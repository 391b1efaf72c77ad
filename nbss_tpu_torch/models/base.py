"""Building blocks of the narrow-band models, channel-last.

Counterpart of the parts of ``nbss_tpu/models/base.py`` that SpatialNet,
OnlineSpatialNet, NBC and NBC2 use. Parameters are float32 in the layout of
the original torch NBSS modules (Linear [out, in], Conv1d [out, in/groups,
k]); each block computes in its input's dtype and casts its parameters to
it, as the JAX package does with ``param_dtype=float32, dtype=bf16``.
Normalizations take their statistics in float32, with var = E[x^2] - E[x]^2
and eps 1e-5.

Initialization follows torch's Linear/Conv defaults (uniform with bound
1/sqrt(fan_in)) and draws from an explicit ``torch.Generator``. Each block's
``reset_parameters(generator)`` draws its own parameters (not its
children's), so ``init_parameters`` can draw a whole model anew.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nbss_tpu_torch.ops.attention import narrowband_attention


@torch.no_grad()
def _uniform_(p: nn.Parameter, bound: float, generator: Optional[torch.Generator]) -> None:
    """Draw p uniformly in [-bound, bound] on the CPU from ``generator``."""
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter of ``module`` anew from ``generator``: each
    submodule's ``reset_parameters``, in the order of ``module.modules()``
    (a shared submodule once)."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class Linear(nn.Module):
    """x [..., in] -> [..., out]; weight [out, in]."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv1d(nn.Module):
    """1-D conv along the second-to-last axis of [..., W, C]; weight
    [out, in/groups, k]. ``padding`` is 'same', 'causal' (k - 1 frames on
    the left only) or 'valid' (none: W - k + 1 frames out). A 1x1 conv
    without groups is a Linear. ``bias=False`` leaves the bias out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 groups: int = 1, padding: str = "same", bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("same", "causal", "valid"):
            raise ValueError(f"padding must be 'same', 'causal' or 'valid', got {padding!r}")
        self.groups, self.kernel_size, self.padding = groups, kernel_size, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.kernel_size)  # fan_in
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.kernel_size == 1 and self.groups == 1:
            return F.linear(x, w[:, :, 0], b)
        *lead, W, C = x.shape
        k = self.kernel_size
        left = {"causal": k - 1, "same": (k - 1) // 2, "valid": 0}[self.padding]
        right = 0 if self.padding == "valid" else k - 1 - left
        xc = F.pad(x.reshape(-1, W, C).transpose(1, 2), (left, right))
        y = F.conv1d(xc, w, b, groups=self.groups)
        return y.transpose(1, 2).reshape(*lead, y.shape[-1], -1)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D conv along the second-to-last axis of [..., W, C]
    (torch's ConvTranspose1d, stride 1, no padding): W + k - 1 frames out.
    Weight [in, out, k] in torch's layout; the JAX package's flax kernel
    [k, in, out] is this one flipped along k. Initialized as the JAX
    package's module: weight and bias uniform with bound 1/sqrt(in * k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[0] * self.weight.shape[2])  # in * k
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        *lead, W, C = x.shape
        y = F.conv_transpose1d(x.reshape(-1, W, C).transpose(1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype))
        return y.transpose(1, 2).reshape(*lead, y.shape[-1], -1)


class PReLU(nn.Module):
    """Per-channel PReLU on the last axis, initialized at 0.25."""

    def __init__(self, num_parameters: int, init: float = 0.25):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(self.init)

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def _norm_stats(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) with float32 statistics."""
    x32 = x.float()
    mean = x32.mean(dims, keepdim=True)
    var = (x32 * x32).mean(dims, keepdim=True) - mean * mean
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        y = _norm_stats(x, (-1,), self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm on channel-last [..., S, H]: per leading sample and
    channel group, statistics over the group's channels and all of S."""

    def __init__(self, num_groups: int, num_features: int, eps: float = 1e-5):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_features} channels do not split into {num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        *lead, S, H = x.shape
        G = self.num_groups
        y = _norm_stats(x.reshape(*lead, S, G, H // G), (-3, -1), self.eps).reshape(x.shape)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class GlobalLayerNorm(nn.Module):
    """gLN: per leading sample, statistics over the sequence and the channels
    of [..., S, H]."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        y = _norm_stats(x, (-2, -1), self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class GroupBatchNorm(nn.Module):
    """Group batch norm over the sequences that share an utterance: x is
    [B * group_size, S, H] (NBC2 calls it with group_size = F, each frequency
    one sequence), and the statistics of each utterance's group are taken
    over (group member, H), or over (group member, S, H) with
    ``share_along_sequence_dim``, from the input in training and in eval
    alike: no running statistics. The affine parameters are [H]."""

    def __init__(self, num_features: int, share_along_sequence_dim: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.share_along_sequence_dim, self.eps = share_along_sequence_dim, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, group_size: int):
        BG, S, H = x.shape
        if BG % group_size:
            raise ValueError(f"{BG} sequences do not split into groups of {group_size}")
        dims = (1, 2, 3) if self.share_along_sequence_dim else (1, 3)
        y = _norm_stats(x.reshape(BG // group_size, group_size, S, H), dims,
                        self.eps).reshape(x.shape)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def new_norm(norm_type: str, num_features: int, num_groups: Optional[int] = None) -> nn.Module:
    """'LN', 'GN', 'gLN', 'GBN' (case-insensitive) or 'GBNShare', as the JAX
    package's ``new_norm``; KeyError for any other name. GBN and GBNShare
    take the runtime group size as their second argument."""
    t = norm_type.upper()
    if t == "LN":
        return LayerNorm(num_features)
    if t == "GN":
        return GroupNorm(num_groups, num_features)
    if t == "GLN":
        return GlobalLayerNorm(num_features)
    if t == "GBN":
        return GroupBatchNorm(num_features)
    if norm_type == "GBNShare":
        return GroupBatchNorm(num_features, share_along_sequence_dim=True)
    raise KeyError(norm_type)


class LinearGroup(nn.Module):
    """Per-group dense map x [..., G, F_in] -> [..., G, F_out]; weight
    [G, F_out, F_in], bias [G, F_out]. SpatialNet's full-band F -> F mixing."""

    def __init__(self, in_features: int, out_features: int, num_groups: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_groups, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(num_groups, out_features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        G, F_out, F_in = self.weight.shape
        # the JAX package's fan_in for a [G, F_out, F_in] kernel is G * F_out
        _uniform_(self.weight, 1.0 / math.sqrt(G * F_out), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(F_in), generator)

    def forward(self, x):
        y = torch.einsum("...gh,gkh->...gk", x, self.weight.to(x.dtype))
        return y + self.bias.to(x.dtype)


class MultiheadAttention(nn.Module):
    """Self-attention over the sequence axis of [..., T, H], parameterized as
    torch.nn.MultiheadAttention (packed ``in_proj_weight`` [3H, H],
    ``out_proj``); scale 1/sqrt(dh), float32 scores and softmax.

    ``attn_mask`` is additive ([T, T], [nh, T, T] or with leading axes, -inf
    for masked) or boolean (True = masked). ``fused=True`` runs
    ``ops.attention.narrowband_attention`` (the CUDA kernels on a CUDA tensor,
    ``reference`` on the CPU; ``kernel=False`` the plain versions on the card
    too), as the JAX package runs its Pallas kernel on an accelerator: a
    boolean mask becomes -1e30 / 0 and a float mask is clamped at -1e30 first,
    and the weights are rounded before they are normalized. A mask with more
    than 3 dimensions, or ``fused=False``, takes the einsum composition, which
    normalizes and then rounds as the JAX package's XLA path does."""

    def __init__(self, embed_dim: int, num_heads: int, fused: bool = True, kernel: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"{embed_dim} channels do not split into {num_heads} heads")
        self.num_heads, self.fused, self.kernel = num_heads, fused, kernel
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.reset_parameters(generator)
        self.out_proj = Linear(embed_dim, embed_dim, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The packed in-projection; ``out_proj`` is a child with its own."""
        bound = 1.0 / math.sqrt(self.in_proj_weight.shape[1])
        _uniform_(self.in_proj_weight, bound, generator)
        _uniform_(self.in_proj_bias, bound, generator)

    def forward(self, x, attn_mask: Optional[torch.Tensor] = None):
        *lead, T, H = x.shape
        nh = self.num_heads
        dh = H // nh
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        if self.fused and (attn_mask is None or attn_mask.dim() <= 3):
            mask = attn_mask
            if mask is not None:
                if mask.dtype == torch.bool:
                    mask = torch.where(mask, -1e30, 0.0)
                mask = mask.float().clamp(min=-1e30)
            q, k, v = qkv.reshape(-1, T, 3 * H).chunk(3, dim=-1)  # row-strided views
            out = narrowband_attention(q, k, v, mask, nh, kernel=self.kernel)
            return self.out_proj(out.reshape(*lead, T, H))
        q, k, v = (t.reshape(*lead, T, nh, dh).float() for t in qkv.chunk(3, dim=-1))
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(dh)
        if attn_mask is not None:
            m = attn_mask[..., None, :, :] if attn_mask.dim() == len(lead) + 2 else attn_mask
            if m.dtype == torch.bool:
                logits = logits.masked_fill(m, -1e30)
            else:
                logits = logits + m.float()
        probs = torch.softmax(logits, dim=-1).to(x.dtype).float()
        out = torch.einsum("...hqk,...khd->...qhd", probs, v).to(x.dtype)
        return self.out_proj(out.reshape(*lead, T, H))
