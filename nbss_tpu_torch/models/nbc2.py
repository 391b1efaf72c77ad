"""NBC2: the revised narrow-band conformer (arXiv 2212.02076).

Counterpart of ``nbss_tpu/models/nbc2.py``. Each frequency is one sequence
over time ([B*F, T, H]), and each block is pre-norm:

    norm1 -> MHSA over T -> + residual
    norm2 -> linear1 -> SiLU -> conv1 -> SiLU -> conv2 -> conv_norm -> SiLU
          -> conv3 -> SiLU -> dropout -> linear2 -> + residual

with 'same' grouped temporal convs. A norm is LN, GBN (``GroupBatchNorm``
over the F sequences of an utterance: the runtime group size is F), GBNShare
or GN.

With an LN first norm, no mask and dropout inactive, ``x + MHSA(norm1(x))``
runs through ``ops.attention_block`` from the folded LN and attention weights
(the CUDA kernels of rows 1-2 on a CUDA tensor, ``reference`` on the CPU),
as the JAX package runs its Pallas kernel; ``fused_block=False`` turns that
off. Otherwise the ``MultiheadAttention`` module runs, through
``ops.attention.narrowband_attention`` (rows 4-5 on a CUDA tensor;
``attention_kernel=False`` takes the plain versions there too).

Parameter names follow the reference torch NBC2 (``encoder``,
``sa_layers.{l}.norm1``, ``.self_attn.in_proj_weight``, ``.norm2``,
``.linear1``, ``.conv.{1,3,6}`` the convs and ``.conv.4`` the mid norm,
``.linear2``, ``decoder``), which
``nbss_tpu.utils.torch_compat.nbc2_params_from_torch`` reads;
``utils/convert.py`` holds its inverse.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nbss_tpu_torch.models.base import (
    Conv1d,
    GroupBatchNorm,
    GroupNorm,
    LayerNorm,
    Linear,
    MultiheadAttention,
)
from nbss_tpu_torch.models.nbc import XavierLinear
from nbss_tpu_torch.ops.attention_block import attention_block, fold_weights


def nbc2_norm(kind: str, num_features: int, num_groups: int = 8,
              share: bool = False) -> nn.Module:
    """The norm factory of NBC2's blocks (the JAX ``_NBC2Norm``): 'LN', 'GBN'
    (shared along the sequence with ``share``), 'GBNShare' or 'GN'."""
    if kind == "LN":
        return LayerNorm(num_features)
    if kind == "GBN":
        return GroupBatchNorm(num_features, share_along_sequence_dim=share)
    if kind == "GBNShare":
        return GroupBatchNorm(num_features, share_along_sequence_dim=True)
    if kind == "GN":
        return GroupNorm(num_groups, num_features)
    raise KeyError(kind)


def _normed(norm: nn.Module, x, group_size: int):
    """``norm(x)``, given the group size where it is a GroupBatchNorm."""
    return norm(x, group_size) if isinstance(norm, GroupBatchNorm) else norm(x)


class NBC2Block(nn.Module):
    """One NBC2 block over x [B*F, T, H] with F = ``group_size``."""

    def __init__(self, dim_hidden: int, dim_ffn: int, n_heads: int = 2, dropout: float = 0.0,
                 conv_kernel_size: int = 3, n_conv_groups: int = 8,
                 norms: Sequence[str] = ("LN", "GBN", "GBN"),
                 share_along_sequence_dim: bool = False, fused_block: bool = True,
                 attention_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        H, FF, g = dim_hidden, dim_ffn, generator

        def norm(kind, width):
            return nbc2_norm(kind, width, n_conv_groups, share_along_sequence_dim)

        def conv():
            return Conv1d(FF, FF, conv_kernel_size, groups=n_conv_groups, generator=g)

        self.n_heads, self.dropout = n_heads, dropout
        self.fused_block = fused_block and norms[0].upper() == "LN"
        self.norm1 = norm(norms[0], H)
        self.self_attn = MultiheadAttention(H, n_heads, kernel=attention_kernel, generator=g)
        self.norm2 = norm(norms[1], H)
        self.linear1 = XavierLinear(H, FF, generator=g)
        self.conv = nn.Sequential(nn.SiLU(), conv(), nn.SiLU(), conv(), norm(norms[2], FF),
                                  nn.SiLU(), conv(), nn.SiLU())
        self.linear2 = XavierLinear(FF, H, generator=g)

    def _drop(self, z):
        return F.dropout(z, self.dropout, training=self.training)

    def _use_fused_block(self, att_mask) -> bool:
        return (self.fused_block and att_mask is None
                and not (self.training and self.dropout > 0))

    def _fused_attn_block(self, x):
        ln, A, Wvo, c, eps = fold_weights(
            self.norm1.weight, self.norm1.bias, self.self_attn.in_proj_weight,
            self.self_attn.in_proj_bias, self.self_attn.out_proj.weight,
            self.self_attn.out_proj.bias, self.n_heads, self.norm1.eps)
        return attention_block(x.contiguous(), ln, A, Wvo, c, eps, self.n_heads)

    def forward(self, x, group_size: int, att_mask: Optional[torch.Tensor] = None):
        if self._use_fused_block(att_mask):
            x = self._fused_attn_block(x)
        else:
            x = x + self._drop(self.self_attn(_normed(self.norm1, x, group_size), att_mask))
        y = self.linear1(_normed(self.norm2, x, group_size))
        for m in self.conv:
            y = _normed(m, y, group_size)
        return x + self._drop(self.linear2(self._drop(y)))


class NBC2(nn.Module):
    """[B, F, T, dim_input] -> [B, F, T, dim_output] (float32 out).

    ``dtype`` is the compute dtype (parameters stay float32). ``num_freqs``
    is kept for the configurations' sake, as in the JAX package: the group
    size of the GroupBatchNorms is F of the input. The weights are drawn on
    the CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, dim_input: int, dim_output: int, n_layers: int,
                 encoder_kernel_size: int = 5, dim_hidden: int = 192, dim_ffn: int = 384,
                 num_freqs: int = 257, n_heads: int = 2, dropout: float = 0.0,
                 conv_kernel_size: int = 3, n_conv_groups: int = 8,
                 norms: Sequence[str] = ("LN", "GBN", "GBN"),
                 share_along_sequence_dim: bool = False, dtype: Optional[torch.dtype] = None,
                 fused_block: bool = True, attention_kernel: bool = True,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.encoder = Conv1d(dim_input, dim_hidden, encoder_kernel_size, generator=g)
        self.sa_layers = nn.ModuleList(
            NBC2Block(dim_hidden, dim_ffn, n_heads, dropout, conv_kernel_size, n_conv_groups,
                      norms, share_along_sequence_dim, fused_block, attention_kernel,
                      generator=g)
            for _ in range(n_layers))
        self.decoder = Linear(dim_hidden, dim_output, generator=g)
        self.to(device)

    def forward(self, x, att_mask: Optional[torch.Tensor] = None):
        B, F_, T, H0 = x.shape
        x = self.encoder(x.to(self.dtype or x.dtype).reshape(B * F_, T, H0))
        for layer in self.sa_layers:
            x = layer(x, F_, att_mask)
        return self.decoder(x).reshape(B, F_, T, -1).float()
