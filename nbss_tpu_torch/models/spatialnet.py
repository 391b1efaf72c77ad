"""SpatialNet (offline): joint separation, denoising and dereverberation.

Counterpart of ``nbss_tpu/models/spatialnet.py``. Each layer is

    cross-band block:  fconv1 -> full-band linear -> fconv2    in [B, T, F, H]
    narrow-band block: x + MHSA(LN(x)) over T                  in [B, F, T, H]
                       -> temporal conv-FFN

Parameter names follow the original torch SpatialNet
(``layers.{l}.fconv1.0.weight``, ``layers.{l}.mhsa.in_proj_weight``, ...), so
``utils/convert.py`` is the exact inverse of the JAX package's
``spatialnet_params_from_torch``. The full-band ``LinearGroup`` of layer
``full_share`` is one module shared by every layer above it.

With the default LayerNorm pre-norm the narrow-band ``x + MHSA(LN(x))`` runs
through ``ops.attention_block`` (the CUDA kernel on a CUDA tensor), as the JAX
package runs its Pallas kernel on an accelerator, unless an ``att_mask`` is
given or the attention's dropout is active (training with ``dropout[0] >
0``): the JAX ``_use_fused_block`` rule. The block then runs as modules, its
``MultiheadAttention`` through ``ops.attention`` (rows 4-5 on the card), as
the JAX package's attention runs its Pallas kernel on an accelerator.
``fused_block=False`` runs the plain module composition instead (the einsum
``MultiheadAttention``).

``dropout`` takes the JAX package's three rates: after the MHSA, after the
T-ConvFFN, and on whole frequencies of an utterance in the full-band module
(a keep mask [B, 1, F, 1] on the squeezed [B, T, F, S] after its SiLU).
``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``) while gradients are enabled.

The T-ConvFFN is the plain ``nn.Sequential`` composition unless
``fused_ffn`` is true, as in the JAX package, where ``fused_ffn=None`` (the
default) means off (``bool(None)``). With it true, the default norms (LN
first, GN in the middle) and k = 3 temporal convs, the whole chain runs
through ``ops.tconvffn`` (the CUDA kernel on a CUDA tensor); other settings
keep the composition, as the JAX package's conditions do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nbss_tpu_torch.models.base import (
    Conv1d,
    Linear,
    LinearGroup,
    MultiheadAttention,
    PReLU,
    new_norm,
)
from nbss_tpu_torch.ops.attention_block import attention_block, fold_weights
from nbss_tpu_torch.ops.tconvffn import params_from_sequential, tconvffn


class SpatialNetLayer(nn.Module):
    def __init__(self, dim_hidden: int, dim_ffn: int, dim_squeeze: int, num_heads: int,
                 full: LinearGroup, kernel_size: Tuple[int, int] = (5, 3),
                 conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 dropout: Tuple[float, float, float] = (0, 0, 0),
                 fused_block: bool = True, fused_ffn: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, FF, S = dim_hidden, dim_ffn, dim_squeeze
        f_groups, t_groups = conv_groups
        f_k, t_k = kernel_size
        g = generator
        self.num_heads = num_heads
        self.dropout = tuple(dropout)
        self.fused_block = fused_block and norms[0].upper() == "LN"
        self.fused_ffn = (bool(fused_ffn) and norms[1].upper() == "LN"
                          and norms[2].upper() == "GN" and t_k == 3)
        self.fconv1 = nn.Sequential(new_norm(norms[3], H, f_groups),
                                    Conv1d(H, H, f_k, groups=f_groups, generator=g), PReLU(H))
        self.norm_full = new_norm(norms[5], H, f_groups)
        self.squeeze = nn.Sequential(Conv1d(H, S, 1, generator=g), nn.SiLU())
        self.full = full
        self.unsqueeze = nn.Sequential(Conv1d(S, H, 1, generator=g), nn.SiLU())
        self.fconv2 = nn.Sequential(new_norm(norms[4], H, f_groups),
                                    Conv1d(H, H, f_k, groups=f_groups, generator=g), PReLU(H))
        self.norm_mhsa = new_norm(norms[0], H, t_groups)
        self.mhsa = MultiheadAttention(H, num_heads, fused=fused_block, generator=g)
        self.tconvffn = nn.Sequential(
            new_norm(norms[1], H, t_groups),
            Conv1d(H, FF, 1, generator=g), nn.SiLU(),
            Conv1d(FF, FF, t_k, groups=t_groups, generator=g), nn.SiLU(),
            Conv1d(FF, FF, t_k, groups=t_groups, generator=g),
            new_norm(norms[2], FF, t_groups), nn.SiLU(),
            Conv1d(FF, FF, t_k, groups=t_groups, generator=g), nn.SiLU(),
            Conv1d(FF, H, 1, generator=g),
        )

    def forward(self, x, att_mask: Optional[torch.Tensor] = None):
        """x: [B, F, T, H] -> [B, F, T, H]; att_mask [T, T] or [nh, T, T],
        additive or boolean (True = masked)."""
        xt = x.transpose(1, 2)  # [B, T, F, H]: the cross-band block runs along F
        xt = xt + self.fconv1(xt)
        xt = xt + self._full(xt)
        xt = xt + self.fconv2(xt)
        x = xt.transpose(1, 2)
        if self.use_fused_block(att_mask):
            x = self._fused_tsa_block(x)
        else:
            y = self.norm_mhsa(x)
            x = x + self._drop(0, self.mhsa(y) if att_mask is None else self.mhsa(y, att_mask))
        y = self._fused_tconvffn(x) if self.fused_ffn else self.tconvffn(x)
        return x + self._drop(1, y)

    def use_fused_block(self, att_mask=None) -> bool:
        """The JAX ``_use_fused_block`` rule: the folded block runs with the
        LN pre-norm, no mask and the attention's dropout inactive."""
        return (self.fused_block and att_mask is None
                and not (self.training and self.dropout[0] > 0))

    def _drop(self, i, y):
        return F.dropout(y, self.dropout[i], training=self.training) if self.dropout[i] > 0 else y

    def _full(self, xt):
        y = self.squeeze(self.norm_full(xt))  # [B, T, F, S]
        if self.training and self.dropout[2] > 0:  # whole frequencies of an utterance
            B, _, Fq, _ = y.shape
            y = y * F.dropout(torch.ones(B, 1, Fq, 1, dtype=y.dtype, device=y.device),
                              self.dropout[2])
        y = self.full(y.transpose(-1, -2)).transpose(-1, -2)  # F -> F per squeezed channel
        return self.unsqueeze(y)

    def _fused_tsa_block(self, x):
        B, Fq, T, H = x.shape
        ln, A, Wvo, c, eps = fold_weights(
            self.norm_mhsa.weight, self.norm_mhsa.bias, self.mhsa.in_proj_weight,
            self.mhsa.in_proj_bias, self.mhsa.out_proj.weight, self.mhsa.out_proj.bias,
            self.num_heads, self.norm_mhsa.eps)
        y = attention_block(x.reshape(B * Fq, T, H).contiguous(), ln, A, Wvo, c, eps,
                            self.num_heads)
        return y.reshape(B, Fq, T, H)

    def _fused_tconvffn(self, x):
        B, Fq, T, H = x.shape
        y = tconvffn(x.reshape(B * Fq, T, H).contiguous(), params_from_sequential(self.tconvffn),
                     self.tconvffn[3].groups)
        return y.reshape(B, Fq, T, H)


class SpatialNet(nn.Module):
    """[B, F, T, dim_input] -> [B, F, T, dim_output] (float32 out).

    ``dtype`` is the compute dtype (parameters stay float32). The weights are
    drawn on the CPU from ``generator`` and then moved to ``device``.
    Dropout is active in training mode (``self.training``), as the JAX
    package's is with ``deterministic=False``."""

    def __init__(self, dim_input: int, dim_output: int, dim_squeeze: int, num_layers: int,
                 num_freqs: int, encoder_kernel_size: int = 5, dim_hidden: int = 192,
                 dim_ffn: int = 384, num_heads: int = 2,
                 dropout: Tuple[float, float, float] = (0, 0, 0),
                 kernel_size: Tuple[int, int] = (5, 3), conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 full_share: int = 0, dtype: Optional[torch.dtype] = None, remat: bool = False,
                 fused_block: bool = True, fused_ffn: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator
        self.dtype, self.remat = dtype, remat
        self.encoder = Conv1d(dim_input, dim_hidden, encoder_kernel_size, generator=g)
        fulls = [LinearGroup(num_freqs, num_freqs, dim_squeeze, generator=g)
                 for _ in range(min(full_share, num_layers - 1) + 1)]
        self.layers = nn.ModuleList(
            SpatialNetLayer(dim_hidden, dim_ffn, dim_squeeze, num_heads,
                            full=fulls[min(l, len(fulls) - 1)], kernel_size=kernel_size,
                            conv_groups=conv_groups, norms=norms, dropout=dropout,
                            fused_block=fused_block, fused_ffn=fused_ffn, generator=g)
            for l in range(num_layers))
        self.decoder = Linear(dim_hidden, dim_output, generator=g)
        self.to(device)

    def forward(self, x, att_mask: Optional[torch.Tensor] = None):
        x = x.to(self.dtype or x.dtype)
        x = self.encoder(x)  # conv over T for each (B, F)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, att_mask, use_reentrant=False)
            else:
                x = layer(x, att_mask)
        return self.decoder(x).float()
