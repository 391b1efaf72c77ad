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
package runs its Pallas kernel on an accelerator. ``fused_block=False`` runs
the plain module composition instead (the einsum ``MultiheadAttention``).

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
from torch import nn

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
                 fused_block: bool = True, fused_ffn: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, FF, S = dim_hidden, dim_ffn, dim_squeeze
        f_groups, t_groups = conv_groups
        f_k, t_k = kernel_size
        g = generator
        self.num_heads = num_heads
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
        self.mhsa = MultiheadAttention(H, num_heads, fused=False, generator=g)
        self.tconvffn = nn.Sequential(
            new_norm(norms[1], H, t_groups),
            Conv1d(H, FF, 1, generator=g), nn.SiLU(),
            Conv1d(FF, FF, t_k, groups=t_groups, generator=g), nn.SiLU(),
            Conv1d(FF, FF, t_k, groups=t_groups, generator=g),
            new_norm(norms[2], FF, t_groups), nn.SiLU(),
            Conv1d(FF, FF, t_k, groups=t_groups, generator=g), nn.SiLU(),
            Conv1d(FF, H, 1, generator=g),
        )

    def forward(self, x):
        """x: [B, F, T, H] -> [B, F, T, H]."""
        xt = x.transpose(1, 2)  # [B, T, F, H]: the cross-band block runs along F
        xt = xt + self.fconv1(xt)
        xt = xt + self._full(xt)
        xt = xt + self.fconv2(xt)
        x = xt.transpose(1, 2)
        if self.fused_block:
            x = self._fused_tsa_block(x)
        else:
            x = x + self.mhsa(self.norm_mhsa(x))
        if self.fused_ffn:
            return x + self._fused_tconvffn(x)
        return x + self.tconvffn(x)

    def _full(self, xt):
        y = self.squeeze(self.norm_full(xt))  # [B, T, F, S]
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
    drawn on the CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, dim_input: int, dim_output: int, dim_squeeze: int, num_layers: int,
                 num_freqs: int, encoder_kernel_size: int = 5, dim_hidden: int = 192,
                 dim_ffn: int = 384, num_heads: int = 2,
                 kernel_size: Tuple[int, int] = (5, 3), conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 full_share: int = 0, dtype: Optional[torch.dtype] = None,
                 fused_block: bool = True, fused_ffn: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.encoder = Conv1d(dim_input, dim_hidden, encoder_kernel_size, generator=g)
        fulls = [LinearGroup(num_freqs, num_freqs, dim_squeeze, generator=g)
                 for _ in range(min(full_share, num_layers - 1) + 1)]
        self.layers = nn.ModuleList(
            SpatialNetLayer(dim_hidden, dim_ffn, dim_squeeze, num_heads,
                            full=fulls[min(l, len(fulls) - 1)], kernel_size=kernel_size,
                            conv_groups=conv_groups, norms=norms, fused_block=fused_block,
                            fused_ffn=fused_ffn, generator=g)
            for l in range(num_layers))
        self.decoder = Linear(dim_hidden, dim_output, generator=g)
        self.to(device)

    def forward(self, x):
        x = x.to(self.dtype or x.dtype)
        x = self.encoder(x)  # conv over T for each (B, F)
        for layer in self.layers:
            x = layer(x)
        return self.decoder(x).float()
