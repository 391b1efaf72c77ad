"""NBC: the narrow-band conformer (v1).

Counterpart of ``nbss_tpu/models/nbc.py``. Each frequency is one sequence
over time: a VALID k=4 temporal conv encoder (T -> T - 3), Transformer-XL
style blocks (relative-position MHSA with u/v content and position biases,
then a conv feed-forward stack of grouped convs with GroupNorm), and a
ConvTranspose decoder that restores T.

The relative-position score never forms a [T, 2T-1] table: since the
position encoding is sinusoidal, the angle-sum identity factorizes it as

    pos_score[i, j] = g_i . PE(i - j) = A_i . cos_j + B_i . sin_j

with g = (q + v_bias) W_pos^T, A = gs sin_i + gc cos_i, B = gc sin_i -
gs cos_i (``_nbc_rel_shift`` builds it the table way, for the tests).

With the default pre-norm (``norm_first``), no mask and dropout inactive,
``x + self_attn(norm1(x))`` runs through ``ops.attention_block``'s
``attention_block_relpos`` from the folded operands (the CUDA kernel on a
CUDA tensor, its plain version on the CPU), as the JAX package runs its
Pallas kernel on an accelerator. Otherwise ``RelPosMultiHeadAttention`` runs
on its own: with dropout inactive and T > 1 through the narrow-band
attention kernel over augmented heads, score = [q+u, A, B] . [k, cos_j,
sin_j] (head width dh + d_model), else through an einsum composition.

Parameter names follow the original torch NBC (``sa_layers.{l}.norm1``,
``sa_layers.{l}.self_attn.{query,key,value,out,pos}_proj``, ``u_bias``,
``v_bias``, ``conv.{3i}`` / ``conv.{3i+1}``, ``linear1``, ``linear2``,
``encoder``, ``decoder``), so ``nbss_tpu.utils.torch_compat.
nbc_params_from_torch`` reads the port's state_dict and
``utils/convert.py`` is its inverse.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nbss_tpu_torch.models.base import Conv1d, ConvTranspose1d, GroupNorm, LayerNorm
from nbss_tpu_torch.ops.attention import narrowband_attention
from nbss_tpu_torch.ops.attention_block import attention_block_relpos, fold_weights_nbc


def sinusoidal_relpos_table(T: int, d: int) -> np.ndarray:
    """The position encoding of the relative positions -(T-1) .. T-1,
    [2T-1, d] float32: sin on the even features, cos on the odd."""
    positions = np.arange(-(T - 1), T, dtype=np.float64)[:, None]
    denom = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((2 * T - 1, d), np.float64)
    pe[:, 0::2] = np.sin(positions * denom)
    pe[:, 1::2] = np.cos(positions * denom)
    return pe.astype(np.float32)


def sincos_position_tables(T: int, d: int):
    """sin and cos of the absolute positions 0 .. T-1 at the d/2 frequencies
    of the encoding, [T, d/2] float32 each:
    PE(i-j)[2m] = sin_i cos_j - cos_i sin_j, PE(i-j)[2m+1] = cos_i cos_j +
    sin_i sin_j."""
    positions = np.arange(T, dtype=np.float64)[:, None]
    denom = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    return (np.sin(positions * denom).astype(np.float32),
            np.cos(positions * denom).astype(np.float32))


def _tables(T: int, d: int, device, dtype=torch.float32):
    """(sin, cos) as tensors on ``device``."""
    return tuple(torch.from_numpy(t).to(device, dtype) for t in sincos_position_tables(T, d))


def _nbc_rel_shift(x, T: int):
    """x [..., T, 2T-1] with x[.., i, r] = f(i, rel = T-1-r) ->
    out[.., i, j] = f(i, i - j): pad one column on the left, fold, slice."""
    *lead, Tq, R = x.shape
    x = F.pad(x, (1, 0)).reshape(*lead, 2 * T, Tq)
    return x[..., 1:, :].reshape(*lead, Tq, R)[..., :T]


@torch.no_grad()
def _xavier_(p: nn.Parameter, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator]) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


class XavierLinear(nn.Module):
    """x [..., in] -> [..., out]; weight [out, in] xavier-uniform, bias zero
    (the JAX package's ``_XavierDense``); ``bias=False`` leaves it out."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_f, in_f = self.weight.shape
        _xavier_(self.weight, in_f, out_f, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class RelPosMultiHeadAttention(nn.Module):
    """Transformer-XL attention over the sequence axis of [..., T, H]:
    score = ((q + u) k^T + (q + v_bias) pos^T) / sqrt(d_model), the
    reference's scale (not sqrt(dh)).

    With dropout inactive (eval mode, or ``dropout == 0``), T > 1 and
    ``fused`` it runs ``ops.attention.narrowband_attention`` over the
    augmented heads (q/k width dh + d_model, the CUDA kernel on a CUDA tensor;
    ``kernel=False`` the plain version there too), with q' pre-scaled by
    sqrt(dh + d_model) / sqrt(d_model) so that the kernel's 1/sqrt(dh') gives
    the reference's scale. Otherwise an einsum composition with float32
    scores and softmax, and dropout on the probabilities when training.
    ``att_mask`` is additive, [T, T] or [nh, T, T]."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, fused: bool = True,
                 kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"{d_model} channels do not split into {num_heads} heads")
        self.d_model, self.num_heads, self.dropout = d_model, num_heads, dropout
        self.fused, self.kernel = fused, kernel
        g = generator
        self.query_proj = XavierLinear(d_model, d_model, generator=g)
        self.key_proj = XavierLinear(d_model, d_model, generator=g)
        self.value_proj = XavierLinear(d_model, d_model, generator=g)
        dh = d_model // num_heads
        self.u_bias = nn.Parameter(torch.empty(num_heads, dh))
        self.v_bias = nn.Parameter(torch.empty(num_heads, dh))
        self.reset_parameters(g)
        self.pos_proj = XavierLinear(d_model, d_model, bias=False, generator=g)
        self.out_proj = XavierLinear(d_model, d_model, generator=g)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """u_bias and v_bias; the projections are children with their own."""
        nh, dh = self.u_bias.shape
        _xavier_(self.u_bias, nh, dh, generator)
        _xavier_(self.v_bias, nh, dh, generator)

    def forward(self, x, att_mask: Optional[torch.Tensor] = None):
        *lead, T, H = x.shape
        nh, d = self.num_heads, self.d_model
        dh = d // nh
        dt = x.dtype
        q = self.query_proj(x).reshape(*lead, T, nh, dh)
        k = self.key_proj(x).reshape(*lead, T, nh, dh)
        v = self.value_proj(x).reshape(*lead, T, nh, dh)
        u_bias, v_bias = self.u_bias.to(dt), self.v_bias.to(dt)
        wpos = self.pos_proj.weight.to(dt).t().reshape(d, nh, dh)  # the JAX [d_model, H] kernel
        w_sin, w_cos = wpos[0::2], wpos[1::2]
        sin_t, cos_t = _tables(T, d, x.device, dt)

        # the trig factorization of the relative-position score (module docstring)
        qv = q + v_bias
        gs = torch.einsum("...qhd,mhd->...qhm", qv, w_sin)
        gc = torch.einsum("...qhd,mhd->...qhm", qv, w_cos)
        A = gs * sin_t[:, None, :] + gc * cos_t[:, None, :]
        Bq = gc * sin_t[:, None, :] - gs * cos_t[:, None, :]

        active = self.training and self.dropout > 0
        if self.fused and not active and len(lead) >= 1 and T > 1:
            dhp = dh + d
            M = math.prod(lead)
            fix = torch.tensor(math.sqrt(dhp) / math.sqrt(d), dtype=dt)
            qa = torch.cat([q + u_bias, A, Bq], dim=-1) * fix
            cs = torch.cat([cos_t, sin_t], dim=-1)[None, :, None, :].expand(M, T, nh, d)
            ka = torch.cat([k.reshape(M, T, nh, dh), cs], dim=-1)
            mask = None if att_mask is None else att_mask.float()
            out = narrowband_attention(qa.reshape(M, T, nh * dhp), ka.reshape(M, T, nh * dhp),
                                       v.reshape(M, T, H), mask, nh, kernel=self.kernel)
            return self.out_proj(out.reshape(*lead, T, H))
        f32 = torch.float32
        content = torch.einsum("...qhd,...khd->...hqk", (q + u_bias).to(f32), k.to(f32))
        pos_score = (torch.einsum("...qhm,km->...hqk", A.to(f32), cos_t.to(f32))
                     + torch.einsum("...qhm,km->...hqk", Bq.to(f32), sin_t.to(f32)))
        score = (content + pos_score) / math.sqrt(d)
        if att_mask is not None:
            score = score + att_mask.to(f32)
        attn = torch.softmax(score, dim=-1).to(dt)
        attn = F.dropout(attn, self.dropout, training=self.training)
        out = torch.einsum("...hqk,...khd->...qhd", attn.to(f32), v.to(f32)).to(dt)
        return self.out_proj(out.reshape(*lead, T, H))


class NBCBlock(nn.Module):
    """One conformer block over x [M, T, H]: the relative-position MHSA half
    and the conv feed-forward half, pre-norm (``norm_first``) or post-norm.

    ``fused_block`` (default) runs the pre-norm attention half through
    ``attention_block_relpos`` where the JAX package runs its kernel: pre-norm,
    no mask, dropout inactive."""

    def __init__(self, dim_model: int = 192, num_head: int = 8, dim_ffn: int = 384,
                 dropout: float = 0.1, norm_first: bool = True, n_conv_groups: int = 8,
                 conv_kernel_size: int = 3, conv_bias: bool = True, n_conv_layers: int = 3,
                 conv_mid_norm: Optional[str] = "GN", fused_block: bool = True,
                 attention_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_mid_norm not in ("GN", None):
            raise KeyError(conv_mid_norm)
        g = generator
        self.num_head, self.dropout, self.norm_first = num_head, dropout, norm_first
        self.fused_block = fused_block
        self.norm1 = LayerNorm(dim_model)
        self.self_attn = RelPosMultiHeadAttention(dim_model, num_head, dropout,
                                                  kernel=attention_kernel, generator=g)
        self.norm2 = LayerNorm(dim_model)
        self.linear1 = XavierLinear(dim_model, dim_ffn, generator=g)
        convs = []
        for _ in range(n_conv_layers):
            convs.append(Conv1d(dim_ffn, dim_ffn, conv_kernel_size, groups=n_conv_groups,
                                bias=conv_bias, generator=g))
            if conv_mid_norm == "GN":
                convs.append(GroupNorm(8, dim_ffn))
            convs.append(nn.SiLU())
        self.conv = nn.Sequential(*convs)
        self.linear2 = XavierLinear(dim_ffn, dim_model, generator=g)

    def _drop(self, z):
        return F.dropout(z, self.dropout, training=self.training)

    def _sa(self, z, att_mask):
        return self._drop(self.self_attn(z, att_mask))

    def _ff(self, z):
        z = self.conv(F.silu(self.linear1(z)))
        return self._drop(self.linear2(self._drop(z)))

    def _use_fused_block(self, att_mask) -> bool:
        return (self.fused_block and self.norm_first and att_mask is None
                and not (self.training and self.dropout > 0))

    def _fused_sa_block(self, x):
        M, T, H = x.shape
        sa = self.self_attn
        ln, A, Gs, Gc, Wvo, c, eps = fold_weights_nbc(
            self.norm1.weight, self.norm1.bias, sa.query_proj.weight, sa.query_proj.bias,
            sa.key_proj.weight, sa.key_proj.bias, sa.value_proj.weight, sa.value_proj.bias,
            sa.out_proj.weight, sa.out_proj.bias, sa.pos_proj.weight, sa.u_bias, sa.v_bias,
            self.num_head, self.norm1.eps)
        sin_t, cos_t = _tables(T, H, x.device)
        return attention_block_relpos(x.contiguous(), ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps,
                                      self.num_head)

    def forward(self, x, att_mask: Optional[torch.Tensor] = None):
        if self.norm_first:
            if self._use_fused_block(att_mask):
                x = self._fused_sa_block(x)
            else:
                x = x + self._sa(self.norm1(x), att_mask)
            return x + self._ff(self.norm2(x))
        x = self.norm1(x + self._sa(x, att_mask))
        return self.norm2(x + self._ff(x))


class NBC(nn.Module):
    """[B, F, T, dim_input] -> [B, F, T, dim_output] (float32 out).

    ``dtype`` is the compute dtype (parameters stay float32). ``fused_block``
    runs each block's pre-norm attention half through the relative-position
    kernel; ``attention_kernel=False`` makes the attention modules take the
    plain narrow-band attention on the card too. The weights are drawn on the
    CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, dim_input: int = 16, dim_output: int = 4, n_layers: int = 4,
                 encoder_kernel_size: int = 4, n_heads: int = 8, hidden_size: int = 192,
                 norm_first: bool = True, ffn_size: int = 384, inner_conv_kernel_size: int = 3,
                 inner_conv_groups: int = 8, inner_conv_bias: bool = True,
                 inner_conv_layers: int = 3, inner_conv_mid_norm: Optional[str] = "GN",
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 fused_block: bool = True, attention_kernel: bool = True,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.encoder = Conv1d(dim_input, hidden_size, encoder_kernel_size, padding="valid",
                              generator=g)
        self.sa_layers = nn.ModuleList(
            NBCBlock(dim_model=hidden_size, num_head=n_heads, dim_ffn=ffn_size, dropout=dropout,
                     norm_first=norm_first, n_conv_groups=inner_conv_groups,
                     conv_kernel_size=inner_conv_kernel_size, conv_bias=inner_conv_bias,
                     n_conv_layers=inner_conv_layers, conv_mid_norm=inner_conv_mid_norm,
                     fused_block=fused_block, attention_kernel=attention_kernel, generator=g)
            for _ in range(n_layers))
        self.decoder = ConvTranspose1d(hidden_size, dim_output, encoder_kernel_size, generator=g)
        self.to(device)

    def forward(self, x, att_mask: Optional[torch.Tensor] = None):
        B, F_, T, H0 = x.shape
        x = x.to(self.dtype or x.dtype).reshape(B * F_, T, H0)
        x = self.encoder(x)  # valid conv: T -> T - k + 1
        for layer in self.sa_layers:
            x = layer(x, att_mask)
        y = self.decoder(x)  # the transposed conv restores T
        return y.reshape(B, F_, T, -1).float()
