"""Multi-scale retention (RetNet) for OnlineSpatialNet's time axis.

Counterpart of ``nbss_tpu/models/retention.py``. x [B, T, H] -> [B, T, H]
through one of three paths that compute the same retention:

- ``parallel``: the whole T x T decay-masked product (bounded T);
- ``chunkwise``: retention inside 64-frame chunks plus a recurrent key-value
  state carried from chunk to chunk, with the scale clamps of the original
  (a Python loop over the chunks where the JAX package has ``lax.scan``);
- ``recurrent``: the O(1)-state recurrence, one frame at a time
  (``streaming_step``) or over a whole sequence (``_recurrent_seq``).

The xPos tables and decay masks are built in float64 numpy and cast to
float32, as the JAX package builds them, and moved to the caller's device.
The rounding points are the JAX package's: products of two bf16 operands
are summed in float32, the scale clamps use detached absolute sums, and
``share_qk=True`` skips the 1/sqrt(key_dim) key scaling. The matrix
products are plain PyTorch, as they are plain XLA in the JAX package: it
has no Pallas kernel for retention.

The recurrent state is float32 whatever the compute dtype: in the JAX
package the first step already turns a bf16 state into float32 (the decay
factors are float32), so the values are the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nbss_tpu_torch.models.base import _uniform_


def resolve_decays(decay: Union[int, bool, Sequence[Union[int, float]], None],
                   num_heads: int) -> List[float]:
    """Per-head exponential decays: ``False`` none (1.0), a list of floats as
    given, a list of ints d as 1 - 2^-d, an int d (or None / True for 5) as
    1 - 2^(-d - h) for head h."""
    if decay is False:
        return [1.0] * num_heads
    if isinstance(decay, (list, tuple)):
        if isinstance(decay[0], float):
            if decay[0] > 1:
                raise ValueError(f"decay factors must be <= 1, got {decay}")
            return list(decay)
        if not (isinstance(decay[0], int) and decay[0] > 1):
            raise ValueError(f"integer decays must be > 1, got {decay}")
        return [1 - 2.0 ** (-d) for d in decay]
    if decay is None or decay is True:
        decay = 5
    return [float(1 - 2.0 ** (-decay - h)) for h in range(num_heads)]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


@dataclass(frozen=True)
class RetNetRelPos:
    """The xPos tables and decay masks of each path, as float32 tensors on
    ``device``."""

    embed_dim: int
    num_heads: int
    recurrent_chunk_size: int = 64
    decay: Union[int, bool, Tuple, None] = None

    @property
    def decays(self) -> np.ndarray:
        d = list(self.decay) if isinstance(self.decay, tuple) else self.decay
        return np.asarray(resolve_decays(d, self.num_heads), np.float64)

    @property
    def angle(self) -> np.ndarray:
        kd = self.embed_dim // self.num_heads
        return np.repeat(1.0 / (10000 ** np.linspace(0, 1, kd // 2)), 2)  # [kd]

    def _sincos(self, slen: int, device):
        idx = np.arange(slen)[:, None] * self.angle[None, :]
        return _tensor(np.sin(idx), device), _tensor(np.cos(idx), device)

    def _decay_mask(self, n: int) -> np.ndarray:
        """[nh, n, n]: decay^(i - j) for j <= i, else 0."""
        i = np.arange(n)
        rel = i[:, None] - i[None, :]
        log_d = np.log(self.decays)
        with np.errstate(invalid="ignore"):
            mask = np.where(rel >= 0, np.exp(rel[None] * log_d[:, None, None]), 0.0)
        return np.nan_to_num(mask)

    def parallel(self, slen: int, device=None):
        """((sin, cos) [T, kd], mask [nh, T, T]), each mask row divided by
        the square root of its sum."""
        mask = self._decay_mask(slen)
        mask = mask / np.sqrt(mask.sum(-1, keepdims=True))
        return self._sincos(slen, device), _tensor(mask, device)

    def chunkwise(self, slen: int, device=None):
        """((sin, cos), (inner_mask [nh, C, C], cross_decay [nh, 1, 1],
        query_inner_decay [nh, C, 1], value_inner_decay [nh, C, 1]))."""
        C = self.recurrent_chunk_size
        mask = self._decay_mask(C)
        log_d = np.log(self.decays)
        last_row_sum = mask[:, -1].sum(-1)  # [nh]
        value_inner_decay = (mask[:, -1] / last_row_sum[:, None])[:, :, None]
        scale = np.sqrt(mask.sum(-1, keepdims=True))  # [nh, C, 1]
        inner_mask = mask / scale
        cross_decay = np.exp(log_d * C)[:, None, None]
        query_inner_decay = np.exp(log_d[:, None] * (np.arange(C) + 1))[:, :, None]
        query_inner_decay = query_inner_decay / (scale / last_row_sum[:, None, None])
        return self._sincos(slen, device), tuple(
            _tensor(a, device) for a in (inner_mask, cross_decay, query_inner_decay,
                                         value_inner_decay))

    def recurrent(self, t: int, device=None):
        """((sin_t, cos_t) [kd], decays [nh]) of frame t: the whole rotation
        at position t, as the JAX package has it."""
        sin, cos = self._sincos(t + 1, device)
        return (sin[-1], cos[-1]), _tensor(self.decays, device)

    def recurrent_dynamic(self, t: int, device=None):
        """``recurrent`` with angle * t formed in float32 on the device, as
        the JAX package's streaming forms it from its frame counter."""
        angle = _tensor(self.angle, device) * torch.tensor(float(t), device=device)
        return (torch.sin(angle), torch.cos(angle)), _tensor(self.decays, device)

    def recurrent_seq(self, slen: int, device=None):
        """((sin, cos) [T, kd], decays [nh]) for the whole-sequence recurrence."""
        return self._sincos(slen, device), _tensor(self.decays, device)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def theta_shift(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    slen = x.shape[-2]
    return x * cos[..., :slen, :] + rotate_every_two(x) * sin[..., :slen, :]


def _rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm without a weight, statistics in float32."""
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)).to(x.dtype)


class _Proj(nn.Module):
    """A bias-free Linear ([out, in] weight) with Xavier-uniform init of the
    given gain; computes in its input's dtype."""

    def __init__(self, in_features: int, out_features: int, gain: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gain = gain
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_f, in_f = self.weight.shape
        _uniform_(self.weight, self.gain * math.sqrt(6.0 / (in_f + out_f)), generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


def _f32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with float32 sums, as the JAX package's
    ``preferred_element_type=float32`` (bf16 products are exact in float32)."""
    return torch.einsum(eq, a.float(), b.float())


class MultiScaleRetention(nn.Module):
    """x [B, T, H] -> [B, T, H]; ``rel_pos`` from ``RetNetRelPos`` for the
    chosen path. Parameters are float32 and named as the reference names
    them (``q_proj``, ``k_proj`` unless ``share_qk``, ``v_proj``,
    ``g_proj``, ``out_proj``); the module computes in its input's dtype."""

    def __init__(self, embed_dim: int, num_heads: int, value_factor: int = 2,
                 look_ahead: int = 0, share_qk: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, V, g = embed_dim, embed_dim * value_factor, generator
        self.num_heads, self.look_ahead, self.share_qk = num_heads, look_ahead, share_qk
        self.key_dim, self.head_dim = H // num_heads, V // num_heads
        self.q_proj = _Proj(H, H, 2 ** -2.5, g)
        if not share_qk:
            self.k_proj = _Proj(H, H, 2 ** -2.5, g)
        self.v_proj = _Proj(H, V, 2 ** -2.5, g)
        self.g_proj = _Proj(H, V, 2 ** -2.5, g)
        self.out_proj = _Proj(V, H, 2 ** -1, g)

    def _qkv(self, x, sin, cos, rope: bool):
        B, T, _ = x.shape
        nh, kd = self.num_heads, self.key_dim
        q = self.q_proj(x).reshape(B, T, nh, kd).transpose(1, 2)
        if self.share_qk:
            k = q  # no 1/sqrt(kd) scaling in the share_qk path, as in the reference
        else:  # the scalar in x's dtype, as the JAX package's weakly typed constant
            scale = torch.tensor(kd ** -0.5, dtype=x.dtype, device=x.device)
            k = (self.k_proj(x) * scale).reshape(B, T, nh, kd).transpose(1, 2)
        v = self.v_proj(x)
        if rope:
            return theta_shift(q, sin, cos), theta_shift(k, sin, cos), v
        return q, k, v

    def _finish(self, output, g, B: int, T: int, dtype):
        """output [B, T, nh, hd] -> the gated, normalized projection, the
        projection's input in the compute dtype (flax Dense casts it)."""
        out = _rms_norm(output).reshape(B, T, self.num_heads * self.head_dim)
        out = F.silu(g) * out
        return self.out_proj(out.to(dtype))

    # ------------------------------------------------------------- parallel
    def _parallel(self, qr, kr, v, mask):
        B, T = v.shape[:2]
        vr = v.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)
        qk = _f32_product("bhqd,bhkd->bhqk", qr, kr) * mask
        qk = qk / qk.detach().abs().sum(-1, keepdim=True).clamp(1.0, 5e4)
        return _f32_product("bhqk,bhkd->bqhd", qk.to(vr.dtype), vr).to(vr.dtype)

    # ------------------------------------------------------------ chunkwise
    def _chunkwise(self, qr, kr, v, inner):
        mask, cross_decay, query_inner_decay, value_inner_decay = inner
        B, T0 = v.shape[:2]
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        C = mask.shape[1]
        pad = (-T0) % C
        if pad:
            qr, kr = F.pad(qr, (0, 0, 0, pad)), F.pad(kr, (0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, pad))
        N = (T0 + pad) // C
        qr = qr.reshape(B, nh, N, C, kd).transpose(1, 2)  # [B, N, nh, C, kd]
        kr = kr.reshape(B, nh, N, C, kd).transpose(1, 2)
        v = v.reshape(B, N, C, nh, hd).transpose(2, 3)  # [B, N, nh, C, hd]

        qk = _f32_product("bnhqd,bnhkd->bnhqk", qr, kr) * mask
        inner_scale = qk.detach().abs().sum(-1, keepdim=True).clamp(min=1.0)
        qk = qk / inner_scale
        inner_output = _f32_product("bnhqk,bnhkd->bnhqd", qk.to(v.dtype), v).to(v.dtype)

        # each chunk's reduced key-value product, then the recurrence over chunks
        kv = _f32_product("bnhkd,bnhke->bnhde", kr, v * value_inner_decay.to(v.dtype))
        kv_state = kv.new_zeros(B, nh, kd, hd)
        kv_scale = kv.new_ones(B, nh, 1, 1)
        states, scales = [], []
        for i in range(N):
            states.append(kv_state / kv_scale)
            scales.append(kv_scale)
            kv_state = kv_state * cross_decay + kv[:, i]
            kv_scale = (kv_state.detach().abs().sum(-2, keepdim=True).amax(-1, keepdim=True)
                        .clamp(min=1.0))
        kv_rec = torch.stack(states, 1)  # [B, N, nh, kd, hd]
        cross_scale = torch.stack(scales, 1)  # [B, N, nh, 1, 1]
        all_scale = torch.maximum(inner_scale, cross_scale)
        align_inner, align_cross = all_scale / inner_scale, all_scale / cross_scale

        cross_output = _f32_product("bnhqd,bnhde->bnhqe",
                                    qr * query_inner_decay.to(qr.dtype), kv_rec.to(qr.dtype))
        output = (inner_output / align_inner.to(v.dtype)
                  + cross_output.to(v.dtype) / align_cross.to(v.dtype))
        return output.transpose(2, 3).reshape(B, N * C, nh, hd)[:, :T0]

    # ------------------------------------------------------------ recurrent
    @staticmethod
    def init_state(batch: int, num_heads: int, key_dim: int, head_dim: int,
                   device=None) -> Dict[str, object]:
        """The recurrent state, float32: the key-value product [B, nh, kd,
        hd], the scale [nh] shared by every stream, and whether a frame was
        seen."""
        return {"prev_key_value": torch.zeros(batch, num_heads, key_dim, head_dim,
                                              device=device),
                "scale": torch.zeros(num_heads, device=device),
                "initialized": False}

    def _recurrent_step(self, qr, kr, v, decay, state):
        """One frame: qr, kr [B, nh, 1, kd], v [B, 1, V] -> (out [B, 1, nh,
        hd], state')."""
        B = v.shape[0]
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        kv = kr.reshape(B, nh, kd, 1) * v.reshape(B, nh, 1, hd)
        if state["initialized"]:
            prev = state["scale"]
            scale = prev * decay + 1.0
            mix = torch.sqrt(prev) * decay / torch.sqrt(scale)
        else:
            scale, mix = torch.ones_like(decay), torch.zeros_like(decay)
        kv = state["prev_key_value"] * mix[:, None, None] + kv / torch.sqrt(scale)[:, None, None]
        out = (qr.reshape(B, nh, kd, 1) * kv).sum(2)  # [B, nh, hd]
        return out.reshape(B, 1, nh, hd), {"prev_key_value": kv, "scale": scale,
                                           "initialized": True}

    def _recurrent_seq(self, qr, kr, v, decay):
        """The whole sequence through the O(1)-state recurrence."""
        B, nh, T, kd = qr.shape
        state = self.init_state(B, nh, kd, self.head_dim, device=v.device)
        outs = []
        for t in range(T):
            out, state = self._recurrent_step(qr[:, :, t:t + 1], kr[:, :, t:t + 1],
                                              v[:, t:t + 1], decay, state)
            outs.append(out)
        return torch.cat(outs, 1)  # [B, T, nh, hd]

    # -------------------------------------------------------------- forward
    def forward(self, x, rel_pos, chunkwise_recurrent: bool = False, recurrent: bool = False,
                rope: bool = True):
        output, g = self.retain(x, rel_pos, chunkwise_recurrent, recurrent, rope)
        return self._finish(output, g, *x.shape[:2], x.dtype)

    def retain(self, x, rel_pos, chunkwise_recurrent: bool = False, recurrent: bool = False,
               rope: bool = True):
        """The retention before its gate and output projection: (output [B,
        T, nh, hd], g [B, T, V])."""
        (sin, cos), inner = rel_pos
        g = self.g_proj(x)
        qr, kr, v = self._qkv(x, sin, cos, rope)
        la = self.look_ahead
        if la > 0:
            kr, v = F.pad(kr, (0, 0, 0, la)), F.pad(v, (0, 0, 0, la))
            qr = F.pad(qr, (0, 0, la, 0))
        if recurrent:
            if la:
                raise ValueError("the recurrent path takes no look_ahead")
            output = self._recurrent_seq(qr, kr, v, inner)
        elif chunkwise_recurrent:
            output = self._chunkwise(qr, kr, v, inner)
        else:
            output = self._parallel(qr, kr, v, inner)
        return (output[:, :-la] if la > 0 else output), g

    def streaming_step(self, x_t, rel_pos_t, state, rope: bool = True):
        """One frame x_t [B, 1, H] -> (y_t [B, 1, H], state'); ``rel_pos_t``
        from ``RetNetRelPos.recurrent`` or ``recurrent_dynamic``."""
        (sin, cos), decay = rel_pos_t
        g = self.g_proj(x_t)
        qr, kr, v = self._qkv(x_t, sin[None], cos[None], rope)
        out, state = self._recurrent_step(qr, kr, v, decay, state)
        return self._finish(out, g, x_t.shape[0], 1, x_t.dtype), state
