"""Online SpatialNet: streaming long-term enhancement (SPL 2024).

Counterpart of ``nbss_tpu/models/online_spatialnet.py``. Each layer is

    cross-band block:  fconv1 -> full-band linear -> fconv2   in [B, T, F, H]
                       (the same modules and names as SpatialNet)
    time module:       x + MHSA(LN(x), mask) or x + Mamba(LN(x)) over T
    FFN:               x + T-ConvFFN(x), or x + Mamba(LN(x)) over T

under a causal encoder conv (kernel 5) and a Linear decoder, so the whole
model is causal over T. The time module is chosen by ``attention``:

- ``mhsa(N)``: masked multi-head self-attention over the last N frames
  (``local_causal_mask``; ``rope="ALiBi"`` adds a per-head slope,
  ``alibi_mask``; ``mhsa(inf)`` is unbounded causal), through
  ``ops.attention.narrowband_attention`` (the CUDA kernels on a CUDA tensor);
- ``ret(value_factor,share_qk|not_share_qk)``: multi-scale retention
  (``models/retention.py``) with the per-head ``decay``; training runs it
  chunkwise, serving chunkwise too unless ``chunkwise_recurrent=False``
  and ``forward(x, inference=True)``, which run the O(1)-state recurrence;
- ``mamba(d_state,d_conv)``: a Mamba block through ``ops.ssm`` (any state
  size), which also replaces the T-ConvFFN unless the string holds
  ``not_replace_ffn``.

The T-ConvFFN is causal: LN -> 1x1 up -> SiLU -> three grouped causal convs
over T, with SiLU and a ``CrossGroupNorm`` (statistics over frequency and
the group's channels at each frame) between them -> 1x1 down. The mhsa and
T-ConvFFN layer is, module for module and name for name, the offline
SpatialNet layer. ``init_streaming_state`` and ``streaming_step`` run one
frame at a time (a KV ring buffer of N - 1 frames for mhsa(N), the convs'
ring buffers, the retention's key-value state, the Mamba states) and equal
the offline (for ret, the recurrent) forward frame by frame. The streaming
step is plain PyTorch, as it is plain code in the JAX package.

``dropout`` takes the JAX package's three rates: after the time module,
after the FFN, and on whole frequencies of an utterance in the full-band
module; active in training mode. ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) when gradients are recorded:
``remat_policy=None`` recomputes the whole layer in the backward,
``remat_policy="dots"`` keeps the outputs of its unbatched matrix products
(``aten.mm``, ``aten.addmm``: the Linear layers) and recomputes the rest,
the counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.
Dropout draws from the global generator, whose state the checkpoint restores
for the recompute, so the recomputed masks are the first ones.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from nbss_tpu_torch.models.base import (
    Conv1d,
    Linear,
    LinearGroup,
    MultiheadAttention,
    PReLU,
    _norm_stats,
    new_norm,
)
from nbss_tpu_torch.models.mamba import MambaBlock
from nbss_tpu_torch.models.retention import MultiScaleRetention, RetNetRelPos
from nbss_tpu_torch.models.spatialnet import SpatialNetLayer


def parse_attention(attention: str):
    """'mhsa(251)' / 'mhsa(inf)' / 'ret(2,share_qk)' / 'mamba(16,4)', as the
    JAX package parses them."""
    if attention.startswith("ret"):
        parts = attention[4:-1].split(",")
        if len(parts) != 2 or parts[1] not in ("share_qk", "not_share_qk"):
            raise ValueError(f"attention {attention!r}: expected ret(v,share_qk|not_share_qk)")
        return ("ret", {"value_factor": int(parts[0]), "share_qk": parts[1] == "share_qk"})
    if attention.startswith("mamba"):
        inner = attention[attention.index("(") + 1:attention.index(")")]
        d_state, d_conv = (int(v) for v in inner.split(","))
        return ("mamba", {"d_state": d_state, "d_conv": d_conv,
                          "replace_ffn": "not_replace_ffn" not in attention})
    if not attention.startswith("mhsa"):
        raise ValueError(f"unknown attention {attention!r}")
    scope = attention[5:-1]
    return ("mhsa", {"scope": math.inf if scope == "inf" else int(scope)})


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """remat_policy='dots': keep the outputs of unbatched matrix products,
    recompute everything else (batched products, convolutions, the
    selective-scan Function and its kernel launch)."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def local_causal_mask(slen: int, scope: float) -> np.ndarray:
    """[T, T] additive mask: 0 where 0 <= i - j < scope, else -inf (the JAX
    package's bounded scope, which the streaming KV ring buffer makes exact)."""
    i = np.arange(slen)
    rel = i[:, None] - i[None, :]
    return np.where((rel >= 0) & (rel < scope), 0.0, -np.inf).astype(np.float32)


def alibi_mask(slen: int, scope: float, num_heads: int) -> np.ndarray:
    """[nh, T, T] ALiBi mask: -m_h (i - j) inside the causal scope, with the
    slope m_h = 2^(-8 / h) of head h = 1..nh; else -inf."""
    i = np.arange(slen)
    rel = (i[:, None] - i[None, :]).astype(np.float32)
    m = 2.0 ** (-8.0 / np.arange(1, num_heads + 1))  # [nh]
    base = np.where((rel >= 0) & (rel < scope), -np.abs(rel), -np.inf)
    return (m[:, None, None] * base[None]).astype(np.float32)


class CrossGroupNorm(nn.Module):
    """GroupNorm over (frequency, channels in the group) at each frame: the
    online T-ConvFFN's mid norm, causal over T. Input [B, F, T, C]."""

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
        B, Fq, T, C = x.shape
        G = self.num_groups
        y = _norm_stats(x.reshape(B, Fq, T, G, C // G), (1, 4), self.eps).reshape(x.shape)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def _conv_frame(conv: Conv1d, window):
    """One causal output frame of ``conv`` from its last k input frames:
    window [..., k, C] -> [..., C_out]."""
    *lead, k, C = window.shape
    y = F.conv1d(window.reshape(-1, k, C).transpose(1, 2), conv.weight.to(window.dtype),
                 conv.bias.to(window.dtype), groups=conv.groups)
    return y.reshape(*lead, -1)


class OnlineSpatialNetLayer(nn.Module):
    def __init__(self, dim_hidden: int, dim_ffn: int, dim_squeeze: int, num_heads: int,
                 full: LinearGroup, attention: str = "mhsa(251)",
                 kernel_size: Tuple[int, int] = (5, 3), conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 dropout: Tuple[float, float, float] = (0, 0, 0),
                 fused_scan: bool = True, fused_attention: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind, self.cfg = parse_attention(attention)
        self.dropout = tuple(dropout)
        H, FF, S, g = dim_hidden, dim_ffn, dim_squeeze, generator
        f_groups, t_groups = conv_groups
        f_k, t_k = kernel_size
        self.fconv1 = nn.Sequential(new_norm(norms[3], H, f_groups),
                                    Conv1d(H, H, f_k, groups=f_groups, generator=g), PReLU(H))
        self.norm_full = new_norm(norms[5], H, f_groups)
        self.squeeze = nn.Sequential(Conv1d(H, S, 1, generator=g), nn.SiLU())
        self.full = full
        self.unsqueeze = nn.Sequential(Conv1d(S, H, 1, generator=g), nn.SiLU())
        self.fconv2 = nn.Sequential(new_norm(norms[4], H, f_groups),
                                    Conv1d(H, H, f_k, groups=f_groups, generator=g), PReLU(H))
        self.norm_mhsa = new_norm(norms[0], H, t_groups)
        if self.kind == "mamba":
            mamba = dict(d_state=self.cfg["d_state"], d_conv=self.cfg["d_conv"],
                         fused_scan=fused_scan, generator=g)
            self.mhsa = MambaBlock(H, **mamba)
        elif self.kind == "ret":
            self.mhsa = MultiScaleRetention(H, num_heads, self.cfg["value_factor"],
                                            share_qk=self.cfg["share_qk"], generator=g)
        else:
            self.mhsa = MultiheadAttention(H, num_heads, kernel=fused_attention, generator=g)
        self.replace_ffn = self.kind == "mamba" and self.cfg["replace_ffn"]
        if self.replace_ffn:
            self.norm_tconvffn = new_norm(norms[1], H, t_groups)
            self.tconvffn = MambaBlock(H, **mamba)
        else:
            causal = dict(groups=t_groups, padding="causal", generator=g)
            self.tconvffn = nn.Sequential(
                new_norm(norms[1], H, t_groups),
                Conv1d(H, FF, 1, generator=g), nn.SiLU(),
                Conv1d(FF, FF, t_k, **causal), nn.SiLU(),
                Conv1d(FF, FF, t_k, **causal),
                CrossGroupNorm(t_groups, FF), nn.SiLU(),
                Conv1d(FF, FF, t_k, **causal), nn.SiLU(),
                Conv1d(FF, H, 1, generator=g),
            )

    _full = SpatialNetLayer._full  # the full-band linear of the cross-band block
    _drop = SpatialNetLayer._drop

    def _cross_band(self, xt):
        """xt [B, T, F, H]: each frame on its own."""
        xt = xt + self.fconv1(xt)
        xt = xt + self._full(xt)
        return xt + self.fconv2(xt)

    def forward(self, x, rel_pos=None, chunkwise_recurrent: bool = True,
                recurrent: bool = False, rope: Union[bool, str] = False):
        """x: [B, F, T, H] -> [B, F, T, H]; rel_pos: the mhsa branch's
        additive [T, T] or [nh, T, T] mask, or the retention's tables."""
        B, Fq, T, H = x.shape
        x = self._cross_band(x.transpose(1, 2)).transpose(1, 2)
        y = self.norm_mhsa(x)
        if self.kind == "mhsa":
            y = self.mhsa(y, attn_mask=rel_pos)
        elif self.kind == "ret":
            y = self.mhsa(y.reshape(B * Fq, T, H), rel_pos, chunkwise_recurrent=chunkwise_recurrent,
                          recurrent=recurrent, rope=_ret_rope(rope)).reshape(B, Fq, T, H)
        else:
            y = self.mhsa(y.reshape(B * Fq, T, H)).reshape(B, Fq, T, H)
        x = x + self._drop(0, y)
        if self.replace_ffn:
            y = self.tconvffn(self.norm_tconvffn(x).reshape(B * Fq, T, H)).reshape(B, Fq, T, H)
        else:
            y = self.tconvffn(x)
        return x + self._drop(1, y)

    # ------------------------------------------------------------ streaming
    def init_streaming_state(self, B: int, F: int, dtype=torch.float32, device=None):
        """The time module's state (a KV ring buffer of scope - 1 frames, the
        retention's float32 key-value state, or the Mamba state) and the
        FFN's (the causal convs' last k - 1 inputs, or the Mamba state)."""
        H = self.norm_mhsa.weight.shape[0]
        st = {}
        if self.kind == "mamba":
            st["time"] = self.mhsa.init_state(B * F, dtype, device)
        elif self.kind == "ret":
            m = self.mhsa
            st["time"] = m.init_state(B * F, m.num_heads, m.key_dim, m.head_dim, device=device)
        else:
            scope = self.cfg["scope"]
            if not math.isfinite(scope):
                raise NotImplementedError(
                    "streaming mhsa needs a finite attention scope: use mhsa(N), as the JAX "
                    "package requires")
            st["time"] = {key: torch.zeros(B * F, scope - 1, H, dtype=dtype, device=device)
                          for key in ("k", "v")}
        if self.replace_ffn:
            st["ffn"] = self.tconvffn.init_state(B * F, dtype, device)
        else:
            conv = self.tconvffn[3]
            FF, k = conv.weight.shape[0], conv.kernel_size
            for key in ("ffn_conv1", "ffn_conv2", "ffn_conv3"):
                st[key] = torch.zeros(B, F, k - 1, FF, dtype=dtype, device=device)
        return st

    def streaming_step(self, x_t, state, rel_pos_t=None, rope: Union[bool, str] = False):
        """One frame: x_t [B, F, H] -> (y_t [B, F, H], state'). ``rel_pos_t``
        is, for mhsa, the frame's index in the stream (the ring-buffer slots
        the stream has not filled yet are masked), for ret the frame's
        rotation and decays."""
        B, Fq, H = x_t.shape
        x = self._cross_band(x_t[:, None])[:, 0]
        y = self.norm_mhsa(x)
        st = dict(state)
        if self.kind == "mamba":
            y, st["time"] = self.mhsa.streaming_step(y.reshape(B * Fq, 1, H), state["time"])
        elif self.kind == "ret":
            y, st["time"] = self.mhsa.streaming_step(y.reshape(B * Fq, 1, H), rel_pos_t,
                                                     state["time"], rope=_ret_rope(rope))
        else:
            y, st["time"] = self._mhsa_step(y.reshape(B * Fq, H), state["time"], rel_pos_t, rope)
        x = x + y.reshape(B, Fq, H)
        if self.replace_ffn:
            y, st["ffn"] = self.tconvffn.streaming_step(
                self.norm_tconvffn(x).reshape(B * Fq, 1, H), state["ffn"])
            return x + y.reshape(B, Fq, H), st
        ffn = self.tconvffn
        y = F.silu(ffn[1](ffn[0](x)))  # [B, F, FF]
        for key, conv, act in (("ffn_conv1", ffn[3], True), ("ffn_conv2", ffn[5], False),
                               ("ffn_conv3", ffn[8], True)):
            if key == "ffn_conv3":
                y = F.silu(ffn[6](y[:, :, None])[:, :, 0])  # the mid norm
            window = torch.cat([state[key], y[:, :, None]], dim=2)  # [B, F, k, FF]
            st[key] = window[:, :, 1:]
            y = _conv_frame(conv, window)
            if act:
                y = F.silu(y)
        return x + ffn[10](y), st

    def _mhsa_step(self, y, kv: Dict[str, torch.Tensor], t: int, rope):
        """Masked local attention for one frame through the KV ring buffer,
        as the JAX package's ``_mhsa_streaming_step``: y [M, H] (the
        normalized frame) -> (out [M, H], kv'), einsum with float32 scores
        and softmax, then rounded."""
        M, H = y.shape
        mha = self.mhsa
        nh = mha.num_heads
        dh = H // nh
        qkv = F.linear(y, mha.in_proj_weight.to(y.dtype), mha.in_proj_bias.to(y.dtype))
        q, k, v = qkv.chunk(3, dim=-1)
        K = torch.cat([kv["k"], k[:, None]], dim=1)  # [M, S, H]: the scope's frames
        V = torch.cat([kv["v"], v[:, None]], dim=1)
        S = K.shape[1]
        logits = torch.einsum("mhd,mshd->mhs", q.reshape(M, nh, dh).float(),
                              K.reshape(M, S, nh, dh).float()) / math.sqrt(dh)
        rel = torch.arange(S - 1, -1, -1, device=y.device)  # distance i - j of each slot
        if rope == "ALiBi":  # the per-head slope bias of alibi_mask
            slopes = torch.from_numpy(2.0 ** (-8.0 / np.arange(1, nh + 1, dtype=np.float32)))
            logits = logits - slopes.to(y.device)[None, :, None] * rel[None, None, :]
        logits = torch.where(rel[None, None, :] <= t, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(y.dtype).float()
        out = torch.einsum("mhs,mshd->mhd", probs, V.reshape(M, S, nh, dh).float())
        return mha.out_proj(out.to(y.dtype).reshape(M, H)), {"k": K[:, 1:], "v": V[:, 1:]}


def _ret_rope(rope: Union[bool, str]) -> bool:
    """The retention's xPos flag: ``rope`` unless it names ALiBi, as the JAX
    package reads it."""
    return bool(rope) and rope != "ALiBi"


class OnlineSpatialNet(nn.Module):
    """[B, F, T, dim_input] -> [B, F, T, dim_output] (float32 out), causal over T.

    ``dtype`` is the compute dtype (parameters stay float32). ``rope="ALiBi"``
    gives the mhsa branch its per-head ALiBi mask; a true ``rope`` otherwise
    turns on the retention's xPos rotation, as in the JAX package. ``decay``
    and ``chunkwise_recurrent`` are the retention's. ``fused_attention=False``
    and ``fused_scan=False`` run the plain versions of the kernels on the
    card too. The weights are drawn on the CPU from ``generator`` and then
    moved to ``device``."""

    def __init__(self, dim_input: int, dim_output: int, num_layers: int, dim_squeeze: int,
                 num_freqs: int, encoder_kernel_size: int = 5, dim_hidden: int = 192,
                 dim_ffn: int = 384, num_heads: int = 2,
                 dropout: Tuple[float, float, float] = (0, 0, 0),
                 kernel_size: Tuple[int, int] = (5, 3), conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 full_share: int = 0, attention: str = "mhsa(251)",
                 decay: Union[int, bool, Sequence, None] = 5, chunkwise_recurrent: bool = True,
                 rope: Union[bool, str] = False, dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 fused_scan: bool = True, fused_attention: bool = True,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.kind, cfg = parse_attention(attention)
        if remat_policy not in (None, "none", "dots"):
            raise ValueError(f"remat_policy={remat_policy!r}: expected None, 'none' or 'dots'")
        g = generator
        self.dtype, self.remat, self.rope = dtype, remat, rope
        self.remat_policy = None if remat_policy == "none" else remat_policy
        self.chunkwise_recurrent = chunkwise_recurrent
        self.scope, self.num_heads = cfg.get("scope"), num_heads
        self.num_freqs, self.dim_input, self.dim_hidden = num_freqs, dim_input, dim_hidden
        if self.kind == "ret":
            self.pos = RetNetRelPos(dim_hidden, num_heads, recurrent_chunk_size=64,
                                    decay=tuple(decay) if isinstance(decay, list) else decay)
        self.encoder = Conv1d(dim_input, dim_hidden, encoder_kernel_size, padding="causal",
                              generator=g)
        fulls = [LinearGroup(num_freqs, num_freqs, dim_squeeze, generator=g)
                 for _ in range(min(full_share, num_layers - 1) + 1)]
        self.layers = nn.ModuleList(
            OnlineSpatialNetLayer(dim_hidden, dim_ffn, dim_squeeze, num_heads,
                                  full=fulls[min(l, len(fulls) - 1)], attention=attention,
                                  kernel_size=kernel_size, conv_groups=conv_groups, norms=norms,
                                  dropout=dropout, fused_scan=fused_scan,
                                  fused_attention=fused_attention, generator=g)
            for l in range(num_layers))
        self.decoder = Linear(dim_hidden, dim_output, generator=g)
        self.to(device)

    def get_rel_pos(self, T: int, chunkwise_recurrent: bool, recurrent: bool, device):
        """What the time module takes for T frames: the retention's tables of
        the chosen path, the mhsa branch's additive mask ([T, T], or
        [nh, T, T] with ALiBi), or None for the mamba branch."""
        if self.kind == "ret":
            if recurrent:
                return self.pos.recurrent_seq(T, device)
            if chunkwise_recurrent:
                return self.pos.chunkwise(T, device)
            return self.pos.parallel(T, device)
        if self.kind == "mamba":
            return None
        m = (alibi_mask(T, self.scope, self.num_heads) if self.rope == "ALiBi"
             else local_causal_mask(T, self.scope))
        return torch.from_numpy(m).to(device)

    def forward(self, x, inference: bool = False):
        """``inference=True`` runs the retention through its O(1)-state
        recurrence when ``chunkwise_recurrent`` is off; training, and serving
        otherwise, run it chunkwise when ``chunkwise_recurrent`` is on (always
        in training) and in parallel when it is off, the JAX package's rule."""
        recurrent = bool(inference) and self.kind == "ret" and not self.chunkwise_recurrent
        chunkwise = False if recurrent else self.chunkwise_recurrent
        if not inference and self.kind == "ret":
            chunkwise = True
        rel_pos = self.get_rel_pos(x.shape[2], chunkwise, recurrent, x.device)
        x = self.encoder(x.to(self.dtype or x.dtype))  # causal conv over T for each (B, F)
        args = (rel_pos, chunkwise, recurrent, self.rope)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                kw = ({"context_fn": partial(create_selective_checkpoint_contexts, _dots_policy)}
                      if self.remat_policy == "dots" else {})
                x = checkpoint(layer, x, *args, use_reentrant=False, **kw)
            else:
                x = layer(x, *args)
        return self.decoder(x).float()

    # ------------------------------------------------------------ streaming
    def init_streaming_state(self, B: int) -> Dict[str, Any]:
        """The state of frame-by-frame inference for B utterances: the frame
        counter, the encoder's last k-1 input frames and each layer's ring
        buffers and states, in the compute dtype (SSM and retention states in
        float32)."""
        dtype = self.dtype or torch.float32
        dev = self.decoder.weight.device
        k = self.encoder.kernel_size
        return {"t": 0,
                "enc": torch.zeros(B, self.num_freqs, k - 1, self.dim_input, dtype=dtype,
                                   device=dev),
                "layers": [layer.init_streaming_state(B, self.num_freqs, dtype, dev)
                           for layer in self.layers]}

    def streaming_step(self, x_t, state):
        """One frame x_t [B, F, dim_input] -> (y_t [B, F, dim_output] float32,
        state')."""
        x_t = x_t.to(self.dtype or x_t.dtype)
        window = torch.cat([state["enc"], x_t[:, :, None]], dim=2)  # [B, F, k, C]
        h = _conv_frame(self.encoder, window)
        t = state["t"]
        rel_pos_t = self.pos.recurrent_dynamic(t, h.device) if self.kind == "ret" else t
        layers = []
        for layer, st in zip(self.layers, state["layers"]):
            h, st = layer.streaming_step(h, st, rel_pos_t, self.rope)
            layers.append(st)
        return self.decoder(h).float(), {"t": t + 1, "enc": window[:, :, 1:],
                                         "layers": layers}
