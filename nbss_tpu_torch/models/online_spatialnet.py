"""Online SpatialNet: streaming long-term enhancement (SPL 2024), mamba branch.

Counterpart of ``nbss_tpu/models/online_spatialnet.py`` for
``attention="mamba(d_state,d_conv)"`` with the second Mamba block in place of
the T-ConvFFN (the committed ``mamba(16,4)`` configuration). Each layer is

    cross-band block:  fconv1 -> full-band linear -> fconv2   in [B, T, F, H]
                       (the same modules and names as SpatialNet)
    time module:       x + Mamba(LN(x))  over T               in [B*F, T, H]
    FFN:               x + Mamba(LN(x))  over T

under a causal encoder conv (kernel 5) and a Linear decoder, so the whole
model is causal over T. ``init_streaming_state`` and ``streaming_step`` run
one frame at a time and equal the offline forward frame by frame.

The other branches of the JAX package wait for later slices of the port
(ROADMAP): ``mhsa(N)`` needs the narrow-band attention kernels,
``ret(...)`` the retention module, and ``not_replace_ffn`` the causal
T-ConvFFN with its cross-group norm. ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) when gradients are recorded.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nbss_tpu_torch.models.base import Conv1d, Linear, LinearGroup, PReLU, new_norm
from nbss_tpu_torch.models.mamba import MambaBlock
from nbss_tpu_torch.models.spatialnet import SpatialNetLayer


def parse_attention(attention: str):
    """'mhsa(251)' / 'mhsa(inf)' / 'ret(2,share_qk)' / 'mamba(16,4)', as the
    JAX package parses them."""
    if attention.startswith("ret"):
        parts = attention[4:-1].split(",")
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


def _refuse(attention: str) -> Dict[str, Any]:
    """The mamba branch's settings, or NotImplementedError for a branch that
    a later slice of the port brings."""
    kind, cfg = parse_attention(attention)
    if kind == "mhsa":
        raise NotImplementedError(
            f"attention={attention!r}: the mhsa(N) branch needs the narrow-band attention "
            "kernels (ROADMAP queue B rows 4-5), a later slice of the port")
    if kind == "ret":
        raise NotImplementedError(
            f"attention={attention!r}: the retention branch needs models/retention.py, "
            "a later slice of the port (ROADMAP A7)")
    if not cfg["replace_ffn"]:
        raise NotImplementedError(
            f"attention={attention!r}: not_replace_ffn needs the causal T-ConvFFN and "
            "CrossGroupNorm, a later slice of the port (ROADMAP A7)")
    return cfg


class OnlineSpatialNetLayer(nn.Module):
    def __init__(self, dim_hidden: int, dim_squeeze: int, full: LinearGroup,
                 attention: str = "mamba(16,4)", kernel_size: Tuple[int, int] = (5, 3),
                 conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 fused_scan: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = _refuse(attention)
        H, S, g = dim_hidden, dim_squeeze, generator
        f_groups, t_groups = conv_groups
        f_k = kernel_size[0]
        self.fconv1 = nn.Sequential(new_norm(norms[3], H, f_groups),
                                    Conv1d(H, H, f_k, groups=f_groups, generator=g), PReLU(H))
        self.norm_full = new_norm(norms[5], H, f_groups)
        self.squeeze = nn.Sequential(Conv1d(H, S, 1, generator=g), nn.SiLU())
        self.full = full
        self.unsqueeze = nn.Sequential(Conv1d(S, H, 1, generator=g), nn.SiLU())
        self.fconv2 = nn.Sequential(new_norm(norms[4], H, f_groups),
                                    Conv1d(H, H, f_k, groups=f_groups, generator=g), PReLU(H))
        mamba = dict(d_state=cfg["d_state"], d_conv=cfg["d_conv"], fused_scan=fused_scan,
                     generator=g)
        self.norm_mhsa = new_norm(norms[0], H, t_groups)
        self.mhsa = MambaBlock(H, **mamba)
        self.norm_tconvffn = new_norm(norms[1], H, t_groups)
        self.tconvffn = MambaBlock(H, **mamba)

    _full = SpatialNetLayer._full  # the full-band linear of the cross-band block

    def _cross_band(self, xt):
        """xt [B, T, F, H]: each frame on its own."""
        xt = xt + self.fconv1(xt)
        xt = xt + self._full(xt)
        return xt + self.fconv2(xt)

    def forward(self, x):
        """x: [B, F, T, H] -> [B, F, T, H]."""
        B, Fq, T, H = x.shape
        x = self._cross_band(x.transpose(1, 2)).transpose(1, 2)
        x = x + self.mhsa(self.norm_mhsa(x).reshape(B * Fq, T, H)).reshape(B, Fq, T, H)
        return x + self.tconvffn(self.norm_tconvffn(x).reshape(B * Fq, T, H)).reshape(
            B, Fq, T, H)

    def init_streaming_state(self, B: int, F: int, dtype=torch.float32, device=None):
        return {"time": self.mhsa.init_state(B * F, dtype, device),
                "ffn": self.tconvffn.init_state(B * F, dtype, device)}

    def streaming_step(self, x_t, state):
        """One frame: x_t [B, F, H] -> (y_t [B, F, H], state')."""
        B, Fq, H = x_t.shape
        x = self._cross_band(x_t[:, None])[:, 0]
        y, time = self.mhsa.streaming_step(self.norm_mhsa(x).reshape(B * Fq, 1, H),
                                           state["time"])
        x = x + y.reshape(B, Fq, H)
        y, ffn = self.tconvffn.streaming_step(self.norm_tconvffn(x).reshape(B * Fq, 1, H),
                                              state["ffn"])
        return x + y.reshape(B, Fq, H), {"time": time, "ffn": ffn}


class OnlineSpatialNet(nn.Module):
    """[B, F, T, dim_input] -> [B, F, T, dim_output] (float32 out), causal over T.

    ``dtype`` is the compute dtype (parameters stay float32). ``dim_ffn`` and
    ``num_heads`` belong to the other branches (T-ConvFFN, attention); the
    mamba branch does not read them. The weights are drawn on the CPU from
    ``generator`` and then moved to ``device``."""

    def __init__(self, dim_input: int, dim_output: int, num_layers: int, dim_squeeze: int,
                 num_freqs: int, encoder_kernel_size: int = 5, dim_hidden: int = 192,
                 dim_ffn: int = 384, num_heads: int = 2,
                 kernel_size: Tuple[int, int] = (5, 3), conv_groups: Tuple[int, int] = (8, 8),
                 norms: Sequence[str] = ("LN", "LN", "GN", "LN", "LN", "LN"),
                 full_share: int = 0, attention: str = "mhsa(251)",
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 remat_policy: Optional[str] = None, fused_scan: bool = True,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        _refuse(attention)
        if remat_policy not in (None, "none"):
            raise NotImplementedError(
                f"remat_policy={remat_policy!r}: only full recomputation is ported "
                "(ROADMAP A7); use remat_policy=None")
        g = generator
        self.dtype, self.remat = dtype, remat
        self.num_freqs, self.dim_input, self.dim_hidden = num_freqs, dim_input, dim_hidden
        self.encoder = Conv1d(dim_input, dim_hidden, encoder_kernel_size, padding="causal",
                              generator=g)
        fulls = [LinearGroup(num_freqs, num_freqs, dim_squeeze, generator=g)
                 for _ in range(min(full_share, num_layers - 1) + 1)]
        self.layers = nn.ModuleList(
            OnlineSpatialNetLayer(dim_hidden, dim_squeeze, full=fulls[min(l, len(fulls) - 1)],
                                  attention=attention, kernel_size=kernel_size,
                                  conv_groups=conv_groups, norms=norms, fused_scan=fused_scan,
                                  generator=g)
            for l in range(num_layers))
        self.decoder = Linear(dim_hidden, dim_output, generator=g)
        self.to(device)

    def forward(self, x):
        x = self.encoder(x.to(self.dtype or x.dtype))  # causal conv over T for each (B, F)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        return self.decoder(x).float()

    # ------------------------------------------------------------ streaming
    def init_streaming_state(self, B: int) -> Dict[str, Any]:
        """The state of frame-by-frame inference for B utterances: the
        encoder's last k-1 input frames and each layer's conv ring buffers
        and SSM states, in the compute dtype (the SSM states in float32)."""
        dtype = self.dtype or torch.float32
        dev = self.decoder.weight.device
        k = self.encoder.kernel_size
        return {"enc": torch.zeros(B, self.num_freqs, k - 1, self.dim_input, dtype=dtype,
                                   device=dev),
                "layers": [layer.init_streaming_state(B, self.num_freqs, dtype, dev)
                           for layer in self.layers]}

    def streaming_step(self, x_t, state):
        """One frame x_t [B, F, dim_input] -> (y_t [B, F, dim_output] float32,
        state')."""
        B, Fq, C = x_t.shape
        x_t = x_t.to(self.dtype or x_t.dtype)
        win = torch.cat([state["enc"], x_t[:, :, None]], dim=2)  # [B, F, k, C]
        w, b = self.encoder.weight.to(x_t.dtype), self.encoder.bias.to(x_t.dtype)
        h = F.conv1d(win.reshape(B * Fq, -1, C).transpose(1, 2), w, b).reshape(B, Fq, -1)
        layers = []
        for layer, st in zip(self.layers, state["layers"]):
            h, st = layer.streaming_step(h, st)
            layers.append(st)
        return self.decoder(h).float(), {"enc": win[:, :, 1:], "layers": layers}
