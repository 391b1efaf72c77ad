"""Mamba (selective SSM) block, channel-last.

Counterpart of ``nbss_tpu/models/mamba.py`` (Mamba v1): in_proj -> [x, z];
causal depthwise conv; x_proj -> [dt, B, C]; dt_proj and a float32 softplus;
A = -exp(A_log); y = scan(x, dt, A, B, C) + D x; gate by silu(z); out_proj.
Parameters are float32 and named as mamba-ssm names them (``in_proj.weight``
[2 d_inner, d_model], ``conv1d.weight`` [d_inner, 1, d_conv], ``x_proj``,
``dt_proj``, ``A_log``, ``D``, ``out_proj``); the block computes in its
input's dtype and keeps dt, A and D in float32, as the JAX package does.

The scan is ``ops.ssm.selective_scan`` (the CUDA kernels on a CUDA tensor;
``fused_scan=False`` runs its plain versions there). ``init_state`` and
``streaming_step`` run one frame at a time with a ring buffer of the last
d_conv - 1 conv inputs, equal to the offline forward frame by frame.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nbss_tpu_torch.models.base import _uniform_
from nbss_tpu_torch.ops.ssm import selective_scan, step


class _Weights(nn.Module):
    """A weight (and optional bias) named like a torch Linear / Conv1d. It
    draws nothing itself: ``MambaBlock.reset_parameters`` does."""

    def __init__(self, *shape: int, bias: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))
        if bias is not None:
            self.bias = nn.Parameter(torch.empty(bias))


class MambaBlock(nn.Module):
    """x [B, T, d_model] -> [B, T, d_model], causal over T."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: Optional[int] = None, dt_min: float = 0.001, dt_max: float = 0.1,
                 dt_init_floor: float = 1e-4, fused_scan: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        di = expand * d_model
        R = dt_rank if dt_rank is not None else math.ceil(d_model / 16)
        self.d_inner, self.d_state, self.d_conv, self.rank = di, d_state, d_conv, R
        self.dt_min, self.dt_max, self.dt_init_floor = dt_min, dt_max, dt_init_floor
        self.fused_scan = fused_scan
        self.in_proj = _Weights(2 * di, d_model)
        self.conv1d = _Weights(di, 1, d_conv, bias=di)
        self.x_proj = _Weights(R + 2 * d_state, di)
        self.dt_proj = _Weights(di, R, bias=di)
        self.A_log = nn.Parameter(torch.empty(di, d_state))
        self.D = nn.Parameter(torch.empty(di))
        self.out_proj = _Weights(d_model, di)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initializers: flax's lecun_normal (a normal
        truncated at 2 sigma) for in_proj, x_proj and out_proj; uniform in
        +-sqrt(3 / rank) for the dt_proj weight and +-1/sqrt(d_conv) for the
        conv (variance_scaling(1/3)); the dt bias the inverse softplus of a
        log-uniform draw in [dt_min, dt_max]; conv bias 0; A_log = log(1..N);
        D = 1."""
        g = generator
        for lin in (self.in_proj, self.x_proj, self.out_proj):
            std = math.sqrt(1.0 / lin.weight.shape[1]) / 0.87962566103423978
            lin.weight.copy_(nn.init.trunc_normal_(torch.empty(lin.weight.shape), std=std,
                                                   a=-2 * std, b=2 * std, generator=g))
        _uniform_(self.dt_proj.weight, math.sqrt(3.0 / self.rank), g)
        _uniform_(self.conv1d.weight, 1.0 / math.sqrt(self.d_conv), g)
        self.conv1d.bias.zero_()
        u = torch.rand(self.d_inner, generator=g)
        lo, hi = math.log(self.dt_min), math.log(self.dt_max)
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=self.dt_init_floor)
        self.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))  # inverse softplus
        self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                         .expand(self.d_inner, -1))
        self.D.fill_(1.0)

    def _ssm_inputs(self, xi):
        proj = F.linear(xi, self.x_proj.weight.to(xi.dtype))
        dt, Bm, Cm = proj.split([self.rank, self.d_state, self.d_state], dim=-1)
        dt = F.linear(dt, self.dt_proj.weight.to(xi.dtype), self.dt_proj.bias.to(xi.dtype))
        return F.softplus(dt.float()), Bm, Cm

    def forward(self, x):
        dtype = x.dtype
        xi, z = F.linear(x, self.in_proj.weight.to(dtype)).chunk(2, dim=-1)
        k = self.d_conv
        xc = F.conv1d(F.pad(xi.transpose(1, 2), (k - 1, 0)), self.conv1d.weight.to(dtype),
                      self.conv1d.bias.to(dtype), groups=self.d_inner)
        xi = F.silu(xc.transpose(1, 2)).contiguous()
        dt, Bm, Cm = self._ssm_inputs(xi)
        y = selective_scan(xi, dt, -torch.exp(self.A_log), Bm.contiguous(), Cm.contiguous(),
                           self.D, kernel=self.fused_scan)
        return F.linear(y * F.silu(z), self.out_proj.weight.to(dtype))

    # ------------------------------------------------------------ streaming
    def init_state(self, batch: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
        return {"conv": torch.zeros(batch, self.d_conv - 1, self.d_inner, dtype=dtype,
                                    device=device),
                "ssm": torch.zeros(batch, self.d_inner, self.d_state, device=device)}

    def streaming_step(self, x_t, state: Dict[str, torch.Tensor]):
        """x_t [B, 1, d_model] -> (y_t [B, 1, d_model], state')."""
        dtype = x_t.dtype
        xi, z = F.linear(x_t, self.in_proj.weight.to(dtype)).chunk(2, dim=-1)
        window = torch.cat([state["conv"], xi], dim=1)  # [B, k, d_inner]
        w = self.conv1d.weight[:, 0, :].t().to(xi.dtype)  # [k, d_inner]
        conv = (window * w).sum(1, keepdim=True) + self.conv1d.bias.to(xi.dtype)
        xi = F.silu(conv)
        dt, Bm, Cm = self._ssm_inputs(xi)
        h, y = step(state["ssm"], xi[:, 0], dt[:, 0], -torch.exp(self.A_log), Bm[:, 0],
                    Cm[:, 0], self.D)
        y = y[:, None] * F.silu(z)
        out = F.linear(y, self.out_proj.weight.to(y.dtype))
        return out, {"conv": window[:, 1:], "ssm": h}
