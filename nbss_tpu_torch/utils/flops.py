"""FLOP and parameter accounting, written to FLOPs.yaml at the start of a run.

Counterpart of ``nbss_tpu/utils/flops.py``, with its keys. The JAX package
reads the numbers from XLA's cost analysis of the compiled program; the port
counts with ``torch.utils.flop_counter.FlopCounterMode``, as the reference's
own ``flops.py`` did. The two differ in what they count: the counter sees
matrix products, convolutions and attention (2 FLOPs a multiply-add), while
XLA's cost analysis also counts elementwise work (norms, activations,
softmax, the STFT's arithmetic). The counter cannot see inside a kernel
launched through ctypes either, so the count runs on a copy of the arch with
every kernel route off (``plain_copy``): the plain module composition, with
unfolded attention. ``bytes_accessed_forward`` adds up the bytes each
PyTorch operation of that forward reads and writes (views left out), the
counterpart of XLA's "bytes accessed". ``params`` counts every parameter once.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# the switches of the models' kernel routes (SpatialNet's folded block and
# T-ConvFFN, the attention modules' fused path and kernel, Mamba's scan)
KERNEL_FLAGS = ("fused_block", "fused_ffn", "fused", "kernel", "fused_scan")


def plain_copy(arch: torch.nn.Module) -> torch.nn.Module:
    """A deep copy of ``arch`` with every kernel route turned off."""
    net = copy.deepcopy(arch)
    for m in net.modules():
        for flag in KERNEL_FLAGS:
            if isinstance(getattr(m, flag, None), bool):
                setattr(m, flag, False)
    return net


class _BytesMode(TorchDispatchMode):
    """Adds up the bytes of every tensor each operation reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def count_flops(module, x: torch.Tensor, audio_seconds: Optional[float] = None) -> Dict[str, Any]:
    """FLOPs of the forward and of the backward of the TrainModule pipeline.

    Args:
        module: TrainModule.
        x: example waveform batch [B, C, T].
    Returns:
        dict with flops_forward, flops_forward_avg (per second of audio, when
        ``audio_seconds`` is given), flops_backward, params and
        bytes_accessed_forward.
    """
    arch = plain_copy(module.arch).eval()
    plain = dataclasses.replace(module, arch=arch)
    dev = next(arch.parameters()).device
    x = torch.as_tensor(x).to(dev)

    with torch.no_grad(), FlopCounterMode(display=False) as fwd, _BytesMode() as nbytes:
        plain._forward(x)
    with torch.enable_grad(), FlopCounterMode(display=False) as both:
        yr_hat, _ = plain._forward(x)
        yr_hat.float().mean().backward()
    flops_f = float(fwd.get_total_flops())
    flops_fb = float(both.get_total_flops())
    out = {
        "flops_forward": flops_f,
        "flops_backward": max(flops_fb - flops_f, 0.0),
        "params": int(sum(p.numel() for p in module.arch.parameters())),
        "bytes_accessed_forward": float(nbytes.bytes),
    }
    if audio_seconds:
        out["flops_forward_avg"] = flops_f / audio_seconds  # FLOPs per audio-second
    return out


def write_flops(log_dir: str, module, x: torch.Tensor,
                audio_seconds: Optional[float] = None) -> Dict[str, Any]:
    """``count_flops`` written to ``log_dir``/FLOPs.yaml (keys sorted, as
    ``yaml.safe_dump`` writes them)."""
    from nbss_tpu_torch.cli import yamlio

    out = count_flops(module, x, audio_seconds)
    with open(os.path.join(log_dir, "FLOPs.yaml"), "w") as f:
        f.write(yamlio.dumps(dict(sorted(out.items()))))
    return out
