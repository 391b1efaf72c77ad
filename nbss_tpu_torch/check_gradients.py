"""Gradient parity of SpatialNet-small's fp32 kernel path at trained weights.

    python3 -m nbss_tpu_torch.check_gradients

Fits SpatialNet-small in bf16 for 20 steps on one fixed batch and takes one
more step, as ``chip_smoke.py`` phase 7 does (``Trainer`` with Adam 1e-3,
clip 5, seed 2; 8 ``SyntheticDataset`` items of 6 channels x 4 s at 8 kHz;
neg-SI-SDR with PIT; the extra step is the one whose launches phase 7
counts), so that it reads the weights phase 8 reads. It then takes that
batch's gradients from the trained state dict three ways: through the
kernels in float32, through the plain module composition in float32, and
through the plain composition with its arch in float64 (the STFT, norm and
loss stay float32 in all three). At trained weights two
float32 runs that round differently can be 1e-2 x max|grad| apart on the
cross-band convs, so neither is the reference: ``hold`` holds the kernel
path to the float64 run by the float32 counterpart of the bf16 rule. Prints
each gap's worst parameter; exits 1 if the rule fails. Needs a CUDA card;
TF32 is off.
"""

from __future__ import annotations

import sys
from typing import Optional

RTOL = 5e-3  # the JAX package's gradient bound, scaled to each parameter's largest entry
SPATIALNET_SMALL = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                        num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                        num_freqs=129, full_share=0)
B, CHANNELS, SECONDS, FS, STEPS = 8, 6, 4.0, 8000, 20


def gradients(module, batch, arch_kwargs: dict, device, parts64: int = 4, arch_cls=None,
              plain: Optional[dict] = None, parts32: int = 1, kernel: Optional[dict] = None,
              plain64: Optional[dict] = None) -> dict:
    """One batch's parameter gradients from ``module.arch``'s state dict,
    as float64, under the keys ``kernel`` (``arch_cls`` built with
    ``kernel``), ``plain32`` (built with ``plain``) and ``plain64`` (with
    ``plain64``); the batch mean is taken in ``parts32`` parts in float32
    and ``parts64`` in float64, to bound the attention's memory.
    ``arch_cls`` is SpatialNet unless given, built from ``arch_kwargs``;
    ``kernel`` is ``{"fused_block": True}``, ``plain`` ``{"fused_block":
    False}`` and ``plain64`` ``plain`` with its arch in float64 unless given.
    A parameter that gets no gradient gets zeros. ``batch`` is on
    ``device``."""
    import torch

    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.train.module import TrainModule

    arch_cls = arch_cls or SpatialNet
    plain = plain if plain is not None else dict(fused_block=False)
    kernel = kernel if kernel is not None else dict(fused_block=True)
    plain64 = plain64 if plain64 is not None else dict(plain, dtype=torch.float64)
    n, grads = len(batch[0]), {}
    for key, kw, parts in (("kernel", kernel, parts32), ("plain32", plain, parts32),
                           ("plain64", plain64, parts64)):
        net = arch_cls(**arch_kwargs, **kw, device=device)
        net.load_state_dict(module.arch.state_dict())
        m = TrainModule(**{**module.__dict__, "arch": net})
        for i in range(0, n, n // parts):
            part = tuple(t[i:i + n // parts] for t in batch[:2]) + tuple(batch[2:])
            (m.training_step(part) / parts).backward()
        grads[key] = {name: (torch.zeros_like(p) if p.grad is None else p.grad).double()
                      for name, p in net.named_parameters()}
        del net, m
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return grads


def hold(grads: dict, rtol: float = RTOL, exempt=()) -> str:
    """Raise AssertionError unless every parameter's kernel gradient is
    non-zero and no farther, from the float64 gradient and from the plain
    float32 one, than max(rtol x max|float64|, 2 x max|plain32 - float64|):
    the kernel path may miss the float64 run by twice what the plain float32
    run misses it by, or by the float32 bound where that run is close.
    Returns a line with each gap's worst parameter, over max|float64|.
    Parameters named in ``exempt`` are left out: those whose gradient is 0
    in exact arithmetic, which a kernel's fold drops (NBC's key bias, whose
    constant score row the softmax removes)."""
    worst = {"kernel - float64": (0.0, ""), "plain fp32 - float64": (0.0, ""),
             "kernel - plain fp32": (0.0, "")}
    for name, g64 in grads["plain64"].items():
        if name in exempt:
            continue
        gk, g32 = grads["kernel"][name], grads["plain32"][name]
        scale = max(g64.abs().max().item(), 1e-30)
        gaps = {"kernel - float64": (gk - g64).abs().max().item(),
                "plain fp32 - float64": (g32 - g64).abs().max().item(),
                "kernel - plain fp32": (gk - g32).abs().max().item()}
        bound = max(rtol * scale, 2 * gaps["plain fp32 - float64"])
        if gk.abs().max() == 0:
            raise AssertionError(f"gradient of {name} through the kernels is zero")
        for label in ("kernel - float64", "kernel - plain fp32"):
            if gaps[label] > bound:
                own = gaps["plain fp32 - float64"] / scale
                raise AssertionError(f"gradient of {name}: max |{label}| = "
                                     f"{gaps[label] / scale:.2e} x max|float64| exceeds "
                                     f"max({rtol:g}, 2 x {own:.2e})")
        for label, gap in gaps.items():
            worst[label] = max(worst[label], (gap / scale, name))
    return (f"{len(grads['kernel']) - len(exempt)} parameters, worst max |gap| / "
            "max|float64|: " + "; ".join(f"{label} {v:.2e} ({name})"
                                         for label, (v, name) in worst.items()))


def fit(device):
    """SpatialNet-small trained in bf16 as phase 7 trains it. Returns the
    ``TrainModule``, the ``Trainer``, the batch and the losses."""
    import numpy as np
    import torch

    from nbss_tpu_torch.data.synthetic import SyntheticDataset
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.train.loop import Trainer
    from nbss_tpu_torch.train.module import TrainModule

    data = SyntheticDataset(num_items=B, num_channels=CHANNELS, sample_rate=FS,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(B)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
             [it[2] for it in items])
    module = TrainModule(arch=SpatialNet(**SPATIALNET_SMALL, dtype=torch.bfloat16, device=device),
                         channels=tuple(range(CHANNELS)), stft=STFT(n_fft=256, n_hop=128),
                         norm=Norm(mode="frequency"))
    losses = []
    trainer = Trainer(module, optimizer=("Adam", {"lr": 1e-3}), gradient_clip_val=5.0,
                      seed=2, device=device,
                      logger=lambda k, v, step: losses.append(v) if k.startswith("train/") else None)
    trainer.init()
    trainer.fit([batch], max_epochs=STEPS)
    return module, trainer, batch, losses


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_gradients: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    module, trainer, batch, losses = fit(dev)
    loss = trainer.train_step(batch).item()  # phase 7's launch-count step
    print(f"losses {losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps, then {loss:.4f}",
          flush=True)
    grads = gradients(module, trainer.to_device(batch), SPATIALNET_SMALL, dev)
    try:
        print(hold(grads), flush=True)
    except AssertionError as e:
        print(f"check_gradients: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
