"""Where the serving step's time goes on the card.

    python3 -m nbss_tpu_torch.profile_serving [--arch spatialnet|online_spatialnet|nbc]
                                              [--attention 'mamba(16,4)'|'mhsa(251)'|...]
                                              [--fused-ffn]

Serves SpatialNet-small, or OnlineSpatialNet with the time module
``--attention`` (default mamba(16,4), the committed run; mhsa(251) is the
masked-attention alternative) at 8 layers, H=96, at B=16 x 6 channels x 4 s
at 8 kHz; or NBC (``configs/NBC.yaml``: 4 layers, H=192, 8 heads) at B=16 x
8 channels x 4 s at 16 kHz, STFT 512/256; seeded random weights, bf16
(``--fused-ffn``: SpatialNet-small's T-ConvFFN through its kernel, row 3),
through ``TrainModule.predict_step`` under ``torch.profiler`` for three
steps, after two warm-up steps, and prints the device time of the 25
costliest kernels, the port's kernels' shares and the device's busy share of
the profiled wall time. It checks that each step launched the arch's kernel
once per block (8 attention blocks, 16 scans for mamba(16,4), 8 narrow-band
attentions for mhsa(N), 4 relative-position blocks for NBC; with
``--fused-ffn`` also 8 T-ConvFFN kernels, whose share it prints) and no
backward kernel. Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time

STEPS, ROWS = 3, 25
B, C, S, LAYERS = 16, 6, 32000, 8
WIDTHS = dict(dim_input=2 * C, dim_output=4, num_layers=LAYERS, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=129)
# configs/NBC.yaml: 8 channels, 4 s at 16 kHz (the JAX module's rate for n_fft 512)
NBC_C, NBC_S = 8, 64000
NBC_WIDTHS = dict(dim_input=2 * NBC_C, dim_output=4, n_layers=4, encoder_kernel_size=4,
                  n_heads=8, hidden_size=192, ffn_size=384, inner_conv_kernel_size=3,
                  inner_conv_groups=8, dropout=0.1)


def build(arch: str, dtype, generator, remat: bool = False, attention: str = "mamba(16,4)",
          fused_ffn: bool = False):
    """(TrainModule, a function giving the kernel's forward and backward
    launch counts, its launches per forward, (forward, backward) tuples of
    kernel-name pieces whose device time is summed) for
    SpatialNet-small, OnlineSpatialNet with ``attention``, as the committed
    run trains it, or NBC. ``fused_ffn`` routes SpatialNet's T-ConvFFN through
    its kernel."""
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nbc import NBC
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet, parse_attention
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention as narrowband
    from nbss_tpu_torch.ops import attention_block, ssm
    from nbss_tpu_torch.train.module import TrainModule

    def counts(kernels):
        return lambda: (kernels.launches, kernels.bwd_launches)

    if arch == "spatialnet":
        net = SpatialNet(**WIDTHS, dtype=dtype, fused_ffn=fused_ffn, generator=generator,
                         device="cuda")
        # the forward: attention_block_tc_kernel in bf16, attention_block_kernel in fp32;
        # the backward: attention_block_bwd_tc_* in bf16, attention_block_bwd_* in fp32
        return (TrainModule(arch=net, norm=Norm(mode="frequency")), counts(attention_block),
                LAYERS, (("attention_block_tc_kernel", "attention_block_kernel"),
                         ("attention_block_bwd",)))
    if arch == "nbc":  # the relative-position block has no backward kernel
        # relpos_tc_keys / _proj / _attn in bf16, relpos_ln / _proj / _qpos / _attn in fp32
        net = NBC(**NBC_WIDTHS, dtype=dtype, generator=generator, device="cuda")
        module = TrainModule(arch=net, channels=tuple(range(NBC_C)),
                             stft=STFT(n_fft=512, n_hop=256), norm=Norm(mode="frequency"))
        return (module, lambda: (attention_block.relpos_launches, 0), NBC_WIDTHS["n_layers"],
                (("relpos_",), ()))
    net = OnlineSpatialNet(**WIDTHS, attention=attention, dtype=dtype, remat=remat,
                           generator=generator, device="cuda")
    module = TrainModule(arch=net, norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True))
    kind, cfg = parse_attention(attention)
    if kind == "mhsa":
        # the forward: narrowband_attention_tc_kernel in bf16, the CUDA-core kernels in fp32;
        # the backward: narrowband_attention_bwd_tc_dq / _dkdv in bf16,
        # narrowband_attention_bwd_dq / _dkdv (and _wide) in fp32
        return (module, counts(narrowband), LAYERS,
                (("narrowband_attention_tc_kernel", "narrowband_attention_kernel",
                  "narrowband_attention_wide_kernel"),
                 ("narrowband_attention_bwd_tc_", "narrowband_attention_bwd_")))
    blocks = 2 if cfg["replace_ffn"] else 1  # Mamba blocks a layer
    return (module, counts(ssm), blocks * LAYERS,
            (("selective_scan_kernel",), ("selective_scan_bwd",)))


def parse_args(description: str, archs=("spatialnet", "online_spatialnet")):
    import argparse

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--arch", choices=archs, default="spatialnet")
    parser.add_argument("--attention", default="mamba(16,4)",
                        help="OnlineSpatialNet's time module, e.g. 'mamba(16,4)' or 'mhsa(251)'")
    parser.add_argument("--fused-ffn", action="store_true",
                        help="SpatialNet only: the T-ConvFFN through its kernel (row 3)")
    args = parser.parse_args()
    if args.fused_ffn and args.arch != "spatialnet":
        parser.error("--fused-ffn takes --arch spatialnet")
    return args


def device_us_of(events, keys) -> float:
    """Device time of the kernels whose names hold any of ``keys``."""
    return sum(e.self_device_time_total for e in events if any(k in e.key for k in keys))


def ffn_report(events, device_us: float, steps: int) -> None:
    """Print the T-ConvFFN kernel's (row 3's) device time and share."""
    us = sum(e.self_device_time_total for e in events if "tconvffn_" in e.key)
    print(f"tconvffn (row 3): {us / steps / 1e3:.2f} ms/step = {100 * us / device_us:.1f}% "
          f"of device time")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nbss_tpu_torch.ops import tconvffn

    args = parse_args(__doc__.splitlines()[0], ("spatialnet", "online_spatialnet", "nbc"))
    arch = args.arch
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA card", file=sys.stderr)
        return 2

    gen = torch.Generator().manual_seed(0)
    module, counts, per_fwd, (fwd_key, _) = build(arch, torch.bfloat16, gen,
                                                  attention=args.attention,
                                                  fused_ffn=args.fused_ffn)
    channels, samples, rate = (NBC_C, NBC_S, 16000) if arch == "nbc" else (C, S, 8000)
    if arch == "online_spatialnet":
        arch = f"{arch} {args.attention}"
    if args.fused_ffn:
        arch = f"{arch} fused_ffn"
    module.arch.eval()
    wave = (0.1 * torch.randn(B, channels, samples, generator=gen)).cuda()
    for _ in range(2):
        module.predict_step(wave)
    torch.cuda.synchronize()
    fwd0, bwd0 = counts()
    ffn0 = tconvffn.launches

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            module.predict_step(wave)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fwd, bwd = (n - n0 for n, n0 in zip(counts(), (fwd0, bwd0)))
    if fwd != STEPS * per_fwd or bwd != 0:
        print(f"profile_serving: {fwd} forward and {bwd} backward kernel launches in {STEPS} "
              f"steps, expected {per_fwd} and 0 a step", file=sys.stderr)
        return 1
    ffn_want = STEPS * LAYERS if args.fused_ffn else 0
    if tconvffn.launches - ffn0 != ffn_want:
        print(f"profile_serving: {tconvffn.launches - ffn0} T-ConvFFN launches in {STEPS} steps, "
              f"expected {ffn_want}", file=sys.stderr)
        return 1

    # kernels and copies on the card only: operator rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in events)
    if device_us == 0:
        print("profile_serving: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; {arch}: {STEPS} steps of predict_step, "
          f"B={B} x {channels} ch x {samples / rate:g} s at {rate} Hz, bf16; {per_fwd} kernel "
          f"launches a step")
    print(f"wall {wall_us / STEPS / 1e3:.2f} ms/step; device busy "
          f"{device_us / STEPS / 1e3:.2f} ms/step = {100 * device_us / wall_us:.1f}% of wall")
    print(f"{'device ms/step':>15} {'share':>7} {'calls/step':>10}  kernel")
    for e in events[:ROWS]:
        print(f"{e.self_device_time_total / STEPS / 1e3:15.3f} "
              f"{100 * e.self_device_time_total / device_us:6.1f}% "
              f"{e.count / STEPS:10.1f}  {e.key[:110]}")
    us = device_us_of(events, fwd_key)
    print(f"{' + '.join(fwd_key)}: {us / STEPS / 1e3:.2f} ms/step = {100 * us / device_us:.1f}% "
          f"of device time")
    if args.fused_ffn:
        ffn_report(events, device_us, STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
