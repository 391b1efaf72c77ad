"""Where a training step's time goes on the card.

    python3 -m nbss_tpu_torch.profile_training
        [--arch spatialnet|online_spatialnet|nbc|nbc2|nb_blstm] [--large]
        [--attention 'mamba(16,4)'|'mhsa(251)'|'ret(2,share_qk)'|...] [--d-state N]
        [--remat-policy none|dots] [--fused-ffn] [--dropout P]

Trains SpatialNet-small (neg-SI-SDR with PIT, Adam), or OnlineSpatialNet
with the time module ``--attention`` (default mamba(16,4); ``--d-state N``
gives the mamba branch N states; ret(2,share_qk) the retention branch) as
the committed run does (neg-SNR with PIT, AdamW with weight decay 1e-3,
remat: full recomputation, or with ``--remat-policy dots``, as
configs/onlineSpatialNet.yaml sets it, the Linear outputs kept), at 8
layers, H=96; or NBC (``configs/NBC.yaml``, 8 channels x 4 s at 16 kHz;
``--dropout``, 0.1 unless given), NBC2-small (neg-SA-SDR with PIT) or
NB-BLSTM at their configurations' widths, with Adam (``--large``:
SpatialNet-large or NBC2-large, 12 layers at H=192, through the attention
block's wide route); seeded random weights,
bf16 compute and float32 parameters, on one fixed batch of B=8
``SyntheticDataset`` items of 6 channels x 4 s (NBC: 8 x 4 s at 16 kHz, B=6
with dropout active, the most an 80 GB card holds)
through ``Trainer.train_step`` (forward, loss, backward, the optimizer step
with clip 5) under ``torch.profiler`` for three steps, after two warm-up
steps. Prints the step's wall time, the device time of the 25 costliest
kernels, the port's kernels' shares, the device's busy share of the
profiled wall time and the peak device memory. It checks each step's
launches: 8 attention-block forward and 8 backward for SpatialNet-small and
NBC2-small, 12 and 12 for the large models; 32 scan forward (16, and 16 more recomputed by remat) and 16
backward for mamba(N,4), with either policy (the scan is recomputed); none
for ret(...), whose products are cuBLAS's; 16 narrow-band attention forward
(8 + 8) and 8 backward for mhsa(N); for NBC 4 relative-position forward at dropout 0 and
none at 0.1, where the block is off while dropout is active, as in the JAX
package (its backward is autograd's); none for NB-BLSTM; with
``--fused-ffn`` (SpatialNet's T-ConvFFN through its kernel) also a T-ConvFFN
forward launch a layer and none in the backward, which recomputes the plain chain
under autograd. Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time

STEPS, ROWS = 3, 25
B, C, SECONDS = 8, 6, 4.0
NBC_B_DROPOUT = 6  # NBC with active dropout keeps [B*257, 8, 248, 248] float32 scores a layer:
# B = 7 does not fit on an 80 GB card (chip_smoke.py's NBC_B_TRAIN)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nbss_tpu_torch.data.synthetic import SyntheticDataset
    from nbss_tpu_torch.ops import tconvffn
    from nbss_tpu_torch.profile_serving import (
        NBC_C,
        build,
        device_us_of,
        ffn_report,
        parse_args,
    )
    from nbss_tpu_torch.train.loop import Trainer

    args = parse_args(__doc__.splitlines()[0], dropout=True)
    arch = args.arch
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA card", file=sys.stderr)
        return 2

    channels, rate = (NBC_C, 16000) if arch == "nbc" else (C, 8000)
    bsz = NBC_B_DROPOUT if arch == "nbc" and args.dropout != 0 else B
    data = SyntheticDataset(num_items=bsz, num_channels=channels, sample_rate=rate,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(bsz)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]))
    online = arch == "online_spatialnet"
    module, counts, (_, want_fwd, want_bwd), (fwd_key, bwd_key) = build(
        arch, torch.bfloat16, None, remat=online, attention=args.attention,
        fused_ffn=args.fused_ffn, dropout=args.dropout, large=args.large,
        remat_policy=args.remat_policy)
    optimizer = ("AdamW", {"lr": 1e-3, "weight_decay": 1e-3}) if online else ("Adam", {"lr": 1e-3})
    trainer = Trainer(module, optimizer=optimizer, seed=2)
    trainer.init()
    if online:
        arch = f"{arch} {args.attention} remat_policy={args.remat_policy}"
    if args.large:
        arch = f"{arch} large"
    if args.fused_ffn:
        arch = f"{arch} fused_ffn"
    if arch == "nbc":
        arch = f"nbc dropout {module.arch.sa_layers[0].dropout:g}"
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()

    fwd0, bwd0 = counts()
    ffn0 = tconvffn.launches
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fwd, bwd = (n - n0 for n, n0 in zip(counts(), (fwd0, bwd0)))
    if fwd != STEPS * want_fwd or bwd != STEPS * want_bwd:
        print(f"profile_training: {fwd} forward and {bwd} backward kernel launches in {STEPS} "
              f"steps, expected {want_fwd} and {want_bwd} a step", file=sys.stderr)
        return 1
    ffn_want = STEPS * want_fwd if args.fused_ffn else 0
    if tconvffn.launches - ffn0 != ffn_want:
        print(f"profile_training: {tconvffn.launches - ffn0} T-ConvFFN launches in {STEPS} "
              f"steps, expected {ffn_want}", file=sys.stderr)
        return 1

    # kernels and copies on the card only: operator rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in events)
    if device_us == 0:
        print("profile_training: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; {arch}: {STEPS} train steps, B={bsz} x {channels} "
          f"ch x {SECONDS:g} s at {rate} Hz, bf16; kernel launches a step: {fwd // STEPS} "
          f"forward, {bwd // STEPS} backward")
    print(f"wall {wall_us / STEPS / 1e3:.2f} ms/step = {bsz * SECONDS * STEPS / wall_us * 1e6:.1f} "
          f"audio-s/s with the profiler on; device busy {device_us / STEPS / 1e3:.2f} ms/step "
          f"= {100 * device_us / wall_us:.1f}% of wall; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"{'device ms/step':>15} {'share':>7} {'calls/step':>10}  kernel")
    for e in events[:ROWS]:
        print(f"{e.self_device_time_total / STEPS / 1e3:15.3f} "
              f"{100 * e.self_device_time_total / device_us:6.1f}% "
              f"{e.count / STEPS:10.1f}  {e.key[:110]}")
    for label, keys in (("forward kernel", fwd_key), ("backward kernels", bwd_key)):
        us = device_us_of(events, keys)
        print(f"{label} ({' + '.join(keys)}): {us / STEPS / 1e3:.2f} ms/step = "
              f"{100 * us / device_us:.1f}% of device time")
    if args.fused_ffn:
        ffn_report(events, device_us, STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
