"""Where the serving step's time goes on the card.

    python3 -m nbss_tpu_torch.profile_serving
        [--arch spatialnet|online_spatialnet|nbc|nbc2|nb_blstm] [--large]
        [--attention 'mamba(16,4)'|'mhsa(251)'|'ret(2,share_qk)'|...] [--d-state N]
        [--remat-policy none|dots] [--fused-ffn] [--seconds 4] [--batch 16]

Serves SpatialNet-small, or OnlineSpatialNet with the time module
``--attention`` (default mamba(16,4), the committed run; mhsa(251) is the
masked-attention alternative, ret(2,share_qk) the retention one with
configs/onlineSpatialNet.yaml's decays 4, 5, 9, 10; ``--d-state N`` gives
the mamba branch N states) at 8 layers, H=96, at B=16 x 6 channels x 4 s
at 8 kHz; or NBC (``configs/NBC.yaml``: 4 layers, H=192, 8 heads) at B=16 x
8 channels x 4 s at 16 kHz, STFT 512/256; or NBC2-small
(``configs/NBC2.yaml``: 8 layers, H=96, 2 heads, LN/GBN/GBN) or NB-BLSTM
(``configs/NB-BLSTM.yaml``: BLSTM 256, 128) at B=16 x 6 channels x 4 s at
8 kHz; with ``--large``, SpatialNet-large or NBC2-large instead (12 layers,
H=192, ffn 384; SpatialNet's squeeze 16; ``configs/SpatialNet.yaml`` and
``configs/NBC2.yaml`` comments), whose blocks take the attention block's
wide route; seeded random weights, bf16
(``--fused-ffn``: SpatialNet's T-ConvFFN through its kernel, row 3),
(``--seconds`` and ``--batch``: recordings of another length and count;
``--seconds 16 --batch 4`` serves whole 16-s recordings, T = 1001, whose
blocks take the wide route even for SpatialNet-small),
through ``TrainModule.predict_step`` under ``torch.profiler`` for three
steps, after two warm-up steps, and prints the device time of the 25
costliest kernels, the port's kernels' shares and the device's busy share of
the profiled wall time. It checks that each step launched the arch's kernel
once per block (8 attention blocks for SpatialNet-small and NBC2-small, 12
for the large models, 16
scans for mamba(N,4), 8 narrow-band attentions for mhsa(N), 4
relative-position blocks for NBC, none for NB-BLSTM, whose LSTMs are
cuDNN's, or for ret, whose products are cuBLAS's (their share is printed);
with ``--fused-ffn`` also a T-ConvFFN kernel a layer, whose share it
prints) and no backward kernel. Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

STEPS, ROWS = 3, 25
B, C, S, LAYERS = 16, 6, 32000, 8
WIDTHS = dict(dim_input=2 * C, dim_output=4, num_layers=LAYERS, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=129)
# configs/NBC.yaml: 8 channels, 4 s at 16 kHz (the JAX module's rate for n_fft 512)
NBC_C = 8
NBC_WIDTHS = dict(dim_input=2 * NBC_C, dim_output=4, n_layers=4, encoder_kernel_size=4,
                  n_heads=8, hidden_size=192, ffn_size=384, inner_conv_kernel_size=3,
                  inner_conv_groups=8, dropout=0.1)
# configs/NBC2.yaml (small) and configs/NB-BLSTM.yaml, 6 channels at 8 kHz
NBC2_WIDTHS = dict(dim_input=2 * C, dim_output=4, n_layers=LAYERS, encoder_kernel_size=5,
                   dim_hidden=96, dim_ffn=192, num_freqs=129, n_heads=2, conv_kernel_size=3,
                   n_conv_groups=8, norms=("LN", "GBN", "GBN"))
BLSTM_WIDTHS = dict(dim_input=2 * C, dim_output=4, hidden_size=(256, 128))
# the large models' widths (configs/SpatialNet.yaml and configs/NBC2.yaml comments)
LARGE_LAYERS = 12
LARGE_WIDTHS = dict(WIDTHS, num_layers=LARGE_LAYERS, dim_hidden=192, dim_ffn=384, dim_squeeze=16)
NBC2_LARGE_WIDTHS = dict(NBC2_WIDTHS, n_layers=LARGE_LAYERS, dim_hidden=192, dim_ffn=384)
ARCHS = ("spatialnet", "online_spatialnet", "nbc", "nbc2", "nb_blstm")
RET_DECAY = (4, 5, 9, 10)  # configs/onlineSpatialNet.yaml


def build(arch: str, dtype, generator, remat: bool = False, attention: str = "mamba(16,4)",
          fused_ffn: bool = False, dropout: Optional[float] = None, large: bool = False,
          remat_policy: Optional[str] = None):
    """(TrainModule, a function giving the kernel's forward and backward
    launch counts, its launches (per serving forward, per train step forward,
    per train step backward), (forward, backward) tuples of kernel-name
    pieces whose device time is summed) for
    SpatialNet-small, OnlineSpatialNet with ``attention``, as the committed
    run trains it, NBC (``dropout``: its configuration's 0.1 unless given),
    NBC2-small or NB-BLSTM (``large``: SpatialNet-large, NBC2-large).
    ``fused_ffn`` routes SpatialNet's T-ConvFFN through its kernel;
    ``remat_policy`` is OnlineSpatialNet's."""
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nb_blstm import BLSTM2_FC1
    from nbss_tpu_torch.models.nbc import NBC
    from nbss_tpu_torch.models.nbc2 import NBC2
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet, parse_attention
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention as narrowband
    from nbss_tpu_torch.ops import attention_block, ssm
    from nbss_tpu_torch.train.module import TrainModule

    def counts(kernels):
        return lambda: (kernels.launches, kernels.bwd_launches)

    # the block's kernels of both routes: the wide one runs at H = 192 and past 256 frames
    keys = (BLOCK_KEYS[0] + WIDE_KEYS[0], BLOCK_KEYS[1] + WIDE_KEYS[1])
    n = LARGE_LAYERS if large else LAYERS
    if arch == "spatialnet":
        net = SpatialNet(**(LARGE_WIDTHS if large else WIDTHS), dtype=dtype, fused_ffn=fused_ffn,
                         generator=generator, device="cuda")
        return (TrainModule(arch=net, norm=Norm(mode="frequency")), counts(attention_block),
                (n,) * 3, keys)
    if arch == "nbc2":
        net = NBC2(**(NBC2_LARGE_WIDTHS if large else NBC2_WIDTHS), dtype=dtype,
                   generator=generator, device="cuda")
        module = TrainModule(arch=net, norm=Norm(mode="frequency"),
                             loss=Loss(name="neg_sa_sdr", pit=True))
        return module, counts(attention_block), (n,) * 3, keys
    if arch == "nb_blstm":  # no kernel of the port: cuDNN's LSTM, its cell kernels timed
        net = BLSTM2_FC1(**BLSTM_WIDTHS, dtype=dtype, generator=generator, device="cuda")
        return (TrainModule(arch=net, norm=Norm(mode="frequency")), lambda: (0, 0), (0, 0, 0),
                (("RNNcell",), ()))
    if arch == "nbc":  # the relative-position block has no backward kernel
        # relpos_tc_keys / _proj / _attn in bf16, relpos_ln / _proj / _qpos / _attn in fp32
        widths = NBC_WIDTHS if dropout is None else dict(NBC_WIDTHS, dropout=dropout)
        net = NBC(**widths, dtype=dtype, generator=generator, device="cuda")
        module = TrainModule(arch=net, channels=tuple(range(NBC_C)),
                             stft=STFT(n_fft=512, n_hop=256), norm=Norm(mode="frequency"))
        # in training the block runs only with dropout inactive, as in the JAX package
        n = widths["n_layers"]
        return (module, lambda: (attention_block.relpos_launches, 0),
                (n, n if widths["dropout"] == 0 else 0, 0), (("relpos_",), ()))
    net = OnlineSpatialNet(**WIDTHS, attention=attention, decay=RET_DECAY, dtype=dtype,
                           remat=remat, remat_policy=remat_policy, generator=generator,
                           device="cuda")
    module = TrainModule(arch=net, norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True))
    kind, cfg = parse_attention(attention)
    if kind == "ret":  # no kernel of the port: the products are cuBLAS's
        return module, lambda: (0, 0), (0, 0, 0), (("gemm",), ("gemm",))
    if kind == "mhsa":
        # the forward: narrowband_attention_tc_kernel in bf16, the CUDA-core kernels in fp32;
        # the backward: narrowband_attention_bwd_tc_dq / _dkdv in bf16,
        # narrowband_attention_bwd_dq / _dkdv (and _wide) in fp32
        return (module, counts(narrowband), (LAYERS, LAYERS * (1 + remat), LAYERS),
                (("narrowband_attention_tc_kernel", "narrowband_attention_kernel",
                  "narrowband_attention_wide_kernel"),
                 ("narrowband_attention_bwd_tc_", "narrowband_attention_bwd_")))
    blocks = 2 if cfg["replace_ffn"] else 1  # Mamba blocks a layer
    n = blocks * LAYERS  # remat recomputes each layer's forward
    return (module, counts(ssm), (n, n * (1 + remat), n),
            (("selective_scan_kernel",), ("selective_scan_bwd",)))


# the attention block's forward: attention_block_tc_kernel in bf16, attention_block_kernel in
# fp32; its backward: attention_block_bwd_tc_* in bf16, attention_block_bwd_* in fp32
BLOCK_KEYS = (("attention_block_tc_kernel", "attention_block_kernel"), ("attention_block_bwd",))
# its wide route (H = 192, or T > 256): wide_prep / wide_ln / wide_vo / wide_attn in bf16 (the
# backward recomputes all but wide_attn), wide_ln / _gemm / _softmax / _accumulate in fp32 (the
# backward's too); the backward's own: wide_bwd_query / _key / _dxa / _weights / _extras /
# _reduce and wide_ln_bwd, wide_ds and wide_sum in fp32 ("wide_ln<" leaves wide_ln_bwd out)
WIDE_KEYS = (("wide_prep", "wide_ln<", "wide_vo", "wide_attn"), ("wide_bwd_", "wide_ln_bwd"))


def parse_args(description: str, dropout: bool = False, serving: bool = False):
    import argparse

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--arch", choices=ARCHS, default="spatialnet")
    parser.add_argument("--attention", default="mamba(16,4)",
                        help="OnlineSpatialNet's time module, e.g. 'mamba(16,4)', 'mhsa(251)' "
                             "or 'ret(2,share_qk)'")
    parser.add_argument("--d-state", type=int, default=None,
                        help="OnlineSpatialNet's mamba branch: its state size N")
    parser.add_argument("--remat-policy", choices=("none", "dots"), default="none",
                        help="OnlineSpatialNet: what remat keeps (dots: the Linear outputs)")
    parser.add_argument("--fused-ffn", action="store_true",
                        help="SpatialNet only: the T-ConvFFN through its kernel (row 3)")
    parser.add_argument("--large", action="store_true",
                        help="SpatialNet-large or NBC2-large (H 192, 12 layers)")
    if serving:
        parser.add_argument("--seconds", type=float, default=S / 8000,
                            help="length of each recording in seconds (16: whole recordings)")
        parser.add_argument("--batch", type=int, default=B, help="recordings a step")
    if dropout:
        parser.add_argument("--dropout", type=float, default=None,
                            help="NBC only: its dropout (configs/NBC.yaml: 0.1; at 0 the "
                                 "relative-position block runs)")
    args = parser.parse_args()
    if args.fused_ffn and args.arch != "spatialnet":
        parser.error("--fused-ffn takes --arch spatialnet")
    if args.large and args.arch not in ("spatialnet", "nbc2"):
        parser.error("--large takes --arch spatialnet or nbc2")
    if getattr(args, "dropout", None) is not None and args.arch != "nbc":
        parser.error("--dropout takes --arch nbc")
    if args.d_state is not None:
        if not args.attention.startswith("mamba("):
            parser.error("--d-state takes a mamba(...) --attention")
        inner = args.attention[6:args.attention.index(")")].split(",")
        args.attention = f"mamba({args.d_state},{inner[1]}){args.attention.split(')', 1)[1]}"
    args.remat_policy = None if args.remat_policy == "none" else args.remat_policy
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

    args = parse_args(__doc__.splitlines()[0], serving=True)
    arch = args.arch
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA card", file=sys.stderr)
        return 2

    gen = torch.Generator().manual_seed(0)
    module, counts, (per_fwd, _, _), (fwd_key, _) = build(arch, torch.bfloat16, gen,
                                                          attention=args.attention,
                                                          fused_ffn=args.fused_ffn,
                                                          large=args.large,
                                                          remat_policy=args.remat_policy)
    channels, rate = (NBC_C, 16000) if arch == "nbc" else (C, 8000)
    samples, batch = int(args.seconds * rate), args.batch
    if arch == "online_spatialnet":
        arch = f"{arch} {args.attention}"
    if args.large:
        arch = f"{arch} large"
    if args.fused_ffn:
        arch = f"{arch} fused_ffn"
    module.arch.eval()
    wave = (0.1 * torch.randn(batch, channels, samples, generator=gen)).cuda()
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
    ffn_want = STEPS * per_fwd if args.fused_ffn else 0
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
          f"B={batch} x {channels} ch x {samples / rate:g} s at {rate} Hz, bf16; {per_fwd} kernel "
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
