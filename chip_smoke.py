#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py

Drives ``nbss_tpu_torch`` only (no JAX, nothing of ``nbss_tpu``) through its
serving path and its training path at the full width of SpatialNet-small
(8 layers, H=96, 4 heads, F=129; 6 channels x 4 s at 8 kHz, bf16, seeded
random weights): serving B=16 requests, then training at B=8, in nine
phases:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the path, by plain nvcc into build/kernels/;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the path's shapes (fp32 with TF32 off: atol 2e-4, rtol 1e-4, the
   JAX package's own kernel bounds; bf16: no farther from the fp32 plain
   result than twice the plain bf16 version is, since the kernel rounds at
   no more points than the plain version and only sums in another order);
4. slice: ``TrainModule.forward`` and ``predict_step``, with launch counts
   reset just before and read just after; then fp32 through the kernel and
   through the plain module composition, SI-SDR between the two >= 50 dB;
5. times: CUDA events for each kernel, its plain version and one PyTorch
   library call of the same function; the end-to-end serving rate;
6. backward kernel vs plain at the training shape (M = 8*129, T = 251): fp32
   with TF32 off, each of dx, dln, dA, dWvo, dc within atol
   5e-3 x max|plain| and rtol 5e-3 (the JAX package's gradient bound,
   scaled to each output since the weight cotangents sum over all rows);
   bf16 no farther from the fp32 plain result than twice the plain bf16
   version, or than the fp32 bound where the plain bf16 version is exact;
7. training slice: ``Trainer`` draws the flagship in bf16 from a seeded
   generator and fits 8 fixed ``SyntheticDataset`` items (Adam 1e-3, clip 5,
   neg-SI-SDR with PIT) for 20 steps, launch counts reset just before and
   read just after (8 forward and 8 backward launches a step); every loss
   finite, the mean of the last 5 below the mean of the first 5;
8. gradient parity: one fp32 batch through the kernels and through the plain
   module composition from one state dict, every parameter's gradient within
   5e-3 x max|plain|;
9. times: the backward kernel, its plain version, the backward of the
   PyTorch library composition, the fp32 forward kernel; the train step.

Prints one ``kernels`` JSON line, the card's ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, when there is no CUDA card or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

T0 = time.monotonic()
BUDGET_S = 600.0  # every phase together: half of the 1200 s a run may take

# H100 SXM published peaks (dense): HBM rate and bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

B, CHANNELS, SECONDS, FS = 16, 6, 4.0, 8000
B_TRAIN, TRAIN_STEPS = 8, 20
FLAGSHIP = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                num_freqs=129, full_share=0)


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.monotonic() - T0:7.1f} s] {msg}", flush=True)


def check_budget(phase: str) -> None:
    elapsed = time.monotonic() - T0
    if elapsed > BUDGET_S:
        raise RuntimeError(f"phase {phase} ended at {elapsed:.0f} s, "
                           f"past the {BUDGET_S:.0f} s budget")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import _build
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.module import TrainModule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    log("phase 1/9 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
        f"{torch.cuda.device_count()} card(s); nvidia-smi: {smi}")

    # 2. build
    log("phase 2/9 build (plain nvcc, sm_90a)")
    seconds = _build.build()
    _build.library()
    log(f"kernels built in {seconds:.1f} s: {_build.library_path().name}")
    check_budget("build")

    # 3. kernel vs plain at the path's shape
    n_freq = FLAGSHIP["num_freqs"]
    n_frames = int(SECONDS * FS) // 128 + 1
    M, T, H, nh = B * n_freq, n_frames, FLAGSHIP["dim_hidden"], FLAGSHIP["num_heads"]
    log(f"phase 3/9 attention_block vs plain at M={M} T={T} H={H} nh={nh}")
    gen = torch.Generator().manual_seed(0)
    net = SpatialNet(**FLAGSHIP, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    layer = net.layers[0]
    with torch.no_grad():  # operands only: no autograd graph around the timed launches
        ln, A, Wvo, c, eps = ab.fold_weights(
            layer.norm_mhsa.weight, layer.norm_mhsa.bias, layer.mhsa.in_proj_weight,
            layer.mhsa.in_proj_bias, layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias, nh)
    x32 = torch.randn(M, T, H, generator=gen).to(dev)
    y = ab.attention_block(x32, ln, A, Wvo, c, eps, nh)
    torch.cuda.synchronize()
    want = ab.reference(x32, ln, A, Wvo, c, eps, nh)
    err32 = (y - want).abs().max().item()
    torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    log(f"fp32: max |kernel - plain| = {err32:.3e} (atol 2e-4, rtol 1e-4): ok")
    xb = x32.to(torch.bfloat16)
    want = ab.reference(xb.float(), ln, A, Wvo, c, eps, nh)
    errbf = (ab.attention_block(xb, ln, A, Wvo, c, eps, nh).float() - want).abs().max().item()
    err_plain = (ab.reference(xb, ln, A, Wvo, c, eps, nh).float() - want).abs().max().item()
    del y, want
    log(f"bf16: max |kernel - fp32 plain| = {errbf:.4f}, plain bf16 version's = {err_plain:.4f} "
        f"(bound: 2x the plain version's)")
    if not errbf <= 2 * err_plain:
        raise AssertionError(f"bf16 kernel error {errbf} exceeds 2 x {err_plain}")
    check_budget("kernel vs plain")

    # 4. the serving slice
    log(f"phase 4/9 slice: TrainModule.forward + predict_step, B={B}, {CHANNELS} ch, "
        f"{SECONDS:g} s, bf16")
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    ab.launches = ab.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    launches, serve_bwd = ab.launches, ab.bwd_launches
    n_layers = FLAGSHIP["num_layers"]
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, wave.shape[-1]) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if launches != 2 * n_layers or serve_bwd != 0:
        raise AssertionError(f"attention_block launched {launches} forward and {serve_bwd} "
                             f"backward kernels in two forwards, expected {2 * n_layers} and 0")
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; attention_block "
        f"launched {launches} times ({n_layers} per forward)")

    net32 = SpatialNet(**FLAGSHIP, dtype=None, device=dev).eval()
    net32.load_state_dict(net.state_dict())
    plain32 = SpatialNet(**FLAGSHIP, dtype=None, fused_block=False, device=dev).eval()
    plain32.load_state_dict(net.state_dict())
    y_kernel, _ = TrainModule(**{**module.__dict__, "arch": net32}).forward(wave)
    y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave)
    sdr = si_sdr(y_kernel, y_plain).min().item()
    del net32, plain32
    log(f"fp32 kernel path vs plain composition: min SI-SDR {sdr:.1f} dB (bound >= 50)")
    if not sdr >= 50.0:
        raise AssertionError(f"kernel path vs plain path SI-SDR {sdr:.1f} dB < 50 dB")
    check_budget("slice")

    # 5. times
    log("phase 5/9 times (CUDA events, after warm-up)")
    ms = cuda_ms(lambda: ab.attention_block(xb, ln, A, Wvo, c, eps, nh), iters=20)
    plain_ms = cuda_ms(lambda: ab.reference(xb, ln, A, Wvo, c, eps, nh), iters=3, warmup=1)
    m = layer.mhsa
    w_in, b_in = m.in_proj_weight.to(xb.dtype), m.in_proj_bias.to(xb.dtype)
    w_out, b_out = m.out_proj.weight.to(xb.dtype), m.out_proj.bias.to(xb.dtype)
    ln_w, ln_b = layer.norm_mhsa.weight.to(xb.dtype), layer.norm_mhsa.bias.to(xb.dtype)

    def library():  # one PyTorch composition of the same function; the port never calls it
        q, k, v = F.linear(F.layer_norm(xb, (H,), ln_w, ln_b), w_in, b_in).chunk(3, -1)
        q, k, v = (t.reshape(M, T, nh, H // nh).transpose(1, 2) for t in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(M, T, H)
        return xb + F.linear(o, w_out, b_out)

    library_ms = cuda_ms(library, iters=20)
    io_bytes = 2 * xb.numel() * xb.element_size() + sum(
        t.numel() * t.element_size() for t in (ln, A, Wvo, c))
    flops = M * (2 * T * H * 3 * H + 2 * 2 * T * T * H + 2 * T * H * H)  # unfolded function
    t_bytes, t_flops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    bound_ms, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes > t_flops else "operations"
    log(f"attention_block bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {io_bytes / 1e6:.0f} MB, "
        f"{flops / 1e9:.1f} GFLOP unfolded)")

    for _ in range(2):
        module.predict_step(wave)
    torch.cuda.synchronize()
    reps, t1 = 5, time.perf_counter()
    for _ in range(reps):
        module.predict_step(wave)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / reps
    log(f"serving: predict_step on {B} x {SECONDS:g} s in {step_s * 1e3:.1f} ms = "
        f"{B * SECONDS / step_s:.1f} audio-s/s")
    ms_fp32 = cuda_ms(lambda: ab.attention_block(x32, ln, A, Wvo, c, eps, nh), iters=10)
    log(f"attention_block fp32: kernel {ms_fp32:.3f} ms")
    check_budget("times")
    del module, net, wave, target, x32, xb
    torch.cuda.empty_cache()

    row2, train_launches = training_phases(dev)

    print(json.dumps({"kernels": [{
        "name": "attention_block", "route": "cuda",
        "source": "nbss_tpu_torch/csrc/attention_block.cu",
        "replaces": "nbss_tpu/ops/attention_block.py:183",
        "launches": launches, "launches_training": train_launches, "max_abs_err": err32,
        "max_err_fp32": err32, "max_err_bf16": errbf, "ms": ms, "ms_fp32": ms_fp32,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}, row2]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def bound(io_bytes: int, flops: int):
    """(ms, 'bytes' or 'operations'): the larger of the two least times."""
    t_bytes, t_flops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes > t_flops else "operations"


def training_phases(dev):
    """Phases 6-9. Returns the backward kernel's row of the ``kernels`` line
    and the forward kernel's launches in the training run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch.data.synthetic import SyntheticDataset
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.train.loop import Trainer
    from nbss_tpu_torch.train.module import TrainModule

    names = ("dx", "dln", "dA", "dWvo", "dc")
    n_layers, H, nh = FLAGSHIP["num_layers"], FLAGSHIP["dim_hidden"], FLAGSHIP["num_heads"]
    M, T = B_TRAIN * FLAGSHIP["num_freqs"], int(SECONDS * FS) // 128 + 1

    # 6. backward kernel vs plain
    log(f"phase 6/9 attention_block backward vs plain at M={M} T={T} H={H} nh={nh}")
    gen = torch.Generator().manual_seed(1)
    layer = SpatialNet(**FLAGSHIP, generator=gen, device=dev).layers[0]
    with torch.no_grad():
        ln, A, Wvo, c, eps = ab.fold_weights(
            layer.norm_mhsa.weight, layer.norm_mhsa.bias, layer.mhsa.in_proj_weight,
            layer.mhsa.in_proj_bias, layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias, nh)
    x32 = torch.randn(M, T, H, generator=gen).to(dev)
    g32 = torch.randn(M, T, H, generator=gen).to(dev)
    got = ab.backward(x32, ln, A, Wvo, g32, eps, nh)
    torch.cuda.synchronize()
    want = ab.reference_bwd(x32, ln, A, Wvo, g32, eps, nh)
    errs32 = [(a - w).abs().max().item() for a, w in zip(got, want)]
    bounds = [5e-3 * w.abs().max().item() for w in want]
    for name, a, w, b in zip(names, got, want, bounds):
        torch.testing.assert_close(a, w, atol=b, rtol=5e-3, msg=name)
    again = ab.backward(x32, ln, A, Wvo, g32, eps, nh)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    log("fp32: max |kernel - plain| " + ", ".join(
        f"{n} {e:.3e} (atol {b:.2e})" for n, e, b in zip(names, errs32, bounds))
        + f"; two launches bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("two launches of the backward kernel on the same inputs differ")
    xb, gb = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
    want = ab.reference_bwd(xb.float(), ln, A, Wvo, gb.float(), eps, nh)
    errsbf = [(a.float() - w).abs().max().item()
              for a, w in zip(ab.backward(xb, ln, A, Wvo, gb, eps, nh), want)]
    plainbf = [(a.float() - w).abs().max().item()
               for a, w in zip(ab.reference_bwd(xb, ln, A, Wvo, gb, eps, nh), want)]
    bounds = [5e-3 * w.abs().max().item() for w in want]
    log("bf16: max |kernel - fp32 plain| vs the plain bf16 version's: " + ", ".join(
        f"{n} {e:.3e} / {p:.3e}" for n, e, p in zip(names, errsbf, plainbf)))
    for name, e, p, b in zip(names, errsbf, plainbf, bounds):
        if not e <= max(2 * p, b):
            raise AssertionError(f"bf16 backward {name}: error {e} exceeds max(2 x {p}, {b})")
    del got, again, want, x32, g32
    check_budget("backward vs plain")

    # 7. the training slice
    log(f"phase 7/9 training: Trainer fits {B_TRAIN} SyntheticDataset items "
        f"({CHANNELS} ch x {SECONDS:g} s) for {TRAIN_STEPS} steps, bf16")
    data = SyntheticDataset(num_items=B_TRAIN, num_channels=CHANNELS, sample_rate=FS,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(B_TRAIN)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
             [it[2] for it in items])
    module = TrainModule(arch=SpatialNet(**FLAGSHIP, dtype=torch.bfloat16, device=dev),
                         channels=tuple(range(CHANNELS)), stft=STFT(n_fft=256, n_hop=128),
                         norm=Norm(mode="frequency"))
    losses = []
    trainer = Trainer(module, optimizer=("Adam", {"lr": 1e-3}), gradient_clip_val=5.0,
                      seed=2, device=dev,
                      logger=lambda k, v, step: losses.append(v) if k.startswith("train/") else None)
    trainer.init()
    ab.launches = ab.bwd_launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_fwd, fit_bwd = ab.launches, ab.bwd_launches
    ab.launches = ab.bwd_launches = 0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step_fwd, step_bwd = ab.launches, ab.bwd_launches
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    log(f"launches: fit {fit_fwd} forward + {fit_bwd} backward in {TRAIN_STEPS} steps; "
        f"one step {step_fwd} + {step_bwd}")
    if (fit_fwd, fit_bwd) != (TRAIN_STEPS * n_layers,) * 2 or (step_fwd, step_bwd) != (n_layers,) * 2:
        raise AssertionError(f"expected {n_layers} forward and {n_layers} backward launches "
                             "a step")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"mean loss of the first 5 steps {first:.3f}, of the last 5 {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    check_budget("training")

    # 8. gradient parity, fp32
    log("phase 8/9 gradients: kernel path vs plain composition, fp32, one batch")
    grads = []
    for fused in (True, False):
        net = SpatialNet(**FLAGSHIP, fused_block=fused, device=dev)
        net.load_state_dict(module.arch.state_dict())
        m32 = TrainModule(**{**module.__dict__, "arch": net})
        m32.training_step(trainer.to_device(batch)).backward()
        grads.append({n: p.grad for n, p in net.named_parameters()})
        del net, m32
    worst = ("", 0.0)
    for name, gk in grads[0].items():
        gp = grads[1][name]
        rel = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        worst = max(worst, (name, rel), key=lambda t: t[1])
        if gk.abs().max() == 0 or rel > 5e-3:
            raise AssertionError(f"gradient of {name}: max |kernel - plain| = {rel:.2e} "
                                 f"x max|plain| (bound 5e-3)")
    log(f"{len(grads[0])} parameters: worst max |kernel - plain| / max|plain| = "
        f"{worst[1]:.2e} ({worst[0]}; bound 5e-3)")
    del grads
    torch.cuda.empty_cache()
    check_budget("gradients")

    # 9. times
    log("phase 9/9 times (CUDA events, after warm-up)")
    ms = cuda_ms(lambda: ab.backward(xb, ln, A, Wvo, gb, eps, nh), iters=10)
    plain_ms = cuda_ms(lambda: ab.reference_bwd(xb, ln, A, Wvo, gb, eps, nh), iters=3, warmup=1)
    m = layer.mhsa
    leaves = [t.detach().to(torch.bfloat16).requires_grad_() for t in (
        xb, layer.norm_mhsa.weight, layer.norm_mhsa.bias, m.in_proj_weight, m.in_proj_bias,
        m.out_proj.weight, m.out_proj.bias)]
    xl, ln_w, ln_b, w_in, b_in, w_out, b_out = leaves
    q, k, v = F.linear(F.layer_norm(xl, (H,), ln_w, ln_b), w_in, b_in).chunk(3, -1)
    q, k, v = (t.reshape(M, T, nh, H // nh).transpose(1, 2) for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(M, T, H)
    y = xl + F.linear(o, w_out, b_out)  # graph built once; the port never calls this
    library_ms = cuda_ms(lambda: torch.autograd.grad(y, leaves, gb, retain_graph=True),
                         iters=10)
    io_bytes = 3 * xb.numel() * xb.element_size() + 2 * sum(
        t.numel() * t.element_size() for t in (ln, A, Wvo, c))
    flops = 2 * M * (2 * T * H * 3 * H + 2 * 2 * T * T * H + 2 * T * H * H)  # 2x unfolded fwd
    bound_ms, bound_by = bound(io_bytes, flops)
    log(f"attention_block backward bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library backward {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{io_bytes / 1e6:.0f} MB, {flops / 1e9:.1f} GFLOP unfolded)")
    del y, o, q, k, v, leaves

    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps, t1 = 5, time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / reps
    log(f"training: train_step on {B_TRAIN} x {SECONDS:g} s in {step_s * 1e3:.1f} ms = "
        f"{B_TRAIN * SECONDS / step_s:.1f} audio-s/s trained; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check_budget("training times")
    return {"name": "attention_block_bwd", "route": "cuda",
            "source": "nbss_tpu_torch/csrc/attention_block_bwd.cu",
            "replaces": "nbss_tpu/ops/attention_block.py:316",
            "launches": fit_bwd, "max_abs_err": max(errs32),
            "max_err_fp32": dict(zip(names, errs32)), "max_err_bf16": dict(zip(names, errsbf)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "train_step_ms": step_s * 1e3,
            "train_audio_s_per_s": B_TRAIN * SECONDS / step_s}, fit_fwd


if __name__ == "__main__":
    sys.exit(main())
