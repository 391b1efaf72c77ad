#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py

Drives ``nbss_tpu_torch`` only (no JAX, nothing of ``nbss_tpu``) through its
serving path and its training path at the full width of SpatialNet-small
(8 layers, H=96, 4 heads, F=129; 6 channels x 4 s at 8 kHz, bf16, seeded
random weights): serving B=16 requests, then training at B=8; then the same
for OnlineSpatialNet ``mamba(16,4)`` (the committed streaming run: 8 layers,
H=96, online utterance norm, neg-SNR with PIT), which also streams, and for
OnlineSpatialNet ``mhsa(251)`` (the same widths with masked attention, 4
heads, and the causal T-ConvFFN); then NBC serving at the full width of
``configs/NBC.yaml``; then SpatialNet-small again with ``fused_ffn=True``,
whose T-ConvFFN runs through its kernel. Twenty-nine phases:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the path, by plain nvcc into build/kernels/;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the path's shapes (fp32 with TF32 off: atol 2e-4, rtol 1e-4, the
   JAX package's own kernel bounds; bf16: no farther from the fp32 plain
   result than twice the plain bf16 version is, since the kernel rounds at
   no more points than the plain version and only sums in another order):
   float32 on the CUDA-core kernel, bf16 on the tensor-core kernel
   (``attention_block_tc.cu``), two launches bit-identical, and so at the
   edges of its 16-frame tiles and 128-key halves (T = 1, 15, 16, 17, 64,
   65, 250, 251, 256, M = 1, nh = 3);
4. slice: ``TrainModule.forward`` and ``predict_step``, with launch counts
   reset just before and read just after (8 a forward, all on the
   tensor-core kernel); then fp32 through the kernel and through the plain
   module composition, SI-SDR between the two >= 50 dB;
5. times: CUDA events for each kernel, its plain version and one PyTorch
   library call of the same function; the end-to-end serving rate;
6. backward kernel vs plain at the training shape (M = 8*129, T = 251): fp32
   with TF32 off, each of dx, dln, dA, dWvo, dc within atol
   5e-3 x max|plain| and rtol 5e-3 (the JAX package's gradient bound,
   scaled to each output since the weight cotangents sum over all rows),
   float32 on the CUDA-core kernel; bf16 on the tensor-core kernel
   (``attention_block_bwd_tc.cu``) no farther from the fp32 plain result
   than twice the plain bf16 version, or than the fp32 bound where the plain
   bf16 version is exact, two launches bit-identical (the weight cotangents
   too), and so at the edges of its 16-frame tiles (T = 1, 13, 16, 17, 64,
   65, 256, 251 with M = 1, and nh = 3);
7. training slice: ``Trainer`` draws the flagship in bf16 from a seeded
   generator and fits 8 fixed ``SyntheticDataset`` items (Adam 1e-3, clip 5,
   neg-SI-SDR with PIT) for 20 steps, launch counts reset just before and
   read just after (8 forward and 8 backward launches a step, every one on
   the tensor-core kernels); every loss
   finite, the mean of the last 5 below the mean of the first 5;
8. gradient parity (``nbss_tpu_torch.check_gradients``): one batch through
   the kernels in fp32, through the plain module composition in fp32 and
   with its arch in float64, from one state dict; every parameter's kernel
   gradient no farther from the float64 one, and from the plain fp32 one,
   than max(5e-3 x max|float64|, 2 x max|plain fp32 - float64|) (two fp32
   runs that round differently can be 1e-2 x max|grad| apart at trained
   weights, so neither is the reference);
9. times: the backward kernel (bf16 on the tensor cores, fp32 on the CUDA
   cores), its plain version, the backward of the PyTorch library
   composition; the train step;
10. selective-scan forward kernel vs ``ssm.reference`` at the serving shape
    (M = 16*129, T = 251, D = 192, N = 16): fp32 at atol 2e-4, rtol 1e-4;
    bf16 no farther from the fp32 plain result than twice the plain bf16
    version; and at ragged shapes (T = 1, T off the 8-frame chunk, D off
    the 64-channel block), forward and backward in fp32;
11. scan backward kernel vs ``ssm.reference_bwd`` at the training shape
    (M = 8*129): each cotangent within atol 5e-3 x max|plain|, rtol 5e-3 in
    fp32, and within the bf16 rule of phase 6; a second launch bit-identical;
12. OnlineSpatialNet serving: ``forward`` and ``predict_step`` at B=16 in
    bf16, 16 scan launches per forward and no backward launch; fp32 kernel
    path vs the plain scan, SI-SDR >= 50 dB;
13. streaming: ``forward_streaming`` (one frame at a time) vs ``forward`` at
    B=4: fp32 SI-SDR >= 50 dB, the bf16 figure printed;
14. training: ``Trainer`` fits 8 SyntheticDataset items for 20 steps at B=8
    (AdamW 1e-3, weight decay 1e-3, clip 5, bf16, remat): finite losses, the
    last 5 below the first 5, 32 forward (16 + 16 recomputed) and 16
    backward scan launches a step; fp32 gradients of every parameter, kernel
    path vs plain, within 5e-3 x max|plain|;
15. times: both scan kernels, their plain versions and bounds; serving,
    streaming and training rates;
16. narrow-band attention forward kernel vs ``attention.reference`` at the
    serving shape (M = 16*129, T = 251, nh = 4, dh = 24): fp32 at atol 2e-4,
    rtol 1e-4 with no mask, the causal [T, T] mask and the ALiBi [nh, T, T]
    mask, on the CUDA-core kernel; bf16 (causal mask) on the tensor-core
    kernel (``narrowband_attention_tc.cu``) no farther from the fp32 plain
    result than twice the plain bf16 version, two launches bit-identical,
    and so at the edges of its tiles and key chunk (T = 1, 13, 16, 17, 64,
    65, 256, 257, 300 and 251 with M = 1; both masks; q/k heads of 24, 64
    and 216); ragged shapes (T = 1, T = 13, M = 1, dv != dh), forward and
    backward in fp32;
17. attention backward kernel vs ``attention.reference_bwd`` at the training
    shape (M = 8*129): each of dq, dk, dv within 5e-3 x max|plain| in fp32 (on
    the CUDA-core kernel) and, on the tensor-core kernel
    (``narrowband_attention_bwd_tc.cu``), within the bf16 rule of phase 6;
    second launches bit-identical, dk and dv included; and so at the edges of
    its 16-row tiles and 256-row chunks (T = 1, 15, 16, 17, 64, 65, 251, 256,
    257, 300, M = 1, both masks, heads of 24, 64 and 216);
18. OnlineSpatialNet mhsa(251) serving at B=16 in bf16: 8 attention launches
    per forward, all on the tensor-core kernel, and no backward launch; fp32
    kernel path vs the plain
    attention, SI-SDR >= 50 dB;
19. streaming (a KV ring buffer of 250 frames) vs ``forward`` at B=4: fp32
    SI-SDR >= 50 dB, the bf16 figure printed;
20. training: 20 steps at B=8 (AdamW 1e-3, weight decay 1e-3, clip 5, bf16,
    remat): falling loss, 16 forward (8 + 8 recomputed) and 8 backward
    attention launches a step, all on the tensor-core kernels; fp32
    gradients, kernel path vs plain, within
    5e-3 x max|plain|; peak device memory;
21. times: both attention kernels (the forward in bf16 on the tensor cores
    and in fp32 on the CUDA cores), their plain versions, one
    ``scaled_dot_product_attention`` call (and its backward) with the same
    float mask, and bounds; serving, streaming and training rates;
22. NBC's relative-position block kernels vs ``attention_block.reference_relpos``
    at the serving shape (M = 16*257, T = 248, H = 192, nh = 8): fp32 on the
    CUDA-core kernel at atol 2e-4, rtol 1e-4, a second launch bit-identical;
    bf16 on the tensor-core kernel (``attention_block_relpos_tc.cu``) within
    one bf16 step of the plain bf16 version, which rounds where it does (the
    step of the largest term entering each element's sum, the share of
    differing elements printed), no farther from the fp32 plain result than
    twice the plain bf16 version, two launches bit-identical; ragged shapes
    (T = 1, 13, 256, 300; M = 1) in fp32 and bf16; the fp32 gradient through
    the kernel's Function against the plain path's at M = 2*257, x and every
    operand within 5e-3 x max|plain|;
23. the narrow-band attention kernels at NBC's widths (nh = 8, q/k heads of
    dh + d_model = 216, dv = 24, no mask, M = 2*257): forward at atol 2e-4,
    rtol 1e-4, dq, dk, dv within 5e-3 x max|plain|, bf16 under the rules of
    phases 3 and 6 (forward and backward on the tensor-core kernels),
    relaunches bit-identical;
24. NBC serving (``configs/NBC.yaml``: 4 layers, H=192, 8 heads; 8 channels
    x 4 s at 16 kHz, STFT 512/256, frequency norm) through ``forward`` and
    ``predict_step`` at B=16 in bf16: 4 relative-position launches per
    forward, all on the tensor-core kernel, and no narrow-band attention
    launch; fp32 kernel path vs the
    plain module composition at B=4, SI-SDR >= 50 dB; post-LN NBC
    (``norm_first=False``) at B=2 through the widened narrow-band kernel (4
    launches a forward) vs its plain path, SI-SDR >= 50 dB;
25. times: the relative-position kernels (bf16 on the tensor cores, fp32 on
    the CUDA cores), its plain version,
    a PyTorch library composition of the same function (LN, the projections,
    ``scaled_dot_product_attention`` over the 216-wide augmented heads, the
    out projection) and its bound; rows 4-5 at dh = 216 (the forward in
    bf16 and fp32) and their ``scaled_dot_product_attention`` counterparts;
    the NBC serving rate;
26. the T-ConvFFN kernel vs ``tconvffn.reference`` at the serving shape
    (M = 16*129, T = 251, H = 96, FF = 192, 8 groups): fp32 at atol 2e-4,
    rtol 1e-4, a second launch bit-identical; bf16 under the rule of phase
    3; ragged shapes (T = 1, 2, 13; M = 1) and SpatialNet-large's widths (H =
    192, FF = 384) in fp32; the fp32 gradient through its Function against
    the plain path's at M = 2*129, x and every parameter within 5e-3 x
    max|plain|;
27. SpatialNet-small ``fused_ffn=True`` serving: ``forward`` and
    ``predict_step`` at B=16 in bf16, 8 T-ConvFFN and 8 attention-block
    launches per forward and no backward launch; fp32 kernel path vs the
    plain module composition, SI-SDR >= 50 dB;
28. training: ``Trainer`` fits 8 SyntheticDataset items for 20 steps at B=8
    (Adam 1e-3, clip 5, bf16): 8 T-ConvFFN, 8 attention-block and 8
    attention-block backward launches a step, every loss finite, the last 5
    below the first 5; fp32 gradients of every parameter with ``fused_ffn``
    on vs off (the T-ConvFFN composition; the attention block through its
    kernels in both, as phase 8 holds that path), within 5e-3 x max|plain|;
29. times: the T-ConvFFN kernel (bf16 and fp32), its plain version, a
    PyTorch library composition of the same function and its bound; serving
    and training rates with ``fused_ffn`` on and off, in turns.

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
FP32_FLOP_PER_S = 67e12  # outside the tensor cores

B, CHANNELS, SECONDS, FS = 16, 6, 4.0, 8000
B_TRAIN, TRAIN_STEPS = 8, 20
FLAGSHIP = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                num_freqs=129, full_share=0)
# the committed streaming run, logs/OnlineSpatialNet/version_0/config.yaml
ONLINE = dict(FLAGSHIP, attention="mamba(16,4)")
# its masked-attention alternative, the class's default (configs/onlineSpatialNet.yaml:31)
MHSA = dict(FLAGSHIP, attention="mhsa(251)")
B_STREAM = 4
# configs/NBC.yaml: 4 layers, H=192, 8 heads, ffn 384, encoder k=4 (valid), 3 grouped k=3
# convs of 8 groups with GroupNorm; 8 channels, STFT 512/256, 4 s at 16 kHz (the rate the
# JAX module infers for n_fft 512)
NBC_CFG = dict(dim_input=16, dim_output=4, n_layers=4, encoder_kernel_size=4, n_heads=8,
               hidden_size=192, ffn_size=384, inner_conv_kernel_size=3, inner_conv_groups=8,
               inner_conv_layers=3, dropout=0.1)
NBC_CHANNELS, NBC_FS, NBC_NFFT = 8, 16000, 512
NBC_B_CHECK = 4  # batch of the fp32 kernel-vs-plain comparison (the plain attention's [M, nh, T, T])


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
    log("phase 1/29 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
        f"{torch.cuda.device_count()} card(s); nvidia-smi: {smi}")

    # 2. build
    log("phase 2/29 build (plain nvcc, sm_90a)")
    seconds = _build.build()
    _build.library()
    log(f"kernels built in {seconds:.1f} s: {_build.library_path().name}")
    check_budget("build")

    # 3. kernel vs plain at the path's shape
    n_freq = FLAGSHIP["num_freqs"]
    n_frames = int(SECONDS * FS) // 128 + 1
    M, T, H, nh = B * n_freq, n_frames, FLAGSHIP["dim_hidden"], FLAGSHIP["num_heads"]
    log(f"phase 3/29 attention_block vs plain at M={M} T={T} H={H} nh={nh}")
    gen = torch.Generator().manual_seed(0)
    net = SpatialNet(**FLAGSHIP, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    layer = net.layers[0]
    with torch.no_grad():  # operands only: no autograd graph around the timed launches
        ln, A, Wvo, c, eps = ab.fold_weights(
            layer.norm_mhsa.weight, layer.norm_mhsa.bias, layer.mhsa.in_proj_weight,
            layer.mhsa.in_proj_bias, layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias, nh)
    x32 = torch.randn(M, T, H, generator=gen).to(dev)
    ab.tc_launches = 0
    y = ab.attention_block(x32, ln, A, Wvo, c, eps, nh)
    torch.cuda.synchronize()
    want = ab.reference(x32, ln, A, Wvo, c, eps, nh)
    err32 = (y - want).abs().max().item()
    torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    log(f"fp32 (CUDA-core kernel): max |kernel - plain| = {err32:.3e} (atol 2e-4, rtol 1e-4): ok")
    if ab.tc_launches != 0:
        raise AssertionError(f"float32 attention_block reached the tensor-core kernel "
                             f"({ab.tc_launches} launches)")
    xb = x32.to(torch.bfloat16)
    want = ab.reference(xb.float(), ln, A, Wvo, c, eps, nh)
    ybf = ab.attention_block(xb, ln, A, Wvo, c, eps, nh)
    relaunched("bf16 attention_block", [ybf], [ab.attention_block(xb, ln, A, Wvo, c, eps, nh)])
    plainbf = ab.reference(xb, ln, A, Wvo, c, eps, nh)
    errbf, = bf16_rule("bf16 attention_block", [ybf], [want], [plainbf], 2e-4, 1e-4)
    err_plain = (plainbf.float() - want).abs().max().item()
    differ = (ybf != plainbf).float().mean().item()
    del y, want, ybf, plainbf
    log(f"bf16 (tensor-core kernel): max |kernel - fp32 plain| = {errbf:.4f}, plain bf16 "
        f"version's = {err_plain:.4f} (bound: 2x the plain version's); {100 * differ:.2f}% of "
        "elements differ from the plain bf16 version; two launches bit-identical")
    if ab.tc_launches != 2:
        raise AssertionError(f"bf16 attention_block: {ab.tc_launches} tensor-core launches, "
                             "expected 2")
    # bf16 at the edges of the tensor-core kernel's 16-frame tiles and 128-key halves
    for Me, Te, nhe in ((1, 1, nh), (5, 15, nh), (5, 16, nh), (5, 17, nh), (3, 64, nh),
                        (3, 65, nh), (2, 250, nh), (1, T, nh), (2, 256, nh), (4, 40, 3)):
        with torch.no_grad():
            ops = ab.fold_weights(
                layer.norm_mhsa.weight, layer.norm_mhsa.bias, layer.mhsa.in_proj_weight,
                layer.mhsa.in_proj_bias, layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias,
                nhe)[:4]
        xe = torch.randn(Me, Te, H, generator=gen).to(dev).to(torch.bfloat16)
        label = f"bf16 attention_block at (M, T, nh) = {(Me, Te, nhe)}"
        ye = ab.attention_block(xe, *ops, eps, nhe)
        relaunched(label, [ye], [ab.attention_block(xe, *ops, eps, nhe)])
        e, = bf16_rule(label, [ye], [ab.reference(xe.float(), *ops, eps, nhe)],
                       [ab.reference(xe, *ops, eps, nhe)], 2e-4, 1e-4)
        log(f"bf16 edge (M, T, nh) = {(Me, Te, nhe)}: {e:.3e}, relaunch bit-identical: ok")
    check_budget("kernel vs plain")

    # 4. the serving slice
    log(f"phase 4/29 slice: TrainModule.forward + predict_step, B={B}, {CHANNELS} ch, "
        f"{SECONDS:g} s, bf16")
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    ab.launches = ab.tc_launches = ab.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    launches, serve_tc, serve_bwd = ab.launches, ab.tc_launches, ab.bwd_launches
    n_layers = FLAGSHIP["num_layers"]
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, wave.shape[-1]) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if launches != 2 * n_layers or serve_tc != launches or serve_bwd != 0:
        raise AssertionError(f"attention_block launched {launches} forward ({serve_tc} on the "
                             f"tensor-core kernel) and {serve_bwd} backward kernels in two "
                             f"forwards, expected {2 * n_layers}, all on the tensor-core kernel, "
                             "and 0")
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; attention_block "
        f"launched {launches} times ({n_layers} per forward), all on the tensor-core kernel")

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
    log("phase 5/29 times (CUDA events, after warm-up)")
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
    folded = M * nh * 2 * T * H * ((H + 2) + H + 2 * T)  # t, vo, scores, pv over 96 channels
    folded_ms = folded / BF16_FLOP_PER_S * 1e3
    log(f"attention_block bf16: tensor-core kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{io_bytes / 1e6:.0f} MB, {flops / 1e9:.1f} GFLOP unfolded); the folded function's "
        f"floor {folded_ms:.4f} ms ({folded / 1e9:.1f} GFLOP, {folded / ms / 1e9:.1f} "
        "TFLOP/s achieved)")

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
    log(f"attention_block fp32: CUDA-core kernel {ms_fp32:.3f} ms")
    check_budget("times")
    del module, net, wave, target, x32, xb
    torch.cuda.empty_cache()

    row2, train_launches = training_phases(dev)
    fresh_start()
    rows67 = online_phases(dev)
    fresh_start()
    rows45 = mhsa_phases(dev)
    fresh_start()
    row8, wide4, wide5 = nbc_phases(dev)
    fresh_start()
    row3 = tconvffn_phases(dev)
    rows45[0].update(wide4)
    rows45[1].update(wide5)

    print(json.dumps({"kernels": [{
        "name": "attention_block", "route": "cuda",
        "source": "nbss_tpu_torch/csrc/attention_block_tc.cu",
        "source_fp32": "nbss_tpu_torch/csrc/attention_block.cu",
        "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
        "replaces": "nbss_tpu/ops/attention_block.py:183",
        "launches": launches, "tc_launches": serve_tc, "launches_training": train_launches,
        "max_abs_err": err32, "max_err_fp32": err32, "max_err_bf16": errbf, "ms": ms,
        "ms_fp32": ms_fp32, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms},
        row2, row3, *rows67, *rows45, row8]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def fresh_start() -> None:
    """Between model groups: collect the previous group's Python objects and
    empty the allocator cache, so each group's rates start from the same
    state. Kept, the blocks one group leaves cached (the bf16 attention-block
    backward's 0.5 GB workspace among them) slowed the next group's train step
    by up to 8%."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def bound(io_bytes: int, flops: int, flop_per_s: float = BF16_FLOP_PER_S):
    """(ms, 'bytes' or 'operations'): the larger of the two least times."""
    t_bytes, t_flops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes > t_flops else "operations"


def bf16_rule(label, got, want, plain, atol, rtol):
    """Hold bf16 outputs to the bf16 rule: each no farther from the fp32
    plain result (want) than twice the plain bf16 version is, or than the
    fp32 bound (atol + rtol x max|want|) where the plain bf16 version is
    exact. Returns the errors."""
    errs = []
    for i, (a, w, p) in enumerate(zip(got, want, plain)):
        e, ep = (a.float() - w).abs().max().item(), (p.float() - w).abs().max().item()
        b = atol + rtol * w.abs().max().item()
        if not e <= max(2 * ep, b):
            raise AssertionError(f"{label} output {i}: bf16 error {e} exceeds max(2 x {ep}, {b})")
        errs.append(e)
    return errs


def relaunched(label, first, second):
    """Raise unless two launches' outputs are bit-identical."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")


def training_phases(dev):
    """Phases 6-9. Returns the backward kernel's row of the ``kernels`` line
    and the forward kernel's launches in the training run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch import check_gradients
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention_block as ab

    names = ("dx", "dln", "dA", "dWvo", "dc")
    n_layers, H, nh = FLAGSHIP["num_layers"], FLAGSHIP["dim_hidden"], FLAGSHIP["num_heads"]
    M, T = B_TRAIN * FLAGSHIP["num_freqs"], int(SECONDS * FS) // 128 + 1

    # 6. backward kernel vs plain
    log(f"phase 6/29 attention_block backward vs plain at M={M} T={T} H={H} nh={nh}")
    gen = torch.Generator().manual_seed(1)
    layer = SpatialNet(**FLAGSHIP, generator=gen, device=dev).layers[0]
    with torch.no_grad():
        ln, A, Wvo, c, eps = ab.fold_weights(
            layer.norm_mhsa.weight, layer.norm_mhsa.bias, layer.mhsa.in_proj_weight,
            layer.mhsa.in_proj_bias, layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias, nh)
    x32 = torch.randn(M, T, H, generator=gen).to(dev)
    g32 = torch.randn(M, T, H, generator=gen).to(dev)
    ab.bwd_tc_launches = 0
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
    if ab.bwd_tc_launches != 0:
        raise AssertionError(f"float32 backward reached the tensor-core kernel "
                             f"({ab.bwd_tc_launches} launches)")
    xb, gb = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
    want = ab.reference_bwd(xb.float(), ln, A, Wvo, gb.float(), eps, nh)
    got = ab.backward(xb, ln, A, Wvo, gb, eps, nh)
    relaunched("bf16 attention_block backward", got, ab.backward(xb, ln, A, Wvo, gb, eps, nh))
    errsbf = [(a.float() - w).abs().max().item() for a, w in zip(got, want)]
    plainbf = [(a.float() - w).abs().max().item()
               for a, w in zip(ab.reference_bwd(xb, ln, A, Wvo, gb, eps, nh), want)]
    bounds = [5e-3 * w.abs().max().item() for w in want]
    log("bf16 (tensor-core kernel): max |kernel - fp32 plain| vs the plain bf16 version's: "
        + ", ".join(f"{n} {e:.3e} / {p:.3e}" for n, e, p in zip(names, errsbf, plainbf))
        + "; two launches bit-identical, weight cotangents included")
    for name, e, p, b in zip(names, errsbf, plainbf, bounds):
        if not e <= max(2 * p, b):
            raise AssertionError(f"bf16 backward {name}: error {e} exceeds max(2 x {p}, {b})")
    if ab.bwd_tc_launches != 2:
        raise AssertionError(f"bf16 backward: {ab.bwd_tc_launches} tensor-core launches, expected 2")
    del got, want, x32, g32
    # bf16 at the edges of the tensor-core kernel's 16-frame tiles, one sequence, odd nh
    for Me, Te, nhe in ((5, 1, nh), (5, 13, nh), (5, 16, nh), (5, 17, nh), (5, 64, nh),
                        (5, 65, nh), (3, 256, nh), (1, T, nh), (4, 40, 3)):
        with torch.no_grad():  # the layer's weights folded into nhe heads
            ops = ab.fold_weights(
                layer.norm_mhsa.weight, layer.norm_mhsa.bias, layer.mhsa.in_proj_weight,
                layer.mhsa.in_proj_bias, layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias,
                nhe)[:3]
        xe, ge = (torch.randn(Me, Te, H, generator=gen).to(dev).to(torch.bfloat16)
                  for _ in range(2))
        got = ab.backward(xe, *ops, ge, eps, nhe)
        label = f"bf16 backward at (M, T, nh) = {(Me, Te, nhe)}"
        relaunched(label, got, ab.backward(xe, *ops, ge, eps, nhe))
        errs = bf16_rule(label, got, ab.reference_bwd(xe.float(), *ops, ge.float(), eps, nhe),
                         ab.reference_bwd(xe, *ops, ge, eps, nhe), 0.0, 5e-3)
        log(f"bf16 edge (M, T, nh) = {(Me, Te, nhe)}: worst {max(errs):.3e}, relaunch "
            "bit-identical: ok")
    check_budget("backward vs plain")

    # 7. the training slice
    log(f"phase 7/29 training: Trainer fits {B_TRAIN} SyntheticDataset items "
        f"({CHANNELS} ch x {SECONDS:g} s) for {TRAIN_STEPS} steps, bf16")
    ab.launches = ab.tc_launches = ab.bwd_launches = ab.bwd_tc_launches = 0
    module, trainer, batch, losses = check_gradients.fit(dev)  # data and init launch nothing
    torch.cuda.synchronize()
    fit = (ab.launches, ab.tc_launches, ab.bwd_launches, ab.bwd_tc_launches)
    ab.launches = ab.tc_launches = ab.bwd_launches = ab.bwd_tc_launches = 0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step = (ab.launches, ab.tc_launches, ab.bwd_launches, ab.bwd_tc_launches)
    fit_fwd, fit_bwd, fit_tc = fit[0], fit[2], fit[3]
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    log(f"launches: fit {fit[0]} forward ({fit[1]} on the tensor-core kernel) + {fit[2]} "
        f"backward ({fit[3]} on the tensor-core kernel) in {TRAIN_STEPS} steps; one step "
        f"{step[0]} ({step[1]}) + {step[2]} ({step[3]})")
    if fit != (TRAIN_STEPS * n_layers,) * 4 or step != (n_layers,) * 4:
        raise AssertionError(f"expected {n_layers} forward and {n_layers} backward launches "
                             "a step, every one on the tensor-core kernels")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"mean loss of the first 5 steps {first:.3f}, of the last 5 {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    check_budget("training")

    # 8. gradient parity, fp32: the kernel path against the plain composition with its arch
    # in float64, by check_gradients.hold's rule (the fp32 counterpart of the bf16 rule)
    log("phase 8/29 gradients: kernel path (fp32) vs plain composition (fp32 and float64 arch), "
        "one batch")
    grads = check_gradients.gradients(module, trainer.to_device(batch), FLAGSHIP, dev)
    log(check_gradients.hold(grads))
    del grads
    torch.cuda.empty_cache()
    check_budget("gradients")

    # 9. times
    log("phase 9/29 times (CUDA events, after warm-up)")
    ms = cuda_ms(lambda: ab.backward(xb, ln, A, Wvo, gb, eps, nh), iters=10)
    x32, g32 = xb.float(), gb.float()
    ms_fp32 = cuda_ms(lambda: ab.backward(x32, ln, A, Wvo, g32, eps, nh), iters=3, warmup=1)
    del x32, g32
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
    log(f"attention_block backward bf16: tensor-core kernel {ms:.3f} ms (fp32, CUDA-core "
        f"kernel {ms_fp32:.3f} ms), plain {plain_ms:.3f} ms, library backward "
        f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {io_bytes / 1e6:.0f} MB, "
        f"{flops / 1e9:.1f} GFLOP unfolded)")
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
            "source": "nbss_tpu_torch/csrc/attention_block_bwd_tc.cu",
            "source_fp32": "nbss_tpu_torch/csrc/attention_block_bwd.cu",
            "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
            "replaces": "nbss_tpu/ops/attention_block.py:316",
            "launches": fit_bwd, "tc_launches": fit_tc, "max_abs_err": max(errs32),
            "max_err_fp32": dict(zip(names, errs32)), "max_err_bf16": dict(zip(names, errsbf)),
            "ms": ms, "ms_fp32": ms_fp32, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms, "train_step_ms": step_s * 1e3,
            "train_audio_s_per_s": B_TRAIN * SECONDS / step_s}, fit_fwd

def scan_inputs(gen, M: int, T: int, D: int, N: int, dtype, dev):
    """Seeded scan operands as the model gives them: dt log-uniform in the
    initial [0.001, 0.1], A = -(1..N) (A_log's initial value), and x, B, C
    in the compute dtype."""
    import math

    import torch

    x = torch.randn(M, T, D, generator=gen)
    dt = torch.empty(M, T, D).uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp()
    A = -torch.arange(1.0, N + 1).expand(D, N).contiguous()
    Bm, Cm = torch.randn(M, T, N, generator=gen), torch.randn(M, T, N, generator=gen)
    Dp = 1 + 0.1 * torch.randn(D, generator=gen)
    gy = torch.randn(M, T, D, generator=gen)
    ins = [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), Dp]
    return [t.to(dev) for t in ins], gy.to(dtype).to(dev)


def online_phases(dev):
    """Phases 10-15: OnlineSpatialNet mamba(16,4) through the selective-scan
    kernels. Returns the two scan kernels' rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from nbss_tpu_torch.data.synthetic import SyntheticDataset
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
    from nbss_tpu_torch.ops import ssm
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.loop import Trainer
    from nbss_tpu_torch.train.module import TrainModule

    T = int(SECONDS * FS) // 128 + 1
    Dm, N, n_layers = 2 * ONLINE["dim_hidden"], 16, ONLINE["num_layers"]
    M_serve, M_train = B * ONLINE["num_freqs"], B_TRAIN * ONLINE["num_freqs"]
    names = ("gx", "gdt", "gA", "gB", "gC", "gD")
    gen = torch.Generator().manual_seed(3)

    def fwd_check(ins, label):
        y = ssm.selective_scan(*ins)
        torch.cuda.synchronize()
        want = ssm.reference(*ins)
        err = (y - want).abs().max().item()
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4, msg=label)
        return err

    def bwd_check(ins, gy, label):
        _, hb = ssm.forward(*ins, boundaries=True)
        got = ssm.backward(*ins, hb, gy)
        torch.cuda.synchronize()
        want = ssm.reference_bwd(*ins, gy)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        for name, a, w in zip(names, got, want):
            torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=f"{label} {name}")
        return got, hb, errs

    # 10. forward kernel vs plain
    log(f"phase 10/29 selective_scan vs plain at M={M_serve} T={T} D={Dm} N={N}")
    ins32, _ = scan_inputs(gen, M_serve, T, Dm, N, torch.float32, dev)
    fwd_err32 = fwd_check(ins32, "fp32")
    log(f"fp32: max |kernel - plain| = {fwd_err32:.3e} (atol 2e-4, rtol 1e-4): ok")
    insb = [t.to(torch.bfloat16) if i in (0, 3, 4) else t for i, t in enumerate(ins32)]
    del ins32
    want = ssm.reference(*[t.float() for t in insb])
    fwd_errbf = (ssm.selective_scan(*insb).float() - want).abs().max().item()
    plainbf = (ssm.reference(*insb).float() - want).abs().max().item()
    del want
    log(f"bf16: max |kernel - fp32 plain| = {fwd_errbf:.4f}, plain bf16 version's = "
        f"{plainbf:.4f} (bound: 2x the plain version's)")
    if not fwd_errbf <= 2 * plainbf:
        raise AssertionError(f"bf16 scan error {fwd_errbf} exceeds 2 x {plainbf}")
    for shape in ((1, 1, Dm, N), (7, 13, 100, N), (3, 9, 33, 4)):
        ins, gy = scan_inputs(gen, *shape, torch.float32, dev)
        e = fwd_check(ins, f"ragged {shape}")
        _, _, be = bwd_check(ins, gy, f"ragged {shape}")
        log(f"ragged (M, T, D, N) = {shape}: forward {e:.2e}, backward worst {max(be):.2e}: ok")
    check_budget("scan vs plain")

    # 11. backward kernel vs plain
    log(f"phase 11/29 selective_scan backward vs plain at M={M_train} T={T} D={Dm} N={N}")
    ins32, gy32 = scan_inputs(gen, M_train, T, Dm, N, torch.float32, dev)
    got, _, bwd_errs32 = bwd_check(ins32, gy32, "fp32")
    _, hb = ssm.forward(*ins32, boundaries=True)
    again = ssm.backward(*ins32, hb, gy32)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    log("fp32: max |kernel - plain| " + ", ".join(
        f"{n} {e:.3e}" for n, e in zip(names, bwd_errs32))
        + f" (atol 5e-3 x max|plain|); two launches bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("two launches of the scan backward kernel on the same inputs differ")
    del got, again, hb
    insbt = [t.to(torch.bfloat16) if i in (0, 3, 4) else t for i, t in enumerate(ins32)]
    gybt = gy32.to(torch.bfloat16)
    del ins32, gy32
    _, hbbt = ssm.forward(*insbt, boundaries=True)
    want = ssm.reference_bwd(*[t.float() for t in insbt], gybt.float())
    bwd_errsbf = [(a.float() - w).abs().max().item()
                  for a, w in zip(ssm.backward(*insbt, hbbt, gybt), want)]
    plainbf = [(a.float() - w).abs().max().item()
               for a, w in zip(ssm.reference_bwd(*insbt, gybt), want)]
    bounds = [5e-3 * w.abs().max().item() for w in want]
    del want
    log("bf16: max |kernel - fp32 plain| vs the plain bf16 version's: " + ", ".join(
        f"{n} {e:.3e} / {p:.3e}" for n, e, p in zip(names, bwd_errsbf, plainbf)))
    for name, e, p, b in zip(names, bwd_errsbf, plainbf, bounds):
        if not e <= max(2 * p, b):
            raise AssertionError(f"bf16 scan backward {name}: error {e} exceeds max(2 x {p}, {b})")
    check_budget("scan backward vs plain")

    # 12. serving
    log(f"phase 12/29 OnlineSpatialNet {ONLINE['attention']} serving: TrainModule.forward + "
        f"predict_step, B={B}, {CHANNELS} ch, {SECONDS:g} s, bf16")
    net = OnlineSpatialNet(**ONLINE, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    ssm.launches = ssm.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    serve_fwd, serve_bwd = ssm.launches, ssm.bwd_launches
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, wave.shape[-1]) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if serve_fwd != 2 * 2 * n_layers or serve_bwd != 0:
        raise AssertionError(f"selective_scan launched {serve_fwd} forward and {serve_bwd} "
                             f"backward kernels in two forwards, expected {4 * n_layers} and 0")
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; selective_scan "
        f"launched {serve_fwd} times ({2 * n_layers} per forward), its backward {serve_bwd}")
    net32 = OnlineSpatialNet(**ONLINE, device=dev).eval()
    net32.load_state_dict(net.state_dict())
    plain32 = OnlineSpatialNet(**ONLINE, fused_scan=False, device=dev).eval()
    plain32.load_state_dict(net.state_dict())
    module32 = TrainModule(**{**module.__dict__, "arch": net32})
    y_kernel, _ = module32.forward(wave)
    y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave)
    serve_sdr = si_sdr(y_kernel, y_plain).min().item()
    del plain32, y_kernel, y_plain
    log(f"fp32 kernel path vs plain composition: min SI-SDR {serve_sdr:.1f} dB (bound >= 50)")
    if not serve_sdr >= 50.0:
        raise AssertionError(f"kernel path vs plain path SI-SDR {serve_sdr:.1f} dB < 50 dB")
    check_budget("online serving")

    # 13. streaming
    log(f"phase 13/29 streaming: forward_streaming vs forward, B={B_STREAM} x {SECONDS:g} s")
    wave_s = wave[:B_STREAM].contiguous()
    stream = {}
    for label, m in (("fp32", module32), ("bf16", module)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_str, _ = m.forward_streaming(wave_s)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        y_off, _ = m.forward(wave_s)
        if not torch.isfinite(y_str).all():
            raise AssertionError(f"{label} streaming output is not finite")
        stream[label] = (si_sdr(y_str, y_off).min().item(), B_STREAM * SECONDS / seconds)
        log(f"{label}: streaming vs offline min SI-SDR {stream[label][0]:.1f} dB; "
            f"{T} frames in {seconds:.2f} s = {stream[label][1]:.2f} audio-s/s")
    if not stream["fp32"][0] >= 50.0:
        raise AssertionError(f"fp32 streaming vs offline SI-SDR {stream['fp32'][0]:.1f} dB < 50")
    del net32, module32
    check_budget("streaming")

    # 14. training
    log(f"phase 14/29 training: Trainer fits {B_TRAIN} SyntheticDataset items for "
        f"{TRAIN_STEPS} steps, AdamW, bf16, remat")
    data = SyntheticDataset(num_items=B_TRAIN, num_channels=CHANNELS, sample_rate=FS,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(B_TRAIN)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]))
    tmodule = TrainModule(**{**module.__dict__, "arch": OnlineSpatialNet(
        **ONLINE, dtype=torch.bfloat16, remat=True, device=dev)})
    losses = []
    trainer = Trainer(tmodule, optimizer=("AdamW", {"lr": 1e-3, "weight_decay": 1e-3}),
                      gradient_clip_val=5.0, seed=2, device=dev,
                      logger=lambda k, v, _: losses.append(v) if k.startswith("train/") else None)
    trainer.init()
    torch.cuda.reset_peak_memory_stats()
    ssm.launches = ssm.bwd_launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_fwd, fit_bwd = ssm.launches, ssm.bwd_launches
    ssm.launches = ssm.bwd_launches = 0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step_fwd, step_bwd = ssm.launches, ssm.bwd_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    log(f"launches: fit {fit_fwd} forward + {fit_bwd} backward in {TRAIN_STEPS} steps; one step "
        f"{step_fwd} + {step_bwd} (forward {2 * n_layers} + {2 * n_layers} recomputed by remat, "
        f"backward {2 * n_layers}); peak memory {peak:.1f} GiB")
    want = (4 * n_layers, 2 * n_layers)
    if (step_fwd, step_bwd) != want or (fit_fwd, fit_bwd) != tuple(TRAIN_STEPS * w for w in want):
        raise AssertionError(f"expected {want[0]} forward and {want[1]} backward launches a step")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"mean loss of the first 5 steps {first:.3f}, of the last 5 {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    grads = []
    for fused in (True, False):
        net = OnlineSpatialNet(**ONLINE, remat=True, fused_scan=fused, device=dev)
        net.load_state_dict(tmodule.arch.state_dict())
        m32 = TrainModule(**{**tmodule.__dict__, "arch": net})
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
    log(f"fp32 gradients of {len(grads[0])} parameters, kernel path vs plain: worst "
        f"max |kernel - plain| / max|plain| = {worst[1]:.2e} ({worst[0]}; bound 5e-3)")
    del grads
    torch.cuda.empty_cache()
    check_budget("online training")

    # 15. times
    log("phase 15/29 times (CUDA events, after warm-up)")
    fwd_ms = cuda_ms(lambda: ssm.forward(*insb), iters=20)
    fwd_train_ms = cuda_ms(lambda: ssm.forward(*insbt, boundaries=True), iters=20)
    fwd_plain_ms = cuda_ms(lambda: ssm.reference(*insb), iters=2, warmup=1)
    bwd_ms = cuda_ms(lambda: ssm.backward(*insbt, hbbt, gybt), iters=20)
    bwd_plain_ms = cuda_ms(lambda: ssm.reference_bwd(*insbt, gybt), iters=1, warmup=1)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    elems = M_serve * T * Dm * N
    fwd_bytes = nbytes(insb) + nbytes(insb[:1])  # inputs read once, y written once
    fwd_ops = 7 * elems + 3 * M_serve * T * Dm  # counted in csrc/selective_scan.cu
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_ops, FP32_FLOP_PER_S)
    elems_t = M_train * T * Dm * N
    # the inputs, gy and the saved states hb read, one gradient each written
    bwd_bytes = 2 * nbytes(insbt) + nbytes([gybt, hbbt])
    bwd_ops = 22 * elems_t + 6 * M_train * T * Dm  # counted in csrc/selective_scan_bwd.cu
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_ops, FP32_FLOP_PER_S)
    log(f"selective_scan bf16 M={M_serve}: kernel {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms, "
        f"library none, bound {fwd_bound:.4f} ms ({fwd_by}: {fwd_bytes / 1e6:.0f} MB, "
        f"{fwd_ops / 1e9:.1f} GFLOP fp32); with saved states at M={M_train}: {fwd_train_ms:.3f} ms")
    log(f"selective_scan backward bf16 M={M_train}: kernel {bwd_ms:.3f} ms, plain "
        f"{bwd_plain_ms:.3f} ms, library none, bound {bwd_bound:.4f} ms ({bwd_by}: "
        f"{bwd_bytes / 1e6:.0f} MB, {bwd_ops / 1e9:.1f} GFLOP fp32)")
    del insb, insbt, hbbt, gybt

    for _ in range(2):
        module.predict_step(wave)
    torch.cuda.synchronize()
    reps, t1 = 5, time.perf_counter()
    for _ in range(reps):
        module.predict_step(wave)
    torch.cuda.synchronize()
    serve_s = (time.perf_counter() - t1) / reps
    log(f"serving: predict_step on {B} x {SECONDS:g} s in {serve_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve_s:.1f} audio-s/s")
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / reps
    log(f"training: train_step on {B_TRAIN} x {SECONDS:g} s in {step_s * 1e3:.1f} ms = "
        f"{B_TRAIN * SECONDS / step_s:.1f} audio-s/s trained")
    check_budget("online times")
    rates = {"serve_audio_s_per_s": B * SECONDS / serve_s,
             "stream_audio_s_per_s_fp32": stream["fp32"][1],
             "stream_audio_s_per_s_bf16": stream["bf16"][1],
             "stream_sdr_db_fp32": stream["fp32"][0], "stream_sdr_db_bf16": stream["bf16"][0],
             "serve_sdr_db_fp32": serve_sdr, "train_audio_s_per_s": B_TRAIN * SECONDS / step_s,
             "train_step_ms": step_s * 1e3, "train_peak_gib": peak}
    return [{"name": "selective_scan", "route": "cuda",
             "source": "nbss_tpu_torch/csrc/selective_scan.cu",
             "replaces": "nbss_tpu/ops/ssm.py:163", "launches": serve_fwd,
             "launches_training": fit_fwd, "max_abs_err": fwd_err32, "max_err_bf16": fwd_errbf,
             "ms": fwd_ms, "ms_with_saved_states_m1032": fwd_train_ms, "plain_ms": fwd_plain_ms,
             "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None, **rates},
            {"name": "selective_scan_bwd", "route": "cuda",
             "source": "nbss_tpu_torch/csrc/selective_scan_bwd.cu",
             "replaces": "nbss_tpu/ops/ssm.py:326", "launches": fit_bwd,
             "max_abs_err": max(bwd_errs32), "max_err_fp32": dict(zip(names, bwd_errs32)),
             "max_err_bf16": dict(zip(names, bwd_errsbf)), "ms": bwd_ms, "plain_ms": bwd_plain_ms,
             "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None}]


def attention_inputs(gen, M: int, T: int, nh: int, dh: int, dv: int, dtype, dev):
    """Seeded q, k [M, T, nh*dh], v and a cotangent g [M, T, nh*dv]."""
    import torch

    q, k = (torch.randn(M, T, nh * dh, generator=gen) for _ in range(2))
    v, g = (torch.randn(M, T, nh * dv, generator=gen) for _ in range(2))
    return [t.to(dtype).to(dev) for t in (q, k, v)], g.to(dtype).to(dev)


def mhsa_phases(dev):
    """Phases 16-21: OnlineSpatialNet mhsa(251) through the narrow-band
    attention kernels. Returns their two rows of the ``kernels`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch.data.synthetic import SyntheticDataset
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.online_spatialnet import (
        OnlineSpatialNet,
        alibi_mask,
        local_causal_mask,
    )
    from nbss_tpu_torch.ops import attention as att
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.loop import Trainer
    from nbss_tpu_torch.train.module import TrainModule

    T = int(SECONDS * FS) // 128 + 1
    nh, n_layers = MHSA["num_heads"], MHSA["num_layers"]
    dh = MHSA["dim_hidden"] // nh
    scope = int(MHSA["attention"][5:-1])
    M_serve, M_train = B * MHSA["num_freqs"], B_TRAIN * MHSA["num_freqs"]
    names = ("dq", "dk", "dv")
    gen = torch.Generator().manual_seed(4)

    def mask_of(kind, T, nh):
        m = {"none": None, "causal": local_causal_mask(T, scope),
             "alibi": alibi_mask(T, scope, nh)}[kind]
        return None if m is None else torch.from_numpy(m).clamp(min=-1e30).to(dev)

    def fwd_check(ins, mask, nh, label):
        o, _ = att.forward(*ins, mask, nh)
        torch.cuda.synchronize()
        want = att.reference(*ins, mask, nh)
        err = (o - want).abs().max().item()
        torch.testing.assert_close(o, want, atol=2e-4, rtol=1e-4, msg=label)
        return err

    def bwd_check(ins, mask, g, nh, label):
        _, st = att.forward(*ins, mask, nh, stats=True)
        got = att.backward(*ins, mask, g, nh, st)
        torch.cuda.synchronize()
        want = att.reference_bwd(*ins, mask, g, nh)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        for name, a, w in zip(names, got, want):
            torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=f"{label} {name}")
        return got, st, errs

    # 16. forward kernel vs plain
    log(f"phase 16/29 narrowband_attention vs plain at M={M_serve} T={T} nh={nh} dh={dh}")
    ins32, _ = attention_inputs(gen, M_serve, T, nh, dh, dh, torch.float32, dev)
    tc0 = att.tc_launches
    fwd_errs32 = {kind: fwd_check(ins32, mask_of(kind, T, nh), nh, f"fp32 {kind}")
                  for kind in ("none", "causal", "alibi")}
    log("fp32: max |kernel - plain| " + ", ".join(f"{k} mask {e:.3e}"
                                                  for k, e in fwd_errs32.items())
        + " (atol 2e-4, rtol 1e-4): ok")
    if att.tc_launches != tc0:
        raise AssertionError("float32 attention reached the tensor-core kernel")
    causal = mask_of("causal", T, nh)
    insb = [t.to(torch.bfloat16) for t in ins32]
    del ins32
    want = att.reference(*[t.float() for t in insb], causal, nh)
    got = att.forward(*insb, causal, nh, stats=True)
    relaunched("bf16 attention", got, att.forward(*insb, causal, nh, stats=True))
    fwd_errbf = (got[0].float() - want).abs().max().item()
    plainbf = (att.reference(*insb, causal, nh).float() - want).abs().max().item()
    del want, got
    log(f"bf16 (tensor-core kernel), causal mask: max |kernel - fp32 plain| = {fwd_errbf:.4f}, "
        f"plain bf16 version's = {plainbf:.4f} (bound: 2x the plain version's); two launches "
        "bit-identical, row statistics included")
    if not fwd_errbf <= 2 * plainbf:
        raise AssertionError(f"bf16 attention error {fwd_errbf} exceeds 2 x {plainbf}")
    if att.tc_launches - tc0 != 2:
        raise AssertionError(f"bf16 attention: {att.tc_launches - tc0} tensor-core launches, "
                             "expected 2")
    # bf16 at the edges of the tensor-core kernel's 16-row tiles and 256-key chunk (T > 256
    # takes two passes over the chunks), one sequence, both masks, q/k heads of 24, 64, 216
    for shape, kind in (((3, 1, 4, 24, 24), "causal"), ((3, 13, 4, 24, 24), "alibi"),
                        ((3, 16, 4, 24, 24), "causal"), ((3, 17, 4, 24, 24), "alibi"),
                        ((3, 64, 4, 24, 24), "causal"), ((3, 65, 4, 24, 24), "alibi"),
                        ((3, 256, 4, 24, 24), "causal"), ((2, 257, 4, 24, 24), "alibi"),
                        ((2, 300, 4, 24, 24), "causal"), ((1, T, 4, 24, 24), "alibi"),
                        ((2, T, 4, 64, 64), "causal"), ((2, 17, 4, 64, 16), "none"),
                        ((2, 65, 8, 216, 24), "alibi"), ((2, 300, 8, 216, 24), "causal"),
                        ((2, 248, 8, 216, 24), "none")):
        ins, _ = attention_inputs(gen, *shape, torch.bfloat16, dev)
        m = mask_of(kind, shape[1], shape[2])
        label = f"bf16 attention at (M, T, nh, dh, dv) = {shape}, {kind} mask"
        got = att.forward(*ins, m, shape[2], stats=True)
        relaunched(label, got, att.forward(*ins, m, shape[2], stats=True))
        e = bf16_rule(label, got[:1], [att.reference(*[t.float() for t in ins], m, shape[2])],
                      [att.reference(*ins, m, shape[2])], 2e-4, 1e-4)[0]
        log(f"bf16 edge {shape}, {kind} mask: {e:.2e}, relaunch bit-identical: ok")
    if att.tc_launches - tc0 != 32:
        raise AssertionError(f"{att.tc_launches - tc0} tensor-core launches, expected 32")
    for shape, kind in (((5, 1, 4, 24, 24), "causal"), ((7, 13, 4, 24, 24), "alibi"),
                        ((1, T, 4, 24, 24), "causal"), ((3, 40, 4, 16, 32), "alibi")):
        ins, g = attention_inputs(gen, *shape, torch.float32, dev)
        m = mask_of(kind, shape[1], shape[2])
        e = fwd_check(ins, m, shape[2], f"ragged {shape}")
        _, _, be = bwd_check(ins, m, g, shape[2], f"ragged {shape}")
        log(f"ragged (M, T, nh, dh, dv) = {shape}, {kind} mask: forward {e:.2e}, backward "
            f"worst {max(be):.2e}: ok")
    check_budget("attention vs plain")

    # 17. backward kernel vs plain
    log(f"phase 17/29 narrowband_attention backward vs plain at M={M_train} T={T}, causal mask")
    ins32, g32 = attention_inputs(gen, M_train, T, nh, dh, dh, torch.float32, dev)
    btc0 = att.bwd_tc_launches
    got, st32, bwd_errs32 = bwd_check(ins32, causal, g32, nh, "fp32")
    again = att.backward(*ins32, causal, g32, nh, st32)
    if att.bwd_tc_launches != btc0:
        raise AssertionError("float32 attention backward reached the tensor-core kernel")
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    log("fp32: max |kernel - plain| " + ", ".join(
        f"{n} {e:.3e}" for n, e in zip(names, bwd_errs32))
        + f" (atol 5e-3 x max|plain|); two launches bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("two launches of the attention backward on the same inputs differ")
    del got, again, st32
    insbt, gbt = [t.to(torch.bfloat16) for t in ins32], g32.to(torch.bfloat16)
    del ins32, g32
    _, stbt = att.forward(*insbt, causal, nh, stats=True)
    want = att.reference_bwd(*[t.float() for t in insbt], causal, gbt.float(), nh)
    gotbf = att.backward(*insbt, causal, gbt, nh, stbt)
    relaunched("bf16 attention backward", gotbf, att.backward(*insbt, causal, gbt, nh, stbt))
    bwd_errsbf = bf16_rule("bf16 attention backward", gotbf, want,
                           att.reference_bwd(*insbt, causal, gbt, nh), 0.0, 5e-3)
    plainbf = [(a.float() - w).abs().max().item()
               for a, w in zip(att.reference_bwd(*insbt, causal, gbt, nh), want)]
    del want, gotbf
    log("bf16 (tensor-core kernel): max |kernel - fp32 plain| vs the plain bf16 version's: "
        + ", ".join(f"{n} {e:.3e} / {p:.3e}" for n, e, p in zip(names, bwd_errsbf, plainbf))
        + "; two launches bit-identical, dk and dv included")
    if att.bwd_tc_launches - btc0 != 2:
        raise AssertionError(f"bf16 attention backward: {att.bwd_tc_launches - btc0} "
                             "tensor-core launches, expected 2")
    # bf16 at the edges of the tensor-core backward's 16-row tiles and 256-row chunks
    # (T > 256 takes the keys and queries in two chunks), both masks, heads of 24, 64, 216
    for shape, kind in (((1, 1, 4, 24, 24), "causal"), ((3, 15, 4, 24, 24), "alibi"),
                        ((3, 16, 4, 24, 24), "causal"), ((3, 17, 4, 24, 24), "alibi"),
                        ((3, 64, 4, 24, 24), "causal"), ((3, 65, 4, 24, 24), "alibi"),
                        ((1, T, 4, 24, 24), "alibi"), ((2, 256, 4, 24, 24), "causal"),
                        ((2, 257, 4, 24, 24), "alibi"), ((2, 300, 4, 24, 24), "causal"),
                        ((2, 300, 4, 24, 24), "none"), ((2, 65, 4, 64, 64), "causal"),
                        ((2, 17, 4, 64, 16), "none"), ((2, 65, 8, 216, 24), "alibi"),
                        ((1, 248, 8, 216, 24), "none")):
        ins, ge = attention_inputs(gen, *shape, torch.bfloat16, dev)
        m = mask_of(kind, shape[1], shape[2])
        label = f"bf16 attention backward at (M, T, nh, dh, dv) = {shape}, {kind} mask"
        _, ste = att.forward(*ins, m, shape[2], stats=True)
        got = att.backward(*ins, m, ge, shape[2], ste)
        relaunched(label, got, att.backward(*ins, m, ge, shape[2], ste))
        e = bf16_rule(label, got, att.reference_bwd(*[t.float() for t in ins], m, ge.float(),
                                                    shape[2]),
                      att.reference_bwd(*ins, m, ge, shape[2]), 0.0, 5e-3)
        log(f"bf16 backward edge {shape}, {kind} mask: worst {max(e):.2e}, relaunch "
            "bit-identical: ok")
    if att.bwd_tc_launches - btc0 != 32:
        raise AssertionError(f"{att.bwd_tc_launches - btc0} tensor-core backward launches, "
                             "expected 32")
    check_budget("attention backward vs plain")

    # 18. serving
    log(f"phase 18/29 OnlineSpatialNet {MHSA['attention']} serving: TrainModule.forward + "
        f"predict_step, B={B}, {CHANNELS} ch, {SECONDS:g} s, bf16")
    net = OnlineSpatialNet(**MHSA, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    att.launches = att.bwd_launches = att.tc_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    serve_fwd, serve_bwd, serve_tc = att.launches, att.bwd_launches, att.tc_launches
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, wave.shape[-1]) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if (serve_fwd, serve_tc) != (2 * n_layers,) * 2 or serve_bwd != 0:
        raise AssertionError(f"narrowband_attention launched {serve_fwd} forward ({serve_tc} on "
                             f"the tensor-core kernel) and {serve_bwd} backward kernels in two "
                             f"forwards, expected {2 * n_layers} on it and 0")
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; narrowband_attention "
        f"launched {serve_fwd} times ({n_layers} per forward, {serve_tc} on the tensor-core "
        f"kernel), its backward {serve_bwd}")
    net32 = OnlineSpatialNet(**MHSA, device=dev).eval()
    net32.load_state_dict(net.state_dict())
    plain32 = OnlineSpatialNet(**MHSA, fused_attention=False, device=dev).eval()
    plain32.load_state_dict(net.state_dict())
    module32 = TrainModule(**{**module.__dict__, "arch": net32})
    y_kernel, _ = module32.forward(wave)
    y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave)
    serve_sdr = si_sdr(y_kernel, y_plain).min().item()
    del plain32, y_kernel, y_plain
    log(f"fp32 kernel path vs plain attention: min SI-SDR {serve_sdr:.1f} dB (bound >= 50)")
    if not serve_sdr >= 50.0:
        raise AssertionError(f"kernel path vs plain path SI-SDR {serve_sdr:.1f} dB < 50 dB")
    check_budget("mhsa serving")

    # 19. streaming
    log(f"phase 19/29 streaming: forward_streaming vs forward, B={B_STREAM} x {SECONDS:g} s, "
        f"a KV ring buffer of {scope - 1} frames")
    wave_s = wave[:B_STREAM].contiguous()
    stream = {}
    for label, m in (("fp32", module32), ("bf16", module)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_str, _ = m.forward_streaming(wave_s)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        y_off, _ = m.forward(wave_s)
        if not torch.isfinite(y_str).all():
            raise AssertionError(f"{label} streaming output is not finite")
        stream[label] = (si_sdr(y_str, y_off).min().item(), B_STREAM * SECONDS / seconds)
        log(f"{label}: streaming vs offline min SI-SDR {stream[label][0]:.1f} dB; "
            f"{T} frames in {seconds:.2f} s = {stream[label][1]:.2f} audio-s/s")
    if not stream["fp32"][0] >= 50.0:
        raise AssertionError(f"fp32 streaming vs offline SI-SDR {stream['fp32'][0]:.1f} dB < 50")
    del net32, module32
    check_budget("mhsa streaming")

    # 20. training
    log(f"phase 20/29 training: Trainer fits {B_TRAIN} SyntheticDataset items for "
        f"{TRAIN_STEPS} steps, AdamW, bf16, remat")
    data = SyntheticDataset(num_items=B_TRAIN, num_channels=CHANNELS, sample_rate=FS,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(B_TRAIN)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]))
    tmodule = TrainModule(**{**module.__dict__, "arch": OnlineSpatialNet(
        **MHSA, dtype=torch.bfloat16, remat=True, device=dev)})
    losses = []
    trainer = Trainer(tmodule, optimizer=("AdamW", {"lr": 1e-3, "weight_decay": 1e-3}),
                      gradient_clip_val=5.0, seed=2, device=dev,
                      logger=lambda k, v, _: losses.append(v) if k.startswith("train/") else None)
    trainer.init()
    torch.cuda.reset_peak_memory_stats()
    att.launches = att.bwd_launches = att.tc_launches = att.bwd_tc_launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_fwd, fit_bwd, fit_tc, fit_btc = (att.launches, att.bwd_launches, att.tc_launches,
                                         att.bwd_tc_launches)
    att.launches = att.bwd_launches = att.tc_launches = att.bwd_tc_launches = 0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step_fwd, step_bwd, step_tc, step_btc = (att.launches, att.bwd_launches, att.tc_launches,
                                             att.bwd_tc_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    log(f"launches: fit {fit_fwd} forward ({fit_tc} tensor-core) + {fit_bwd} backward "
        f"({fit_btc} tensor-core) in {TRAIN_STEPS} steps; one step {step_fwd} ({step_tc}) + "
        f"{step_bwd} ({step_btc}) (forward {n_layers} + {n_layers} recomputed by remat, "
        f"backward {n_layers}); peak memory {peak:.1f} GiB")
    want = (2 * n_layers, 2 * n_layers, n_layers, n_layers)
    if ((step_fwd, step_tc, step_bwd, step_btc) != want
            or (fit_fwd, fit_tc, fit_bwd, fit_btc) != tuple(TRAIN_STEPS * w for w in want)):
        raise AssertionError(f"expected {want[0]} forward and {want[2]} backward launches a "
                             "step, all on the tensor-core kernels")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"mean loss of the first 5 steps {first:.3f}, of the last 5 {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    grads = []
    for fused in (True, False):
        net = OnlineSpatialNet(**MHSA, remat=True, fused_attention=fused, device=dev)
        net.load_state_dict(tmodule.arch.state_dict())
        m32 = TrainModule(**{**tmodule.__dict__, "arch": net})
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
    log(f"fp32 gradients of {len(grads[0])} parameters, kernel path vs plain: worst "
        f"max |kernel - plain| / max|plain| = {worst[1]:.2e} ({worst[0]}; bound 5e-3)")
    del grads
    torch.cuda.empty_cache()
    check_budget("mhsa training")

    # 21. times
    log("phase 21/29 times (CUDA events, after warm-up), causal mask")
    fwd_ms = cuda_ms(lambda: att.forward(*insb, causal, nh), iters=10)
    fwd_train_ms = cuda_ms(lambda: att.forward(*insbt, causal, nh, stats=True), iters=10)
    ins32 = [t.float() for t in insb]
    fwd_ms_fp32 = cuda_ms(lambda: att.forward(*ins32, causal, nh), iters=5)
    del ins32
    fwd_plain_ms = cuda_ms(lambda: att.reference(*insb, causal, nh), iters=3, warmup=1)
    bwd_ms = cuda_ms(lambda: att.backward(*insbt, causal, gbt, nh, stbt), iters=10)
    ins32, g32 = [t.float() for t in insbt], gbt.float()
    _, st32 = att.forward(*ins32, causal, nh, stats=True)
    bwd_ms_fp32 = cuda_ms(lambda: att.backward(*ins32, causal, g32, nh, st32), iters=3,
                          warmup=1)
    del ins32, g32, st32
    bwd_plain_ms = cuda_ms(lambda: att.reference_bwd(*insbt, causal, gbt, nh), iters=3, warmup=1)

    def heads(t):  # [M, T, nh*d] -> [M, nh, T, d], a view
        M_, T_, W = t.shape
        return t.view(M_, T_, nh, W // nh).transpose(1, 2)

    mask_b = causal.to(torch.bfloat16)  # SDPA takes a float mask in the inputs' dtype
    fwd_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *(heads(t) for t in insb), attn_mask=mask_b), iters=10)
    leaves = [t.detach().clone().requires_grad_() for t in insbt]
    o = F.scaled_dot_product_attention(*(heads(t) for t in leaves), attn_mask=mask_b)
    g4 = heads(gbt)  # graph built once; the port never calls this
    bwd_library_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, g4, retain_graph=True),
                             iters=10)
    del o, leaves

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    fwd_bytes = nbytes(insb) + nbytes(insb[2:]) + nbytes([causal])  # q, k, v, mask in; o out
    fwd_ops = 2 * M_serve * nh * T * T * (dh + dh)  # q k^T and e v
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_ops)
    bwd_bytes = 2 * nbytes(insbt) + nbytes([gbt, causal])  # q, k, v, g, mask in; dq, dk, dv out
    bwd_ops = 2 * M_train * nh * T * T * (3 * dh + 2 * dh)  # q k^T, e^T g', g' v^T, dS k, dS^T q
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_ops)
    log(f"narrowband_attention bf16 M={M_serve}: tensor-core kernel {fwd_ms:.3f} ms (fp32, "
        f"CUDA-core kernel {fwd_ms_fp32:.3f} ms), plain {fwd_plain_ms:.3f} ms, library (SDPA, "
        f"float mask) "
        f"{fwd_library_ms:.3f} ms, bound {fwd_bound:.4f} ms ({fwd_by}: "
        f"{fwd_bytes / 1e6:.0f} MB, {fwd_ops / 1e9:.1f} GFLOP); writing the row statistics "
        f"at M={M_train}: {fwd_train_ms:.3f} ms")
    log(f"narrowband_attention backward bf16 M={M_train}: tensor-core kernel {bwd_ms:.3f} ms "
        f"(fp32, CUDA-core kernel {bwd_ms_fp32:.3f} ms), plain "
        f"{bwd_plain_ms:.3f} ms, library (SDPA backward) {bwd_library_ms:.3f} ms, bound "
        f"{bwd_bound:.4f} ms ({bwd_by}: {bwd_bytes / 1e6:.0f} MB, {bwd_ops / 1e9:.1f} GFLOP)")
    del insb, insbt, gbt, stbt

    for _ in range(2):
        module.predict_step(wave)
    torch.cuda.synchronize()
    reps, t1 = 5, time.perf_counter()
    for _ in range(reps):
        module.predict_step(wave)
    torch.cuda.synchronize()
    serve_s = (time.perf_counter() - t1) / reps
    log(f"serving: predict_step on {B} x {SECONDS:g} s in {serve_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve_s:.1f} audio-s/s")
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / reps
    log(f"training: train_step on {B_TRAIN} x {SECONDS:g} s in {step_s * 1e3:.1f} ms = "
        f"{B_TRAIN * SECONDS / step_s:.1f} audio-s/s trained")
    check_budget("mhsa times")
    rates = {"serve_audio_s_per_s": B * SECONDS / serve_s,
             "stream_audio_s_per_s_fp32": stream["fp32"][1],
             "stream_audio_s_per_s_bf16": stream["bf16"][1],
             "stream_sdr_db_fp32": stream["fp32"][0], "stream_sdr_db_bf16": stream["bf16"][0],
             "serve_sdr_db_fp32": serve_sdr, "train_audio_s_per_s": B_TRAIN * SECONDS / step_s,
             "train_step_ms": step_s * 1e3, "train_peak_gib": peak}
    return [{"name": "narrowband_attention", "route": "cuda",
             "source": "nbss_tpu_torch/csrc/narrowband_attention_tc.cu",
             "source_fp32": "nbss_tpu_torch/csrc/narrowband_attention.cu",
             "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
             "replaces": "nbss_tpu/ops/attention.py:89", "launches": serve_fwd,
             "tc_launches": serve_tc, "launches_training": fit_fwd,
             "tc_launches_training": fit_tc, "max_abs_err": max(fwd_errs32.values()),
             "max_err_fp32": fwd_errs32, "max_err_bf16": fwd_errbf, "ms": fwd_ms,
             "ms_fp32": fwd_ms_fp32, "ms_with_row_stats_m1032": fwd_train_ms,
             "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
             "library_ms": fwd_library_ms, **rates},
            {"name": "narrowband_attention_bwd", "route": "cuda",
             "source": "nbss_tpu_torch/csrc/narrowband_attention_bwd_tc.cu",
             "source_fp32": "nbss_tpu_torch/csrc/narrowband_attention_bwd.cu",
             "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
             "replaces": "nbss_tpu/ops/attention.py:197", "launches": fit_bwd,
             "tc_launches": fit_btc, "launches_training": fit_bwd,
             "max_abs_err": max(bwd_errs32), "max_err_fp32": dict(zip(names, bwd_errs32)),
             "max_err_bf16": dict(zip(names, bwd_errsbf)), "ms": bwd_ms,
             "ms_fp32": bwd_ms_fp32, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound,
             "bound_by": bwd_by,
             "library_ms": bwd_library_ms}]


def nbc_phases(dev):
    """Phases 22-25: NBC through the relative-position block kernel, and the
    narrow-band attention kernels at NBC's augmented head width. Returns row
    8's entry of the ``kernels`` line and the keys that rows 4-5 gain."""
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nbc import NBC, sincos_position_tables
    from nbss_tpu_torch.ops import attention as att
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.module import TrainModule

    H, nh, n_layers = NBC_CFG["hidden_size"], NBC_CFG["n_heads"], NBC_CFG["n_layers"]
    n_freq = NBC_NFFT // 2 + 1
    samples = int(SECONDS * NBC_FS)
    T = samples // (NBC_NFFT // 2) + 1 - (NBC_CFG["encoder_kernel_size"] - 1)  # in the blocks
    M = B * n_freq
    dh, d2 = H // nh, H // 2
    gen = torch.Generator().manual_seed(5)
    net = NBC(**NBC_CFG, dtype=torch.bfloat16, generator=gen, device=dev).eval()

    def operands(layer, T_):
        sa = layer.self_attn
        with torch.no_grad():
            *ops, eps = ab.fold_weights_nbc(
                layer.norm1.weight, layer.norm1.bias, sa.query_proj.weight, sa.query_proj.bias,
                sa.key_proj.weight, sa.key_proj.bias, sa.value_proj.weight, sa.value_proj.bias,
                sa.out_proj.weight, sa.out_proj.bias, sa.pos_proj.weight, sa.u_bias, sa.v_bias,
                nh, layer.norm1.eps)
        tables = [torch.tensor(t, device=dev) for t in sincos_position_tables(T_, H)]
        return [*ops, *tables], eps

    def fwd_check(x, ops, eps, label):
        with torch.no_grad():
            y = ab.attention_block_relpos(x, *ops, eps, nh)
            torch.cuda.synchronize()
            want = ab.reference_relpos(x, *ops, eps, nh)
        err = (y - want).abs().max().item()
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4, msg=label)
        return y, err

    # 22. row 8 vs plain
    log(f"phase 22/29 attention_block_relpos vs plain at M={M} T={T} H={H} nh={nh}")
    ab.relpos_tc_launches = 0
    layer = net.sa_layers[0]
    ops, eps = operands(layer, T)
    x32 = torch.randn(M, T, H, generator=gen).to(dev)
    y, relpos_err32 = fwd_check(x32, ops, eps, "fp32")
    with torch.no_grad():
        again = ab.attention_block_relpos(x32, *ops, eps, nh)
    deterministic = torch.equal(y, again)
    log(f"fp32: max |kernel - plain| = {relpos_err32:.3e} (atol 2e-4, rtol 1e-4): ok; two "
        f"launches bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("two launches of the relative-position kernel differ")
    del y, again
    if ab.relpos_tc_launches != 0:
        raise AssertionError(f"float32 attention_block_relpos reached the tensor-core kernel "
                             f"({ab.relpos_tc_launches} launches)")
    xb = x32.to(torch.bfloat16)
    del x32

    def tc_check(x, ops_, label):
        """bf16 through the tensor-core kernel: a relaunch bit-identical; against
        the plain bf16 version, which rounds where it does, every element within
        one bf16 step of the largest term entering its sum. Returns (kernel
        output, plain output, steps, share of elements that differ)."""
        with torch.no_grad():
            y_ = ab.attention_block_relpos(x, *ops_, eps, nh)
            relaunched(label, [y_], [ab.attention_block_relpos(x, *ops_, eps, nh)])
            plain_ = ab.reference_relpos(x, *ops_, eps, nh)
            scale = torch.maximum(ab.relpos_term_scale(x, ops_[0], ops_[4], ops_[5], eps, nh),
                                  plain_.float().abs())
            step = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
            steps_ = ((y_.float() - plain_.float()).abs() / step).max().item()
            share_ = (y_ != plain_).float().mean().item()
        if not steps_ <= 1.0:
            raise AssertionError(f"{label}: the tensor-core kernel is {steps_:.2f} bf16 steps "
                                 "from the plain bf16 version")
        return y_, plain_, steps_, share_

    ybf, plainbf_y, relpos_steps, relpos_share = tc_check(xb, ops, "bf16 attention_block_relpos")
    if ab.relpos_tc_launches != 2:
        raise AssertionError(f"bf16 attention_block_relpos: {ab.relpos_tc_launches} tensor-core "
                             "launches, expected 2")
    with torch.no_grad():
        want = ab.reference_relpos(xb.float(), *ops, eps, nh)
        relpos_errbf = (ybf.float() - want).abs().max().item()
        plainbf = (plainbf_y.float() - want).abs().max().item()
    del want, ybf, plainbf_y
    log(f"bf16 (tensor-core kernel): {100 * relpos_share:.3f}% of elements differ from the plain "
        f"bf16 version, at most {relpos_steps:.2f} bf16 steps of the largest term (bound 1); "
        f"max |kernel - fp32 plain| = {relpos_errbf:.4f}, plain bf16 version's = {plainbf:.4f} "
        "(bound: 2x the plain version's); two launches bit-identical")
    if not relpos_errbf <= 2 * plainbf:
        raise AssertionError(f"bf16 relative-position error {relpos_errbf} exceeds 2 x {plainbf}")
    for Mr, Tr in ((5, 1), (7, 13), (1, T), (3, 256), (2, 300)):
        ops_r, _ = operands(layer, Tr)
        xr = torch.randn(Mr, Tr, H, generator=gen).to(dev)
        _, e = fwd_check(xr, ops_r, eps, f"ragged {(Mr, Tr)}")
        *_, st, sh = tc_check(xr.to(torch.bfloat16), ops_r, f"bf16 ragged {(Mr, Tr)}")
        log(f"ragged (M, T) = {(Mr, Tr)}: fp32 {e:.2e}; bf16 tensor-core kernel {st:.2f} steps, "
            f"{100 * sh:.3f}% differ: ok")
    Mg = 2 * n_freq
    xg = torch.randn(Mg, T, H, generator=gen).to(dev)
    gy = torch.randn(Mg, T, H, generator=gen).to(dev)
    grads = []
    for fn in (ab.attention_block_relpos, ab.reference_relpos):
        leaves = [xg.clone().requires_grad_()] + [t.clone().requires_grad_() for t in ops[:6]]
        grads.append(torch.autograd.grad(fn(*leaves, *ops[6:], eps, nh), leaves, gy))
    worst = 0.0
    for name, a, w in zip(("dx", "dln", "dA", "dGs", "dGc", "dWvo", "dc"), *grads):
        rel = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if not rel <= 5e-3:
            raise AssertionError(f"relative-position gradient {name}: {rel:.2e} x max|plain|")
    log(f"fp32 gradients through the kernel's Function at M={Mg}, x and every operand: worst "
        f"max |kernel - plain| / max|plain| = {worst:.2e} (bound 5e-3)")
    del grads, xg, gy
    torch.cuda.empty_cache()
    check_budget("relpos vs plain")

    # 23. rows 4-5 at NBC's widths
    dhp, dv, Ma = dh + H, dh, 2 * n_freq
    log(f"phase 23/29 narrowband_attention at NBC's widths: M={Ma} T={T} nh={nh} dh={dhp} dv={dv}")
    ins32, g32 = attention_inputs(gen, Ma, T, nh, dhp, dv, torch.float32, dev)
    o, st = att.forward(*ins32, None, nh, stats=True)
    torch.cuda.synchronize()
    want = att.reference(*ins32, None, nh)
    wide_fwd_err = (o - want).abs().max().item()
    torch.testing.assert_close(o, want, atol=2e-4, rtol=1e-4)
    got = att.backward(*ins32, None, g32, nh, st)
    want = att.reference_bwd(*ins32, None, g32, nh)
    wide_bwd_errs = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        wide_bwd_errs.append((a - w).abs().max().item())
        torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3, msg=name)
    again = att.backward(*ins32, None, g32, nh, st)
    deterministic = (torch.equal(o, att.forward(*ins32, None, nh)[0])
                     and all(torch.equal(a, b) for a, b in zip(got, again)))
    log(f"fp32: forward {wide_fwd_err:.3e} (atol 2e-4, rtol 1e-4); backward dq, dk, dv "
        + ", ".join(f"{e:.3e}" for e in wide_bwd_errs) + " (atol 5e-3 x max|plain|); "
        f"relaunches bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("relaunches of the wide attention kernels differ")
    del o, st, got, again, want
    insb, gb = [t.to(torch.bfloat16) for t in ins32], g32.to(torch.bfloat16)
    del ins32, g32
    want = att.reference(*[t.float() for t in insb], None, nh)
    tc0 = att.tc_launches
    ob, stb = att.forward(*insb, None, nh, stats=True)
    relaunched("bf16 wide attention", (ob, stb), att.forward(*insb, None, nh, stats=True))
    wide_errbf = (ob.float() - want).abs().max().item()
    plainbf = (att.reference(*insb, None, nh).float() - want).abs().max().item()
    log(f"bf16 forward (tensor-core kernel): max |kernel - fp32 plain| = {wide_errbf:.4f}, plain "
        f"bf16 version's = {plainbf:.4f} (bound: 2x the plain version's); two launches "
        "bit-identical")
    if not wide_errbf <= 2 * plainbf:
        raise AssertionError(f"bf16 wide attention error {wide_errbf} exceeds 2 x {plainbf}")
    if att.tc_launches - tc0 != 2:
        raise AssertionError(f"bf16 wide attention: {att.tc_launches - tc0} tensor-core "
                             "launches, expected 2")
    del ob
    want = att.reference_bwd(*[t.float() for t in insb], None, gb.float(), nh)
    btc0 = att.bwd_tc_launches
    gotb = att.backward(*insb, None, gb, nh, stb)
    relaunched("bf16 wide attention backward", gotb, att.backward(*insb, None, gb, nh, stb))
    errs = [(a.float() - w).abs().max().item() for a, w in zip(gotb, want)]
    plain = [(a.float() - w).abs().max().item()
             for a, w in zip(att.reference_bwd(*insb, None, gb, nh), want)]
    del gotb
    log("bf16 backward (tensor-core kernel): max |kernel - fp32 plain| vs the plain bf16 "
        "version's: " + ", ".join(
            f"{n} {e:.3e} / {p:.3e}" for n, e, p in zip(("dq", "dk", "dv"), errs, plain))
        + "; two launches bit-identical")
    if att.bwd_tc_launches - btc0 != 2:
        raise AssertionError(f"bf16 wide attention backward: {att.bwd_tc_launches - btc0} "
                             "tensor-core launches, expected 2")
    for name, e, p, w in zip(("dq", "dk", "dv"), errs, plain, want):
        if not e <= max(2 * p, 5e-3 * w.abs().max().item()):
            raise AssertionError(f"bf16 wide attention backward {name}: {e} vs plain {p}")
    del want
    check_budget("wide attention vs plain")

    # 24. NBC serving
    log(f"phase 24/29 NBC serving: TrainModule.forward + predict_step, B={B}, {NBC_CHANNELS} ch, "
        f"{SECONDS:g} s at {NBC_FS} Hz, bf16")
    module = TrainModule(arch=net, channels=tuple(range(NBC_CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=NBC_NFFT, n_hop=NBC_NFFT // 2),
                         norm=Norm(mode="frequency"), loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, NBC_CHANNELS, samples, generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, samples, generator=gen)).to(dev)
    ab.relpos_launches = ab.relpos_tc_launches = att.launches = att.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    serve_relpos, serve_att = ab.relpos_launches, att.launches + att.bwd_launches
    serve_relpos_tc = ab.relpos_tc_launches
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, samples) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if serve_relpos != 2 * n_layers or serve_relpos_tc != serve_relpos or serve_att != 0:
        raise AssertionError(f"attention_block_relpos launched {serve_relpos} times "
                             f"({serve_relpos_tc} on the tensor-core kernel) and the narrow-band "
                             f"attention {serve_att} in two forwards, expected {2 * n_layers} "
                             "(all on the tensor-core kernel) and 0")
    log(f"forward and predict_step: finite [{B}, 2, {samples}]; attention_block_relpos launched "
        f"{serve_relpos} times ({n_layers} per forward), {serve_relpos_tc} on the tensor-core "
        f"kernel; the narrow-band attention {serve_att}")
    sdrs = {}
    for label, kw, bsz in (("pre-LN", {}, NBC_B_CHECK), ("post-LN", {"norm_first": False}, 2)):
        kernel32 = NBC(**NBC_CFG, **kw, device=dev).eval()
        kernel32.load_state_dict(net.state_dict())
        plain32 = NBC(**NBC_CFG, **kw, fused_block=False, attention_kernel=False,
                      device=dev).eval()
        plain32.load_state_dict(net.state_dict())
        ab.relpos_launches = att.launches = 0
        y_kernel, _ = TrainModule(**{**module.__dict__, "arch": kernel32}).forward(wave[:bsz])
        launched = (ab.relpos_launches, att.launches)
        y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave[:bsz])
        sdrs[label] = si_sdr(y_kernel, y_plain).min().item()
        want = (n_layers, 0) if not kw else (0, n_layers)
        log(f"fp32 {label} kernel path vs plain composition at B={bsz}: min SI-SDR "
            f"{sdrs[label]:.1f} dB (bound >= 50); launches (relpos, narrow-band) {launched}")
        if launched != want:
            raise AssertionError(f"{label}: launches {launched}, expected {want}")
        if not sdrs[label] >= 50.0:
            raise AssertionError(f"{label} kernel path vs plain SI-SDR {sdrs[label]:.1f} dB < 50")
        del kernel32, plain32, y_kernel, y_plain
    torch.cuda.empty_cache()
    check_budget("nbc serving")

    # 25. times
    log("phase 25/29 times (CUDA events, after warm-up)")
    xb = torch.randn(M, T, H, generator=gen).to(dev).to(torch.bfloat16)
    with torch.no_grad():
        relpos_ms = cuda_ms(lambda: ab.attention_block_relpos(xb, *ops, eps, nh), iters=10,
                            warmup=1)
        x32 = xb.float()
        relpos_ms_fp32 = cuda_ms(lambda: ab.attention_block_relpos(x32, *ops, eps, nh), iters=2,
                                 warmup=1)
        del x32
        relpos_plain_ms = cuda_ms(lambda: ab.reference_relpos(xb, *ops, eps, nh), iters=1,
                                  warmup=1)
        sa = layer.self_attn
        bf = torch.bfloat16
        ln_w, ln_b = layer.norm1.weight.to(bf), layer.norm1.bias.to(bf)
        projs = [(p.weight.to(bf), p.bias.to(bf)) for p in (sa.query_proj, sa.key_proj,
                                                            sa.value_proj, sa.out_proj)]
        u, vb = sa.u_bias.to(bf), sa.v_bias.to(bf)
        wpos = sa.pos_proj.weight.to(bf).t().reshape(H, nh, dh)
        w_sin, w_cos = wpos[0::2], wpos[1::2]
        sin_t, cos_t = ops[6].to(bf), ops[7].to(bf)
        fix = torch.tensor((dh + H) ** 0.5 / H ** 0.5, dtype=bf)
        cs = torch.cat([cos_t, sin_t], -1)[None, None].expand(M, nh, T, H)

        def library():  # one PyTorch composition of the same function; the port never calls it
            z = F.layer_norm(xb, (H,), ln_w, ln_b)
            q, k, v = (F.linear(z, w, b).view(M, T, nh, dh) for w, b in projs[:3])
            qv = q + vb
            gs = torch.einsum("mqhd,fhd->mqhf", qv, w_sin)
            gc = torch.einsum("mqhd,fhd->mqhf", qv, w_cos)
            A = gs * sin_t[:, None] + gc * cos_t[:, None]
            Bq = gc * sin_t[:, None] - gs * cos_t[:, None]
            qa = torch.cat([q + u, A, Bq], -1).transpose(1, 2) * fix
            ka = torch.cat([k.transpose(1, 2), cs], -1)
            o = F.scaled_dot_product_attention(qa, ka, v.transpose(1, 2))
            return xb + F.linear(o.transpose(1, 2).reshape(M, T, H), *projs[3])

        relpos_library_ms = cuda_ms(library, iters=5)
    relpos_bytes = 2 * xb.numel() * xb.element_size() + sum(
        t.numel() * t.element_size() for t in ops)
    Ha = H + 2
    relpos_ops = (2 * M * T * nh * Ha * (2 * Ha + 2 * d2)  # t, gs, gc, vo
                  + 2 * M * nh * T * T * (2 * H + (H + 1)))  # scores over [xa, cos, sin]; e vo
    relpos_bound, relpos_by = bound(relpos_bytes, relpos_ops)
    log(f"attention_block_relpos bf16 M={M}: tensor-core kernel {relpos_ms:.3f} ms (fp32, "
        f"CUDA-core kernel {relpos_ms_fp32:.3f} ms), plain {relpos_plain_ms:.3f} ms, library "
        f"(LN + projections + SDPA over the {dh + H}-wide heads + out projection) "
        f"{relpos_library_ms:.3f} ms, bound "
        f"{relpos_bound:.4f} ms ({relpos_by}: {relpos_bytes / 1e6:.0f} MB, "
        f"{relpos_ops / 1e12:.2f} TFLOP folded)")
    del xb

    # rows 4-5 at dh = 216: the forward at the serving count, the backward at Ma
    qf, kf, vf = (torch.randn(M, T, nh * d, generator=gen).to(dev).to(torch.bfloat16)
                  for d in (dhp, dhp, dv))
    wide_ms = cuda_ms(lambda: att.forward(qf, kf, vf, None, nh), iters=5)
    q32, k32, v32 = (t.float() for t in (qf, kf, vf))
    wide_ms_fp32 = cuda_ms(lambda: att.forward(q32, k32, v32, None, nh), iters=1, warmup=1)
    del q32, k32, v32

    def heads(t):  # [M, T, nh*d] -> [M, nh, T, d], a view
        M_, T_, W = t.shape
        return t.view(M_, T_, nh, W // nh).transpose(1, 2)

    wide_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        heads(qf), heads(kf), heads(vf)), iters=5)
    wide_bytes = sum(t.numel() * t.element_size() for t in (qf, kf, vf, vf))
    wide_ops = 2 * M * nh * T * T * (dhp + dv)
    wide_bound, wide_by = bound(wide_bytes, wide_ops)
    del qf, kf, vf
    wide_plain_ms = cuda_ms(lambda: att.reference(*insb, None, nh), iters=2, warmup=1)
    wide_bwd_ms = cuda_ms(lambda: att.backward(*insb, None, gb, nh, stb), iters=3)
    ins32, g32 = [t.float() for t in insb], gb.float()
    _, st32 = att.forward(*ins32, None, nh, stats=True)
    wide_bwd_ms_fp32 = cuda_ms(lambda: att.backward(*ins32, None, g32, nh, st32), iters=1,
                               warmup=1)
    del ins32, g32, st32
    wide_bwd_plain_ms = cuda_ms(lambda: att.reference_bwd(*insb, None, gb, nh), iters=2,
                                warmup=1)
    leaves = [t.detach().clone().requires_grad_() for t in insb]
    o = F.scaled_dot_product_attention(*(heads(t) for t in leaves))
    g4 = heads(gb)  # graph built once; the port never calls this
    wide_bwd_library_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, g4, retain_graph=True),
                                  iters=5)
    del o, leaves
    wide_bwd_bytes = 2 * sum(t.numel() * t.element_size() for t in insb) + gb.numel() * 2
    wide_bwd_ops = 2 * Ma * nh * T * T * (3 * dhp + 2 * dv)
    wide_bwd_bound, wide_bwd_by = bound(wide_bwd_bytes, wide_bwd_ops)
    log(f"narrowband_attention bf16 at dh={dhp}, dv={dv}, no mask: forward M={M} tensor-core "
        f"kernel {wide_ms:.3f} ms (fp32, CUDA-core kernel {wide_ms_fp32:.3f} ms), library (SDPA) "
        f"{wide_library_ms:.3f} ms, bound {wide_bound:.4f} ms "
        f"({wide_by}); plain at M={Ma} {wide_plain_ms:.3f} ms; backward M={Ma} tensor-core "
        f"kernel {wide_bwd_ms:.3f} ms (fp32, CUDA-core kernel {wide_bwd_ms_fp32:.3f} ms), plain "
        f"{wide_bwd_plain_ms:.3f} ms, library (SDPA backward) "
        f"{wide_bwd_library_ms:.3f} ms, bound {wide_bwd_bound:.4f} ms ({wide_bwd_by})")
    del insb, gb, stb

    module.predict_step(wave)  # warm-up
    torch.cuda.synchronize()
    reps, t1 = 3, time.perf_counter()
    for _ in range(reps):
        module.predict_step(wave)
    torch.cuda.synchronize()
    serve_s = (time.perf_counter() - t1) / reps
    log(f"NBC serving: predict_step on {B} x {SECONDS:g} s in {serve_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve_s:.1f} audio-s/s")
    check_budget("nbc times")
    row8 = {"name": "attention_block_relpos", "route": "cuda",
            "source": "nbss_tpu_torch/csrc/attention_block_relpos_tc.cu",
            "source_fp32": "nbss_tpu_torch/csrc/attention_block_relpos.cu",
            "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
            "replaces": "nbss_tpu/ops/attention_block.py:517", "launches": serve_relpos,
            "tc_launches": serve_relpos_tc, "max_abs_err": relpos_err32,
            "max_err_bf16": relpos_errbf, "bf16_steps_vs_plain": relpos_steps,
            "bf16_share_differing": relpos_share, "ms": relpos_ms,
            "ms_fp32": relpos_ms_fp32, "plain_ms": relpos_plain_ms, "bound_ms": relpos_bound,
            "bound_by": relpos_by, "library_ms": relpos_library_ms,
            "serve_audio_s_per_s": B * SECONDS / serve_s, "serve_step_ms": serve_s * 1e3,
            "serve_sdr_db_fp32": sdrs["pre-LN"], "post_ln_sdr_db_fp32": sdrs["post-LN"]}
    row4 = {"nbc_dh216": {"M": M, "ms": wide_ms, "ms_fp32": wide_ms_fp32,
                          "library_ms": wide_library_ms,
                          "bound_ms": wide_bound, "bound_by": wide_by, "plain_ms_m": Ma,
                          "plain_ms": wide_plain_ms, "max_abs_err": wide_fwd_err,
                          "max_err_bf16": wide_errbf}}
    row5 = {"nbc_dh216": {"M": Ma, "ms": wide_bwd_ms, "ms_fp32": wide_bwd_ms_fp32,
                          "plain_ms": wide_bwd_plain_ms,
                          "library_ms": wide_bwd_library_ms, "bound_ms": wide_bwd_bound,
                          "bound_by": wide_bwd_by,
                          "max_err_fp32": dict(zip(("dq", "dk", "dv"), wide_bwd_errs))}}
    return row8, row4, row5


def ffn_params(gen, H: int, FF: int, dev):
    """Seeded random T-ConvFFN parameters in torch layout (fan-in scaled)."""
    from nbss_tpu_torch.ops.tconvffn import PARAM_NAMES

    cpg = FF // 8
    shapes = {"ln_scale": (H,), "ln_bias": (H,), "w_up": (FF, H), "b_up": (FF,),
              "gn_scale": (FF,), "gn_bias": (FF,), "w_down": (H, FF), "b_down": (H,),
              **{f"w_c{i}": (FF, cpg, 3) for i in (1, 2, 3)},
              **{f"b_c{i}": (FF,) for i in (1, 2, 3)}}
    import torch

    out = {}
    for k in PARAM_NAMES:
        fan_in = {"w_up": H, "w_down": FF}.get(k, 3 * cpg)
        v = torch.randn(*shapes[k], generator=gen) / (fan_in ** 0.5 if k.startswith("w_") else 10)
        out[k] = (v + 1 if k.endswith("_scale") else v).to(dev)
    return out


def tconvffn_phases(dev):
    """Phases 26-29: SpatialNet-small with ``fused_ffn=True``, whose
    T-ConvFFN runs through the row-3 kernel. Returns row 3's entry of the
    ``kernels`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch.data.synthetic import SyntheticDataset
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops import tconvffn as tc
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.loop import Trainer
    from nbss_tpu_torch.train.module import TrainModule

    n_layers, H, FF = FLAGSHIP["num_layers"], FLAGSHIP["dim_hidden"], FLAGSHIP["dim_ffn"]
    G = FLAGSHIP["conv_groups"][1]
    n_freq, T = FLAGSHIP["num_freqs"], int(SECONDS * FS) // 128 + 1
    M = B * n_freq
    gen = torch.Generator().manual_seed(6)
    net = SpatialNet(**FLAGSHIP, fused_ffn=True, dtype=torch.bfloat16, generator=gen,
                     device=dev).eval()
    with torch.no_grad():
        p = {k: v.detach() for k, v in tc.params_from_sequential(net.layers[0].tconvffn).items()}

    def fwd_check(x, params, label):
        with torch.no_grad():
            y = tc.tconvffn(x, params, G)
            torch.cuda.synchronize()
            want = tc.reference(x, params, G)
        err = (y - want).abs().max().item()
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4, msg=label)
        return y, err

    # 26. row 3 vs plain
    log(f"phase 26/29 tconvffn vs plain at M={M} T={T} H={H} FF={FF} groups={G}")
    x32 = torch.randn(M, T, H, generator=gen).to(dev)
    y, ffn_err32 = fwd_check(x32, p, "fp32")
    with torch.no_grad():
        deterministic = torch.equal(y, tc.tconvffn(x32, p, G))
    log(f"fp32: max |kernel - plain| = {ffn_err32:.3e} (atol 2e-4, rtol 1e-4): ok; two launches "
        f"bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("two launches of the T-ConvFFN kernel differ")
    del y
    xb = x32.to(torch.bfloat16)
    with torch.no_grad():
        want = tc.reference(xb.float(), p, G)
        ffn_errbf = (tc.tconvffn(xb, p, G).float() - want).abs().max().item()
        plainbf = (tc.reference(xb, p, G).float() - want).abs().max().item()
    del want
    log(f"bf16: max |kernel - fp32 plain| = {ffn_errbf:.4f}, plain bf16 version's = "
        f"{plainbf:.4f} (bound: 2x the plain version's)")
    if not ffn_errbf <= 2 * plainbf:
        raise AssertionError(f"bf16 T-ConvFFN error {ffn_errbf} exceeds 2 x {plainbf}")
    for Mr, Tr in ((5, 1), (3, 2), (7, 13), (1, T)):
        _, e = fwd_check(torch.randn(Mr, Tr, H, generator=gen).to(dev), p, f"ragged {(Mr, Tr)}")
        log(f"ragged (M, T) = {(Mr, Tr)}: {e:.2e}: ok")
    p_large = ffn_params(gen, 2 * H, 2 * FF, dev)
    _, e = fwd_check(torch.randn(2 * n_freq, T, 2 * H, generator=gen).to(dev), p_large,
                     "SpatialNet-large widths")
    log(f"SpatialNet-large widths (H={2 * H}, FF={2 * FF}) at M={2 * n_freq}: {e:.2e}: ok")
    Mg = 2 * n_freq
    xg = torch.randn(Mg, T, H, generator=gen).to(dev)
    gy = torch.randn(Mg, T, H, generator=gen).to(dev)
    grads = []
    for kernel in (True, False):
        leaves = [xg.clone().requires_grad_()] + [v.clone().requires_grad_() for v in p.values()]
        y = tc.tconvffn(leaves[0], dict(zip(p, leaves[1:])), G, kernel=kernel)
        grads.append(torch.autograd.grad(y, leaves, gy))
    worst = 0.0
    for name, a, w in zip(("x", *p), *grads):
        rel = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if not rel <= 5e-3:
            raise AssertionError(f"T-ConvFFN gradient {name}: {rel:.2e} x max|plain|")
    log(f"fp32 gradients through the kernel's Function at M={Mg}, x and every parameter: worst "
        f"max |kernel - plain| / max|plain| = {worst:.2e} (bound 5e-3)")
    del grads, xg, gy, x32, p_large
    torch.cuda.empty_cache()
    check_budget("tconvffn vs plain")

    # 27. serving
    log(f"phase 27/29 SpatialNet-small fused_ffn=True serving: TrainModule.forward + "
        f"predict_step, B={B}, {CHANNELS} ch, {SECONDS:g} s, bf16")
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    tc.launches = ab.launches = ab.tc_launches = ab.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    served = (tc.launches, ab.launches, ab.bwd_launches)
    if ab.tc_launches != ab.launches:
        raise AssertionError(f"{ab.launches - ab.tc_launches} bf16 attention-block launches "
                             "missed the tensor-core kernel")
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, wave.shape[-1]) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if served != (2 * n_layers, 2 * n_layers, 0):
        raise AssertionError(f"launches (tconvffn, attention block, its backward) {served} in two "
                             f"forwards, expected {(2 * n_layers, 2 * n_layers, 0)}")
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; launches (tconvffn, "
        f"attention block, backward) {served} ({n_layers} + {n_layers} per forward, the "
        "attention block's all on its tensor-core kernel)")
    kernel32 = SpatialNet(**FLAGSHIP, fused_ffn=True, device=dev).eval()
    kernel32.load_state_dict(net.state_dict())
    plain32 = SpatialNet(**FLAGSHIP, fused_block=False, device=dev).eval()
    plain32.load_state_dict(net.state_dict())
    tc.launches = 0
    y_kernel, _ = TrainModule(**{**module.__dict__, "arch": kernel32}).forward(wave)
    launched = tc.launches
    y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave)
    ffn_sdr = si_sdr(y_kernel, y_plain).min().item()
    del kernel32, plain32, y_kernel, y_plain
    log(f"fp32 kernel path vs plain composition: min SI-SDR {ffn_sdr:.1f} dB (bound >= 50); "
        f"tconvffn launched {launched} times")
    if launched != n_layers or not ffn_sdr >= 50.0:
        raise AssertionError(f"fp32 kernel path: {launched} launches, SI-SDR {ffn_sdr:.1f} dB")
    torch.cuda.empty_cache()
    check_budget("fused_ffn serving")

    # 28. training
    log(f"phase 28/29 training with fused_ffn=True: Trainer fits {B_TRAIN} SyntheticDataset "
        f"items for {TRAIN_STEPS} steps, bf16")
    data = SyntheticDataset(num_items=B_TRAIN, num_channels=CHANNELS, sample_rate=FS,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(B_TRAIN)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
             [it[2] for it in items])

    def trainer_for(fused_ffn, losses):
        m = TrainModule(arch=SpatialNet(**FLAGSHIP, fused_ffn=fused_ffn, dtype=torch.bfloat16,
                                        device=dev),
                        channels=tuple(range(CHANNELS)), stft=STFT(n_fft=256, n_hop=128),
                        norm=Norm(mode="frequency"))
        t = Trainer(m, optimizer=("Adam", {"lr": 1e-3}), gradient_clip_val=5.0, seed=2,
                    device=dev, logger=lambda k, v, step: losses.append(v)
                    if k.startswith("train/") else None)
        t.init()
        return t

    losses = []
    trainer = trainer_for(True, losses)
    tc.launches = ab.launches = ab.bwd_launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit = (tc.launches, ab.launches, ab.bwd_launches)
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    log(f"launches (tconvffn, attention block, its backward) in {TRAIN_STEPS} steps: {fit}")
    if fit != (TRAIN_STEPS * n_layers,) * 3:
        raise AssertionError(f"expected {n_layers} launches of each a step")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"mean loss of the first 5 steps {first:.3f}, of the last 5 {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    grads = []  # row 3 against the plain T-ConvFFN; phase 8 holds the attention block's path
    for fused_ffn in (True, False):
        net32 = SpatialNet(**FLAGSHIP, fused_ffn=fused_ffn, device=dev)
        net32.load_state_dict(trainer.arch.state_dict())
        m32 = TrainModule(**{**trainer.module.__dict__, "arch": net32})
        m32.training_step(trainer.to_device(batch)).backward()
        grads.append({n: q.grad for n, q in net32.named_parameters()})
        del net32, m32
    worst = ("", 0.0)
    for name, gk in grads[0].items():
        gp = grads[1][name]
        rel = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        worst = max(worst, (name, rel), key=lambda t: t[1])
        if gk.abs().max() == 0 or rel > 5e-3:
            raise AssertionError(f"gradient of {name}: max |kernel - plain| = {rel:.2e} "
                                 f"x max|plain| (bound 5e-3)")
    log(f"fp32 gradients, fused_ffn on vs off, {len(grads[0])} parameters: worst "
        f"{worst[1]:.2e} ({worst[0]}; bound 5e-3)")
    del grads
    torch.cuda.empty_cache()
    check_budget("fused_ffn training")

    # 29. times
    log("phase 29/29 times (CUDA events, after warm-up)")
    with torch.no_grad():
        ffn_ms = cuda_ms(lambda: tc.tconvffn(xb, p, G), iters=10)
        x32 = xb.float()
        ffn_ms_fp32 = cuda_ms(lambda: tc.tconvffn(x32, p, G), iters=5)
        del x32
        ffn_plain_ms = cuda_ms(lambda: tc.reference(xb, p, G), iters=3, warmup=1)
        bf = torch.bfloat16
        w = {k: v.to(bf) for k, v in p.items()}

        def library():  # one PyTorch composition of the same function; the port never calls it
            z = F.silu(F.linear(F.layer_norm(xb, (H,), w["ln_scale"], w["ln_bias"]), w["w_up"],
                                w["b_up"])).transpose(1, 2)
            z = F.silu(F.conv1d(z, w["w_c1"], w["b_c1"], padding=1, groups=G))
            z = F.conv1d(z, w["w_c2"], w["b_c2"], padding=1, groups=G)
            z = F.silu(F.group_norm(z, G, w["gn_scale"], w["gn_bias"]))
            z = F.silu(F.conv1d(z, w["w_c3"], w["b_c3"], padding=1, groups=G))
            return F.linear(z.transpose(1, 2), w["w_down"], w["b_down"])

        ffn_library_ms = cuda_ms(library, iters=10)
    ffn_bytes = 2 * xb.numel() * xb.element_size() + sum(v.numel() * 2 for v in p.values())
    ffn_ops = 2 * M * T * (2 * H * FF + 3 * 3 * FF * (FF // G))  # up, down, three grouped convs
    ffn_bound, ffn_by = bound(ffn_bytes, ffn_ops)
    log(f"tconvffn bf16 M={M}: kernel {ffn_ms:.3f} ms (fp32 {ffn_ms_fp32:.3f} ms), plain "
        f"{ffn_plain_ms:.3f} ms, library (layer_norm + linear + grouped conv1d x3 + group_norm "
        f"+ linear) {ffn_library_ms:.3f} ms, bound {ffn_bound:.4f} ms ({ffn_by}: "
        f"{ffn_bytes / 1e6:.0f} MB, {ffn_ops / 1e9:.1f} GFLOP grouped)")
    del xb

    net_off = SpatialNet(**FLAGSHIP, dtype=torch.bfloat16, device=dev).eval()
    net_off.load_state_dict(net.state_dict())
    module_off = TrainModule(**{**module.__dict__, "arch": net_off})

    def step_ms(fn, reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / reps * 1e3

    serve = {True: [], False: []}
    for mod in (module, module_off):
        mod.predict_step(wave)  # warm-up
    for on in (True, False, False, True):  # in turns
        serve[on].append(step_ms(lambda: (module if on else module_off).predict_step(wave), 3))
    serve_ms = {k: float(np.mean(v)) for k, v in serve.items()}
    log(f"serving: predict_step on {B} x {SECONDS:g} s, fused_ffn on {serve_ms[True]:.1f} ms = "
        f"{B * SECONDS / serve_ms[True] * 1e3:.1f} audio-s/s, off {serve_ms[False]:.1f} ms = "
        f"{B * SECONDS / serve_ms[False] * 1e3:.1f} audio-s/s")
    del module_off, net_off
    trainer_off = trainer_for(False, [])
    train = {True: [], False: []}
    for t in (trainer, trainer_off):
        t.train_step(batch)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    for on in (True, False, False, True):
        train[on].append(step_ms(lambda: (trainer if on else trainer_off).train_step(batch), 3))
    train_ms = {k: float(np.mean(v)) for k, v in train.items()}
    log(f"training: train_step on {B_TRAIN} x {SECONDS:g} s, fused_ffn on {train_ms[True]:.1f} "
        f"ms = {B_TRAIN * SECONDS / train_ms[True] * 1e3:.1f} audio-s/s, off "
        f"{train_ms[False]:.1f} ms = {B_TRAIN * SECONDS / train_ms[False] * 1e3:.1f} audio-s/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check_budget("fused_ffn times")
    return {"name": "tconvffn", "route": "cuda", "source": "nbss_tpu_torch/csrc/tconvffn.cu",
            "replaces": "nbss_tpu/ops/tconvffn.py:148", "launches": served[0],
            "launches_training": fit[0], "max_abs_err": ffn_err32, "max_err_bf16": ffn_errbf,
            "ms": ffn_ms, "ms_fp32": ffn_ms_fp32, "plain_ms": ffn_plain_ms,
            "bound_ms": ffn_bound, "bound_by": ffn_by, "library_ms": ffn_library_ms,
            "serve_sdr_db_fp32": ffn_sdr,
            "serve_step_ms": {"fused_ffn": serve_ms[True], "plain_ffn": serve_ms[False]},
            "train_step_ms": {"fused_ffn": train_ms[True], "plain_ffn": train_ms[False]}}


if __name__ == "__main__":
    sys.exit(main())
