#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --corpus-rates

Drives ``nbss_tpu_torch`` only (no JAX, nothing of ``nbss_tpu``) through its
serving path and its training path at the full width of SpatialNet-small
(8 layers, H=96, 4 heads, F=129; 6 channels x 4 s at 8 kHz, bf16, seeded
random weights): serving B=16 requests, then training at B=8; then the same
for OnlineSpatialNet ``mamba(16,4)`` (the committed streaming run: 8 layers,
H=96, online utterance norm, neg-SNR with PIT), which also streams, and for
OnlineSpatialNet ``mhsa(251)`` (the same widths with masked attention, 4
heads, and the causal T-ConvFFN); then NBC serving at the full width of
``configs/NBC.yaml``; then SpatialNet-small again with ``fused_ffn=True``,
whose T-ConvFFN runs through its kernel; then NBC2-small (``configs/NBC2.yaml``)
through the attention-block kernels at two heads, NB-BLSTM, the NBSS
wrapper, and NBC training; then SpatialNet-large (12 layers, H=192, 4
heads), whole 16-s recordings and NBC2-large through the attention block's
wide route; then the selective scan at state sizes above 16 and
OnlineSpatialNet as ``configs/onlineSpatialNet.yaml`` builds it: mamba(64,4),
mamba(16,4) with ``remat_policy='dots'``, and the retention branch
``ret(2,share_qk)``; then the two committed training runs as users launch
them: rooms rendered by ``python -m nbss_tpu_torch.sim.generate``, mixtures
made on the card by ``data/device_mix.py``, and ``fit``/``validate``/
``test``/``predict`` through ``nbss_tpu_torch.cli`` with the configs in
configs/; then the public corpora, from fixtures written in their layouts,
through the host loaders with threaded prefetch and the command line; then
data-parallel training (``nbss_tpu_torch.parallel``), the command line on
every card with the FLOP counter, and the oracle MVDR beamformer; then the
JAX package's two committed epoch-39 models, converted into the port's
checkpoints under checkpoints_torch/, against that package's outputs on the
same mixtures (checkpoints_torch/epoch39_golden.npz) and through ``cli
test``. Sixty-two phases:

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
    version, two launches bit-identical; and at ragged shapes (T = 1, T off
    the 8-frame chunk and the 32-frame span, D off the 64-channel block,
    rows off 16 bytes, N = 4, 8 and 16), forward and backward in fp32, the
    forward in bf16 under the same rule with a bit-identical relaunch;
11. scan backward kernel vs ``ssm.reference_bwd`` at the training shape
    (M = 8*129): each cotangent within atol 5e-3 x max|plain|, rtol 5e-3 in
    fp32, and within the bf16 rule of phase 6; a second launch bit-identical;
12. OnlineSpatialNet serving: ``forward`` and ``predict_step`` at B=16 in
    bf16, 16 scan launches per forward and no backward launch; fp32 kernel
    path vs the plain scan, SI-SDR >= 50 dB;
13. streaming: ``forward_streaming`` (one frame at a time) vs ``forward`` at
    B=4 on the first 2 s of the items: fp32 SI-SDR >= 50 dB, the bf16 figure
    printed;
14. training: ``Trainer`` fits 8 SyntheticDataset items for 8 steps at B=8
    (AdamW 1e-3, weight decay 1e-3, clip 5, bf16, remat): finite losses, the
    last 5 below the first 5, 32 forward (16 + 16 recomputed) and 16
    backward scan launches a step; fp32 gradients of every parameter, kernel
    path vs plain, within 5e-3 x max|plain|;
15. times: both scan kernels, their plain versions and bounds (and the
    forward's floor from its exponentials on the special-function unit);
    serving, streaming and training rates;
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
20. training: 8 steps at B=8 (AdamW 1e-3, weight decay 1e-3, clip 5, bf16,
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
26. the T-ConvFFN kernels vs ``tconvffn.reference`` at the serving shape
    (M = 16*129, T = 251, H = 96, FF = 192, 8 groups): fp32 on the CUDA-core
    kernel at atol 2e-4, rtol 1e-4, a second launch bit-identical; bf16 on
    the tensor-core kernel (``tconvffn_tc.cu``) under the rule of phase 3,
    two launches bit-identical, and so at the edges of its 16-frame tiles
    and 64-frame steps (T = 1, 2, 15, 16, 17, 63, 64, 65, 251, 256, 300, M =
    1); ragged shapes (T = 1, 2, 13; M = 1) in fp32; SpatialNet-large's
    widths (H = 192, FF = 384) in fp32 and bf16; the fp32 gradient through
    its Function against the plain path's at M = 2*129, x and every
    parameter within 5e-3 x max|plain|;
27. SpatialNet-small ``fused_ffn=True`` serving: ``forward`` and
    ``predict_step`` at B=16 in bf16, 8 T-ConvFFN and 8 attention-block
    launches per forward, all on the tensor-core kernels, and no backward
    launch; fp32 kernel path vs the plain module composition, SI-SDR >= 50
    dB;
28. training: ``Trainer`` fits 8 SyntheticDataset items for 8 steps at B=8
    (Adam 1e-3, clip 5, bf16): 8 T-ConvFFN (all on the tensor-core kernel),
    8 attention-block and 8 attention-block backward launches a step, every
    loss finite, the last 5 below the first 5; fp32 gradients of every
    parameter with ``fused_ffn`` on vs off (the T-ConvFFN composition; the
    attention block through its kernels in both, as phase 8 holds that
    path), within 5e-3 x max|plain|;
29. times: the T-ConvFFN kernels (bf16 on the tensor cores, fp32 on the
    CUDA cores), the bf16 operand layout, its plain version, a PyTorch
    library composition of the same function and its bound; serving and
    training rates with ``fused_ffn`` on and off, in turns;
30. the attention-block kernels at NBC2-small's shape (nh = 2, heads of 48;
    the forward at M = 16*129, the backward at M = 8*129, T = 251, H = 96):
    fp32 on the CUDA-core kernels (forward at atol 2e-4, rtol 1e-4; each
    cotangent within 5e-3 x max|plain|, rtol 5e-3), bf16 on the tensor-core
    kernels under the bf16 rule of phases 3 and 6 with bit-identical
    relaunches, also at T = 1, 17, 65, 256; times of both, their plain
    versions, the library composition (LN + linear + SDPA at two heads +
    linear + residual) and its backward, and bounds;
31. the narrow-band attention kernels at NBC2's heads (nh = 2, dh = dv = 48;
    M = 2*129, no mask and a causal one), which an NBC2 whose first norm is
    not LN runs: forward and backward under the bounds of phase 30, fp32 and
    bf16, relaunches bit-identical; times at M = 16*129 (forward) and 8*129
    (backward) against SDPA and its backward, and bounds;
32. NBC2-small serving (``configs/NBC2.yaml``: 8 layers, H=96, ffn 192, 2
    heads, LN/GBN/GBN; 6 ch x 4 s at 8 kHz, frequency norm, neg-SA-SDR with
    PIT): ``forward`` and ``predict_step`` at B=16 in bf16, 8 attention-block
    launches a forward, all on the tensor-core kernel, and no other kernel;
    fp32 kernel path vs the plain module composition, SI-SDR >= 50 dB; and
    with GBN first norms at B=2 through rows 4-5 (8 launches), >= 50 dB;
33. training: ``Trainer`` fits 8 SyntheticDataset items for 8 steps at B=8
    (Adam 1e-3, clip 5, bf16): falling loss, 8 + 8 attention-block launches
    a step, all on the tensor-core kernels; the fp32 kernel path's gradients
    held by ``check_gradients.hold`` against the plain composition in fp32
    and float64;
34. NBC2-small's serving and training rates;
35. NB-BLSTM serving (``configs/NB-BLSTM.yaml``: BLSTM 256, 128; 6 ch x 4 s
    at 8 kHz): ``forward`` and ``predict_step`` at B=16 in bf16 and fp32,
    finite, no kernel of the port (its LSTMs are cuDNN's; the first BLSTM's
    time in bf16 and fp32); the serving rates;
36. training: 8 steps at B=8 (Adam 1e-3, clip 5, bf16), falling loss; the
    training rate;
37. the NBSS wrapper (STFT 512/256, 8 ch x 4 s at 16 kHz, B=2): one forward
    for NB_BLSTM, NBC and NBC2 in fp32 and bf16, finite [2, 2, T], with NBC's
    4 relative-position and NBC2's 8 attention-block launches;
38. NBC training (``configs/NBC.yaml``, dropout 0.1; 2 of its 4 layers) for 8
    steps at B=6 (M = 8*257, T = 248; Adam 1e-3, clip 5, bf16): falling loss, no kernel
    launch (the block and the fused attention are off while dropout is
    active, as in the JAX package), the peak device memory and the rate;
39. the same at dropout 0: 4 relative-position launches a step, all on the
    tensor-core kernel (the gradient is autograd's of the plain version, as
    the JAX package's); the fp32 kernel path's gradients held by
    ``check_gradients.hold`` (the key biases left out: the fold drops them);
    the peak device memory and the rate;
40. the attention block's wide route (``attention_block_wide_tc.cu`` in bf16,
    Hopper's ``wgmma``; ``attention_block_wide.cu`` in fp32) vs ``reference``
    / ``reference_bwd`` at SpatialNet-large's shape (H=192, nh=4; the forward
    at M = 16*129, the backward at 8*129, T=251), at M = 3 with the edge
    lengths ``WIDE_EDGES`` (either side of the 32-row stages, 64-row tiles
    and 128-row blocks, and 1001) for H = 96 and 192 at nh 4, 3 and 2, and
    at (M, T) = (4*129, 1001): fp32 at the bounds of phases 3 and 6, bf16
    under the bf16 rule, every relaunch bit-identical, the wide counters
    advancing by the launches; times of both directions against their plain
    versions, the library composition and bounds, also at T = 1001 (H 192,
    and SpatialNet-small's H 96) and at nh 2; row 3's time, library call and
    bound at SpatialNet-large's widths (192, 384);
41. SpatialNet-large serving (``configs/SpatialNet.yaml`` comments: 12
    layers, H=192, ffn 384, 4 heads, squeeze 16) at B=16 in bf16 with
    ``fused_ffn`` off and on: 12 wide launches a forward, all on the
    tensor cores, and 12 T-ConvFFN launches with it on; fp32 kernel path vs
    the plain composition at B=2, SI-SDR >= 50 dB; serving rates;
42. whole recordings: SpatialNet-small and -large at B=4 x 16 s (T = 1001)
    through the wide route, fp32 vs plain at B=1 >= 50 dB, serving rates;
43. SpatialNet-large training: 8 steps at B=8 (Adam 1e-3, clip 5, bf16),
    falling loss, 12 + 12 wide tensor-core launches a step, the peak
    memory and the rate; fp32 gradients of its first 2 layers at the
    trained weights held by ``check_gradients.hold``; 3 steps at dropout
    (0.1, 0.1, 0.1), where the block is off and rows 4-5 run at dh 48;
44. NBC2-large (12 layers, H=192, 2 heads): serving at B=16 through the wide
    route, fp32 vs plain at B=2 >= 50 dB, and 5 training steps at B=8;
45. rows 6-7 at N = 17, 32, 64 and 128 (passes over groups of 16 states),
    the forward at the serving shape (M = 16*129) and the backward at the
    training shape (M = 8*129), T = 251, D = 192: fp32 and bf16 under the
    rules of phases 10-11, every relaunch bit-identical, one counted launch
    a call;
46. their times at N = 32 and 64 and again at N = 16 (the single pass,
    beside phase 15's reading), against their plain versions and bounds
    (the larger of the bytes and the exponentials' floor at 16 an SM a
    clock);
47. OnlineSpatialNet mamba(64,4): serving at B=16 through ``predict_step``
    (16 scan launches a forward) and 5 training steps at B=8 with remat
    (``dots``; 32 + 16 launches a step), rates and peak memory;
48. mamba(16,4) with ``remat_policy='dots'`` (the config as written, 4 of its 8
    layers): an
    8-step fit (falling loss, 32 + 16 launches a step: the recompute runs
    the scan again); fp32 gradients of ``dots`` held by
    ``check_gradients.hold`` against full recomputation and the plain scan
    in a float64 arch; the rate and peak memory of full recomputation and
    ``dots`` in turns;
49. OnlineSpatialNet ret(2,share_qk) (decays 4, 5, 9, 10; 4 of its 8 layers; no kernel of the
    port: the retention's products are plain PyTorch, as they are plain XLA
    in the JAX package): serving at B=16 in bf16, bf16 vs fp32 SI-SDR
    reported; ``forward_streaming`` at B=4 (2 s) against ``forward(inference=True)``
    with ``chunkwise_recurrent=False`` (fp32 >= 50 dB; against the chunkwise
    forward reported); an 8-step fit at B=8 with ``dots`` (falling loss);
    fp32 gradients of ``dots`` held by ``check_gradients.hold`` against
    ``remat=False`` and a float64 arch; serving, streaming and training
    rates and peak memory;
50. rooms: ``sim.generate``'s main on the card with the flags of
    scripts/run_spatialnet_convergence.sh (6 mics, 8 kHz, RT60 0.1-0.6,
    ``length_round`` 2048, seed 0) and ``--rir_nums 8 2 2``, seconds a room;
    room 0 rendered again on the CPU by the same code (within 1e-4 x
    max|rir|) and on the card (bit-identical); the direct path's delay and
    amplitude against d / c and 1 / (4 pi d);
51. mixtures: ``DeviceSyntheticDataModule`` at device_synth.yaml's settings
    over that corpus, preloaded: the first train batch (B=8) on the card
    against the same batch on the CPU (seeds, rooms, keys, segments and noise
    types equal; x and ys within atol 2e-5, rtol 1e-4), and mixtures/s;
52. ``fit`` through ``nbss_tpu_torch.cli.run`` with configs/SpatialNet.yaml +
    device_synth.yaml at full width in bf16-mixed, 2 epochs of 4 steps at B=8,
    host metrics STOI/eSTOI every epoch: 8 + 8 tensor-core attention-block
    launches a step (and 8 a validation forward), finite losses, the version
    directory's files and metrics.jsonl's host metrics; the training rate
    with mixing on the card beside phase 9's fixed-batch rate;
53. ``validate``, ``test`` (the config's metrics: SDR, SI-SDR, NB-PESQ,
    WB-PESQ, eSTOI; results_*.json, results_mean.json,
    results_incremental.jsonl, examples) and ``predict`` from the checkpoint
    ``fit`` wrote, and a resumed ``fit`` into the same version directory;
54. the moving run: ``sim.generate`` with the flags of
    scripts/run_moving_convergence.sh (``--trajectory=4points+sin,0.5``) and
    ``--rir_nums 2 1 1``, then ``fit`` with configs/onlineSpatialNet.yaml +
    device_synth_moving.yaml for 2 steps at full width (rows 6-7: 32 + 16
    scan launches a step under ``remat_policy='dots'``);
55. SMS-WSJ-Plus: a fixture corpus (sms_wsj.json, wsj_8k_zeromean/ with
    utterances of 3-10 s, 12 items a split; phase 50's rooms), the host
    loader's items/s at ``num_workers`` 0 and 2, ``fit`` with
    configs/SpatialNet.yaml + sms_wsj_plus.yaml at full width in bf16-mixed
    (6 steps at its B=2, its whole validation split: 8 + 8 tensor-core
    launches a step, 8 a validation forward), ``test`` on the 12 whole
    utterances at B=1 (8 launches each, on the wide route past 4 s), and the
    train rate fed by the loader at 2 workers beside one fixed batch
    (each rate over 24 items, after a first batch that starts the loader);
56. CHiME3-moving: single-speaker trajectory rooms from ``sim.generate``
    (5-cm points), wsj0 speakers and six 16-kHz background channels, ``fit``
    with configs/onlineSpatialNet.yaml + chime3_moving.yaml (3 steps at B=4,
    one validation batch of 8 x 32 s; rows 6-7: 32 + 16 a step, 16 a
    forward), ``test`` on one 32-s item;
57. the other corpora (SMS-WSJ, spatialized WSJ0-2mix with 8 channels,
    WHAMR!, LibriCSS, the 4-speaker WSJ0 pairs, REVERB train/val and ET):
    the first train and test batch of each through ``ThreadedLoader``, with
    the shapes their modules document; ``fit`` with configs/NBC2.yaml +
    spatialized_wsj0_mix.yaml for one step (rows 1-2 at two heads);
58. data parallel (``nbss_tpu_torch.profile_parallel``): SpatialNet-small at
    full width, bf16, a global B=8 split into contiguous rows over NCCL ranks
    on min(cards, 4) cards, or, on one card, 2 ranks over gloo sharing it:
    one float32 step's all-reduced gradient (rank 0's) held against one
    process's float64 and plain float32 gradients on the global batch by
    ``check_gradients.hold``; a 10-step fit with each rank's rows-1-2
    counters at 8 + 8 tensor-core launches a step, the parameters' crc32
    equal on every rank and the loss falling; the training rate over 6 more
    steps, after two warm-up steps; and that rate in a 1-rank NCCL group;
59. ``cli fit`` with configs/SpatialNet.yaml + device_synth.yaml and
    ``--trainer.devices`` the card count (1 on a one-card machine), 3 steps
    and one validation batch, ``--trainer.write_flops=true`` (FLOPs.yaml:
    the JAX package's keys, ``params`` the model's count), then ``cli test``
    from its checkpoint on 2 items;
60. ``eval.beamformer.mvdr`` with the oracle noise on the 8 mixtures of a
    first train batch made on the card by ``data/device_mix.py`` (phase 50's
    rooms): SI-SDR against speaker 0's direct path at channel 0 improves by
    more than 3 dB on average;
61. the trained SpatialNet-small: checkpoints_torch/SpatialNet/version_0's
    epoch 39 restored by the port's ``CheckpointManager`` (no optimizer
    state), ``TrainModule.forward`` on the golden fixture's two test
    mixtures (6 ch x 4 s, rooms test/440-441 as the JAX package regenerates
    them) in float32 with TF32 off and in bf16, rows 1's counters reset just
    before each forward and read just after (8 launches a forward; bf16 all
    on the tensor-core kernel, float32 none): float32 against the JAX
    package's float32 outputs at SI-SDR >= 60 dB for each item and speaker,
    each item's SI-SDR and SI-SDRi (after PIT, the mean over speakers)
    within 0.05 dB of the JAX package's; bf16 no farther from the JAX
    float32 outputs, as an L2 norm, than twice the JAX bf16 outputs are;
    and ``python -m nbss_tpu_torch.cli test`` in a subprocess from a
    temporary copy of the converted run over phase 50's test rooms (4
    items; both phases' subprocesses start when phase 61 begins and run
    beside its checks): mean SI-SDRi >= 5 dB, printed beside the committed
    test set's 11.89 dB;
62. the trained OnlineSpatialNet ``mamba(16,4)``: the same for
    ``forward`` (row 6: 16 scan launches a forward, in float32 and in bf16)
    and for ``forward_streaming`` (one frame at a time through ``ssm.step``:
    no scan launch), each against its own JAX outputs; the stream against
    the offline output printed beside streaming_eval_epoch39.json's 34.07
    dB; and ``cli test`` over phase 54's moving test room (4 items), mean
    SI-SDRi >= 5 dB beside the committed test set's 12.40 dB.

Prints one ``kernels`` JSON line, one ``training_runs`` JSON line (phases
50-54's seconds a room, mixtures/s and training rate), one ``corpus_runs``
JSON line (phases 55-57's loader and training rates), one ``parallel_runs``
JSON line (phases 58-60: the data-parallel rates at 1 and n ranks, FLOPs.yaml,
the MVDR gains), one ``trained_models`` JSON line (phases 61-62: dB against
the golden outputs, the bf16 ratios, SI-SDRi, seconds), the card's
``nvidia-smi`` name and power limit, and as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero, without that line, when there is no CUDA
card or any phase fails.

``--corpus-rates`` runs phase 55's rates alone and longer: the kernels
built, phase 50's rooms and phase 55's fixture, then the loader at 0, 2 and
4 workers and the train step fed by it and on a fixed batch over 288 items
each, and the card's busy share under ``torch.profiler`` over 16 more; it
prints a ``corpus_rates`` JSON line and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.monotonic()
BUDGET_S = 600.0  # every phase together: half of the 1200 s a run may take

# H100 SXM published peaks (dense): HBM rate and bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores

B, CHANNELS, SECONDS, FS = 16, 6, 4.0, 8000
B_TRAIN, TRAIN_STEPS = 8, 8  # fits on a fixed batch; 20 until phases 50-54 and 10 until
# phases 58-60 needed the time (phase 7 keeps check_gradients.fit's 20 steps, phase 58 its
# own 10); every loss falls within 8
FLAGSHIP = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                num_freqs=129, full_share=0)
# the committed streaming run, logs/OnlineSpatialNet/version_0/config.yaml
ONLINE = dict(FLAGSHIP, attention="mamba(16,4)")
# its masked-attention alternative, the class's default (configs/onlineSpatialNet.yaml:31)
MHSA = dict(FLAGSHIP, attention="mhsa(251)")
B_STREAM = 4
# mamba and retention stream the first STREAM_SECONDS of each item (their state does not grow
# with time; mhsa(251) streams all 4 s, so its 250-frame KV ring buffer fills); 4 s until
# phases 58-60 needed the time
STREAM_SECONDS = 2.0
# configs/NBC.yaml: 4 layers, H=192, 8 heads, ffn 384, encoder k=4 (valid), 3 grouped k=3
# convs of 8 groups with GroupNorm; 8 channels, STFT 512/256, 4 s at 16 kHz (the rate the
# JAX module infers for n_fft 512)
NBC_CFG = dict(dim_input=16, dim_output=4, n_layers=4, encoder_kernel_size=4, n_heads=8,
               hidden_size=192, ffn_size=384, inner_conv_kernel_size=3, inner_conv_groups=8,
               inner_conv_layers=3, dropout=0.1)
NBC_CHANNELS, NBC_FS, NBC_NFFT = 8, 16000, 512
NBC_B_CHECK = 4  # batch of the fp32 kernel-vs-plain comparison (the plain attention's [M, nh, T, T])
# NBC's training batches: M = B*257 sequences of T = 248 frames in the blocks. At dropout 0.1
# every layer keeps [M, 8, 248, 248] float32 scores for the backward: B = 8 and B = 7 ran out
# of the card's 80 GB, B = 6 peaks near 70 GiB. At dropout 0 B = 8 fits.
NBC_B_TRAIN = {0.1: 6, 0.0: 8}
NBC_TRAIN_LAYERS = 2  # phases 38-39 train 2 of NBC's 4 layers (4 until phases 58-60)
# configs/NBC2.yaml, NBC2-small: 8 layers, H=96, ffn 192, 2 heads, k=5 encoder, 8 conv groups,
# norms LN/GBN/GBN; 6 channels, STFT 256/128 at 8 kHz, frequency norm, neg-SA-SDR with PIT
NBC2_CFG = dict(dim_input=12, dim_output=4, n_layers=8, encoder_kernel_size=5, dim_hidden=96,
                dim_ffn=192, num_freqs=129, n_heads=2, conv_kernel_size=3, n_conv_groups=8,
                norms=("LN", "GBN", "GBN"))
# configs/NB-BLSTM.yaml: BLSTM 256 then 128; 6 channels at 8 kHz, neg-SI-SDR with PIT
BLSTM_CFG = dict(dim_input=12, dim_output=4, hidden_size=(256, 128))
# SpatialNet-large (configs/SpatialNet.yaml comments): 12 layers, H 192, ffn 384, 4 heads (dh
# 48), squeeze 16; the rest as SpatialNet-small
LARGE = dict(FLAGSHIP, num_layers=12, dim_hidden=192, dim_ffn=384, dim_squeeze=16)
LARGE_DEPTH_CHECK = 2  # layers of its fp32 gradient check (check_gradients.hold)
B_LARGE_CHECK = 2  # batch of its fp32 kernel-vs-plain serving comparison
DROPOUT_STEPS = 3  # training steps of the run at dropout 0.1 (the block off, rows 4-5 on)
LONG_SECONDS, B_LONG = 16.0, 4  # offline serving of whole recordings: T = 1001 frames
# phase 40's edge lengths of the wide route: either side of the bf16 kernels' 32-row stages,
# 64-row tiles and 128-row blocks of two warpgroups, and whole recordings; at H = 96 the
# wide route starts past 256 frames. M_EDGE sequences, a count no tile or block divides.
WIDE_EDGES = {192: (1, 31, 33, 63, 64, 65, 127, 128, 129, 191, 193, 255, 256, 257, 300, 1001),
              96: (1, 255, 257, 300, 319, 321, 383, 385, 1001)}
M_EDGE = 3
# NBC2-large (configs/NBC2.yaml comments): 12 layers, H 192, ffn 384, 2 heads (dh 96)
NBC2_LARGE_CFG = dict(NBC2_CFG, n_layers=12, dim_hidden=192, dim_ffn=384)
NBC2_LARGE_STEPS = 5
# rows 6-7 at state sizes above 16 (passes of 16 states; 17 pads its second group), the two
# timed beside N = 16, and OnlineSpatialNet at mamba(64,4) for WIDE_N_STEPS training steps
SCAN_N, SCAN_TIMED_N = (17, 32, 64, 128), (32, 64)
MAMBA_WIDE_N, WIDE_N_STEPS = 64, 5
# configs/onlineSpatialNet.yaml's retention alternative, its decays as YAML gives them
# phase 49 at 4 of its 8 layers, and phase 48's mamba(16,4) with remat_policy='dots' too
# (DOTS): cut in depth when phases 58-60 needed the time
RET = dict(FLAGSHIP, attention="ret(2,share_qk)", decay=[4, 5, 9, 10], num_layers=4)
DOTS = dict(ONLINE, num_layers=4)


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
    log("phase 1/62 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
        f"{torch.cuda.device_count()} card(s); nvidia-smi: {smi}")

    # 2. build
    log("phase 2/62 build (plain nvcc, sm_90a)")
    seconds = _build.build()
    _build.library()
    log(f"kernels built in {seconds:.1f} s: {_build.library_path().name}")
    check_budget("build")
    from nbss_tpu_torch.parallel.mesh import start_fork_server

    start_fork_server()  # phase 58's ranks fork from it; its imports run beside phases 3-57

    # 3. kernel vs plain at the path's shape
    n_freq = FLAGSHIP["num_freqs"]
    n_frames = int(SECONDS * FS) // 128 + 1
    M, T, H, nh = B * n_freq, n_frames, FLAGSHIP["dim_hidden"], FLAGSHIP["num_heads"]
    log(f"phase 3/62 attention_block vs plain at M={M} T={T} H={H} nh={nh}")
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
    log(f"phase 4/62 slice: TrainModule.forward + predict_step, B={B}, {CHANNELS} ch, "
        f"{SECONDS:g} s, bf16")
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    ab.launches = ab.tc_launches = ab.bwd_launches = ab.wide_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    launches, serve_tc, serve_bwd = ab.launches, ab.tc_launches, ab.bwd_launches
    n_layers = FLAGSHIP["num_layers"]
    if ab.wide_launches != 0:  # H = 96, T <= 256: the shared-memory kernel, not the wide route
        raise AssertionError(f"SpatialNet-small reached the wide route ({ab.wide_launches})")
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
    log("phase 5/62 times (CUDA events, after warm-up)")
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
    fresh_start()
    nbc2_row1, nbc2_row2, nbc2_row4, nbc2_row5 = nbc2_phases(dev)
    fresh_start()
    blstm_phases(dev)
    fresh_start()
    nbss_phase(dev)
    fresh_start()
    row8["training"] = nbc_training_phases(dev)
    fresh_start()
    row1_wide, row2_wide, row3["large"] = large_phases(dev)
    fresh_start()
    scan_n_phases(dev, rows67)
    fresh_start()
    rows67[0]["online_models"] = {**online_n_phases(dev), "ret_2_share_qk": retention_phase(dev)}
    fresh_start()
    with tempfile.TemporaryDirectory(prefix="nbss_chip_smoke_") as tmp:
        runs = training_runs(dev, row2["train_audio_s_per_s"], tmp)
        fresh_start()
        corpora = corpus_runs(dev, tmp, row2["train_audio_s_per_s"])
        fresh_start()
        dp = parallel_runs(dev, tmp)
        fresh_start()
        trained = trained_models(dev, tmp)
    row2["launches_cli_fit"] = runs["cli_fit_launches"][2]
    rows67[0]["launches_moving_fit"], rows67[1]["launches_moving_fit"] = runs["moving_fit_launches"]
    runs.pop("moving_fit_launches")
    sms_fit, sms_test = corpora.pop("sms_wsj_plus_fit_launches"), corpora.pop(
        "sms_wsj_plus_test_launches")
    nbc2_fit = corpora.pop("nbc2_fit_launches")
    row2.update(launches_sms_wsj_plus_fit=sms_fit[1], launches_nbc2_wsj0mix_fit=nbc2_fit[2])
    row1_wide["launches_sms_wsj_plus_test"] = sms_test[2]
    chime3 = corpora.pop("chime3_launches")
    rows67[0].update(launches_chime3_fit=chime3[0], launches_chime3_test=chime3[2])
    rows67[1]["launches_chime3_fit"] = chime3[1]
    rows45[0].update(wide4, **nbc2_row4)
    rows45[1].update(wide5, **nbc2_row5)
    row2.update(nbc2_row2)
    # rows 1-2 in one rank of phase 58's data-parallel fit (forward, tc, backward, tc)
    dp_launches = dp["dp"]["launches"][str(dp["dp"]["ranks"])]
    row2["launches_dp_fit_per_rank"] = dp_launches[3]
    # the committed models' paths, a forward each in float32 and bf16 (and a stream each)
    row1_trained = {f"launches_epoch39_{k.replace(' ', '_')}": v
                    for k, v in trained["spatialnet"]["launches"].items()}
    rows67[0].update({f"launches_epoch39_{k.replace(' ', '_')}": v
                      for k, v in trained["online"]["launches"].items()})

    print(json.dumps({"kernels": [{
        "name": "attention_block", "route": "cuda",
        "source": "nbss_tpu_torch/csrc/attention_block_tc.cu",
        "source_fp32": "nbss_tpu_torch/csrc/attention_block.cu",
        "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
        "replaces": "nbss_tpu/ops/attention_block.py:183",
        "launches": launches, "tc_launches": serve_tc, "launches_training": train_launches,
        "max_abs_err": err32, "max_err_fp32": err32, "max_err_bf16": errbf, "ms": ms,
        "ms_fp32": ms_fp32, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "launches_cli_fit": runs.pop("cli_fit_launches")[0],
        "launches_sms_wsj_plus_fit": sms_fit[0],
        "launches_sms_wsj_plus_test": sms_test[0] - sms_test[2],
        "launches_nbc2_wsj0mix_fit": nbc2_fit[0], "launches_dp_fit_per_rank": dp_launches[1],
        **row1_trained, **nbc2_row1},
        row2, row1_wide, row2_wide, row3, *rows67, *rows45, row8]}), flush=True)
    print(json.dumps({"training_runs": runs, "device": smi}), flush=True)
    print(json.dumps({"corpus_runs": corpora, "device": smi}), flush=True)
    print(json.dumps({"parallel_runs": dp, "device": smi}), flush=True)
    print(json.dumps({"trained_models": trained, "device": smi}), flush=True)
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
    log(f"phase 6/62 attention_block backward vs plain at M={M} T={T} H={H} nh={nh}")
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
    log(f"phase 7/62 training: Trainer fits {B_TRAIN} SyntheticDataset items "
        f"({CHANNELS} ch x {SECONDS:g} s) for {check_gradients.STEPS} steps, bf16")
    ab.launches = ab.tc_launches = ab.bwd_launches = ab.bwd_tc_launches = 0
    ab.wide_launches = ab.bwd_wide_launches = 0
    module, trainer, batch, losses = check_gradients.fit(dev)  # data and init launch nothing
    torch.cuda.synchronize()
    fit = (ab.launches, ab.tc_launches, ab.bwd_launches, ab.bwd_tc_launches)
    if ab.wide_launches or ab.bwd_wide_launches:  # H = 96, T <= 256: not the wide route
        raise AssertionError(f"SpatialNet-small training reached the wide route "
                             f"({ab.wide_launches} + {ab.bwd_wide_launches})")
    ab.launches = ab.tc_launches = ab.bwd_launches = ab.bwd_tc_launches = 0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step = (ab.launches, ab.tc_launches, ab.bwd_launches, ab.bwd_tc_launches)
    fit_fwd, fit_bwd, fit_tc = fit[0], fit[2], fit[3]
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    log(f"launches: fit {fit[0]} forward ({fit[1]} on the tensor-core kernel) + {fit[2]} "
        f"backward ({fit[3]} on the tensor-core kernel) in {check_gradients.STEPS} steps; "
        f"one step {step[0]} ({step[1]}) + {step[2]} ({step[3]})")
    if fit != (check_gradients.STEPS * n_layers,) * 4 or step != (n_layers,) * 4:
        raise AssertionError(f"expected {n_layers} forward and {n_layers} backward launches "
                             "a step, every one on the tensor-core kernels")
    if len(losses) != check_gradients.STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"mean loss of the first 5 steps {first:.3f}, of the last 5 {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    check_budget("training")

    # 8. gradient parity, fp32: the kernel path against the plain composition with its arch
    # in float64, by check_gradients.hold's rule (the fp32 counterpart of the bf16 rule)
    log("phase 8/62 gradients: kernel path (fp32) vs plain composition (fp32 and float64 arch), "
        "one batch")
    grads = check_gradients.gradients(module, trainer.to_device(batch), FLAGSHIP, dev)
    log(check_gradients.hold(grads))
    del grads
    torch.cuda.empty_cache()
    check_budget("gradients")

    # 9. times
    log("phase 9/62 times (CUDA events, after warm-up)")
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
    log(f"phase 10/62 selective_scan vs plain at M={M_serve} T={T} D={Dm} N={N}")
    ins32, _ = scan_inputs(gen, M_serve, T, Dm, N, torch.float32, dev)
    fwd_err32 = fwd_check(ins32, "fp32")
    log(f"fp32: max |kernel - plain| = {fwd_err32:.3e} (atol 2e-4, rtol 1e-4): ok")
    insb = [t.to(torch.bfloat16) if i in (0, 3, 4) else t for i, t in enumerate(ins32)]
    del ins32
    want = ssm.reference(*[t.float() for t in insb])
    fwd_errbf = (ssm.selective_scan(*insb).float() - want).abs().max().item()
    plainbf = (ssm.reference(*insb).float() - want).abs().max().item()
    del want
    relaunched("bf16 scan", [ssm.selective_scan(*insb)], [ssm.selective_scan(*insb)])
    log(f"bf16: max |kernel - fp32 plain| = {fwd_errbf:.4f}, plain bf16 version's = "
        f"{plainbf:.4f} (bound: 2x the plain version's); two launches bit-identical")
    if not fwd_errbf <= 2 * plainbf:
        raise AssertionError(f"bf16 scan error {fwd_errbf} exceeds 2 x {plainbf}")
    # T = 1, T off the 8-frame chunk and the 32-frame span, D off the 64-channel block,
    # rows off 16 bytes (D = 100, 33; N = 4: the plain-load staging), N = 4, 8 and 16
    for shape in ((1, 1, Dm, N), (7, 13, 100, N), (3, 9, 33, 4), (5, 33, Dm, N),
                  (2, 300, 40, 8), (3, 17, Dm, 4)):
        ins, gy = scan_inputs(gen, *shape, torch.float32, dev)
        e = fwd_check(ins, f"ragged {shape}")
        _, _, be = bwd_check(ins, gy, f"ragged {shape}")
        insb_r = [t.to(torch.bfloat16) if i in (0, 3, 4) else t for i, t in enumerate(ins)]
        yb = ssm.selective_scan(*insb_r)
        relaunched(f"bf16 scan {shape}", [yb], [ssm.selective_scan(*insb_r)])
        want = ssm.reference(*[t.float() for t in insb_r])
        eb = (yb.float() - want).abs().max().item()
        ebp = (ssm.reference(*insb_r).float() - want).abs().max().item()
        if not eb <= max(2 * ebp, 2e-4 + 1e-4 * want.abs().max().item()):
            raise AssertionError(f"bf16 scan {shape}: error {eb} exceeds 2 x {ebp}")
        log(f"ragged (M, T, D, N) = {shape}: forward {e:.2e}, backward worst {max(be):.2e}; "
            f"bf16 {eb:.4f} (plain {ebp:.4f}), relaunch bit-identical: ok")
    check_budget("scan vs plain")

    # 11. backward kernel vs plain
    log(f"phase 11/62 selective_scan backward vs plain at M={M_train} T={T} D={Dm} N={N}")
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
    log(f"phase 12/62 OnlineSpatialNet {ONLINE['attention']} serving: TrainModule.forward + "
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
    log(f"phase 13/62 streaming: forward_streaming vs forward, B={B_STREAM} x "
        f"{STREAM_SECONDS:g} s")
    wave_s = wave[:B_STREAM, :, :int(STREAM_SECONDS * FS)].contiguous()
    n_frames = wave_s.shape[-1] // 128 + 1
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
        stream[label] = (si_sdr(y_str, y_off).min().item(),
                         B_STREAM * STREAM_SECONDS / seconds)
        log(f"{label}: streaming vs offline min SI-SDR {stream[label][0]:.1f} dB; "
            f"{n_frames} frames in {seconds:.2f} s = {stream[label][1]:.2f} audio-s/s")
    if not stream["fp32"][0] >= 50.0:
        raise AssertionError(f"fp32 streaming vs offline SI-SDR {stream['fp32'][0]:.1f} dB < 50")
    del net32, module32
    check_budget("streaming")

    # 14. training
    log(f"phase 14/62 training: Trainer fits {B_TRAIN} SyntheticDataset items for "
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
    log(f"launches: fit {fit_fwd} forward + {fit_bwd} backward in {TRAIN_STEPS} steps; one step "
        f"{step_fwd} + {step_bwd} (forward {2 * n_layers} + {2 * n_layers} recomputed by remat, "
        f"backward {2 * n_layers}); peak memory {peak:.1f} GiB")
    want = (4 * n_layers, 2 * n_layers)
    if (step_fwd, step_bwd) != want or (fit_fwd, fit_bwd) != tuple(TRAIN_STEPS * w for w in want):
        raise AssertionError(f"expected {want[0]} forward and {want[1]} backward launches a step")
    check_losses(losses)
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
    log("phase 15/62 times (CUDA events, after warm-up)")
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
    # every state update forms exp(dt A) on the special-function unit: 16 an SM a clock
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.split()[0])
    exp_floor_ms = elems / (16 * sms * mhz * 1e6) * 1e3
    log(f"selective_scan bf16 M={M_serve}: kernel {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms, "
        f"library none, bound {fwd_bound:.4f} ms ({fwd_by}: {fwd_bytes / 1e6:.0f} MB, "
        f"{fwd_ops / 1e9:.1f} GFLOP fp32); {elems / 1e9:.2f} G exps, {exp_floor_ms:.4f} ms at "
        f"16 an SM a clock on {sms} SMs at {mhz:.0f} MHz; with saved states at M={M_train}: "
        f"{fwd_train_ms:.3f} ms")
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
    log(f"phase 16/62 narrowband_attention vs plain at M={M_serve} T={T} nh={nh} dh={dh}")
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
    log(f"phase 17/62 narrowband_attention backward vs plain at M={M_train} T={T}, causal mask")
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
    log(f"phase 18/62 OnlineSpatialNet {MHSA['attention']} serving: TrainModule.forward + "
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
    log(f"phase 19/62 streaming: forward_streaming vs forward, B={B_STREAM} x {SECONDS:g} s, "
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
    log(f"phase 20/62 training: Trainer fits {B_TRAIN} SyntheticDataset items for "
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
    log(f"launches: fit {fit_fwd} forward ({fit_tc} tensor-core) + {fit_bwd} backward "
        f"({fit_btc} tensor-core) in {TRAIN_STEPS} steps; one step {step_fwd} ({step_tc}) + "
        f"{step_bwd} ({step_btc}) (forward {n_layers} + {n_layers} recomputed by remat, "
        f"backward {n_layers}); peak memory {peak:.1f} GiB")
    want = (2 * n_layers, 2 * n_layers, n_layers, n_layers)
    if ((step_fwd, step_tc, step_bwd, step_btc) != want
            or (fit_fwd, fit_tc, fit_bwd, fit_btc) != tuple(TRAIN_STEPS * w for w in want)):
        raise AssertionError(f"expected {want[0]} forward and {want[2]} backward launches a "
                             "step, all on the tensor-core kernels")
    check_losses(losses)
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
    log("phase 21/62 times (CUDA events, after warm-up), causal mask")
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
    log(f"phase 22/62 attention_block_relpos vs plain at M={M} T={T} H={H} nh={nh}")
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
    log(f"phase 23/62 narrowband_attention at NBC's widths: M={Ma} T={T} nh={nh} dh={dhp} dv={dv}")
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
    log(f"phase 24/62 NBC serving: TrainModule.forward + predict_step, B={B}, {NBC_CHANNELS} ch, "
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
    log("phase 25/62 times (CUDA events, after warm-up)")
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
    # drawn on the card: two of these are 1.8 G elements, which the CPU takes half a minute to draw
    gen_dev = torch.Generator(device=dev).manual_seed(25)
    qf, kf, vf = (torch.randn(M, T, nh * d, generator=gen_dev, device=dev).to(torch.bfloat16)
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


def tconvffn_times(xb, p, G):
    """CUDA-event times of row 3's bf16 kernel on xb, its plain version and
    one PyTorch composition of the same function (the port never calls it),
    with the bound of the grouped work."""
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch.ops import tconvffn as tc

    M, T, H = xb.shape
    FF = p["w_up"].shape[0]
    with torch.no_grad():
        ms = cuda_ms(lambda: tc.tconvffn(xb, p, G), iters=10)
        plain_ms = cuda_ms(lambda: tc.reference(xb, p, G), iters=3, warmup=1)
        w = {k: v.to(torch.bfloat16) for k, v in p.items()}

        def library():
            z = F.silu(F.linear(F.layer_norm(xb, (H,), w["ln_scale"], w["ln_bias"]), w["w_up"],
                                w["b_up"])).transpose(1, 2)
            z = F.silu(F.conv1d(z, w["w_c1"], w["b_c1"], padding=1, groups=G))
            z = F.conv1d(z, w["w_c2"], w["b_c2"], padding=1, groups=G)
            z = F.silu(F.group_norm(z, G, w["gn_scale"], w["gn_bias"]))
            z = F.silu(F.conv1d(z, w["w_c3"], w["b_c3"], padding=1, groups=G))
            return F.linear(z.transpose(1, 2), w["w_down"], w["b_down"])

        library_ms = cuda_ms(library, iters=10)
    io_bytes = 2 * xb.numel() * xb.element_size() + sum(v.numel() * 2 for v in p.values())
    ops = 2 * M * T * (2 * H * FF + 3 * 3 * FF * (FF // G))  # up, down, three grouped convs
    bound_ms, bound_by = bound(io_bytes, ops)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": io_bytes, "ops": ops, "M": M, "T": T, "H": H, "FF": FF}


def tconvffn_phases(dev):
    """Phases 26-29: SpatialNet-small with ``fused_ffn=True``, whose
    T-ConvFFN runs through the row-3 kernel. Returns row 3's entry of the
    ``kernels`` line."""
    import numpy as np
    import torch

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
    log(f"phase 26/62 tconvffn vs plain at M={M} T={T} H={H} FF={FF} groups={G}")
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
    from nbss_tpu_torch.ops import _build

    for h, ff in tc.KERNEL_WIDTHS:  # the wrapper's fragment layout fills the kernel's buffer
        zeros = {k: torch.zeros(s, device=dev) for k, s in tc._param_shapes(h, ff, G).items()}
        words = _build.library().nbss_tconvffn_tc_words(h, ff)
        if tc._tc_operands(zeros, G)[0].numel() != 2 * words:
            raise AssertionError(f"H={h} FF={ff}: ops/tconvffn.py lays out a fragment buffer "
                                 f"of another size than csrc/tconvffn_tc.cu's {words} words")

    def tc_check(x, params, label):
        """bf16 on the tensor-core kernel under the bf16 rule, a relaunch
        bit-identical; returns (error, the plain bf16 version's)."""
        with torch.no_grad():
            t0 = tc.tc_launches
            y = tc.tconvffn(x, params, G)
            again = tc.tconvffn(x, params, G)
            torch.cuda.synchronize()
            if tc.tc_launches != t0 + 2:
                raise AssertionError(f"{label}: bf16 missed the tensor-core kernel")
            relaunched(label, [y], [again])
            want = tc.reference(x.float(), params, G)
            e = (y.float() - want).abs().max().item()
            ep = (tc.reference(x, params, G).float() - want).abs().max().item()
        if not e <= 2 * ep:
            raise AssertionError(f"{label}: bf16 T-ConvFFN error {e} exceeds 2 x {ep}")
        return e, ep

    ffn_errbf, plainbf = tc_check(xb, p, "bf16")
    log(f"bf16 (tensor-core kernel): max |kernel - fp32 plain| = {ffn_errbf:.4f}, plain bf16 "
        f"version's = {plainbf:.4f} (bound: 2x the plain version's); two launches "
        "bit-identical")
    edges = []
    for Mr, Tr in ((1, 1), (3, 2), (2, 15), (2, 16), (2, 17), (1, 63), (2, 64), (1, 65),
                   (1, T), (2, 256), (2, 300)):
        e, ep = tc_check(torch.randn(Mr, Tr, H, generator=gen).to(dev).bfloat16(), p,
                         f"bf16 (M, T) = {(Mr, Tr)}")
        edges.append(f"{Tr}: {e:.4f}/{ep:.4f}")
    log("bf16 at the edges of the 16-frame tiles and 64-frame steps, T: kernel/plain error "
        + ", ".join(edges) + ": ok, relaunches bit-identical")
    for Mr, Tr in ((5, 1), (3, 2), (7, 13), (1, T)):
        _, e = fwd_check(torch.randn(Mr, Tr, H, generator=gen).to(dev), p, f"ragged {(Mr, Tr)}")
        log(f"ragged (M, T) = {(Mr, Tr)}: {e:.2e}: ok")
    p_large = ffn_params(gen, 2 * H, 2 * FF, dev)
    x_large = torch.randn(2 * n_freq, T, 2 * H, generator=gen).to(dev)
    _, e = fwd_check(x_large, p_large, "SpatialNet-large widths")
    eb, ebp = tc_check(x_large.bfloat16(), p_large, "bf16 SpatialNet-large widths")
    log(f"SpatialNet-large widths (H={2 * H}, FF={2 * FF}) at M={2 * n_freq}: fp32 {e:.2e}, "
        f"bf16 {eb:.4f} (plain {ebp:.4f}): ok")
    del x_large
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
    log(f"phase 27/62 SpatialNet-small fused_ffn=True serving: TrainModule.forward + "
        f"predict_step, B={B}, {CHANNELS} ch, {SECONDS:g} s, bf16")
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    tc.launches = tc.tc_launches = ab.launches = ab.tc_launches = ab.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    served = (tc.launches, ab.launches, ab.bwd_launches)
    served_tc = tc.tc_launches
    if ab.tc_launches != ab.launches or tc.tc_launches != tc.launches:
        raise AssertionError(f"bf16 launches that missed the tensor-core kernels: attention "
                             f"block {ab.launches - ab.tc_launches}, T-ConvFFN "
                             f"{tc.launches - tc.tc_launches}")
    for name, out in (("forward", yr_hat), ("predict_step", pred)):
        if out.shape != (B, 2, wave.shape[-1]) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    if served != (2 * n_layers, 2 * n_layers, 0):
        raise AssertionError(f"launches (tconvffn, attention block, its backward) {served} in two "
                             f"forwards, expected {(2 * n_layers, 2 * n_layers, 0)}")
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; launches (tconvffn, "
        f"attention block, backward) {served} ({n_layers} + {n_layers} per forward, all on "
        "the tensor-core kernels)")
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
    log(f"phase 28/62 training with fused_ffn=True: Trainer fits {B_TRAIN} SyntheticDataset "
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
    tc.launches = tc.tc_launches = ab.launches = ab.bwd_launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit = (tc.launches, ab.launches, ab.bwd_launches)
    if tc.tc_launches != tc.launches:
        raise AssertionError(f"{tc.launches - tc.tc_launches} bf16 T-ConvFFN launches in "
                             "training missed the tensor-core kernel")
    log(f"launches (tconvffn, attention block, its backward) in {TRAIN_STEPS} steps: {fit}, "
        "the T-ConvFFN's all on its tensor-core kernel")
    if fit != (TRAIN_STEPS * n_layers,) * 3:
        raise AssertionError(f"expected {n_layers} launches of each a step")
    check_losses(losses)
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
    log("phase 29/62 times (CUDA events, after warm-up)")
    ffn = tconvffn_times(xb, p, G)
    ffn_ms, ffn_plain_ms, ffn_library_ms = ffn["ms"], ffn["plain_ms"], ffn["library_ms"]
    ffn_bound, ffn_by, ffn_bytes, ffn_ops = ffn["bound_ms"], ffn["bound_by"], ffn["bytes"], ffn["ops"]
    with torch.no_grad():
        x32 = xb.float()
        ffn_ms_fp32 = cuda_ms(lambda: tc.tconvffn(x32, p, G), iters=5)
        del x32
        operands_ms = cuda_ms(lambda: tc._tc_operands(p, G), iters=20)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            tc._tc_operands(p, G)
        operands_host_us = (time.perf_counter() - t1) / 20 * 1e6
    log(f"tconvffn bf16 M={M}: kernel {ffn_ms:.3f} ms (fp32 {ffn_ms_fp32:.3f} ms), plain "
        f"{ffn_plain_ms:.3f} ms, library (layer_norm + linear + grouped conv1d x3 + group_norm "
        f"+ linear) {ffn_library_ms:.3f} ms, bound {ffn_bound:.4f} ms ({ffn_by}: "
        f"{ffn_bytes / 1e6:.0f} MB, {ffn_ops / 1e9:.1f} GFLOP grouped); the bf16 operand "
        f"layout (_tc_operands, every call) {operands_ms:.4f} ms of device time, "
        f"{operands_host_us:.0f} us on the host")
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

    # For comparison only: the same serving step with the bf16 operand layout made
    # once per layer (memoized by the first weight's address; the weights do not
    # change while serving). The port lays it out on every call.
    per_call, laid_out = tc._tc_operands, {}

    def once(params, groups=G):
        key = params["w_up"].data_ptr()
        if key not in laid_out:
            laid_out[key] = per_call(params, groups)
        return laid_out[key]

    def serve_step(mode):
        tc._tc_operands = once if mode == "cached" else per_call
        try:
            (module_off if mode == "off" else module).predict_step(wave)
        finally:
            tc._tc_operands = per_call

    serve = {"on": [], "cached": [], "off": []}
    for mode in serve:
        serve_step(mode)  # warm-up
    for mode in ("on", "cached", "off", "off", "cached", "on"):  # in turns
        serve[mode].append(step_ms(lambda: serve_step(mode), 3))
    serve_ms = {k: float(np.mean(v)) for k, v in serve.items()}
    laid_out.clear()
    log(f"serving: predict_step on {B} x {SECONDS:g} s, fused_ffn on {serve_ms['on']:.1f} ms = "
        f"{B * SECONDS / serve_ms['on'] * 1e3:.1f} audio-s/s (with the operand layout made "
        f"once a layer {serve_ms['cached']:.1f} ms = "
        f"{B * SECONDS / serve_ms['cached'] * 1e3:.1f} audio-s/s), off {serve_ms['off']:.1f} "
        f"ms = {B * SECONDS / serve_ms['off'] * 1e3:.1f} audio-s/s")
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
    return {"name": "tconvffn", "route": "cuda", "source": "nbss_tpu_torch/csrc/tconvffn_tc.cu",
            "source_fp32": "nbss_tpu_torch/csrc/tconvffn.cu",
            "routes": {"bfloat16": "mma.sync bf16", "float32": "fp32 FMA"},
            "replaces": "nbss_tpu/ops/tconvffn.py:148", "launches": served[0],
            "tc_launches": served_tc, "launches_training": fit[0], "max_abs_err": ffn_err32,
            "max_err_fp32": ffn_err32, "max_err_bf16": ffn_errbf,
            "ms": ffn_ms, "ms_fp32": ffn_ms_fp32, "plain_ms": ffn_plain_ms,
            "operands_ms": operands_ms, "operands_host_us": operands_host_us,
            "bound_ms": ffn_bound, "bound_by": ffn_by, "library_ms": ffn_library_ms,
            "serve_sdr_db_fp32": ffn_sdr,
            "serve_step_ms": {"fused_ffn": serve_ms["on"], "plain_ffn": serve_ms["off"],
                              "fused_ffn_operands_once": serve_ms["cached"]},
            "train_step_ms": {"fused_ffn": train_ms[True], "plain_ffn": train_ms[False]}}


def fixed_batch(n: int, channels: int, rate: int):
    """n fixed ``SyntheticDataset`` items of ``channels`` x SECONDS at
    ``rate``, stacked as a batch (x, ys)."""
    import numpy as np

    from nbss_tpu_torch.data.synthetic import SyntheticDataset

    data = SyntheticDataset(num_items=n, num_channels=channels, sample_rate=rate,
                            audio_time_len=SECONDS)
    items = [data[(i, 1000 + i)] for i in range(n)]
    return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


def trainer_of(module, dev, losses):
    """A ``Trainer`` (Adam 1e-3, clip 5, seed 2) that appends each step's
    loss to ``losses``, its parameters drawn."""
    from nbss_tpu_torch.train.loop import Trainer

    trainer = Trainer(module, optimizer=("Adam", {"lr": 1e-3}), gradient_clip_val=5.0, seed=2,
                      device=dev, logger=lambda k, v, _: losses.append(v)
                      if k.startswith("train/") else None)
    trainer.init()
    return trainer


def check_losses(losses, steps: int = 0) -> None:
    """``steps`` (TRAIN_STEPS unless given) losses, every one finite, and the
    mean of the last half below the first half's."""
    import numpy as np

    steps = steps or TRAIN_STEPS
    log(f"losses: {', '.join(f'{v:.3f}' for v in losses)}")
    half = steps // 2
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    first, last = float(np.mean(losses[:half])), float(np.mean(losses[-half:]))
    log(f"mean loss of the first {half} steps {first:.3f}, of the last {half} {last:.3f}")
    if not last < first:
        raise AssertionError("the loss did not fall")


def seconds_per_call(fn, reps: int) -> float:
    """Host seconds a call of ``fn`` takes, after one warm-up call, ending in
    a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) / reps


def check_outputs(outputs, shape) -> None:
    """Raise unless each named output is finite with ``shape``."""
    import torch

    for name, out in outputs:
        if tuple(out.shape) != tuple(shape) or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: shape {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}, expected {tuple(shape)}")


def nbc2_phases(dev):
    """Phases 30-34: rows 1-2 at NBC2-small's two heads, rows 4-5 at its
    48-wide heads, NBC2-small serving and training. Returns the keys that
    rows 1, 2, 4 and 5 gain in the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch import check_gradients
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nbc2 import NBC2
    from nbss_tpu_torch.models.online_spatialnet import local_causal_mask
    from nbss_tpu_torch.ops import attention as att
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.module import TrainModule

    H, nh, n_layers = NBC2_CFG["dim_hidden"], NBC2_CFG["n_heads"], NBC2_CFG["n_layers"]
    dh = H // nh
    n_freq = NBC2_CFG["num_freqs"]
    T = int(SECONDS * FS) // 128 + 1
    M, Mt = B * n_freq, B_TRAIN * n_freq
    gen = torch.Generator().manual_seed(7)
    net = NBC2(**NBC2_CFG, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    blk = net.sa_layers[0]
    sa = blk.self_attn
    with torch.no_grad():
        ln, A, Wvo, c, eps = ab.fold_weights(blk.norm1.weight, blk.norm1.bias, sa.in_proj_weight,
                                             sa.in_proj_bias, sa.out_proj.weight,
                                             sa.out_proj.bias, nh)
    ops = (ln, A, Wvo)

    # 30. rows 1-2 at nh 2
    log(f"phase 30/62 attention_block at NBC2-small's shape: forward M={M}, backward M={Mt}, "
        f"T={T} H={H} nh={nh} (dh {dh})")
    tc0, btc0 = ab.tc_launches, ab.bwd_tc_launches
    xb = torch.randn(M, T, H, generator=gen).to(dev).to(torch.bfloat16)
    x32 = xb.float()  # the fp32 checks on the bf16 inputs' values
    with torch.no_grad():
        y = ab.attention_block(x32, *ops, c, eps, nh)
        torch.cuda.synchronize()
        want = ab.reference(x32, *ops, c, eps, nh)
    fwd_err32 = (y - want).abs().max().item()
    torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    del x32, y
    with torch.no_grad():
        ybf = ab.attention_block(xb, *ops, c, eps, nh)
        relaunched("bf16 attention_block nh 2", [ybf], [ab.attention_block(xb, *ops, c, eps, nh)])
        fwd_errbf, = bf16_rule("bf16 attention_block nh 2", [ybf], [want],
                               [ab.reference(xb, *ops, c, eps, nh)], 2e-4, 1e-4)
    del ybf, want
    log(f"forward: fp32 (CUDA-core kernel) max |kernel - plain| = {fwd_err32:.3e} (atol 2e-4, "
        f"rtol 1e-4); bf16 (tensor-core kernel) {fwd_errbf:.4f}, within the bf16 rule; two "
        "launches bit-identical")
    names = ("dx", "dln", "dA", "dWvo", "dc")
    xtb = xb[:Mt]
    gtb = torch.randn(Mt, T, H, generator=gen).to(dev).to(torch.bfloat16)
    xt32, g32 = xtb.float(), gtb.float()
    got = ab.backward(xt32, *ops, g32, eps, nh)
    torch.cuda.synchronize()
    want = ab.reference_bwd(xt32, *ops, g32, eps, nh)
    bwd_errs32 = [(a - w).abs().max().item() for a, w in zip(got, want)]
    for name, a, w in zip(names, got, want):
        torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3, msg=name)
    del xt32, g32, got
    gotb = ab.backward(xtb, *ops, gtb, eps, nh)
    relaunched("bf16 attention_block backward nh 2", gotb, ab.backward(xtb, *ops, gtb, eps, nh))
    bwd_errsbf = bf16_rule("bf16 attention_block backward nh 2", gotb, want,
                           ab.reference_bwd(xtb, *ops, gtb, eps, nh), 0.0, 5e-3)
    del gotb, want
    log("backward: fp32 (CUDA-core kernel) max |kernel - plain| " + ", ".join(
        f"{n} {e:.3e}" for n, e in zip(names, bwd_errs32)) + " (atol 5e-3 x max|plain|); bf16 "
        "(tensor-core kernel) " + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, bwd_errsbf))
        + ", within the bf16 rule; two launches bit-identical, weight cotangents included")
    for Te in (1, 17, 65, 256):  # the edges of the tensor-core kernels' tiles, at nh 2
        xe, ge = (torch.randn(3, Te, H, generator=gen).to(dev).to(torch.bfloat16)
                  for _ in range(2))
        label = f"bf16 attention_block nh 2 at (M, T) = (3, {Te})"
        with torch.no_grad():
            ye = ab.attention_block(xe, *ops, c, eps, nh)
            relaunched(label, [ye], [ab.attention_block(xe, *ops, c, eps, nh)])
            bf16_rule(label, [ye], [ab.reference(xe.float(), *ops, c, eps, nh)],
                      [ab.reference(xe, *ops, c, eps, nh)], 2e-4, 1e-4)
        got = ab.backward(xe, *ops, ge, eps, nh)
        relaunched(label + " backward", got, ab.backward(xe, *ops, ge, eps, nh))
        bf16_rule(label + " backward", got,
                  ab.reference_bwd(xe.float(), *ops, ge.float(), eps, nh),
                  ab.reference_bwd(xe, *ops, ge, eps, nh), 0.0, 5e-3)
    log("bf16 at T = 1, 17, 65, 256 (M = 3), forward and backward: within the bf16 rule, "
        "relaunches bit-identical")
    if (ab.tc_launches - tc0, ab.bwd_tc_launches - btc0) != (10, 10):
        raise AssertionError(f"{ab.tc_launches - tc0} forward and {ab.bwd_tc_launches - btc0} "
                             "backward tensor-core launches, expected 10 and 10")

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ab.attention_block(xb, *ops, c, eps, nh), iters=20)
        x32 = xb.float()
        fwd_ms_fp32 = cuda_ms(lambda: ab.attention_block(x32, *ops, c, eps, nh), iters=5)
        del x32
        fwd_plain_ms = cuda_ms(lambda: ab.reference(xb, *ops, c, eps, nh), iters=3, warmup=1)
    bf = torch.bfloat16
    w_in, b_in = sa.in_proj_weight.to(bf), sa.in_proj_bias.to(bf)
    w_out, b_out = sa.out_proj.weight.to(bf), sa.out_proj.bias.to(bf)
    ln_w, ln_b = blk.norm1.weight.to(bf), blk.norm1.bias.to(bf)

    def library(x, ln_w, ln_b, w_in, b_in, w_out, b_out):  # the port never calls this
        M_ = x.shape[0]
        q, k, v = F.linear(F.layer_norm(x, (H,), ln_w, ln_b), w_in, b_in).chunk(3, -1)
        q, k, v = (t.reshape(M_, T, nh, dh).transpose(1, 2) for t in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(M_, T, H)
        return x + F.linear(o, w_out, b_out)

    with torch.no_grad():
        fwd_library_ms = cuda_ms(lambda: library(xb, ln_w, ln_b, w_in, b_in, w_out, b_out),
                                 iters=20)
    bwd_ms = cuda_ms(lambda: ab.backward(xtb, *ops, gtb, eps, nh), iters=10)
    xt32, gt32 = xtb.float(), gtb.float()
    bwd_ms_fp32 = cuda_ms(lambda: ab.backward(xt32, *ops, gt32, eps, nh), iters=3, warmup=1)
    del xt32, gt32
    bwd_plain_ms = cuda_ms(lambda: ab.reference_bwd(xtb, *ops, gtb, eps, nh), iters=3, warmup=1)
    leaves = [t.detach().clone().requires_grad_() for t in (xtb, ln_w, ln_b, w_in, b_in, w_out,
                                                            b_out)]
    yl = library(*leaves)  # graph built once
    bwd_library_ms = cuda_ms(lambda: torch.autograd.grad(yl, leaves, gtb, retain_graph=True),
                             iters=10)
    del yl, leaves
    op_bytes = sum(t.numel() * t.element_size() for t in (ln, A, Wvo, c))
    flops = T * H * 3 * H * 2 + 2 * 2 * T * T * H + 2 * T * H * H  # a sequence, unfolded
    fwd_bound, fwd_by = bound(2 * xb.numel() * 2 + op_bytes, M * flops)
    bwd_bound, bwd_by = bound(3 * xtb.numel() * 2 + 2 * op_bytes, 2 * Mt * flops)
    log(f"attention_block nh 2, bf16: forward M={M} tensor-core kernel {fwd_ms:.3f} ms (fp32, "
        f"CUDA-core kernel {fwd_ms_fp32:.3f} ms), plain {fwd_plain_ms:.3f} ms, library (LN + "
        f"linear + SDPA at nh 2 + linear + residual) {fwd_library_ms:.3f} ms, bound "
        f"{fwd_bound:.4f} ms ({fwd_by}); backward M={Mt} tensor-core kernel {bwd_ms:.3f} ms "
        f"(fp32, CUDA-core kernel {bwd_ms_fp32:.3f} ms), plain {bwd_plain_ms:.3f} ms, library "
        f"backward {bwd_library_ms:.3f} ms, bound {bwd_bound:.4f} ms ({bwd_by})")
    del xb, xtb, gtb
    check_budget("attention block at nh 2")

    # 31. rows 4-5 at dh = dv = 48
    Ma = 2 * n_freq
    causal = torch.from_numpy(local_causal_mask(T, T)).clamp(min=-1e30).to(dev)
    log(f"phase 31/62 narrowband_attention at NBC2-small's heads: M={Ma} T={T} nh={nh} "
        f"dh=dv={dh}, no mask and causal")
    tc0, btc0 = att.tc_launches, att.bwd_tc_launches
    att_errs = {}
    for label, mask in (("none", None), ("causal", causal)):
        insb, gb = attention_inputs(gen, Ma, T, nh, dh, dh, torch.bfloat16, dev)
        ins32, g32 = [t.float() for t in insb], gb.float()  # the bf16 inputs' values
        o, st = att.forward(*ins32, mask, nh, stats=True)
        torch.cuda.synchronize()
        want = att.reference(*ins32, mask, nh)
        e_fwd = (o - want).abs().max().item()
        torch.testing.assert_close(o, want, atol=2e-4, rtol=1e-4, msg=label)
        got = att.backward(*ins32, mask, g32, nh, st)
        want = att.reference_bwd(*ins32, mask, g32, nh)
        e_bwd = []
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            e_bwd.append((a - w).abs().max().item())
            torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=f"{label} {name}")
        ob, stb = att.forward(*insb, mask, nh, stats=True)
        relaunched(f"bf16 attention dh 48 {label}", (ob, stb),
                   att.forward(*insb, mask, nh, stats=True))
        e_fwdbf, = bf16_rule(f"bf16 attention dh 48 {label}", [ob],
                             [att.reference(*ins32, mask, nh)],
                             [att.reference(*insb, mask, nh)], 2e-4, 1e-4)
        gotb = att.backward(*insb, mask, gb, nh, stb)
        relaunched(f"bf16 attention backward dh 48 {label}", gotb,
                   att.backward(*insb, mask, gb, nh, stb))
        e_bwdbf = bf16_rule(f"bf16 attention backward dh 48 {label}", gotb, want,
                            att.reference_bwd(*insb, mask, gb, nh), 0.0, 5e-3)
        att_errs[label] = {"fwd_fp32": e_fwd, "fwd_bf16": e_fwdbf,
                           "bwd_fp32": dict(zip(("dq", "dk", "dv"), e_bwd)),
                           "bwd_bf16": dict(zip(("dq", "dk", "dv"), e_bwdbf))}
        log(f"{label} mask: forward fp32 {e_fwd:.3e} (atol 2e-4, rtol 1e-4), bf16 "
            f"{e_fwdbf:.4f}; backward fp32 " + ", ".join(f"{e:.3e}" for e in e_bwd)
            + " (atol 5e-3 x max|plain|), bf16 " + ", ".join(f"{e:.3e}" for e in e_bwdbf)
            + "; bf16 within the bf16 rule, relaunches bit-identical")
        del ins32, g32, o, st, got, want, ob, stb, gotb
    if (att.tc_launches - tc0, att.bwd_tc_launches - btc0) != (4, 4):
        raise AssertionError(f"{att.tc_launches - tc0} forward and "
                             f"{att.bwd_tc_launches - btc0} backward tensor-core launches, "
                             "expected 4 and 4")
    # times: the forward at the serving count, the backward at the training count, no mask
    q, k, v = (torch.randn(M, T, H, generator=gen).to(dev).to(torch.bfloat16) for _ in range(3))
    a_fwd_ms = cuda_ms(lambda: att.forward(q, k, v, None, nh), iters=10)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    a_fwd_ms_fp32 = cuda_ms(lambda: att.forward(q32, k32, v32, None, nh), iters=3, warmup=1)
    del q32, k32, v32
    a_fwd_plain_ms = cuda_ms(lambda: att.reference(q, k, v, None, nh), iters=2, warmup=1)

    def heads(t):  # [M, T, nh*d] -> [M, nh, T, d], a view
        M_, T_, W = t.shape
        return t.view(M_, T_, nh, W // nh).transpose(1, 2)

    a_fwd_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v)), iters=10)
    a_fwd_bound, a_fwd_by = bound(4 * q.numel() * 2, 2 * M * nh * T * T * 2 * dh)
    qt, kt, vt = (t[:Mt] for t in (q, k, v))
    gt = torch.randn(Mt, T, H, generator=gen).to(dev).to(torch.bfloat16)
    _, stt = att.forward(qt, kt, vt, None, nh, stats=True)
    a_bwd_ms = cuda_ms(lambda: att.backward(qt, kt, vt, None, gt, nh, stt), iters=10)
    ins32, g32 = [t.float() for t in (qt, kt, vt)], gt.float()
    _, st32 = att.forward(*ins32, None, nh, stats=True)
    a_bwd_ms_fp32 = cuda_ms(lambda: att.backward(*ins32, None, g32, nh, st32), iters=3, warmup=1)
    del ins32, g32, st32
    a_bwd_plain_ms = cuda_ms(lambda: att.reference_bwd(qt, kt, vt, None, gt, nh), iters=2,
                             warmup=1)
    leaves = [t.detach().clone().requires_grad_() for t in (qt, kt, vt)]
    o = F.scaled_dot_product_attention(*(heads(t) for t in leaves))  # graph built once
    a_bwd_library_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, heads(gt),
                                                           retain_graph=True), iters=10)
    del o, leaves
    a_bwd_bound, a_bwd_by = bound(7 * qt.numel() * 2, 2 * Mt * nh * T * T * 5 * dh)
    log(f"narrowband_attention dh 48, bf16, no mask: forward M={M} tensor-core kernel "
        f"{a_fwd_ms:.3f} ms (fp32, CUDA-core kernel {a_fwd_ms_fp32:.3f} ms), plain "
        f"{a_fwd_plain_ms:.3f} ms, library (SDPA) {a_fwd_library_ms:.3f} ms, bound "
        f"{a_fwd_bound:.4f} ms ({a_fwd_by}); backward M={Mt} tensor-core kernels "
        f"{a_bwd_ms:.3f} ms (fp32 {a_bwd_ms_fp32:.3f} ms), plain {a_bwd_plain_ms:.3f} ms, "
        f"library (SDPA backward) {a_bwd_library_ms:.3f} ms, bound {a_bwd_bound:.4f} ms "
        f"({a_bwd_by})")
    del q, k, v, qt, kt, vt, gt, stt
    check_budget("attention at dh 48")

    # 32. serving
    log(f"phase 32/62 NBC2-small serving: TrainModule.forward + predict_step, B={B}, "
        f"{CHANNELS} ch, {SECONDS:g} s, bf16")
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_sa_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    ab.launches = ab.tc_launches = ab.bwd_launches = att.launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave, target)
    torch.cuda.synchronize()
    served = (ab.launches, ab.tc_launches, ab.bwd_launches, att.launches)
    check_outputs((("forward", yr_hat), ("predict_step", pred)), (B, 2, wave.shape[-1]))
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; attention_block "
        f"launched {served[0]} times ({served[1]} on the tensor-core kernel), its backward "
        f"{served[2]}, the narrow-band attention {served[3]}")
    if served != (2 * n_layers, 2 * n_layers, 0, 0):
        raise AssertionError(f"expected {n_layers} attention-block launches a forward, all on "
                             "the tensor-core kernel, and no other")
    sdrs = {}
    for label, kw, bsz in (("LN/GBN/GBN", {}, B), ("GBN/GBN/GBN", {"norms": ("GBN",) * 3}, 2)):
        cfg = dict(NBC2_CFG, **kw)
        kernel32 = NBC2(**cfg, device=dev).eval()
        kernel32.load_state_dict(net.state_dict())
        plain32 = NBC2(**cfg, fused_block=False, attention_kernel=False, device=dev).eval()
        plain32.load_state_dict(net.state_dict())
        ab.launches = att.launches = 0
        y_kernel, _ = TrainModule(**{**module.__dict__, "arch": kernel32}).forward(wave[:bsz])
        launched = (ab.launches, att.launches)
        y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave[:bsz])
        sdrs[label] = si_sdr(y_kernel, y_plain).min().item()
        want = (n_layers, 0) if not kw else (0, n_layers)
        log(f"fp32 {label} kernel path vs plain composition at B={bsz}: min SI-SDR "
            f"{sdrs[label]:.1f} dB (bound >= 50); launches (attention block, narrow-band "
            f"attention) {launched}")
        if launched != want or not sdrs[label] >= 50.0:
            raise AssertionError(f"{label}: launches {launched} (expected {want}), SI-SDR "
                                 f"{sdrs[label]:.1f} dB")
        del kernel32, plain32, y_kernel, y_plain
    torch.cuda.empty_cache()
    check_budget("nbc2 serving")

    # 33. training
    log(f"phase 33/62 NBC2-small training: Trainer fits {B_TRAIN} SyntheticDataset items for "
        f"{TRAIN_STEPS} steps, Adam 1e-3, clip 5, neg-SA-SDR with PIT, bf16")
    batch = fixed_batch(B_TRAIN, CHANNELS, FS)
    losses = []
    trainer = trainer_of(TrainModule(**{**module.__dict__, "arch": NBC2(
        **NBC2_CFG, dtype=torch.bfloat16, device=dev)}), dev, losses)
    ab.launches = ab.tc_launches = ab.bwd_launches = ab.bwd_tc_launches = att.launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit = (ab.launches, ab.tc_launches, ab.bwd_launches, ab.bwd_tc_launches, att.launches)
    check_losses(losses)
    log(f"launches in {TRAIN_STEPS} steps: {fit[0]} forward ({fit[1]} tensor-core) + {fit[2]} "
        f"backward ({fit[3]} tensor-core); the narrow-band attention {fit[4]}")
    if fit != (TRAIN_STEPS * n_layers,) * 4 + (0,):
        raise AssertionError(f"expected {n_layers} forward and {n_layers} backward launches a "
                             "step, all on the tensor-core kernels")
    log("fp32 gradients: kernel path vs plain composition (fp32 and float64 arch), one batch")
    grads = check_gradients.gradients(trainer.module, trainer.to_device(batch), NBC2_CFG, dev,
                                      arch_cls=NBC2,
                                      plain=dict(fused_block=False, attention_kernel=False))
    log(check_gradients.hold(grads))
    del grads
    torch.cuda.empty_cache()
    check_budget("nbc2 training")

    # 34. rates
    log("phase 34/62 NBC2-small rates")
    serve_s = seconds_per_call(lambda: module.predict_step(wave), 5)
    torch.cuda.reset_peak_memory_stats()
    train_s = seconds_per_call(lambda: trainer.train_step(batch), 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"serving: predict_step on {B} x {SECONDS:g} s in {serve_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve_s:.1f} audio-s/s; training: train_step on {B_TRAIN} x "
        f"{SECONDS:g} s in {train_s * 1e3:.1f} ms = {B_TRAIN * SECONDS / train_s:.1f} "
        f"audio-s/s trained; peak memory {peak:.1f} GiB")
    check_budget("nbc2 rates")
    row1 = {"nbc2_nh2": {"M": M, "nh": nh, "launches": served[0], "tc_launches": served[1],
                         "launches_training": fit[0], "max_err_fp32": fwd_err32,
                         "max_err_bf16": fwd_errbf, "ms": fwd_ms, "ms_fp32": fwd_ms_fp32,
                         "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
                         "library_ms": fwd_library_ms,
                         "serve_sdr_db_fp32": sdrs["LN/GBN/GBN"],
                         "serve_audio_s_per_s": B * SECONDS / serve_s,
                         "train_audio_s_per_s": B_TRAIN * SECONDS / train_s}}
    row2 = {"nbc2_nh2": {"M": Mt, "nh": nh, "launches": fit[2], "tc_launches": fit[3],
                         "max_err_fp32": dict(zip(names, bwd_errs32)),
                         "max_err_bf16": dict(zip(names, bwd_errsbf)), "ms": bwd_ms,
                         "ms_fp32": bwd_ms_fp32, "plain_ms": bwd_plain_ms,
                         "bound_ms": bwd_bound, "bound_by": bwd_by,
                         "library_ms": bwd_library_ms}}
    row4 = {"nbc2_dh48": {"M": M, "nh": nh, "max_err": att_errs, "ms": a_fwd_ms,
                          "ms_fp32": a_fwd_ms_fp32, "plain_ms": a_fwd_plain_ms,
                          "bound_ms": a_fwd_bound, "bound_by": a_fwd_by,
                          "library_ms": a_fwd_library_ms,
                          "gbn_first_norm_sdr_db_fp32": sdrs["GBN/GBN/GBN"]}}
    row5 = {"nbc2_dh48": {"M": Mt, "nh": nh, "ms": a_bwd_ms, "ms_fp32": a_bwd_ms_fp32,
                          "plain_ms": a_bwd_plain_ms, "bound_ms": a_bwd_bound,
                          "bound_by": a_bwd_by, "library_ms": a_bwd_library_ms}}
    return row1, row2, row4, row5


def blstm_phases(dev):
    """Phases 35-36: NB-BLSTM serving and training (no kernel of the port:
    its LSTMs are cuDNN's)."""
    import torch

    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nb_blstm import BLSTM2_FC1
    from nbss_tpu_torch.ops import attention as att
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops import ssm, tconvffn
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.module import TrainModule

    def port_launches():
        return (ab.launches + ab.bwd_launches + ab.relpos_launches + att.launches
                + att.bwd_launches + ssm.launches + ssm.bwd_launches + tconvffn.launches)

    # 35. serving
    log(f"phase 35/62 NB-BLSTM serving: TrainModule.forward + predict_step, B={B}, {CHANNELS} "
        f"ch, {SECONDS:g} s, bf16 and fp32")
    gen = torch.Generator().manual_seed(8)
    net = BLSTM2_FC1(**BLSTM_CFG, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    net32 = BLSTM2_FC1(**BLSTM_CFG, device=dev).eval()
    net32.load_state_dict(net.state_dict())
    module32 = TrainModule(**{**module.__dict__, "arch": net32})
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    before = port_launches()
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave)
    y32, _ = module32.forward(wave)
    torch.cuda.synchronize()
    check_outputs((("forward", yr_hat), ("predict_step", pred), ("fp32 forward", y32)),
                  (B, 2, wave.shape[-1]))
    if port_launches() != before:
        raise AssertionError("NB-BLSTM launched a kernel of the port")
    sdr_bf16 = si_sdr(yr_hat, y32).min().item()
    x = torch.randn(B * 129, int(SECONDS * FS) // 128 + 1, 12, generator=gen).to(dev)
    with torch.no_grad():
        lstm_ms = {str(dt).split(".")[1]: cuda_ms(lambda: net.blstm1(x.to(dt)), iters=3)
                   for dt in (torch.bfloat16, torch.float32)}
    log(f"forward and predict_step: finite [{B}, 2, {wave.shape[-1]}]; no kernel of the port "
        f"launched; bf16 vs fp32 min SI-SDR {sdr_bf16:.1f} dB; the first BLSTM (256) at "
        f"[{x.shape[0]}, {x.shape[1]}, 12]: bf16 {lstm_ms['bfloat16']:.1f} ms, fp32 (TF32 off) "
        f"{lstm_ms['float32']:.1f} ms")
    serve_s = seconds_per_call(lambda: module.predict_step(wave), 3)
    serve32_s = seconds_per_call(lambda: module32.predict_step(wave), 3)
    log(f"serving: predict_step on {B} x {SECONDS:g} s in {serve_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve_s:.1f} audio-s/s in bf16, {serve32_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve32_s:.1f} audio-s/s in fp32")
    del module32, net32, x
    check_budget("nb-blstm serving")

    # 36. training
    log(f"phase 36/62 NB-BLSTM training: Trainer fits {B_TRAIN} SyntheticDataset items for "
        f"{TRAIN_STEPS} steps, Adam 1e-3, clip 5, neg-SI-SDR with PIT, bf16")
    batch = fixed_batch(B_TRAIN, CHANNELS, FS)
    losses = []
    trainer = trainer_of(TrainModule(**{**module.__dict__, "arch": BLSTM2_FC1(
        **BLSTM_CFG, dtype=torch.bfloat16, device=dev)}), dev, losses)
    before = port_launches()
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    check_losses(losses)
    if port_launches() != before:
        raise AssertionError("NB-BLSTM training launched a kernel of the port")
    torch.cuda.reset_peak_memory_stats()
    train_s = seconds_per_call(lambda: trainer.train_step(batch), 3)
    log(f"training: train_step on {B_TRAIN} x {SECONDS:g} s in {train_s * 1e3:.1f} ms = "
        f"{B_TRAIN * SECONDS / train_s:.1f} audio-s/s trained; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check_budget("nb-blstm training")


def nbss_phase(dev):
    """Phase 37: the NBSS wrapper, one forward for each arch in fp32 and bf16."""
    import torch

    from nbss_tpu_torch.models.nbss import NBSS
    from nbss_tpu_torch.ops import attention_block as ab

    log(f"phase 37/62 NBSS (STFT 512/256, {NBC_CHANNELS} ch, {SECONDS:g} s at {NBC_FS} Hz, "
        "B=2): one forward for each arch in fp32 and bf16")
    gen = torch.Generator().manual_seed(9)
    wave = (0.1 * torch.randn(2, NBC_CHANNELS, int(SECONDS * NBC_FS), generator=gen)).to(dev)
    nbc_kw = {k: v for k, v in NBC_CFG.items() if k not in ("dim_input", "dim_output")}
    nbc2_kw = {k: v for k, v in NBC2_CFG.items() if k not in ("dim_input", "dim_output")}
    for arch, kw, counter, per_fwd in (
            ("NB_BLSTM", {"hidden_size": BLSTM_CFG["hidden_size"]}, None, 0),
            ("NBC", nbc_kw, "relpos_launches", NBC_CFG["n_layers"]),
            ("NBC2", dict(nbc2_kw, num_freqs=NBC_NFFT // 2 + 1), "launches",
             NBC2_CFG["n_layers"])):
        for dtype in (torch.float32, torch.bfloat16):
            model = NBSS(n_channel=NBC_CHANNELS, arch=arch, arch_kwargs=kw, dtype=dtype,
                         generator=torch.Generator().manual_seed(10), device=dev).eval()
            before = getattr(ab, counter) if counter else 0
            with torch.no_grad():
                out = model(wave)
            torch.cuda.synchronize()
            launched = (getattr(ab, counter) - before) if counter else 0
            check_outputs(((f"NBSS {arch} {dtype}", out),), (2, 2, wave.shape[-1]))
            if launched != per_fwd:
                raise AssertionError(f"NBSS {arch} {dtype}: {launched} kernel launches, "
                                     f"expected {per_fwd}")
            log(f"{arch} {str(dtype).split('.')[1]}: finite [2, 2, {wave.shape[-1]}], "
                f"{launched} kernel launches")
            del model, out
    check_budget("nbss")


def nbc_training_phases(dev):
    """Phases 38-39: NBC (``configs/NBC.yaml``) trains at its dropout 0.1,
    where neither row 8 nor rows 4-5 run, and at dropout 0 through row 8.
    Returns row 8's training launches and rates."""
    import torch

    from nbss_tpu_torch import check_gradients
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nbc import NBC
    from nbss_tpu_torch.ops import attention as att
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.train.module import TrainModule

    n_layers = NBC_TRAIN_LAYERS
    out = {}
    for phase, dropout in ((38, NBC_CFG["dropout"]), (39, 0.0)):
        bsz = NBC_B_TRAIN[dropout]
        log(f"phase {phase}/62 NBC training at dropout {dropout:g}, {n_layers} of its "
            f"{NBC_CFG['n_layers']} layers: Trainer fits {bsz} SyntheticDataset items "
            f"({NBC_CHANNELS} ch x {SECONDS:g} s at {NBC_FS} Hz) for {TRAIN_STEPS} steps, Adam "
            "1e-3, clip 5, bf16")
        batch = fixed_batch(bsz, NBC_CHANNELS, NBC_FS)
        cfg = dict(NBC_CFG, dropout=dropout, n_layers=n_layers)
        module = TrainModule(arch=NBC(**cfg, dtype=torch.bfloat16, device=dev),
                             channels=tuple(range(NBC_CHANNELS)),
                             stft=STFT(n_fft=NBC_NFFT, n_hop=NBC_NFFT // 2),
                             norm=Norm(mode="frequency"))
        losses = []
        trainer = trainer_of(module, dev, losses)
        torch.cuda.reset_peak_memory_stats()
        ab.relpos_launches = ab.relpos_tc_launches = att.launches = att.bwd_launches = 0
        trainer.fit([batch], max_epochs=TRAIN_STEPS)
        torch.cuda.synchronize()
        fit = (ab.relpos_launches, ab.relpos_tc_launches, att.launches + att.bwd_launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_losses(losses)
        per_step = n_layers if dropout == 0 else 0  # the block is off while dropout is active
        log(f"launches in {TRAIN_STEPS} steps: attention_block_relpos {fit[0]} ({fit[1]} "
            f"on the tensor-core kernel), the narrow-band attention {fit[2]}; peak memory "
            f"{peak:.1f} GiB")
        if fit != (TRAIN_STEPS * per_step,) * 2 + (0,):
            raise AssertionError(f"expected {per_step} relative-position launches a step, all on "
                                 "the tensor-core kernel, and no narrow-band attention")
        if dropout == 0:
            log("fp32 gradients: kernel path vs plain composition (fp32 and float64 arch)")
            grads = check_gradients.gradients(  # in parts: the plain attention's [M, 8, T, T]
                module, trainer.to_device(batch), cfg, dev, parts64=bsz, arch_cls=NBC,
                plain=dict(fused_block=False, attention_kernel=False), parts32=2)
            exempt = [n for n in grads["kernel"] if n.endswith("self_attn.key_proj.bias")]
            log(check_gradients.hold(grads, exempt=exempt) + f"; {len(exempt)} key biases "
                "left out (the fold drops them: the softmax removes a constant score row)")
            del grads
            torch.cuda.empty_cache()
        train_s = seconds_per_call(lambda: trainer.train_step(batch), 3)
        log(f"training: train_step on {bsz} x {SECONDS:g} s in {train_s * 1e3:.1f} ms = "
            f"{bsz * SECONDS / train_s:.2f} audio-s/s trained")
        out[f"dropout_{dropout:g}"] = {"B": bsz, "launches": fit[0], "tc_launches": fit[1],
                                       "train_audio_s_per_s": bsz * SECONDS / train_s,
                                       "peak_gib": peak}
        del trainer, module
        fresh_start()
        check_budget(f"nbc training at dropout {dropout:g}")
    return out


def fold_block(layer, nh):
    """A SpatialNet layer's LN + MHSA folded into the attention block's
    operands at nh heads (no autograd graph)."""
    import torch

    from nbss_tpu_torch.ops import attention_block as ab

    with torch.no_grad():
        return ab.fold_weights(layer.norm_mhsa.weight, layer.norm_mhsa.bias,
                               layer.mhsa.in_proj_weight, layer.mhsa.in_proj_bias,
                               layer.mhsa.out_proj.weight, layer.mhsa.out_proj.bias, nh)


def wide_counts():
    from nbss_tpu_torch.ops import attention_block as ab

    return (ab.wide_launches, ab.wide_tc_launches, ab.bwd_wide_launches, ab.bwd_wide_tc_launches)


def check_wide_block(label, x, g, ops, c, eps, nh):
    """The wide route's forward and backward on x, g against ``reference``
    and ``reference_bwd``: float32 at atol 2e-4, rtol 1e-4 and each
    cotangent at atol 5e-3 x max|plain|, rtol 5e-3; bf16 under the bf16
    rule; two launches bit-identical. Returns (forward error, cotangent
    errors) against the float32 plain results."""
    import torch

    from nbss_tpu_torch.ops import attention_block as ab

    names = ("dx", "dln", "dA", "dWvo", "dc")
    with torch.no_grad():
        y = ab.attention_block(x, *ops, c, eps, nh)
        relaunched(label, [y], [ab.attention_block(x, *ops, c, eps, nh)])
        want = ab.reference(x.float(), *ops, c, eps, nh)
        if x.dtype == torch.float32:
            torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4, msg=label)
            err = (y - want).abs().max().item()
        else:
            err, = bf16_rule(label, [y], [want], [ab.reference(x, *ops, c, eps, nh)], 2e-4, 1e-4)
        del y, want
    got = ab.backward(x, *ops[:3], g, eps, nh)
    relaunched(label + " backward", got, ab.backward(x, *ops[:3], g, eps, nh))
    want = ab.reference_bwd(x.float(), *ops[:3], g.float(), eps, nh)
    if x.dtype == torch.float32:
        errs = []
        for name, a, w in zip(names, got, want):
            torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=f"{label} {name}")
            errs.append((a - w).abs().max().item())
    else:
        errs = bf16_rule(label + " backward", got, want,
                         ab.reference_bwd(x, *ops[:3], g, eps, nh), 0.0, 5e-3)
    return err, dict(zip(names, errs))


def wide_block_times(layer, xb, gb, ops, c, eps, nh):
    """CUDA-event times of the wide route's forward on xb and backward on
    gb's rows (bf16 tensor cores and fp32 CUDA cores), their plain versions,
    the PyTorch library composition (LN, the projections, SDPA, the out
    projection, the residual) and its backward, and their bounds."""
    import torch
    import torch.nn.functional as F

    from nbss_tpu_torch.ops import attention_block as ab

    M, T, H = xb.shape
    Mt = gb.shape[0]
    xt = xb[:Mt]
    bf = torch.bfloat16
    m = layer.mhsa
    params = [t.detach().to(bf) for t in (layer.norm_mhsa.weight, layer.norm_mhsa.bias,
                                          m.in_proj_weight, m.in_proj_bias, m.out_proj.weight,
                                          m.out_proj.bias)]

    def library(x, ln_w, ln_b, w_in, b_in, w_out, b_out):  # the port never calls this
        M_ = x.shape[0]
        q, k, v = F.linear(F.layer_norm(x, (H,), ln_w, ln_b), w_in, b_in).chunk(3, -1)
        q, k, v = (t.reshape(M_, T, nh, H // nh).transpose(1, 2) for t in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(M_, T, H)
        return x + F.linear(o, w_out, b_out)

    out = {}
    with torch.no_grad():
        out["fwd_ms"] = cuda_ms(lambda: ab.attention_block(xb, *ops, c, eps, nh), iters=10)
        x32 = xb.float()
        out["fwd_ms_fp32"] = cuda_ms(lambda: ab.attention_block(x32, *ops, c, eps, nh), iters=2,
                                     warmup=1)
        del x32
        out["fwd_plain_ms"] = cuda_ms(lambda: ab.reference(xb, *ops, c, eps, nh), iters=2,
                                      warmup=1)
        out["fwd_library_ms"] = cuda_ms(lambda: library(xb, *params), iters=10)
    out["bwd_ms"] = cuda_ms(lambda: ab.backward(xt, *ops[:3], gb, eps, nh), iters=5)
    xt32, gt32 = xt.float(), gb.float()
    out["bwd_ms_fp32"] = cuda_ms(lambda: ab.backward(xt32, *ops[:3], gt32, eps, nh), iters=2,
                                 warmup=1)
    del xt32, gt32
    out["bwd_plain_ms"] = cuda_ms(lambda: ab.reference_bwd(xt, *ops[:3], gb, eps, nh), iters=2,
                                  warmup=1)
    leaves = [t.detach().clone().requires_grad_() for t in (xt, *params)]
    yl = library(*leaves)  # graph built once
    out["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(yl, leaves, gb,
                                                                retain_graph=True), iters=5)
    del yl, leaves
    op_bytes = sum(t.numel() * t.element_size() for t in ops[:4])
    flops = T * H * 3 * H * 2 + 2 * 2 * T * T * H + 2 * T * H * H  # a sequence, unfolded
    out["fwd_bound_ms"], out["fwd_bound_by"] = bound(2 * xb.numel() * 2 + op_bytes, M * flops)
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(3 * gb.numel() * 2 + 2 * op_bytes,
                                                     2 * Mt * flops)
    out.update(M=M, M_bwd=Mt, T=T, H=H, nh=nh)
    return out


def large_phases(dev):
    """Phases 40-44: rows 1-2 on the wide route (H = 192 and T > 256),
    SpatialNet-large serving (also at 16 s) and training, NBC2-large. Returns
    the wide routes' two rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from nbss_tpu_torch import check_gradients
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.models.nbc2 import NBC2
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention as att
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops import tconvffn
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.module import TrainModule

    H, nh, n_layers = LARGE["dim_hidden"], LARGE["num_heads"], LARGE["num_layers"]
    n_freq = LARGE["num_freqs"]
    T = int(SECONDS * FS) // 128 + 1
    T_long = int(LONG_SECONDS * FS) // 128 + 1
    M, Mt, M_long = B * n_freq, B_TRAIN * n_freq, B_LONG * n_freq
    gen = torch.Generator().manual_seed(11)
    large = SpatialNet(**dict(LARGE, num_layers=1), generator=gen, device=dev).layers[0]
    small = SpatialNet(**dict(FLAGSHIP, num_layers=1), generator=gen, device=dev).layers[0]
    ln, A, Wvo, c, eps = fold_block(large, nh)
    ops = (ln, A, Wvo)

    # 40. rows 1-2 on the wide route
    log(f"phase 40/62 attention_block's wide route vs plain: forward M={M}, backward M={Mt}, "
        f"T={T} H={H} nh={nh}; M = {M_EDGE}, T = 1 ... {T_long} at H = 96 and 192, nh 2, 3, 4")
    counts0 = wide_counts()
    n_fwd = n_bwd = 0  # wide launches expected, half of each in bf16
    xb = torch.randn(M, T, H, generator=gen).to(dev).to(torch.bfloat16)
    gb = torch.randn(Mt, T, H, generator=gen).to(dev).to(torch.bfloat16)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        with torch.no_grad():
            y = ab.attention_block(xb.to(dtype), *ops, c, eps, nh)
            relaunched(f"{key} wide forward", [y], [ab.attention_block(xb.to(dtype), *ops, c, eps,
                                                                       nh)])
            want = ab.reference(xb.float(), *ops, c, eps, nh)
            if dtype == torch.float32:
                torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
                fwd_err = (y - want).abs().max().item()
            else:
                fwd_err, = bf16_rule("bf16 wide forward", [y], [want],
                                     [ab.reference(xb, *ops, c, eps, nh)], 2e-4, 1e-4)
            del y, want
        _, bwd_err = check_wide_block(f"{key} wide at (M, T) = ({Mt}, {T})", xb[:Mt].to(dtype),
                                      gb.to(dtype), ops, c, eps, nh)
        n_fwd, n_bwd = n_fwd + 4, n_bwd + 2
        errs[key] = (fwd_err, bwd_err)
        log(f"{key}: forward max |kernel - plain| {fwd_err:.3e}; backward " + ", ".join(
            f"{n} {e:.3e}" for n, e in bwd_err.items()) + "; within the bounds, relaunches "
            "bit-identical")
    edges = []
    for layer, width, heads in ((small, 96, 4), (small, 96, 3), (small, 96, 2), (large, 192, 4),
                                (large, 192, 3), (large, 192, 2)):
        opse = fold_block(layer, heads)
        for Te in WIDE_EDGES[width]:
            for dtype in (torch.float32, torch.bfloat16):
                xe, ge = (torch.randn(M_EDGE, Te, width, generator=gen).to(dev).to(dtype)
                          for _ in range(2))
                check_wide_block(f"{dtype} (H, nh, T) = {(width, heads, Te)}", xe, ge,
                                 opse[:3], opse[3], opse[4], heads)
                n_fwd += 2 * ab.is_wide(Te, width)
                n_bwd += 2 * ab.is_wide(Te, width)
        edges.append((width, heads))
    log(f"M = {M_EDGE} at T = {WIDE_EDGES[192]} (H 192) and {WIDE_EDGES[96]} (H 96) for (H, nh) "
        "in " + ", ".join(map(str, edges)) + ", fp32 and bf16, forward and backward: within the "
        "bounds, relaunches bit-identical")
    xl = torch.randn(M_long, T_long, H, generator=gen).to(dev).to(torch.bfloat16)
    gl = torch.randn(M_long, T_long, H, generator=gen).to(dev).to(torch.bfloat16)
    errs_long = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs_long[str(dtype).split(".")[1]] = check_wide_block(
            f"{dtype} wide at (M, T) = ({M_long}, {T_long})", xl.to(dtype), gl.to(dtype), ops, c,
            eps, nh)
        n_fwd, n_bwd = n_fwd + 2, n_bwd + 2
    log(f"(M, T) = ({M_long}, {T_long}): forward fp32 {errs_long['float32'][0]:.3e}, bf16 "
        f"{errs_long['bfloat16'][0]:.3e}; within the bounds, relaunches bit-identical")
    counts = tuple(a - b for a, b in zip(wide_counts(), counts0))
    if counts != (n_fwd, n_fwd // 2, n_bwd, n_bwd // 2):
        raise AssertionError(f"wide launches {counts}, expected {n_fwd} forward and {n_bwd} "
                             "backward, half of each on the tensor cores")
    times = wide_block_times(large, xb, gb, ops, c, eps, nh)
    times_long = wide_block_times(large, xl, gl, ops, c, eps, nh)
    for label, t in (("serving/training shape", times), (f"T = {T_long}", times_long)):
        log(f"wide route at the {label}, nh {nh}: forward M={t['M']} bf16 {t['fwd_ms']:.3f} ms "
            f"(fp32 {t['fwd_ms_fp32']:.3f}), plain {t['fwd_plain_ms']:.3f}, library "
            f"{t['fwd_library_ms']:.3f}, bound {t['fwd_bound_ms']:.4f} ({t['fwd_bound_by']}); "
            f"backward M={t['M_bwd']} bf16 {t['bwd_ms']:.3f} ms (fp32 {t['bwd_ms_fp32']:.3f}), "
            f"plain {t['bwd_plain_ms']:.3f}, library {t['bwd_library_ms']:.3f}, bound "
            f"{t['bwd_bound_ms']:.4f} ({t['bwd_bound_by']})")
    ops2 = fold_block(large, 2)
    times_nh2 = wide_block_times(large, xb, gb, ops2[:3], ops2[3], eps, 2)
    log(f"wide route at nh 2 (NBC2-large's heads of 96): forward bf16 {times_nh2['fwd_ms']:.3f} "
        f"ms, library {times_nh2['fwd_library_ms']:.3f}; backward bf16 "
        f"{times_nh2['bwd_ms']:.3f} ms, library {times_nh2['bwd_library_ms']:.3f}")
    del xl, gl
    # SpatialNet-small's whole 16-s recordings (H 96, nh 4) take the wide route too
    opss = fold_block(small, FLAGSHIP["num_heads"])
    xs_long, gs_long = (torch.randn(M_long, T_long, FLAGSHIP["dim_hidden"], generator=gen).to(dev)
                        .to(torch.bfloat16) for _ in range(2))
    times_small = wide_block_times(small, xs_long, gs_long, opss[:3], opss[3], opss[4],
                                   FLAGSHIP["num_heads"])
    log(f"wide route at SpatialNet-small's 16-s shape (M={M_long}, T={T_long}, H 96, nh 4): "
        f"forward bf16 {times_small['fwd_ms']:.3f} ms (fp32 {times_small['fwd_ms_fp32']:.3f}), "
        f"plain {times_small['fwd_plain_ms']:.3f}, library {times_small['fwd_library_ms']:.3f}, "
        f"bound {times_small['fwd_bound_ms']:.4f} ({times_small['fwd_bound_by']}); backward bf16 "
        f"{times_small['bwd_ms']:.3f} ms, library {times_small['bwd_library_ms']:.3f}, bound "
        f"{times_small['bwd_bound_ms']:.4f}")
    del xs_long, gs_long
    # row 3 at SpatialNet-large's widths, (H, FF) = (192, 384), at its serving shape
    with torch.no_grad():
        pl = {k: v.detach().to(torch.bfloat16)
              for k, v in tconvffn.params_from_sequential(large.tconvffn).items()}
    ffn_large = tconvffn_times(xb, pl, LARGE["conv_groups"][1])
    log(f"tconvffn bf16 at (H, FF) = (192, 384), M={M}, T={T}: kernel {ffn_large['ms']:.3f} ms, "
        f"plain {ffn_large['plain_ms']:.3f}, library {ffn_large['library_ms']:.3f}, bound "
        f"{ffn_large['bound_ms']:.4f} ({ffn_large['bound_by']}: {ffn_large['bytes'] / 1e6:.0f} MB, "
        f"{ffn_large['ops'] / 1e9:.1f} GFLOP grouped)")
    del xb, gb, large, small, pl
    fresh_start()
    check_budget("wide route")

    # 41. SpatialNet-large serving, fused_ffn off and on
    log(f"phase 41/62 SpatialNet-large serving: TrainModule.forward + predict_step, B={B}, "
        f"{CHANNELS} ch, {SECONDS:g} s, bf16, fused_ffn off and on")
    net = SpatialNet(**LARGE, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    module = TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                         stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True))
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    target = (0.1 * torch.randn(B, 2, int(SECONDS * FS), generator=gen)).to(dev)
    serving, sdrs = {}, {}
    for fused_ffn in (False, True):
        arch = SpatialNet(**LARGE, dtype=torch.bfloat16, fused_ffn=fused_ffn, device=dev).eval()
        arch.load_state_dict(net.state_dict())
        m = TrainModule(**{**module.__dict__, "arch": arch})
        ab.launches = ab.tc_launches = ab.bwd_launches = 0
        ab.wide_launches = ab.wide_tc_launches = tconvffn.tc_launches = 0
        yr_hat, _ = m.forward(wave)
        pred = m.predict_step(wave, target)
        torch.cuda.synchronize()
        served = (ab.launches, ab.wide_tc_launches, ab.bwd_launches, tconvffn.tc_launches)
        check_outputs((("forward", yr_hat), ("predict_step", pred)), (B, 2, wave.shape[-1]))
        want = (2 * n_layers, 2 * n_layers, 0, 2 * n_layers * fused_ffn)
        log(f"fused_ffn {fused_ffn}: finite [{B}, 2, {wave.shape[-1]}]; attention_block launched "
            f"{served[0]} times ({served[1]} on the wide tensor-core kernel), its backward "
            f"{served[2]}; the T-ConvFFN's tensor-core kernel {served[3]}")
        if served != want:
            raise AssertionError(f"launches {served}, expected {want}")
        serve_s = seconds_per_call(lambda: m.predict_step(wave), 3)
        serving[fused_ffn] = (served, B * SECONDS / serve_s)
        log(f"serving: predict_step on {B} x {SECONDS:g} s in {serve_s * 1e3:.1f} ms = "
            f"{B * SECONDS / serve_s:.1f} audio-s/s")
        kernel32 = SpatialNet(**LARGE, fused_ffn=fused_ffn, device=dev).eval()
        kernel32.load_state_dict(net.state_dict())
        plain32 = SpatialNet(**LARGE, fused_block=False, device=dev).eval()
        plain32.load_state_dict(net.state_dict())
        w2 = wave[:B_LARGE_CHECK]
        y_kernel, _ = TrainModule(**{**module.__dict__, "arch": kernel32}).forward(w2)
        y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(w2)
        sdrs[fused_ffn] = si_sdr(y_kernel, y_plain).min().item()
        log(f"fp32 kernel path (fused_ffn {fused_ffn}) vs plain composition at "
            f"B={B_LARGE_CHECK}: min SI-SDR {sdrs[fused_ffn]:.1f} dB (bound >= 50)")
        if not sdrs[fused_ffn] >= 50.0:
            raise AssertionError(f"SI-SDR {sdrs[fused_ffn]:.1f} dB < 50 dB")
        del arch, m, kernel32, plain32, yr_hat, pred, y_kernel, y_plain
        fresh_start()
    check_budget("spatialnet-large serving")

    # 42. long utterances: 16 s, T = 1001
    log(f"phase 42/62 long-utterance serving: SpatialNet-small and -large, B={B_LONG} x "
        f"{LONG_SECONDS:g} s (T = {T_long}), bf16, through the wide route")
    wave_long = (0.1 * torch.randn(B_LONG, CHANNELS, int(LONG_SECONDS * FS), generator=gen)).to(dev)
    long_rates, long_sdrs = {}, {}
    for name, cfg in (("small", FLAGSHIP), ("large", LARGE)):
        arch = SpatialNet(**cfg, dtype=torch.bfloat16, generator=gen, device=dev).eval()
        m = TrainModule(**{**module.__dict__, "arch": arch})
        ab.launches = ab.wide_tc_launches = 0
        yr_hat, _ = m.forward(wave_long)
        pred = m.predict_step(wave_long)
        torch.cuda.synchronize()
        served = (ab.launches, ab.wide_tc_launches)
        check_outputs((("forward", yr_hat), ("predict_step", pred)),
                      (B_LONG, 2, wave_long.shape[-1]))
        if served != (2 * cfg["num_layers"],) * 2:
            raise AssertionError(f"SpatialNet-{name} at {LONG_SECONDS:g} s: launches {served}, "
                                 f"expected {cfg['num_layers']} a forward on the wide route")
        serve_s = seconds_per_call(lambda: m.predict_step(wave_long), 2)
        long_rates[name] = B_LONG * LONG_SECONDS / serve_s
        kernel32 = SpatialNet(**cfg, device=dev).eval()
        kernel32.load_state_dict(arch.state_dict())
        plain32 = SpatialNet(**cfg, fused_block=False, device=dev).eval()
        plain32.load_state_dict(arch.state_dict())
        y_kernel, _ = TrainModule(**{**module.__dict__, "arch": kernel32}).forward(wave_long[:1])
        y_plain, _ = TrainModule(**{**module.__dict__, "arch": plain32}).forward(wave_long[:1])
        long_sdrs[name] = si_sdr(y_kernel, y_plain).min().item()
        log(f"SpatialNet-{name}: finite [{B_LONG}, 2, {wave_long.shape[-1]}], {served[0]} wide "
            f"launches in two forwards; predict_step in {serve_s * 1e3:.1f} ms = "
            f"{long_rates[name]:.1f} audio-s/s; fp32 kernel path vs plain composition at B=1: "
            f"{long_sdrs[name]:.1f} dB (bound >= 50)")
        if not long_sdrs[name] >= 50.0:
            raise AssertionError(f"SI-SDR {long_sdrs[name]:.1f} dB < 50 dB")
        del arch, m, kernel32, plain32, yr_hat, pred, y_kernel, y_plain
        fresh_start()
    del wave_long
    check_budget("long-utterance serving")

    # 43. SpatialNet-large training
    log(f"phase 43/62 SpatialNet-large training: Trainer fits {B_TRAIN} SyntheticDataset items "
        f"for {TRAIN_STEPS} steps, Adam 1e-3, clip 5, neg-SI-SDR with PIT, bf16")
    batch = fixed_batch(B_TRAIN, CHANNELS, FS)
    losses = []
    trainer = trainer_of(TrainModule(**{**module.__dict__, "arch": SpatialNet(
        **LARGE, dtype=torch.bfloat16, device=dev)}), dev, losses)
    ab.launches = ab.bwd_launches = 0
    ab.wide_launches = ab.wide_tc_launches = ab.bwd_wide_launches = ab.bwd_wide_tc_launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fit = (ab.launches, ab.wide_tc_launches, ab.bwd_launches, ab.bwd_wide_tc_launches)
    check_losses(losses)
    log(f"launches in {TRAIN_STEPS} steps: {fit[0]} forward ({fit[1]} on the wide tensor-core "
        f"kernel) + {fit[2]} backward ({fit[3]}); peak memory {peak:.1f} GiB")
    if fit != (TRAIN_STEPS * n_layers,) * 4:
        raise AssertionError(f"expected {n_layers} forward and {n_layers} backward launches a "
                             "step, all on the wide tensor-core kernels")
    train_s = seconds_per_call(lambda: trainer.train_step(batch), 3)
    log(f"training: train_step on {B_TRAIN} x {SECONDS:g} s in {train_s * 1e3:.1f} ms = "
        f"{B_TRAIN * SECONDS / train_s:.1f} audio-s/s trained")
    depth = LARGE_DEPTH_CHECK
    cfg = dict(LARGE, num_layers=depth)
    state = {k: v for k, v in trainer.module.arch.state_dict().items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < depth}
    small_arch = SpatialNet(**cfg, device=dev)
    small_arch.load_state_dict(state)
    log(f"fp32 gradients at the trained weights of the first {depth} layers: kernel path vs "
        "plain composition (fp32 and float64 arch), one batch")
    grads = check_gradients.gradients(TrainModule(**{**module.__dict__, "arch": small_arch}),
                                      trainer.to_device(batch), cfg, dev)
    log(check_gradients.hold(grads))
    del grads, small_arch, trainer
    fresh_start()
    # at dropout 0.1 the block is off in training and the MHSA runs rows 4-5 at dh 48
    cfg = dict(LARGE, dropout=(0.1, 0.1, 0.1))
    losses_d = []
    trainer = trainer_of(TrainModule(**{**module.__dict__, "arch": SpatialNet(
        **cfg, dtype=torch.bfloat16, device=dev)}), dev, losses_d)
    ab.launches = ab.bwd_launches = 0
    att.launches = att.tc_launches = att.bwd_launches = att.bwd_tc_launches = 0
    trainer.fit([batch], max_epochs=DROPOUT_STEPS)
    torch.cuda.synchronize()
    dropped = (ab.launches, ab.bwd_launches, att.tc_launches, att.bwd_tc_launches)
    log(f"dropout (0.1, 0.1, 0.1), {DROPOUT_STEPS} steps: losses "
        f"{', '.join(f'{v:.3f}' for v in losses_d)}; attention_block {dropped[0]} + "
        f"{dropped[1]} launches, the narrow-band attention (dh {H // nh}) {dropped[2]} + "
        f"{dropped[3]} on the tensor-core kernels")
    if dropped != (0, 0, DROPOUT_STEPS * n_layers, DROPOUT_STEPS * n_layers) or not all(
            np.isfinite(losses_d)):
        raise AssertionError("expected the block off and rows 4-5 once a layer and step")
    del trainer
    fresh_start()
    check_budget("spatialnet-large training")

    # 44. NBC2-large
    nl2 = NBC2_LARGE_CFG["n_layers"]
    log(f"phase 44/62 NBC2-large (H {NBC2_LARGE_CFG['dim_hidden']}, "
        f"{NBC2_LARGE_CFG['n_heads']} heads, {nl2} layers): serving B={B} and "
        f"{NBC2_LARGE_STEPS} training steps at B={B_TRAIN}, bf16")
    net2 = NBC2(**NBC2_LARGE_CFG, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    module2 = TrainModule(**{**module.__dict__, "arch": net2, "loss": Loss(name="neg_sa_sdr",
                                                                           pit=True)})
    ab.launches = ab.wide_tc_launches = 0
    yr_hat, _ = module2.forward(wave)
    pred = module2.predict_step(wave)
    torch.cuda.synchronize()
    served2 = (ab.launches, ab.wide_tc_launches)
    check_outputs((("forward", yr_hat), ("predict_step", pred)), (B, 2, wave.shape[-1]))
    if served2 != (2 * nl2,) * 2:
        raise AssertionError(f"NBC2-large launches {served2}, expected {nl2} a forward on the "
                             "wide tensor-core kernel")
    serve2_s = seconds_per_call(lambda: module2.predict_step(wave), 3)
    kernel32 = NBC2(**NBC2_LARGE_CFG, device=dev).eval()
    kernel32.load_state_dict(net2.state_dict())
    plain32 = NBC2(**NBC2_LARGE_CFG, fused_block=False, attention_kernel=False, device=dev).eval()
    plain32.load_state_dict(net2.state_dict())
    y_kernel, _ = TrainModule(**{**module2.__dict__, "arch": kernel32}).forward(wave[:2])
    y_plain, _ = TrainModule(**{**module2.__dict__, "arch": plain32}).forward(wave[:2])
    sdr2 = si_sdr(y_kernel, y_plain).min().item()
    del kernel32, plain32, y_kernel, y_plain, yr_hat, pred
    log(f"serving: finite [{B}, 2, {wave.shape[-1]}], {served2[0]} wide launches in two "
        f"forwards; predict_step in {serve2_s * 1e3:.1f} ms = {B * SECONDS / serve2_s:.1f} "
        f"audio-s/s; fp32 kernel path vs plain composition at B=2: {sdr2:.1f} dB (bound >= 50)")
    if not sdr2 >= 50.0:
        raise AssertionError(f"NBC2-large SI-SDR {sdr2:.1f} dB < 50 dB")
    losses2 = []
    trainer = trainer_of(TrainModule(**{**module2.__dict__, "arch": NBC2(
        **NBC2_LARGE_CFG, dtype=torch.bfloat16, device=dev)}), dev, losses2)
    ab.wide_tc_launches = ab.bwd_wide_tc_launches = 0
    trainer.fit([batch], max_epochs=NBC2_LARGE_STEPS)
    torch.cuda.synchronize()
    fit2 = (ab.wide_tc_launches, ab.bwd_wide_tc_launches)
    train2_s = seconds_per_call(lambda: trainer.train_step(batch), 2)
    log(f"training: losses {', '.join(f'{v:.3f}' for v in losses2)}; {fit2[0]} + {fit2[1]} wide "
        f"tensor-core launches; train_step in {train2_s * 1e3:.1f} ms = "
        f"{B_TRAIN * SECONDS / train2_s:.1f} audio-s/s trained")
    if fit2 != (NBC2_LARGE_STEPS * nl2,) * 2 or not all(np.isfinite(losses2)):
        raise AssertionError(f"NBC2-large training: launches {fit2}, losses {losses2}")
    del trainer, net2, module2
    fresh_start()
    check_budget("nbc2-large")

    common = {"route": "cuda", "routes": {"bfloat16": "wgmma bf16", "float32": "fp32 FMA"}}
    row1 = {"name": "attention_block_wide", **common,
            "source": "nbss_tpu_torch/csrc/attention_block_wide_tc.cu",
            "source_fp32": "nbss_tpu_torch/csrc/attention_block_wide.cu",
            "replaces": "nbss_tpu/ops/attention_block.py:183",
            "launches": serving[False][0][0], "tc_launches": serving[False][0][1],
            "launches_training": fit[0], "max_abs_err": errs["float32"][0],
            "max_err_fp32": errs["float32"][0], "max_err_bf16": errs["bfloat16"][0],
            "ms": times["fwd_ms"], "ms_fp32": times["fwd_ms_fp32"],
            "plain_ms": times["fwd_plain_ms"], "bound_ms": times["fwd_bound_ms"],
            "bound_by": times["fwd_bound_by"], "library_ms": times["fwd_library_ms"],
            "M": M, "T": T, "H": H, "nh": nh,
            "t1001": {k: v for k, v in times_long.items() if not k.startswith("bwd")},
            "t1001_h96": {k: v for k, v in times_small.items() if not k.startswith("bwd")},
            "nh2": {k: v for k, v in times_nh2.items() if not k.startswith("bwd")},
            "serve_audio_s_per_s": serving[False][1],
            "serve_audio_s_per_s_fused_ffn": serving[True][1],
            "serve_sdr_db_fp32": sdrs[False], "serve_sdr_db_fp32_fused_ffn": sdrs[True],
            "long_serve_audio_s_per_s": long_rates, "long_sdr_db_fp32": long_sdrs,
            "nbc2_large": {"launches": served2[0], "serve_audio_s_per_s": B * SECONDS / serve2_s,
                           "sdr_db_fp32": sdr2, "train_audio_s_per_s":
                           B_TRAIN * SECONDS / train2_s}}
    row2 = {"name": "attention_block_wide_bwd", **common,
            "source": "nbss_tpu_torch/csrc/attention_block_wide_tc.cu",
            "source_fp32": "nbss_tpu_torch/csrc/attention_block_wide.cu",
            "replaces": "nbss_tpu/ops/attention_block.py:316",
            "launches": fit[2], "tc_launches": fit[3],
            "max_abs_err": max(errs["float32"][1].values()),
            "max_err_fp32": errs["float32"][1], "max_err_bf16": errs["bfloat16"][1],
            "ms": times["bwd_ms"], "ms_fp32": times["bwd_ms_fp32"],
            "plain_ms": times["bwd_plain_ms"], "bound_ms": times["bwd_bound_ms"],
            "bound_by": times["bwd_bound_by"], "library_ms": times["bwd_library_ms"],
            "M": Mt, "T": T, "H": H, "nh": nh,
            "t1001": {k: v for k, v in times_long.items() if not k.startswith("fwd")},
            "t1001_h96": {k: v for k, v in times_small.items() if not k.startswith("fwd")},
            "nh2": {k: v for k, v in times_nh2.items() if not k.startswith("fwd")},
            "train_audio_s_per_s": B_TRAIN * SECONDS / train_s, "train_peak_gib": peak,
            "nbc2_large_launches": fit2[1]}
    return row1, row2, {k: ffn_large[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "M", "T", "H", "FF")}


def scan_n_phases(dev, rows67):
    """Phases 45-46: rows 6-7 at state sizes above 16, which run in passes
    over groups of 16 states (N = 17 pads its second group), at the serving
    shape (forward) and the training shape (backward). Adds what they were
    checked at and their times to the two rows of the ``kernels`` line."""
    import torch

    from nbss_tpu_torch.ops import ssm

    T = int(SECONDS * FS) // 128 + 1
    Dm = 2 * ONLINE["dim_hidden"]
    M_serve, M_train = B * ONLINE["num_freqs"], B_TRAIN * ONLINE["num_freqs"]
    names = ("gx", "gdt", "gA", "gB", "gC", "gD")
    gen = torch.Generator().manual_seed(45)

    def bf16(ins):
        return [t.to(torch.bfloat16) if i in (0, 3, 4) else t for i, t in enumerate(ins)]

    # 45. kernels vs plain
    log(f"phase 45/62 selective_scan and its backward at N = {SCAN_N} (passes of "
        f"{ssm.STATE_GROUP} states) vs plain: forward at M={M_serve}, backward at M={M_train}, "
        f"T={T}, D={Dm}")
    checked = {}
    for N in SCAN_N:
        ins, gy = scan_inputs(gen, M_serve, T, Dm, N, torch.float32, dev)
        ssm.launches = 0
        y = ssm.selective_scan(*ins)
        torch.cuda.synchronize()
        want = ssm.reference(*ins)
        e32 = (y - want).abs().max().item()
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4, msg=f"fp32 scan N={N}")
        insb = bf16(ins)
        want = ssm.reference(*[t.float() for t in insb])
        yb = ssm.selective_scan(*insb)
        relaunched(f"bf16 scan N={N}", [yb], [ssm.selective_scan(*insb)])
        ebf, = bf16_rule(f"bf16 scan N={N}", [yb], [want], [ssm.reference(*insb)], 2e-4, 1e-4)
        if ssm.launches != 3:
            raise AssertionError(f"scan N={N}: {ssm.launches} kernel calls, expected 3")
        del y, yb, want, insb, ins, gy
        ins, gy = scan_inputs(gen, M_train, T, Dm, N, torch.float32, dev)
        ssm.bwd_launches = 0
        _, hb = ssm.forward(*ins, boundaries=True)
        got = ssm.backward(*ins, hb, gy)
        relaunched(f"fp32 scan backward N={N}", got, ssm.backward(*ins, hb, gy))
        want = ssm.reference_bwd(*ins, gy)
        b32 = {}
        for name, a, w in zip(names, got, want):
            b32[name] = (a - w).abs().max().item()
            torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=f"fp32 scan backward N={N} {name}")
        del got, want, hb
        insb, gyb = bf16(ins), gy.to(torch.bfloat16)
        _, hb = ssm.forward(*insb, boundaries=True)
        got = ssm.backward(*insb, hb, gyb)
        relaunched(f"bf16 scan backward N={N}", got, ssm.backward(*insb, hb, gyb))
        want = ssm.reference_bwd(*[t.float() for t in insb], gyb.float())
        plain = ssm.reference_bwd(*insb, gyb)
        bbf = {}
        for name, a, p_, w in zip(names, got, plain, want):
            e, ep = (a.float() - w).abs().max().item(), (p_.float() - w).abs().max().item()
            if not e <= max(2 * ep, 5e-3 * w.abs().max().item()):
                raise AssertionError(f"bf16 scan backward N={N} {name}: error {e} exceeds "
                                     f"max(2 x {ep}, 5e-3 x max|plain|)")
            bbf[name] = e
        if ssm.bwd_launches != 4:
            raise AssertionError(f"scan backward N={N}: {ssm.bwd_launches} kernel calls, "
                                 "expected 4")
        del got, want, plain, hb, ins, gy, insb, gyb
        torch.cuda.empty_cache()
        checked[N] = {"fwd_err_fp32": e32, "fwd_err_bf16": ebf, "bwd_err_fp32": b32,
                      "bwd_err_bf16": bbf}
        log(f"N={N}: forward fp32 {e32:.2e}, bf16 {ebf:.4f}; backward fp32 worst "
            f"{max(b32.values()):.2e}, bf16 worst {max(bbf.values()):.3e}; fp32 and bf16 "
            "relaunches bit-identical: ok")
    check_budget("scan at any N")

    # 46. times
    log(f"phase 46/62 selective_scan times at N = {SCAN_TIMED_N} beside N = 16 (CUDA events, "
        "bf16, after warm-up)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.split()[0])

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    times = {}
    for N in (16, *SCAN_TIMED_N):
        insb, gyb = scan_inputs(gen, M_serve, T, Dm, N, torch.bfloat16, dev)
        fwd_ms = cuda_ms(lambda: ssm.forward(*insb), iters=10)
        fwd_plain_ms = (cuda_ms(lambda: ssm.reference(*insb), iters=1, warmup=1)
                        if N != 16 else None)
        elems = M_serve * T * Dm * N
        fwd_bytes = nbytes(insb) + nbytes(insb[:1])  # inputs read once, y written once
        fwd_ops = 7 * elems + 3 * M_serve * T * Dm
        fwd_exp = elems / (16 * sms * mhz * 1e6) * 1e3  # exp(dt A), 16 an SM a clock
        del insb, gyb
        insb, gyb = scan_inputs(gen, M_train, T, Dm, N, torch.bfloat16, dev)
        _, hb = ssm.forward(*insb, boundaries=True)
        bwd_ms = cuda_ms(lambda: ssm.backward(*insb, hb, gyb), iters=5)
        bwd_plain_ms = (cuda_ms(lambda: ssm.reference_bwd(*insb, gyb), iters=1, warmup=0)
                        if N != 16 else None)
        elems_t = M_train * T * Dm * N
        bwd_bytes = 2 * nbytes(insb) + nbytes([gyb, hb])
        bwd_ops = 22 * elems_t + 6 * M_train * T * Dm
        bwd_exp = 2 * elems_t / (16 * sms * mhz * 1e6) * 1e3  # the recompute and the walk back
        del insb, gyb, hb
        torch.cuda.empty_cache()
        fb, fb_by = bound(fwd_bytes, fwd_ops, FP32_FLOP_PER_S)
        bb, bb_by = bound(bwd_bytes, bwd_ops, FP32_FLOP_PER_S)
        t = {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
             "fwd_bound_ms": max(fb, fwd_exp), "fwd_bound_by": "operations"
             if fwd_exp > fb or fb_by == "operations" else "bytes",
             "fwd_exp_floor_ms": fwd_exp, "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
             "bwd_bound_ms": max(bb, bwd_exp), "bwd_bound_by": "operations"
             if bwd_exp > bb or bb_by == "operations" else "bytes",
             "bwd_exp_floor_ms": bwd_exp, "fwd_mb": fwd_bytes / 1e6, "bwd_mb": bwd_bytes / 1e6}
        times[N] = t
        log(f"N={N}: forward {fwd_ms:.3f} ms (plain {fwd_plain_ms}), bound "
            f"{t['fwd_bound_ms']:.4f} ms ({t['fwd_bound_by']}: {fwd_bytes / 1e6:.0f} MB, "
            f"{fwd_exp:.4f} ms of exps); backward {bwd_ms:.3f} ms (plain {bwd_plain_ms}), "
            f"bound {t['bwd_bound_ms']:.4f} ms ({t['bwd_bound_by']}: {bwd_bytes / 1e6:.0f} MB, "
            f"{bwd_exp:.4f} ms of exps)")
    log(f"N=16, the single pass: forward {times[16]['fwd_ms']:.3f} ms, backward "
        f"{times[16]['bwd_ms']:.3f} ms; phase 15 read {rows67[0]['ms']:.3f} / "
        f"{rows67[1]['ms']:.3f} ms")
    check_budget("scan times at any N")
    for row, key in ((rows67[0], "fwd"), (rows67[1], "bwd")):
        row["checked_n"] = [4, 8, 16, *SCAN_N]  # phases 10-11 at N <= 16, 45 above
        row["n_checked"] = {N: {k: v for k, v in c.items() if k.startswith(key)}
                            for N, c in checked.items()}
        row["n_times"] = {N: {k[4:]: v for k, v in t.items() if k.startswith(key)}
                          for N, t in times.items()}


def _online_module(net):
    """OnlineSpatialNet's task: 6 channels, STFT 256/128, online utterance
    norm, neg-SNR with PIT."""
    from nbss_tpu_torch.io.loss import Loss
    from nbss_tpu_torch.io.norm import Norm
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.train.module import TrainModule

    return TrainModule(arch=net, channels=tuple(range(CHANNELS)), ref_channel=0,
                       stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="utterance", online=True),
                       loss=Loss(name="neg_snr", pit=True))


def online_trainer(module, dev, losses):
    """The config's optimizer: AdamW (1e-3, weight decay 1e-3), clip 5, seed 2."""
    from nbss_tpu_torch.train.loop import Trainer

    trainer = Trainer(module, optimizer=("AdamW", {"lr": 1e-3, "weight_decay": 1e-3}),
                      gradient_clip_val=5.0, seed=2, device=dev,
                      logger=lambda k, v, _: losses.append(v) if k.startswith("train/") else None)
    trainer.init()
    return trainer


def online_n_phases(dev):
    """Phases 47-48: OnlineSpatialNet mamba(64,4) serving and training, and
    mamba(16,4) with remat_policy='dots' as configs/onlineSpatialNet.yaml
    sets it. Returns their rates."""
    import numpy as np
    import torch

    from nbss_tpu_torch import check_gradients
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
    from nbss_tpu_torch.ops import ssm

    gen = torch.Generator().manual_seed(47)
    n_layers = ONLINE["num_layers"]
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    batch = fixed_batch(B_TRAIN, CHANNELS, FS)
    rates = {}

    # 47. mamba(64,4)
    cfg = dict(FLAGSHIP, attention=f"mamba({MAMBA_WIDE_N},4)")
    log(f"phase 47/62 OnlineSpatialNet {cfg['attention']}: serving B={B} x {SECONDS:g} s and "
        f"{WIDE_N_STEPS} training steps at B={B_TRAIN} (remat, dots), bf16")
    module = _online_module(OnlineSpatialNet(**cfg, dtype=torch.bfloat16, generator=gen,
                                             device=dev).eval())
    ssm.launches = ssm.bwd_launches = 0
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave)
    torch.cuda.synchronize()
    served = (ssm.launches, ssm.bwd_launches)
    check_outputs((("forward", yr_hat), ("predict_step", pred)), (B, 2, wave.shape[-1]))
    if served != (4 * n_layers, 0):
        raise AssertionError(f"mamba(64,4) serving: scan launches {served}, expected "
                             f"({4 * n_layers}, 0)")
    serve_s = seconds_per_call(lambda: module.predict_step(wave), 3)
    del module, yr_hat, pred
    fresh_start()
    losses = []
    trainer = online_trainer(_online_module(OnlineSpatialNet(
        **cfg, dtype=torch.bfloat16, remat=True, remat_policy="dots", device=dev)), dev, losses)
    torch.cuda.reset_peak_memory_stats()
    ssm.launches = ssm.bwd_launches = 0
    trainer.fit([batch], max_epochs=WIDE_N_STEPS)
    torch.cuda.synchronize()
    fit = (ssm.launches, ssm.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_s = seconds_per_call(lambda: trainer.train_step(batch), 2)
    rates["mamba64"] = {"serve_audio_s_per_s": B * SECONDS / serve_s,
                        "train_audio_s_per_s": B_TRAIN * SECONDS / train_s,
                        "train_peak_gib": peak, "launches": served[0], "fit_launches": fit}
    log(f"serving: {served[0]} scan launches in two forwards, predict_step in "
        f"{serve_s * 1e3:.1f} ms = {B * SECONDS / serve_s:.1f} audio-s/s; training: losses "
        f"{', '.join(f'{v:.3f}' for v in losses)}; {fit[0]} + {fit[1]} scan launches; "
        f"train_step in {train_s * 1e3:.1f} ms = {B_TRAIN * SECONDS / train_s:.1f} audio-s/s "
        f"trained; peak memory {peak:.1f} GiB")
    want = (WIDE_N_STEPS * 4 * n_layers, WIDE_N_STEPS * 2 * n_layers)
    if fit != want or len(losses) != WIDE_N_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"mamba(64,4) training: launches {fit}, expected {want}; "
                             f"losses {losses}")
    del trainer
    fresh_start()
    check_budget("mamba(64,4)")

    # 48. mamba(16,4), remat_policy='dots'
    log(f"phase 48/62 OnlineSpatialNet {DOTS['attention']} with remat_policy='dots' at "
        f"{DOTS['num_layers']} layers: {TRAIN_STEPS}-step fit at B={B_TRAIN}, fp32 gradients "
        "against full recomputation, rates and peak memory of both policies in turns")
    n_layers = DOTS["num_layers"]
    losses = []
    trainer = online_trainer(_online_module(OnlineSpatialNet(
        **DOTS, dtype=torch.bfloat16, remat=True, remat_policy="dots", device=dev)), dev,
        losses)
    ssm.launches = ssm.bwd_launches = 0
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit = (ssm.launches, ssm.bwd_launches)
    check_losses(losses)
    want = (TRAIN_STEPS * 4 * n_layers, TRAIN_STEPS * 2 * n_layers)
    if fit != want:
        raise AssertionError(f"dots training: scan launches {fit}, expected {want} (the "
                             "recompute runs the scan again)")
    log(f"scan launches {fit[0]} + {fit[1]} in {TRAIN_STEPS} steps (16 + 16 recomputed, 16 "
        "backward a step)")
    grads = check_gradients.gradients(
        trainer.module, trainer.to_device(batch), DOTS, dev, arch_cls=OnlineSpatialNet,
        kernel=dict(remat=True, remat_policy="dots"), plain=dict(remat=True),
        plain64=dict(remat=True, fused_scan=False, dtype=torch.float64))
    log("dots (kernel) vs full recomputation (plain32) and the plain scan in a float64 arch "
        "(plain64): " + check_gradients.hold(grads))
    del grads
    torch.cuda.empty_cache()
    arch = trainer.module.arch
    turns = []
    for policy in (None, "dots", "dots", None):
        arch.remat_policy = policy
        torch.cuda.reset_peak_memory_stats()
        step_s = seconds_per_call(lambda: trainer.train_step(batch), 3)
        turns.append((policy, B_TRAIN * SECONDS / step_s,
                      torch.cuda.max_memory_allocated() / 2 ** 30))
    arch.remat_policy = "dots"
    log("rates in turns: " + "; ".join(f"{p or 'full'} {r:.1f} audio-s/s trained, peak "
                                       f"{g:.1f} GiB" for p, r, g in turns))
    rates["mamba16_remat"] = {p or "full": {"train_audio_s_per_s": [r for q, r, _ in turns
                                                                     if q == p],
                                            "train_peak_gib": max(g for q, _, g in turns
                                                                  if q == p)}
                              for p in (None, "dots")}
    del trainer, arch
    fresh_start()
    check_budget("dots")
    return rates


def retention_phase(dev):
    """Phase 49: OnlineSpatialNet ret(2,share_qk) (configs/onlineSpatialNet.yaml's
    alternative, decays 4, 5, 9, 10): serving, streaming, training with
    remat_policy='dots', gradients. No kernel of the port runs: the
    retention's products are plain PyTorch, as they are plain XLA in the JAX
    package. Returns its rates."""
    import numpy as np
    import torch

    from nbss_tpu_torch import check_gradients
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
    from nbss_tpu_torch.ops.metrics import si_sdr

    gen = torch.Generator().manual_seed(49)
    log(f"phase 49/62 OnlineSpatialNet {RET['attention']}: serving B={B} x {SECONDS:g} s, "
        f"streaming B={B_STREAM}, {TRAIN_STEPS}-step fit at B={B_TRAIN} with "
        "remat_policy='dots', fp32 gradients")
    net = OnlineSpatialNet(**RET, dtype=torch.bfloat16, generator=gen, device=dev).eval()
    module = _online_module(net)
    wave = (0.1 * torch.randn(B, CHANNELS, int(SECONDS * FS), generator=gen)).to(dev)
    yr_hat, _ = module.forward(wave)
    pred = module.predict_step(wave)
    torch.cuda.synchronize()
    check_outputs((("forward", yr_hat), ("predict_step", pred)), (B, 2, wave.shape[-1]))
    serve_s = seconds_per_call(lambda: module.predict_step(wave), 3)
    net32 = OnlineSpatialNet(**RET, device=dev).eval()
    net32.load_state_dict(net.state_dict())
    y32, _ = _online_module(net32).forward(wave)
    sdr_bf16 = si_sdr(yr_hat, y32).min().item()
    log(f"serving: finite [{B}, 2, {wave.shape[-1]}]; predict_step in {serve_s * 1e3:.1f} ms = "
        f"{B * SECONDS / serve_s:.1f} audio-s/s; bf16 vs fp32 (chunkwise) min SI-SDR "
        f"{sdr_bf16:.1f} dB (reported)")
    del yr_hat, pred

    # streaming: the O(1)-state recurrence, frame by frame
    wave_s = wave[:B_STREAM, :, :int(STREAM_SECONDS * FS)].contiguous()
    n_frames = wave_s.shape[-1] // 128 + 1
    stream = {}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        rec = OnlineSpatialNet(**RET, chunkwise_recurrent=False, dtype=dtype, device=dev).eval()
        rec.load_state_dict(net.state_dict())
        m = _online_module(rec)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_str, _ = m.forward_streaming(wave_s)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        y_rec, _ = _online_module(lambda X, arch=rec: arch(X, inference=True)).forward(wave_s)
        y_chunk, _ = _online_module(net32 if dtype is None else net).forward(wave_s)
        if not torch.isfinite(y_str).all():
            raise AssertionError(f"{label} streaming output is not finite")
        stream[label] = (si_sdr(y_str, y_rec).min().item(), si_sdr(y_str, y_chunk).min().item(),
                         B_STREAM * STREAM_SECONDS / seconds)
        log(f"{label}: streaming vs forward(inference=True) min SI-SDR {stream[label][0]:.1f} dB, "
            f"vs the chunkwise forward {stream[label][1]:.1f} dB (reported); {n_frames} frames "
            f"in {seconds:.2f} s = {stream[label][2]:.2f} audio-s/s")
        del rec, m, y_str, y_rec, y_chunk
    if not stream["fp32"][0] >= 50.0:
        raise AssertionError(f"fp32 streaming vs the recurrent forward SI-SDR "
                             f"{stream['fp32'][0]:.1f} dB < 50")
    del net, net32, module
    fresh_start()
    check_budget("retention serving")

    batch = fixed_batch(B_TRAIN, CHANNELS, FS)
    losses = []
    trainer = online_trainer(_online_module(OnlineSpatialNet(
        **RET, dtype=torch.bfloat16, remat=True, remat_policy="dots", device=dev)), dev, losses)
    torch.cuda.reset_peak_memory_stats()
    trainer.fit([batch], max_epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_losses(losses)
    train_s = seconds_per_call(lambda: trainer.train_step(batch), 3)
    log(f"training: train_step in {train_s * 1e3:.1f} ms = {B_TRAIN * SECONDS / train_s:.1f} "
        f"audio-s/s trained; peak memory {peak:.1f} GiB")
    grads = check_gradients.gradients(
        trainer.module, trainer.to_device(batch), RET, dev, arch_cls=OnlineSpatialNet,
        kernel=dict(remat=True, remat_policy="dots"), plain=dict(remat=False),
        plain64=dict(remat=True, dtype=torch.float64), parts32=2)
    log("dots (kernel) vs remat=False (plain32) and a float64 arch (plain64): "
        + check_gradients.hold(grads))
    del grads, trainer
    fresh_start()
    check_budget("retention training")
    return {"serve_audio_s_per_s": B * SECONDS / serve_s, "serve_sdr_db_bf16_vs_fp32": sdr_bf16,
            "stream_audio_s_per_s_fp32": stream["fp32"][2],
            "stream_audio_s_per_s_bf16": stream["bf16"][2],
            "stream_sdr_db_fp32": stream["fp32"][0], "stream_sdr_db_bf16": stream["bf16"][0],
            "stream_vs_chunkwise_sdr_db_fp32": stream["fp32"][1],
            "train_audio_s_per_s": B_TRAIN * SECONDS / train_s, "train_peak_gib": peak}


# configs/datasets/device_synth.yaml's corpus as scripts/run_spatialnet_convergence.sh:23-26
# renders it, and configs/datasets/device_synth_moving.yaml's as
# scripts/run_moving_convergence.sh:28-30 does; RIR_NUMS rooms of each (train, val, test)
STATIC_SIM = ["--spk_num=2", "--noise_num=0", "--arr_geometry=circular+cm", "--mic_num=6",
              "--fs=8000", "--RT60_lim", "0.1", "0.6", "--length_round=2048", "--seed=0"]
MOVING_SIM = ["--spk_num=2", "--fs=8000", "--trajectory=4points+sin,0.5", "--seed=0"]
RIR_NUMS, MOVING_RIR_NUMS = (8, 2, 2), (2, 1, 1)
CLI_ITEMS, CLI_EPOCHS = [32, 8, 4, 4], 2  # items a stage; 4 steps of B=8 an epoch
MOVING_STEPS = 2
MIX_EPOCHS = 3  # train loaders timed by phase 51 (4 batches of 8 each)


def _sim_args(rir_dir: str, flags, nums) -> list:
    return [f"--rir_dir={rir_dir}", *flags, "--rir_nums", *map(str, nums)]


def _rendered(rir_dir: str, flags, nums, label: str) -> float:
    """Render a corpus through ``python -m nbss_tpu_torch.sim.generate``'s
    main on the card; returns seconds a room."""
    import torch

    from nbss_tpu_torch.sim.generate import main as generate

    t1 = time.perf_counter()
    generate(_sim_args(rir_dir, flags, nums))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    n = sum(nums)
    log(f"{label}: {n} rooms rendered on the card in {seconds:.2f} s = {seconds / n:.3f} s a room")
    return seconds / n


def _cli(sub: str, args: list, extra=()) -> dict:
    from nbss_tpu_torch.cli.main import run

    return run([sub, *args, *extra])


def _ab_counts():
    from nbss_tpu_torch.ops import attention_block as ab

    return (ab.launches, ab.tc_launches, ab.bwd_launches, ab.bwd_tc_launches,
            ab.wide_launches + ab.bwd_wide_launches)


def _zero_counts() -> None:
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops import ssm

    ab.launches = ab.tc_launches = ab.bwd_launches = ab.bwd_tc_launches = 0
    ab.wide_launches = ab.bwd_wide_launches = 0
    ssm.launches = ssm.bwd_launches = 0


def training_runs(dev, fixed_rate: float, tmp: str) -> dict:
    """Phases 50-54: the two committed training runs as users launch them.
    Rooms rendered on the card, mixtures made on the card, ``fit`` through
    the command line with SpatialNet-small, then ``validate``/``test``/
    ``predict`` and a resumed ``fit``, then OnlineSpatialNet on the moving
    corpus; files go under ``tmp``. Returns numbers for the ``kernels`` line."""
    import numpy as np
    import torch

    from nbss_tpu_torch.cli import yamlio
    from nbss_tpu_torch.cli.config import instantiate, load_configs
    from nbss_tpu_torch.cli.main import build_module
    from nbss_tpu_torch.data.device_mix import DeviceSyntheticDataModule, mix_draws
    from nbss_tpu_torch.ops import ssm
    from nbss_tpu_torch.sim.config import RirConfigSampler
    from nbss_tpu_torch.sim.ism import simulate_direct_path, simulate_rir
    from nbss_tpu_torch.train.loop import Trainer

    out = {}
    rir_dir = os.path.join(tmp, "rir8k")
    # 50. rooms
    log(f"phase 50/62 rooms: nbss_tpu_torch.sim.generate with "
        f"run_spatialnet_convergence.sh's flags, --rir_nums {' '.join(map(str, RIR_NUMS))}")
    out["sim_s_per_room"] = _rendered(rir_dir, STATIC_SIM, RIR_NUMS, "static corpus")
    par = RirConfigSampler(spk_num=2, noise_num=0, arr_geometry="circular+cm", mic_num=6,
                           fs=FS, RT60_lim=(0.1, 0.6), seed=0).sample(0)
    args = (par["room_sz"], par["pos_src"], par["pos_rcv"], par["RT60"], FS)
    kw = dict(beta=par.get("beta"), length_round=2048)
    card = np.load(os.path.join(rir_dir, "train", "0.npz"), allow_pickle=True)["rir"]
    t1 = time.perf_counter()
    cpu = simulate_rir(*args, **kw, device="cpu")
    cpu_s = time.perf_counter() - t1
    again = simulate_rir(*args, **kw, device=dev)
    err, scale = float(np.abs(card - cpu).max()), float(np.abs(cpu).max())
    log(f"room 0 (RT60 {par['RT60']:.3f} s, rir {card.shape}): card vs CPU max |diff| "
        f"{err:.3e} = {err / scale:.2e} x max|rir| (bound 1e-4); the CPU took {cpu_s:.1f} s; "
        f"a second render on the card bit-identical: {np.array_equal(card, again)}")
    if card.shape != cpu.shape or not err <= 1e-4 * scale:
        raise AssertionError(f"room 0: card vs CPU {err} > 1e-4 x {scale}")
    if not np.array_equal(card, again):
        raise AssertionError("room 0: two renders on the card differ")
    d, c = 2.0, 343.0
    dp = simulate_direct_path([5.0, 4.0, 3.0], [1.0, 2.0, 1.5], [[3.0, 2.0, 1.5]], FS,
                              device=dev)[0, 0]
    peak, gain = int(np.argmax(np.abs(dp))), float(dp.sum())
    log(f"direct path at {d} m: peak at sample {peak} (d / c = {d / c * FS:.2f}), sum "
        f"{gain:.6f} (1 / (4 pi d) = {1 / (4 * np.pi * d):.6f})")
    if abs(peak - d / c * FS) > 1 or abs(gain * 4 * np.pi * d - 1) > 1e-3:
        raise AssertionError("direct path: delay or amplitude off")
    check_budget("rooms")

    # 51. mixtures
    log("phase 51/62 mixtures: DeviceSyntheticDataModule at device_synth.yaml's settings, "
        "preloaded, B=8 on the card against the CPU")
    init = load_configs(["configs/datasets/device_synth.yaml"])["data"]["init_args"]
    kw = dict(init, rir_dir=rir_dir, num_items=CLI_ITEMS, preload_rir=True,
              seeds=(5, 2, 3, 3))
    dms = {name: DeviceSyntheticDataModule(**kw, device=name) for name in ("cuda", "cpu")}
    batches = {name: next(iter(dm.train_dataloader())) for name, dm in dms.items()}
    (x, ys, paras), (xc, ysc, parasc) = batches["cuda"], batches["cpu"]
    if [p["seed"] for p in paras] != [p["seed"] for p in parasc] or \
            [p["rir_file"] for p in paras] != [p["rir_file"] for p in parasc]:
        raise AssertionError("host picks (seeds, rooms) differ between the card and the CPU")
    seeds = torch.tensor([p["seed"] % 2 ** 31 for p in paras])
    draws = {name: mix_draws(dm.stage_key(0), seeds, dm.ovlp, dm.speech_overlap_ratio,
                             int(4.0 * FS), len(dm.noise_type)) for name, dm in dms.items()}
    for k in ("keys", "ks", "lens", "shifts", "noise_type"):
        if not torch.equal(draws["cuda"][k].cpu(), draws["cpu"][k]):
            raise AssertionError(f"draw {k} differs between the card and the CPU")
    errs = {n: float((a.cpu() - b).abs().max()) for n, a, b in (("x", x, xc), ("ys", ys, ysc))}
    log(f"train batch {tuple(x.shape)}, {tuple(ys.shape)}: seeds, rooms, keys, segments and "
        f"noise types equal; card vs CPU max |diff| x {errs['x']:.2e}, ys {errs['ys']:.2e} "
        "(atol 2e-5, rtol 1e-4)")
    torch.testing.assert_close(x.cpu(), xc, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(ys.cpu(), ysc, atol=2e-5, rtol=1e-4)
    out["mix_max_abs_err"] = max(errs.values())
    dm = dms["cuda"]
    for _ in dm.train_dataloader(0):  # warm-up
        pass
    torch.cuda.synchronize()
    n, t1 = 0, time.perf_counter()
    for epoch in range(MIX_EPOCHS):
        for xb, _, _ in dm.train_dataloader(epoch):
            n += xb.shape[0]
    torch.cuda.synchronize()
    out["mixtures_per_s"] = n / (time.perf_counter() - t1)
    log(f"{n} mixtures (B=8, 6 ch x 4 s) made at {out['mixtures_per_s']:.1f} mixtures/s "
        "(host picks, index upload and mixing)")
    del dms, dm, batches, x, ys, xc, ysc
    fresh_start()
    check_budget("mixtures")

    # 52. fit through the command line
    logs = os.path.join(tmp, "logs")
    args = ["--config=configs/SpatialNet.yaml", "--config=configs/datasets/device_synth.yaml",
            "--trainer.precision=bf16-mixed", f"--data.init_args.rir_dir={rir_dir}",
            f"--data.init_args.num_items={CLI_ITEMS}", f"--log_root={logs}",
            "--model.val_host_metrics=[STOI, eSTOI]", "--model.val_host_metrics_every=1"]
    steps = CLI_EPOCHS * CLI_ITEMS[0] // 8
    log(f"phase 52/62 fit: python -m nbss_tpu_torch.cli fit --config=configs/SpatialNet.yaml "
        f"--config=configs/datasets/device_synth.yaml, full width, bf16-mixed, {CLI_EPOCHS} "
        f"epochs of {CLI_ITEMS[0] // 8} steps at B=8, host metrics STOI/eSTOI every epoch")
    _zero_counts()
    fit = _cli("fit", args, [f"--trainer.max_epochs={CLI_EPOCHS}"])
    torch.cuda.synchronize()
    counts = _ab_counts()
    log_dir = fit["log_dir"]
    n_layers = FLAGSHIP["num_layers"]
    val_forwards = CLI_EPOCHS * 2  # one validation batch and one host-metric batch an epoch
    want = (n_layers * (steps + val_forwards),) * 2 + (n_layers * steps,) * 2 + (0,)
    log(f"attention_block launches: {counts[0]} forward ({counts[1]} tensor-core), "
        f"{counts[2]} backward ({counts[3]} tensor-core), {counts[4]} wide; "
        f"{steps} steps and {val_forwards} validation forwards: {n_layers} + {n_layers} a step")
    if counts != want:
        raise AssertionError(f"CLI fit launches {counts}, expected {want}")
    records = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    losses = [r["value"] for r in records if r["key"] == "train/neg_si_sdr"]
    host = {r["key"]: r["value"] for r in records if r["key"] in ("val/STOI", "val/eSTOI")}
    files = ["config.yaml", "provenance.txt", "model.txt", "metrics.jsonl",
             "checkpoints/epoch0/params", "checkpoints/epoch1/params"]
    missing = [f for f in files if not os.path.exists(os.path.join(log_dir, f))]
    log(f"{os.path.basename(log_dir)}: epoch losses {losses}, {host}, files present: "
        f"{not missing}")
    if len(losses) != CLI_EPOCHS or not np.isfinite(losses).all() or missing or \
            set(host) != {"val/STOI", "val/eSTOI"}:
        raise AssertionError(f"CLI fit: losses {losses}, host metrics {host}, "
                             f"missing {missing}")
    if yamlio.load(os.path.join(log_dir, "config.yaml"))["data"]["init_args"]["rir_dir"] != \
            rir_dir:
        raise AssertionError("config.yaml does not hold the run's config")
    out["cli_fit_launches"] = counts
    # the rate of the path the CLI runs: mixing on the card and the train step, B=8
    cfg = load_configs(["configs/SpatialNet.yaml", "configs/datasets/device_synth.yaml"],
                       {"data.init_args.rir_dir": rir_dir,
                        "data.init_args.num_items": CLI_ITEMS})
    data = instantiate(cfg["data"], device=str(dev))
    trainer = Trainer(build_module(cfg, dev), device=dev)
    trainer.init()
    for batch in data.train_dataloader(0):  # warm-up epoch
        trainer.train_step(batch)
    torch.cuda.synchronize()
    n, t1 = 0, time.perf_counter()
    for epoch in (1, 2):
        for batch in data.train_dataloader(epoch):
            trainer.train_step(batch)
            n += batch[0].shape[0]
    torch.cuda.synchronize()
    out["cli_train_audio_s_per_s"] = n * SECONDS / (time.perf_counter() - t1)
    log(f"training rate with mixing on the card: {out['cli_train_audio_s_per_s']:.1f} "
        f"audio-s/s ({n} items); phase 9's fixed batch: {fixed_rate:.1f} audio-s/s")
    del trainer, data
    fresh_start()
    check_budget("CLI fit")

    # 53. validate, test, predict, resume
    ckpt = os.path.join(log_dir, "checkpoints", f"epoch{CLI_EPOCHS - 1}")
    log(f"phase 53/62 validate, test (the config's metrics), predict and a resumed fit "
        f"from {os.path.relpath(ckpt, tmp)}")
    _zero_counts()
    val = _cli("validate", args, ["--ckpt_path", ckpt])
    test = _cli("test", args, ["--ckpt_path", ckpt])
    pred = _cli("predict", args, ["--ckpt_path", ckpt])
    resumed = _cli("fit", args, ["--ckpt_path", ckpt, f"--trainer.max_epochs={CLI_EPOCHS + 1}"])
    torch.cuda.synchronize()
    counts = _ab_counts()
    test_dir = test["log_dir"]
    results = [f for f in os.listdir(test_dir) if f.startswith("results_")]
    wavs = [f for f in os.listdir(os.path.join(pred["log_dir"], "examples"))
            if f.endswith(".wav")]
    shown = {k: round(v, 3) for k, v in test.items() if isinstance(v, float)
             and k != "id" and not k.startswith("input_") and not k.endswith("_i")}
    log(f"validate: val/metric {val['val/metric']:.3f}; test over {test['num_items']} items: "
        f"{shown}; files {sorted(results)}; predict wrote {len(wavs)} WAVs; resumed fit in "
        f"{os.path.basename(resumed['log_dir'])}, train loss {resumed['train_loss']:.3f}; "
        f"attention_block launches {counts}")
    need = {"SDR", "SI_SDR", "eSTOI"}
    if not (np.isfinite(val["val/metric"]) and test["num_items"] == CLI_ITEMS[2]
            and need <= set(test) and ("NB_PESQ" in test or "NB_PESQ_est" in test)
            and "results_mean.json" in results and "results_incremental.jsonl" in results
            and len(results) == 3 and len(wavs) == 2 * CLI_ITEMS[3]
            and os.path.abspath(resumed["log_dir"]) == os.path.abspath(log_dir)
            and os.path.exists(os.path.join(log_dir, "checkpoints",
                                            f"epoch{CLI_EPOCHS}", "params"))
            and np.isfinite(resumed["train_loss"])):
        raise AssertionError(f"subcommands: validate {val}, test {test}, predict {pred}, "
                             f"resumed {resumed}, results {results}, wavs {len(wavs)}")
    if counts[1] != counts[0] or counts[3] != counts[2] or counts[2] != \
            n_layers * CLI_ITEMS[0] // 8:
        raise AssertionError(f"subcommands' launches {counts}: not all on the tensor-core "
                             "kernels, or not one epoch of backward launches")
    fresh_start()
    check_budget("subcommands")

    # 54. the moving run
    mdir = os.path.join(tmp, "rir8k_moving")
    log(f"phase 54/62 moving run: sim.generate with run_moving_convergence.sh's flags, "
        f"--rir_nums {' '.join(map(str, MOVING_RIR_NUMS))}; fit configs/onlineSpatialNet.yaml "
        f"+ device_synth_moving.yaml, {MOVING_STEPS} steps at B=8")
    out["moving_sim_s_per_room"] = _rendered(mdir, MOVING_SIM, MOVING_RIR_NUMS,
                                             "moving corpus")
    margs = ["--config=configs/onlineSpatialNet.yaml",
             "--config=configs/datasets/device_synth_moving.yaml",
             "--trainer.precision=bf16-mixed", f"--data.init_args.rir_dir={mdir}",
             "--data.init_args.num_items=[16, 8, 4, 4]", "--trainer.max_epochs=1",
             f"--trainer.limit_train_batches={MOVING_STEPS}", f"--log_root={logs}"]
    _zero_counts()
    moving = _cli("fit", margs)
    torch.cuda.synchronize()
    scans = (ssm.launches, ssm.bwd_launches)
    want = (4 * n_layers * MOVING_STEPS + 2 * n_layers, 2 * n_layers * MOVING_STEPS)
    log(f"{os.path.basename(os.path.dirname(moving['log_dir']))}/"
        f"{os.path.basename(moving['log_dir'])}: train loss {moving['train_loss']:.3f}, "
        f"val/metric {moving['val/metric']:.3f}; scan launches {scans[0]} + {scans[1]} "
        f"({4 * n_layers} + {2 * n_layers} a step under remat_policy='dots', "
        f"{2 * n_layers} for the validation batch)")
    if scans != want or not np.isfinite(moving["train_loss"]):
        raise AssertionError(f"moving fit: scan launches {scans}, expected {want}; "
                             f"loss {moving['train_loss']}")
    out["moving_fit_launches"] = scans
    fresh_start()
    check_budget("moving run")
    return out


# phases 55-57: fixture corpora in each corpus's layout, written from speech-like sources
# (data/device_mix.py's synth_speech) with the port's write_audio; rooms from sim.generate
CORPUS_ITEMS = 12  # SMS-WSJ-Plus items (utterance pairs) a split
CORPUS_SECONDS = (3.0, 10.0)  # utterance lengths; the test split's first 4 pairs under 4 s
SMS_STEPS = 6  # phase 55's fit: steps at sms_wsj_plus.yaml's B = 2, then its validation split
# items each of phase 55's rates is timed over, after one batch that starts the loader;
# ``--corpus-rates`` times RATE_ITEMS_LONG and traces the card's busy share over TRACE_ITEMS
RATE_ITEMS, RATE_ITEMS_LONG, TRACE_ITEMS = 24, 288, 16  # 32 until phases 58-60 needed the time
# CHiME3-moving (README's generate flags for it): single-speaker trajectories, 5 cm apart
CHIME3_TRAJECTORY = ("4points+sin", 0.05)
CHIME3_SIM = ["--spk_num=1", "--noise_num=0", "--arr_geometry=chime3", "--mic_num=6", "--fs=8000",
              f"--trajectory={CHIME3_TRAJECTORY[0]},{CHIME3_TRAJECTORY[1]}", "--seed=0"]
CHIME3_RIR_NUMS, CHIME3_STEPS = (2, 1, 1), 3
BACKGROUND_SECONDS = 60  # each of CHiME-3's six background channels at 16 kHz
# 16-kHz rooms for LibriCSS (its 7-mic array, up to 3 speakers), REVERB and the 4-speaker
# pairs (8-mic circular arrays)
LIBRICSS_SIM = ["--spk_num=3", "--noise_num=0", "--arr_geometry=libricss", "--fs=16000",
                "--RT60_lim", "0.2", "0.4", "--seed=0"]
REVERB_SIM = ["--spk_num=2", "--noise_num=0", "--arr_geometry=circular", "--mic_num=8",
              "--fs=16000", "--RT60_lim", "0.2", "0.7", "--seed=0"]


def speech(seconds, fs: int, seed: int, dev) -> list:
    """Speech-like utterances of the given lengths (float32, peak 0.5), made
    on ``dev`` by data/device_mix.py's synth_speech."""
    import numpy as np

    from nbss_tpu_torch.data.device_mix import synth_speech
    from nbss_tpu_torch.utils import prng

    lengths = [int(s * fs) for s in seconds]
    keys = prng.split(prng.PRNGKey(seed), len(lengths)).to(dev)
    wavs = synth_speech(keys, max(lengths), fs).float().cpu().numpy()
    out = []
    for w, n in zip(wavs, lengths):
        w = w[:n]
        out.append((0.5 * (w - w.mean()) / np.abs(w).max()).astype(np.float32))
    return out


def write_sms_wsj_plus(root: str, dev) -> str:
    """SMS-WSJ-Plus's layout: sms_wsj.json naming each item's two WSJ
    utterances, wsj_8k_zeromean/*.wav, CORPUS_ITEMS items a split."""
    import numpy as np

    from nbss_tpu_torch.utils.audio_io import write_audio

    os.makedirs(os.path.join(root, "wsj_8k_zeromean"))
    rng = np.random.default_rng(55)
    info = {"datasets": {}}
    for si, split in enumerate(("train_si284", "cv_dev93", "test_eval92")):
        lengths = rng.uniform(*CORPUS_SECONDS, 2 * CORPUS_ITEMS)
        if split == "test_eval92":  # whole utterances of 4 s at most: rows 1-2's narrow route
            lengths[:8] = rng.uniform(CORPUS_SECONDS[0], 3.9, 8)
        wavs = speech(lengths, FS, si, dev)
        info["datasets"][split] = {}
        for k in range(CORPUS_ITEMS):
            paths = []
            for s in range(2):
                rel = f"wsj_8k_zeromean/{split}/{k:03d}_{s}.wav"
                os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
                write_audio(os.path.join(root, rel), wavs[2 * k + s], FS)
                paths.append(f"/data/sms_wsj/{rel}")  # the json's paths are the original host's
            info["datasets"][split][f"{split}_{k:03d}"] = {
                "audio_path": {"original_source": paths}}
    with open(os.path.join(root, "sms_wsj.json"), "w") as f:
        json.dump(info, f)
    return root


def write_chime3(root: str, dev):
    """CHiME3-moving's layout: wsj0/<split>/<speaker>/*.wav at 16 kHz and six
    16-kHz background channels under CHiME3/data/audio/16kHz/backgrounds/."""
    import numpy as np

    from nbss_tpu_torch.utils.audio_io import write_audio

    rng = np.random.default_rng(56)
    for si, (sub, spks) in enumerate((("si_tr_s", ("011", "012", "013")),
                                      ("si_dt_05", ("020",)), ("si_et_05", ("030",)))):
        for sj, spk in enumerate(spks):
            d = os.path.join(root, "wsj0", sub, spk)
            os.makedirs(d)
            for u, w in enumerate(speech(rng.uniform(*CORPUS_SECONDS, 3), 16000,
                                         100 * si + sj, dev)):
                write_audio(os.path.join(d, f"{spk}c020{u}.wav"), w, 16000)
    bg = os.path.join(root, "CHiME3", "data", "audio", "16kHz", "backgrounds")
    os.makedirs(bg)
    hum = np.sin(2 * np.pi * 50 * np.arange(16000 * BACKGROUND_SECONDS) / 16000)
    for ch in range(1, 7):
        wav = 0.05 * rng.standard_normal(hum.size) + 0.02 * np.roll(hum, 7 * ch)
        write_audio(os.path.join(bg, f"BGD_150203_010_CAF.CH{ch}.wav"), wav.astype(np.float32),
                    16000)
    return os.path.join(root, "wsj0"), os.path.join(root, "CHiME3")


def write_other_corpora(root: str, dev) -> dict:
    """Fixtures of the other corpora in their layouts; returns their roots."""
    import numpy as np

    from nbss_tpu_torch.data.sms_wsj import scenario_map
    from nbss_tpu_torch.utils.audio_io import write_audio

    rng = np.random.default_rng(57)
    paths = {k: os.path.join(root, k) for k in ("sms_wsj", "spwsj", "whamr", "librispeech",
                                                "noise", "libricss", "wsj0", "wsjcam0",
                                                "Reverb")}

    def wav(path, data, fs):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_audio(path, np.asarray(data, np.float32), fs)

    # official SMS-WSJ: sources, 6-channel RIR wavs, and observations made by scenario_map
    sms = paths["sms_wsj"]
    info = {"datasets": {}}
    for si, ds in enumerate(("train_si284", "cv_dev93", "test_eval92")):
        info["datasets"][ds] = {}
        srcs = speech(rng.uniform(3.0, 6.0, 4), FS, 570 + si, dev)
        for k in range(2):
            eid = f"{ds}_{k}"
            lens = [len(srcs[2 * k]), len(srcs[2 * k + 1])]
            offsets = [0, int(rng.integers(0, 4000))]
            ex = {"example_id": eid, "num_speakers": 2, "log_weights": [0.5, -0.5],
                  "offset": offsets, "sound_decay_time": 0.3,
                  "num_samples": {"observation": max(l + o for l, o in zip(lens, offsets)),
                                  "original_source": lens},
                  "audio_path": {"original_source": [], "rir": []}}
            rirs, dps = [], []
            for s in range(2):
                rel = f"wsj_8k_zeromean/{eid}_{s}.wav"
                wav(os.path.join(sms, rel), srcs[2 * k + s], FS)
                d = 30 + 9 * s
                rir = np.zeros((6, 2048))
                rir[:, d] = 1.0
                rir[:, d + 20:] += rng.standard_normal((6, 2028 - d)) * 0.05 * np.exp(
                    -np.arange(2028 - d) / 400)
                dp = np.zeros_like(rir)
                dp[:, d] = 1.0
                for sub, r in (("rirs", rir), ("rirs_direct_path", dp)):
                    wav(os.path.join(sms, sub, ds, f"{eid}_{s}.wav"), r.T, FS)
                ex["audio_path"]["original_source"].append(f"/data/sms_wsj/{rel}")
                ex["audio_path"]["rir"].append(f"/data/sms_wsj/rirs/{ds}/{eid}_{s}.wav")
                rirs.append(rir)
                dps.append(dp)
            work = dict(ex, audio_data={"original_source": [srcs[2 * k + s].astype(np.float64)
                                                            for s in range(2)],
                                        "rir": np.stack(rirs)})
            work = scenario_map(work, rir_target=np.stack(dps))
            wav(os.path.join(sms, "observation", ds, f"{eid}.wav"),
                work["audio_data"]["observation"].T, FS)
            info["datasets"][ds][eid] = ex
    with open(os.path.join(sms, "sms_wsj.json"), "w") as f:
        json.dump(info, f)

    # spatialized WSJ0-2mix (8 channels) and WHAMR! (2 channels), 3-6 s utterances
    for split in ("tr", "cv", "tt"):
        for u in range(2):
            s1, s2 = speech([rng.uniform(3.0, 6.0)] * 2, FS, 580 + u + 10 * len(split), dev)
            frames = len(s1)
            for target, C in (("reverb", 8), ("anechoic", 8)):
                d = os.path.join(paths["spwsj"], f"2speakers_{target}", "wav8k", "min", split)
                img = [np.roll(s[:, None] * (1 + 0.1 * np.arange(C)), 3, axis=0)
                       for s in (s1, s2)]
                wav(os.path.join(d, "s1", f"u{u}.wav"), img[0], FS)
                wav(os.path.join(d, "s2", f"u{u}.wav"), img[1], FS)
                wav(os.path.join(d, "mix", f"u{u}.wav"), img[0] + img[1], FS)
            d = os.path.join(paths["whamr"], "wav8k", "min", split)
            for name, x in (("s1_anechoic", s1), ("s2_anechoic", s2)):
                wav(os.path.join(d, name, f"u{u}.wav"), np.stack([x, x], -1), FS)
            noisy = np.stack([s1 + s2, s1 + s2], -1) + 0.01 * rng.standard_normal((frames, 2))
            wav(os.path.join(d, "mix_both_reverb", f"u{u}.wav"), noisy, FS)

    # LibriSpeech, recorded-noise stand-ins and the real LibriCSS utterances, at 16 kHz
    for sub in ("train-clean-100", "dev-clean", "test-clean"):
        for u, w in enumerate(speech(rng.uniform(3.0, 6.0, 3), 16000, 590 + len(sub), dev)):
            wav(os.path.join(paths["librispeech"], sub, "19", "198", f"19-198-{u:04d}.wav"), w,
                16000)
    wav(os.path.join(paths["noise"], "n0.wav"), 0.05 * rng.standard_normal((16000 * 12, 2)),
        16000)
    for sess in ("session0", "session1"):
        wav(os.path.join(paths["libricss"], "exp", "data", "7ch", "utterances", sess, "u0.wav"),
            0.1 * rng.standard_normal((16000 * 3, 7)), 16000)

    # 4 WSJ0 speakers at 16 kHz, two utterances of 4 s or more each
    for si, spk in enumerate(("024", "01y", "401", "02a")):
        for u, w in enumerate(speech(rng.uniform(4.5, 6.0, 2), 16000, 600 + si, dev)):
            wav(os.path.join(paths["wsj0"], "si_tr_s", spk, f"{spk}c010{u}.wav"), w, 16000)

    # REVERB: WSJCAM0 sources, the train and SimData tools' noise, the real evaluation set
    for sub in ("si_tr", "si_dt", "si_et"):
        for u, w in enumerate(speech(rng.uniform(3.0, 5.0, 2), 16000, 610 + len(sub), dev)):
            wav(os.path.join(paths["wsjcam0"], "data", "primary_microphone", sub, f"c0{u}.wav"),
                w, 16000)
    tools = os.path.join(paths["Reverb"], "reverb_tools_for_Generate_mcTrainData", "NOISE")
    for room in ("SmallRoom1", "MediumRoom1", "LargeRoom1"):
        wav(os.path.join(tools, f"Noise_{room}_1.wav"), 0.05 * rng.standard_normal((48000, 8)),
            16000)
    wav(os.path.join(paths["Reverb"], "reverb_tools_for_Generate_SimData", "NOISE",
                     "Noise_SimRoom1_1.wav"), 0.05 * rng.standard_normal((48000, 8)), 16000)
    wav(os.path.join(paths["Reverb"], "MC_WSJ_AV_Eval", "audio", "T10c0201.wav"),
        0.1 * rng.standard_normal((16000 * 3, 8)), 16000)
    return paths


def _attention_counts():
    from nbss_tpu_torch.ops import attention_block as ab

    return (ab.launches, ab.tc_launches, ab.wide_launches, ab.wide_tc_launches,
            ab.bwd_launches, ab.bwd_tc_launches, ab.bwd_wide_launches)


def corpus_runs(dev, tmp: str, fixed_rate: float) -> dict:
    """Phases 55-57: the public corpora through the command line and the
    threaded loader, from fixture corpora under ``tmp`` (phase 50's rooms
    for SMS-WSJ-Plus). Returns rates and launch counts."""
    out = sms_wsj_plus_phase(dev, tmp, fixed_rate)
    fresh_start()
    out.update(chime3_phase(dev, tmp))
    fresh_start()
    out.update(other_corpora_phase(dev, tmp))
    return out


def sms_wsj_plus_phase(dev, tmp: str, fixed_rate: float) -> dict:
    """Phase 55: SMS-WSJ-Plus through the command line."""
    import numpy as np
    import torch

    from nbss_tpu_torch.cli.config import instantiate, load_configs
    from nbss_tpu_torch.ops import attention_block as ab

    out = {}
    n_layers = FLAGSHIP["num_layers"]
    logs = os.path.join(tmp, "logs")
    rir_dir = os.path.join(tmp, "rir8k")
    log(f"phase 55/62 SMS-WSJ-Plus: python -m nbss_tpu_torch.cli fit "
        f"--config=configs/SpatialNet.yaml --config=configs/datasets/sms_wsj_plus.yaml, full "
        f"width, bf16-mixed, {SMS_STEPS} steps at B=2 and the validation split; test on whole "
        "utterances at B=1")
    t1 = time.perf_counter()
    wsj = write_sms_wsj_plus(os.path.join(tmp, "sms_wsj"), dev)
    log(f"fixture: {CORPUS_ITEMS} items a split, utterances of {CORPUS_SECONDS[0]:g}-"
        f"{CORPUS_SECONDS[1]:g} s, written in {time.perf_counter() - t1:.1f} s; rooms: phase 50's")
    paths = {"data.init_args.sms_wsj_dir": wsj, "data.init_args.rir_dir": rir_dir}
    args = ["--config=configs/SpatialNet.yaml", "--config=configs/datasets/sms_wsj_plus.yaml",
            f"--log_root={logs}", *(f"--{k}={v}" for k, v in paths.items())]
    cfg = load_configs(["configs/SpatialNet.yaml", "configs/datasets/sms_wsj_plus.yaml"], paths)
    data = instantiate(cfg["data"])
    B = data.batch_size[0]
    x, ys, _ = next(iter(data.train_dataloader(0)))
    if x.shape != (B, 6, 4 * FS) or ys.shape != (B, 2, 6, 4 * FS):
        raise AssertionError(f"train batch {x.shape}, {ys.shape}")
    _zero_counts()
    ab.wide_tc_launches = ab.bwd_wide_tc_launches = 0
    fit = _cli("fit", args, [f"--trainer.limit_train_batches={SMS_STEPS}",
                             "--trainer.max_epochs=1"])
    torch.cuda.synchronize()
    counts = _attention_counts()
    val = CORPUS_ITEMS  # the validation split at B=1, 4 s
    want = (n_layers * (SMS_STEPS + val),) * 2 + (0, 0) + (n_layers * SMS_STEPS,) * 2 + (0,)
    log(f"fit: train loss {fit['train_loss']:.3f}, val/metric {fit['val/metric']:.3f}; "
        f"attention_block launches (forward, tc, wide, wide tc, backward, tc, wide) {counts}, "
        f"expected {want}: {SMS_STEPS} steps and {val} validation forwards")
    if counts != want or not (np.isfinite(fit["train_loss"]) and np.isfinite(fit["val/metric"])):
        raise AssertionError(f"SMS-WSJ-Plus fit: launches {counts}, expected {want}; {fit}")
    out["sms_wsj_plus_fit_launches"] = (counts[0], counts[4])

    # the test split's whole utterances, as the test loader gives them, decide the route
    lens = [x.shape[-1] for x, _, _ in data.test_dataloader()]
    frames = [-(-T // FS) * FS // 128 + 1 for T in lens]  # the runner pads to whole seconds
    n_wide = sum(f > 256 for f in frames)
    ckpt = os.path.join(fit["log_dir"], "checkpoints", "epoch0")
    _zero_counts()
    ab.wide_tc_launches = 0
    test = _cli("test", args, ["--ckpt_path", ckpt, "--model.metrics=[SDR, SI_SDR]"])
    torch.cuda.synchronize()
    counts = _attention_counts()[:4]
    want = (n_layers * len(lens),) * 2 + (n_layers * n_wide,) * 2
    results = sorted(f for f in os.listdir(test["log_dir"]) if f.startswith("results_"))
    log(f"test over {test['num_items']} whole utterances ({min(lens) / FS:.2f}-"
        f"{max(lens) / FS:.2f} s, {len(lens) - n_wide} at T <= 256, {n_wide} on the wide route, "
        f"T up to {max(frames)}): SI-SDR {test['SI_SDR']:.2f} dB; launches (forward, tc, wide, "
        f"wide tc) {counts}, expected {want}; files {results}")
    if counts != want or test["num_items"] != CORPUS_ITEMS or not 0 < n_wide < len(lens) or \
            not {"results_mean.json", "results_incremental.jsonl"} <= set(results) or \
            len(results) != 3 or not np.isfinite(test["SI_SDR"]):
        raise AssertionError(f"SMS-WSJ-Plus test: launches {counts}, expected {want}; {test}")
    out["sms_wsj_plus_test_launches"] = (counts[0], counts[1], counts[2])

    rates = sms_wsj_plus_rates(cfg, data, dev, RATE_ITEMS)
    rates["fixed_b8_audio_s_per_s"] = fixed_rate
    log(f"phase 9's fixed batch at B=8: {fixed_rate:.1f} audio-s/s")
    out["sms_wsj_plus"] = {**rates, "test_items": len(lens), "test_wide_items": n_wide}
    del data
    check_budget("SMS-WSJ-Plus")
    return out


class _Epochs:
    """The samples of the train split's epochs 0, 1, ... in turn (fresh
    items each epoch), so that one loader, started once, draws them all, as
    it would from a corpus that many items long."""

    def __init__(self, n_items: int, epochs: int):
        from nbss_tpu_torch.data.sampler import DistributedSampler

        self.samplers = [DistributedSampler(n_items, seed=0, last_epoch=e) for e in range(epochs)]

    def __len__(self) -> int:
        return sum(len(s) for s in self.samplers)

    def __iter__(self):
        for s in self.samplers:
            yield from s


def _timed(batches, items: int, step=None, trace: bool = False):
    """Items/s over ``items`` items of ``batches``, each through ``step``
    when given, after a first batch that starts the loader (and the step)
    outside the window. With ``trace``, also the card's busy share of the
    window: its kernels' device time over the wall time, under
    ``torch.profiler`` recording the card's activity only (recording every
    host op as well would slow the host it measures)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    it = iter(batches)
    try:
        first = next(it)
        if step is not None:
            step(first)
            torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA]) if trace else contextlib.nullcontext()
        with prof:
            n, t1 = 0, time.perf_counter()
            while n < items:
                batch = next(it)
                if step is not None:
                    step(batch)
                n += batch[0].shape[0]
            if step is not None:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if not trace:
        return n / seconds
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    if device_us == 0:
        raise AssertionError("the profiler recorded no device time")
    return n / seconds, device_us / (seconds * 1e6)


def sms_wsj_plus_rates(cfg, data, dev, items: int, workers=(0, 2), fed=(2,),
                       trace: bool = False) -> dict:
    """The host loader's items/s over the SMS-WSJ-Plus train split at each
    of ``workers``, and SpatialNet-small's train rate at the config's B fed
    by it at each of ``fed`` and on one fixed batch, each over ``items``
    items after a warm-up batch (the fixture's files in the page cache).
    With ``trace``, the card's busy share over TRACE_ITEMS more items of
    each feed."""
    import itertools

    from nbss_tpu_torch.cli.main import build_module
    from nbss_tpu_torch.data.prefetch import ThreadedLoader
    from nbss_tpu_torch.data.sampler import BatchLoader
    from nbss_tpu_torch.train.loop import Trainer

    ds, B = data._make_dataset(0), data.batch_size[0]

    def loader(nw: int, n: int):
        sampler = _Epochs(len(ds), -(-(n + B) // len(ds)))
        return ThreadedLoader(ds, B, sampler, num_workers=nw) if nw else \
            BatchLoader(ds, B, sampler)

    loader_rate = {str(nw): _timed(loader(nw, items), items) for nw in workers}
    log("host loader (warm page cache): " + ", ".join(
        f"{v:.2f} items/s at num_workers {k}" for k, v in loader_rate.items())
        + f" ({items} items of 6 ch x 4 s each, after a first batch)")

    trainer = Trainer(build_module(cfg, dev), device=dev)
    trainer.init()
    first = next(iter(data.train_dataloader(0)))
    for _ in range(2):  # warm-up
        trainer.train_step(first)
    feeds = {f"num_workers {nw}": (lambda n, nw=nw: loader(nw, n)) for nw in fed}
    feeds["fixed batch"] = lambda n: itertools.repeat(first, n // B + 1)
    rates = {k: 4.0 * _timed(f(items), items, trainer.train_step) for k, f in feeds.items()}
    log(f"train rate at B={B} over {items} items (audio-s/s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
    out = {"loader_items_per_s": loader_rate, "train_audio_s_per_s": rates, "items": items}
    if trace:
        traced = {k: _timed(f(TRACE_ITEMS), TRACE_ITEMS, trainer.train_step, trace=True)
                  for k, f in feeds.items()}
        log(f"over {TRACE_ITEMS} more items with the profiler on: " + ", ".join(
            f"{k} {4.0 * r:.2f} audio-s/s, the card busy {100 * b:.1f}% of the wall time"
            for k, (r, b) in traced.items()))
        out["traced"] = {k: {"audio_s_per_s": 4.0 * r, "busy_share": b}
                         for k, (r, b) in traced.items()}
    del trainer
    return out


def corpus_rates(items: int) -> int:
    """``python3 chip_smoke.py --corpus-rates``: the kernels built, phase 50's
    rooms and phase 55's fixture, then ``sms_wsj_plus_rates`` over ``items``
    items at 0, 2 and 4 workers, traced."""
    import torch

    from nbss_tpu_torch.cli.config import instantiate, load_configs
    from nbss_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"corpus rates: {smi}; kernels built in {_build.build():.1f} s")
    _build.library()
    with tempfile.TemporaryDirectory(prefix="nbss_chip_smoke_") as tmp:
        rir_dir = os.path.join(tmp, "rir8k")
        _rendered(rir_dir, STATIC_SIM, RIR_NUMS, "static corpus")
        paths = {"data.init_args.sms_wsj_dir": write_sms_wsj_plus(os.path.join(tmp, "sms_wsj"), dev),
                 "data.init_args.rir_dir": rir_dir}
        cfg = load_configs(["configs/SpatialNet.yaml", "configs/datasets/sms_wsj_plus.yaml"], paths)
        rates = sms_wsj_plus_rates(cfg, instantiate(cfg["data"]), dev, items, (0, 2, 4),
                                   (0, 2, 4), True)
    print(json.dumps({"corpus_rates": rates, "device": smi}), flush=True)
    print(smi, flush=True)
    return 0


def chime3_phase(dev, tmp: str) -> dict:
    """Phase 56: CHiME3-moving through the command line."""
    import numpy as np
    import torch

    from nbss_tpu_torch.ops import ssm

    out = {}
    n_layers = ONLINE["num_layers"]
    logs = os.path.join(tmp, "logs")
    mdir = os.path.join(tmp, "rir8k_chime3")
    log(f"phase 56/62 CHiME3-moving: sim.generate {' '.join(CHIME3_SIM[2:])} --rir_nums "
        f"{' '.join(map(str, CHIME3_RIR_NUMS))}; fit configs/onlineSpatialNet.yaml + "
        f"configs/datasets/chime3_moving.yaml for {CHIME3_STEPS} steps at B=4 and a "
        "validation batch (B=8 x 32 s); test one 32-s item")
    out["chime3_sim_s_per_room"] = _rendered(mdir, CHIME3_SIM, CHIME3_RIR_NUMS, "CHiME3 rooms")
    np.savez(os.path.join(mdir, "rir_cfg.npz"),  # the generator's settings the dataset reads
             args=np.array({"trajectory": CHIME3_TRAJECTORY}, dtype=object))
    wsj0, chime3 = write_chime3(os.path.join(tmp, "chime3"), dev)
    cargs = ["--config=configs/onlineSpatialNet.yaml",
             "--config=configs/datasets/chime3_moving.yaml", f"--log_root={logs}",
             f"--data.init_args.wsj0_dir={wsj0}", f"--data.init_args.chime3_dir={chime3}",
             f"--data.init_args.rir_dir={mdir}",
             "--model.arch.init_args.dim_output=2"]  # one speaker: the config has no num_spk
    _zero_counts()
    t1 = time.perf_counter()
    fit = _cli("fit", cargs, ["--trainer.max_epochs=1", "--trainer.limit_val_batches=1",
                              f"--trainer.limit_train_batches={CHIME3_STEPS}"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    scans = (ssm.launches, ssm.bwd_launches)
    want = (4 * n_layers * CHIME3_STEPS + 2 * n_layers, 2 * n_layers * CHIME3_STEPS)
    log(f"fit in {fit_s:.1f} s: train loss {fit['train_loss']:.3f}, val/metric "
        f"{fit['val/metric']:.3f}; scan launches {scans}, expected {want} "
        f"({4 * n_layers} + {2 * n_layers} a step under remat_policy='dots', {2 * n_layers} for "
        "the validation batch)")
    if scans != want or not (np.isfinite(fit["train_loss"]) and np.isfinite(fit["val/metric"])):
        raise AssertionError(f"CHiME3 fit: scan launches {scans}, expected {want}; {fit}")
    ckpt = os.path.join(fit["log_dir"], "checkpoints", "epoch0")
    test = _cli("test", cargs, ["--ckpt_path", ckpt, "--trainer.limit_test_batches=1",
                                "--model.metrics=[SDR, SI_SDR]"])
    torch.cuda.synchronize()
    test_scans = ssm.launches - scans[0]
    inc = [json.loads(line) for line in open(os.path.join(test["log_dir"],
                                                          "results_incremental.jsonl"))]
    log(f"test: {test['num_items']} item of 32 s, SI-SDR {test['SI_SDR']:.2f} dB; scan "
        f"launches {test_scans}, expected {2 * n_layers}")
    if test["num_items"] != 1 or len(inc) != 1 or test_scans != 2 * n_layers or \
            not np.isfinite(test["SI_SDR"]):
        raise AssertionError(f"CHiME3 test: {test}, scan launches {test_scans}")
    out["chime3_launches"] = (scans[0], scans[1], test_scans)
    out["chime3_fit_s"] = fit_s
    check_budget("CHiME3-moving")
    return out


def other_corpora_phase(dev, tmp: str) -> dict:
    """Phase 57: every other ported corpus's first batches through the
    threaded loader, and one NBC2 step on spatialized WSJ0-2mix."""
    import numpy as np
    import torch

    from nbss_tpu_torch.cli.config import instantiate, load_configs
    from nbss_tpu_torch.data.libricss import LibriCSSDataModule
    from nbss_tpu_torch.data.prefetch import ThreadedLoader
    from nbss_tpu_torch.data.reverb import ReverbDataModule
    from nbss_tpu_torch.data.spk4_wsj0_mix_sp import Spk4Wsj0MixSpDataModule

    out = {}
    n_layers = NBC2_CFG["n_layers"]
    logs = os.path.join(tmp, "logs")
    log("phase 57/62 the other corpora: SMS-WSJ, spatialized WSJ0-2mix, WHAMR!, LibriCSS, "
        "4-speaker WSJ0 pairs, REVERB (train/val and ET): first train and test batch each; "
        "configs/NBC2.yaml + spatialized_wsj0_mix.yaml, one fit step")
    r16 = os.path.join(tmp, "rir16k_libricss")
    rrev = os.path.join(tmp, "rir16k_reverb")
    _rendered(r16, LIBRICSS_SIM, (1, 1, 1), "LibriCSS rooms")
    _rendered(rrev, REVERB_SIM, (1, 1, 0), "REVERB rooms")
    fx = write_other_corpora(os.path.join(tmp, "corpora"), dev)

    def from_yaml(name, **kw):
        return instantiate(load_configs([f"configs/datasets/{name}.yaml"],
                                        {f"data.init_args.{k}": v for k, v in kw.items()})["data"])

    L4, L16 = 4 * FS, 4 * 16000
    modules = {
        "sms_wsj": (from_yaml("sms_wsj", sms_wsj_dir=fx["sms_wsj"]),
                    (2, 6, L4), (2, 2, 6, L4), 6),
        "spatialized_wsj0_mix": (from_yaml("spatialized_wsj0_mix", sp_wsj0_dir=fx["spwsj"]),
                                 (2, 8, L4), (2, 2, 8, L4), 8),
        "whamr": (from_yaml("whamr", whamr_dir=fx["whamr"]), (2, 2, L4), (2, 2, 2, L4), 2),
        "libricss": (LibriCSSDataModule(
            librispeech_dir=fx["librispeech"], rir_dir=r16, noise_dir=fx["noise"],
            libricss_dir=fx["libricss"], audio_time_len=(4.0, 4.0, 4.0, None),
            batch_size=(2, 1)), (2, 7, L16), (2, 2, 7, L16), 7),
        "spk4_wsj0_mix_sp": (Spk4Wsj0MixSpDataModule(
            wsj0_dir=fx["wsj0"], rir_dir=os.path.join(r16, "train"), batch_size=(2, 1)),
            (2, 7, L16), (2, 2, 7, L16), 7),
        "reverb": (ReverbDataModule(
            wsjcam0_dir=fx["wsjcam0"], reverb_dir=fx["Reverb"], rir_dir=rrev,
            batch_size=(2, 1)), (2, 8, L16), (2, 1, 8, L16), 8),
    }
    shapes = {}
    for name, (dm, x_shape, y_shape, C) in modules.items():
        t1 = time.perf_counter()
        loaders = {"train": dm.train_dataloader(0), "test": dm.test_dataloader()}
        if not all(isinstance(ld, ThreadedLoader) for ld in loaders.values()):
            raise AssertionError(f"{name}: not the threaded loader")
        (x, ys, _), (xt, yst, pt) = (next(iter(ld)) for ld in loaders.values())
        shapes[name] = {"train": [list(x.shape), list(ys.shape)],
                        "test": [list(xt.shape), None if yst is None else list(yst.shape)]}
        ok = x.shape == x_shape and ys.shape == y_shape and xt.shape[:2] == (1, C) and \
            np.isfinite(x).all() and np.isfinite(ys).all() and np.isfinite(xt).all()
        log(f"{name}: train {tuple(x.shape)}, {tuple(ys.shape)}; test {tuple(xt.shape)}, "
            f"{None if yst is None else tuple(yst.shape)} ({pt[0]['dataset']}); "
            f"{time.perf_counter() - t1:.2f} s")
        if not ok:
            raise AssertionError(f"{name}: batch shapes {shapes[name]}, expected {x_shape}, "
                                 f"{y_shape} and {C} test channels")
    out["first_batches"] = shapes

    _zero_counts()
    nargs = ["--config=configs/NBC2.yaml", "--config=configs/datasets/spatialized_wsj0_mix.yaml",
             f"--log_root={logs}", f"--data.init_args.sp_wsj0_dir={fx['spwsj']}",
             "--trainer.max_epochs=1", "--trainer.limit_train_batches=1",
             "--trainer.limit_val_batches=1"]
    fit = _cli("fit", nargs)
    torch.cuda.synchronize()
    counts = _ab_counts()
    want = (2 * n_layers,) * 2 + (n_layers,) * 2 + (0,)
    log(f"NBC2-small on spatialized WSJ0-2mix (6 of its 8 channels): one step, train loss "
        f"{fit['train_loss']:.3f}; attention_block launches {counts}, expected {want} (8 a "
        "forward at two heads, the step's and the validation batch's, 8 backward)")
    if counts != want or not np.isfinite(fit["train_loss"]):
        raise AssertionError(f"NBC2 fit: launches {counts}, expected {want}")
    out["nbc2_fit_launches"] = (counts[0], counts[1], counts[2])
    check_budget("other corpora")
    return out


# phases 58-60: data parallelism, the command line on every card with the FLOP counter, MVDR
DP_STEPS = 10  # phase 58's fit on the fixed global batch
DP_RATE_STEPS = 6  # its rate window, after two warm-up steps
DP_CLI_STEPS = 3  # phase 59's fit: train steps at device_synth.yaml's B = 8, one val batch
MVDR_STFT = (512, 128)  # phase 60: tests/test_beamformer.py's STFT


def parallel_runs(dev, tmp: str) -> dict:
    """Phases 58-60: SpatialNet-small data-parallel through ``Trainer``
    (``nbss_tpu_torch.profile_parallel``), ``cli fit`` on every card with
    ``trainer.write_flops`` and ``cli test`` from its checkpoint, and the
    oracle MVDR on mixtures made on the card. Phase 50's rooms under ``tmp``."""
    import numpy as np
    import torch

    from nbss_tpu_torch import profile_parallel as pp
    from nbss_tpu_torch.check_gradients import gradients, hold
    from nbss_tpu_torch.cli import yamlio
    from nbss_tpu_torch.models.base import init_parameters

    out = {}
    cards = torch.cuda.device_count()
    n_layers = FLAGSHIP["num_layers"]
    # 58. data parallel
    n, backend = (min(cards, 4), "nccl") if cards >= 2 else (2, "gloo")
    where = f"{n} cards" if backend == "nccl" else "2 ranks sharing the one card"
    log(f"phase 58/62 data parallel: SpatialNet-small at full width, bf16, global B={pp.B} over "
        f"{n} ranks ({backend}, {where}); one fp32 step's all-reduced gradient, a {DP_STEPS}-step "
        "fit, then its rate; and a 1-rank NCCL group")
    res = pp.run(n, backend, DP_STEPS, grads=True, rate_steps=DP_RATE_STEPS)
    runs = {n: res, 1: pp.run(1, "nccl", 0, rate_steps=DP_RATE_STEPS)}
    want = (n_layers * DP_STEPS,) * 4
    crcs = {r["params_crc32"] for r in res}
    log(f"{n} ranks: launches (forward, tensor-core, backward, tensor-core) per rank "
        f"{[r['launches'] for r in res]} in {DP_STEPS} steps ({n_layers} + {n_layers} a step); "
        f"parameters' crc32 {sorted(crcs)}; peak {res[0]['peak_gib']:.1f} GiB a rank")
    if any(tuple(r["launches"]) != want for r in res):
        raise AssertionError(f"{n} ranks: launches {[r['launches'] for r in res]}, "
                             f"expected {want} in every rank")
    if len(crcs) != 1:
        raise AssertionError(f"{n} ranks: parameters differ across ranks ({crcs})")
    check_losses(res[0]["losses"], DP_STEPS)
    log(f"training rate over {DP_RATE_STEPS} steps: {res[0]['audio_s_per_s']:.1f} audio-s/s at "
        f"{n} ranks, {runs[1][0]['audio_s_per_s']:.1f} in the 1-rank NCCL group (peak "
        f"{runs[1][0]['peak_gib']:.1f} GiB)")
    m = pp.module(None, dev)
    init_parameters(m.arch, torch.Generator().manual_seed(pp.SEED))
    batch = tuple(torch.as_tensor(b, device=dev) for b in pp.global_batch()[:2])
    grads = gradients(m, batch, pp.SPATIALNET_SMALL, dev)
    grads["kernel"] = {k: v.to(dev).double() for k, v in runs[n][0]["grads"].items()}
    log(f"{n} ranks' all-reduced fp32 gradient against one process's float64 and plain fp32 "
        f"gradients on the global batch (check_gradients.hold): {hold(grads)}")
    out["dp"] = {"ranks": n, "backend": backend,
                 "audio_s_per_s": {str(k): v[0]["audio_s_per_s"] for k, v in runs.items()},
                 "peak_gib": {str(k): v[0]["peak_gib"] for k, v in runs.items()},
                 "launches": {str(n): res[0]["launches"]}}
    del m, batch, grads, runs, res
    fresh_start()
    check_budget("data parallel")

    # 59. the command line on every card, with the FLOP counter, then test
    rir_dir, logs = os.path.join(tmp, "rir8k"), os.path.join(tmp, "logs_dp")
    args = ["--config=configs/SpatialNet.yaml", "--config=configs/datasets/device_synth.yaml",
            "--trainer.precision=bf16-mixed", f"--data.init_args.rir_dir={rir_dir}",
            "--data.init_args.num_items=[24, 8, 4, 4]", f"--log_root={logs}",
            f"--trainer.devices={cards}"]
    log(f"phase 59/62 cli fit --trainer.devices={cards} --trainer.write_flops=true "
        f"({DP_CLI_STEPS} steps at B=8, one validation batch), then cli test from its checkpoint")
    _zero_counts()
    fit = _cli("fit", args, ["--trainer.max_epochs=1",
                             f"--trainer.limit_train_batches={DP_CLI_STEPS}",
                             "--trainer.limit_val_batches=1", "--trainer.write_flops=true"])
    counts = _ab_counts()
    flops = yamlio.load(os.path.join(fit["log_dir"], "FLOPs.yaml"))
    ckpt = os.path.join(fit["log_dir"], "checkpoints", "epoch0")
    test = _cli("test", args, ["--ckpt_path", ckpt, "--trainer.limit_test_batches=2",
                               "--model.metrics=[SI_SDR, SDR]", "--model.write_examples=0"])
    log(f"fit: train loss {fit['train_loss']:.3f}, val/metric {fit['val/metric']:.3f}; "
        f"FLOPs.yaml {flops}; attention_block launches in this process {counts}; test over "
        f"{test['num_items']} items: SI_SDR {test['SI_SDR']:.2f} dB")
    n_params = sum(p.numel() for p in pp.module(None, "cpu").arch.parameters())
    if set(flops) != {"flops_forward", "flops_backward", "params", "bytes_accessed_forward",
                      "flops_forward_avg"} or flops["params"] != n_params or \
            not flops["flops_backward"] > 0.5 * flops["flops_forward"] > 0:
        raise AssertionError(f"FLOPs.yaml {flops} (params {n_params})")
    if cards == 1 and counts[:4] != (n_layers * (DP_CLI_STEPS + 1),) * 2 + \
            (n_layers * DP_CLI_STEPS,) * 2:
        raise AssertionError(f"cli fit on one card: launches {counts}")
    if not (np.isfinite(fit["train_loss"]) and test["num_items"] == 2
            and np.isfinite(test["SI_SDR"])):
        raise AssertionError(f"cli fit {fit}, test {test}")
    out["cli"] = {"devices": cards, "flops": flops, "launches": counts}
    fresh_start()
    check_budget("CLI on every card")

    # 60. oracle MVDR on mixtures made on the card
    out["mvdr"] = mvdr_phase(dev, rir_dir)
    check_budget("MVDR")
    return out


def mvdr_phase(dev, rir_dir: str) -> dict:
    """Phase 60: ``eval.beamformer.mvdr`` with the oracle noise on the first
    train batch of ``DeviceSyntheticDataModule`` (device_synth.yaml's
    settings, phase 50's rooms): speaker 0's direct-path image at channel 0
    as the target, everything else as the noise."""
    import torch

    from nbss_tpu_torch.cli.config import load_configs
    from nbss_tpu_torch.data.device_mix import DeviceSyntheticDataModule
    from nbss_tpu_torch.eval.beamformer import mvdr
    from nbss_tpu_torch.io.stft import STFT
    from nbss_tpu_torch.ops.metrics import si_sdr

    init = load_configs(["configs/datasets/device_synth.yaml"])["data"]["init_args"]
    dm = DeviceSyntheticDataModule(**dict(init, rir_dir=rir_dir, num_items=[8, 8, 8, 8],
                                          seeds=(5, 2, 3, 3)), device=str(dev))
    x, ys, _ = next(iter(dm.train_dataloader(0)))
    log(f"phase 60/62 oracle MVDR (STFT {MVDR_STFT}) on {x.shape[0]} mixtures made on the card "
        f"({x.shape[1]} ch x {x.shape[-1] / FS:g} s): speaker 0's direct path at channel 0")
    stft = STFT(n_fft=MVDR_STFT[0], n_hop=MVDR_STFT[1])
    before, after = [], []
    t1 = time.perf_counter()
    for b in range(x.shape[0]):
        target = ys[b, 0]
        y = mvdr(x[b], noise=x[b] - target, stft=stft)
        before.append(float(si_sdr(x[b, :1], target[:1])[0]))
        after.append(float(si_sdr(y[None], target[:1])[0]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    gain = [a - b for a, b in zip(after, before)]
    log(f"SI-SDR before {[round(v, 2) for v in before]}, after "
        f"{[round(v, 2) for v in after]}: improvement mean {sum(gain) / len(gain):.2f} dB, "
        f"least {min(gain):.2f} dB (bound: more than 3 dB on average); {seconds:.2f} s")
    if not sum(gain) / len(gain) > 3.0:
        raise AssertionError(f"MVDR improved SI-SDR by {gain} dB")
    return {"si_sdr_gain_db": gain, "seconds": seconds}


# phases 61-62: the JAX package's committed epoch-39 runs, converted into the port's layout by
# scripts/convert_jax_checkpoint.py, and that package's outputs on two regenerated test items
TRAINED_RUNS = {"spatialnet": "checkpoints_torch/SpatialNet/version_0",
                "online": "checkpoints_torch/OnlineSpatialNet/version_0"}
GOLDEN, TRAINED_EPOCH = "checkpoints_torch/epoch39_golden.npz", 39
GOLDEN_FP32_DB = 60.0  # float32 against the JAX package's float32, each item and speaker
GOLDEN_METRIC_DB = 0.05  # each item's SI-SDR and SI-SDRi against the JAX package's
CLI_TEST_ITEMS = 4  # cli test items over phase 50's two static / phase 54's one moving test room
CLI_TEST_SI_SDRI_DB = 5.0  # an untrained or wrongly loaded model gives about 0 dB
# printed beside this run's numbers (other rooms, on a TPU): the committed test sets' mean
# SI-SDRi over 256 items (logs/<Arch>/version_0/epoch39_test_set/results_mean.json), and
# logs/OnlineSpatialNet/version_0/streaming_eval_epoch39.json's stream against offline
COMMITTED_SI_SDRI_DB = {"spatialnet": 11.89, "online": 12.40}
COMMITTED_STREAM_DB = 34.07


def trained_models(dev, tmp: str) -> dict:
    """Phases 61-62: the two committed models on the card, held against the
    JAX package's outputs on the same mixtures and run through ``cli test``
    over phase 50's and phase 54's rooms under ``tmp``."""
    import numpy as np

    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    out = {"golden": {"commit": str(golden["commit"]), "rooms": golden["rir_file"].tolist()}}
    # both cli test processes start first and run beside the checks in this process (each
    # spends most of its time starting Python, torch and its CUDA context)
    tests = {model: start_cli_test(model, tmp) for model in TRAINED_RUNS}
    try:
        for number, model, label in ((61, "spatialnet", "trained SpatialNet-small"),
                                     (62, "online", "trained OnlineSpatialNet")):
            out[model] = trained_phase(number, model, dev, golden)
            out[model].update(finish_cli_test(model, *tests[model]))
            fresh_start()
            check_budget(label)
    finally:
        for proc, *_ in tests.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def start_cli_test(model: str, tmp: str):
    """``python -m nbss_tpu_torch.cli test`` from a temporary copy of the
    converted run (test writes epoch39_test_set/ beside the checkpoints),
    over phase 50's static or phase 54's moving test rooms under ``tmp``;
    returns (process, copy, log file, start time)."""
    import shutil

    run = TRAINED_RUNS[model]
    copy = os.path.join(tmp, "trained", os.path.basename(os.path.dirname(run)), "version_0")
    shutil.copytree(run, copy)
    rir_dir = os.path.join(tmp, "rir8k" if model == "spatialnet" else "rir8k_moving")
    cmd = [sys.executable, "-m", "nbss_tpu_torch.cli", "test",
           f"--config={copy}/config.yaml",
           f"--ckpt_path={copy}/checkpoints/epoch{TRAINED_EPOCH}",
           f"--data.init_args.rir_dir={rir_dir}",
           f"--trainer.limit_test_batches={CLI_TEST_ITEMS}",
           "--model.metrics=[SI_SDR, SDR]", "--model.write_examples=0"]
    log(f"started python -m nbss_tpu_torch.cli test --config=<copy of {run}>/config.yaml "
        f"--ckpt_path=<copy>/checkpoints/epoch{TRAINED_EPOCH} over "
        f"{os.path.basename(rir_dir)}'s test rooms, {CLI_TEST_ITEMS} items")
    out = os.path.join(tmp, f"cli_test_{model}.log")
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, copy, out, time.perf_counter()


def finish_cli_test(model: str, proc, copy: str, out: str, t1: float) -> dict:
    """Wait for ``start_cli_test``'s process and hold its mean SI-SDRi."""
    proc.wait(timeout=300)
    res = {"cli_test_s": time.perf_counter() - t1}
    if proc.returncode != 0:
        with open(out) as f:
            raise RuntimeError(f"cli test of {model} exited {proc.returncode}: {f.read()[-3000:]}")
    with open(os.path.join(copy, f"epoch{TRAINED_EPOCH}_test_set", "results_mean.json")) as f:
        mean = json.load(f)
    res["cli_test"] = {k: mean[k] for k in ("SI_SDR", "SI_SDR_i", "SDR", "SDR_i")}
    log(f"cli test: {res['cli_test']} over {CLI_TEST_ITEMS} items, {res['cli_test_s']:.1f} s "
        f"after its start; mean SI-SDRi {mean['SI_SDR_i']:.2f} dB (bound >= "
        f"{CLI_TEST_SI_SDRI_DB:g}), the committed test set's {COMMITTED_SI_SDRI_DB[model]} dB "
        "(256 items, other rooms, on a TPU)")
    if not mean["SI_SDR_i"] >= CLI_TEST_SI_SDRI_DB:
        raise AssertionError(f"cli test of the trained {model}: mean SI-SDRi "
                             f"{mean['SI_SDR_i']} dB < {CLI_TEST_SI_SDRI_DB} dB")
    return res


def _item_metrics(yr_hat, yr, x_ref):
    """Per item: SI-SDR after PIT, the mean over speakers, and its gain over
    the reference channel of the mixture (the golden fixture's definition)."""
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.ops.pit import permutate, pit

    def mean_si_sdr(preds, target):
        return si_sdr(preds, target).mean(-1)

    _, perm = pit(preds=yr_hat, target=yr, metric_func=mean_si_sdr)
    sdr = mean_si_sdr(permutate(yr_hat, perm), yr)
    sdr_in = mean_si_sdr(x_ref[:, None].expand_as(yr), yr)
    return sdr.double().cpu().numpy(), (sdr - sdr_in).double().cpu().numpy()


def trained_phase(number: int, model: str, dev, golden: dict) -> dict:
    """One committed model: restore, and hold each path in float32 and bf16
    against the golden outputs with its kernel's launches counted."""
    import numpy as np
    import torch

    from nbss_tpu_torch.cli.config import load_configs
    from nbss_tpu_torch.cli.main import build_module
    from nbss_tpu_torch.ops import attention_block as ab
    from nbss_tpu_torch.ops import ssm
    from nbss_tpu_torch.ops.metrics import si_sdr
    from nbss_tpu_torch.train.ckpt import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    run = TRAINED_RUNS[model]
    cfg = load_configs([os.path.join(run, "config.yaml")])
    restored = CheckpointManager(os.path.join(run, "checkpoints")).restore(TRAINED_EPOCH)
    arch_name = cfg["model"]["arch"]["class_path"].rsplit(".", 1)[-1]
    n_layers = cfg["model"]["arch"]["init_args"]["num_layers"]
    log(f"phase {number}/62 the trained {arch_name} ({run}, epoch {restored['epoch']}, "
        f"{len(restored['params'])} tensors, optimizer state {'opt_state' in restored}) "
        f"against the JAX package's outputs on {golden['x'].shape[0]} test mixtures "
        f"({', '.join(golden['rir_file'])})")
    if "opt_state" in restored or restored["epoch"] != TRAINED_EPOCH:
        raise AssertionError(f"{run}: restored {sorted(restored)} at epoch {restored['epoch']}")
    x = torch.from_numpy(golden["x"]).to(dev)
    yr = torch.from_numpy(golden["yr"]).to(dev)
    ref = cfg["model"].get("ref_channel", 0)
    paths = ("forward", "streaming") if model == "online" else ("forward",)
    # the launches each path must make, read just after it: row 1's (all, tensor-core; bf16
    # takes the tensor-core kernel, float32 the CUDA-core one), row 6's (forward, backward:
    # two Mamba blocks a layer; the stream runs ssm.step, the JAX package's XLA step, and
    # launches no scan)
    if model == "spatialnet":
        def counts():
            return ab.launches, ab.tc_launches

        def expected(path, prec):
            return n_layers, n_layers if prec == "bf16" else 0
    else:
        def counts():
            return ssm.launches, ssm.bwd_launches

        def expected(path, prec):
            return 2 * n_layers if path == "forward" else 0, 0
    res = {"launches": {}, "db_fp32": {}, "bf16_l2_ratio": {}, "si_sdr": {}, "si_sdri": {}}
    ys = {}
    for prec, precision in (("fp32", "32"), ("bf16", "bf16-mixed")):
        module = build_module({**cfg, "trainer": {**cfg["trainer"], "precision": precision}}, dev)
        module.arch.load_state_dict(restored["params"], strict=True)
        module.arch.eval()
        res["parameters"] = sum(p.numel() for p in module.arch.parameters())
        for path in paths:
            fn = module.forward if path == "forward" else module.forward_streaming
            _zero_counts()
            t1 = time.perf_counter()
            y, _ = fn(x)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
            got = counts()
            label = f"{path} {prec}"
            if got != expected(path, prec):
                raise AssertionError(f"{arch_name} {label}: launches {got}, expected "
                                     f"{expected(path, prec)}")
            res["launches"][label] = got[0]
            y = y.float()
            if y.shape != yr.shape or not torch.isfinite(y).all():
                raise AssertionError(f"{arch_name} {label}: shape {tuple(y.shape)}, finite "
                                     f"{bool(torch.isfinite(y).all())}")
            ys[path, prec] = y
            key = f"{model}_{path}"
            g32 = torch.from_numpy(golden[f"{key}_fp32"]).to(dev)
            sdr, sdri = _item_metrics(y, yr, x[:, ref])
            res["si_sdr"][label], res["si_sdri"][label] = sdr.tolist(), sdri.tolist()
            if prec == "fp32":
                db = si_sdr(y, g32)  # [item, speaker]
                d_sdr = np.abs(sdr - golden[f"{key}_fp32_si_sdr"]).max()
                d_sdri = np.abs(sdri - golden[f"{key}_fp32_si_sdri"]).max()
                res["db_fp32"][path] = db.min().item()
                log(f"{label}: {res['parameters']} parameters loaded (strict); {got[0]} kernel "
                    f"launches; against the JAX float32 output "
                    f"SI-SDR {[round(v, 1) for v in db.flatten().tolist()]} dB (bound >= "
                    f"{GOLDEN_FP32_DB:g} each); items' SI-SDR {np.round(sdr, 3).tolist()} "
                    f"(JAX {np.round(golden[f'{key}_fp32_si_sdr'], 3).tolist()}), SI-SDRi "
                    f"{np.round(sdri, 3).tolist()} (JAX "
                    f"{np.round(golden[f'{key}_fp32_si_sdri'], 3).tolist()}): largest gaps "
                    f"{d_sdr:.4f} and {d_sdri:.4f} dB (bound {GOLDEN_METRIC_DB}); {seconds:.2f} s")
                if not (db.min().item() >= GOLDEN_FP32_DB and d_sdr <= GOLDEN_METRIC_DB
                        and d_sdri <= GOLDEN_METRIC_DB):
                    raise AssertionError(f"{arch_name} {label} against the JAX package: SI-SDR "
                                         f"{db.tolist()}, metric gaps {d_sdr}, {d_sdri} dB")
            else:
                gbf = torch.from_numpy(golden[f"{key}_bf16"]).to(dev)
                err = torch.linalg.vector_norm(y - g32).item()
                j_err = torch.linalg.vector_norm(gbf - g32).item()
                res["bf16_l2_ratio"][path] = err / j_err
                log(f"{label}: {got[0]} kernel launches; |port bf16 - JAX fp32| = {err:.4e}, "
                    f"|JAX bf16 - JAX fp32| = {j_err:.4e} (L2; ratio {err / j_err:.3f}, bound "
                    f"2); against the JAX bf16 output SI-SDR "
                    f"{si_sdr(y, gbf).min().item():.1f} dB; items' SI-SDR "
                    f"{np.round(sdr, 3).tolist()} (JAX bf16 "
                    f"{np.round(golden[f'{key}_bf16_si_sdr'], 3).tolist()}), SI-SDRi "
                    f"{np.round(sdri, 3).tolist()}; {seconds:.2f} s")
                if not err <= 2.0 * j_err:
                    raise AssertionError(f"{arch_name} {label}: L2 error {err} against the JAX "
                                         f"float32 output > 2 x the JAX bf16 output's {j_err}")
        del module
    if model == "online":
        res["stream_vs_offline_db"] = {
            prec: si_sdr(ys["streaming", prec], ys["forward", prec]).mean().item()
            for prec in ("fp32", "bf16")}
        log(f"stream against offline: {res['stream_vs_offline_db']} dB (mean over items and "
            f"speakers); streaming_eval_epoch39.json: {COMMITTED_STREAM_DB} dB, other rooms, "
            "on a TPU")
    del ys, x, yr
    res["seconds"] = time.perf_counter() - t_phase
    return res


def stop_rank_servers() -> None:
    """Stop the processes ``parallel.launch`` leaves for later launches (its
    fork server and multiprocessing's resource tracker), so that none
    outlives the run, whether it passed or failed."""
    try:
        from nbss_tpu_torch.parallel.mesh import stop_fork_server
    except ImportError:  # no checkout beside the script: nothing was started
        return
    stop_fork_server()


if __name__ == "__main__":
    try:
        code = corpus_rates(RATE_ITEMS_LONG) if sys.argv[1:] == ["--corpus-rates"] else main()
    finally:
        stop_rank_servers()
    sys.exit(code)
