"""Narrow-band attention block: ``y = x + out_proj(MHSA(LayerNorm(x)))``.

Counterpart of ``nbss_tpu/ops/attention_block.py``, forward and backward.
The projections are folded into per-head operands exactly as there:

    A_h   = Wq_h Wk_h^T / sqrt(dh)   (+ row H: Wk_h bq_h / sqrt(dh))
    Wvo_h = Wv_h Wo_h                (+ [H, H] = 1, the ones lane)
    c     = b_out + sum_h bv_h Wo_h

so that ``y = x + sum_h softmax(xa A_h xa^T) (xa Wvo_h)[:, :H] + c`` with
``xa = [LN(x), 1, 0]``.

``attention_block`` is a ``torch.autograd.Function``. For a CUDA tensor its
forward and backward run hand-written CUDA kernels chosen by dtype and
shape. At H = 96 with T <= 256 (SpatialNet-small, NBC2-small at 4 s),
bfloat16 inputs take ``csrc/attention_block_tc.cu`` and
``csrc/attention_block_bwd_tc.cu`` (bf16 tensor cores, ``mma.sync``; a
sequence's tiles in shared memory), float32 inputs
``csrc/attention_block.cu`` and ``csrc/attention_block_bwd.cu`` (float32
FMA on the CUDA cores: no tensor-core product keeps float32's digits). At
H = 192 (SpatialNet-large, NBC2-large) and at H = 96 with T > 256 the wide
route runs: bfloat16 through ``csrc/attention_block_wide_tc.cu`` (Hopper's
warpgroup products, ``wgmma``, on operands that ``cp.async.bulk`` copies
stream through ``mbarrier`` rings as swizzled 64-row tiles; t formed on the
chip, xa and vo written to device memory once in that layout), float32
through ``csrc/attention_block_wide.cu`` (float32 products and row passes
over chunks of sequences). Other widths raise
``ValueError``. For a CPU tensor they run the plain
PyTorch versions ``reference`` and ``reference_bwd``. The kernels replace the
Pallas TPU kernels ``_fused_block`` (``_kernel``) and ``_fused_block_bwd``
(``_bwd_kernel``) of the JAX package, and the backward returns what the JAX
package's ``custom_vjp`` returns: dx in x's dtype, and dln, dA, dWvo, dc in
float32. The fold is differentiable, so these reach the LayerNorm and
attention parameters; the constant slots of A and Wvo (``A[:, H, H+1]``,
``Wvo[:, H, H]`` and the pad lane) lead to no parameter, so their cotangents
are dropped, as the JAX fold's ``.at[].set`` drops them. On an H100 it is bound by
arithmetic, not by memory: at the flagship shape (M = B*F = 2064 sequences of
T = 251 frames, H = 96, 4 heads) a call moves about 199 MB in bf16 but the
folded function is about 277 GFLOP. The forward kernels keep every
intermediate (LN rows, t, vo, scores, weights) in shared memory or
registers; no [T, T] matrix reaches device memory (see the sources for the
layouts). The backward recomputes the forward from (x, ln, A, Wvo) and
keeps its cross-sequence sums in per-block float32 partials that a second
kernel adds in a fixed order, so its result is deterministic.

NBC's block adds Transformer-XL relative positions (``fold_weights_nbc``,
``reference_relpos``, ``attention_block_relpos``): per head also Gs_h, Gc_h
[H+2, H/2], so that the position score is (gs sin_i + gc cos_i) . cos_j +
(gc sin_i - gs cos_i) . sin_j with gs = xa Gs_h, gc = xa Gc_h and the
absolute-position tables sin, cos [T, H/2]. For a CUDA tensor its forward
runs a kernel chosen by dtype, both for H = 192 and replacing the Pallas
kernel ``_fused_block_relpos`` (``_kernel_relpos``): bfloat16 inputs take
``csrc/attention_block_relpos_tc.cu`` (bf16 tensor cores), float32 inputs
``csrc/attention_block_relpos.cu`` (float32 FMA). ``reference_relpos`` is
its plain version, with the Pallas kernel's rounding points; its gradient is
the autodiff of ``reference_relpos_xla`` on every device, as the JAX
package's ``custom_vjp`` differentiates ``_reference_relpos``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30
KERNEL_H = 96  # channels the shared-memory kernels are compiled for
KERNEL_TMAX = 256  # longest sequence they hold in shared memory
WIDE_H = (96, 192)  # channels the wide route is compiled for (any T)
# the wide forward's workspace holds this many bytes; longer calls go in chunks of sequences
WIDE_TC_WORKSPACE_BYTES = 4 << 30  # bf16: the xa and vo tiles of a chunk
WIDE_WORKSPACE_BYTES = 2 << 30  # float32: a chunk's rows and its [T, T] scores

launches = 0  # forward kernel launches made by attention_block since import
tc_launches = 0  # of which on a bf16 tensor-core forward (either route)
wide_launches = 0  # of which on the wide route (either dtype)
wide_tc_launches = 0  # of which on the wide bf16 tensor-core forward
bwd_launches = 0  # backward kernel launches made by attention_block since import
bwd_tc_launches = 0  # of which on a bf16 tensor-core backward (either route)
bwd_wide_launches = 0  # of which on the wide route (either dtype)
bwd_wide_tc_launches = 0  # of which on the wide bf16 tensor-core backward
BWD_SLICE_ROWS = 1024  # frames per slice of the tensor-core backward's weight products
BWD_MAX_SLICES = 64  # and at most this many slices, each a block per head and operand


def fold_weights(ln_weight, ln_bias, in_proj_weight, in_proj_bias,
                 out_proj_weight, out_proj_bias, nh: int, eps: float = 1e-5):
    """Fold torch-layout LayerNorm + MultiheadAttention parameters
    (``in_proj_weight`` [3H, H], ``out_proj.weight`` [H, H]) into the
    kernel's operands. Returns (ln [2, H], A [nh, H+2, H+2],
    Wvo [nh, H+2, H+2], c [1, H], eps), all float32."""
    f32 = torch.float32
    H = in_proj_weight.shape[1]
    dh = H // nh
    scale = 1.0 / math.sqrt(dh)
    w_in = in_proj_weight.to(f32).t()  # [H, 3H], x @ w_in
    b_in = in_proj_bias.to(f32)
    w_out = out_proj_weight.to(f32).t()  # [H, H]

    def heads(w):  # [H, H] column block -> [nh, H, dh]
        return w.reshape(H, nh, dh).permute(1, 0, 2)

    Wq, Wk, Wv = heads(w_in[:, :H]), heads(w_in[:, H:2 * H]), heads(w_in[:, 2 * H:])
    bq, bv = b_in[:H].reshape(nh, dh), b_in[2 * H:].reshape(nh, dh)
    Wo = w_out.reshape(nh, dh, H)  # rows of the out projection per head

    A = torch.zeros(nh, H + 2, H + 2, dtype=f32, device=w_in.device)
    Wvo = torch.zeros_like(A)
    A[:, :H, :H] = Wq @ Wk.transpose(1, 2) * scale
    A[:, H, :H] = (Wk @ bq[:, :, None])[..., 0] * scale
    A[:, H, H + 1] = NEG_INF  # ones x pad lane masks padded columns
    Wvo[:, :H, :H] = Wv @ Wo
    Wvo[:, H, H] = 1.0
    c = out_proj_bias.to(f32) + (bv[:, None, :] @ Wo)[:, 0].sum(0)
    ln = torch.stack([ln_weight.to(f32), ln_bias.to(f32)])
    return ln, A, Wvo, c[None], eps


def reference(x, ln, A, Wvo, c, eps: float, nh: int):
    """Plain PyTorch version of the folded block, with the rounding points of
    the JAX package's Pallas kernel (``_kernel``): xa, A, Wvo, t, vo and the
    unnormalised weights e = exp(s - rowmax(s)) are rounded to x's dtype;
    each head's pv = e vo is summed in float32 and divided by the float32
    sum of the rounded e (the kernel's lane H of pv: vo's ones lane, which
    ``fold_weights`` sets to 1 as the JAX fold does); the heads are summed
    in float32 in head order and y is rounded once. Every product
    accumulates in float32. x: [M, T, H]."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    H = x.shape[-1]
    xf = x.to(f32)
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    xln = xc * torch.rsqrt(var + eps) * ln[0] + ln[1]
    ones = torch.ones_like(xln[..., :1])
    xa = rnd(torch.cat([xln, ones, 0 * ones], -1))
    acc = torch.zeros_like(xf)
    for h in range(nh):
        t = rnd(xa @ rnd(A[h]))
        s = t @ xa.transpose(1, 2)
        e = rnd(torch.exp(s - s.amax(-1, keepdim=True)))
        pv = e @ rnd(xa @ rnd(Wvo[h, :, :H]))
        acc = acc + pv / e.sum(-1, keepdim=True)
    return (acc + c[0] + xf).to(dt)


def reference_bwd(x, ln, A, Wvo, g, eps: float, nh: int):
    """Plain PyTorch adjoint of the folded block, step by step as the JAX
    package's ``_bwd_kernel``: the forward is recomputed, and t, vo,
    g' = g / rowsum(e), e (where it meets g'), dvo, dS and dt are rounded to
    x's dtype; every product accumulates in float32. x, g: [M, T, H].
    Returns (dx in x's dtype, dln [2, H], dA, dWvo [nh, H+2, H+2], dc [1, H]
    in float32)."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    H = x.shape[-1]
    xf = x.to(f32)
    xc = xf - xf.mean(-1, keepdim=True)
    rsig = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rsig
    xln = xhat * ln[0] + ln[1]
    ones = torch.ones_like(xln[..., :1])
    xa = rnd(torch.cat([xln, ones, 0 * ones], -1))
    gf = g.to(f32)
    dxa = torch.zeros_like(xa)
    dA, dWvo = torch.zeros_like(A, dtype=f32), torch.zeros_like(Wvo, dtype=f32)
    for h in range(nh):
        a_h, w_h = rnd(A[h]), rnd(Wvo[h])
        t = rnd(xa @ a_h)
        s = t @ xa.transpose(1, 2)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        rinv = 1.0 / e.sum(-1, keepdim=True)
        vo = rnd(xa @ w_h)
        gp = rnd(gf * rinv)
        dvo = torch.nn.functional.pad(rnd(rnd(e).transpose(1, 2) @ gp), (0, 2))
        dp = gp @ vo[..., :H].transpose(1, 2)
        delta = (dp * e).sum(-1, keepdim=True) * rinv
        ds = rnd(e * (dp - delta))
        dth = rnd(ds @ xa)
        dxa = dxa + ds.transpose(1, 2) @ t + dth @ a_h.t() + dvo @ w_h.t()
        dA[h] = torch.einsum("mqi,mqk->ik", xa, dth)
        dWvo[h] = torch.einsum("mqi,mqk->ik", xa, dvo)
    dxln = dxa[..., :H]
    dln = torch.stack([(dxln * xhat).sum((0, 1)), dxln.sum((0, 1))])
    dc = gf.sum((0, 1))[None]
    dxhat = dxln * ln[0]
    dx_ln = rsig * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (gf + dx_ln).to(dt), dln, dA, dWvo, dc


def _check(name, x, ln, A, Wvo, nh, extra=()):
    """Raise ValueError unless the CUDA kernels take these inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [M, T, H], got {tuple(x.shape)}")
    M, T, H = x.shape
    if H not in WIDE_H or T < 1 or nh < 1 or H % nh:
        raise ValueError(f"{name}: the kernels take H = 96 or 192, T >= 1 and nh dividing H, "
                         f"got H = {H}, T = {T}, nh = {nh}")
    expect = {"ln": (ln, (2, H)), "A": (A, (nh, H + 2, H + 2)),
              "Wvo": (Wvo, (nh, H + 2, H + 2)), **dict(extra)}
    for key, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: {key} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the persistent
    kernels' grid, asked of the driver once a device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def is_wide(T: int, H: int) -> bool:
    """Whether a [*, T, H] block takes the wide route (H = 192, or T > 256)
    rather than the kernels that hold a sequence in shared memory."""
    return H != KERNEL_H or T > KERNEL_TMAX


def _chunk(M: int, workspace_bytes, budget: int, most: int) -> int:
    """Sequences a chunked kernel takes at a time: the fewest chunks, of
    equal size, whose workspace fits ``budget`` bytes, each at most ``most``
    sequences. ``workspace_bytes(k)`` is the workspace of k sequences."""
    one, two = workspace_bytes(1), workspace_bytes(2)
    fit = max(1, min(most, (budget - (2 * one - two)) // max(1, two - one)))
    return -(-M // -(-M // fit))


def _forward_wide(lib, x, ln, A, Wvo, c, y, eps: float, nh: int, stream):
    M, T, H = x.shape
    nblocks = _sm_count(x.device.index)
    if x.dtype == torch.bfloat16:
        def size(k):
            return lib.nbss_attention_block_wide_tc_workspace_bytes(k, T, H, nh, nblocks)

        chunk = _chunk(M, size, WIDE_TC_WORKSPACE_BYTES, (2 ** 31 - 1) // (T * (H + 16)))
        ws = torch.empty(size(chunk), dtype=torch.uint8, device=x.device)
        return lib.nbss_attention_block_wide_tc_fwd(
            x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), c.data_ptr(), y.data_ptr(),
            ws.data_ptr(), M, T, H, nh, chunk, nblocks, ctypes.c_float(eps), stream)

    def size(k):
        return lib.nbss_attention_block_wide_workspace_bytes(k, T, H, 0, 0)

    chunk = _chunk(M, size, WIDE_WORKSPACE_BYTES, min(65535, (1 << 22) // T))
    ws = torch.empty(size(chunk), dtype=torch.uint8, device=x.device)
    return lib.nbss_attention_block_wide_fwd(
        x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), c.data_ptr(), y.data_ptr(),
        ws.data_ptr(), M, T, H, nh, chunk, ctypes.c_float(eps), stream)


def _backward_wide(lib, x, ln, A, Wvo, g, dx, out, eps: float, nh: int, stream):
    M, T, H = x.shape
    nblocks = _sm_count(x.device.index)
    if x.dtype == torch.bfloat16:
        nslices = max(1, min(BWD_MAX_SLICES, -(-M * T // BWD_SLICE_ROWS)))
        ws = torch.empty(lib.nbss_attention_block_wide_bwd_tc_workspace_bytes(
            M, T, H, nh, nblocks, nslices), dtype=torch.uint8, device=x.device)
        return lib.nbss_attention_block_wide_bwd_tc(
            x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), g.data_ptr(), dx.data_ptr(),
            out.data_ptr(), ws.data_ptr(), nblocks, nslices, M, T, H, nh, ctypes.c_float(eps),
            stream)

    def size(k):
        return lib.nbss_attention_block_wide_workspace_bytes(k, T, H, 1, nblocks * 8)

    chunk = _chunk(M, size, WIDE_WORKSPACE_BYTES, min(65535, (1 << 22) // T))
    ws = torch.empty(size(chunk), dtype=torch.uint8, device=x.device)
    return lib.nbss_attention_block_wide_bwd(
        x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), g.data_ptr(), dx.data_ptr(),
        out.data_ptr(), ws.data_ptr(), M, T, H, nh, chunk, nblocks, ctypes.c_float(eps), stream)


def _forward(x, ln, A, Wvo, c, eps: float, nh: int):
    """The block: ``reference`` for a CPU tensor; for a CUDA tensor a
    tensor-core kernel on bfloat16 inputs and a CUDA-core kernel on float32
    ones, of the wide route where ``is_wide`` (or ValueError if no kernel
    takes the inputs)."""
    global launches, tc_launches, wide_launches, wide_tc_launches
    if x.device.type == "cpu":
        return reference(x, ln, A, Wvo, c, eps, nh)
    _check("attention_block", x, ln, A, Wvo, nh, {"c": (c, (1, x.shape[-1]))})
    M, T, H = x.shape
    y = torch.empty_like(x)
    if M == 0:
        return y
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tc = x.dtype == torch.bfloat16
    wide = is_wide(T, H)
    if wide:
        err = _forward_wide(lib, x, ln, A, Wvo, c, y, eps, nh, stream)
    elif tc:
        nblocks = min(M, _sm_count(x.device.index))
        ws = torch.empty(lib.nbss_attention_block_tc_workspace_bytes(nh, nblocks),
                         dtype=torch.uint8, device=x.device)
        err = lib.nbss_attention_block_tc_fwd(
            x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), c.data_ptr(),
            y.data_ptr(), ws.data_ptr(), nblocks, M, T, H, nh, ctypes.c_float(eps), stream)
    else:
        err = lib.nbss_attention_block_fwd(
            x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), c.data_ptr(),
            y.data_ptr(), M, T, H, nh, ctypes.c_float(eps), stream)
    if err != 0:
        raise RuntimeError(f"attention_block {'wide ' if wide else ''}"
                           f"{'tensor-core ' if tc else ''}kernel launch failed with CUDA error {err}")
    launches += 1
    tc_launches += tc
    wide_launches += wide
    wide_tc_launches += wide and tc
    return y


def backward(x, ln, A, Wvo, g, eps: float, nh: int):
    """The block's adjoint: ``reference_bwd`` for a CPU tensor; for a CUDA
    tensor a tensor-core kernel on bfloat16 inputs and a CUDA-core kernel on
    float32 ones, of the wide route where ``is_wide`` (or ValueError if no
    kernel takes the inputs). Returns (dx, dln, dA, dWvo, dc) as
    ``reference_bwd`` does."""
    global bwd_launches, bwd_tc_launches, bwd_wide_launches, bwd_wide_tc_launches
    if x.device.type == "cpu":
        return reference_bwd(x, ln, A, Wvo, g, eps, nh)
    _check("attention_block backward", x, ln, A, Wvo, nh)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"attention_block backward: g must be {x.dtype} {tuple(x.shape)}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    M, T, H = x.shape
    Ha = H + 2
    out = torch.empty(2 * nh * Ha * Ha + 3 * H, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if M == 0:
        out.zero_()
    else:
        from nbss_tpu_torch.ops import _build

        lib = _build.library()
        nblocks = min(M, _sm_count(x.device.index))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tc = x.dtype == torch.bfloat16
        wide = is_wide(T, H)
        if wide:
            err = _backward_wide(lib, x, ln, A, Wvo, g, dx, out, eps, nh, stream)
        elif tc:
            nslices = max(1, min(BWD_MAX_SLICES, -(-M * T // BWD_SLICE_ROWS)))
            ws = torch.empty(lib.nbss_attention_block_bwd_tc_workspace_bytes(
                M, T, nh, nblocks, nslices), dtype=torch.uint8, device=x.device)
            err = lib.nbss_attention_block_bwd_tc(
                x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), g.data_ptr(),
                dx.data_ptr(), out.data_ptr(), ws.data_ptr(), nblocks, nslices, M, T, H, nh,
                ctypes.c_float(eps), stream)
        else:
            ws = torch.empty(nblocks * lib.nbss_attention_block_bwd_workspace_floats(nh),
                             dtype=torch.float32, device=x.device)
            err = lib.nbss_attention_block_bwd(
                x.data_ptr(), ln.data_ptr(), A.data_ptr(), Wvo.data_ptr(), g.data_ptr(),
                dx.data_ptr(), out.data_ptr(), ws.data_ptr(), nblocks, M, T, H, nh,
                ctypes.c_float(eps), stream)
        if err != 0:
            raise RuntimeError(f"attention_block backward {'wide ' if wide else ''}"
                               f"{'tensor-core ' if tc else ''}kernel launch failed with CUDA "
                               f"error {err}")
        bwd_launches += 1
        bwd_tc_launches += tc
        bwd_wide_launches += wide
        bwd_wide_tc_launches += wide and tc
    n = nh * Ha * Ha
    return (dx, out[2 * n:2 * n + 2 * H].view(2, H), out[:n].view(nh, Ha, Ha),
            out[n:2 * n].view(nh, Ha, Ha), out[2 * n + 2 * H:].view(1, H))


class _AttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln, A, Wvo, c, eps, nh):
        ctx.save_for_backward(x, ln, A, Wvo)
        ctx.eps, ctx.nh = eps, nh
        return _forward(x, ln, A, Wvo, c, eps, nh)

    @staticmethod
    def backward(ctx, g):
        x, ln, A, Wvo = ctx.saved_tensors
        dx, dln, dA, dWvo, dc = backward(x, ln, A, Wvo, g, ctx.eps, ctx.nh)
        return dx, dln, dA, dWvo, dc, None, None


def attention_block(x, ln, A, Wvo, c, eps: float, nh: int):
    """x [M, T, H] (float32 or bfloat16) -> y of the same shape and dtype,
    differentiable in x, ln, A, Wvo and c.

    A CPU tensor takes ``reference`` (and ``reference_bwd`` for its
    gradient). A CUDA tensor launches the kernels, or raises if they do not
    take these inputs."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_block: no kernel for device {x.device}")
    return _AttentionBlock.apply(x, ln, A, Wvo, c, eps, nh)


# ---------------------------------------------------------------------------
# NBC's block: + Transformer-XL relative positions, trig-factorized
# ---------------------------------------------------------------------------

KERNEL_RELPOS_H = 192  # channels the relative-position kernels are compiled for (NBC)
RELPOS_WORKSPACE_BYTES = 1 << 30  # the CUDA-core kernel's workspaces hold this many bytes
# and the tensor-core kernel's: at NBC's serving shape (16 x 257 sequences of 248
# frames, 2.4 MB each) three chunks; more, smaller chunks were slower on an H100,
# from the partial last waves of each chunk's launches
RELPOS_TC_WORKSPACE_BYTES = 4 << 30

relpos_launches = 0  # kernel launches made by attention_block_relpos since import
relpos_tc_launches = 0  # of which on the bf16 tensor-core kernel


def fold_weights_nbc(ln_weight, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, wpos, u_bias, v_bias,
                     nh: int, eps: float = 1e-5):
    """Fold NBC's LayerNorm + RelPosMultiHeadAttention parameters (torch
    layout: Linear weights [out, in], ``pos_proj.weight`` [H, d_model],
    ``u_bias``/``v_bias`` [nh, dh]) into the relative-position kernel's
    operands, as the JAX package's ``fold_weights_nbc`` does:

        A_h   = Wq_h Wk_h^T / sqrt(H)   (+ row H: Wk_h (bq_h + u_h) / sqrt(H); [H, H+1] = -1e30)
        Gs_h  = Wq_h Wsin_h^T / sqrt(H) (+ row H: Wsin_h (bq_h + v_h) / sqrt(H)), Gc_h with Wcos
        Wvo_h = Wv_h Wo_h               (+ [H, H] = 1, the ones lane)
        c     = b_out + sum_h bv_h Wo_h

    with the reference's 1/sqrt(d_model) scale and Wsin/Wcos the even/odd
    rows of the position projection. Returns (ln [2, H], A [nh, H+2, H+2],
    Gs, Gc [nh, H+2, H/2], Wvo [nh, H+2, H+2], c [1, H], eps), all float32,
    differentiable in every parameter."""
    f32 = torch.float32
    H = wq.shape[1]
    dh, d2 = H // nh, H // 2
    scale = 1.0 / math.sqrt(H)

    def heads(w):  # torch Linear weight [H, H] -> per-head input maps [nh, H, dh]
        return w.to(f32).t().reshape(H, nh, dh).permute(1, 0, 2)

    Wq, Wk, Wv = heads(wq), heads(wk), heads(wv)
    Wo = wo.to(f32).t().reshape(nh, dh, H)  # rows of the out projection per head
    wpos3 = wpos.to(f32).t().reshape(H, nh, dh)  # [d_model, nh, dh]
    Wsin, Wcos = wpos3[0::2].permute(1, 0, 2), wpos3[1::2].permute(1, 0, 2)  # [nh, d/2, dh]
    bq_h, bv_h = bq.to(f32).reshape(nh, dh), bv.to(f32).reshape(nh, dh)
    qu, qv = bq_h + u_bias.to(f32), bq_h + v_bias.to(f32)

    A = torch.zeros(nh, H + 2, H + 2, dtype=f32, device=wq.device)
    Gs = torch.zeros(nh, H + 2, d2, dtype=f32, device=wq.device)
    Gc = torch.zeros_like(Gs)
    Wvo = torch.zeros_like(A)
    A[:, :H, :H] = Wq @ Wk.transpose(1, 2) * scale
    A[:, H, :H] = (Wk @ qu[:, :, None])[..., 0] * scale
    A[:, H, H + 1] = NEG_INF
    Gs[:, :H] = Wq @ Wsin.transpose(1, 2) * scale
    Gs[:, H] = (Wsin @ qv[:, :, None])[..., 0] * scale
    Gc[:, :H] = Wq @ Wcos.transpose(1, 2) * scale
    Gc[:, H] = (Wcos @ qv[:, :, None])[..., 0] * scale
    Wvo[:, :H, :H] = Wv @ Wo
    Wvo[:, H, H] = 1.0
    c = bo.to(f32) + (bv_h[:, None, :] @ Wo)[:, 0].sum(0)
    ln = torch.stack([ln_weight.to(f32), ln_bias.to(f32)])
    return ln, A, Gs, Gc, Wvo, c[None], eps


def _relpos_xa(x, ln, eps: float):
    """(x, xa = [LN(x), 1, 0] rounded to x's dtype), both float32."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(-1, keepdim=True)
    xln = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * ln[0] + ln[1]
    ones = torch.ones_like(xln[..., :1])
    return xf, torch.cat([xln, ones, 0 * ones], -1).to(x.dtype).to(torch.float32)


def reference_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps: float, nh: int):
    """Plain PyTorch version of the folded NBC block, with the rounding points
    of the JAX package's Pallas kernel (``_kernel_relpos``): xa, the
    operands, the tables, t, gs and gc are rounded to x's dtype; Aq =
    rnd(rnd(gs sin) + rnd(gc cos)) and Bq = rnd(rnd(gc sin) - rnd(gs cos));
    the scores s = t xa^T + Aq cos^T + Bq sin^T are float32; the unnormalised
    weights e = exp(s - rowmax(s)) and vo = xa Wvo_h are rounded; pv = e vo
    is summed in float32 and divided by the float32 sum of the rounded e
    (the Pallas kernel's lane H of pv: vo's ones lane, which
    ``fold_weights_nbc`` sets to 1 as the JAX fold does, so it does not
    depend on Wvo's constant column H); the heads are summed in float32 in
    head order and y = rnd((acc + c) + x) is rounded once. Every product
    accumulates in float32. One head at a time, as the Pallas kernel walks
    them, so that no [nh, M, T, T] tensor exists. x: [M, T, H]; sin_t,
    cos_t: [T, H/2]. This is the forward a CPU tensor takes and the yardstick
    of the CUDA kernels; ``reference_relpos_xla`` is what the gradient
    differentiates."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    H = x.shape[-1]
    xf, xa = _relpos_xa(x, ln, eps)
    sin_b, cos_b = rnd(sin_t.to(x.device)), rnd(cos_t.to(x.device))
    acc = None
    for h in range(nh):
        t = rnd(xa @ rnd(A[h]))
        gs, gc = rnd(xa @ rnd(Gs[h])), rnd(xa @ rnd(Gc[h]))
        Aq = rnd(rnd(gs * sin_b) + rnd(gc * cos_b))
        Bq = rnd(rnd(gc * sin_b) - rnd(gs * cos_b))
        s = t @ xa.transpose(1, 2)
        s = s + Aq @ cos_b.t()
        s = s + Bq @ sin_b.t()
        e = rnd(torch.exp(s - s.amax(-1, keepdim=True)))
        o = (e @ rnd(xa @ rnd(Wvo[h, :, :H]))) / e.sum(-1, keepdim=True)
        acc = o if acc is None else acc + o
    return ((acc + c[0]) + xf).to(dt)


def reference_relpos_xla(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps: float, nh: int):
    """Counterpart of the JAX package's ``_reference_relpos``, with its
    rounding points: xa, the operands, t, gs, gc, Aq, Bq (each elementwise
    step), the tables, p = softmax(s) and vo are rounded to x's dtype; every
    product accumulates in float32. One head at a time. Differentiable in
    every operand; the gradient of ``attention_block_relpos`` is its
    autodiff, as the JAX ``custom_vjp`` differentiates ``_reference_relpos``.
    In float32 it differs from ``reference_relpos`` only in the order of
    sums."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    H = x.shape[-1]
    xf, xa = _relpos_xa(x, ln, eps)
    sin_b, cos_b = rnd(sin_t.to(x.device)), rnd(cos_t.to(x.device))
    o = None
    for h in range(nh):
        t = rnd(xa @ rnd(A[h]))
        gs, gc = rnd(xa @ rnd(Gs[h])), rnd(xa @ rnd(Gc[h]))
        Aq = rnd(rnd(gs * sin_b) + rnd(gc * cos_b))
        Bq = rnd(rnd(gc * sin_b) - rnd(gs * cos_b))
        s = t @ xa.transpose(1, 2) + (Aq @ cos_b.t() + Bq @ sin_b.t())
        p = rnd(torch.softmax(s, dim=-1))
        vo = rnd(xa @ rnd(Wvo[h]))
        o = p @ vo if o is None else o + p @ vo
    return (o[..., :H] + c[0] + xf).to(dt)


def relpos_term_scale(x, ln, Wvo, c, eps: float, nh: int):
    """Per element of y, the largest magnitude among the terms that the folded
    NBC block adds into it: |x|, |c| and, for every head, the largest |vo_h|
    of that channel over the sequence's frames (o_h is a weighted mean of
    them, formed from bf16 values). A bf16 step of it is the resolution at
    which two versions that round at the same points but sum in another
    order can be told apart. float32 [M, T, H]; no gradient."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    with torch.no_grad():
        H = x.shape[-1]
        xf, xa = _relpos_xa(x, ln, eps)
        scale = torch.maximum(xf.abs(), c[0].abs())
        for h in range(nh):
            vo = rnd(xa @ rnd(Wvo[h, :, :H]))
            scale = torch.maximum(scale, vo.abs().amax(1, keepdim=True))
    return scale


def _check_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, nh):
    """Raise ValueError unless the relative-position kernel takes these inputs."""
    name = "attention_block_relpos"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [M, T, H], got {tuple(x.shape)}")
    M, T, H = x.shape
    if H != KERNEL_RELPOS_H or T < 1 or nh < 1 or H % nh:
        raise ValueError(f"{name}: the kernel takes H = {KERNEL_RELPOS_H}, T >= 1 and nh "
                         f"dividing H, got H = {H}, T = {T}, nh = {nh}")
    Ha, d2 = H + 2, H // 2
    expect = {"ln": (ln, (2, H)), "A": (A, (nh, Ha, Ha)), "Gs": (Gs, (nh, Ha, d2)),
              "Gc": (Gc, (nh, Ha, d2)), "Wvo": (Wvo, (nh, Ha, Ha)), "c": (c, (1, H)),
              "sin": (sin_t, (T, d2)), "cos": (cos_t, (T, d2))}
    for key, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: {key} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def _forward_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps: float, nh: int):
    """The block: ``reference_relpos`` for a CPU tensor; for a CUDA tensor the
    tensor-core kernel on bfloat16 inputs and the CUDA-core kernel on float32
    ones (or ValueError if they do not take the inputs)."""
    global relpos_launches, relpos_tc_launches
    if x.device.type == "cpu":
        return reference_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps, nh)
    _check_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, nh)
    M, T, H = x.shape
    y = torch.empty_like(x)
    if M == 0:
        return y
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tc = x.dtype == torch.bfloat16
    if tc:
        nblocks = _sm_count(x.device.index)

        def size(k):
            return lib.nbss_attention_block_relpos_tc_workspace_bytes(k, T, nh, nblocks)

        chunk = _chunk(M, size, RELPOS_TC_WORKSPACE_BYTES, M)
        ws = torch.empty(size(chunk), dtype=torch.uint8, device=x.device)
        err = lib.nbss_attention_block_relpos_tc_fwd(
            x.data_ptr(), ln.data_ptr(), A.data_ptr(), Gs.data_ptr(), Gc.data_ptr(),
            Wvo.data_ptr(), c.data_ptr(), sin_t.data_ptr(), cos_t.data_ptr(), y.data_ptr(),
            ws.data_ptr(), M, T, H, nh, chunk, nblocks, ctypes.c_float(eps), stream)
    else:
        head_cols, key_cols = (lib.nbss_attention_block_relpos_head_cols(),
                               lib.nbss_attention_block_relpos_key_cols())
        per_seq = T * ((nh * head_cols + key_cols) * x.element_size() + (H + T) * 4)
        chunk = max(1, min(M, RELPOS_WORKSPACE_BYTES // per_seq))
        xk = torch.empty(chunk * T, key_cols, dtype=x.dtype, device=x.device)
        P = torch.empty(chunk * T, nh * head_cols, dtype=x.dtype, device=x.device)
        acc = torch.empty(chunk * T, H, dtype=torch.float32, device=x.device)
        scores = torch.empty(chunk * T, T, dtype=torch.float32, device=x.device)
        wcat = torch.empty(H + 2, nh * head_cols, dtype=torch.float32, device=x.device)
        err = lib.nbss_attention_block_relpos_fwd(
            x.data_ptr(), ln.data_ptr(), A.data_ptr(), Gs.data_ptr(), Gc.data_ptr(),
            Wvo.data_ptr(), c.data_ptr(), sin_t.data_ptr(), cos_t.data_ptr(), y.data_ptr(),
            xk.data_ptr(), P.data_ptr(), acc.data_ptr(), scores.data_ptr(), wcat.data_ptr(), M,
            T, H, nh, chunk, ctypes.c_float(eps), stream)
    if err != 0:
        raise RuntimeError(f"attention_block_relpos {'tensor-core ' if tc else ''}kernel launch "
                           f"failed with CUDA error {err}")
    relpos_launches += 1
    relpos_tc_launches += tc
    return y


class _AttentionBlockRelpos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps, nh, save):
        if save:
            ctx.save_for_backward(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t)
        ctx.eps, ctx.nh = eps, nh
        return _forward_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps, nh)

    @staticmethod
    def backward(ctx, g):
        x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, ln, A, Gs, Gc, Wvo, c)]
            y = reference_relpos_xla(*leaves, sin_t, cos_t, ctx.eps, ctx.nh)
            grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None, None, None, None, None)


def attention_block_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps: float, nh: int):
    """y = x + out_proj(RelPosMHSA(LN(x))) on x [M, T, H] (float32 or
    bfloat16), NBC's attention half, from the operands of
    ``fold_weights_nbc`` and the float32 [T, H/2] tables of
    ``models.nbc.sincos_position_tables``. Differentiable in x, ln, A, Gs,
    Gc, Wvo and c.

    A CPU tensor takes ``reference_relpos``; a CUDA tensor launches the
    tensor-core kernel (bfloat16) or the CUDA-core kernel (float32), or
    raises if it does not take these inputs. The gradient is the autodiff of
    ``reference_relpos_xla`` on every device, as the JAX package's
    ``custom_vjp`` takes the autodiff of its ``_reference_relpos``: the
    Pallas kernel has no backward."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_block_relpos: no kernel for device {x.device}")
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, ln, A, Gs, Gc, Wvo, c))
    return _AttentionBlockRelpos.apply(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, eps, nh, save)
