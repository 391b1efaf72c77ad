"""Narrow-band multi-head attention, forward and backward.

Counterpart of ``nbss_tpu/ops/attention.py``. For each of M short sequences
and each head h,

    o_h = softmax(q_h k_h^T / sqrt(dh) + mask_h) v_h

over the layout the JAX package uses: q and k [M, T, nh * dh], v and o
[M, T, nh * dv] (dv may differ from dh), heads as slices of the last axis.
The mask is none, additive [T, T] for every head, or [nh, T, T].

``narrowband_attention`` is a ``torch.autograd.Function``. For a CUDA tensor
its forward runs a hand-written kernel chosen by dtype: bfloat16 inputs take
``csrc/narrowband_attention_tc.cu`` (bf16 tensor cores, ``mma.sync``),
float32 inputs ``csrc/narrowband_attention.cu`` (float32 FMA on the CUDA
cores: no tensor-core product keeps float32's digits); its backward likewise
``csrc/narrowband_attention_bwd_tc.cu`` and ``csrc/narrowband_attention_bwd.cu``.
For a CPU tensor they run the plain PyTorch versions ``reference`` and
``reference_bwd``. The
kernels replace the Pallas TPU kernels ``narrowband_attention`` /
``_fused_forward`` and ``_fused_backward`` of the JAX package and keep their
rounding points: the unnormalized weights e = exp(s - rowmax) are rounded to
v's dtype, their product with v is summed in float32 and scaled by
1 / sum(e) (taken over the float32 e), and the result is rounded once. The
JAX package's einsum reference and the model's XLA path normalize first and
then round; in float32 the two are the same, in bf16 about one bf16 step
apart. The backward follows ``_bwd_kernel``'s formulas and rounding.

When a gradient is wanted the forward kernel also writes each row's max and
1 / sum(e) ([2, M, nh, T] float32), from which the backward kernel
recomputes e; under ``no_grad`` nothing but o is written. The mask gets no
gradient. The kernels take q/k head widths up to ``KERNEL_DHMAX`` (NBC's
augmented heads of dh + d_model = 216 among them: above 64 the float32
kernels split each row over four threads), v head widths up to
``KERNEL_DVMAX``, and any M, T >= 1.
"""

from __future__ import annotations

import math

import torch

KERNEL_DHMAX = 256  # largest q/k head width the kernels take; csrc holds the same value
KERNEL_DVMAX = 64  # largest v head width the kernels take; csrc holds the same value
NARROW_DMAX = 64  # q/k head widths above this take the wide kernels (32-row tiles)

launches = 0  # forward kernel launches made by narrowband_attention since import
tc_launches = 0  # of which on the bf16 tensor-core kernel
bwd_launches = 0  # backward kernel launches made by narrowband_attention since import
bwd_tc_launches = 0  # of which on the bf16 tensor-core backward


def _up(t):
    """t in float32, or float64 if it is (the plain versions' sums)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _heads(t, nh):
    """[M, T, nh * d] -> [M, nh, T, d] in float32 (float64 stays)."""
    M, T, W = t.shape
    return _up(t.reshape(M, T, nh, W // nh).transpose(1, 2))


def _merge(t, like):
    """[M, nh, T, d] -> [M, T, nh * d] in ``like``'s dtype."""
    M, nh, T, d = t.shape
    return t.to(like.dtype).transpose(1, 2).reshape(M, T, nh * d)


def _weights(q, k, mask, nh):
    """(e, rinv, scale): e = exp(s - rowmax(s)) and 1 / sum(e) in float32
    for s = q k^T * scale + mask, as the Pallas kernel forms them."""
    scale = 1.0 / math.sqrt(q.shape[-1] // nh)
    s = _heads(q, nh) @ _heads(k, nh).transpose(-1, -2) * scale
    if mask is not None:
        s = s + _up(mask if mask.dim() == 3 else mask[None])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e, 1.0 / e.sum(-1, keepdim=True), scale


def reference(q, k, v, mask=None, nh: int = 1):
    """Plain PyTorch attention with the Pallas kernel's rounding points:
    o = round(round(e) v * (1 / sum(e))), round to v's and then q's dtype.
    q, k [M, T, nh * dh], v [M, T, nh * dv] -> o [M, T, nh * dv]."""
    e, rinv, _ = _weights(q, k, mask, nh)
    o = (_up(e.to(v.dtype)) @ _heads(v, nh)) * rinv
    return _merge(o, q)


def reference_bwd(q, k, v, mask, g, nh: int = 1):
    """Plain PyTorch adjoint of ``reference`` for the cotangent g
    [M, T, nh * dv], with the formulas and rounding points of the Pallas
    ``_bwd_kernel``:

        g'  = round(g * rinv) ;  dV = round(e)^T g' ;  dP' = g' V^T
        delta = rowsum(dP' o e) * rinv ;  dS = round(e o (dP' - delta) * scale)
        dQ = dS K ;  dK = dS^T Q

    Returns (dq, dk, dv), each in its input's dtype."""
    e, rinv, scale = _weights(q, k, mask, nh)
    gp = _up((_heads(g, nh) * rinv).to(g.dtype))
    dv = _up(e.to(g.dtype)).transpose(-1, -2) @ gp
    dp = gp @ _heads(v, nh).transpose(-1, -2)
    delta = (dp * e).sum(-1, keepdim=True) * rinv
    ds = _up((e * (dp - delta) * scale).to(q.dtype))
    dq = ds @ _heads(k, nh)
    dk = ds.transpose(-1, -2) @ _heads(q, nh)
    return _merge(dq, q), _merge(dk, k), _merge(dv, v)


def _shape(name, q, k, v, mask, nh):
    """(M, T, dh, dv), or ValueError unless the kernels take these inputs'
    types and shapes (the device is checked by the caller)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or nh < 1 or q.shape[2] % nh:
        raise ValueError(f"{name}: q must be [M, T, nh * dh] with nh = {nh}, "
                         f"got {tuple(q.shape)}")
    M, T, H = q.shape
    for key, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or t.dim() != 3 or t.shape[:2] != q.shape[:2]:
            raise ValueError(f"{name}: {key} must be {q.dtype} [M, T, ...] = [{M}, {T}, ...] on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k.shape[2] != H or v.shape[2] % nh:
        raise ValueError(f"{name}: k must be [{M}, {T}, {H}] and v [{M}, {T}, nh * dv], "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    dh, dv = H // nh, v.shape[2] // nh
    if T < 1 or not 1 <= dh <= KERNEL_DHMAX or not 1 <= dv <= KERNEL_DVMAX:
        raise ValueError(f"{name}: the kernels take T >= 1 and head widths dh 1..{KERNEL_DHMAX}"
                         f", dv 1..{KERNEL_DVMAX}, got T = {T}, dh = {dh}, dv = {dv}")
    if q.dtype == torch.bfloat16:
        blocks = M * nh  # the tensor-core kernels run a block per (sequence, head)
    else:
        blocks = M * nh * -(-T // (64 if dh <= NARROW_DMAX else 32))
    if blocks >= 2 ** 31:
        raise ValueError(f"{name}: {blocks} blocks exceed the grid")
    if mask is not None and (mask.device != q.device or tuple(mask.shape[-2:]) != (T, T)
                             or mask.dim() not in (2, 3)
                             or (mask.dim() == 3 and mask.shape[0] not in (1, nh))):
        raise ValueError(f"{name}: mask must be [T, T] or [nh, T, T] = [{nh}, {T}, {T}] on "
                         f"{q.device}, got {tuple(mask.shape)} on {mask.device}")
    return M, T, dh, dv


def _rows(t):
    """(t, row stride): t itself where its rows lie a fixed stride apart with
    unit steps inside (a slice of a packed qkv projection), else a
    contiguous copy."""
    M, T, W = t.shape
    if (t.stride(2) == 1 and T > 1 and t.stride(1) >= W
            and (M == 1 or t.stride(0) == T * t.stride(1))):
        return t, t.stride(1)
    t = t.contiguous()
    return t, W


def _mask_arg(mask):
    """(float32 contiguous [mask_heads, T, T] or None, mask_heads)."""
    if mask is None:
        return None, 1
    mask = mask.float().contiguous()
    return mask, 1 if mask.dim() == 2 else mask.shape[0]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def forward(q, k, v, mask=None, nh: int = 1, stats: bool = False):
    """The attention: ``reference`` for a CPU tensor; for a CUDA tensor the
    tensor-core kernel on bfloat16 inputs and the CUDA-core kernel on
    float32 ones (or ValueError if it does not take the inputs). Returns
    (o, st); st holds each row's max and 1 / sum(e), [2, M, nh, T] float32,
    when ``stats`` is set on the card, else None."""
    global launches, tc_launches
    if q.device.type == "cpu":
        return reference(q, k, v, mask, nh), None
    if q.device.type != "cuda":
        raise ValueError(f"narrowband_attention: no kernel for device {q.device}")
    M, T, dh, dv = _shape("narrowband_attention", q, k, v, mask, nh)
    (q, ldq), (k, ldk), (v, ldv) = _rows(q), _rows(k), _rows(v)
    mask, mask_heads = _mask_arg(mask)
    o = torch.empty(M, T, nh * dv, dtype=q.dtype, device=q.device)
    st = torch.empty(2, M, nh, T, dtype=torch.float32, device=q.device) if stats else None
    if M == 0:
        return o, st
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    widths = (lib.nbss_narrowband_attention_max_width(),
              lib.nbss_narrowband_attention_max_v_width())
    if widths != (KERNEL_DHMAX, KERNEL_DVMAX):
        raise RuntimeError(f"csrc/narrowband_attention.cu takes head widths up to {widths} "
                           f"(q/k, v), ops/attention.py expects {(KERNEL_DHMAX, KERNEL_DVMAX)}")
    tc = q.dtype == torch.bfloat16
    kernel = lib.nbss_narrowband_attention_tc_fwd if tc else lib.nbss_narrowband_attention_fwd
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        o.data_ptr(), None if st is None else st.data_ptr(), ldq, ldk, ldv, M, T, nh, dh, dv,
        mask_heads, 1.0 / math.sqrt(dh), _stream(q))
    if err != 0:
        raise RuntimeError(f"narrowband_attention {'tensor-core ' if tc else ''}kernel launch "
                           f"failed with CUDA error {err}")
    launches += 1
    tc_launches += tc
    return o, st


def backward(q, k, v, mask, g, nh: int, stats):
    """The adjoint: ``reference_bwd`` for a CPU tensor (stats unused), the
    CUDA kernels for a CUDA tensor, which read the row statistics that
    ``forward(..., stats=True)`` wrote on the same q, k and mask. Returns
    (dq, dk, dv) as ``reference_bwd`` does."""
    global bwd_launches, bwd_tc_launches
    if q.device.type == "cpu":
        return reference_bwd(q, k, v, mask, g, nh)
    if q.device.type != "cuda":
        raise ValueError(f"narrowband_attention backward: no kernel for device {q.device}")
    M, T, dh, dv = _shape("narrowband_attention backward", q, k, v, mask, nh)
    for key, t, shape, dtype in (("g", g, (M, T, nh * dv), q.dtype),
                                 ("stats", stats, (2, M, nh, T), torch.float32)):
        if t is None or tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"narrowband_attention backward: {key} must be {dtype} {shape} on "
                             f"{q.device}, got "
                             f"{None if t is None else (t.dtype, tuple(t.shape), t.device)}")
    (q, ldq), (k, ldk), (v, ldv) = _rows(q), _rows(k), _rows(v)
    g, stats = g.contiguous(), stats.contiguous()
    mask, mask_heads = _mask_arg(mask)
    dq = torch.empty(M, T, nh * dh, dtype=q.dtype, device=q.device)
    dk, dvals = torch.empty_like(dq), torch.empty(M, T, nh * dv, dtype=q.dtype, device=q.device)
    if M == 0:
        return dq, dk, dvals
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    delta = torch.empty(M, nh, T, dtype=torch.float32, device=q.device)
    tc = q.dtype == torch.bfloat16
    kernel = lib.nbss_narrowband_attention_bwd_tc if tc else lib.nbss_narrowband_attention_bwd
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvals.data_ptr(),
        delta.data_ptr(), ldq, ldk, ldv, M, T, nh, dh, dv, mask_heads, 1.0 / math.sqrt(dh),
        _stream(q))
    if err != 0:
        raise RuntimeError(f"narrowband_attention backward {'tensor-core ' if tc else ''}kernel "
                           f"launch failed with CUDA error {err}")
    bwd_launches += 1
    bwd_tc_launches += tc
    return dq, dk, dvals


class _NarrowbandAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, nh: int, save: bool, kernel: bool):
        if kernel:
            o, stats = forward(q, k, v, mask, nh, stats=save)
        else:
            o, stats = reference(q, k, v, mask, nh), None
        if save:
            ctx.save_for_backward(q, k, v, mask, stats)
        ctx.nh, ctx.kernel = nh, kernel
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, stats = ctx.saved_tensors
        if ctx.kernel:
            grads = backward(q, k, v, mask, g, ctx.nh, stats)
        else:
            grads = reference_bwd(q, k, v, mask, g, ctx.nh)
        return (*grads, None, None, None, None)


def narrowband_attention(q, k, v, mask=None, nh: int = 1, kernel: bool = True):
    """o [M, T, nh * dv] in q's dtype, differentiable in q, k and v (the mask's
    gradient is None).

    q and k are [M, T, nh * dh], v [M, T, nh * dv], all float32 or all
    bfloat16; mask is None, [T, T] or [nh, T, T], additive. A CPU tensor takes
    ``reference`` (and ``reference_bwd`` for its gradient). A CUDA tensor
    launches the kernels, or raises if they do not take these inputs;
    ``kernel=False`` runs the plain versions there too. The forward keeps
    what the backward needs only when a gradient is wanted."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"narrowband_attention: no kernel for device {q.device}")
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _NarrowbandAttention.apply(q, k, v, mask, nh, save, kernel)
