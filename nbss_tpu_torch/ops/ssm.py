"""Selective state-space scan (Mamba v1), forward and backward.

Counterpart of ``nbss_tpu/ops/ssm.py``. The recurrence, with a float32
state h [M, D, N] per sequence, is

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = C_t . h_t + D * x_t

``selective_scan`` is a ``torch.autograd.Function``. For a CUDA tensor its
forward runs the hand-written kernel ``csrc/selective_scan.cu`` and its
backward ``csrc/selective_scan_bwd.cu``; for a CPU tensor they run the plain
PyTorch versions ``reference`` and ``reference_bwd``. The kernels replace the
Pallas TPU kernels ``selective_scan_pallas`` (``_pallas_scan_kernel``) and
``_pallas_scan_bwd`` (``_pallas_scan_bwd_kernel``) of the JAX package, and
keep their rounding points: ``C . h`` is rounded to x's dtype before the
``D * x`` term is added in float32 and the sum rounded again. x, B and C are
in the compute dtype, dt, A and D in float32; the gradients come back in
each input's own dtype.

When a gradient is wanted the forward kernel also writes the state at the
start of every ``CHUNK`` frames ([n_chunks, M, N, D] float32, 1/CHUNK of the
[M, T, D, N] states), and the backward kernel recomputes each chunk's states
from it before it runs the adjoint backwards through the chunk. Under
``no_grad`` nothing but y is written. On an H100 the forward is bound by the
instructions of its state updates (one exponential each) rather than by its
bytes, the backward by memory traffic (see the sources).

The kernels take any state size N. Up to ``STATE_GROUP`` = 16 states they
run in one launch; a larger N runs in passes over groups of 16 states, one
launch each, which carry the sums over states (C . h in the forward; lam . B
and the gdt term in the backward) from pass to pass in float32 scratch of
[M, T, D] and round once in the last pass. A call counts one launch in
``launches`` / ``bwd_launches`` whatever its number of passes.

``step`` is one frame of the recurrence for streaming, plain code as in the
JAX package.
"""

from __future__ import annotations

import torch

CHUNK = 8  # frames between saved states; csrc/selective_scan*.cu hold the same value
STATE_GROUP = 16  # states a pass of the kernels; csrc/selective_scan*.cu hold the same value

launches = 0  # forward kernel launches made by selective_scan since import
bwd_launches = 0  # backward kernel launches made by selective_scan since import


def reference(x, dt, A, Bm, Cm, D):
    """Plain PyTorch scan with the Pallas kernel's rounding points.

    x [M, T, D], dt [M, T, D] (float32), A [D, N], Bm, Cm [M, T, N], D [D]
    -> y [M, T, D] in x's dtype."""
    f32 = torch.float32
    x32, dt32, A32 = x.to(f32), dt.to(f32), A.to(f32)
    B32, C32 = Bm.to(f32), Cm.to(f32)
    M, T, Dm = x.shape
    h = x32.new_zeros(M, Dm, A.shape[-1])
    ys = []
    for t in range(T):
        dA = torch.exp(dt32[:, t, :, None] * A32)
        h = dA * h + (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        ys.append((h * C32[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1).to(x.dtype).to(f32)  # the kernel writes C . h in x's dtype
    return (y + x32 * D.to(f32)).to(x.dtype)


def reference_bwd(x, dt, A, Bm, Cm, D, gy):
    """Plain PyTorch reverse-time adjoint of ``reference``, in float32 as the
    JAX package's ``_pallas_scan_bwd`` and ``_ss_bwd``:

        lam_t = exp(dt_{t+1} A) lam_{t+1} + gy_t C_t
        gdt   = sum_n lam h_{t-1} exp(dt A) A + (lam . B_t) x_t
        gx    = (lam . B_t) dt_t + gy D
        gB    = sum_d lam dt x ;  gC = sum_d gy h_t
        gA    = sum_{m,t} lam h_{t-1} exp(dt A) dt ;  gD = sum_{m,t} gy x

    Returns (gx, gdt, gA, gB, gC, gD), each in its input's dtype."""
    f32 = torch.float32
    x32, dt32, A32 = x.to(f32), dt.to(f32), A.to(f32)
    B32, C32, gy32 = Bm.to(f32), Cm.to(f32), gy.to(f32)
    M, T, Dm = x.shape
    hs = [x32.new_zeros(M, Dm, A.shape[-1])]  # hs[t] = state before step t
    for t in range(T):
        dA = torch.exp(dt32[:, t, :, None] * A32)
        hs.append(dA * hs[-1] + (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :])
    gx, gdt = torch.empty_like(x32), torch.empty_like(x32)
    gB, gC = torch.empty_like(B32), torch.empty_like(C32)
    gA = torch.zeros_like(A32)
    lam = torch.zeros_like(hs[0])
    for t in range(T - 1, -1, -1):
        lam = lam + gy32[:, t, :, None] * C32[:, t, None, :]
        dA = torch.exp(dt32[:, t, :, None] * A32)
        g = lam * hs[t] * dA
        lamB = (lam * B32[:, t, None, :]).sum(-1)
        gdt[:, t] = (g * A32).sum(-1) + lamB * x32[:, t]
        gx[:, t] = lamB * dt32[:, t]
        gB[:, t] = (lam * (dt32[:, t] * x32[:, t])[..., None]).sum(1)
        gC[:, t] = (gy32[:, t, :, None] * hs[t + 1]).sum(1)
        gA += (g * dt32[:, t, :, None]).sum(0)
        lam = dA * lam
    gx = gx + gy32 * D.to(f32)
    gD = (gy32 * x32).sum((0, 1))
    outs = (gx, gdt, gA, gB, gC, gD)
    return tuple(o.to(v.dtype) for o, v in zip(outs, (x, dt, A, Bm, Cm, D)))


def step(h, x_t, dt_t, A, B_t, C_t, D):
    """One streaming frame, as the JAX package's ``selective_scan_step``:
    h [M, D, N] float32, x_t, dt_t [M, D], B_t, C_t [M, N] -> (h', y_t [M, D]
    in x_t's dtype)."""
    f32 = torch.float32
    x32, dt32 = x_t.to(f32), dt_t.to(f32)
    dA = torch.exp(dt32[..., None] * A.to(f32))
    h = dA * h + (dt32 * x32)[..., None] * B_t.to(f32)[:, None, :]
    y = torch.einsum("mdn,mn->md", h, C_t.to(f32)) + x32 * D.to(f32)
    return h, y.to(x_t.dtype)


def _check(name, x, dt, A, Bm, Cm, D, extra=()):
    """Raise ValueError unless the CUDA kernels take these inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [M, T, D], got {tuple(x.shape)}")
    M, T, Dm = x.shape
    if A.dim() != 2 or A.shape[0] != Dm:
        raise ValueError(f"{name}: A must be [D, N] with D = {Dm}, got {tuple(A.shape)}")
    N = A.shape[1]
    if T < 1 or N < 1:
        raise ValueError(f"{name}: the kernels take T >= 1 and N >= 1, got T = {T}, N = {N}")
    expect = {"dt": (dt, (M, T, Dm), torch.float32), "A": (A, (Dm, N), torch.float32),
              "B": (Bm, (M, T, N), x.dtype), "C": (Cm, (M, T, N), x.dtype),
              "D": (D, (Dm,), torch.float32), **dict(extra)}
    for key, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name}: {key} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def forward(x, dt, A, Bm, Cm, D, boundaries: bool = False):
    """The scan: ``reference`` for a CPU tensor, the CUDA kernel for a CUDA
    tensor (or ValueError if it does not take the inputs). Returns (y, hb);
    hb holds the chunk-start states when ``boundaries`` is set on the card,
    else None."""
    global launches
    if x.device.type == "cpu":
        return reference(x, dt, A, Bm, Cm, D), None
    _check("selective_scan", x, dt, A, Bm, Cm, D)
    x, dt, A, Bm, Cm, D = (t.contiguous() for t in (x, dt, A, Bm, Cm, D))
    M, T, Dm = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    hb = (torch.empty(-(-T // CHUNK), M, N, Dm, dtype=torch.float32, device=x.device)
          if boundaries else None)
    if M == 0 or Dm == 0:
        return y, hb
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    if (lib.nbss_selective_scan_chunk(), lib.nbss_selective_scan_state_group()) != (
            CHUNK, STATE_GROUP):
        raise RuntimeError(f"csrc/selective_scan.cu saves a state every "
                           f"{lib.nbss_selective_scan_chunk()} frames and runs "
                           f"{lib.nbss_selective_scan_state_group()} states a pass, ops/ssm.py "
                           f"expects {CHUNK} and {STATE_GROUP}")
    # float32 scratch for the sum of C . h over the passes of a large N
    acc = (torch.empty(M, T, Dm, dtype=torch.float32, device=x.device)
           if N > STATE_GROUP else None)
    err = lib.nbss_selective_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), hb.data_ptr() if boundaries else None,
        acc.data_ptr() if acc is not None else None, M, T, Dm, N,
        int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed with CUDA error {err}")
    launches += 1
    return y, hb


def backward(x, dt, A, Bm, Cm, D, hb, gy):
    """The scan's adjoint: ``reference_bwd`` for a CPU tensor (hb unused),
    the CUDA kernel for a CUDA tensor, which reads the chunk-start states hb
    written by ``forward(..., boundaries=True)`` on the same inputs.
    Returns (gx, gdt, gA, gB, gC, gD) as ``reference_bwd`` does."""
    global bwd_launches
    if x.device.type == "cpu":
        return reference_bwd(x, dt, A, Bm, Cm, D, gy)
    M, T, Dm = x.shape
    N = A.shape[-1] if A.dim() == 2 else 0
    _check("selective_scan backward", x, dt, A, Bm, Cm, D, {
        "gy": (gy, (M, T, Dm), x.dtype),
        "hb": (hb, (-(-T // CHUNK), M, N, Dm), torch.float32)})
    x, dt, A, Bm, Cm, D, hb, gy = (t.contiguous() for t in (x, dt, A, Bm, Cm, D, hb, gy))
    gx, gdt = torch.empty_like(x), torch.empty_like(dt)
    gB, gC = torch.empty_like(Bm), torch.empty_like(Cm)
    gA, gD = torch.empty_like(A), torch.empty_like(D)
    if M == 0 or Dm == 0:
        return gx, gdt, gA.zero_(), gB.zero_(), gC.zero_(), gD.zero_()
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    ws = torch.empty(lib.nbss_selective_scan_bwd_workspace_floats(M, T, Dm, N),
                     dtype=torch.float32, device=x.device)
    err = lib.nbss_selective_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        hb.data_ptr(), gy.data_ptr(), gx.data_ptr(), gdt.data_ptr(), gA.data_ptr(),
        gB.data_ptr(), gC.data_ptr(), gD.data_ptr(), ws.data_ptr(), M, T, Dm, N,
        int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"selective_scan backward kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return gx, gdt, gA, gB, gC, gD


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, save: bool, kernel: bool):
        if kernel:
            y, hb = forward(x, dt, A, Bm, Cm, D, boundaries=save)
        else:
            y, hb = reference(x, dt, A, Bm, Cm, D), None
        if save:
            ctx.save_for_backward(x, dt, A, Bm, Cm, D, hb)
        ctx.kernel = kernel
        return y

    @staticmethod
    def backward(ctx, gy):
        x, dt, A, Bm, Cm, D, hb = ctx.saved_tensors
        if ctx.kernel:
            grads = backward(x, dt, A, Bm, Cm, D, hb, gy)
        else:
            grads = reference_bwd(x, dt, A, Bm, Cm, D, gy)
        return (*grads, None, None)


def selective_scan(x, dt, A, Bm, Cm, D, kernel: bool = True):
    """y [M, T, D] in x's dtype, differentiable in every input.

    x, Bm, Cm share one dtype (float32 or bfloat16); dt, A and D are float32.
    A CPU tensor takes ``reference`` (and ``reference_bwd`` for its
    gradient). A CUDA tensor launches the kernels, or raises if they do not
    take these inputs; ``kernel=False`` runs the plain versions there too.
    The forward keeps what the backward needs only when a gradient is
    wanted."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan: no kernel for device {x.device}")
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, Bm, Cm, D))
    return _SelectiveScan.apply(x, dt, A, Bm, Cm, D, save, kernel)
