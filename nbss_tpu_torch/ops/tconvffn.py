"""Temporal conv-FFN of the offline SpatialNet layer, as one fused op.

Counterpart of ``nbss_tpu/ops/tconvffn.py``. The chain is

    LN -> 1x1 up -> SiLU -> gconv1 -> SiLU -> gconv2 -> GroupNorm -> SiLU
       -> gconv3 -> SiLU -> 1x1 down

on x [M, T, H] (M = B*F independent sequences), with grouped k=3 'same'
convolutions along T; the caller adds the residual. The parameters are a dict
in the port's torch layout (``PARAM_NAMES``): ``w_up`` [FF, H] and
``w_down`` [H, FF] as Linear weights, ``w_c1..3`` [FF, FF/groups, 3] as
Conv1d weights, the norms' scales and biases and every bias as vectors.

``reference`` is the plain PyTorch version with the Pallas kernel's rounding
points (``_kernel``): every weight, bias, scale and shift is cast to x's
dtype first; LN and GN take float32 statistics (var = E[y^2] - E[y]^2, eps
1e-5) and round once, then scale and shift in x's dtype; every product
accumulates in float32 and is rounded before its bias is added; each conv is
``rnd(rnd(rnd(m0 + m1) + m2) + b)`` over its three taps; SiLU is a / (1 +
exp(-a)) in float32 from the rounded value, rounded once. ``reference_xla``
is the counterpart of the JAX package's ``_ref_tconvffn``, computed in x's
dtype with PyTorch's own ops; the gradient is its autodiff, as the JAX
``custom_vjp`` differentiates ``_ref_tconvffn``.

``tconvffn`` is a ``torch.autograd.Function``. For a CUDA tensor its forward
launches a hand-written kernel that replaces the Pallas TPU kernel
``fused_tconvffn`` -> ``_fused_forward`` / ``_kernel``: bf16 inputs the
tensor-core kernel ``csrc/tconvffn_tc.cu`` (mma.sync on bf16, float32
accumulators; its weight fragments laid out by ``_tc_operands`` on every
call), float32 inputs the CUDA-core kernel ``csrc/tconvffn.cu``; for a CPU
tensor, or with ``kernel=False``, it runs ``reference``. It saves only x and
the parameters; its backward recomputes ``reference_xla`` under autograd at
x's dtype and launches no kernel. The kernels do each grouped conv directly
(FF/groups inputs x 3 taps an output), not as the Pallas kernel's
block-diagonal dense product, so they do an eighth of that arithmetic: at
the flagship's serving shape (M = 2064, T = 251, H = 96, FF = 192) about 81
GFLOP and 199 MB of x and y in bf16.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

PARAM_NAMES = ("ln_scale", "ln_bias", "w_up", "b_up", "w_c1", "b_c1", "w_c2", "b_c2",
               "gn_scale", "gn_bias", "w_c3", "b_c3", "w_down", "b_down")
KERNEL_WIDTHS = ((96, 192), (192, 384))  # (H, FF) the kernel is compiled for
KERNEL_GROUPS = 8

VECTOR_NAMES = tuple(k for k in PARAM_NAMES if not k.startswith("w_"))

launches = 0  # kernel launches made by tconvffn / forward since import
tc_launches = 0  # of those, launches of the bf16 tensor-core kernel


def params_from_sequential(seq) -> dict:
    """The parameter dict of a SpatialNet layer's ``tconvffn`` ``nn.Sequential``
    (0 LN, 1 up, 3/5/8 grouped convs, 6 GN, 10 down), as views of its
    parameters, so that gradients reach them."""
    return {"ln_scale": seq[0].weight, "ln_bias": seq[0].bias,
            "w_up": seq[1].weight[:, :, 0], "b_up": seq[1].bias,
            "w_c1": seq[3].weight, "b_c1": seq[3].bias,
            "w_c2": seq[5].weight, "b_c2": seq[5].bias,
            "gn_scale": seq[6].weight, "gn_bias": seq[6].bias,
            "w_c3": seq[8].weight, "b_c3": seq[8].bias,
            "w_down": seq[10].weight[:, :, 0], "b_down": seq[10].bias}


def _grouped(a, w, groups: int):
    """Grouped 1x1 map of one conv tap: a [M, T, FF] by w [FF, FF/groups]
    (output channel, input channel of its group)."""
    M, T, FF = a.shape
    cpg = FF // groups
    y = torch.einsum("mtgi,goi->mtgo", a.reshape(M, T, groups, cpg),
                     w.reshape(groups, cpg, cpg))
    return y.reshape(M, T, FF)


def _shifted(a):
    """(a at t-1, a at t+1), zero outside the sequence ('same' padding)."""
    return F.pad(a, (0, 0, 1, 0))[:, :-1], F.pad(a, (0, 0, 0, 1))[:, 1:]


def reference(x, params: dict, groups: int = KERNEL_GROUPS, eps: float = 1e-5):
    """Plain PyTorch version of the chain with the Pallas kernel's rounding
    points (see the module docstring). x [M, T, H] -> [M, T, H] in x's dtype."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    def silu(a):
        return rnd(a / (1.0 + torch.exp(-a)))

    def conv(a, w, b):
        prev, nxt = _shifted(a)
        m0, m1, m2 = (rnd(_grouped(t, w[..., k], groups)) for k, t in enumerate((prev, a, nxt)))
        return rnd(rnd(rnd(m0 + m1) + m2) + b)

    p = {k: rnd(v.to(f32)) for k, v in params.items()}
    M, T, _ = x.shape
    FF = p["w_up"].shape[0]
    x32 = x.to(f32)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    y = rnd((x32 - mu) * torch.rsqrt(var + eps))
    y = rnd(rnd(y * p["ln_scale"]) + p["ln_bias"])
    y = silu(rnd(rnd(y @ p["w_up"].t()) + p["b_up"]))
    y = silu(conv(y, p["w_c1"], p["b_c1"]))
    y = conv(y, p["w_c2"], p["b_c2"])
    yg = y.reshape(M, T, groups, FF // groups)
    mu = yg.mean((1, 3), keepdim=True)
    var = (yg * yg).mean((1, 3), keepdim=True) - mu * mu
    y = rnd(((yg - mu) * torch.rsqrt(var + eps)).reshape(M, T, FF))
    y = silu(rnd(rnd(y * p["gn_scale"]) + p["gn_bias"]))
    y = silu(conv(y, p["w_c3"], p["b_c3"]))
    return (rnd(y @ p["w_down"].t()) + p["b_down"]).to(dt)


def reference_xla(x, params: dict, groups: int = KERNEL_GROUPS, eps: float = 1e-5):
    """Counterpart of the JAX package's ``_ref_tconvffn``: the same chain in
    x's dtype with PyTorch's ops (float32 only for the norms' statistics).
    Differentiable in x and every parameter; the Function's backward is its
    autodiff."""
    dt = x.dtype
    p = {k: v.to(dt) for k, v in params.items()}

    def conv(a, w, b):
        prev, nxt = _shifted(a)
        return (_grouped(prev, w[..., 0], groups) + _grouped(a, w[..., 1], groups)
                + _grouped(nxt, w[..., 2], groups)) + b

    M, T, _ = x.shape
    FF = p["w_up"].shape[0]
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    y = ((x32 - mu) * torch.rsqrt(var + eps)).to(dt)
    y = y * p["ln_scale"] + p["ln_bias"]
    y = F.silu(y @ p["w_up"].t() + p["b_up"])
    y = F.silu(conv(y, p["w_c1"], p["b_c1"]))
    y = conv(y, p["w_c2"], p["b_c2"])
    yg = y.reshape(M, T, groups, FF // groups).float()
    mu = yg.mean((1, 3), keepdim=True)
    var = (yg * yg).mean((1, 3), keepdim=True) - mu * mu
    y = ((yg - mu) * torch.rsqrt(var + eps)).reshape(M, T, FF).to(dt)
    y = F.silu(y * p["gn_scale"] + p["gn_bias"])
    y = F.silu(conv(y, p["w_c3"], p["b_c3"]))
    return y @ p["w_down"].t() + p["b_down"]


def _param_shapes(H: int, FF: int, groups: int) -> dict:
    """Each parameter's shape in the torch layout."""
    cpg = FF // groups
    return {"ln_scale": (H,), "ln_bias": (H,), "w_up": (FF, H), "b_up": (FF,),
            "w_c1": (FF, cpg, 3), "b_c1": (FF,), "w_c2": (FF, cpg, 3), "b_c2": (FF,),
            "gn_scale": (FF,), "gn_bias": (FF,), "w_c3": (FF, cpg, 3), "b_c3": (FF,),
            "w_down": (H, FF), "b_down": (H,)}


def _check(x, params: dict, groups: int):
    """Raise ValueError unless the CUDA kernel takes these inputs."""
    name = "tconvffn"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [M, T, H], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    M, T, H = x.shape
    FF = params["w_up"].shape[0]
    if (H, FF) not in KERNEL_WIDTHS or groups != KERNEL_GROUPS or T < 1:
        raise ValueError(f"{name}: the kernel takes (H, FF) in {KERNEL_WIDTHS}, "
                         f"{KERNEL_GROUPS} groups and T >= 1, got H = {H}, FF = {FF}, "
                         f"groups = {groups}, T = {T}")
    expect = _param_shapes(H, FF, groups)
    if set(params) != set(expect):
        raise ValueError(f"{name}: params must hold {sorted(expect)}, got {sorted(params)}")
    for key, shape in expect.items():
        t = params[key]
        if tuple(t.shape) != shape or not t.is_floating_point() or t.device != x.device:
            raise ValueError(f"{name}: {key} must be a float {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_operands(params: dict) -> torch.Tensor:
    """The CUDA-core kernel's one float32 parameter buffer: the 1x1 weights
    as [in, out] and the conv weights as [tap, input of the group, output],
    in the order of ``PARAM_NAMES``."""

    def lay(key, t):
        if key in ("w_up", "w_down"):
            t = t.t()
        elif key.startswith("w_c"):
            t = t.permute(2, 1, 0)
        return t.to(torch.float32).reshape(-1)

    return torch.cat([lay(k, params[k]) for k in PARAM_NAMES])


def _fragments(w):
    """Matrices w [..., K, N] (input, output) as the B fragments of mma.sync
    [..., N/8, K/8, 32, 2]: entry (n, kb, lane, e) is
    w[8 kb + 2 (lane % 4) + e, 8 n + lane // 4], so that lane's 32-bit word
    (n, kb) is its register for n-tile n and the 8-deep k block kb."""
    *lead, K, N = w.shape
    nd = len(lead)
    v = w.reshape(*lead, K // 8, 4, 2, N // 8, 8)  # [kb, t, e, n, g]
    v = v.permute(*range(nd), nd + 3, nd, nd + 4, nd + 1, nd + 2)  # [n, kb, g, t, e]
    return v.reshape(*lead, N // 8, K // 8, 32, 2)


@functools.lru_cache(maxsize=None)
def _tc_index(H: int, FF: int, groups: int, device: torch.device):
    """Indices into the concatenated parameters (``PARAM_NAMES`` order, each
    flattened) of the tensor-core kernel's two buffers: its bf16 weight
    fragments (w_up, w_c1, w_c2, w_c3, w_down; a conv's per tap and group)
    and its vectors (``VECTOR_NAMES``)."""
    cpg = FF // groups
    shapes = _param_shapes(H, FF, groups)
    idx, off = {}, 0
    for k in PARAM_NAMES:
        n = torch.Size(shapes[k]).numel()
        idx[k] = torch.arange(off, off + n).reshape(shapes[k])
        off += n

    def conv(w):  # [FF, cpg, 3] -> [tap, group, input, output]
        return w.reshape(groups, cpg, cpg, 3).permute(3, 0, 2, 1)

    mats = [idx["w_up"].t(), *(conv(idx[f"w_c{i}"]) for i in (1, 2, 3)), idx["w_down"].t()]
    frags = torch.cat([_fragments(w).reshape(-1) for w in mats])
    vecs = torch.cat([idx[k] for k in VECTOR_NAMES])
    return frags.to(device), vecs.to(device)


def _tc_operands(params: dict, groups: int = KERNEL_GROUPS):
    """The tensor-core kernel's operands: every parameter rounded to bf16,
    the weights as mma.sync B fragments (``_fragments``) in one bf16 buffer,
    the vectors as one float32 buffer. Three small gathers a call."""
    FF, H = params["w_up"].shape
    flat = torch.cat([params[k].detach().reshape(-1) for k in PARAM_NAMES]).to(torch.bfloat16)
    widx, vidx = _tc_index(H, FF, groups, flat.device)
    return flat[widx], flat[vidx].to(torch.float32)


def forward(x, params: dict, groups: int = KERNEL_GROUPS, eps: float = 1e-5):
    """Launch the CUDA kernel on x [M, T, H] (on the card: bfloat16 on the
    tensor-core kernel, float32 on the CUDA-core one), or raise ValueError if
    it does not take the inputs. No gradient."""
    global launches, tc_launches
    _check(x, params, groups)
    M, T, H = x.shape
    FF = params["w_up"].shape[0]
    y = torch.empty_like(x)
    if M == 0:
        return y
    from nbss_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = torch.empty(M, T, FF, dtype=x.dtype, device=x.device)
    tc = x.dtype == torch.bfloat16
    if tc:
        with torch.no_grad():
            frags, vecs = _tc_operands(params, groups)
        err = lib.nbss_tconvffn_tc_fwd(
            x.data_ptr(), frags.data_ptr(), vecs.data_ptr(), y.data_ptr(), ws.data_ptr(),
            M, T, H, FF, groups, ctypes.c_float(eps), stream)
    else:
        with torch.no_grad():
            ops = _kernel_operands(params)
        tiles = -(-T // lib.nbss_tconvffn_tile_frames())
        partials = torch.empty(M, tiles, groups, 2, dtype=torch.float32, device=x.device)
        err = lib.nbss_tconvffn_fwd(
            x.data_ptr(), ops.data_ptr(), y.data_ptr(), ws.data_ptr(), partials.data_ptr(),
            M, T, H, FF, groups, ctypes.c_float(eps), stream)
    if err != 0:
        raise RuntimeError(f"tconvffn {'tensor-core ' if tc else ''}kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    tc_launches += tc
    return y


class _TConvFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, eps, kernel, *values):
        ctx.save_for_backward(x, *values)
        ctx.groups, ctx.eps = groups, eps
        params = dict(zip(PARAM_NAMES, values))
        if x.device.type == "cpu" or not kernel:
            return reference(x, params, groups, eps)
        return forward(x, params, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, *values = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, *values)]
            y = reference_xla(leaves[0], dict(zip(PARAM_NAMES, leaves[1:])), ctx.groups,
                              ctx.eps)
            grads = torch.autograd.grad(y, leaves, g)
        return (grads[0], None, None, None, *grads[1:])


def tconvffn(x, params: dict, groups: int = KERNEL_GROUPS, eps: float = 1e-5,
             kernel: bool = True):
    """The chain on x [M, T, H] (float32 or bfloat16) -> [M, T, H] in x's
    dtype, differentiable in x and every parameter of ``params`` (keys
    ``PARAM_NAMES``, torch layout).

    A CPU tensor takes ``reference``; a CUDA tensor launches the kernel, or
    raises if it does not take these inputs; ``kernel=False`` takes
    ``reference`` on the card too. The gradient is the autodiff of
    ``reference_xla`` on every device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tconvffn: no kernel for device {x.device}")
    return _TConvFFN.apply(x, groups, eps, kernel, *(params[k] for k in PARAM_NAMES))
