"""The port's narrow-band attention against nbss_tpu on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The JAX
package's ``narrowband_attention`` runs its Pallas kernels in interpret mode
on the CPU, as ``tests/test_fused_attention.py`` runs them; its gradient is
its hand-written Pallas backward, reached through ``jax.vjp``.

Bounds: the forward in float32 at atol 2e-4, rtol 1e-4 (the JAX package's
kernel bound); in bfloat16 within one bf16 step of the interpreted kernel,
whose rounding points ``reference`` follows (the unnormalized weights
rounded, the float32 product with v scaled by 1 / sum(e), one final
rounding), so only the order of the float32 sums differs. The gradients at
atol and rtol 5e-3 (the JAX package's gradient bound). The Function on the
CPU is ``reference`` and ``reference_bwd`` exactly. At the edges of the
tensor-core forward's tiles and key chunk (T = 16, 17, 64, 65, 257) both
plain versions are held against the interpreted kernels in float32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.ops.attention import narrowband_attention as j_attention
from nbss_tpu_torch.models.online_spatialnet import alibi_mask, local_causal_mask
from nbss_tpu_torch.ops import attention as att

NH = 4
# (M, T, dh, dv): ragged M and T against the Pallas blocks (8 rows, 128 frames),
# and a v head wider than the q/k head
SHAPES = [(5, 23, 6, 6), (3, 9, 8, 12)]
MASKS = ["none", "causal", "alibi"]


def _mask(kind, T):
    """None, a shared bounded causal [T, T] or a per-head ALiBi [nh, T, T]
    mask, clamped at -1e30 as MultiheadAttention hands it to the kernel."""
    if kind == "none":
        return None
    m = local_causal_mask(T, 7) if kind == "causal" else alibi_mask(T, 7, NH)
    return np.maximum(m, -1e30).astype(np.float32)


def _inputs(seed, M, T, dh, dv):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((M, T, NH * dh)).astype(np.float32) for _ in range(2))
    v, g = (rng.standard_normal((M, T, NH * dv)).astype(np.float32) for _ in range(2))
    return q, k, v, g


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("M,T,dh,dv", SHAPES)
def test_reference_matches_pallas_forward_fp32(kind, M, T, dh, dv):
    q, k, v, _ = _inputs(0, M, T, dh, dv)
    mask = _mask(kind, T)
    want = j_attention(*_jax([q, k, v]), None if mask is None else jnp.asarray(mask), NH)
    got = att.reference(*_torch([q, k, v, mask]), NH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", MASKS)
def test_reference_matches_pallas_forward_bf16(kind):
    M, T, dh, dv = SHAPES[0]
    q, k, v, _ = _inputs(1, M, T, dh, dv)
    mask = _mask(kind, T)
    want = _f32(j_attention(*_jax([q, k, v], jnp.bfloat16),
                            None if mask is None else jnp.asarray(mask), NH))
    got = att.reference(*_torch([q, k, v], torch.bfloat16),
                        None if mask is None else torch.from_numpy(mask), NH)
    assert got.dtype == torch.bfloat16
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)  # one bf16 step
    assert (np.abs(_f32(got) - want) <= step).all(), np.abs(_f32(got) - want).max()


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("M,T,dh,dv", SHAPES)
def test_reference_bwd_matches_pallas_backward(kind, M, T, dh, dv):
    q, k, v, g = _inputs(2, M, T, dh, dv)
    mask = _mask(kind, T)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, jm, NH), *_jax([q, k, v]))
    want = vjp(jnp.asarray(g))
    got = att.reference_bwd(*_torch([q, k, v, mask, g]), NH)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-3, rtol=5e-3, err_msg=name)


def test_reference_bwd_matches_pallas_backward_bf16():
    """In bf16 the adjoint keeps the Pallas kernel's rounding points: each
    cotangent within 5e-3 x its largest value of the interpreted kernel's."""
    M, T, dh, dv = SHAPES[0]
    q, k, v, g = _inputs(3, M, T, dh, dv)
    mask = _mask("alibi", T)
    _, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, jnp.asarray(mask), NH),
                     *_jax([q, k, v], jnp.bfloat16))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    got = att.reference_bwd(*_torch([q, k, v], torch.bfloat16), torch.from_numpy(mask),
                            torch.from_numpy(g).bfloat16(), NH)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        w = _f32(w)
        np.testing.assert_allclose(_f32(a), w, atol=5e-3 * np.abs(w).max(), rtol=5e-3,
                                   err_msg=name)


# the edges of the tensor-core forward's tiles: 16 query rows, 16-key blocks,
# and the 256-key chunk beyond which it takes two passes over the chunks
EDGE_T = [16, 17, 64, 65, 257]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", EDGE_T)
def test_reference_and_adjoint_match_pallas_at_tile_edges(T, dtype):
    """``reference`` and ``reference_bwd``, the yardsticks the card holds the
    kernels to, against the interpreted Pallas forward and its backward
    through ``jax.vjp`` at the tile edges: float32 at atol 2e-4, rtol 1e-4
    (forward) and 5e-3 (adjoint); bf16 within one bf16 step (forward) and
    5e-3 x each cotangent's largest value (adjoint), as above."""
    M, dh, dv = 2, 8, 8
    q, k, v, g = _inputs(T, M, T, dh, dv)
    mask = _mask("causal" if T % 2 else "alibi", T)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    want, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, jnp.asarray(mask), NH),
                        *_jax([q, k, v], jdt))
    tq, tk, tv = _torch([q, k, v], tdt)
    got = att.reference(tq, tk, tv, torch.from_numpy(mask), NH)
    grads = att.reference_bwd(tq, tk, tv, torch.from_numpy(mask), torch.from_numpy(g).to(tdt),
                              NH)
    want, wants = _f32(want), [_f32(w) for w in vjp(jnp.asarray(g, jdt))]
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), want, atol=2e-4, rtol=1e-4)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)  # one bf16 step
        assert (np.abs(_f32(got) - want) <= step).all(), np.abs(_f32(got) - want).max()
    for name, a, w in zip(("dq", "dk", "dv"), grads, wants):
        assert a.dtype == tdt, name
        atol = 5e-3 if dtype == "float32" else 5e-3 * np.abs(w).max()
        np.testing.assert_allclose(_f32(a), w, atol=atol, rtol=5e-3, err_msg=name)


def test_reference_matches_pallas_at_nbc_head_width():
    """NBC's augmented q/k heads (dh = 24 + d_model = 216) with dv = 24, the
    widths the widened kernels take: the forward at atol 2e-4, rtol 1e-4 and
    the adjoint at 5e-3 against the interpreted Pallas kernels, float32."""
    M, T, dh, dv = 2, 9, 216, 24
    q, k, v, g = _inputs(9, M, T, dh, dv)
    q = q / np.sqrt(dh / 24.0)  # scores of the size NBC's pre-scaled q' gives
    want, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, None, NH), *_jax([q, k, v]))
    got = att.reference(*_torch([q, k, v]), None, NH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    for name, a, w in zip(("dq", "dk", "dv"), att.reference_bwd(*_torch([q, k, v]), None,
                                                                torch.from_numpy(g), NH),
                          vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-3, rtol=5e-3, err_msg=name)
    att._shape("narrowband_attention", *_torch([q, k, v]), None, NH)  # the checks take it


def test_reference_bwd_is_the_adjoint_of_reference():
    """In float64, where no rounding point matters, reference_bwd equals
    torch autograd through reference."""
    q, k, v, g = (torch.from_numpy(a).double() for a in _inputs(4, 3, 11, 5, 7))
    mask = torch.from_numpy(_mask("alibi", 11)).double()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(att.reference(*leaves, mask, NH), leaves, g)
    got = att.reference_bwd(q, k, v, mask, g, NH)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, atol=1e-10, rtol=1e-8, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["none", "alibi"])
def test_function_on_cpu_is_reference_and_reference_bwd(dtype, kind):
    M, T, dh, dv = SHAPES[1]
    q, k, v, g = _inputs(5, M, T, dh, dv)
    mask = None if kind == "none" else torch.from_numpy(_mask(kind, T)).requires_grad_()
    qt, kt, vt = _torch([q, k, v], dtype)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    before = (att.launches, att.bwd_launches)
    o = att.narrowband_attention(*leaves, mask, NH)
    assert torch.equal(o, att.reference(qt, kt, vt, mask, NH))
    gt = torch.from_numpy(g).to(dtype)
    inputs = leaves + ([mask] if mask is not None else [])
    got = torch.autograd.grad(o, inputs, gt, allow_unused=True)
    for a, w, p in zip(got, att.reference_bwd(qt, kt, vt, mask, gt, NH), (qt, kt, vt)):
        assert a.dtype == p.dtype and torch.equal(a, w)
    if mask is not None:
        assert got[3] is None  # the mask gets no gradient
    assert (att.launches, att.bwd_launches) == before  # the plain versions, no kernel


def test_function_gradcheck_in_float64():
    q, k, v, _ = (torch.from_numpy(a).double().requires_grad_()
                  for a in _inputs(6, 2, 5, 3, 2))
    mask = torch.from_numpy(_mask("causal", 5)).double()
    assert torch.autograd.gradcheck(lambda a, b, c: att.narrowband_attention(a, b, c, mask, NH),
                                    (q, k, v))


def test_serving_saves_nothing_for_the_backward():
    q, k, v, _ = _torch(_inputs(7, *SHAPES[0]))
    with torch.no_grad():
        o = att.narrowband_attention(q, k, v, None, NH)
    assert o.grad_fn is None
    o = att.narrowband_attention(q, k, v, None, NH)  # no input wants a gradient
    assert o.grad_fn is None


def test_function_refuses_other_devices():
    q, k, v, _ = _torch(_inputs(8, *SHAPES[0]))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        att.narrowband_attention(*[t.to("meta") for t in (q, k, v)], None, NH)


@pytest.mark.parametrize("shapes,nh,mask_shape,match", [
    (((2, 5, 2 * 257), (2, 5, 2 * 257), (2, 5, 2 * 24)), 2, None, "head widths"),  # q/k > 256
    (((2, 5, 8), (2, 5, 8), (2, 5, 8 * 65)), 8, None, "head widths"),
    (((2, 5, 8), (2, 6, 8), (2, 5, 8)), 4, None, "k must be"),
    (((2, 5, 8), (2, 5, 8), (2, 5, 6)), 4, None, "nh \\* dv"),
    (((2, 5, 8), (2, 5, 8), (2, 5, 8)), 4, (3, 5, 5), "mask must be"),
    (((2, 5, 9), (2, 5, 9), (2, 5, 8)), 4, None, "nh \\* dh"),
])
def test_kernel_checks_refuse_what_the_kernels_do_not_take(shapes, nh, mask_shape, match):
    """The checks the wrappers make before a launch, on CPU tensors of the
    shapes in question: a q/k head width above 256 (one past the widened
    limit that takes NBC's 216), a v head width above 64, mismatched shapes,
    a mask of another shape."""
    q, k, v = (torch.zeros(s) for s in shapes)
    mask = None if mask_shape is None else torch.zeros(mask_shape)
    with pytest.raises(ValueError, match=match):
        att._shape("narrowband_attention", q, k, v, mask, nh)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        att.forward(*(t.to("meta") for t in (q, k, v)), mask, nh)
