"""The port's NBC relative-position block against nbss_tpu.ops.attention_block.

``fold_weights_nbc`` and ``reference_relpos`` (the path a CPU tensor takes)
are held against the JAX package's ``fold_weights_nbc``, its
``_reference_relpos`` and its ``attention_block_relpos``, whose Pallas
kernel runs in interpret mode on the CPU as the JAX tests run it. Inputs are
made from a seed with numpy and handed to both packages.

Bounds: the forward in float32 at atol 2e-4, rtol 1e-4 (the JAX package's
kernel bound); gradients against the JAX ``custom_vjp`` at atol and rtol
5e-3 (its gradient bound); bf16 within one bf16 step (2**-6 for outputs in
[2, 4)) of the interpreted kernel and of ``_reference_relpos``. In bf16
``reference_relpos`` takes the Pallas kernel's rounding points and
``reference_relpos_xla`` those of ``_reference_relpos``: each is held to its
counterpart at one bf16 step, with at most 0.5% of elements differing at all.
The CUDA kernels themselves are held against ``reference_relpos`` in
test_torch_kernels_gpu.py, which needs a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.models.nbc import sincos_position_tables as j_tables
from nbss_tpu.ops import attention_block as jab
from nbss_tpu_torch.models.nbc import sincos_position_tables
from nbss_tpu_torch.ops import attention_block as ab

H, NH = 16, 2
SHAPES = [(6, 29), (3, 1), (9, 13)]  # (M, T): ragged against the Pallas blocks of 8 x 128
NAMES = ("x", "ln", "A", "Gs", "Gc", "Wvo", "c")


def _params(seed, nh=NH, H=H):
    """Seeded NBC attention parameters in the flax layout (Dense kernels
    [in, out], pos_proj [d_model, H], u and v [nh, dh])."""
    rng = np.random.default_rng(seed)
    dh = H // nh

    def w(*shape, s=0.3):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    flax = dict(ln_s=(1 + w(H, s=0.1)), ln_b=w(H, s=0.1), wq=w(H, H), bq=w(H, s=0.1),
                wk=w(H, H), bk=w(H, s=0.1), wv=w(H, H), bv=w(H, s=0.1), wo=w(H, H),
                bo=w(H, s=0.1), wpos=w(H, H), u=w(nh, dh), v=w(nh, dh))
    return flax


def _folds(p, nh=NH):
    order = ("ln_s", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "wpos", "u", "v")
    jfold = jab.fold_weights_nbc(*(jnp.asarray(p[k]) for k in order), nh)
    tw = {k: torch.from_numpy(p[k].T.copy() if k in ("wq", "wk", "wv", "wo", "wpos") else p[k])
          for k in order}
    tfold = ab.fold_weights_nbc(*(tw[k] for k in order), nh)
    return jfold, tfold


def _x(seed, M, T, H=H):
    return np.random.default_rng(seed + 100).standard_normal((M, T, H)).astype(np.float32)


def _tables(T, H=H):
    return [torch.from_numpy(t) for t in sincos_position_tables(T, H)]


@jax.jit
def _j_kernel(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t):
    return jab.attention_block_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, 1e-5, NH)


@functools.partial(jax.jit, static_argnums=(9,))
def _j_kernel_nh(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, nh):
    return jab.attention_block_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, 1e-5, nh)


@functools.partial(jax.jit, static_argnums=(9,))
def _j_reference_nh(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, nh):
    return jab._reference_relpos(x, ln, A, Gs, Gc, Wvo, c, sin_t, cos_t, 1e-5, nh)


def _j_kernel_vjp(args, g):
    y, vjp = jax.vjp(lambda *a: _j_kernel(*a, *args[7:]), *args[:7])
    return y, vjp(g)


def test_tables_match_jax():
    for T in (1, 29):
        for a, b in zip(sincos_position_tables(T, H), j_tables(T, H)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nh", [1, 2, 4])
def test_fold_weights_nbc_match_jax(nh):
    jfold, tfold = _folds(_params(0, nh), nh)
    for name, j, t in zip(("ln", "A", "Gs", "Gc", "Wvo", "c"), jfold[:6], tfold[:6]):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6, err_msg=name)
    assert tfold[6] == jfold[6]


@pytest.mark.parametrize("M,T", SHAPES)
def test_plain_block_matches_jax_kernel_and_reference(M, T):
    jfold, tfold = _folds(_params(1))
    x = _x(1, M, T)
    sin_t, cos_t = _tables(T)
    y = ab.attention_block_relpos(torch.from_numpy(x), *tfold[:6], sin_t, cos_t, 1e-5, NH)
    jargs = (jnp.asarray(x), *jfold[:6], *map(jnp.asarray, j_tables(T, H)))
    y_kernel = np.asarray(_j_kernel(*jargs))
    y_ref = np.asarray(jab._reference_relpos(*jargs, 1e-5, NH))
    np.testing.assert_allclose(y.numpy(), y_kernel, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("M,T", SHAPES[:2])
def test_gradients_match_jax_custom_vjp(M, T):
    """The Function's gradient (autodiff of reference_relpos_xla) against
    ``jax.vjp`` of the JAX block, whose custom_vjp differentiates
    ``_reference_relpos``, for every differentiable operand."""
    jfold, tfold = _folds(_params(2))
    x = _x(2, M, T)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    sin_t, cos_t = _tables(T)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        t.detach().clone().requires_grad_() for t in tfold[:6]]
    y = ab.attention_block_relpos(*leaves, sin_t, cos_t, 1e-5, NH)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    jargs = (jnp.asarray(x), *jfold[:6], *map(jnp.asarray, j_tables(T, H)))
    _, jgrads = _j_kernel_vjp(jargs, jnp.asarray(g))
    for name, a, b in zip(NAMES, grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3, rtol=5e-3, err_msg=name)


def test_plain_block_bf16_within_one_step_of_jax():
    """bf16: the port rounds where ``_reference_relpos`` rounds; the
    interpreted kernel rounds the unnormalized weights instead of the
    probabilities. Both within one bf16 step of the port."""
    jfold, tfold = _folds(_params(4))
    M, T = SHAPES[0]
    x = _x(4, M, T)
    sin_t, cos_t = _tables(T)
    y = ab.attention_block_relpos(torch.from_numpy(x).to(torch.bfloat16), *tfold[:6], sin_t,
                                  cos_t, 1e-5, NH)
    assert y.dtype == torch.bfloat16
    jargs = (jnp.asarray(x, jnp.bfloat16), *jfold[:6], *map(jnp.asarray, j_tables(T, H)))
    for want in (_j_kernel(*jargs), jab._reference_relpos(*jargs, 1e-5, NH)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=2.0 ** -6, rtol=2.0 ** -8)


def _bf16_steps(got, want, x):
    """|got - want| in units of one bf16 step (2**-7 of the binade) of the
    largest term of y = x + o + c: the output, the residual x or o + c."""
    mag = np.maximum(np.maximum(np.abs(want), np.abs(x)), np.abs(want - x))
    mag = np.maximum(mag, np.finfo(np.float32).tiny)
    step = np.exp2(np.floor(np.log2(mag)) - 7)
    return np.abs(got - want) / step


# (M, T, H, nh): the file's shape, and a ragged one at a wider width with more heads
BF16_SHAPES = [(6, 29, H, NH), (5, 37, 48, 4)]


@pytest.mark.parametrize("M,T,Hw,nh", BF16_SHAPES)
@pytest.mark.parametrize("plain", ["kernel", "xla"])
def test_plain_block_bf16_rounds_like_its_jax_counterpart(M, T, Hw, nh, plain):
    """In bf16 ``reference_relpos`` rounds where the Pallas ``_kernel_relpos``
    does (e unnormalised, pv divided by its ones lane, heads summed in
    float32) and is held against the interpreted ``attention_block_relpos``;
    ``reference_relpos_xla`` rounds where ``_reference_relpos`` does (p =
    softmax) and is held against it. Every element is within one bf16 step
    of the largest term of its sum (float32 sums in another order can move a
    rounding by one step), and at most 0.5% of them differ at all (measured:
    0% and 0.07% for the plain version against the kernel, 0.04% and 0.06%
    for the counterpart against ``_reference_relpos``; 26% and 40% of
    elements differ between the two rounding schemes)."""
    jfold, tfold = _folds(_params(4, nh, Hw), nh)
    x = _x(4, M, T, Hw)
    sin_t, cos_t = _tables(T, Hw)
    fn = ab.reference_relpos if plain == "kernel" else ab.reference_relpos_xla
    y = fn(torch.from_numpy(x).to(torch.bfloat16), *tfold[:6], sin_t, cos_t, 1e-5, nh)
    assert y.dtype == torch.bfloat16
    jargs = (jnp.asarray(x, jnp.bfloat16), *jfold[:6], *map(jnp.asarray, j_tables(T, Hw)))
    want = (_j_kernel_nh if plain == "kernel" else _j_reference_nh)(*jargs, nh)
    got, want = y.float().numpy(), np.asarray(want.astype(jnp.float32))
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    assert _bf16_steps(got, want, xb).max() <= 1.0
    assert np.mean(got != want) <= 0.005


def test_cpu_tensor_takes_plain_path_without_launch():
    _, tfold = _folds(_params(5))
    x = torch.from_numpy(_x(5, 3, 11))
    sin_t, cos_t = _tables(11)
    before = ab.relpos_launches
    y = ab.attention_block_relpos(x, *tfold[:6], sin_t, cos_t, 1e-5, NH)
    assert ab.relpos_launches == before and y.grad_fn is None
    np.testing.assert_array_equal(
        y.numpy(), ab.reference_relpos(x, *tfold[:6], sin_t, cos_t, 1e-5, NH).numpy())


def test_no_plain_fallback_for_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, and the
    kernel's checks refuse a CPU tensor (the wrapper never hands it one)."""
    _, tfold = _folds(_params(6))
    sin_t, cos_t = _tables(8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ab.attention_block_relpos(torch.empty(2, 8, H, device="meta"), *tfold[:6], sin_t,
                                  cos_t, 1e-5, NH)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ab._check_relpos(torch.zeros(2, 8, 192), *tfold[:6], sin_t, cos_t, NH)
