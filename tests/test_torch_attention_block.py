"""The port's attention block against nbss_tpu.ops.attention_block.

fold_weights and the plain PyTorch version (the path a CPU tensor takes) are
held against the JAX package's fold, its Pallas kernel run in interpret mode
as the JAX tests run it, and its ``_reference``, at the JAX tests' shapes and
bounds (atol 2e-4, rtol 1e-4). The CUDA kernel itself is held against the
plain version in test_torch_kernels_gpu.py, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.ops import attention_block as jab
from nbss_tpu_torch.ops import attention_block as ab


def _operands(rng, M, T, H, nh):
    x = rng.standard_normal((M, T, H)).astype(np.float32)
    w_in = (rng.standard_normal((H, 3 * H)) * 0.2).astype(np.float32)  # flax [in, out]
    b_in = (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((H, H)) * 0.2).astype(np.float32)
    b_out = (rng.standard_normal((H,)) * 0.1).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal((H,))).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal((H,))).astype(np.float32)
    jfold = jab.fold_weights(*map(jnp.asarray, (ln_s, ln_b, w_in, b_in, w_out, b_out)), nh)
    tfold = ab.fold_weights(*map(torch.from_numpy, (ln_s, ln_b, w_in.T.copy(), b_in,
                                                   w_out.T.copy(), b_out)), nh)
    return x, jfold, tfold


@pytest.mark.parametrize("nh", [2, 4])
def test_fold_weights_match_jax(rng, nh):
    _, jfold, tfold = _operands(rng, 6, 40, 16, nh)
    for j, t in zip(jfold[:4], tfold[:4]):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
    assert tfold[4] == jfold[4]


@pytest.mark.parametrize("nh", [2, 4])
def test_plain_block_matches_jax_kernel_and_reference(rng, nh):
    x, jfold, tfold = _operands(rng, 6, 40, 16, nh)
    y = ab.attention_block(torch.from_numpy(x), *tfold[:4], 1e-5, nh).numpy()
    y_kernel = np.asarray(jab.attention_block(jnp.asarray(x), *jfold[:4], 1e-5, nh))
    y_ref = np.asarray(jab._reference(jnp.asarray(x), *jfold[:4], 1e-5, nh))
    np.testing.assert_allclose(y, y_kernel, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(y, y_ref, atol=2e-4, rtol=1e-4)


def test_plain_block_bf16_rounds_like_jax_reference(rng):
    """Same bf16 rounding points as the JAX reference: at most one bf16 step
    (2**-6 for outputs in [2, 4)) apart, from float32 sums in another order."""
    x, jfold, tfold = _operands(rng, 6, 40, 16, 4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = ab.attention_block(xb, *tfold[:4], 1e-5, 4)
    assert y.dtype == torch.bfloat16
    y_ref = jab._reference(jnp.asarray(x, jnp.bfloat16), *jfold[:4], 1e-5, 4)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref.astype(jnp.float32)),
                               atol=2.0 ** -6, rtol=2.0 ** -8)


def test_cpu_tensor_takes_plain_path_without_launch(rng):
    x, _, tfold = _operands(rng, 3, 17, 16, 2)
    before = ab.launches
    y = ab.attention_block(torch.from_numpy(x), *tfold[:4], 1e-5, 2)
    assert ab.launches == before
    np.testing.assert_array_equal(y.numpy(), ab.reference(torch.from_numpy(x), *tfold[:4],
                                                          1e-5, 2).numpy())


def test_no_plain_fallback_for_other_devices(rng):
    """A tensor that is not on the CPU never silently takes the plain path."""
    _, _, tfold = _operands(rng, 2, 8, 16, 2)
    x = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ab.attention_block(x, *tfold[:4], 1e-5, 2)


def _bf16_steps(got, want, x):
    """|got - want| in units of one bf16 step (2**-7 of the binade) of the
    largest term of y = x + o + c: the output, the residual x or o + c."""
    mag = np.maximum(np.maximum(np.abs(want), np.abs(x)), np.abs(want - x))
    mag = np.maximum(mag, np.finfo(np.float32).tiny)
    step = np.exp2(np.floor(np.log2(mag)) - 7)
    return np.abs(got - want) / step


@pytest.mark.parametrize("M, T, H, nh", [(6, 40, 16, 4), (4, 100, 96, 4)])
def test_plain_block_bf16_rounds_like_pallas_kernel(rng, M, T, H, nh):
    """In bf16 the plain version takes the Pallas kernel's rounding points
    (e rounded unnormalised, vo rounded, pv divided by the float32 sum of the
    rounded e, heads summed in float32): against the interpreted Pallas
    attention_block every element is within one bf16 step of the largest
    term of its sum (float32 sums in another order can move the final
    rounding by one step), and fewer than 1% of them differ at all (0% and
    0.07% measured; 12% and 38% with the JAX _reference's rounding points)."""
    x, jfold, tfold = _operands(rng, M, T, H, nh)
    y = ab.reference(torch.from_numpy(x).to(torch.bfloat16), *tfold[:4], 1e-5, nh)
    assert y.dtype == torch.bfloat16
    y_kernel = jab.attention_block(jnp.asarray(x, jnp.bfloat16), *jfold[:4], 1e-5, nh)
    got, want = y.float().numpy(), np.asarray(y_kernel.astype(jnp.float32))
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    assert _bf16_steps(got, want, xb).max() <= 1.0
    assert np.mean(got != want) < 0.01
