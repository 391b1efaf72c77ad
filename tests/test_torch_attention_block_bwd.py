"""The port's attention-block backward against nbss_tpu.ops.attention_block.

``reference_bwd`` (the plain PyTorch adjoint that a CPU tensor takes, and
the yardstick of the CUDA kernel on the card) is held entry by entry against
the JAX package's ``_fused_block_bwd``, its Pallas backward kernel run in
interpret mode as the JAX tests run it, at small shapes (M <= 6, T <= 40,
H = 16):

- float32: atol and rtol 5e-3 (the JAX package's gradient bound), and
  against torch autograd of the plain forward ``reference`` at 1e-4;
- bfloat16: within one bf16 step at each output's largest magnitude
  (rtol 2**-8), since both round at the same points and only sum in another
  order.

At the edges of the tensor-core backward's 16-frame tiles (T = 16, 17, 64,
65) ``reference_bwd`` is also held against ``jax.vjp`` of the JAX package's
``attention_block`` (its custom_vjp runs the interpreted Pallas backward),
in float32 and bf16 at the bounds above.

The ``autograd.Function`` gives ``reference_bwd``'s gradients on the CPU, and
a loss through the default SpatialNet reaches the input and every LayerNorm
and attention parameter through it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.ops import attention_block as jab
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.ops import attention_block as ab

NAMES = ("dx", "dln", "dA", "dWvo", "dc")


def _operands(rng, M, T, H, nh):
    x = rng.standard_normal((M, T, H)).astype(np.float32)
    g = rng.standard_normal((M, T, H)).astype(np.float32)
    w_in = (rng.standard_normal((H, 3 * H)) * 0.2).astype(np.float32)  # flax [in, out]
    b_in = (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((H, H)) * 0.2).astype(np.float32)
    b_out = (rng.standard_normal((H,)) * 0.1).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal((H,))).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal((H,))).astype(np.float32)
    jfold = jab.fold_weights(*map(jnp.asarray, (ln_s, ln_b, w_in, b_in, w_out, b_out)), nh)
    tfold = ab.fold_weights(*map(torch.from_numpy, (ln_s, ln_b, w_in.T.copy(), b_in,
                                                   w_out.T.copy(), b_out)), nh)
    return x, g, jfold, tfold


def _jax_bwd(x, g, jfold, nh, dtype):
    out = jab._fused_block_bwd(jnp.asarray(x, dtype), *jfold[:3], jnp.asarray(g, dtype),
                               1e-5, nh, 8)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


@pytest.mark.parametrize("M,T,nh", [(6, 40, 4), (3, 17, 2), (2, 1, 4)])
def test_reference_bwd_matches_jax_kernel_fp32(rng, M, T, nh):
    x, g, jfold, tfold = _operands(rng, M, T, 16, nh)
    got = ab.reference_bwd(torch.from_numpy(x), *tfold[:3], torch.from_numpy(g), 1e-5, nh)
    want = _jax_bwd(x, g, jfold, nh, jnp.float32)
    shapes = [(M, T, 16), (2, 16), (nh, 18, 18), (nh, 18, 18), (1, 16)]
    for name, a, w, shape in zip(NAMES, got, want, shapes):
        assert a.dtype == torch.float32 and tuple(a.shape) == shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, atol=5e-3, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("nh", [2, 4])
def test_reference_bwd_matches_autograd_of_reference(rng, nh):
    x, g, _, tfold = _operands(rng, 4, 23, 16, nh)
    leaves = [torch.from_numpy(x).requires_grad_()] + [t.clone().requires_grad_()
                                                        for t in tfold[:4]]
    ab.reference(*leaves, 1e-5, nh).backward(torch.from_numpy(g))
    got = ab.reference_bwd(torch.from_numpy(x), *tfold[:3], torch.from_numpy(g), 1e-5, nh)
    for name, a, leaf in zip(NAMES, got, [leaves[0], leaves[1], leaves[2], leaves[3], leaves[4]]):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_reference_bwd_bf16_rounds_like_jax_kernel(rng):
    x, g, jfold, tfold = _operands(rng, 6, 40, 16, 4)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    got = ab.reference_bwd(xb, *tfold[:3], gb, 1e-5, 4)
    assert got[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got[1:])
    want = _jax_bwd(x, g, jfold, 4, jnp.bfloat16)
    for name, a, w in zip(NAMES, got, want):
        step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)  # one bf16 step at max|w|
        np.testing.assert_allclose(a.float().numpy(), w, atol=step, rtol=2.0 ** -8,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 17, 64, 65])
def test_reference_bwd_matches_jax_vjp_at_tile_edges(rng, T, dtype):
    """At the edges of the tensor-core backward's 16-frame tiles,
    ``reference_bwd`` (its yardstick on the card) against ``jax.vjp`` of the
    JAX package's ``attention_block``, whose custom_vjp runs the interpreted
    Pallas backward: float32 at atol and rtol 5e-3, bf16 within one bf16
    step at each output's largest magnitude, as above."""
    x, g, jfold, tfold = _operands(rng, 2, T, 16, 4)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    _, vjp = jax.vjp(lambda a, ln, A, Wvo, c: jab.attention_block(a, ln, A, Wvo, c, 1e-5, 4),
                     jnp.asarray(x, jdt), *jfold[:4])
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]
    got = ab.reference_bwd(torch.from_numpy(x).to(tdt), *tfold[:3],
                           torch.from_numpy(g).to(tdt), 1e-5, 4)
    for name, a, w in zip(NAMES, got, want):
        assert tuple(a.shape) == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), w, atol=5e-3, rtol=5e-3, err_msg=name)
        else:
            step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            np.testing.assert_allclose(a.float().numpy(), w, atol=step, rtol=2.0 ** -8,
                                       err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_gives_reference_bwd_on_cpu(rng, dtype):
    x, g, _, tfold = _operands(rng, 3, 21, 16, 2)
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    leaves = [xt.clone().requires_grad_()] + [t.clone().requires_grad_() for t in tfold[:4]]
    before = ab.bwd_launches
    y = ab.attention_block(*leaves, 1e-5, 2)
    assert type(y.grad_fn).__name__ == "_AttentionBlockBackward"
    y.backward(gt)
    assert ab.bwd_launches == before  # CPU tensors take the plain version
    want = ab.reference_bwd(xt, *tfold[:3], gt, 1e-5, 2)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert leaf.grad.dtype == w.dtype, name
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0, msg=name)


def test_default_spatialnet_loss_reaches_input_and_attention_parameters(rng):
    """The fused block (the default) passes gradients to everything below it:
    the input, norm_mhsa and mhsa of every layer."""
    net = SpatialNet(dim_input=6, dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32,
                     num_heads=4, conv_groups=(4, 4), dim_squeeze=4, num_freqs=9,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(layer.fused_block for layer in net.layers)
    x = torch.from_numpy(rng.standard_normal((2, 9, 20, 6)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 9, 20, 4)).astype(np.float32))
    (net(x) * w).sum().backward()
    assert x.grad is not None and x.grad.abs().max() > 0
    names = [n for n, _ in net.named_parameters() if ".norm_mhsa." in n or ".mhsa." in n]
    assert len(names) == 2 * 6
    params = dict(net.named_parameters())
    for n in names:
        assert params[n].grad is not None and params[n].grad.abs().max() > 0, n
