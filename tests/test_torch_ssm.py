"""The port's selective scan and Mamba block against nbss_tpu on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The JAX
package's Pallas kernels run in interpret mode on the CPU, as its own tests
run them (``t_chunk=4``, T ragged against it).

Bounds: the forward in float32 at atol 2e-4, rtol 1e-4 (the JAX package's
kernel bound); in bfloat16 within one bf16 step of the Pallas kernel's
output, whose rounding points ``reference`` follows (C . h rounded, then the
D x term added and rounded again), so only the order of the float32 sums
differs. The adjoint at atol and rtol 5e-3 (the JAX package's gradient
bound) against both the Pallas backward with its wrapper's D terms and
``jax.vjp`` of ``selective_scan``. The Function on the CPU is ``reference``
and ``reference_bwd`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.models.mamba import MambaBlock as JMambaBlock
from nbss_tpu.ops.ssm import (_pallas_scan_bwd, selective_scan as j_selective_scan,
                              selective_scan_pallas, selective_scan_step)
from nbss_tpu_torch.models.mamba import MambaBlock
from nbss_tpu_torch.ops import ssm
from nbss_tpu_torch.utils.convert import mamba_state_dict_from_flax

B, T, D, N = 5, 21, 32, 8  # T = 21 is ragged against t_chunk = 4 and the kernels' CHUNK = 8


def _inputs(seed, dtype="fp32", M=B, T=T, D=D, N=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, T, D)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (M, T, D)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (D, N)).astype(np.float32)
    Bm = rng.standard_normal((M, T, N)).astype(np.float32)
    Cm = rng.standard_normal((M, T, N)).astype(np.float32)
    Dp = rng.standard_normal(D).astype(np.float32)
    gy = rng.standard_normal((M, T, D)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    port = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(Bm).to(tdt), torch.from_numpy(Cm).to(tdt), torch.from_numpy(Dp)]
    jax_ = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, jdt),
            jnp.asarray(Cm, jdt), jnp.asarray(Dp)]
    return port, jax_, gy


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def test_reference_matches_pallas_forward_fp32():
    port, jx, _ = _inputs(0)
    want = selective_scan_pallas(*jx, t_chunk=4)
    np.testing.assert_allclose(ssm.reference(*port).numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-4)


def test_reference_matches_pallas_forward_bf16():
    port, jx, _ = _inputs(1, "bf16")
    want = _f32(selective_scan_pallas(*jx, t_chunk=4))
    got = ssm.reference(*port)
    assert got.dtype == torch.bfloat16
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)  # one bf16 step
    assert (np.abs(_f32(got) - want) <= step).all(), np.abs(_f32(got) - want).max()


def test_reference_bwd_matches_pallas_backward_and_vjp():
    port, jx, gy = _inputs(2)
    got = ssm.reference_bwd(*port, torch.from_numpy(gy))
    x, dt, A, Bm, Cm, Dp = jx
    _, hb = selective_scan_pallas(*jx, t_chunk=4, return_boundaries=True)
    gx, gdt, gA, gB, gC = _pallas_scan_bwd(x, dt, A, Bm, Cm, hb, jnp.asarray(gy), t_chunk=4)
    pallas = (gx + jnp.asarray(gy) * Dp, gdt, gA, gB, gC, jnp.einsum("btd,btd->d", gy, x))
    _, vjp = jax.vjp(j_selective_scan, *jx)
    for want_all in (pallas, vjp(jnp.asarray(gy))):
        for name, g, w in zip("x dt A B C D".split(), got, want_all):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-3, rtol=5e-3,
                                       err_msg=name)


def test_reference_bwd_is_the_adjoint_of_reference():
    """reference_bwd against torch autograd through reference (float64)."""
    port, _, gy = _inputs(3, M=2, T=11, D=6, N=3)
    leaves = [t.double().requires_grad_() for t in port]
    y = ssm.reference(*leaves)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(gy).double())
    got = ssm.reference_bwd(*[t.double() for t in port], torch.from_numpy(gy).double())
    for name, g, w in zip("x dt A B C D".split(), got, want):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-8, msg=name)


def test_step_matches_selective_scan_step():
    port, jx, _ = _inputs(4)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, D, N)).astype(np.float32)
    x, dt, A, Bm, Cm, Dp = port
    h_got, y_got = ssm.step(torch.from_numpy(h), x[:, 3], dt[:, 3], A, Bm[:, 3], Cm[:, 3], Dp)
    jx_, jdt, jA, jB, jC, jD = jx
    h_want, y_want = selective_scan_step(jnp.asarray(h), jx_[:, 3], jdt[:, 3], jA, jB[:, 3],
                                         jC[:, 3], jD)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), atol=1e-6, rtol=1e-6)


def test_steps_equal_the_scan():
    port, _, _ = _inputs(6)
    x, dt, A, Bm, Cm, Dp = port
    h, ys = torch.zeros(B, D, N), []
    for t in range(T):
        h, y = ssm.step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], Dp)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), ssm.reference(*port), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_function_on_cpu_is_reference_and_reference_bwd(dtype):
    port, _, gy = _inputs(7, dtype)
    leaves = [t.clone().requires_grad_() for t in port]
    before = (ssm.launches, ssm.bwd_launches)
    y = ssm.selective_scan(*leaves)
    assert torch.equal(y, ssm.reference(*port))
    gyt = torch.from_numpy(gy).to(y.dtype)
    got = torch.autograd.grad(y, leaves, gyt)
    for g, w, p in zip(got, ssm.reference_bwd(*port, gyt), port):
        assert g.dtype == p.dtype and torch.equal(g, w)
    assert (ssm.launches, ssm.bwd_launches) == before  # the plain versions, no kernel


def test_function_refuses_other_devices():
    port, _, _ = _inputs(8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ssm.selective_scan(*[t.to("meta") for t in port])


def _mamba_pair(seed, d_model=16, d_state=8, T=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, T, d_model)).astype(np.float32)
    jm = JMambaBlock(d_model=d_model, d_state=d_state, d_conv=4)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    m = MambaBlock(d_model, d_state=d_state, d_conv=4)
    m.load_state_dict(mamba_state_dict_from_flax(params), strict=True)
    return jm, params, m, x


def test_mamba_block_forward_matches_jax():
    jm, params, m, x = _mamba_pair(0)
    with torch.no_grad():
        y = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jm.apply(params, jnp.asarray(x))),
                               atol=2e-4, rtol=1e-4)


def test_mamba_block_streaming_matches_jax_and_offline():
    jm, params, m, x = _mamba_pair(1)
    state, jstate, ys, jys = m.init_state(3), jm.init_state(3), [], []
    with torch.no_grad():
        for t in range(x.shape[1]):
            y, state = m.streaming_step(torch.from_numpy(x[:, t:t + 1]), state)
            jy, jstate = jm.apply(params, jnp.asarray(x[:, t:t + 1]), jstate,
                                  method=jm.streaming_step)
            ys.append(y.numpy())
            jys.append(np.asarray(jy))
        off = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.concatenate(ys, 1), np.concatenate(jys, 1),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.concatenate(ys, 1), off, atol=1e-5, rtol=1e-5)


def test_mamba_block_gradients_match_jax():
    jm, params, m, x = _mamba_pair(2)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    grads_j = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w))(params)
    (m(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    want = mamba_state_dict_from_flax(grads_j)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_mamba_block_init_follows_the_jax_initializers():
    """The draws of reset_parameters: A_log = log(1..N), D = 1, conv bias 0,
    softplus(dt bias) in [dt_min, dt_max], every weight within its JAX
    initializer's range, and a generator's seed fixing them."""
    m = MambaBlock(96, d_state=16, d_conv=4, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(m.A_log, torch.log(torch.arange(1.0, 17.0)).expand(192, 16))
    assert torch.equal(m.D, torch.ones(192)) and torch.equal(m.conv1d.bias, torch.zeros(192))
    dt = torch.nn.functional.softplus(m.dt_proj.bias)
    assert dt.min() >= 0.001 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    assert m.conv1d.weight.abs().max() <= 0.5  # 1 / sqrt(d_conv)
    assert m.dt_proj.weight.abs().max() <= (3 / 6) ** 0.5  # sqrt(3 / rank), rank 6
    for lin in (m.in_proj, m.x_proj, m.out_proj):
        std = (1.0 / lin.weight.shape[1]) ** 0.5 / 0.87962566103423978
        assert lin.weight.abs().max() <= 2 * std
        assert abs(lin.weight.std().item() - std * 0.87962566103423978) < 0.1 * std
    again = MambaBlock(96, d_state=16, d_conv=4, generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [17, 32])
def test_reference_matches_pallas_above_one_state_group(N):
    """State sizes above the kernels' 16-state pass (17 pads the second
    group): ``reference`` and ``reference_bwd`` against the interpreted Pallas
    scan and its backward, fp32 and bf16 forward, fp32 backward."""
    port, jx, gy = _inputs(10 + N, M=2, T=13, D=16, N=N)
    np.testing.assert_allclose(ssm.reference(*port).numpy(),
                               np.asarray(selective_scan_pallas(*jx, t_chunk=4)),
                               atol=2e-4, rtol=1e-4)
    portb, jxb, _ = _inputs(10 + N, "bf16", M=2, T=13, D=16, N=N)
    want = _f32(selective_scan_pallas(*jxb, t_chunk=4))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(_f32(ssm.reference(*portb)) - want) <= step).all()
    got = ssm.reference_bwd(*port, torch.from_numpy(gy))
    x, dt, A, Bm, Cm, Dp = jx
    _, hb = selective_scan_pallas(*jx, t_chunk=4, return_boundaries=True)
    gx, gdt, gA, gB, gC = _pallas_scan_bwd(x, dt, A, Bm, Cm, hb, jnp.asarray(gy), t_chunk=4)
    pallas = (gx + jnp.asarray(gy) * Dp, gdt, gA, gB, gC, jnp.einsum("btd,btd->d", gy, x))
    for name, g, w in zip("x dt A B C D".split(), got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-3, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_function_takes_any_state_size_on_cpu(dtype):
    """selective_scan at N = 40 (two full passes of 16 states and a ragged
    third on the card): on the CPU the plain versions, exactly, no launch."""
    port, _, gy = _inputs(11, dtype, M=2, T=9, D=8, N=40)
    leaves = [t.clone().requires_grad_() for t in port]
    before = (ssm.launches, ssm.bwd_launches)
    y = ssm.selective_scan(*leaves)
    assert torch.equal(y, ssm.reference(*port))
    gyt = torch.from_numpy(gy).to(y.dtype)
    for g, w in zip(torch.autograd.grad(y, leaves, gyt), ssm.reference_bwd(*port, gyt)):
        assert torch.equal(g, w)
    assert (ssm.launches, ssm.bwd_launches) == before


def test_mamba_block_with_32_states_matches_jax():
    """mamba(32, 4): forward and every parameter's gradient against the JAX
    block."""
    jm, params, m, x = _mamba_pair(12, d_state=32, T=12)
    with torch.no_grad():
        y = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jm.apply(params, jnp.asarray(x))),
                               atol=2e-4, rtol=1e-4)
    w = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)
    grads_j = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w))(params)
    (m(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    want = mamba_state_dict_from_flax(grads_j)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)
