"""The port's multi-scale retention against nbss_tpu on the CPU.

Inputs are made from a seed with numpy; the JAX package's initial weights
are carried over by utils/convert.py. The JAX functions are compiled once
per setting, with XLA's excess precision off so that they round to bf16
wherever the code casts, as the port does.

Bounds: float32 at atol 2e-4, rtol 1e-4 (forward) and atol, rtol 5e-3
(gradients against ``jax.vjp``, the JAX package's gradient bound); bf16
within one bf16 step of the JAX bf16 result up to the gate, and after it
the models' bf16 rule (at most twice JAX bf16's error). The JAX package's
whole-sequence recurrence does not run in bf16 (its ``lax.scan`` carry turns
float32 after the first frame), so the port's bf16 recurrence is held
against the JAX package's ``streaming_step`` run frame by frame, which is
the same recurrence.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.models.retention import MultiScaleRetention as JMSR
from nbss_tpu.models.retention import RetNetRelPos as JRelPos
from nbss_tpu_torch.models.retention import MultiScaleRetention, RetNetRelPos
from nbss_tpu_torch.utils.convert import retention_state_dict_from_flax

H, NH, VF, CHUNK = 32, 4, 2, 64
T = 150  # three 64-frame chunks, the last one ragged
DECAY = (4, 5, 9, 10)  # configs/onlineSpatialNet.yaml


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_one_bf16_step(got, want):
    got, want = _f32(got), _f32(want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    bad = np.abs(got - want) > step
    assert not bad.any(), (bad.mean(), np.abs(got - want).max())


@pytest.mark.parametrize("decay", [5, None, False, (4, 5, 9, 10), (0.9, 0.95, 0.99, 0.999)])
def test_relpos_tables_equal_jax(decay):
    pos, jpos = RetNetRelPos(H, NH, CHUNK, decay), JRelPos(H, NH, CHUNK, decay)
    for got, want in ((pos.parallel(T), jpos.parallel(T)),
                      (pos.chunkwise(T), jpos.chunkwise(T)),
                      (pos.recurrent(37), jpos.recurrent(37)),
                      (pos.recurrent_dynamic(37), jpos.recurrent_dynamic(37)),
                      (pos.recurrent_seq(T), jpos.recurrent_seq(T))):
        g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _pair(share_qk, look_ahead=0, bf16=False):
    jm = JMSR(embed_dim=H, num_heads=NH, value_factor=VF, share_qk=share_qk,
              look_ahead=look_ahead, dtype=jnp.bfloat16 if bf16 else None)
    jpos = JRelPos(H, NH, CHUNK, DECAY)
    params = jm.init(jax.random.PRNGKey(int(share_qk)), jnp.zeros((1, 8, H)),
                     jpos.parallel(8 + look_ahead))
    m = MultiScaleRetention(H, NH, VF, look_ahead=look_ahead, share_qk=share_qk)
    m.load_state_dict(retention_state_dict_from_flax(params), strict=True)
    return jm, params, m


def _x(seed, bf16=False, T=T):
    x = np.random.default_rng(seed).standard_normal((2, T, H)).astype(np.float32)
    if bf16:
        return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def _port_path(m, x, path, rope):
    """(the retention before its gate, the module's output)."""
    pos, T_ = RetNetRelPos(H, NH, CHUNK, DECAY), x.shape[1]
    with torch.no_grad():
        if path == "streaming":
            state, outs, cores = m.init_state(x.shape[0], NH, H // NH, H * VF // NH), [], []
            for t in range(T_):
                (sin, cos), decay = pos.recurrent(t)
                qr, kr, v = m._qkv(x[:, t:t + 1], sin[None], cos[None], rope)
                core, _ = m._recurrent_step(qr, kr, v, decay, state)
                y, state = m.streaming_step(x[:, t:t + 1], pos.recurrent(t), state, rope=rope)
                cores.append(core)
                outs.append(y)
            return torch.cat(cores, 1), torch.cat(outs, 1)
        kw = {"parallel": {}, "chunkwise": {"chunkwise_recurrent": True},
              "recurrent": {"recurrent": True}}[path]
        table = {"parallel": "parallel", "chunkwise": "chunkwise",
                 "recurrent": "recurrent_seq"}[path]
        rel_pos = getattr(pos, table)(T_ + (0 if path == "recurrent" else m.look_ahead))
        return m.retain(x, rel_pos, rope=rope, **kw)[0], m(x, rel_pos, rope=rope, **kw)


def _jax_retain(s, x, rel_pos, path, rope):
    """The JAX module's __call__, returning the retention before its gate too."""
    B, T_, _ = x.shape
    (sin, cos), inner = rel_pos
    g = s.g_proj(x)
    qr, kr, v = s._qkv(x, sin, cos, rope)
    la = s.look_ahead
    if la > 0:
        kr = jnp.pad(kr, ((0, 0), (0, 0), (0, la), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, la), (0, 0)))
        qr = jnp.pad(qr, ((0, 0), (0, 0), (la, 0), (0, 0)))
    if path == "recurrent":
        output = s._recurrent_seq(qr, kr, v, jnp.asarray(inner))
    elif path == "chunkwise":
        output = s._chunkwise(qr, kr, v, inner)
    else:
        output = s._parallel(qr, kr, v, inner)
    if la > 0:
        output = output[:, :-la]
    return output, s._finish(output, g, B, T_)


def _jax_step(s, x_t, rel_pos_t, state, rope):
    (sin, cos), decay = rel_pos_t
    g = s.g_proj(x_t)
    qr, kr, v = s._qkv(x_t, sin[None, :], cos[None, :], rope)
    out, state = s._recurrent_step(qr, kr, v, decay, state)
    return out, s._finish(out, g, x_t.shape[0], 1), state


def _compiled(fn, *args):
    """fn jitted for these arguments, rounding wherever the code casts to
    bf16: XLA on the CPU otherwise may skip a bf16 rounding (excess
    precision), which the port and the card keep."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _jax_path(jm, params, x, path, rope):
    """(the retention before its gate, the module's output)."""
    jpos, T_ = JRelPos(H, NH, CHUNK, DECAY), x.shape[1]
    if path != "streaming" and not (path == "recurrent" and x.dtype == jnp.bfloat16):
        table = {"parallel": "parallel", "chunkwise": "chunkwise",
                 "recurrent": "recurrent_seq"}[path]
        rel_pos = getattr(jpos, table)(T_ + (0 if path == "recurrent" else jm.look_ahead))
        return _compiled(lambda p, x: jm.apply(p, x, rel_pos, path, rope, method=_jax_retain),
                         params, x)(params, x)
    state, cores, outs = JMSR.init_state(x.shape[0], NH, H // NH, H * VF // NH), [], []
    step = _compiled(lambda p, x_t, rp, st: jm.apply(p, x_t, rp, st, rope, method=_jax_step),
                     params, x[:, :1], jpos.recurrent(0), state)
    for t in range(T_):
        core, y, state = step(params, x[:, t:t + 1], jpos.recurrent(t), state)
        cores.append(core)
        outs.append(y)
    return jnp.concatenate(cores, 1), jnp.concatenate(outs, 1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("path", ["parallel", "chunkwise", "recurrent", "streaming"])
def test_paths_match_jax(path, dtype):
    """Each path for share_qk True and False and rope True and False. In
    bf16 the retention before its gate is within one bf16 step of the JAX
    package's; the gated output, whose SiLU the JAX package rounds at every
    one of its four operations on the CPU and the port once, is at most
    twice as far from the JAX float32 output as the JAX bf16 output is."""
    bf16 = dtype == "bf16"
    for share_qk in (True, False):
        jm, params, m = _pair(share_qk, bf16=bf16)
        # the recurrences walk frame by frame: 40 frames; the others three chunks
        x, jx = _x(int(share_qk), bf16, T=T if path in ("parallel", "chunkwise") else 40)
        for rope in (True, False):
            core, got = _port_path(m, x, path, rope)
            jcore, want = _jax_path(jm, params, jx, path, rope)
            assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
            if core.dtype == torch.float32:  # the recurrence's float32 state
                np.testing.assert_allclose(_f32(core), _f32(jcore), atol=2e-4, rtol=1e-4)
            else:
                _within_one_bf16_step(core, jcore)
            if bf16:
                jm32 = _pair(share_qk)[0]
                want32 = _f32(_jax_path(jm32, params, jx.astype(jnp.float32), path, rope)[1])
                err, j_err = np.abs(_f32(got) - want32).max(), np.abs(_f32(want) - want32).max()
                assert err <= 2 * j_err, (err, j_err, share_qk, rope)
            else:
                np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=1e-4,
                                           err_msg=f"share_qk={share_qk} rope={rope}")


@pytest.mark.parametrize("path", ["parallel", "chunkwise"])
def test_look_ahead_matches_jax(path):
    jm, params, m = _pair(False, look_ahead=3)
    x, jx = _x(5)
    got = _port_path(m, x, path, False)[1]
    assert got.shape == (2, T, H)
    np.testing.assert_allclose(_f32(got), _f32(_jax_path(jm, params, jx, path, False)[1]),
                               atol=2e-4, rtol=1e-4)


def test_recurrent_refuses_look_ahead():
    _, _, m = _pair(False, look_ahead=3)
    x, _ = _x(6, T=10)
    with pytest.raises(ValueError, match="look_ahead"):
        m(x, RetNetRelPos(H, NH, CHUNK, DECAY).recurrent_seq(10), recurrent=True)


@pytest.mark.parametrize("path", ["parallel", "chunkwise", "recurrent"])
def test_gradients_match_jax_vjp(path):
    """Every parameter's and the input's gradient of <y, w> against jax.vjp,
    share_qk on (the config's ret(2,share_qk)) with rope, and off without."""
    Tg = 70 if path == "recurrent" else T
    for share_qk, rope in ((True, True), (False, False)):
        jm, params, m = _pair(share_qk)
        x, jx = _x(7, T=Tg)
        w = np.random.default_rng(8).standard_normal((2, Tg, H)).astype(np.float32)
        jpos, pos = JRelPos(H, NH, CHUNK, DECAY), RetNetRelPos(H, NH, CHUNK, DECAY)
        kw = {"parallel": {}, "chunkwise": {"chunkwise_recurrent": True},
              "recurrent": {"recurrent": True}}[path]
        table = {"parallel": "parallel", "chunkwise": "chunkwise",
                 "recurrent": "recurrent_seq"}[path]
        y, vjp = jax.vjp(lambda p, x: jm.apply(p, x, getattr(jpos, table)(Tg), rope=rope, **kw),
                         params, jx)
        g_params, g_x = vjp(jnp.asarray(w))
        xt = x.clone().requires_grad_()
        out = m(xt, getattr(pos, table)(Tg), rope=rope, **kw)
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=5e-3, rtol=5e-3)
        want = retention_state_dict_from_flax(g_params)
        for name, p in m.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3,
                                       rtol=5e-3, err_msg=f"{name} share_qk={share_qk}")
            p.grad = None


def test_parameters_follow_the_jax_initializers():
    """Xavier-uniform bounds of gain 2^-2.5 (q, k, v, g) and 2^-1 (out), no
    biases, no k_proj under share_qk, and a generator's seed fixing them."""
    m = MultiScaleRetention(96, 4, 2, share_qk=True, generator=torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in m.named_parameters()) == [
        "g_proj.weight", "out_proj.weight", "q_proj.weight", "v_proj.weight"]
    for name, gain in (("q_proj", 2 ** -2.5), ("v_proj", 2 ** -2.5), ("g_proj", 2 ** -2.5),
                       ("out_proj", 0.5)):
        w = getattr(m, name).weight
        bound = gain * (6.0 / sum(w.shape)) ** 0.5
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound, name
    again = MultiScaleRetention(96, 4, 2, share_qk=True,
                                generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))
