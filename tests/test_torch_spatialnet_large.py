"""SpatialNet-large's slice of the port against nbss_tpu on the CPU.

Rows 1-2 (``ops/attention_block.py`` ``reference`` and ``reference_bwd``,
the yardsticks of the CUDA kernels) past the 256-frame edge the JAX kernel
pads over (T = 257 and 300, Tp = 384: the pad lane masks up to 127 columns)
and at SpatialNet-large's H = 192, against the JAX package's Pallas
``attention_block`` run in interpret mode and ``jax.vjp`` of it (its
custom_vjp runs the interpreted Pallas backward), jitted. Then the model
surface this slice ports: SpatialNet at the large widths (H 192, ffn 384, 4
heads, squeeze 16; 2 layers, F 9) with the block on and off; ``att_mask``
([T, T] and [nh, T, T], additive and boolean); the three ``dropout`` rates
(eval equals the JAX deterministic model, training at rate 0 equals eval,
active rates turn the block off and drop whole frequencies); ``remat``; and
the MHSA with the block off reaching ``ops.attention`` (rows 4-5), held in
bf16 against the JAX model with ``NBSS_ATTN=pallas``.

Bounds: float32 at atol 2e-4, rtol 1e-4 (the JAX package's kernel bound),
gradients at atol and rtol 5e-3 (its gradient bound); bf16 within one bf16
step of the interpreted kernel as the existing rounding tests hold it
(``test_torch_attention_block.py``, ``test_torch_attention_block_bwd.py``),
and a bf16 model no farther from the JAX float32 model than twice the JAX
bf16 model is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.models.spatialnet import SpatialNet as JSpatialNet
from nbss_tpu.ops import attention_block as jab
from nbss_tpu_torch.models import base as tbase
from nbss_tpu_torch.models import spatialnet as tspatialnet
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.ops import attention_block as ab
from nbss_tpu_torch.utils.convert import spatialnet_state_dict_from_flax

NAMES = ("dx", "dln", "dA", "dWvo", "dc")


def _operands(seed, M, T, H, nh):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, T, H)).astype(np.float32)
    g = rng.standard_normal((M, T, H)).astype(np.float32)
    s = 1.0 / np.sqrt(H)
    w_in = (rng.standard_normal((H, 3 * H)) * s).astype(np.float32)  # flax [in, out]
    b_in = (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((H, H)) * s).astype(np.float32)
    b_out = (rng.standard_normal((H,)) * 0.1).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal((H,))).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal((H,))).astype(np.float32)
    jfold = jab.fold_weights(*map(jnp.asarray, (ln_s, ln_b, w_in, b_in, w_out, b_out)), nh)
    tfold = ab.fold_weights(*map(torch.from_numpy, (ln_s, ln_b, w_in.T.copy(), b_in,
                                                   w_out.T.copy(), b_out)), nh)
    return x, g, jfold, tfold


def _bf16_steps(got, want, x):
    """|got - want| in units of one bf16 step (2**-7 of the binade) of the
    largest term of y = x + o + c: the output, the residual x or o + c."""
    mag = np.maximum(np.maximum(np.abs(want), np.abs(x)), np.abs(want - x))
    mag = np.maximum(mag, np.finfo(np.float32).tiny)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


# past the 256-frame edge at a narrow width, and SpatialNet-large's width at a short length
SHAPES = [(2, 257, 48, 4), (2, 300, 16, 2), (2, 20, 192, 4), (1, 37, 192, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,T,H,nh", SHAPES)
def test_rows_1_2_reference_matches_interpreted_pallas(M, T, H, nh, dtype):
    """``reference`` against the interpreted Pallas ``attention_block`` and
    ``reference_bwd`` against ``jax.vjp`` of it: float32 within the kernel
    and gradient bounds; bf16 every output element within one bf16 step of
    the largest term of its sum and under 1% differing, every cotangent
    within one bf16 step at its largest magnitude."""
    x, g, jfold, tfold = _operands(M * 1000 + T + H, M, T, H, nh)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)

    def run(a, ln, A, Wvo, c, gy):
        y, vjp = jax.vjp(lambda *o: jab.attention_block(*o, 1e-5, nh), a, ln, A, Wvo, c)
        return y, vjp(gy)

    y_j, cot = jax.jit(run)(jnp.asarray(x, jdt), *jfold[:4], jnp.asarray(g, jdt))
    want_bwd = [np.asarray(w.astype(jnp.float32)) for w in cot]
    want = np.asarray(y_j.astype(jnp.float32))
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    got = ab.reference(xt, *tfold[:4], 1e-5, nh).float().numpy()
    got_bwd = ab.reference_bwd(xt, *tfold[:3], gt, 1e-5, nh)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    else:
        xb = xt.float().numpy()
        assert _bf16_steps(got, want, xb).max() <= 1.0
        assert np.mean(got != want) < 0.01
    for name, a, w in zip(NAMES, got_bwd, want_bwd):
        assert tuple(a.shape) == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), w, atol=5e-3, rtol=5e-3, err_msg=name)
        else:
            step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            np.testing.assert_allclose(a.float().numpy(), w, atol=step, rtol=2.0 ** -8,
                                       err_msg=name)


# SpatialNet-large's widths (configs/SpatialNet.yaml comments), cut to 2 layers and 9 bins
LARGE = dict(dim_output=4, num_layers=2, dim_hidden=192, dim_ffn=384, num_heads=4,
             dim_squeeze=16, num_freqs=9)
SMALL = dict(dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32, num_heads=4,
             conv_groups=(4, 4), dim_squeeze=4, num_freqs=9)


def _pair(kw, dim_input=6, seed=3, **extra):
    """JAX params for ``kw`` and the port's SpatialNet with them."""
    params = JSpatialNet(dim_input=dim_input, **kw, fused_block=False).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, kw["num_freqs"], 20, dim_input)))
    net = SpatialNet(dim_input=dim_input, **kw, **extra, device="cpu")
    net.load_state_dict(spatialnet_state_dict_from_flax(params, kw["num_layers"]))
    return params, net


def _jax(kw, params, x, dim_input=6, att_mask=None, pallas_attention=False, **extra):
    j_net = JSpatialNet(dim_input=dim_input, **kw, **extra)
    with pytest.MonkeyPatch.context() as mp:
        if pallas_attention:
            mp.setenv("NBSS_ATTN", "pallas")
        mask = None if att_mask is None else jnp.asarray(att_mask)
        fn = jax.jit(lambda p, a, m: j_net.apply(p, a, att_mask=m))
        return np.asarray(fn(params, jnp.asarray(x), mask))


def _spy(monkeypatch):
    """Counts of the folded block's and the attention's calls in SpatialNet."""
    calls = {"block": 0, "attention": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tspatialnet, "attention_block", count("block", ab.attention_block))
    monkeypatch.setattr(tbase, "narrowband_attention",
                        count("attention", tbase.narrowband_attention))
    return calls


@pytest.mark.parametrize("fused", [True, False])
def test_spatialnet_large_widths_match_jax(fused, monkeypatch):
    """SpatialNet at the large widths against the JAX SpatialNet, the folded
    block on (the interpreted Pallas kernel in JAX, ``reference`` here) and
    off (the module composition in both)."""
    params, net = _pair(LARGE, fused_block=fused)
    calls = _spy(monkeypatch)
    x = np.random.default_rng(5).standard_normal((1, 9, 20, 6)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert calls == {"block": 2 * fused, "attention": 0}
    want = _jax(LARGE, params, x, fused_block=fused)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def _masks(kind, T, nh):
    rng = np.random.default_rng(7)
    if kind == "additive TT":
        return (-3.0 * rng.random((T, T))).astype(np.float32)
    if kind == "additive nhTT":
        return (-3.0 * rng.random((nh, T, T))).astype(np.float32)
    causal = np.triu(np.ones((T, T), bool), 1)  # True = masked
    return causal if kind == "boolean TT" else np.broadcast_to(causal, (nh, T, T)).copy()


@pytest.mark.parametrize("kind", ["additive TT", "additive nhTT", "boolean TT", "boolean nhTT"])
def test_att_mask_matches_jax(kind, monkeypatch):
    """A [T, T] or [nh, T, T] mask, additive or boolean, turns the folded
    block off in both packages: the attention runs as a module (through
    ``ops.attention`` here, the XLA attention in JAX) and the outputs agree
    at the kernel bound."""
    params, net = _pair(SMALL)
    calls = _spy(monkeypatch)
    x = np.random.default_rng(6).standard_normal((2, 9, 20, 6)).astype(np.float32)
    mask = _masks(kind, 20, SMALL["num_heads"])
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x), att_mask=torch.from_numpy(mask)).numpy()
    assert calls == {"block": 0, "attention": 2}
    want = _jax(SMALL, params, x, att_mask=mask, fused_block=True)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_dropout_in_eval_matches_jax_deterministic(monkeypatch):
    """With the three rates set, eval mode is the JAX model run
    deterministically: the folded block runs and nothing is dropped."""
    params, net = _pair(LARGE, dropout=(0.1, 0.2, 0.3))
    calls = _spy(monkeypatch)
    x = np.random.default_rng(8).standard_normal((1, 9, 20, 6)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert calls == {"block": 2, "attention": 0}
    want = _jax(LARGE, params, x, dropout=(0.1, 0.2, 0.3), fused_block=True)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_dropout_rate_zero_in_training_equals_eval(monkeypatch):
    params, net = _pair(SMALL, dropout=(0.0, 0.0, 0.0))
    calls = _spy(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 9, 20, 6)).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(net.train()(x), net.eval()(x))
    assert calls == {"block": 4, "attention": 0}


def test_active_dropout_turns_the_block_off_and_drops_whole_frequencies(monkeypatch):
    """Training at rates > 0: the MHSA's dropout turns the folded block off
    (the attention runs through ``ops.attention``, as the JAX
    ``_use_fused_block`` rule has it); the full-band module's keep mask
    [B, 1, F, 1] zeroes whole frequencies of an utterance and scales the
    rest by 1 / (1 - p), the same over every frame and squeezed channel."""
    p = 0.5
    _, net = _pair(SMALL, dropout=(0.1, 0.1, p))
    calls = _spy(monkeypatch)
    layer = net.layers[0]
    seen = []
    monkeypatch.setattr(layer.full, "forward", lambda y: seen.append(y) or y)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((4, 9, 20, 6)).astype(
        np.float32))
    torch.manual_seed(0)
    net.train()(x)
    assert calls == {"block": 0, "attention": 2}
    assert not any(layer.use_fused_block() for layer in net.layers)
    # the same layer's squeezed input without the mask, from the same encoder output
    with torch.no_grad():
        xt = net.encoder(x).transpose(1, 2)
        xt = xt + layer.fconv1(xt)
        plain = layer.squeeze(layer.norm_full(xt))  # [B, T, F, S]
    ratio = (seen[0].detach().transpose(-1, -2) / plain).numpy()  # [B, T, F, S]
    per_freq = ratio[:, :1, :, :1]
    np.testing.assert_allclose(ratio, np.broadcast_to(per_freq, ratio.shape), rtol=1e-5,
                               atol=1e-6)
    kept = np.isclose(per_freq, 1 / (1 - p), rtol=1e-5)
    dropped = per_freq == 0
    assert np.all(kept | dropped) and kept.any() and dropped.any()


@pytest.mark.parametrize("dropout", [(0.0, 0.0, 0.0), (0.1, 0.1, 0.1)])
def test_remat_gives_the_same_loss_and_gradients(dropout):
    """``remat=True`` checkpoints each layer; the loss and every gradient
    equal those of ``remat=False`` from the same weights and random state
    (the checkpoint replays the forward's dropout masks)."""
    _, net = _pair(SMALL, dropout=dropout)
    _, net_remat = _pair(SMALL, dropout=dropout, remat=True)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 9, 20, 6)).astype(
        np.float32))
    w = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 9, 20, 4)).astype(
        np.float32))
    out = []
    for n in (net, net_remat):
        torch.manual_seed(0)
        loss = (n.train()(x) * w).sum()
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in n.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert g is not None and torch.equal(g, out[1][1][k]), k


def test_block_off_attention_rounds_like_pallas_in_bf16(monkeypatch):
    """With a mask the folded block is off and the MHSA runs
    ``ops.attention`` (``reference`` here, rows 4-5 on the card), rounding
    as the JAX package's Pallas ``narrowband_attention`` does: the bf16 model
    no farther from the JAX float32 model than twice the JAX bf16 model with
    ``NBSS_ATTN=pallas`` (its interpreted kernel) is."""
    params, net = _pair(SMALL, dtype=torch.bfloat16)
    calls = _spy(monkeypatch)
    x = np.random.default_rng(13).standard_normal((2, 9, 20, 6)).astype(np.float32)
    mask = _masks("additive TT", 20, SMALL["num_heads"])
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x), att_mask=torch.from_numpy(mask)).numpy()
    assert calls == {"block": 0, "attention": 2}
    j32 = _jax(SMALL, params, x, att_mask=mask, pallas_attention=True)
    jbf = _jax(SMALL, params, x, att_mask=mask, pallas_attention=True, dtype=jnp.bfloat16)
    err, j_err = np.abs(got - j32).max(), np.abs(jbf - j32).max()
    assert 0 < err <= 2 * j_err, (err, j_err)
