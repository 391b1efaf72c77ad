"""The port's NBC against nbss_tpu on the CPU.

A small model (2 layers, H=16, 2 heads, ffn 32, two grouped convs a block,
B x F = 6 sequences of T = 29 frames) with the JAX package's initial weights
carried over by utils/convert.py; inputs made from a seed with numpy. On the
CPU the port's folded block is ``reference_relpos`` and its attention the
plain ``ops.attention.reference``; the JAX package runs its Pallas kernels
(the relative-position block, the narrow-band attention) in interpret mode.

Bounds: float32 at atol 2e-4, rtol 1e-4 (the JAX package's kernel bound)
for the attention module, the block and the whole model; gradients at atol
and rtol 5e-3 (its gradient bound); the task's waveform at atol 2e-4 of its
largest value, rtol 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.io import Loss as JLoss
from nbss_tpu.io import Norm as JNorm
from nbss_tpu.io import STFT as JSTFT
from nbss_tpu.models.nbc import NBC as JNBC
from nbss_tpu.models.nbc import RelPosMultiHeadAttention as JRelPos
from nbss_tpu.models.nbc import sinusoidal_relpos_table as j_relpos_table
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.nbc import (
    NBC,
    RelPosMultiHeadAttention,
    _nbc_rel_shift,
    sincos_position_tables,
    sinusoidal_relpos_table,
)
from nbss_tpu_torch.ops import attention as att
from nbss_tpu_torch.ops import attention_block as ab
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import nbc_state_dict_from_flax

CFG = dict(dim_input=4, dim_output=4, n_layers=2, encoder_kernel_size=4, n_heads=2,
           hidden_size=16, ffn_size=32, inner_conv_groups=2, inner_conv_layers=2, dropout=0.0)
B, F, T = 2, 3, 29


def _pair(seed=0, **kw):
    """JAX NBC params, the port's NBC with the same weights, and the JAX
    NBC, both built with ``kw``."""
    cfg = dict(CFG, **kw)
    params = JNBC(**cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 10, 4)))
    net = NBC(**cfg, device="cpu")
    net.load_state_dict(nbc_state_dict_from_flax(params, cfg["n_layers"],
                                                 cfg["inner_conv_layers"]), strict=True)
    return params, net, JNBC(**cfg)


def _x(seed, shape=(B, F, T, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_trig_factorization_matches_rel_shift():
    """A . cos_j + B . sin_j equals the relative table gathered by the
    rel-shift construction, with the port's own tables and shift."""
    rng = np.random.default_rng(0)
    T_, d, nh = 19, 16, 2
    dh = d // nh
    qv = rng.standard_normal((3, T_, nh, dh))
    W = rng.standard_normal((d, d))  # the [d_model, H] position projection
    pe = sinusoidal_relpos_table(T_, d).astype(np.float64)
    np.testing.assert_array_equal(pe.astype(np.float32), j_relpos_table(T_, d))
    pos = (pe @ W).reshape(2 * T_ - 1, nh, dh)
    pos_full = np.einsum("bqhd,rhd->bhqr", qv, pos)
    ref = _nbc_rel_shift(torch.from_numpy(pos_full[..., ::-1].copy()), T_).numpy()
    Wh = W.reshape(d, nh, dh)
    gs = np.einsum("bqhd,mhd->bqhm", qv, Wh[0::2])
    gc = np.einsum("bqhd,mhd->bqhm", qv, Wh[1::2])
    sin_t, cos_t = (t.astype(np.float64) for t in sincos_position_tables(T_, d))
    A = gs * sin_t[:, None, :] + gc * cos_t[:, None, :]
    Bq = gc * sin_t[:, None, :] - gs * cos_t[:, None, :]
    dec = np.einsum("bqhm,km->bhqk", A, cos_t) + np.einsum("bqhm,km->bhqk", Bq, sin_t)
    np.testing.assert_allclose(dec, ref, atol=1e-4, rtol=1e-4)


def _attn_state_dict(p):
    sd = {}
    for proj in ("query_proj", "key_proj", "value_proj", "out_proj", "pos_proj"):
        dense = p[proj]["Dense_0"]
        sd[f"{proj}.weight"] = torch.from_numpy(np.asarray(dense["kernel"]).T.copy())
        if "bias" in dense:
            sd[f"{proj}.bias"] = torch.from_numpy(np.asarray(dense["bias"]))
    for b in ("u_bias", "v_bias"):
        sd[b] = torch.from_numpy(np.asarray(p[b]))
    return sd


@pytest.mark.parametrize("fused", [True, False])
def test_rel_pos_attention_matches_jax(fused):
    """The fused path (augmented heads through the narrow-band attention)
    against the JAX module's, which runs the interpreted Pallas kernel; the
    einsum path against the JAX module's ``force_xla`` path; with their
    gradients in every parameter."""
    x = _x(1, (3, 17, 32))
    j_mod = JRelPos(32, 2, dropout=0.0, force_xla=not fused)
    params = j_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mod = RelPosMultiHeadAttention(32, 2, fused=fused)
    mod.load_state_dict(_attn_state_dict(params["params"]), strict=True)
    before = att.launches
    y = mod(torch.from_numpy(x))
    assert att.launches == before
    want = j_mod.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    (y ** 2).sum().backward()
    j_grads = jax.grad(lambda p: jnp.sum(j_mod.apply(p, jnp.asarray(x)) ** 2))(params)
    want_g = _attn_state_dict(j_grads["params"])
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


@pytest.mark.parametrize("variant", ["fused_block", "unfused", "post_ln"])
def test_nbc_matches_jax_fp32(variant):
    """The whole model: through the folded block (JAX: its interpreted
    relative-position kernel), through the attention module (JAX: its
    interpreted narrow-band kernel), and post-LN (``norm_first=False``)."""
    kw = {"fused_block": dict(fused_block=True), "unfused": dict(fused_block=False),
          "post_ln": dict(norm_first=False)}[variant]
    params, net, j_net = _pair(0, **kw)
    x = _x(2)
    with torch.no_grad():
        y = net.eval()(torch.from_numpy(x))
    assert y.shape == (B, F, T, 4) and y.dtype == torch.float32
    want = np.asarray(j_net.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), want, atol=2e-4, rtol=1e-4)


def test_nbc_gradients_reach_every_parameter_through_the_folded_block():
    """A loss through the default NBC (the folded block, ``reference_relpos``
    on the CPU) gives every parameter a non-zero gradient, u_bias, v_bias
    and pos_proj among them, equal to the JAX package's through its
    ``custom_vjp``. The one exception is the key projection's bias: it adds
    a constant to each row of scores, which the softmax removes, so neither
    fold uses it and its gradient is 0 in JAX and absent here."""
    params, net, j_net = _pair(1, fused_block=True)
    x = _x(3, (1, 2, 21, 4))
    net.train()  # dropout is 0, so the folded block is still taken
    calls = []
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: calls.append(type(m).__name__))
    try:
        loss = (net(torch.from_numpy(x)) ** 2).sum()
    finally:
        handle.remove()
    assert "RelPosMultiHeadAttention" not in calls  # the folded block, not the module
    loss.backward()
    j_grads = jax.grad(lambda p: jnp.sum(j_net.apply(p, jnp.asarray(x)) ** 2))(params)
    want = nbc_state_dict_from_flax(j_grads, CFG["n_layers"], CFG["inner_conv_layers"])
    names = [n for n, _ in net.named_parameters()]
    assert any("u_bias" in n for n in names) and any("pos_proj" in n for n in names)
    for name, p in net.named_parameters():
        if name.endswith("key_proj.bias"):
            assert p.grad is None and not want[name].any(), name
            continue
        assert p.grad is not None and p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_module_forward_matches_jax():
    """``TrainModule.forward`` and ``predict_step`` with NBC (2 channels,
    STFT 8/4, frequency norm, neg-SI-SDR with PIT) against the JAX
    package's, B=1 x 5 frequencies x 25 frames."""
    params, net, j_net = _pair(2, fused_block=True)
    kw = dict(channels=(0, 1), ref_channel=0)
    j_module = JTrainModule(arch=j_net, stft=JSTFT(n_fft=8, n_hop=4), norm=JNorm("frequency"),
                            loss=JLoss(name="neg_si_sdr", pit=True), **kw)
    module = TrainModule(arch=net.eval(), stft=STFT(n_fft=8, n_hop=4), norm=Norm("frequency"),
                         loss=Loss(name="neg_si_sdr", pit=True), **kw)
    wave = np.random.default_rng(4).standard_normal((1, 2, 96)).astype(np.float32)
    y, _ = module.forward(torch.from_numpy(wave))
    j_y, _ = j_module.forward(params, jnp.asarray(wave))
    assert y.shape == (1, 2, 96)
    scale = float(np.abs(np.asarray(j_y)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=2e-4 * scale, rtol=1e-4)
    pred = module.predict_step(torch.from_numpy(wave))
    j_pred = j_module.predict_step(params, jnp.asarray(wave))
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), atol=2e-4, rtol=1e-4)


def test_attention_scale_and_fused_rule():
    """The fused path's pre-scale recovers 1/sqrt(d_model); with dropout
    active in training the einsum path is taken (no narrow-band call), as in
    the JAX module; a single frame also takes it."""
    torch.manual_seed(0)
    mod = RelPosMultiHeadAttention(16, 2, dropout=0.5)
    x = torch.randn(2, 7, 16)
    mod.eval()
    y_fused = mod(x)
    mod.fused = False
    torch.testing.assert_close(y_fused, mod(x), atol=2e-5, rtol=1e-4)
    mod.fused = True
    assert math.isclose(math.sqrt(24 + 16) / math.sqrt(16) / math.sqrt(24 + 16),
                        1 / math.sqrt(16))
    seen = []
    orig = att._NarrowbandAttention.apply
    att._NarrowbandAttention.apply = lambda *a: seen.append(1) or orig(*a)
    try:
        mod.train()
        mod(x)
        mod.eval()
        mod(x[:, :1])
        assert not seen
        mod(x)
        assert seen
    finally:
        att._NarrowbandAttention.apply = orig


def test_fused_block_is_refused_on_other_devices():
    _, net, _ = _pair(3)
    block = net.sa_layers[0]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ab.attention_block_relpos(torch.empty(2, 8, 16, device="meta"),
                                  *[torch.empty(1, device="meta")] * 8, 1e-5, 2)
    assert block.fused_block and block._use_fused_block(None)
    assert not block._use_fused_block(torch.zeros(8, 8))
