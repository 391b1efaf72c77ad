"""The port's OnlineSpatialNet mhsa branch and causal T-ConvFFN against
nbss_tpu on the CPU.

A small model (2 layers, H=32, 4 heads, dim_ffn 64, F=9, T=20) with the JAX
package's initial weights carried over by utils/convert.py; inputs made from
a seed with numpy. On the CPU the port's attention is the plain
``ops.attention.reference`` with the Pallas kernel's rounding points; the
JAX package's MultiheadAttention takes its XLA einsum path on the CPU, or
its Pallas kernel in interpret mode with ``NBSS_ATTN=pallas`` (read when the
model is traced).

Bounds: the arch output in float32 at atol 2e-4, rtol 1e-4, for a bounded
scope, an unbounded one and the ALiBi mask. In bfloat16 against the JAX
model through the interpreted kernel and against its XLA model, the port's
error against JAX float32 at most twice the JAX bf16 model's: the convs,
norms and projections round at bf16 steps in another order in the two
frameworks, so whole-model bf16 outputs differ by about the bf16 error
itself (``tests/test_torch_attention.py`` holds the attention alone to one
bf16 step of the Pallas kernel). Streaming against the port's own forward at
atol 1e-5 of the output's range, and the serving and streaming entry points
against JAX at the JAX test's bounds (atol 2e-3, rtol 2e-2).
``training_step``: loss rtol 1e-4 and every gradient atol and rtol 5e-3
against ``jax.value_and_grad``, with the port's remat on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.io import Loss as JLoss
from nbss_tpu.io import Norm as JNorm
from nbss_tpu.io import STFT as JSTFT
from nbss_tpu.models.online_spatialnet import OnlineSpatialNet as JOnlineSpatialNet
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu.utils.torch_compat import online_spatialnet_params_from_torch
from nbss_tpu_torch.data.synthetic import SyntheticDataset
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.base import MultiheadAttention
from nbss_tpu_torch.models.online_spatialnet import (
    CrossGroupNorm,
    OnlineSpatialNet,
    alibi_mask,
    local_causal_mask,
)
from nbss_tpu_torch.ops import attention as att
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import online_spatialnet_state_dict_from_flax

CFG = dict(dim_input=4, dim_output=4, num_layers=2, dim_hidden=32, dim_ffn=64, num_heads=4,
           kernel_size=(5, 3), conv_groups=(8, 8), norms=("LN", "LN", "GN", "LN", "LN", "LN"),
           dim_squeeze=4, num_freqs=9, full_share=0, attention="mhsa(6)")
VARIANTS = {"scope": dict(attention="mhsa(6)"), "inf": dict(attention="mhsa(inf)"),
            "alibi": dict(attention="mhsa(6)", rope="ALiBi")}
T = 20


def _pair(cfg, seed=0, **kw):
    params = JOnlineSpatialNet(**cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg["num_freqs"], 10, cfg["dim_input"])))
    net = OnlineSpatialNet(**cfg, **kw, device="cpu")
    net.load_state_dict(online_spatialnet_state_dict_from_flax(
        params, cfg["num_layers"], cfg["full_share"]), strict=True)
    return params, net


def _x(seed, T=T, cfg=CFG):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, cfg["num_freqs"], T, cfg["dim_input"])).astype(np.float32)


@pytest.mark.parametrize("attention,full_share", [("mhsa(6)", 0), ("mhsa(6)", 1),
                                                  ("mamba(8,4)not_replace_ffn", 0)])
def test_converter_fills_every_parameter_once(attention, full_share):
    cfg = dict(CFG, num_layers=3, full_share=full_share, attention=attention)
    params = JOnlineSpatialNet(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 10, 4)))
    sd = online_spatialnet_state_dict_from_flax(params, 3, full_share)
    net = OnlineSpatialNet(**cfg, device="cpu")
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    # each JAX leaf fills one port entry; a shared full-band group fills every layer above it
    assert len(sd) == n_leaves + 2 * (3 - 1 - min(full_share, 2))


@pytest.mark.parametrize("full_share", [0, 1])
def test_converter_round_trips_through_torch_compat(full_share):
    """The port's state_dict, read back by the JAX package's own mapping of
    the torch mhsa OnlineSpatialNet (the offline SpatialNet layout), gives
    the JAX tree it came from, leaf for leaf."""
    cfg = dict(CFG, num_layers=3, full_share=full_share, attention="mhsa(inf)")
    params = JOnlineSpatialNet(**cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 9, 10, 4)))
    sd = {k: v.numpy() for k, v in online_spatialnet_state_dict_from_flax(
        params, 3, full_share).items()}
    back = online_spatialnet_params_from_torch(sd, 3, full_share, attention="mhsa(inf)")
    want = params["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax_fp32(variant):
    cfg = dict(CFG, **VARIANTS[variant])
    params, net = _pair(cfg)
    x = _x(0)
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    want = np.asarray(JOnlineSpatialNet(**cfg).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(y, want, atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def bf16_outputs():
    """Port bf16, JAX fp32, JAX bf16 through XLA and through the
    interpreted Pallas kernel, for the ALiBi model on one input."""
    cfg = dict(CFG, **VARIANTS["alibi"])
    params, net = _pair(cfg, dtype=torch.bfloat16)
    x = _x(1)
    with torch.no_grad():
        port = net(torch.from_numpy(x)).numpy()
    j32 = np.asarray(JOnlineSpatialNet(**cfg).apply(params, jnp.asarray(x)))
    jbf = JOnlineSpatialNet(**cfg, dtype=jnp.bfloat16)
    xla = np.asarray(jbf.apply(params, jnp.asarray(x)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NBSS_ATTN", "pallas")
        pallas = np.asarray(jax.jit(jbf.apply)(params, jnp.asarray(x)))
    return port, j32, xla, pallas


def test_forward_bf16_matches_jax_through_the_pallas_kernel(bf16_outputs):
    port, j32, _, pallas = bf16_outputs
    err, j_err = np.abs(port - j32).max(), np.abs(pallas - j32).max()
    assert err <= 2 * j_err, (err, j_err)


def test_forward_bf16_error_within_twice_jax_xla_bf16(bf16_outputs):
    port, j32, xla, _ = bf16_outputs
    err, j_err = np.abs(port - j32).max(), np.abs(xla - j32).max()
    assert err <= 2 * j_err, (err, j_err)


@pytest.mark.parametrize("variant", ["scope", "alibi"])
def test_arch_streaming_equals_offline(variant):
    """Frame by frame through the KV ring buffer (scope 6 < T = 20) and the
    causal convs' ring buffers, equal to the offline masked forward."""
    _, net = _pair(dict(CFG, **VARIANTS[variant]))
    x = torch.from_numpy(_x(2))
    with torch.no_grad():
        off = net(x)
        state, outs = net.init_streaming_state(2), []
        for t in range(x.shape[2]):
            y, state = net.streaming_step(x[:, :, t], state)
            outs.append(y)
    assert state["t"] == x.shape[2]
    torch.testing.assert_close(torch.stack(outs, 2), off, atol=1e-5, rtol=1e-5)


def test_streaming_with_unbounded_scope_raises():
    _, net = _pair(dict(CFG, attention="mhsa(inf)"))
    with pytest.raises(NotImplementedError, match="finite attention scope"):
        net.init_streaming_state(2)


def _modules(variant="scope"):
    cfg = dict(CFG, **VARIANTS[variant])
    params, net = _pair(cfg)
    kw = dict(channels=(0, 1), ref_channel=0)
    j_module = JTrainModule(arch=JOnlineSpatialNet(**cfg), stft=JSTFT(n_fft=16, n_hop=8),
                            norm=JNorm(mode="utterance", online=True),
                            loss=JLoss(name="neg_snr", pit=True), **kw)
    module = TrainModule(arch=net, stft=STFT(n_fft=16, n_hop=8),
                         norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True), **kw)
    return j_module, params, module


@pytest.mark.parametrize("variant", ["scope", "alibi"])
def test_module_forward_and_streaming_match_jax(variant):
    """B=2 x 2 ch x 400 samples (49 frames, past the scope of 6)."""
    j_module, params, module = _modules(variant)
    x = np.random.default_rng(3).standard_normal((2, 2, 400)).astype(np.float32)
    y_off, _ = module.forward(torch.from_numpy(x))
    y_str, _ = module.forward_streaming(torch.from_numpy(x))
    j_off, _ = j_module.forward(params, jnp.asarray(x))
    j_str, _ = j_module.forward_streaming(params, jnp.asarray(x))
    np.testing.assert_allclose(y_off.numpy(), np.asarray(j_off), atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(y_str.numpy(), np.asarray(j_str), atol=2e-3, rtol=2e-2)
    scale = y_off.abs().max().item()
    torch.testing.assert_close(y_str, y_off, atol=1e-5 * scale, rtol=1e-5)


N_FFT, HOP, FRAMES = 16, 8, 20
TRAIN_CFG = dict(CFG, dim_input=12, attention="mhsa(6)", rope="ALiBi")


def _batch(seed, B=2):
    data = SyntheticDataset(num_items=B, audio_time_len=HOP * (FRAMES - 1) / 8000)
    items = [data[(i, seed + i)] for i in range(B)]
    return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


def _train_module(remat):
    params, net = _pair(TRAIN_CFG, seed=3, remat=remat)
    module = TrainModule(arch=net, stft=STFT(n_fft=N_FFT, n_hop=HOP),
                         norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True))
    return params, module


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's loss and gradient on batch 0, computed once."""
    params, _ = _train_module(False)
    j_module = JTrainModule(arch=JOnlineSpatialNet(**TRAIN_CFG),
                            stft=JSTFT(n_fft=N_FFT, n_hop=HOP),
                            norm=JNorm(mode="utterance", online=True),
                            loss=JLoss(name="neg_snr", pit=True))
    return jax.jit(jax.value_and_grad(j_module.training_step))(
        params, tuple(map(jnp.asarray, _batch(0))))


@pytest.mark.parametrize("remat", [True, False])
def test_training_step_loss_and_gradients_match_jax(remat, jax_step):
    _, module = _train_module(remat)
    loss_j, grads_j = jax_step
    before = (att.launches, att.bwd_launches)
    loss = module.training_step(tuple(torch.from_numpy(b) for b in _batch(0)))
    loss.backward()
    assert (att.launches, att.bwd_launches) == before  # the plain versions on the CPU
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = online_spatialnet_state_dict_from_flax(grads_j, TRAIN_CFG["num_layers"])
    named = list(module.arch.named_parameters())
    assert len(named) == len(want) - (TRAIN_CFG["num_layers"] - 1) * 2  # shared full-band once
    for name, p in named:
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_mamba_not_replace_ffn_forward_matches_jax():
    """Mamba as the time module with the causal T-ConvFFN beside it."""
    cfg = dict(CFG, attention="mamba(8,4)not_replace_ffn")
    params, net = _pair(cfg)
    x = _x(4)
    with torch.no_grad():
        y = net(torch.from_numpy(x))
        state, outs = net.init_streaming_state(2), []
        for t in range(x.shape[2]):
            y_t, state = net.streaming_step(torch.from_numpy(x[:, :, t]), state)
            outs.append(y_t)
    want = np.asarray(JOnlineSpatialNet(**cfg).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), want, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(torch.stack(outs, 2), y, atol=1e-5, rtol=1e-5)


def test_masks_and_cross_group_norm_match_jax():
    from nbss_tpu.models.online_spatialnet import CrossGroupNorm as JCrossGroupNorm
    from nbss_tpu.models.online_spatialnet import alibi_mask as j_alibi
    from nbss_tpu.models.online_spatialnet import local_causal_mask as j_local

    for scope in (1, 6, 40, np.inf):
        np.testing.assert_array_equal(local_causal_mask(20, scope), j_local(20, scope))
        np.testing.assert_array_equal(alibi_mask(20, scope, 4), j_alibi(20, scope, 4))
    x = np.random.default_rng(5).standard_normal((2, 9, 7, 16)).astype(np.float32)
    jn = JCrossGroupNorm(num_groups=4)
    norm = CrossGroupNorm(4, 16)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, 16))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, 16))
    params = {"params": {"scale": norm.weight.detach().numpy(),
                         "bias": norm.bias.detach().numpy()}}
    with torch.no_grad():
        y = norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jn.apply(params, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # causal over T: a frame's output ignores every other frame
        torch.testing.assert_close(norm(torch.from_numpy(x[:, :, :3]))[:, :, 2],
                                   norm(torch.from_numpy(x[:, :, 2:3]))[:, :, 0])


@pytest.mark.parametrize("mask_kind", ["bool", "float"])
def test_multihead_attention_fused_equals_einsum_with_masks(mask_kind):
    """The fused path (the plain kernel version on the CPU) against the einsum
    composition in float32, with a boolean mask and with a float mask holding
    -inf, for [T, T], [nh, T, T] and (einsum only) per-item masks."""
    g = torch.Generator().manual_seed(0)
    fused = MultiheadAttention(16, 4, generator=g)
    plain = MultiheadAttention(16, 4, fused=False)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 3, 11, 16, generator=g)
    causal = torch.from_numpy(local_causal_mask(11, 4))
    alibi = torch.from_numpy(alibi_mask(11, 4, 4))
    masks = [None, causal, alibi] if mask_kind == "float" else [causal.isinf(), alibi.isinf()]
    with torch.no_grad():
        for mask in masks:
            torch.testing.assert_close(fused(x, mask), plain(x, mask), atol=1e-5, rtol=1e-5)
        item = (causal if mask_kind == "float" else causal.isinf()).expand(2, 3, 11, 11)
        torch.testing.assert_close(fused(x, item), plain(x, causal if mask_kind == "float"
                                                          else causal.isinf()),
                                   atol=1e-5, rtol=1e-5)
