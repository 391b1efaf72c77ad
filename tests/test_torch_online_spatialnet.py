"""The port's OnlineSpatialNet (mamba branch) against nbss_tpu on the CPU.

A small model (2 layers, H=32, mamba(8,4), F=9) with the JAX package's
initial weights carried over by utils/convert.py; inputs made from a seed
with numpy. On the CPU the port's scan is the plain ``reference`` with the
Pallas kernel's rounding points, and the JAX package's is its XLA scan.

Bounds: the arch output in float32 at atol 2e-4, rtol 1e-4; in bfloat16 the
port's error against JAX float32 at most twice JAX bfloat16's (the two round
at different points of the scan, so allclose does not apply). The serving
and streaming entry points at the JAX test's own sizes and bounds (atol
2e-3, rtol 2e-2); the port's streaming against its own forward at atol 1e-5
of the output's range. training_step: loss rtol 1e-4 and every gradient
atol and rtol 5e-3 against jax.value_and_grad, with the port's remat on and
off. The
committed epoch-39 checkpoint: SI-SDR >= 60 dB against the JAX package at
full width.
"""

from pathlib import Path

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
from nbss_tpu_torch.data.synthetic import SyntheticDataset
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.base import Conv1d
from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
from nbss_tpu_torch.ops.metrics import si_sdr
from nbss_tpu_torch.train.loop import Trainer
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import online_spatialnet_state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "logs" / "OnlineSpatialNet" / "version_0" / "checkpoints"
CFG = dict(dim_input=4, dim_output=4, num_layers=2, dim_hidden=32, dim_ffn=64, num_heads=4,
           kernel_size=(5, 3), conv_groups=(8, 8), norms=("LN", "LN", "GN", "LN", "LN", "LN"),
           dim_squeeze=4, num_freqs=9, full_share=0, attention="mamba(8,4)")
FLAGSHIP = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                num_freqs=129, full_share=0, attention="mamba(16,4)")


def _pair(cfg=CFG, seed=0, frames=10, **kw):
    params = JOnlineSpatialNet(**cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg["num_freqs"], frames, cfg["dim_input"])))
    net = OnlineSpatialNet(**cfg, **kw, device="cpu")
    net.load_state_dict(online_spatialnet_state_dict_from_flax(
        params, cfg["num_layers"], cfg["full_share"]), strict=True)
    return params, net


def _japply(cfg, params, x, **kw):
    """The JAX model's forward, jitted."""
    net = JOnlineSpatialNet(**cfg, **kw.pop("model", {}))
    return np.asarray(jax.jit(lambda p, x: net.apply(p, x, **kw))(params, jnp.asarray(x)))


def _x(seed, T=40, cfg=CFG):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, cfg["num_freqs"], T, cfg["dim_input"])).astype(np.float32)


@pytest.mark.parametrize("full_share", [0, 1])
def test_converter_fills_every_parameter_once(full_share):
    cfg = dict(CFG, num_layers=3, full_share=full_share)
    params = JOnlineSpatialNet(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 10, 4)))
    sd = online_spatialnet_state_dict_from_flax(params, 3, full_share)
    net = OnlineSpatialNet(**cfg, device="cpu")
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    # each JAX leaf fills one port entry; a shared full-band group fills every layer above it
    assert len(sd) == n_leaves + 2 * (3 - 1 - min(full_share, 2))


def test_forward_matches_jax_fp32():
    params, net = _pair()
    x = _x(0)
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    want = np.asarray(JOnlineSpatialNet(**CFG).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(y, want, atol=2e-4, rtol=1e-4)


def test_forward_bf16_error_within_twice_jax_bf16():
    params, net = _pair(dtype=torch.bfloat16)
    x = _x(1)
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    want = np.asarray(JOnlineSpatialNet(**CFG).apply(params, jnp.asarray(x)))
    j_bf16 = np.asarray(JOnlineSpatialNet(**CFG, dtype=jnp.bfloat16).apply(params, jnp.asarray(x)))
    err, j_err = np.abs(y - want).max(), np.abs(j_bf16 - want).max()
    assert err <= 2 * j_err, (err, j_err)


def test_causal_conv_pads_on_the_left():
    conv = Conv1d(3, 5, 4, padding="causal")
    x = torch.randn(2, 11, 3)
    with torch.no_grad():
        y = conv(x)
        y_cut = conv(x[:, :6])
    torch.testing.assert_close(y[:, :6], y_cut)  # no frame sees a later one
    with pytest.raises(ValueError, match="padding"):
        Conv1d(3, 5, 4, padding="full")  # a mode the port does not have ('valid' is NBC's)


def test_arch_streaming_equals_offline():
    _, net = _pair()
    x = torch.from_numpy(_x(2, T=14))
    with torch.no_grad():
        off = net(x)
        state, outs = net.init_streaming_state(2), []
        for t in range(x.shape[2]):
            y, state = net.streaming_step(x[:, :, t], state)
            outs.append(y)
    torch.testing.assert_close(torch.stack(outs, 2), off, atol=1e-5, rtol=1e-5)


def _modules():
    params, net = _pair(dict(CFG, dim_input=4))
    kw = dict(channels=(0, 1), ref_channel=0)
    j_module = JTrainModule(arch=JOnlineSpatialNet(**CFG), stft=JSTFT(n_fft=16, n_hop=8),
                            norm=JNorm(mode="utterance", online=True),
                            loss=JLoss(name="neg_snr", pit=True), **kw)
    module = TrainModule(arch=net, stft=STFT(n_fft=16, n_hop=8),
                         norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True), **kw)
    return j_module, params, module


def test_module_forward_and_streaming_match_jax():
    """The JAX package's own test of this pair: B=2 x 2 ch x 400 samples."""
    j_module, params, module = _modules()
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
TRAIN_CFG = dict(CFG, dim_input=12)


def _train_modules(remat, cfg=TRAIN_CFG, remat_policy=None):
    params, net = _pair(cfg, seed=3, frames=FRAMES, remat=remat, remat_policy=remat_policy)
    module = TrainModule(arch=net, stft=STFT(n_fft=N_FFT, n_hop=HOP),
                         norm=Norm(mode="utterance", online=True),
                         loss=Loss(name="neg_snr", pit=True))
    return params, module


def _batch(seed, B=2):
    data = SyntheticDataset(num_items=B, audio_time_len=HOP * (FRAMES - 1) / 8000)
    items = [data[(i, seed + i)] for i in range(B)]
    return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


def _jax_step(cfg):
    params, _ = _train_modules(False, cfg)
    j_module = JTrainModule(arch=JOnlineSpatialNet(**cfg),
                            stft=JSTFT(n_fft=N_FFT, n_hop=HOP),
                            norm=JNorm(mode="utterance", online=True),
                            loss=JLoss(name="neg_snr", pit=True))
    return jax.jit(jax.value_and_grad(j_module.training_step))(
        params, tuple(map(jnp.asarray, _batch(0))))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's loss and gradient on batch 0, computed once: its
    remat changes no value (tests/test_online_spatialnet.py), so each of the
    port's settings is held against the same numbers."""
    return _jax_step(TRAIN_CFG)


@pytest.mark.parametrize("remat,remat_policy", [
    pytest.param(True, None, id="True"),
    pytest.param(False, None, id="False"),
    pytest.param(True, "dots", id="dots"),
])
def test_training_step_loss_and_gradients_match_jax(remat, remat_policy, jax_step):
    check_training_step(_train_modules(remat, TRAIN_CFG, remat_policy)[1], TRAIN_CFG, jax_step)


def check_training_step(module, cfg, jax_step):
    """training_step's loss (rtol 1e-4) and every gradient (atol, rtol 5e-3)
    against the JAX package's."""
    loss_j, grads_j = jax_step
    loss = module.training_step(tuple(torch.from_numpy(b) for b in _batch(0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = online_spatialnet_state_dict_from_flax(grads_j, cfg["num_layers"])
    named = list(module.arch.named_parameters())
    assert len(named) == len(want) - (cfg["num_layers"] - 1) * 2  # shared full-band once
    for name, p in named:
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_trainer_fits_with_adamw_and_remat():
    """Trainer on the CPU with the config's optimizer: AdamW (1e-3, weight
    decay 1e-3), clip 5, remat with the dots policy; four steps on one batch."""
    _, module = _train_modules(True, remat_policy="dots")
    losses = []
    trainer = Trainer(module, optimizer=("AdamW", {"lr": 1e-3, "weight_decay": 1e-3}),
                      gradient_clip_val=5.0, device="cpu",
                      logger=lambda k, v, _: losses.append(v) if k.startswith("train/") else None)
    trainer.init()
    before = [p.detach().clone() for p in module.arch.parameters()]
    trainer.fit([_batch(1)], max_epochs=4)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert all(not torch.equal(a, p) for a, p in zip(before, module.arch.parameters()))


@pytest.mark.parametrize("kw,label", [
    pytest.param(dict(attention="ret(2,share_qk)"), "retention", id="kw0-retention"),
    pytest.param(dict(attention="ret(1,not_share_qk)"), "retention", id="kw1-retention"),
    pytest.param(dict(attention="mamba(16,4)", remat=True, remat_policy="dots"), "remat_policy",
                 id="kw2-remat_policy"),
    pytest.param(dict(attention="mhsa(251)", remat=True, remat_policy="dots"), "remat_policy",
                 id="kw3-remat_policy"),
])
def test_refused_settings_raise(kw, label):
    """The four settings the port refused before the retention slice: each
    now builds on the CPU and matches the JAX model's fp32 forward (and
    none raises)."""
    cfg = {**CFG, **kw}
    params, net = _pair(cfg, seed=5)
    x = _x(5, T=12, cfg=cfg)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = _japply(cfg, params, x)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4, err_msg=label)


def test_gln_norm_matches_jax():
    """The gLN norm the port refused until NBC2's slice brought it (here
    before the masked attention) builds and matches the JAX model."""
    cfg = dict(CFG, attention="mhsa(251)", norms=("gLN", "LN", "GN", "LN", "LN", "LN"))
    params, net = _pair(cfg, seed=3)
    x = _x(4, T=20, cfg=cfg)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(JOnlineSpatialNet(**cfg).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_epoch39_checkpoint_port_matches_jax():
    from nbss_tpu.train.ckpt import CheckpointManager

    params = CheckpointManager(str(CKPT)).restore(39)["params"]
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(params)) == 1_346_996  # model.txt

    net = OnlineSpatialNet(**FLAGSHIP, device="cpu").eval()
    net.load_state_dict(online_spatialnet_state_dict_from_flax(params, 8), strict=True)
    kw = dict(stft=STFT(n_fft=256, n_hop=128), norm=Norm(mode="utterance", online=True),
              loss=Loss(name="neg_snr", pit=True))
    module = TrainModule(arch=net, **kw)
    j_module = JTrainModule(arch=JOnlineSpatialNet(**FLAGSHIP),
                            stft=JSTFT(n_fft=256, n_hop=128),
                            norm=JNorm(mode="utterance", online=True),
                            loss=JLoss(name="neg_snr", pit=True))
    x = (0.1 * np.random.default_rng(0).standard_normal((1, 6, 4000))).astype(np.float32)
    y, _ = module.forward(torch.from_numpy(x))
    y_j, _ = j_module.forward(params, jnp.asarray(x))
    assert si_sdr(y, torch.from_numpy(np.array(y_j))).min() >= 60.0
