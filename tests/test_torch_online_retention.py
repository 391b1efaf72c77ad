"""The port's OnlineSpatialNet with the retention branch, dropout and
``remat_policy='dots'``, against nbss_tpu on the CPU.

The small model of tests/test_torch_online_spatialnet.py (2 layers, H=32, 4
heads, F=9) with ``attention="ret(2,share_qk)"`` and
configs/onlineSpatialNet.yaml's decays (4, 5, 9, 10); the JAX package's
initial weights carried over by utils/convert.py, inputs made from a seed
with numpy, the JAX forward jitted.

Bounds: the arch output in float32 at atol 2e-4, rtol 1e-4; in bfloat16 the
port's error against JAX float32 at most twice JAX bfloat16's; the serving
and streaming entry points at the JAX test's sizes and bounds (atol 2e-3,
rtol 2e-2); the port's streaming against its own recurrent forward at atol
1e-5 of the output's range; training_step's loss rtol 1e-4 and gradients
atol and rtol 5e-3 against jax.value_and_grad.
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
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
from nbss_tpu_torch.train.module import TrainModule
from test_torch_online_spatialnet import (CFG, TRAIN_CFG, _japply, _jax_step, _pair,
                                          _train_modules, _x, check_training_step)

ROOT = Path(__file__).resolve().parents[1]
RET_CFG = dict(CFG, attention="ret(2,share_qk)", decay=(4, 5, 9, 10))
RET_TRAIN_CFG = dict(TRAIN_CFG, attention="ret(2,share_qk)", decay=(4, 5, 9, 10))


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step(RET_TRAIN_CFG)


@pytest.mark.parametrize("remat,remat_policy", [pytest.param(False, None, id="ret"),
                                                pytest.param(True, "dots", id="ret-dots")])
def test_training_step_loss_and_gradients_match_jax(remat, remat_policy, jax_step):
    check_training_step(_train_modules(remat, RET_TRAIN_CFG, remat_policy)[1], RET_TRAIN_CFG,
                        jax_step)


@pytest.mark.parametrize("attention", ["ret(2,share_qk)", "ret(2,not_share_qk)"])
def test_ret_forward_matches_jax_fp32_and_bf16(attention):
    """fp32 at atol 2e-4, rtol 1e-4; bf16 at most twice as far from the JAX
    float32 output as JAX bfloat16 is. T = 70 runs two 64-frame chunks."""
    cfg = dict(RET_CFG, attention=attention)
    params, net = _pair(cfg, seed=6)
    x = _x(6, T=70, cfg=cfg)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = _japply(cfg, params, x)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    _, net16 = _pair(cfg, seed=6, dtype=torch.bfloat16)
    with torch.no_grad():
        y16 = net16(torch.from_numpy(x)).numpy()
    j16 = _japply(cfg, params, x, model={"dtype": jnp.bfloat16})
    err, j_err = np.abs(y16 - want).max(), np.abs(j16 - want).max()
    assert err <= 2 * j_err, (err, j_err)


def test_ret_inference_recurrent_and_streaming_match_jax():
    """chunkwise_recurrent=False: forward(inference=True) runs the O(1)-state
    recurrence and matches the JAX model's; streaming_step frame by frame
    matches the JAX model's streaming_step and equals the recurrent forward."""
    cfg = dict(RET_CFG, chunkwise_recurrent=False)
    params, net = _pair(cfg, seed=7)
    x = _x(7, T=24, cfg=cfg)
    jnet = JOnlineSpatialNet(**cfg)
    with torch.no_grad():
        rec = net(torch.from_numpy(x), inference=True)
        state, outs = net.init_streaming_state(2), []
        for t in range(x.shape[2]):
            y, state = net.streaming_step(torch.from_numpy(x[:, :, t]), state)
            outs.append(y)
    streamed = torch.stack(outs, 2)
    want = _japply(cfg, params, x, inference=True)
    np.testing.assert_allclose(rec.numpy(), want, atol=2e-4, rtol=1e-4)
    step = jax.jit(lambda p, x_t, st: jnet.apply(p, x_t, st, method=jnet.streaming_step))
    jstate, jouts = jnet.apply(params, 2, method=jnet.init_streaming_state), []
    for t in range(x.shape[2]):
        y, jstate = step(params, jnp.asarray(x[:, :, t]), jstate)
        jouts.append(np.asarray(y))
    np.testing.assert_allclose(streamed.numpy(), np.stack(jouts, 2), atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(streamed, rec, atol=1e-5 * rec.abs().max().item(), rtol=1e-5)


def test_ret_chunkwise_is_causal():
    """Changing frames from t0 on leaves every earlier output frame as it
    was, across the 64-frame chunks."""
    _, net = _pair(RET_CFG, seed=8)
    x = torch.from_numpy(_x(8, T=150, cfg=RET_CFG))
    x2 = x.clone()
    x2[:, :, 100:] = torch.randn(x2[:, :, 100:].shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, y2 = net(x), net(x2)
    assert torch.equal(y[:, :, :100], y2[:, :, :100])
    assert not torch.allclose(y[:, :, 100:], y2[:, :, 100:])


def test_ret_module_forward_streaming_matches_jax():
    """TrainModule.forward_streaming with the retention branch, at the JAX
    test's size and bounds (atol 2e-3, rtol 2e-2)."""
    cfg = dict(RET_CFG, chunkwise_recurrent=False)
    params, net = _pair(cfg)
    kw = dict(channels=(0, 1), ref_channel=0, stft=None, norm=None, loss=None)
    module = TrainModule(arch=net, **{**kw, "stft": STFT(n_fft=16, n_hop=8),
                                      "norm": Norm(mode="utterance", online=True),
                                      "loss": Loss(name="neg_snr", pit=True)})
    j_module = JTrainModule(arch=JOnlineSpatialNet(**cfg), **{
        **kw, "stft": JSTFT(n_fft=16, n_hop=8), "norm": JNorm(mode="utterance", online=True),
        "loss": JLoss(name="neg_snr", pit=True)})
    x = np.random.default_rng(9).standard_normal((2, 2, 400)).astype(np.float32)
    y_str, _ = module.forward_streaming(torch.from_numpy(x))
    j_str, _ = j_module.forward_streaming(params, jnp.asarray(x))
    assert torch.isfinite(y_str).all()
    np.testing.assert_allclose(y_str.numpy(), np.asarray(j_str), atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("attention", ["mamba(8,4)", "ret(2,share_qk)"])
def test_remat_dots_equals_no_remat(attention):
    """remat_policy='dots' and full recomputation give the outputs and
    gradients of remat=False, with dropout active (the checkpoint restores
    the generator's state, so the recompute draws the same masks); the
    retention across two 64-frame chunks."""
    cfg = dict(CFG, attention=attention, decay=(4, 5, 9, 10), dropout=(0.1, 0.1, 0.1))
    x = torch.from_numpy(_x(10, T=70 if attention.startswith("ret") else 20, cfg=cfg))
    runs = []
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        _, net = _pair(cfg, seed=10, remat=remat, remat_policy=policy)
        net.train()
        torch.manual_seed(11)
        y = net(x)
        (y ** 2).mean().backward()
        runs.append((y.detach(), [p.grad for p in net.parameters()]))
    for y, grads in runs[1:]:
        assert torch.equal(y, runs[0][0])
        for g, g0 in zip(grads, runs[0][1]):
            torch.testing.assert_close(g, g0, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("attention", ["mamba(8,4)", "ret(2,share_qk)", "mhsa(251)"])
def test_dropout_eval_matches_jax_and_train_drops_whole_frequencies(attention):
    """In eval mode the rates change nothing (the JAX model's deterministic
    forward); in training the full-band keep mask zeroes whole frequencies
    of an utterance and scales the rest by 1 / (1 - p)."""
    cfg = dict(CFG, attention=attention, decay=(4, 5, 9, 10), dropout=(0.3, 0.3, 0.5))
    params, net = _pair(cfg, seed=12)
    x = _x(12, T=20, cfg=cfg)
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _japply(cfg, params, x), atol=2e-4, rtol=1e-4)

    layer, seen = net.layers[0], []
    hook = layer.full.register_forward_hook(lambda m, inp, out: seen.append(inp[0]))
    with torch.no_grad():
        net.eval()
        net(torch.from_numpy(x))
        net.train()
        torch.manual_seed(13)
        net(torch.from_numpy(x))
    hook.remove()
    ref, dropped = seen[0], seen[2]  # layer 0's full-band input [B, T, S, F] (shared module)
    zero = (dropped == 0).all(1).all(1)  # [B, F]: a whole frequency of an utterance
    assert zero.any() and not zero.all()
    kept = ~zero[:, None, None, :].expand_as(dropped)
    torch.testing.assert_close(dropped[kept], ref[kept] / 0.5)


@pytest.mark.parametrize("attention", ["mamba(16,4)", "ret(2,share_qk)"])
def test_config_file_init_args_build_and_train(attention):
    """configs/onlineSpatialNet.yaml's init_args, lists as YAML gives them
    (remat with the dots policy, dropout, decay), build the model at full
    width, and a backward runs through it (a few frames: the policy's
    values are held by test_remat_dots_equals_no_remat)."""
    import yaml

    init = yaml.safe_load((ROOT / "configs" / "onlineSpatialNet.yaml").read_text())
    args = dict(init["model"]["arch"]["init_args"], attention=attention)
    assert args["remat_policy"] == "dots" and isinstance(args["decay"], list)
    net = OnlineSpatialNet(**args, dim_input=12, dim_output=4, device="cpu")
    x = torch.randn(1, 129, 3, 12, generator=torch.Generator().manual_seed(0))
    y = net(x)
    assert y.shape == (1, 129, 3, 4) and torch.isfinite(y).all()
    y.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())
