"""The port's training slice against nbss_tpu on the CPU.

A small SpatialNet (2 layers, H=16, F=9, 20 frames, 6 channels, 2 speakers)
with the JAX package's initial weights carried over by utils/convert.py. The
JAX package's fused block runs its Pallas forward and backward in interpret
mode; with it off, both sides run the plain module composition. A flax
gradient tree maps through the same converter as the parameters, so the
port's ``.grad`` is compared entry by entry of ``named_parameters()`` (the
shared full-band LinearGroup once, its gradient summed over layers on both
sides).

Bounds: losses rtol 1e-4; gradients and parameters after optimizer steps
atol and rtol 5e-3 (the JAX package's gradient bound); the learning-rate
schedule, the synthetic data and the sampler's order exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nbss_tpu.data.sampler import BatchLoader as JBatchLoader
from nbss_tpu.data.sampler import DistributedSampler as JDistributedSampler
from nbss_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from nbss_tpu.io import Loss as JLoss
from nbss_tpu.io import Norm as JNorm
from nbss_tpu.io import STFT as JSTFT
from nbss_tpu.models.spatialnet import SpatialNet as JSpatialNet
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu.train.optim import LRSchedule as JLRSchedule
from nbss_tpu.train.optim import build_optimizer
from nbss_tpu_torch.data.sampler import BatchLoader, DistributedSampler
from nbss_tpu_torch.data.synthetic import SyntheticDataModule, SyntheticDataset
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.train.ckpt import CheckpointManager
from nbss_tpu_torch.train.loop import Trainer
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.train.optim import LRSchedule, Optimizer, clip_by_global_norm
from nbss_tpu_torch.utils.convert import spatialnet_state_dict_from_flax

N_FFT, HOP, FRAMES = 16, 8, 20
SAMPLES = HOP * (FRAMES - 1)
KW = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32, num_heads=4,
          kernel_size=(5, 3), conv_groups=(4, 4), dim_squeeze=4, num_freqs=N_FFT // 2 + 1,
          full_share=0)


def _modules(fused, mchunk=None):
    j_net = JSpatialNet(**KW, fused_block=fused)
    params = JSpatialNet(**KW, fused_block=False).init(
        jax.random.PRNGKey(3), jnp.zeros((1, KW["num_freqs"], FRAMES, KW["dim_input"])))
    net = SpatialNet(**KW, fused_block=fused, device="cpu")
    net.load_state_dict(spatialnet_state_dict_from_flax(params, KW["num_layers"]))
    j_module = JTrainModule(arch=j_net, stft=JSTFT(n_fft=N_FFT, n_hop=HOP),
                            norm=JNorm(mode="frequency"), loss=JLoss("neg_si_sdr", pit=True),
                            mchunk=mchunk)
    module = TrainModule(arch=net, stft=STFT(n_fft=N_FFT, n_hop=HOP),
                         norm=Norm(mode="frequency"), loss=Loss("neg_si_sdr", pit=True),
                         mchunk=mchunk)
    return j_module, params, module


_JAX_STEPS = {}


def _jax_value_and_grad(j_module):
    """jax.jit of value_and_grad of training_step, compiled once per JAX
    module (the interpreted Pallas kernels are slow to run eagerly)."""
    if id(j_module) not in _JAX_STEPS:
        _JAX_STEPS[id(j_module)] = (j_module, jax.jit(jax.value_and_grad(
            lambda p, b: j_module.training_step(p, b))))
    return _JAX_STEPS[id(j_module)][1]


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX module with the fused block on, shared by the tests that
    run its interpreted kernels, so that they compile once."""
    return _modules(True)[0]


def _batch(seed, B=2):
    data = SyntheticDataset(num_items=B, audio_time_len=SAMPLES / 8000)
    items = [data[(i, seed + i)] for i in range(B)]
    return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


def _as_torch(batch):
    return tuple(torch.from_numpy(b) for b in batch)


def _grads_by_name(flax_grads):
    return spatialnet_state_dict_from_flax(flax_grads, KW["num_layers"])


@pytest.mark.parametrize("fused", [True, False])
def test_training_step_loss_and_gradients_match_jax(fused, jax_fused):
    j_module, params, module = _modules(fused)
    batch = _batch(0)
    step_j = _jax_value_and_grad(jax_fused if fused else j_module)
    loss_j, grads_j = step_j(params, tuple(map(jnp.asarray, batch)))
    loss = module.training_step(_as_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = _grads_by_name(grads_j)
    named = list(module.arch.named_parameters())
    assert len(named) == len(want) - (KW["num_layers"] - 1) * 2  # shared full-band once
    for name, p in named:
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_validation_step_matches_jax():
    j_module, params, module = _modules(False, mchunk=(0.005, 0.005))
    batch = _batch(5)
    got = module.validation_step(_as_torch(batch))
    want = jax.jit(j_module.validation_step)(params, tuple(map(jnp.asarray, batch)))
    assert set(got) == set(want) and any("si_sdr_" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("clip,clipped", [(5.0, True), (1e3, False)])
def test_three_adam_steps_track_jax(clip, clipped, jax_fused):
    """Adam 1e-3 with global-norm clipping through the fused block. At these
    weights the gradient's norm is about 60: clip 5 (the flagship's)
    triggers, clip 1000 does not."""
    _, params, module = _modules(True)
    tx = build_optimizer("Adam", {"lr": 1e-3}, clip)
    opt_state = tx.init(params)
    opt = Optimizer(module.arch.parameters(), "Adam", {"lr": 1e-3}, clip)
    step_j = _jax_value_and_grad(jax_fused)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for i in range(3):
        batch = _batch(10 + 2 * i)
        loss_j, grads_j = step_j(params, tuple(map(jnp.asarray, batch)))
        if i == 0:
            norm = float(optax.global_norm(grads_j))
            assert (norm >= clip) == clipped, norm
        params, opt_state = update(grads_j, opt_state, params)
        opt.zero_grad()
        loss = module.training_step(_as_torch(batch))
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = _grads_by_name(params)
    for name, p in module.arch.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=5e-3,
                                   rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("name,kwargs", [
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-2, "betas": (0.8, 0.9)}),
    ("SGD", {"lr": 0.1, "momentum": 0.9}),
])
def test_optimizer_chain_matches_optax(name, kwargs):
    """Clip, coupled weight decay and the optimizer, on fixed gradients."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = build_optimizer(name, dict(kwargs), 2.0)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = Optimizer(tparams.values(), name, dict(kwargs), 2.0)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(1)
    g = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    for max_norm in (100.0, 0.5):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in g], None)
        got = [torch.from_numpy(a.copy()) for a in g]
        norm = clip_by_global_norm(got, max_norm)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,kwargs,monitored", [
    ("ExponentialLR", {"gamma": 0.9}, None),
    ("ReduceLROnPlateau", {"mode": "min", "factor": 0.5, "patience": 1, "min_lr": 1e-4},
     [3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6, 1.7, 1.8]),
    (None, {}, None),
])
def test_lr_schedule_matches_jax(name, kwargs, monitored):
    got, want = LRSchedule(name, 1e-3, kwargs), JLRSchedule(name, 1e-3, kwargs)
    for epoch in range(10):
        m = monitored[epoch] if monitored else None
        assert got.step(epoch, m) == want.step(epoch, m)


@pytest.mark.parametrize("index,seed", [(0, 0), (3, 17), (5, 2**40 + 3)])
def test_synthetic_items_are_bit_identical(index, seed):
    got = SyntheticDataset(audio_time_len=0.5)[(index, seed)]
    want = JSyntheticDataset(audio_time_len=0.5)[(index, seed)]
    for a, w in zip(got[:2], want[:2]):
        assert a.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(a, w)
    assert got[2] == want[2]


@pytest.mark.parametrize("shuffle,num_replicas,rank,epoch", [
    (True, 1, 0, 0), (True, 3, 2, 4), (False, 2, 1, 1)])
def test_sampler_and_loader_order_match_jax(shuffle, num_replicas, rank, epoch):
    kw = dict(seed=7, shuffle=shuffle, num_replicas=num_replicas, rank=rank, last_epoch=epoch)
    got, want = DistributedSampler(11, **kw), JDistributedSampler(11, **kw)
    assert list(got) == list(want) and len(got) == len(want)
    data = SyntheticDataset(num_items=11, audio_time_len=0.01)
    jdata = JSyntheticDataset(num_items=11, audio_time_len=0.01)
    for a, w in zip(BatchLoader(data, 2, got, drop_last=False),
                    JBatchLoader(jdata, 2, want, drop_last=False)):
        np.testing.assert_array_equal(a[0], w[0])
        assert [p["index"] for p in a[2]] == [p["index"] for p in w[2]]


def test_checkpoints_save_restore_and_ensemble(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_epoch() is None and ckpt.best_epoch() is None
    net = torch.nn.Linear(3, 2)
    opt = Optimizer(net.parameters(), "Adam", {"lr": 1e-3})
    saved = []
    for epoch, metric in enumerate([1.0, 3.0, 2.0]):
        with torch.no_grad():
            net.weight.fill_(float(epoch))
        net.weight.grad, net.bias.grad = torch.ones(2, 3), torch.ones(2)
        opt.step()
        ckpt.save(epoch, net.state_dict(), opt.state_dict(), metric=metric)
        saved.append({k: v.clone() for k, v in net.state_dict().items()})
    for name in ("epoch2", "epoch2.json", "last.json"):
        assert (tmp_path / name).exists()
    assert sorted(os.listdir(tmp_path / "epoch1")) == ["opt_state", "params"]
    assert ckpt.latest_epoch() == 2
    assert ckpt.best_epoch("max") == 1 and ckpt.best_epoch("min") == 0

    r = ckpt.restore(1)
    assert r["epoch"] == 1 and "opt_state" in r
    for k, v in saved[1].items():
        torch.testing.assert_close(r["params"][k], v, atol=0, rtol=0)
    assert r["opt_state"]["state"][0]["step"] == 2
    assert "opt_state" not in ckpt.restore(reset=["optimizer"])
    assert ckpt.restore()["epoch"] == 2

    ens = ckpt.ensemble(2)
    assert ens["epochs"] == [1, 2]
    for k in saved[0]:
        want = ((saved[1][k].double() + saved[2][k].double()) / 2).float()
        torch.testing.assert_close(ens["params"][k], want, atol=0, rtol=0)
    assert ckpt.ensemble("epoch[02]")["epochs"] == [0, 2]
    assert ckpt.ensemble([0, 1])["epochs"] == [0, 1]


def test_trainer_fits_resumes_and_stops_early(tmp_path, capsys):
    """Trainer on the CPU: seeded init, epoch summaries, a checkpoint per
    epoch, resume from the last one, and early stopping."""
    def make():
        module = TrainModule(arch=SpatialNet(**KW, device="cpu"), stft=STFT(n_fft=N_FFT, n_hop=HOP),
                             norm=Norm(mode="frequency"))
        return Trainer(module, seed=4, ckpt_dir=str(tmp_path), device="cpu",
                       early_stopping={"patience": 1, "mode": "max", "min_delta": 100.0})

    dm = SyntheticDataModule(num_items=4, batch_size=(2, 2), seeds=(1, 2, 3, 3),
                             audio_time_len=SAMPLES / 8000)
    a, b = make(), make()
    a.init()
    b.init()
    for (n, p), (_, q) in zip(a.arch.named_parameters(), b.arch.named_parameters()):
        torch.testing.assert_close(p, q, atol=0, rtol=0, msg=n)  # same seed, same weights
    history = a.fit(lambda: dm.train_dataloader(a.epoch), dm.val_dataloader, max_epochs=5)
    out = capsys.readouterr().out
    assert "epoch 0: train/neg_si_sdr=" in out and "epoch 1:" in out and "epoch 2:" not in out
    assert a.epoch == 2 and np.isfinite(history["train_loss"])  # stopped after patience 1
    assert CheckpointManager(str(tmp_path)).latest_epoch() == 1
    np.testing.assert_allclose(a.opt.lr, 1e-3 * 0.99 ** 2)
    c = make()
    c.restore()
    assert c.epoch == 2
    for (n, p), (_, q) in zip(a.arch.named_parameters(), c.arch.named_parameters()):
        torch.testing.assert_close(p, q, atol=0, rtol=0, msg=n)
