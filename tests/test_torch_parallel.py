"""The port's data parallelism (nbss_tpu_torch.parallel) on the CPU, gloo ranks.

- Two ranks through ``Trainer`` (tests/torch_parallel_worker.py, one spawn):
  the global loss and the all-reduced, clipped gradient of a step equal one
  process's on the same global batch of 8 (atol 1e-5, rtol 1e-4) and the JAX
  ``Trainer``'s ``value_and_grad`` on ``make_mesh(2)`` of the conftest's
  virtual CPU devices, with the weights carried by utils/convert.py (the
  port's training tolerance, 5e-3); the parameters are bit-identical across
  ranks and, after 2 Adam steps, within atol 5e-4 and rtol 1e-2 of one
  process's (the bound of tests/test_multihost.py); validation over a ragged
  last batch (replicated, counted once) equals one process's; a replicated
  batch that differs between ranks raises; each rank's loaders take its
  contiguous rows of the host batches, a short validation batch whole.
- Two hosts over ``NBSS_COORDINATOR`` on localhost, two ranks each: each
  rank's train items are its rows of the JAX sampler's batches for its host,
  and ``run_test``'s merge holds all 16 test items once.
- ``cli fit --trainer.accelerator=cpu --trainer.devices=2`` writes one
  version directory and its checkpoint loads with ``cli test`` on one device.
- Without spawning: the rendezvous contract from the environment and
  torchrun's (``init_from_env``, a group of one), the device count capped as
  the JAX CLI caps its mesh, the rows of a host batch, the sampler without
  padding, and every arch of configs/ giving each parameter a gradient (so
  ``DistributedDataParallel`` runs without ``find_unused_parameters``).

Every spawn has its own timeout (``launch(timeout=...)``).
"""

import json
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as W
from nbss_tpu.data.sampler import DistributedSampler as JDistributedSampler
from nbss_tpu_torch import parallel
from nbss_tpu_torch.cli.config import load_configs
from nbss_tpu_torch.cli.main import local_ranks, run
from nbss_tpu_torch.data.sampler import DistributedSampler, rank_batches
from nbss_tpu_torch.parallel.mesh import Mesh, Shard, shard_batch
from nbss_tpu_torch.utils.convert import spatialnet_state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 300


def _jax_module():
    from nbss_tpu.io import Loss, Norm, STFT
    from nbss_tpu.models import SpatialNet
    from nbss_tpu.train.module import TrainModule

    arch = SpatialNet(**W.KW, fused_block=False)
    return TrainModule(arch=arch, channels=(0, 1), ref_channel=0, stft=STFT(n_fft=256, n_hop=128),
                       norm=Norm(mode="frequency"), loss=Loss(name="neg_si_sdr", pit=True))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The 2-rank run and one process's, from the JAX package's initial
    weights carried by utils/convert.py."""
    tmp = tmp_path_factory.mktemp("dp")
    j_module = _jax_module()
    params = j_module.arch.init(jax.random.PRNGKey(5),
                                jnp.zeros((1, 129, 63, W.KW["dim_input"])))
    state = spatialnet_state_dict_from_flax(params, W.KW["num_layers"])
    torch.save(state, tmp / "state.pt")
    assert parallel.launch(W.dp_rank, (str(tmp / "state.pt"), str(tmp)), 2, "gloo",
                           timeout=SPAWN_TIMEOUT, threads=1) == [0, 1]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    for r in range(2):
        ranks[r].update(json.loads((tmp / f"rank{r}.json").read_text()))
    one = W.train_and_validate(W.make_trainer(state), Mesh())
    return {"ranks": ranks, "one": one, "j_module": j_module, "params": params}


def test_two_ranks_step_matches_one_process(dp_run):
    r0, one = dp_run["ranks"][0], dp_run["one"]
    np.testing.assert_allclose(r0["losses"][0], one["losses"][0], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(r0["grads"], one["grads"], atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(r0["grads"], dp_run["ranks"][1]["grads"])


def test_two_ranks_step_matches_jax_mesh_of_two(dp_run, cpu_devices):
    """value_and_grad of the JAX TrainModule with the global batch sharded
    over make_mesh(2); its gradient clipped by global norm 5 as the port's
    optimizer clips the all-reduced one."""
    from nbss_tpu.parallel import make_mesh

    j_module, params = dp_run["j_module"], dp_run["params"]
    x, ys, _ = W.batches(W.GLOBAL_BATCH, W.GLOBAL_BATCH, seed=11)[0]
    mesh = make_mesh(2)
    sharded = jax.device_put((jnp.asarray(x), jnp.asarray(ys)), NamedSharding(mesh, P("data")))
    loss, grads = jax.jit(jax.value_and_grad(j_module.training_step))(params, sharded)
    grads, _ = optax.clip_by_global_norm(5.0).update(grads, None)
    want = spatialnet_state_dict_from_flax(grads, W.KW["num_layers"])
    names = [n for n, _ in W.make_module().arch.named_parameters()]
    want = np.concatenate([want[n].numpy().reshape(-1) for n in names])
    r0 = dp_run["ranks"][0]
    np.testing.assert_allclose(r0["losses"][0], float(loss), rtol=5e-3)
    np.testing.assert_allclose(r0["grads"], want, atol=5e-3, rtol=5e-3)


def test_parameters_identical_across_ranks_and_track_one_process(dp_run):
    r0, r1, one = *dp_run["ranks"], dp_run["one"]
    np.testing.assert_array_equal(r0["params"], r1["params"])
    np.testing.assert_allclose(r0["params"], one["params"], atol=5e-4, rtol=1e-2)
    np.testing.assert_allclose(r0["losses"], one["losses"], atol=1e-4, rtol=1e-4)


def test_validation_over_ranks_equals_one_process(dp_run):
    r0, r1, one = *dp_run["ranks"], dp_run["one"]
    assert r0["val"] == r1["val"]  # every rank takes the same decisions
    assert set(r0["val"]) == set(one["val"])
    for k, v in one["val"].items():
        np.testing.assert_allclose(r0["val"][k], v, atol=1e-5, rtol=1e-4, err_msg=k)


def test_replicated_batch_that_differs_raises(dp_run):
    assert all(r["crc_raised"] for r in dp_run["ranks"])


def test_each_rank_loads_its_rows(dp_run):
    """Train batches of 4 from the host's sampler: rank r takes rows
    [2r, 2r + 2); validation batches of 3 do not split, so both take them."""
    want = list(JDistributedSampler(12, seed=1, shuffle=True, last_epoch=0))
    host = [[i for i, _ in want[a:a + 4]] for a in range(0, 12, 4)]
    for r, run_ in enumerate(dp_run["ranks"]):
        assert run_["train_items"] == [b[2 * r:2 * r + 2] for b in host]
        val = [i for i, _ in JDistributedSampler(12, seed=2, shuffle=False, last_epoch=0)]
        assert run_["val_items"] == [[val[a:a + 3], True] for a in range(0, 12, 3)]


def _host(rdv, out_dir, results, key):
    try:
        results[key] = parallel.launch(W.host_rank, (out_dir,), 2, "gloo", rdv=rdv,
                                       timeout=SPAWN_TIMEOUT, threads=1)
    except BaseException as e:  # raised in the test thread
        results[key] = e


def test_two_hosts_over_nbss_coordinator(tmp_path, monkeypatch):
    """Two launcher 'hosts' of two ranks each meet at NBSS_COORDINATOR on
    localhost (the hosts run as two threads of this process)."""
    coord = f"127.0.0.1:{parallel.mesh.free_port()}"
    rdvs = []
    for pid in range(2):
        monkeypatch.setenv("NBSS_COORDINATOR", coord)
        monkeypatch.setenv("NBSS_NUM_PROCESSES", "2")
        monkeypatch.setenv("NBSS_PROCESS_ID", str(pid))
        rdvs.append(parallel.rendezvous(num_nodes=1))
    assert rdvs == [parallel.Rendezvous(coord, 2, 0), parallel.Rendezvous(coord, 2, 1)]
    results = {}
    threads = [threading.Thread(target=_host, args=(rdvs[p], str(tmp_path), results, p))
               for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p in range(2):
        if isinstance(results[p], BaseException):
            raise results[p]
    ranks = results[0] + results[1]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        host = [i for i, _ in JDistributedSampler(16, seed=3, shuffle=True, num_replicas=2,
                                                 rank=r["host"], last_epoch=0)]
        lr = r["local_rank"]
        assert r["train_items"] == [host[a:a + 4][2 * lr:2 * lr + 2] for a in range(0, 8, 4)]
    assert ranks[0]["num_items"] == 16
    merged = json.loads((tmp_path / "test" / "results_mean.json").read_text())
    assert np.isfinite(merged["SI_SDR"])
    files = sorted(tmp_path.joinpath("test").glob("results_2*.json"))
    names = [item["wavname"] for item in json.loads(files[-1].read_text())]
    assert sorted(names, key=int) == [str(i) for i in range(16)]
    assert sorted(p.name for p in tmp_path.joinpath("test").glob("results_rank*.json")) == \
        [f"results_rank{r}.json" for r in range(4)]


def test_cli_fit_on_two_devices_then_test_on_one(tmp_path):
    args = ["--config", str(ROOT / "configs" / "SpatialNet.yaml"),
            "--config", str(ROOT / "configs" / "datasets" / "synthetic.yaml"),
            "--log_root", str(tmp_path / "logs"), "--trainer.accelerator=cpu",
            "--trainer.max_epochs=1", "--trainer.limit_train_batches=2",
            "--trainer.limit_val_batches=2", "--trainer.precision=32",
            "--model.arch.init_args.num_layers=1", "--model.arch.init_args.dim_hidden=16",
            "--model.arch.init_args.dim_ffn=32", "--model.arch.init_args.dim_squeeze=4",
            "--model.arch.init_args.num_freqs=33", "--model.stft.init_args.n_fft=64",
            "--model.stft.init_args.n_hop=32", "--data.init_args.num_items=8",
            "--data.init_args.num_channels=2", "--data.init_args.audio_time_len=0.5",
            "--data.init_args.batch_size=[4, 2]", "--model.channels=[0, 1]"]
    out = run(["fit", *args, "--trainer.devices=2"])
    assert np.isfinite(out["train_loss"]) and np.isfinite(out["val/metric"])
    assert sorted(os.listdir(tmp_path / "logs" / "SpatialNet")) == ["version_0"]
    version = tmp_path / "logs" / "SpatialNet" / "version_0"
    for f in ("config.yaml", "provenance.txt", "model.txt", "metrics.jsonl",
              "checkpoints/epoch0/params"):
        assert (version / f).exists(), f
    params = torch.load(version / "checkpoints" / "epoch0" / "params")
    assert not any(k.startswith("module.") for k in params)
    res = run(["test", *args, "--trainer.devices=1", "--trainer.limit_test_batches=3",
               "--model.metrics=[SI_SDR]", "--model.write_examples=0",
               "--ckpt_path", str(version / "checkpoints" / "epoch0")])
    assert res["num_items"] == 3 and np.isfinite(res["SI_SDR"])


@pytest.mark.parametrize("devices,cards,train_bs", [
    (None, 8, 8), (None, 8, 6), (3, 8, 8), (4, 8, 2), (16, 8, 8), (None, 8, 5), (2, 1, 8)])
def test_device_count_is_capped_as_the_jax_cli_caps_its_mesh(devices, cards, train_bs,
                                                            monkeypatch):
    """``local_ranks`` against ``nbss_tpu.cli.main._mesh_for`` with ``cards``
    JAX devices (the conftest's 8 virtual CPU devices, or fewer)."""
    from nbss_tpu.cli import main as jmain

    cfg = {"trainer": {} if devices is None else {"devices": devices},
           "data": {"init_args": {"batch_size": [train_bs, 1]}}}
    monkeypatch.setattr(jax, "device_count", lambda: cards)
    assert local_ranks(cfg, cards) == jmain._mesh_for(cfg).devices.size
    assert local_ranks(cfg, None) == (1 if devices is None else
                                      max(n for n in range(1, devices + 1) if train_bs % n == 0))


def test_rendezvous_contract(monkeypatch):
    for k in ("NBSS_COORDINATOR", "NBSS_NUM_PROCESSES", "NBSS_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.rendezvous(1) is None
    with pytest.raises(ValueError, match="NBSS_COORDINATOR.*torchrun"):
        parallel.rendezvous(2)
    monkeypatch.setenv("NBSS_COORDINATOR", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="NBSS_NUM_PROCESSES"):
        parallel.rendezvous(1)
    monkeypatch.setenv("NBSS_NUM_PROCESSES", "3")
    monkeypatch.setenv("NBSS_PROCESS_ID", "2")
    assert parallel.rendezvous(1) == parallel.Rendezvous("10.0.0.1:1234", 3, 2)
    monkeypatch.delenv("NBSS_COORDINATOR")
    for k, v in dict(MASTER_ADDR="h0", MASTER_PORT="29500", RANK="5", WORLD_SIZE="8",
                     LOCAL_WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    assert parallel.rendezvous(2) == parallel.Rendezvous(None, 2, 1, torchrun=True)


@pytest.mark.parametrize("n,ranks,drop_last", [(8, 2, True), (6, 4, False), (7, 2, False)])
def test_rank_batches_take_contiguous_rows_or_replicate(n, ranks, drop_last):
    samples = list(range(n))
    per_rank = [list(rank_batches(samples, 4, drop_last, ranks, r)) for r in range(ranks)]
    host = [samples[a:a + 4] for a in range(0, n, 4)
            if not drop_last or len(samples[a:a + 4]) == 4]
    for r, got in enumerate(per_rank):
        assert len(got) == len(host)
        for (items, replicated), b in zip(got, host):
            k = len(b) // ranks
            assert (items, replicated) == ((b, True) if len(b) % ranks
                                           else (b[r * k:(r + 1) * k], False))
    # rank by rank, the rows of a split batch put the host batch back together
    for i, b in enumerate(host):
        if len(b) % ranks == 0:
            assert sum((per_rank[r][i][0] for r in range(ranks)), []) == b


def test_shard_batch_rows_and_sampler_without_padding():
    x, ys = np.arange(8)[:, None], np.arange(8)[:, None] * 2
    got = shard_batch(Mesh(2, 1, 2, 1), (x, ys))
    assert isinstance(got, Shard) and not got.replicated
    np.testing.assert_array_equal(got[0], x[4:])
    np.testing.assert_array_equal(got[1], ys[4:])
    assert shard_batch(Mesh(), (x, ys)).replicated is False
    assert shard_batch(Mesh(2, 1, 2, 1), got) is got
    items = [list(DistributedSampler(10, seed=4, num_replicas=4, rank=r, pad=False))
             for r in range(4)]
    assert sorted(i for rank in items for i, _ in rank) == list(range(10))
    assert [len(DistributedSampler(10, num_replicas=4, rank=r, pad=False))
            for r in range(4)] == [len(i) for i in items] == [3, 3, 2, 2]
    padded = list(DistributedSampler(10, seed=4, num_replicas=4, rank=3))
    assert padded[:2] == items[3] and len(padded) == 3


@pytest.mark.parametrize("config", sorted(p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_every_config_arch_gives_each_parameter_a_gradient(config):
    """DistributedDataParallel runs without find_unused_parameters: every
    parameter of every arch in configs/ (at its widths, in float32) gets a
    gradient from one training step on a short input."""
    from nbss_tpu_torch.cli.main import build_module
    from nbss_tpu_torch.models.base import init_parameters

    module = build_module(load_configs([str(ROOT / "configs" / config)],
                                       {"trainer.precision": "32"}), device="cpu")
    init_parameters(module.arch, torch.Generator().manual_seed(0))
    C, T = max(module.channels) + 1, module.stft.n_hop * 12
    g = torch.Generator().manual_seed(1)
    module.arch.train()
    module.training_step((0.1 * torch.randn(1, C, T, generator=g),
                          0.1 * torch.randn(1, 2, C, T, generator=g))).backward()
    assert [n for n, p in module.arch.named_parameters() if p.grad is None] == []


def test_init_from_env_makes_this_process_a_rank(monkeypatch):
    """torchrun's contract: this process joins the group its env:// variables
    name (here a group of one)."""
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(parallel.mesh.free_port()),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    try:
        mesh = parallel.init_from_env("gloo", "cpu")
        assert mesh == Mesh(1, 0, 1, 0) and parallel.current_mesh() is mesh
        assert torch.distributed.is_initialized()
    finally:
        parallel.shutdown()
    assert parallel.current_mesh() == Mesh() and not torch.distributed.is_initialized()
