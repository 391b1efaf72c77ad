"""The JAX package's two committed epoch-39 runs in the port's checkpoint
layout (checkpoints_torch/, written by scripts/convert_jax_checkpoint.py),
and the golden outputs of that package which hold the port against it.

- The committed params equal the converter's output on the orbax tree
  (restored once per run by the JAX package's CheckpointManager), leaf for
  leaf, with every key of the port's state_dict present, and load into the
  port's arch with ``strict=True``; config.yaml is the JAX run's, byte for
  byte; the port's CheckpointManager restores epoch 39 with no optimizer
  state; the command line's refusal of the orbax directory names the
  converted copy.
- The script converts the other archs it has a converter for (NBC, NBC2,
  NB-BLSTM at tiny widths) from a run that the JAX CheckpointManager wrote.
- On the CPU, the port's plain path with the converted params, on the
  golden item 0 at its full 4 s, matches the JAX package's float32 offline
  output stored in the fixture: atol 1e-5 x max|y|, rtol 1e-4, SI-SDR >= 60
  dB (the bounds of tests/test_torch_convert.py's epoch-39 test).
- The fixture's shapes and provenance.
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nbss_tpu.train.ckpt import CheckpointManager as JCheckpointManager
from nbss_tpu_torch.cli.config import load_configs
from nbss_tpu_torch.cli.main import build_module, run
from nbss_tpu_torch.ops.metrics import si_sdr
from nbss_tpu_torch.train.ckpt import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
RUNS = {"spatialnet": "SpatialNet", "online": "OnlineSpatialNet"}
LEAVES = {"spatialnet": (294, 1_191_092), "online": (310, 1_346_996)}  # model.txt
GOLDEN = ROOT / "checkpoints_torch" / "epoch39_golden.npz"
OUTPUTS = [f"{m}_{p}_{prec}" for m, p in (("spatialnet", "forward"), ("online", "forward"),
                                          ("online", "streaming")) for prec in ("fp32", "bf16")]


def _script():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", ROOT / "scripts" / "convert_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(model):
    return ROOT / "logs" / RUNS[model] / "version_0"


def _port_run(model):
    return ROOT / "checkpoints_torch" / RUNS[model] / "version_0"


@pytest.fixture(scope="module")
def orbax_params():
    """Each committed orbax tree, restored once."""
    return {m: JCheckpointManager(str(_jax_run(m) / "checkpoints")).restore(39)["params"]
            for m in RUNS}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _port_arch(model):
    cfg = load_configs([str(_port_run(model) / "config.yaml")])
    return build_module(dict(cfg, trainer=dict(cfg["trainer"], precision="32")), "cpu")


@pytest.mark.parametrize("model", list(RUNS))
def test_committed_params_equal_the_converted_orbax_tree(model, orbax_params):
    params = orbax_params[model]
    leaves = jax.tree_util.tree_leaves(params)
    assert (len(leaves), sum(np.size(a) for a in leaves)) == LEAVES[model]
    script = _script()
    arch = script.build_module(load_configs([str(_jax_run(model) / "config.yaml")])).arch
    want = script.converter(arch)(params)
    got = torch.load(_port_run(model) / "checkpoints" / "epoch39" / "params",
                     map_location="cpu")
    net = _port_arch(model).arch
    assert set(got) == set(want) == set(net.state_dict())
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    net.load_state_dict(got, strict=True)
    assert sum(p.numel() for p in net.parameters()) == LEAVES[model][1]


@pytest.mark.parametrize("model", list(RUNS))
def test_config_is_the_jax_runs_byte_for_byte(model):
    assert (_port_run(model) / "config.yaml").read_bytes() == \
        (_jax_run(model) / "config.yaml").read_bytes()


@pytest.mark.parametrize("model", list(RUNS))
def test_port_checkpoint_manager_restores_epoch39_without_optimizer(model):
    manager = CheckpointManager(str(_port_run(model) / "checkpoints"))
    assert manager.latest_epoch() == 39
    restored = manager.restore(39)
    assert set(restored) == {"params", "epoch"} and restored["epoch"] == 39
    assert manager.restore()["epoch"] == 39


@pytest.mark.parametrize("model", list(RUNS))
def test_cli_refuses_the_orbax_run_and_names_its_converted_copy(model, tmp_path):
    orbax = _jax_run(model) / "checkpoints" / "epoch39"
    with pytest.raises(ValueError, match="convert_jax_checkpoint.py") as err:
        run(["test", f"--config={_port_run(model) / 'config.yaml'}",
             f"--ckpt_path={orbax}", "--trainer.accelerator=cpu",
             f"--log_root={tmp_path}"])
    assert f"checkpoints_torch/{RUNS[model]}/version_0" in str(err.value)
    assert "convert.py" in str(err.value)
    assert not any(tmp_path.iterdir())


TINY = {
    "NBC": (dict(n_layers=2, n_heads=2, hidden_size=16, ffn_size=32, inner_conv_groups=2,
                 inner_conv_layers=2), (1, 2, 10, 4)),
    "NBC2": (dict(n_layers=2, dim_hidden=16, dim_ffn=32, n_heads=2, n_conv_groups=4,
                  num_freqs=3), (1, 3, 10, 4)),
    "BLSTM2_FC1": (dict(hidden_size=[8, 6], n_repeat_last_lstm=2), (1, 3, 10, 4)),
}


@pytest.mark.parametrize("arch", list(TINY))
def test_script_converts_a_jax_run_of_another_arch(arch, tmp_path):
    """A tiny run that the JAX CheckpointManager wrote, converted by the
    script into the port's layout and read back by the port."""
    import nbss_tpu.models as jmodels

    init_args, shape = TINY[arch]
    cfg = {"trainer": {"precision": "32"},
           "model": {"arch": {"class_path": f"nbss_tpu.models.{arch}", "init_args": init_args},
                     "channels": [0, 1]}}
    jrun, prun = tmp_path / "jax" / "version_0", tmp_path / "port" / "version_0"
    jrun.mkdir(parents=True)
    (jrun / "config.yaml").write_text(yaml.safe_dump(cfg))
    net = getattr(jmodels, arch)(dim_input=4, dim_output=4, **init_args)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    JCheckpointManager(str(jrun / "checkpoints")).save(3, params, metric=1.5)

    script = _script()
    info = script.convert_run(str(jrun), str(prun))
    assert info["epoch"] == 3 and info["arch"] == arch
    restored = CheckpointManager(str(prun / "checkpoints")).restore()
    assert restored["epoch"] == 3 and "opt_state" not in restored
    want = script.converter(net)(params)
    assert set(restored["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(restored["params"][k].numpy(), v.numpy(), err_msg=k)
    assert (prun / "config.yaml").read_bytes() == (jrun / "config.yaml").read_bytes()
    assert (prun / "checkpoints" / "epoch3.json").read_text() == '{"epoch": 3, "metric": 1.5}'
    port = build_module(load_configs([str(prun / "config.yaml")]), "cpu").arch
    port.load_state_dict(restored["params"], strict=True)


@pytest.fixture()
def one_thread():
    """The full-size forward is thousands of small ops: beside the other
    test workers, torch's intra-op threads contend for the cores and slow it
    by two orders of magnitude, so it runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model", list(RUNS))
def test_port_plain_path_matches_the_jax_golden_output(model, golden, one_thread):
    module = _port_arch(model)
    restored = CheckpointManager(str(_port_run(model) / "checkpoints")).restore(39)
    module.arch.load_state_dict(restored["params"], strict=True)
    module.arch.eval()
    y, _ = module.forward(torch.from_numpy(golden["x"][:1]))
    want = golden[f"{model}_forward_fp32"][:1]
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)
    assert si_sdr(y, torch.from_numpy(want)).min() >= 60.0


def test_golden_fixture_shapes_and_provenance(golden):
    n, C, T = golden["x"].shape
    assert (n, C, T) == (2, 6, 32000) and golden["yr"].shape == (2, 2, 32000)
    for key in OUTPUTS:
        assert golden[key].shape == (2, 2, 32000) and golden[key].dtype == np.float32, key
        assert np.isfinite(golden[key]).all(), key
        assert golden[f"{key}_si_sdr"].shape == golden[f"{key}_si_sdri"].shape == (2,), key
    assert golden["rir_file"].tolist() == ["test/440.npz", "test/441.npz"]
    assert golden["index"].tolist() == [0, 1]
    assert len(str(golden["commit"])) == 40 and "--golden" in str(golden["command"])
    assert float(golden["seconds"]) > 0
    # the JAX package's separations improve on the mixtures by several dB
    assert (golden["spatialnet_forward_fp32_si_sdri"] > 5).all()
    assert os.path.basename(str(golden["command"]).split()[1]) == "convert_jax_checkpoint.py"
