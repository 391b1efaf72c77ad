"""The weight converter, the committed flagship checkpoint, and the port's
independence from JAX.

- Round trip: a flax tree -> utils/convert.py -> the JAX package's
  torch_compat.spatialnet_params_from_torch gives back an equal tree.
- Real weights: the committed SpatialNet-small epoch-39 checkpoint, restored
  by the JAX package on the CPU and converted, drives the port's full-width
  8-layer forward against nbss_tpu on a seeded 6-channel 0.5 s input. Both run
  in float32 on the CPU; the eight layers of sums in another order leave
  differences of about 2e-6 of the output's range, so the arch output is held
  at atol 1e-5 x max|y| (rtol 1e-4), and the waveform at SI-SDR >= 60 dB.
- Imports: no module of nbss_tpu_torch, and not chip_smoke.py, imports jax,
  flax, orbax, nbss_tpu, yaml, jsonargparse or soundfile.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.io import Norm as JNorm
from nbss_tpu.models.nbc import NBC as JNBC
from nbss_tpu.models.spatialnet import SpatialNet as JSpatialNet
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu.utils.torch_compat import nbc_params_from_torch, spatialnet_params_from_torch
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.models.nbc import NBC
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.ops.metrics import si_sdr
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import nbc_state_dict_from_flax, spatialnet_state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "logs" / "SpatialNet" / "version_0" / "checkpoints"
FLAGSHIP = dict(dim_input=12, dim_output=4, num_layers=8, dim_hidden=96, dim_ffn=192,
                num_heads=4, kernel_size=(5, 3), conv_groups=(8, 8), dim_squeeze=8,
                num_freqs=129, full_share=0)
BLOCKED = {"jax", "jaxlib", "flax", "orbax", "nbss_tpu", "yaml", "jsonargparse", "soundfile"}


@pytest.mark.parametrize("num_layers,full_share", [(2, 0), (3, 1)])
def test_converter_round_trips_through_torch_compat(num_layers, full_share):
    kw = dict(FLAGSHIP, num_layers=num_layers, dim_hidden=16, dim_ffn=32, num_freqs=9,
              conv_groups=(4, 4), dim_squeeze=4, full_share=full_share)
    params = JSpatialNet(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 12, 12)))
    sd = spatialnet_state_dict_from_flax(params, num_layers, full_share)
    net = SpatialNet(**kw, device="cpu")
    net.load_state_dict(sd, strict=True)  # every name and shape of the port's layout
    back = spatialnet_params_from_torch({k: v.numpy() for k, v in net.state_dict().items()},
                                        num_layers, full_share)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_epoch39_checkpoint_port_matches_jax():
    from nbss_tpu.train.ckpt import CheckpointManager

    params = CheckpointManager(str(CKPT)).restore(39)["params"]
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == 294 and sum(np.size(a) for a in leaves) == 1_191_092

    net = SpatialNet(**FLAGSHIP, device="cpu").eval()
    net.load_state_dict(spatialnet_state_dict_from_flax(params, FLAGSHIP["num_layers"]))
    module = TrainModule(arch=net, norm=Norm(mode="frequency"))
    j_module = JTrainModule(arch=JSpatialNet(**FLAGSHIP), norm=JNorm(mode="frequency"))
    x = (0.1 * np.random.default_rng(0).standard_normal((1, 6, 4000))).astype(np.float32)

    X, _ = module.stft.stft(torch.from_numpy(x))
    Xn, _ = module.norm.norm(X, ref_channel=0)
    B, C, F, T = Xn.shape
    Xin = torch.view_as_real(Xn.permute(0, 2, 3, 1)).reshape(B, F, T, 2 * C)
    with torch.no_grad():
        out = net(Xin).numpy()
    out_j = np.asarray(JSpatialNet(**FLAGSHIP).apply(params, jnp.asarray(Xin.numpy())))
    np.testing.assert_allclose(out, out_j, atol=1e-5 * np.abs(out_j).max(), rtol=1e-4)

    y, _ = module.forward(torch.from_numpy(x))
    y_j, _ = j_module.forward(params, jnp.asarray(x))
    assert si_sdr(y, torch.from_numpy(np.array(y_j))).min() >= 60.0


def _port_sources():
    return sorted((ROOT / "nbss_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("n_layers,n_conv_layers", [(2, 3), (1, 1)])
def test_nbc_converter_round_trips_through_torch_compat(n_layers, n_conv_layers):
    """flax NBC -> the port's state_dict (every name and shape of the port's
    NBC, the ConvTranspose kernel flipped) -> ``nbc_params_from_torch`` ->
    the tree it came from, leaf for leaf."""
    kw = dict(dim_input=4, dim_output=4, n_layers=n_layers, n_heads=2, hidden_size=16,
              ffn_size=32, inner_conv_groups=2, inner_conv_layers=n_conv_layers)
    params = JNBC(**kw).init(jax.random.PRNGKey(2), jnp.zeros((1, 2, 10, 4)))
    sd = nbc_state_dict_from_flax(params, n_layers, n_conv_layers)
    net = NBC(**kw, device="cpu")
    net.load_state_dict(sd, strict=True)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))  # each leaf once
    back = nbc_params_from_torch({k: v.numpy() for k, v in net.state_dict().items()},
                                 n_layers, n_conv_layers)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_port_sources_import_no_jax():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path.name} imports {name}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where the blocked
    packages cannot be imported."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for p in _port_sources()[:-1]]
    code = f"""
import importlib, importlib.abc, sys
BLOCKED = {sorted(BLOCKED)!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
print("imported", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout
