#!/usr/bin/env python3
"""Convert a run of the JAX package into the PyTorch port's checkpoint layout,
and write the golden outputs that hold the port's trained models against it.

    python scripts/convert_jax_checkpoint.py logs/SpatialNet/version_0 \\
        checkpoints_torch/SpatialNet/version_0 --epoch 39
    python scripts/convert_jax_checkpoint.py --golden checkpoints_torch/epoch39_golden.npz

Runs on a machine with JAX, flax and orbax (the JAX package restores the
orbax tree), on the CPU. The first form restores ``<run>/checkpoints/epoch{N}``
with ``nbss_tpu.train.ckpt.CheckpointManager``, picks the converter of
``nbss_tpu_torch/utils/convert.py`` by the arch's ``class_path`` in
``<run>/config.yaml`` (SpatialNet, OnlineSpatialNet, NBC, NBC2, BLSTM2_FC1),
loads the result into the port's arch with ``strict=True``, and writes it
with the port's ``CheckpointManager`` (``<out>/checkpoints/epoch{N}/params``,
``epoch{N}.json``, ``last.json``), with ``config.yaml`` copied byte for byte,
so that ``python -m nbss_tpu_torch.cli test --config=<out>/config.yaml
--ckpt_path=<out>/checkpoints/epoch{N}`` takes it as a run the port trained.
The optimizer state is not converted: the port's ``restore`` then returns
none, and a resumed fit starts a fresh optimizer.

``--golden`` regenerates the SpatialNet run's test items 0 and 1 with the
JAX package's ``sim`` and ``DeviceSyntheticDataModule`` at its
``config.yaml``'s settings (rooms test/440 and test/441 of
``scripts/run_spatialnet_convergence.sh``'s corpus, rendered alone), and
stores the mixtures, the reference-channel targets and the JAX package's
separated waveforms ``yr_hat`` of both committed models in float32 and in
bfloat16: SpatialNet ``forward``, OnlineSpatialNet ``forward`` and
``forward_streaming``, each with its per-item SI-SDR and SI-SDRi (after PIT,
the mean over speakers), and the commit, command and seconds taken.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nbss_tpu.cli.config import instantiate, load_configs  # noqa: E402
from nbss_tpu.cli.main import build_module  # noqa: E402
from nbss_tpu.train.ckpt import CheckpointManager  # noqa: E402

# the runs whose epoch-39 outputs the golden fixture holds
SPATIALNET_RUN = ROOT / "logs" / "SpatialNet" / "version_0"
ONLINE_RUN = ROOT / "logs" / "OnlineSpatialNet" / "version_0"
GOLDEN_EPOCH = 39
# scripts/run_spatialnet_convergence.sh's corpus: --rir_nums 400 40 60, so the test rooms
# start at 440; test item i takes room 440 + i while i < 60 (DeviceRirDataset, index mode)
GOLDEN_SIM = dict(spk_num=2, noise_num=0, arr_geometry="circular+cm", mic_num=6, fs=8000,
                  RT60_lim=(0.1, 0.6), seed=0)
GOLDEN_LENGTH_ROUND = 2048
FIRST_TEST_ROOM = 440
GOLDEN_ITEMS = 2
PRECISIONS = {"fp32": "32", "bf16": "bf16-mixed"}


def converter(arch):
    """The ``utils/convert.py`` function for a JAX arch, as params -> state_dict."""
    from nbss_tpu_torch.utils import convert

    name = type(arch).__name__
    table = {
        "SpatialNet": lambda p: convert.spatialnet_state_dict_from_flax(
            p, arch.num_layers, arch.full_share),
        "OnlineSpatialNet": lambda p: convert.online_spatialnet_state_dict_from_flax(
            p, arch.num_layers, arch.full_share),
        "NBC": lambda p: convert.nbc_state_dict_from_flax(
            p, arch.n_layers, arch.inner_conv_layers),
        "NBC2": lambda p: convert.nbc2_state_dict_from_flax(p, arch.n_layers),
        "BLSTM2_FC1": convert.blstm2_fc1_state_dict_from_flax,
    }
    if name not in table:
        raise ValueError(f"no converter for {name} (one of {sorted(table)})")
    return table[name]


def convert_run(run: str, out: str, epoch=None) -> dict:
    """Restore ``run``'s checkpoint ``epoch`` (the newest by default), convert
    it and write it under ``out`` in the port's layout; returns
    {"epoch", "arch", "leaves", "numbers"} of the tree."""
    from nbss_tpu_torch.cli.main import build_module as port_module
    from nbss_tpu_torch.train.ckpt import CheckpointManager as PortCheckpointManager

    run, out = Path(run), Path(out)
    cfg = load_configs([str(run / "config.yaml")])
    manager = CheckpointManager(str(run / "checkpoints"))
    epoch = manager.latest_epoch() if epoch is None else int(epoch)
    params = manager.restore(epoch)["params"]
    arch = build_module(cfg).arch
    sd = converter(arch)(params)
    leaves = jax.tree_util.tree_leaves(params)
    net = port_module(cfg, device="cpu").arch
    net.load_state_dict(sd, strict=True)  # every name and shape of the port's arch
    meta_path = run / "checkpoints" / f"epoch{epoch}.json"
    metric = json.loads(meta_path.read_text()).get("metric") if meta_path.exists() else None
    out.mkdir(parents=True, exist_ok=True)
    PortCheckpointManager(str(out / "checkpoints")).save(epoch, net.state_dict(), metric=metric)
    shutil.copyfile(run / "config.yaml", out / "config.yaml")
    return {"epoch": epoch, "arch": type(arch).__name__, "leaves": len(leaves),
            "numbers": int(sum(np.size(a) for a in leaves))}


def _item_metrics(yr_hat, yr, x_ref):
    """Per item: SI-SDR after PIT, the mean over speakers, and its gain over
    the reference channel of the mixture."""
    from nbss_tpu.ops.metrics import si_sdr
    from nbss_tpu.ops.pit import permutate, pit

    def mean_si_sdr(preds, target):
        return si_sdr(preds, target).mean(-1)

    yr_hat, yr = jnp.asarray(yr_hat), jnp.asarray(yr)
    _, perm = pit(preds=yr_hat, target=yr, metric_func=mean_si_sdr)
    sdr = mean_si_sdr(permutate(yr_hat, perm), yr)
    sdr_in = mean_si_sdr(jnp.broadcast_to(jnp.asarray(x_ref)[:, None], yr.shape), yr)
    return np.asarray(sdr, np.float64), np.asarray(sdr - sdr_in, np.float64)


def _test_items(cfg: dict, rir_dir: str, n: int):
    """The first ``n`` test items of the run's DeviceSyntheticDataModule over
    the rooms in ``rir_dir``: (x [n, C, T], ys [n, Spk, C, T], paras)."""
    data = dict(cfg["data"], init_args=dict(cfg["data"]["init_args"], rir_dir=rir_dir))
    xs, yss, paras = [], [], []
    for x, ys, p in instantiate(data).test_dataloader():
        xs.append(np.asarray(x))
        yss.append(np.asarray(ys))
        paras += p
        if len(paras) >= n:
            break
    return np.concatenate(xs)[:n], np.concatenate(yss)[:n], paras[:n]


def _render_test_rooms(rir_dir: str, n: int) -> None:
    """Rooms FIRST_TEST_ROOM ... + n - 1 into ``rir_dir``/test, and the
    diffuse-noise mixing matrices the data module would make from the first
    train room (train/0.npz), from that room's array alone."""
    from nbss_tpu.data.diffuse import spatial_coherence_mixing_matrices
    from nbss_tpu.sim.config import RirConfigSampler
    from nbss_tpu.sim.generate import render_room

    sampler = RirConfigSampler(**GOLDEN_SIM)
    for index in range(FIRST_TEST_ROOM, FIRST_TEST_ROOM + n):
        t1 = time.perf_counter()
        render_room(sampler.sample(index), sampler.fs, rir_dir, "test",
                    length_round=GOLDEN_LENGTH_ROUND)
        print(f"room {index} rendered in {time.perf_counter() - t1:.1f} s", flush=True)
    pos = sampler.sample(0)["pos_rcv"]
    _, Cs = spatial_coherence_mixing_matrices(pos_mics=np.asarray(pos, np.float64),
                                              fs=sampler.fs, noise_field="spherical", nfft=256)
    np.savez(os.path.join(rir_dir, "diffuse.npz"), Cs=Cs)


def _committed_mixture_db(x: np.ndarray, indices) -> np.ndarray:
    """SI-SDR of each regenerated mixture's reference channel against the
    committed test set's mixture.wav (NaN where the file is absent)."""
    from scipy.io import wavfile

    from nbss_tpu.ops.metrics import si_sdr

    out = []
    for b, index in enumerate(indices):
        wav = SPATIALNET_RUN / "epoch39_test_set" / "examples" / str(index) / "mixture.wav"
        if not wav.exists():
            out.append(np.nan)
            continue
        ref = wavfile.read(wav)[1].astype(np.float32)
        out.append(float(si_sdr(jnp.asarray(x[b, 0]), jnp.asarray(ref))))
    return np.asarray(out)


def golden(path: str) -> dict:
    t0 = time.perf_counter()
    cfg_s = load_configs([str(SPATIALNET_RUN / "config.yaml")])
    cfg_o = load_configs([str(ONLINE_RUN / "config.yaml")])
    with tempfile.TemporaryDirectory(prefix="nbss_golden_") as tmp:
        rir_dir = os.path.join(tmp, "rir8k")
        _render_test_rooms(rir_dir, GOLDEN_ITEMS)
        x, ys, paras = _test_items(cfg_s, rir_dir, GOLDEN_ITEMS)
    ref = cfg_s["model"].get("ref_channel", 0)
    yr = ys[:, :, ref]
    out = {"x": x.astype(np.float32), "yr": yr.astype(np.float32),
           "index": np.asarray([p["index"] for p in paras], np.int64),
           "seed": np.asarray([p["seed"] for p in paras], np.int64),
           "rir_file": np.asarray([os.path.join("test", os.path.basename(p["rir_file"]))
                                   for p in paras]),
           "RT60": np.asarray([p["RT60"] for p in paras], np.float64),
           "committed_mixture_si_sdr_db": _committed_mixture_db(x, [p["index"] for p in paras])}
    print(f"items {out['index']}: rooms {out['rir_file']}, seeds {out['seed']}, RT60 "
          f"{out['RT60']}; regenerated mixtures against the committed mixture.wav: "
          f"{out['committed_mixture_si_sdr_db']} dB", flush=True)
    for model, run, cfg in (("spatialnet", SPATIALNET_RUN, cfg_s),
                            ("online", ONLINE_RUN, cfg_o)):
        params = CheckpointManager(str(run / "checkpoints")).restore(GOLDEN_EPOCH)["params"]
        for prec, precision in PRECISIONS.items():
            module = build_module(dict(cfg, trainer=dict(cfg["trainer"], precision=precision)))
            paths = {"forward": module.forward}
            if model == "online":
                paths["streaming"] = module.forward_streaming
            for path_name, fn in paths.items():
                t1 = time.perf_counter()
                y = np.asarray(jax.jit(lambda p, v, f=fn: f(p, v)[0])(params, jnp.asarray(x)),
                               np.float32)
                key = f"{model}_{path_name}_{prec}"
                out[key] = y
                out[f"{key}_si_sdr"], out[f"{key}_si_sdri"] = _item_metrics(y, yr, x[:, ref])
                print(f"{key}: {y.shape}, SI-SDR {out[f'{key}_si_sdr']}, SI-SDRi "
                      f"{out[f'{key}_si_sdri']} ({time.perf_counter() - t1:.1f} s)", flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    out.update(commit=np.asarray(commit or "unknown"),
               command=np.asarray(" ".join(["python", *sys.argv])),
               jax_version=np.asarray(jax.__version__),
               seconds=np.asarray(time.perf_counter() - t0))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path} in {float(out['seconds']):.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", nargs="?", help="a JAX run directory (<root>/<Arch>/version_N)")
    p.add_argument("out", nargs="?", help="the port's run directory to write")
    p.add_argument("--epoch", type=int, default=None, help="the checkpoint (default: newest)")
    p.add_argument("--golden", default=None, metavar="NPZ",
                   help="write the JAX package's epoch-39 outputs on regenerated test items")
    args = p.parse_args(argv)
    if args.golden is None and (args.run is None or args.out is None):
        p.error("give RUN and OUT, or --golden NPZ")
    if args.run is not None:
        info = convert_run(args.run, args.out, args.epoch)
        print(f"{args.run} -> {args.out}: {info}", flush=True)
    if args.golden is not None:
        golden(args.golden)
    return 0


if __name__ == "__main__":
    sys.exit(main())
