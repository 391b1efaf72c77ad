"""The port's command line (nbss_tpu_torch.cli) on the CPU.

Modelled on tests/test_cli.py with ``--trainer.accelerator=cpu`` and tiny
widths, each command in a child process as ``python -m nbss_tpu_torch.cli``: ``fit`` twice gives version_0 and version_1 with config.yaml,
provenance.txt, model.txt, metrics.jsonl and checkpoints; ``test`` writes
results_*.json, results_mean.json, results_incremental.jsonl and example
WAVs; a resumed ``fit`` goes on in the checkpoint's version directory; then
``validate`` and ``predict``. The same chain runs once over a corpus rendered
by the port's generator through ``DeviceSyntheticDataModule`` with host
metrics on validation, and once over an SMS-WSJ-Plus fixture with
configs/datasets/sms_wsj_plus.yaml (``fit``, then ``test`` on whole
utterances). Every config in configs/ builds the port's model and every
dataset config the port's DataModule; the JAX package's and the reference's
class paths (the ``data_loaders.*`` aliases too) resolve to the port; the
port's YAML reader equals ``yaml.safe_load`` on every file under configs/ and
every config.yaml under logs/, and a config.yaml it writes reads back equal.
A missing card, an orbax checkpoint and a multi-node run without a
rendezvous raise; ``trainer.write_flops`` writes FLOPs.yaml.
"""

import ast
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from nbss_tpu_torch.cli import yamlio
from nbss_tpu_torch.cli.config import (_ALIASES, deep_merge, instantiate, load_configs,
                                       parse_argv, parse_value, port_class_path, resolve_class,
                                       save_config)
from nbss_tpu_torch.cli.main import build_module, run

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
YAMLS = sorted(str(p.relative_to(ROOT)) for p in
               list(CONFIGS.rglob("*.yaml")) + list((ROOT / "logs").rglob("config.yaml")))
TINY = ["--model.arch.init_args.num_layers", "1", "--model.arch.init_args.dim_hidden", "32",
        "--model.arch.init_args.dim_ffn", "64", "--model.arch.init_args.dim_squeeze", "4"]


def _base_args(tmp_path, extra=()):
    return [
        "--config", str(CONFIGS / "SpatialNet.yaml"),
        "--config", str(CONFIGS / "datasets" / "synthetic.yaml"),
        "--log_root", str(tmp_path / "logs"),
        "--trainer.accelerator", "cpu",
        "--trainer.max_epochs", "1",
        "--trainer.limit_train_batches", "2",
        "--trainer.precision", "32",
        *TINY,
        "--model.arch.init_args.num_freqs", "33",
        "--model.stft.init_args.n_fft", "64",
        "--model.stft.init_args.n_hop", "32",
        "--data.init_args.num_items", "8",
        "--data.init_args.num_channels", "2",
        "--data.init_args.audio_time_len", "0.5",
        "--model.channels", "[0, 1]",
        *extra,
    ]


def test_parse_argv_and_merge():
    sub, paths, ovr = parse_argv(["fit", "--config=a.yaml", "--config", "b.yaml",
                                  "--model.arch.init_args.num_layers=4",
                                  "--trainer.precision", "bf16-mixed", "--x=[1, {a: 2}]"])
    assert sub == "fit" and paths == ["a.yaml", "b.yaml"]
    assert ovr == {"model.arch.init_args.num_layers": 4, "trainer.precision": "bf16-mixed",
                   "x": [1, {"a": 2}]}
    assert parse_value("null") is None and parse_value("1e-3") == "1e-3"
    assert parse_value("[unclosed") == "[unclosed"
    assert deep_merge({"m": {"x": 1, "y": 2}, "k": 1}, {"m": {"y": 3}, "j": 4}) == \
        {"m": {"x": 1, "y": 3}, "k": 1, "j": 4}


def test_class_paths_resolve_to_the_port():
    from nbss_tpu_torch.data.device_mix import DeviceSyntheticDataModule
    from nbss_tpu_torch.io import Loss, STFT
    from nbss_tpu_torch.models import NBSS, OnlineSpatialNet, SpatialNet

    assert resolve_class("models.arch.SpatialNet.SpatialNet") is SpatialNet
    assert resolve_class("models.arch.OnlineSpatialNet.OnlineSpatialNet") is OnlineSpatialNet
    assert resolve_class("models.arch.NBSS.NBSS") is NBSS
    assert resolve_class("nbss_tpu.io.STFT") is STFT
    assert resolve_class("nbss_tpu.data.device_mix.DeviceSyntheticDataModule") is \
        DeviceSyntheticDataModule
    assert port_class_path("models.io.norm.Norm") == "nbss_tpu_torch.io.Norm"
    loss = instantiate({"class_path": "models.io.loss.Loss",
                        "init_args": {"loss_func": "models.io.loss.neg_si_sdr", "pit": True}})
    assert isinstance(loss, Loss) and loss.name == "neg_si_sdr" and loss.pit
    with pytest.raises(NotImplementedError, match="not ported"):
        resolve_class("nbss_tpu.data.no_such_corpus.NoSuchDataModule")


@pytest.mark.parametrize("alias", sorted(a for a in _ALIASES if a.startswith("data_loaders.")))
def test_reference_data_aliases_are_the_port_classes(alias):
    import importlib

    module, name = _ALIASES[alias].replace("nbss_tpu.", "nbss_tpu_torch.", 1).rsplit(".", 1)
    assert resolve_class(alias) is getattr(importlib.import_module(module), name)
    assert resolve_class(_ALIASES[alias]) is resolve_class(alias)
    if alias.endswith("Spk4Wsj0mixSp"):
        assert resolve_class(alias).__name__ == "Spk4Wsj0MixSpDataModule"


@pytest.mark.parametrize("path", sorted(p.name for p in (CONFIGS / "datasets").glob("*.yaml")))
def test_every_dataset_config_builds_the_port_datamodule(path):
    from nbss_tpu_torch.data.loader import DataModule

    node = load_configs([str(CONFIGS / "datasets" / path)])["data"]
    dm = instantiate(node, device="cpu")
    assert isinstance(dm, DataModule) and type(dm).__module__.startswith("nbss_tpu_torch.data.")
    assert type(dm).__name__ == node["class_path"].rsplit(".", 1)[1]


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_reader_is_safe_load(path, tmp_path):
    want = yaml.safe_load(open(ROOT / path))
    assert yamlio.load(str(ROOT / path)) == want
    save_config(want, str(tmp_path / "config.yaml"))  # the port's writer reads back equal
    assert yamlio.load(str(tmp_path / "config.yaml")) == want
    assert yaml.safe_load(open(tmp_path / "config.yaml")) == want


def test_yaml_writer_quotes_what_would_read_back_otherwise(tmp_path):
    cfg = {"a": ["yes", "1e-3", "0x10", "null", "", "x: y", "#c", "-", 1e-05, 1e20, 2.0, True,
                 None, [1, [2, 3]], {"k": [1]}], "b": {}, "c": [], "d": (1, 2),
           "e": {"f": {"g": "it's"}}, "f": [{"a": 1, "b": [1, 2]}, ["x", {"y": 2}]]}
    text = yamlio.dumps(cfg)
    want = {**cfg, "d": [1, 2]}
    assert yamlio.loads(text) == want and yaml.safe_load(text) == want


@pytest.mark.parametrize("name", ["SpatialNet", "onlineSpatialNet", "NBC", "NBC2", "NB-BLSTM"])
def test_every_config_builds_the_port_model(name):
    cfg = load_configs([str(CONFIGS / f"{name}.yaml")])
    module = build_module(cfg, device="cpu")
    arch_cls = cfg["model"]["arch"]["class_path"].rsplit(".", 1)[1]
    assert type(module.arch).__name__ == arch_cls
    assert type(module.arch).__module__.startswith("nbss_tpu_torch.models")
    p = next(module.arch.parameters())
    assert p.device.type == "cpu"
    assert module.loss.name == cfg["model"]["loss"]["init_args"]["name"]
    assert module.stft.n_fft == cfg["model"]["stft"]["init_args"]["n_fft"]
    bf16 = "bf16" in str(cfg.get("trainer", {}).get("precision", "32"))
    assert module.arch.dtype == (torch.bfloat16 if bf16 else None)


def _command(module: str, *argv) -> dict:
    """``python -m <module> argv...`` in a child process with one OpenMP
    thread (the suite's pytest workers share the cores); returns the dict
    that the CLI prints last, {} for the generator."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", module, *map(str, argv)], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ast.literal_eval(proc.stdout.strip().splitlines()[-1]) if module.endswith("cli") else {}


def test_fit_test_resume_validate_predict(tmp_path):
    out = _command("nbss_tpu_torch.cli", "fit", *_base_args(tmp_path))
    log_dir = out["log_dir"]
    assert "version_0" in log_dir and np.isfinite(out["train_loss"])
    for f in ("config.yaml", "provenance.txt", "model.txt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(log_dir, f)), f
    assert glob.glob(os.path.join(log_dir, "checkpoints", "epoch0", "params"))
    saved = yamlio.load(os.path.join(log_dir, "config.yaml"))
    assert saved["trainer"]["accelerator"] == "cpu" and saved["model"]["channels"] == [0, 1]

    assert "version_1" in _command("nbss_tpu_torch.cli", "fit", *_base_args(tmp_path))["log_dir"]

    ckpt = os.path.join(log_dir, "checkpoints", "epoch0")
    res = _command("nbss_tpu_torch.cli", "test", *_base_args(
        tmp_path, ("--ckpt_path", ckpt, "--model.metrics", "[SI_SDR, SDR]",
                   "--model.write_examples", "1")))
    assert res["log_dir"].endswith("epoch0_test_set")
    assert res["num_items"] > 0 and np.isfinite(res["SI_SDR"]) and "SI_SDR_i" in res
    results = [p for p in glob.glob(os.path.join(res["log_dir"], "results_*.json"))
               if not p.endswith("results_mean.json")]
    items = json.load(open(results[0]))
    assert {"wavname", "SI_SDR", "input_SI_SDR", "SDR"} <= set(items[0])
    inc = [json.loads(l) for l in open(os.path.join(res["log_dir"],
                                                     "results_incremental.jsonl"))]
    assert len(inc) == res["num_items"]
    mean = json.load(open(os.path.join(res["log_dir"], "results_mean.json")))
    assert "partial" not in mean and mean["SI_SDR"] == pytest.approx(res["SI_SDR"])
    assert glob.glob(os.path.join(res["log_dir"], "examples", "*", "prediction_0.wav"))

    args3 = _base_args(tmp_path, ("--ckpt_path", ckpt))
    args3[args3.index("--trainer.max_epochs") + 1] = "2"
    out3 = _command("nbss_tpu_torch.cli", "fit", *args3)
    assert os.path.abspath(out3["log_dir"]) == os.path.abspath(log_dir)
    assert os.path.isdir(os.path.join(log_dir, "checkpoints", "epoch1"))

    val = _command("nbss_tpu_torch.cli", "validate", *_base_args(tmp_path, ("--ckpt_path", ckpt)))
    assert np.isfinite(val["val/metric"])
    pres = _command("nbss_tpu_torch.cli", "predict", *_base_args(tmp_path, ("--ckpt_path", ckpt)))
    assert glob.glob(os.path.join(pres["log_dir"], "examples", "*.wav"))


def test_fit_over_a_rendered_corpus_with_host_metrics(tmp_path):
    corpus = tmp_path / "rirs"
    _command("nbss_tpu_torch.sim.generate", f"--rir_dir={corpus}", "--spk_num=2",
             "--noise_num=0", "--rir_nums", 2, 1, 1, "--RT60_lim", 0.1, 0.12, "--mic_num=4",
             "--arr_geometry=circular", "--seed=1", "--device", "cpu")
    assert sorted(p.parent.name for p in corpus.rglob("*.npz")) == \
        ["test", "train", "train", "validation"]
    args = ["--config", str(CONFIGS / "SpatialNet.yaml"),
            "--config", str(CONFIGS / "datasets" / "device_synth.yaml"),
            "--log_root", str(tmp_path / "logs"), "--trainer.accelerator=cpu",
            "--trainer.max_epochs=1", "--trainer.precision=32", *TINY,
            "--model.channels=[0, 1, 2, 3]", f"--data.init_args.rir_dir={corpus}",
            "--data.init_args.num_items=[4,2,2,2]", "--data.init_args.rir_len=2048",
            "--data.init_args.audio_time_len=[1.0,1.0,1.0,1.0]",
            "--data.init_args.batch_size=[2,2]", "--model.val_host_metrics=[STOI, eSTOI]",
            "--model.val_host_metrics_every=1"]
    out = _command("nbss_tpu_torch.cli", "fit", *args)
    assert np.isfinite(out["train_loss"]) and 0.0 < out["val/STOI"] <= 1.0
    keys = {json.loads(l)["key"] for l in open(os.path.join(out["log_dir"], "metrics.jsonl"))}
    assert {"val/STOI", "val/eSTOI", "train/neg_si_sdr", "lr"} <= keys
    assert os.path.basename(_command("nbss_tpu_torch.cli", "fit", *args)["log_dir"]) == \
        "version_1"


def test_fit_and_test_over_an_sms_wsj_plus_corpus(tmp_path):
    """The README's ``fit --config=configs/SpatialNet.yaml
    --config=configs/datasets/sms_wsj_plus.yaml`` at a narrow width over a
    fixture corpus in SMS-WSJ-Plus's layout, items made by worker threads;
    then ``test`` on whole utterances at batch 1."""
    from nbss_tpu_torch.utils.audio_io import write_audio

    rng = np.random.default_rng(0)
    wsj = tmp_path / "sms_wsj"
    (wsj / "wsj_8k_zeromean").mkdir(parents=True)
    info = {"datasets": {d: {} for d in ("train_si284", "cv_dev93", "test_eval92")}}
    for d in info["datasets"]:
        for k in range(4):
            srcs = []
            for s in range(2):
                name = f"wsj_8k_zeromean/{d}_{k}_{s}.wav"
                wav = rng.standard_normal(8000 + 2000 * (k + s)).astype(np.float32) * 0.1
                write_audio(str(wsj / name), wav, 8000)
                srcs.append(f"/corpora/sms_wsj/{name}")
            info["datasets"][d][f"{d}_{k}"] = {"audio_path": {"original_source": srcs}}
    (wsj / "sms_wsj.json").write_text(json.dumps(info))
    rirs = tmp_path / "rirs"
    for sub in ("train", "validation", "test"):
        (rirs / sub).mkdir(parents=True)
        rir = (rng.standard_normal((2, 6, 600)) * 0.02).astype(np.float32)
        rir[:, :, 30] = 1.0
        dp = np.zeros_like(rir)
        dp[:, :, 30] = 1.0
        pos_rcv = np.stack([np.cos(np.arange(6)), np.sin(np.arange(6)), np.zeros(6)], -1) * 0.05
        np.savez(rirs / sub / "0.npz", fs=8000, RT60=0.2, rir=rir, rir_dp=dp,
                 pos_src=np.ones((2, 3)), pos_rcv=pos_rcv)
    args = ["--config", str(CONFIGS / "SpatialNet.yaml"),
            "--config", str(CONFIGS / "datasets" / "sms_wsj_plus.yaml"),
            "--log_root", str(tmp_path / "logs"), "--trainer.accelerator=cpu",
            "--trainer.max_epochs=1", "--trainer.limit_train_batches=2",
            "--trainer.limit_val_batches=1", "--trainer.precision=32", *TINY,
            f"--data.init_args.sms_wsj_dir={wsj}", f"--data.init_args.rir_dir={rirs}",
            "--data.init_args.audio_time_len=[1.0, 1.0, null, null]"]
    out = _command("nbss_tpu_torch.cli", "fit", *args)
    assert np.isfinite(out["train_loss"]) and np.isfinite(out["val/metric"])
    assert (rirs / "diffuse.npz").exists()
    saved = yamlio.load(os.path.join(out["log_dir"], "config.yaml"))
    assert saved["data"]["init_args"]["sms_wsj_dir"] == str(wsj)
    ckpt = os.path.join(out["log_dir"], "checkpoints", "epoch0")
    res = _command("nbss_tpu_torch.cli", "test", *args, "--ckpt_path", ckpt,
                   "--trainer.limit_test_batches=2", "--model.metrics=[SI_SDR]",
                   "--model.write_examples=0")
    assert res["num_items"] == 2 and np.isfinite(res["SI_SDR"])


def test_unported_paths_raise(tmp_path, monkeypatch):
    """A missing card, an orbax checkpoint and ``trainer.num_nodes=2`` without
    a rendezvous raise before anything is written; ``trainer.write_flops``
    writes FLOPs.yaml."""
    for k in ("NBSS_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if not torch.cuda.is_available():
        args = _base_args(tmp_path)
        args[args.index("--trainer.accelerator") + 1] = "gpu"
        with pytest.raises(RuntimeError, match="CUDA"):
            run(["fit", *args])
    orbax = ROOT / "logs" / "SpatialNet" / "version_0" / "checkpoints" / "epoch39"
    with pytest.raises(ValueError, match="convert.py"):
        run(["test", *_base_args(tmp_path, ("--ckpt_path", str(orbax)))])
    with pytest.raises(ValueError, match="NBSS_COORDINATOR"):
        run(["fit", *_base_args(tmp_path, ("--trainer.num_nodes", "2"))])
    assert not (tmp_path / "logs").exists()  # nothing written before the errors
    out = run(["fit", *_base_args(tmp_path, ("--trainer.write_flops", "true"))])
    flops = yamlio.load(os.path.join(out["log_dir"], "FLOPs.yaml"))
    assert flops["flops_forward"] > 0 and flops["params"] > 0 and flops["flops_backward"] > 0


def test_trainer_profiles_steps_and_takes_host_metrics(tmp_path):
    """``profile_dir`` writes a torch.profiler trace of ``profile_steps``;
    ``val_host_metrics`` adds val/STOI to the epoch's logs."""
    from nbss_tpu_torch.data.synthetic import SyntheticDataModule
    from nbss_tpu_torch.train.loop import Trainer

    cfg = load_configs([str(CONFIGS / "SpatialNet.yaml")], {
        "model.arch.init_args.num_layers": 1, "model.arch.init_args.dim_hidden": 16,
        "model.arch.init_args.dim_ffn": 32, "model.arch.init_args.dim_squeeze": 4,
        "model.arch.init_args.num_freqs": 33, "model.stft.init_args.n_fft": 64,
        "model.stft.init_args.n_hop": 32, "model.channels": [0, 1], "trainer.precision": "32"})
    data = SyntheticDataModule(num_items=4, num_channels=2, audio_time_len=0.5, batch_size=(2, 2))
    trainer = Trainer(build_module(cfg, device="cpu"), device="cpu", val_host_metrics=["STOI"],
                      val_host_metrics_every=1, profile_dir=str(tmp_path / "prof"),
                      profile_steps=(0, 1))
    history = trainer.fit(lambda: data.train_dataloader(trainer.epoch), data.val_dataloader)
    assert 0.0 <= history["val/STOI"] <= 1.0
    assert (tmp_path / "prof" / "trace_epoch0.json").stat().st_size > 0
