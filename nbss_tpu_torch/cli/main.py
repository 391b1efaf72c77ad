"""`python -m nbss_tpu_torch.cli {fit,validate,test,predict}`: the training CLI.

Counterpart of ``nbss_tpu/cli/main.py``, with the same command surface:

    python -m nbss_tpu_torch.cli fit --config=configs/SpatialNet.yaml \\
        --config=configs/datasets/device_synth.yaml \\
        --model.arch.init_args.num_layers=8 --trainer.max_epochs=100

- version directories logs/{ArchName}/version_{N} hold the resolved
  config.yaml, provenance.txt, model.txt, checkpoints/ (every epoch, with
  metric metadata) and metrics.jsonl (and TensorBoard events with
  tensorboardX); a resumed ``fit`` (``--ckpt_path``) goes back into the
  checkpoint's own version directory, and ``test``/``predict`` write to
  ``{epoch}_{test_set}_set`` beside it;
- ``trainer.precision`` '32' or 'bf16-mixed' selects the network's compute
  dtype (STFT, norm and loss stay float32);
- ``trainer.limit_train_batches``, ``limit_val_batches`` and
  ``limit_test_batches`` cap the batches a stage takes (Lightning's names;
  all of them when unset);
- everything runs on CUDA cards unless ``--trainer.accelerator=cpu``:
  ``trainer.devices`` of them (every visible card by default), capped, as
  the JAX package caps its mesh, so that the train batch divides the count.
  With more than one, ``run`` starts one rank per card (NCCL; gloo ranks on
  the CPU) and the batch is split over them (``nbss_tpu_torch.parallel``);
- several hosts: one launcher process a host with ``NBSS_COORDINATOR=host:port``,
  ``NBSS_NUM_PROCESSES`` and ``NBSS_PROCESS_ID``, each starting its local
  ranks; or ``trainer.num_nodes > 1`` under ``torchrun`` (this process is one
  rank). ``data.init_args.batch_size[0]`` is then each host's batch;
- ``trainer.write_flops`` writes FLOPs.yaml (``utils/flops.py``);
- only rank 0 writes config.yaml, provenance.txt, model.txt, FLOPs.yaml,
  metrics.jsonl, events and checkpoints; every rank restores.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import torch

from nbss_tpu_torch import parallel
from nbss_tpu_torch.cli.config import instantiate, load_configs, parse_argv, save_config
from nbss_tpu_torch.train.loop import Trainer, take
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.device import resolve
from nbss_tpu_torch.utils.logging import log_provenance, rank_zero_logger, write_model_summary


def _next_version(root: str) -> int:
    if not os.path.isdir(root):
        return 0
    versions = [int(d.split("_")[1]) for d in os.listdir(root)
                if d.startswith("version_") and d.split("_")[1].isdigit()]
    return max(versions) + 1 if versions else 0


def _on_cuda(cfg: Dict) -> bool:
    """trainer.accelerator 'cpu' -> the CPU; anything else -> CUDA cards."""
    return str((cfg.get("trainer", {}) or {}).get("accelerator", "cuda")).lower() != "cpu"


def _train_batch(cfg: Dict) -> int:
    bs = ((cfg.get("data") or {}).get("init_args") or {}).get("batch_size", (1,))
    return int(bs[0] if isinstance(bs, (list, tuple)) else bs)


def local_ranks(cfg: Dict, cards: Optional[int]) -> int:
    """Ranks this host trains on: ``trainer.devices``, or every one of the
    ``cards`` (None on the CPU: one), at most ``cards``, and lowered until the
    train batch divides it, as ``nbss_tpu.cli.main._mesh_for`` sizes its mesh."""
    devices = (cfg.get("trainer", {}) or {}).get("devices")
    n = int(devices) if devices not in (None, "auto", -1) else (cards or 1)
    if cards is not None:
        n = min(n, cards)
    train_bs = _train_batch(cfg)
    while n > 1 and train_bs % n != 0:
        n -= 1
    return max(n, 1)


def build_module(cfg: Dict, device="cuda") -> TrainModule:
    m = cfg.get("model", {})
    channels = tuple(m.get("channels", (0, 1, 2, 3, 4, 5)))
    arch_node = dict(m["arch"])
    init_args = dict(arch_node.get("init_args") or {})
    # precision policy: bf16-mixed puts the network in bf16 (fp32 islands stay)
    precision = str(cfg.get("trainer", {}).get("precision", "32"))
    if "bf16" in precision and init_args.get("dtype") is None:
        init_args["dtype"] = torch.bfloat16
    arch_node["init_args"] = init_args
    arch = instantiate(arch_node, dim_input=2 * len(channels), dim_output=2 * _num_spk(cfg),
                       device=device)
    stft = instantiate(m.get("stft", {"class_path": "nbss_tpu_torch.io.STFT"}))
    norm = instantiate(m.get("norm", {"class_path": "nbss_tpu_torch.io.Norm"}))
    loss = instantiate(m.get("loss", {"class_path": "nbss_tpu_torch.io.Loss"}))
    return TrainModule(arch=arch, channels=channels, ref_channel=m.get("ref_channel", 0),
                       stft=stft, norm=norm, loss=loss, val_metric=m.get("val_metric", "loss"))


def _num_spk(cfg: Dict) -> int:
    data_args = (cfg.get("data") or {}).get("init_args") or {}
    for key in ("num_spk", "num_speakers", "n_speaker"):
        if key in data_args:
            return int(data_args[key])
    return 2


def build_trainer(cfg: Dict, module: TrainModule, logger, log_dir: str, device) -> Trainer:
    from nbss_tpu_torch.eval.metrics import HOST_METRICS

    m = cfg.get("model", {})
    t = cfg.get("trainer", {})
    optimizer = m.get("optimizer", ("Adam", {"lr": 1e-3}))
    lr_scheduler = m.get("lr_scheduler", ("ExponentialLR", {"gamma": 0.99}))
    es = cfg.get("early_stopping") or {}
    early_stopping = None
    if es.get("enable"):
        early_stopping = {"monitor": es.get("monitor", "val/metric"),
                          "patience": es.get("patience", 10),
                          "mode": es.get("mode", "max"),
                          "min_delta": es.get("min_delta", 0.1)}
    # host metrics every N epochs over the validation set: by default the
    # host-side subset of model.metrics
    vhm = m.get("val_host_metrics")
    if vhm is None:
        vhm = [x for x in m.get("metrics", []) if x in HOST_METRICS]
    return Trainer(
        module,
        optimizer=(optimizer[0], dict(optimizer[1])),
        lr_scheduler=(lr_scheduler[0], dict(lr_scheduler[1])) if lr_scheduler else None,
        gradient_clip_val=t.get("gradient_clip_val", 5.0),
        seed=cfg.get("seed_everything", 2),
        ckpt_dir=os.path.join(log_dir, "checkpoints"),
        logger=logger,
        early_stopping=early_stopping,
        val_host_metrics=vhm or None,
        val_host_metrics_every=m.get("val_host_metrics_every", 5),
        val_host_metrics_batches=m.get("val_host_metrics_batches"),
        profile_dir=t.get("profile_dir"),
        device=device,
    )


# the JAX package's committed epoch-39 runs and their converted copies in the port's layout
CONVERTED_RUNS = {f"logs/{arch}/version_0/checkpoints/epoch39":
                  f"checkpoints_torch/{arch}/version_0"
                  for arch in ("SpatialNet", "OnlineSpatialNet")}


def _checkpoint_dirs(ckpt_path: str):
    """(version dir, checkpoints dir, epoch or None) of a checkpoint the port
    wrote; an orbax checkpoint of the JAX package raises, naming the
    converted copy where the repository holds one."""
    ckpt_path = os.path.abspath(ckpt_path)
    if os.path.isdir(os.path.join(ckpt_path, "params")):
        converted = [v for k, v in CONVERTED_RUNS.items()
                     if ckpt_path.replace(os.sep, "/").endswith("/" + k)]
        hint = (f"; its converted copy is {converted[0]}: --config={converted[0]}/config.yaml "
                f"--ckpt_path={converted[0]}/checkpoints/epoch39" if converted else "")
        raise ValueError(
            f"{ckpt_path} is an orbax checkpoint of the JAX package, which the port cannot "
            "read; convert its run with scripts/convert_jax_checkpoint.py (the functions of "
            "nbss_tpu_torch/utils/convert.py, on a machine with JAX and orbax) into the "
            f"port's checkpoint layout{hint}")
    base = os.path.basename(ckpt_path)
    epoch = None
    if base.startswith("epoch"):
        epoch = int(base.replace("epoch", "").split("_")[0].split(".")[0])
    ckpt_dir = os.path.dirname(ckpt_path)
    return os.path.dirname(ckpt_dir), ckpt_dir, epoch


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run a subcommand; returns (local) rank 0's results. The decision to
    start ranks is taken from the config and the environment before any
    device is touched."""
    sub, paths, overrides = parse_argv(argv if argv is not None else sys.argv[1:])
    if sub not in ("fit", "validate", "test", "predict"):
        raise ValueError(f"unknown subcommand {sub!r} (fit/validate/test/predict)")
    cfg = load_configs(paths, overrides)
    cuda = _on_cuda(cfg)
    rdv = parallel.rendezvous(int((cfg.get("trainer", {}) or {}).get("num_nodes") or 1))
    if cuda:
        resolve("cuda")  # no card: raise before anything is written
    if cfg.get("ckpt_path") is not None:
        _checkpoint_dirs(cfg["ckpt_path"])  # an orbax checkpoint raises here
    backend = "nccl" if cuda else "gloo"  # no silent switch: a failed NCCL init fails
    if rdv is not None and rdv.torchrun:
        parallel.init_from_env(backend, "cuda" if cuda else "cpu")
        try:
            return run_rank(sub, cfg)
        finally:
            parallel.shutdown()
    n = local_ranks(cfg, torch.cuda.device_count() if cuda else None)
    if n == 1 and rdv is None:
        return run_rank(sub, cfg)
    devices = [f"cuda:{i}" for i in range(n)] if cuda else None
    # CPU ranks (tests, debugging) take one thread each, so that they do not crowd the cores
    return parallel.launch(run_rank, (sub, cfg), n, backend, devices, rdv,
                           threads=None if cuda else 1)[0]


def run_rank(sub: str, cfg: Dict) -> Dict[str, Any]:
    """One rank of ``run`` (the only one on one card): its device is the
    current card, or the CPU."""
    mesh = parallel.current_mesh()
    device = (resolve(f"cuda:{torch.cuda.current_device()}") if _on_cuda(cfg)
              else torch.device("cpu"))
    ckpt_path = cfg.get("ckpt_path")
    ckpt = _checkpoint_dirs(ckpt_path) if ckpt_path is not None else None

    data_module = instantiate(cfg["data"], device=str(device))
    module = build_module(cfg, device)
    arch_name = type(module.arch).__name__

    log_dir = None
    if mesh.is_main:  # rank 0 picks the version directory; every rank uses it
        if ckpt is not None and sub == "fit":
            log_dir = ckpt[0]  # a resumed fit goes on in the checkpoint's version dir
        elif ckpt is None:
            root = os.path.join(cfg.get("log_root", "logs"), arch_name)
            log_dir = os.path.join(root, f"version_{_next_version(root)}")
        else:
            epoch_tag = os.path.splitext(os.path.basename(os.path.abspath(ckpt_path)))[0]
            test_set = (cfg.get("data", {}).get("init_args", {}) or {}).get("test_set", "test")
            log_dir = os.path.join(ckpt[0], f"{epoch_tag}_{test_set}_set")
        os.makedirs(log_dir, exist_ok=True)
        save_config(cfg, os.path.join(log_dir, "config.yaml"))
        log_provenance(log_dir)
    log_dir = mesh.broadcast_object(log_dir)

    logger = rank_zero_logger(log_dir, mesh)
    try:
        trainer = build_trainer(cfg, module, logger, log_dir, device)
        trainer.init()
        if mesh.is_main:
            write_model_summary(log_dir, module)
        if (cfg.get("trainer", {}) or {}).get("write_flops"):
            _write_flops(log_dir, module, data_module, mesh)
        if ckpt is not None:
            trainer.ckpt.ckpt_dir = ckpt[1]
            trainer.restore(epoch=ckpt[2], reset=cfg.get("model", {}).get("reset"),
                            ensemble=cfg.get("model", {}).get("ensemble"))
        return _run_stage(sub, cfg, trainer, module, data_module, log_dir)
    finally:
        if logger is not None:
            logger.close()


def _write_flops(log_dir: str, module: TrainModule, data_module, mesh) -> None:
    """FLOPs.yaml of one item of the first train batch (every rank draws the
    batch, as its loader may broadcast a seed; rank 0 counts and writes)."""
    from nbss_tpu_torch.utils.flops import write_flops

    for x, *_ in take(data_module.train_dataloader(0), 1):
        if mesh.is_main:
            x0 = torch.as_tensor(x[:1])
            fs = getattr(data_module, "sample_rate", 8000)
            write_flops(log_dir, module, x0, audio_seconds=x0.shape[-1] / fs)


def _run_stage(sub, cfg, trainer, module, data_module, log_dir) -> Dict[str, Any]:
    t = cfg.get("trainer", {})
    m = cfg.get("model", {}) or {}
    if sub == "fit":
        history = trainer.fit(
            lambda: iter(data_module.train_dataloader(trainer.epoch)),
            lambda: iter(data_module.val_dataloader()),
            max_epochs=t.get("max_epochs", 1),
            steps_per_epoch=t.get("limit_train_batches"),
            val_batches=t.get("limit_val_batches"),
        )
        return {"log_dir": log_dir, **history}
    if sub == "validate":
        return {"log_dir": log_dir, **trainer.validate(lambda: iter(data_module.val_dataloader()),
                                                       t.get("limit_val_batches"))}
    if sub == "test":
        from nbss_tpu_torch.eval.runner import run_test

        metrics = m.get("metrics", ["SDR", "SI_SDR", "NB_PESQ", "WB_PESQ", "eSTOI"])
        batches = take(data_module.test_dataloader(), t.get("limit_test_batches"))
        results = run_test(trainer, module, batches, log_dir,
                           metrics=metrics, write_examples=m.get("write_examples", 200),
                           mchunk=m.get("mchunk"))
        return {"log_dir": log_dir, **results}
    from nbss_tpu_torch.eval.runner import run_predict

    run_predict(trainer, module, data_module.predict_dataloader(), log_dir)
    return {"log_dir": log_dir}


def main():  # console entry
    out = run()
    parallel.mesh.stop_fork_server()
    print({k: v for k, v in out.items() if not isinstance(v, (list, dict))})
