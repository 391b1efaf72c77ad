"""Fit / validate loop, on one CUDA card or data-parallel over several.

Counterpart of ``nbss_tpu/train/loop.py``: a train step is
forward + uPIT loss + backward + the clipped optimizer step; the learning
rate is scheduled per epoch on the host (ExponentialLR or ReduceLROnPlateau
on the validation metric); every epoch is checkpointed; early stopping
watches the validation metric; host metrics (PESQ, STOI) are taken on the
validation set every few epochs; a profiler trace of a few steps can be
written; and each epoch ends with a summary line. Parameters are drawn from
a ``torch.Generator`` seeded with ``seed``.

Data parallelism (``mesh``, a ``parallel.Mesh`` of several ranks, one process
per card), as the JAX ``Trainer`` takes ``mesh=``: each rank takes its rows
of the global batch (a ``parallel.Shard`` from the data modules, or its rows
of a host batch it is given); the train step runs the arch wrapped in
``DistributedDataParallel``, whose all-reduce averages the ranks' gradients
of their equal-sized batch means, so that the optimizer clips by global norm
and steps on the gradient of the global batch's mean loss, as the JAX step
does, in float32 (the parameters' dtype) and identically on every rank. The
logged train loss and the validation sums are reduced over the ranks, so
every rank takes the same learning-rate and early-stopping decisions; only
rank 0 logs, prints and writes checkpoints. ``arch`` and ``state_dict()``
stay the unwrapped module's, so a checkpoint from several cards loads on one.
Dropout masks are drawn per rank, from a global generator seeded with
(``seed``, rank).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from nbss_tpu_torch.models.base import init_parameters
from nbss_tpu_torch.parallel.mesh import Mesh, current_mesh, replicate, shard_batch
from nbss_tpu_torch.train.ckpt import CheckpointManager
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.train.optim import LRSchedule, Optimizer
from nbss_tpu_torch.utils.device import resolve


def take(batches: Iterable, n: Optional[int] = None) -> Iterator:
    """The first ``n`` batches (all when n is None). The source's iterator
    is closed after them, which stops a prefetching loader's threads."""
    it = iter(batches)
    try:
        yield from (it if n is None else itertools.islice(it, n))
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class Trainer:
    def __init__(
        self,
        module: TrainModule,
        optimizer: Tuple[str, Dict[str, Any]] = ("Adam", {"lr": 1e-3}),
        lr_scheduler: Optional[Tuple[str, Dict[str, Any]]] = ("ExponentialLR", {"gamma": 0.99}),
        gradient_clip_val: Optional[float] = 5.0,
        seed: int = 2,
        ckpt_dir: Optional[str] = None,
        logger: Optional[Callable[[str, float, int], None]] = None,
        val_metric_mode: str = "max",
        early_stopping: Optional[Dict[str, Any]] = None,
        detect_unused_parameters: bool = False,
        val_host_metrics: Optional[Sequence[str]] = None,
        val_host_metrics_every: int = 5,
        val_host_metrics_batches: Optional[int] = None,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        """early_stopping: e.g. {'monitor': 'val/metric', 'patience': 10,
        'mode': 'max', 'min_delta': 0.1}; disabled when None.

        val_host_metrics: e.g. ('NB_PESQ', 'STOI'), host metrics taken every
        ``val_host_metrics_every`` epochs over the validation set (at most
        ``val_host_metrics_batches`` batches when set). profile_dir: a
        ``torch.profiler`` trace of train steps [a, b) = ``profile_steps`` of
        the first epoch is written there as Chrome trace JSON.

        mesh: the data-parallel ranks (default ``parallel.current_mesh()``,
        one rank outside a group)."""
        self.mesh = mesh or current_mesh()
        self._step_module: Optional[TrainModule] = None
        self.module = module
        self.optimizer_spec = optimizer
        self.gradient_clip_val = gradient_clip_val
        self.lr_schedule = LRSchedule(lr_scheduler[0] if lr_scheduler else None,
                                      optimizer[1].get("lr", 1e-3),
                                      lr_scheduler[1] if lr_scheduler else {})
        self.seed = seed
        self.ckpt = CheckpointManager(ckpt_dir, self.mesh) if ckpt_dir else None
        self.logger = (logger if logger and self.mesh.is_main
                       else (lambda k, v, step: None))
        self.val_metric_mode = val_metric_mode
        self.early_stopping = early_stopping
        self.detect_unused_parameters = detect_unused_parameters
        self.val_host_metrics = tuple(val_host_metrics) if val_host_metrics else None
        self.val_host_metrics_every = val_host_metrics_every
        self.val_host_metrics_batches = val_host_metrics_batches
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self._profiler = None
        self.device = resolve(device)
        self.epoch = 0
        self.opt: Optional[Optimizer] = None
        self._es_best: Optional[float] = None
        self._es_bad = 0

    @property
    def arch(self) -> torch.nn.Module:
        return self.module.arch

    def init(self) -> torch.nn.Module:
        """Draw the arch's parameters from a generator seeded with ``seed``,
        move it to the device and build the optimizer. On several ranks, rank
        0's parameters are broadcast to the others (they draw the same ones)
        and the global generator that draws dropout masks is seeded with
        (seed, rank)."""
        init_parameters(self.arch, torch.Generator().manual_seed(self.seed))
        self.arch.to(self.device)
        if self.mesh.size > 1:
            replicate(self.mesh, self.arch)
            torch.manual_seed(1_000_003 * self.seed + self.mesh.rank)
        self._build_optimizer()
        return self.arch

    def _build_optimizer(self) -> None:
        name, kwargs = self.optimizer_spec
        self.opt = Optimizer(self.arch.parameters(), name, kwargs, self.gradient_clip_val)
        self.opt.lr = self.lr_schedule.lr

    def restore(self, epoch: Optional[int] = None, reset: Optional[Sequence[str]] = None,
                ensemble: Optional[Any] = None) -> None:
        """Load a checkpoint (or the ensemble average of several) into the
        arch; with a checkpoint, also the optimizer state unless ``reset``
        names it, and continue from the epoch after it."""
        if self.ckpt is None:
            raise ValueError("restore needs a ckpt_dir")
        if self.opt is None:
            self.arch.to(self.device)
            self._build_optimizer()
        if ensemble is not None:
            self.arch.load_state_dict(self.ckpt.ensemble(ensemble)["params"])
            return
        restored = self.ckpt.restore(epoch, reset=reset)
        self.arch.load_state_dict(restored["params"])
        if "opt_state" in restored:
            self.opt.load_state_dict(restored["opt_state"])
        self.epoch = restored["epoch"] + 1

    def to_device(self, batch):
        """(x, ys, ...) as numpy arrays or tensors -> (x, ys) on the device."""
        return tuple(torch.as_tensor(b, device=self.device) for b in batch[:2])

    def _train_module(self) -> TrainModule:
        """The module the train step runs: on several ranks a copy whose arch
        is wrapped in ``DistributedDataParallel`` (made at the first step)."""
        if self.mesh.size == 1:
            return self.module
        if self._step_module is None:
            from torch.nn.parallel import DistributedDataParallel

            # every arch of configs/ gives each parameter a gradient each step
            # (tests/test_torch_parallel.py), so DDP need not search the graph
            # for unused ones; and they hold no buffers to broadcast
            ddp = DistributedDataParallel(
                self.arch, device_ids=[self.device] if self.device.type == "cuda" else None)
            self._step_module = dataclasses.replace(self.module, arch=ddp)
        return self._step_module

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on (x, ys): this rank's rows of the batch (see
        ``parallel.shard_batch``). Returns this rank's loss (on the device);
        on several ranks the gradient the optimizer takes is the global
        batch's."""
        self.arch.train()
        self.opt.zero_grad()
        loss = self._train_module().training_step(self.to_device(shard_batch(self.mesh, batch)))
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit(self, train_data: Iterable, val_data: Optional[Iterable] = None,
            max_epochs: int = 1, steps_per_epoch: Optional[int] = None,
            log_every: int = 50, val_batches: Optional[int] = None) -> Dict[str, float]:
        """Run the fit loop. ``train_data``/``val_data`` are callables or
        re-iterables yielding (x [B,C,T], ys [B,Spk,C,T], paras); an epoch
        takes at most ``steps_per_epoch`` train batches and validates on at
        most ``val_batches``."""
        if self.opt is None:
            self.init()
        history: Dict[str, float] = {}
        checked_unused = self.epoch > 0 or not self.detect_unused_parameters
        first_epoch = self.epoch  # the profiler captures only this epoch
        for epoch in range(self.epoch, max_epochs):
            t0 = time.time()
            losses = []
            it = train_data() if callable(train_data) else train_data
            for step, batch in enumerate(take(it, steps_per_epoch)):
                if self.profile_dir and epoch == first_epoch and self.mesh.is_main:
                    self._profile_hook(step)
                losses.append(self.train_step(batch))
                if not checked_unused:
                    self._warn_unused_parameters()
                    checked_unused = True
                if (step + 1) % log_every == 0:
                    self.logger(f"train/{self.module.loss.name}",
                                float(self.mesh.all_mean(losses[-1])), epoch)
            self._stop_profiler()
            train_loss = (float(self.mesh.all_mean(torch.stack(losses).mean())) if losses
                          else float("nan"))
            history["train_loss"] = train_loss
            self.logger(f"train/{self.module.loss.name}", train_loss, epoch)

            val_metric = None
            if val_data is not None:
                val_logs = self.validate(val_data, val_batches)
                if self.val_host_metrics and (epoch + 1) % self.val_host_metrics_every == 0:
                    val_logs.update(self._host_metrics(val_data, val_batches))
                for k, v in val_logs.items():
                    self.logger(k, v, epoch)
                history.update(val_logs)
                val_metric = val_logs.get("val/metric")

            if self.ckpt is not None:
                self.ckpt.save(epoch, self.arch.state_dict(), self.opt.state_dict(),
                               metric=val_metric)

            monitored = None
            if val_metric is not None:
                monitored = -val_metric if self.val_metric_mode == "max" else val_metric
            new_lr = self.lr_schedule.step(epoch, monitored)
            self.opt.lr = new_lr
            self.logger("lr", new_lr, epoch)
            self.epoch = epoch + 1
            history["epoch_time"] = time.time() - t0
            vm = f" val/metric={val_metric:.4f}" if val_metric is not None else ""
            if self.mesh.is_main:
                print(f"epoch {epoch}: train/{self.module.loss.name}={train_loss:.4f}"
                      f"{vm} lr={new_lr:.2e} ({history['epoch_time']:.1f}s)", flush=True)

            if self.early_stopping and val_metric is not None and self._should_stop(val_metric):
                break
        return history

    def _profile_hook(self, step: int) -> None:
        """Start ``torch.profiler`` at the first profiled step, stop it at the last."""
        a, b = self.profile_steps
        if step == a:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif step == b:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_epoch{self.epoch}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"profiler trace written to {path}", flush=True)

    def _host_metrics(self, val_data, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Host metrics (PESQ/STOI/...) over validation batches (at most
        ``val_host_metrics_batches`` and ``max_batches``); an item whose
        metric is missing or not finite (say STOI of a near-silent segment)
        is left out of that metric's mean. On several ranks each takes its
        rows (rank 0 alone a replicated batch) and the sums are gathered."""
        from nbss_tpu_torch.eval.metrics import cal_metrics

        self.arch.eval()
        it = val_data() if callable(val_data) else val_data
        limits = [n for n in (self.val_host_metrics_batches, max_batches) if n is not None]
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for batch in take(it, min(limits) if limits else None):
            batch = shard_batch(self.mesh, batch)
            if batch.replicated and not self.mesh.is_main:
                continue
            x, ys = self.to_device(batch)
            paras = batch[2] if len(batch) > 2 else [{}]
            fs = paras[0].get("sample_rate", 8000) if paras else 8000
            yhat = self.module.predict_step(x, norm_if_exceed_1=False).float().cpu().numpy()
            yr = ys[:, :, self.module.ref_channel, :].float().cpu().numpy()
            for b in range(yhat.shape[0]):
                m, _, _ = cal_metrics(self.val_host_metrics, yhat[b], yr[b], yr[b], fs,
                                      device_only="host")
                for k, v in m.items():
                    if isinstance(v, (int, float)) and np.isfinite(v):
                        sums[k] = sums.get(k, 0.0) + v
                        counts[k] = counts.get(k, 0) + 1
        sums, counts = _add_up(self.mesh.all_gather_object((sums, counts)))
        return {f"val/{k}": sums[k] / counts[k] for k in sums}

    def _warn_unused_parameters(self) -> None:
        """After the first step: warn for each parameter whose gradient is
        zero everywhere (a debugging aid)."""
        if not self.mesh.is_main:
            return
        for name, p in self.arch.named_parameters():
            if p.grad is None or float(p.grad.abs().max()) == 0.0:
                warnings.warn(f"unused parameter (check code or freeze it): {name}")

    def _should_stop(self, monitored: float) -> bool:
        es = self.early_stopping
        mode = es.get("mode", "max")
        min_delta = es.get("min_delta", 0.0)
        improved = (self._es_best is None
                    or (mode == "max" and monitored > self._es_best + min_delta)
                    or (mode == "min" and monitored < self._es_best - min_delta))
        if improved:
            self._es_best, self._es_bad = monitored, 0
            return False
        self._es_bad += 1
        return self._es_bad >= es.get("patience", 10)

    def validate(self, val_data: Iterable, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Batch-size-weighted means of ``validation_step``'s logs over at
        most ``max_batches`` batches. On several ranks each rank takes its
        rows and the weighted sums are added over the ranks (a replicated
        batch weighs 1/ranks on each), so every rank returns the means over
        the global batches."""
        self.arch.eval()
        it = val_data() if callable(val_data) else val_data
        sums: Dict[str, float] = {}
        n = 0.0
        for batch in take(it, max_batches):
            batch = shard_batch(self.mesh, batch)
            x, ys = self.to_device(batch)
            logs = self.module.validation_step((x, ys))
            bs = int(x.shape[0]) / (self.mesh.size if batch.replicated else 1)
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v) * bs
            n += bs
        sums, n = _add_up(self.mesh.all_gather_object((sums, n)))
        return {k: v / max(n, 1) for k, v in sums.items()}


def _add_up(parts):
    """The ranks' (sums, counts) added up: dicts key by key, numbers as numbers."""
    def add(a, b):
        if isinstance(a, dict):
            return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}
        return a + b

    out = parts[0]
    for p in parts[1:]:
        out = tuple(add(a, b) for a, b in zip(out, p))
    return out
