"""Checkpoint save, restore and ensemble with ``torch.save``.

Counterpart of ``nbss_tpu/train/ckpt.py``, in the same layout:

    <dir>/epoch{N}/params      the model's state_dict
    <dir>/epoch{N}/opt_state   the optimizer's state_dict (when saved)
    <dir>/epoch{N}.json        {"epoch": N, "metric": m}
    <dir>/last.json            the same for the newest save

Every epoch is kept. In a data-parallel run only rank 0 writes, and every
rank waits at a barrier until it has; every rank restores. ``restore``
drops the optimizer state with ``reset=["optimizer"]``, and ``ensemble``
averages the parameters of several checkpoints in float64 (the last N, a
list of epochs, or glob patterns).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from nbss_tpu_torch.parallel.mesh import Mesh, current_mesh


def _epoch_dirs(ckpt_dir: str) -> List[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((d for d in os.listdir(ckpt_dir) if re.match(r"^epoch\d+$", d)),
                  key=lambda d: int(d[5:]))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Every-epoch checkpointing with a ``last`` pointer and metric metadata."""

    def __init__(self, ckpt_dir: str, mesh: Optional[Mesh] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.mesh = mesh or current_mesh()
        if self.mesh.is_main:
            os.makedirs(self.ckpt_dir, exist_ok=True)

    def save(self, epoch: int, params: Dict[str, torch.Tensor],
             opt_state: Optional[Dict[str, Any]] = None, metric: Optional[float] = None):
        if self.mesh.is_main:
            self._write(epoch, params, opt_state, metric)
        self.mesh.barrier()

    def _write(self, epoch, params, opt_state, metric) -> None:
        path = os.path.join(self.ckpt_dir, f"epoch{epoch}")
        os.makedirs(path, exist_ok=True)
        torch.save(_to_cpu(params), os.path.join(path, "params"))
        if opt_state is not None:
            torch.save(_to_cpu(opt_state), os.path.join(path, "opt_state"))
        meta = {"epoch": epoch, "metric": metric}
        for name in (f"epoch{epoch}.json", "last.json"):
            with open(os.path.join(self.ckpt_dir, name), "w") as f:
                json.dump(meta, f)

    def latest_epoch(self) -> Optional[int]:
        dirs = _epoch_dirs(self.ckpt_dir)
        return int(dirs[-1][5:]) if dirs else None

    def best_epoch(self, mode: str = "max") -> Optional[int]:
        best, best_m = None, None
        for d in _epoch_dirs(self.ckpt_dir):
            meta_path = os.path.join(self.ckpt_dir, d + ".json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                m = json.load(f).get("metric")
            if m is None:
                continue
            if best_m is None or (m > best_m if mode == "max" else m < best_m):
                best, best_m = int(d[5:]), m
        return best

    def restore(self, epoch: Optional[int] = None,
                reset: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """{"params", "epoch"} and, unless ``reset`` names the optimizer,
        "opt_state" when the checkpoint holds one. Tensors load on the CPU."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        path = os.path.join(self.ckpt_dir, f"epoch{epoch}")
        restored: Dict[str, Any] = {
            "params": torch.load(os.path.join(path, "params"), map_location="cpu"),
            "epoch": epoch}
        skip_opt = reset and {r.lower() for r in reset} & {"optimizer", "opt_state"}
        opt_path = os.path.join(path, "opt_state")
        if not skip_opt and os.path.exists(opt_path):
            restored["opt_state"] = torch.load(opt_path, map_location="cpu")
        return restored

    def _resolve_ensemble_epochs(self, opts) -> List[int]:
        """int N -> the last N epochs; a list of ints -> those epochs; a string
        or list of strings -> glob patterns or checkpoint directories."""
        if isinstance(opts, int):
            return [int(d[5:]) for d in _epoch_dirs(self.ckpt_dir)[-opts:]]
        items = [opts] if isinstance(opts, str) else list(opts)
        epochs: List[int] = []
        for it in items:
            if isinstance(it, int):
                epochs.append(it)
                continue
            matches = sorted(glob.glob(str(it))) or sorted(
                glob.glob(os.path.join(self.ckpt_dir, str(it))))
            if not matches:
                raise FileNotFoundError(f"ensemble pattern matched nothing: {it}")
            for m in matches:
                em = re.match(r"^epoch(\d+)", os.path.basename(m.rstrip("/")))
                if not em:
                    raise ValueError(f"not an epoch checkpoint: {m}")
                epochs.append(int(em.group(1)))
        return sorted(set(epochs))

    def ensemble(self, opts: Union[int, str, Sequence[Union[int, str]]]) -> Dict[str, Any]:
        """{"params": the float64 mean of the checkpoints' parameters, cast back
        to float32, "epochs": the epochs averaged}."""
        epochs = self._resolve_ensemble_epochs(opts)
        if not epochs:
            raise FileNotFoundError("no checkpoints to ensemble")
        acc: Dict[str, torch.Tensor] = {}
        for e in epochs:
            for k, v in self.restore(e)["params"].items():
                acc[k] = acc[k] + v.double() if k in acc else v.double()
        n = float(len(epochs))
        return {"params": {k: (v / n).float() for k, v in acc.items()}, "epochs": epochs}
