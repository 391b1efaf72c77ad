"""Run records: scalar logs, provenance and the model summary.

Counterpart of ``nbss_tpu/utils/logging.py``: ``TensorBoardLogger`` writes
scalars through tensorboardX when it can be imported and always appends them
to ``metrics.jsonl``; ``log_provenance`` records the git state and the
environment; ``write_model_summary`` writes ``model.txt``. In a data-parallel
run only rank 0 writes them (``rank_zero_logger``; the callers of the other
two ask ``Mesh.is_main``), as the JAX package writes on process 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


class TensorBoardLogger:
    """Scalar logger: tensorboardX events when available, and metrics.jsonl."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except ImportError:
            self._writer = None
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def __call__(self, key: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(key, value, step)
        self._jsonl.write(json.dumps({"key": key, "value": float(value), "step": step}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
        self._jsonl.close()


def rank_zero_logger(log_dir: str, mesh) -> "TensorBoardLogger | None":
    """A ``TensorBoardLogger`` on rank 0 of ``mesh``; None (log nothing) on
    the others."""
    return TensorBoardLogger(log_dir) if mesh.is_main else None


def _run(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:  # provenance is best-effort
        return f"<failed: {e}>"


def log_provenance(log_dir: str) -> None:
    """provenance.txt: git revision and status, Python, torch and CUDA, and
    the installed distributions as ``pip freeze`` names them (read in
    process from their metadata, without pip's seconds of start-up)."""
    from importlib import metadata

    import torch

    heads = [d.metadata for d in metadata.distributions()]  # each parsed once
    packages = sorted({f"{m['Name']}=={m['Version']}" for m in heads if m["Name"]},
                      key=str.lower)
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "provenance.txt"), "w") as f:
        f.write("## git rev\n" + _run(["git", "rev-parse", "HEAD"]))
        f.write("\n## git status\n" + _run(["git", "status", "--short"]))
        f.write("\n## python\n" + sys.version + "\n")
        f.write(f"\n## torch\n{torch.__version__} cuda {torch.version.cuda}\n")
        f.write("\n## pip freeze\n" + "\n".join(packages) + "\n")


def write_model_summary(log_dir: str, module) -> None:
    """model.txt: the arch's repr and its parameter count."""
    n_params = sum(p.numel() for p in module.arch.parameters())
    with open(os.path.join(log_dir, "model.txt"), "w") as f:
        f.write(repr(module.arch) + "\n")
        f.write(f"\nparams: {n_params / 1e6:.3f} M ({n_params})\n")
