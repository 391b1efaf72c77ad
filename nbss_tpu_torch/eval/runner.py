"""Test and predict runs: metrics, result files and example WAVs.

Counterpart of ``nbss_tpu/eval/runner.py``: per item the device metrics
and, concurrently in a spawn pool, the host metrics;
``results_incremental.jsonl`` as items finish, ``results_<timestamp>.json``
and ``results_mean.json`` at the end, the first N examples as WAVs with a
``paras.json``, and at predict time WAVs named by each item's ``saveto``.

On several ranks (``trainer.mesh``) each rank evaluates its own items (the
data modules stride test and predict items over the ranks), writes
``results_rank{r}.json`` and its ``_rank{r}`` incremental files, and after a
barrier rank 0 merges the ranks' files, each wavname once, into the final
results, as the JAX package merges its processes' shards.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from multiprocessing import get_context
from typing import Dict, List, Sequence

import numpy as np
import torch

from nbss_tpu_torch.eval.metrics import HOST_METRICS, cal_metrics
from nbss_tpu_torch.utils.audio_io import write_audio


def _mean_of(results: List[Dict]) -> Dict:
    keys = {k for r in results for k, v in r.items() if isinstance(v, (int, float))}
    out = {}
    for k in sorted(keys):
        vals = [r[k] for r in results
                if isinstance(r.get(k), (int, float)) and np.isfinite(r[k])]
        if vals:
            out[k] = float(np.mean(vals))
    return out


def _pad_to_bucket(x, T0: int, length_bucket_s: float, fs: int):
    """Zero-pad the last dim up to the next length bucket (falsy
    ``length_bucket_s`` disables padding)."""
    if not length_bucket_s:
        return x
    quantum = max(int(length_bucket_s * fs), 1)
    Tpad = -(-T0 // quantum) * quantum
    if Tpad == T0:
        return x
    return np.pad(np.asarray(x), [(0, 0)] * (np.ndim(x) - 1) + [(0, Tpad - T0)])


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_test(trainer, module, test_loader, log_dir: str,
             metrics: Sequence[str] = ("SDR", "SI_SDR"),
             write_examples: int = 200,
             mchunk=None,
             host_metric_workers: int = 4,
             length_bucket_s: float = 1.0,
             flush_every: int = 16) -> Dict:
    """Evaluate ``module`` on ``test_loader`` and write the result files.

    Utterances are zero-padded up to a multiple of ``length_bucket_s``
    seconds before ``test_step``, as in the JAX package; metrics are taken on
    the original lengths. Each item's device-metric result is appended to
    ``results_incremental.jsonl`` at once, and ``results_mean.json`` is
    rewritten (with ``"partial": true``) every ``flush_every`` items, so an
    interrupted run leaves readable results."""
    module.arch.eval()
    mesh = trainer.mesh
    os.makedirs(log_dir, exist_ok=True)
    examples_dir = os.path.join(log_dir, "examples")
    results: List[Dict] = []
    host_async = []  # per-item AsyncResult, or the arguments when the pool is down
    rank_tag = f"_rank{mesh.rank}" if mesh.size > 1 else ""
    mean_path = os.path.join(log_dir, f"results_mean{rank_tag}.json")

    def _flush_mean(partial: bool) -> Dict:
        mean = _mean_of(results)
        rec = {"partial": True, "num_items": len(results), **mean} if partial else mean
        tmp = mean_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, mean_path)
        return mean

    pool = None
    if HOST_METRICS.intersection(metrics):  # host metrics run beside the device loop
        try:
            pool = get_context("spawn").Pool(host_metric_workers)
        except OSError:
            pool = None

    seen = set()
    item_idx = 0
    with open(os.path.join(log_dir, f"results_incremental{rank_tag}.jsonl"), "w") as inc_f:
        for x, ys, paras in test_loader:
            T0 = x.shape[-1]
            fs_b = paras[0].get("sample_rate", 16000) if paras else 16000
            x = _pad_to_bucket(_host(x), T0, length_bucket_s, fs_b)
            ys = _pad_to_bucket(_host(ys), T0, length_bucket_s, fs_b)
            out = module.test_step((torch.as_tensor(x, device=trainer.device),
                                    torch.as_tensor(ys, device=trainer.device)))
            batch_loss = float(out["loss"])  # batch mean (per item not separable)
            yr_hat_b = _host(out["yr_hat"])[..., :T0]
            yr_b = _host(out["yr"])[..., :T0]
            x_ref_b = _host(out["x_ref"])[..., :T0]
            for b in range(yr_hat_b.shape[0]):
                para = paras[b] if b < len(paras) else {}
                wavname = os.path.basename(
                    f"{para.get('wavname', para.get('index', item_idx))}")
                if wavname in seen:
                    continue
                seen.add(wavname)
                yr_hat, yr, x_ref = yr_hat_b[b], yr_b[b], x_ref_b[b]
                fs = para.get("sample_rate", 16000)

                result = {"id": item_idx, "wavname": wavname, module.loss.name: batch_loss}
                m, im, imp = cal_metrics(metrics, yr_hat, yr, np.broadcast_to(x_ref, yr.shape),
                                         fs, device_only="device", chunk=mchunk)
                result.update(im)
                result.update(imp)
                result.update(m)
                hi = (metrics, yr_hat, yr, np.broadcast_to(x_ref, yr.shape).copy(), fs, "host",
                      mchunk)
                host_async.append(pool.apply_async(cal_metrics, hi) if pool is not None else hi)

                if write_examples < 0 or item_idx < write_examples:
                    _write_example(examples_dir, wavname, x_ref, yr, yr_hat, fs, para, result)

                result["paras"] = _jsonable(para)
                results.append(result)
                inc_f.write(json.dumps(result, default=str) + "\n")
                inc_f.flush()
                item_idx += 1
                if item_idx % flush_every == 0:
                    _flush_mean(partial=True)

    # host metrics, computed meanwhile when pooled
    try:
        for r, h in zip(results, host_async):
            try:
                m, im, imp = h.get() if pool is not None else cal_metrics(*h)
            except Exception as e:  # an item's failed host metrics degrade to None
                warnings.warn(f"host metrics of item {r['wavname']} failed: {e!r}")
                continue
            merged = {**im, **imp, **m}
            r.update({k: v for k, v in merged.items() if v is not None})
    finally:
        if pool is not None:
            pool.close()
            pool.join()

    if mesh.size > 1:
        results = _merge_ranks(mesh, log_dir, results)
        if not mesh.is_main:
            return {"num_items": len(results)}
        mean_path = os.path.join(log_dir, "results_mean.json")
    ts = time.strftime("%Y%m%d_%H%M%S")
    with open(os.path.join(log_dir, f"results_{ts}.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    mean = _flush_mean(partial=False)
    return {"num_items": len(results), **mean}


def _merge_ranks(mesh, log_dir: str, results: List[Dict]) -> List[Dict]:
    """Each rank writes results_rank{r}.json; after a barrier rank 0 returns
    the ranks' results in rank order, each wavname once (the others their own)."""
    with open(os.path.join(log_dir, f"results_rank{mesh.rank}.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    mesh.barrier()
    if not mesh.is_main:
        return results
    merged, seen = [], set()
    for r in range(mesh.size):
        with open(os.path.join(log_dir, f"results_rank{r}.json")) as f:
            for item in json.load(f):
                if item["wavname"] not in seen:
                    seen.add(item["wavname"])
                    merged.append(item)
    return merged


def run_predict(trainer, module, predict_loader, log_dir: str,
                length_bucket_s: float = 1.0) -> List[str]:
    """Write predicted WAVs to log_dir/examples under each item's
    ``paras['saveto']``; ``length_bucket_s`` pads as in ``run_test``. On
    several ranks each writes its own items (every item on one rank)."""
    module.arch.eval()
    out_dir = os.path.join(log_dir, "examples")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for batch_idx, (x, ys, paras) in enumerate(predict_loader):
        T0 = x.shape[-1]
        fs_b = paras[0].get("sample_rate", 16000) if paras else 16000
        x = _pad_to_bucket(_host(x), T0, length_bucket_s, fs_b)
        yhat = _host(module.predict_step(torch.as_tensor(x, device=trainer.device)))[..., :T0]
        for b, para in enumerate(paras):
            fs = para.get("sample_rate", 16000)
            saveto = para.get("saveto") or [f"{para.get('index', batch_idx)}_{s}.wav"
                                            for s in range(yhat.shape[1])]
            if isinstance(saveto, str):
                saveto = [saveto]
            if isinstance(saveto, dict):
                saveto = saveto.get("prediction", list(saveto.values())[0])
            for s, name in enumerate(saveto[: yhat.shape[1]]):
                path = os.path.join(out_dir, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_audio(path, yhat[b, s], fs)
                written.append(path)
    return written


def _write_example(examples_dir, wavname, x_ref, yr, yr_hat, fs, para, result):
    d = os.path.join(examples_dir, os.path.splitext(wavname)[0])
    os.makedirs(d, exist_ok=True)
    write_audio(os.path.join(d, "mixture.wav"), x_ref, fs)
    for s in range(yr.shape[0]):
        write_audio(os.path.join(d, f"target_{s}.wav"), yr[s], fs)
        write_audio(os.path.join(d, f"prediction_{s}.wav"), yr_hat[s], fs)
    with open(os.path.join(d, "paras.json"), "w") as f:
        json.dump({"paras": _jsonable(para), "result": _jsonable(result)}, f,
                  indent=1, default=str)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return f"<array shape={obj.shape}>"
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj
