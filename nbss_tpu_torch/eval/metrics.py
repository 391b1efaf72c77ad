"""Test-time metric computation: metric / input-metric / improvement.

Counterpart of ``nbss_tpu/eval/metrics.py`` (the reference's
models/utils/metrics.py:26-151, ``cal_metrics_functional``): given
prediction/target/mixture waveforms, compute each requested metric, the
same metric on the unprocessed mixture (``input_``), and the improvement
(``_i``), with optional chunk-wise evaluation over (len, hop)-second
windows (``_Xs-Ys`` suffixed entries).

Device metrics (SDR / SI_SDR / SNR / SI_SNR) run through the port's
``ops/metrics.py`` on CPU tensors of the given arrays; host metrics run in
numpy (NB/WB_PESQ via the optional ``pesq`` C library, else the native
estimator of ``eval/pesq_native.py``; STOI/eSTOI via ``eval/stoi.py``).
DNSMOS needs onnxruntime and its models and is not ported: it reports None
with a warning, as the JAX package does where onnxruntime is absent.
Per-metric failures degrade to None.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nbss_tpu_torch.eval.stoi import stoi
from nbss_tpu_torch.ops import metrics as M

DEVICE_METRICS = {"SDR", "SI_SDR", "SNR", "SI_SNR"}
HOST_METRICS = {"NB_PESQ", "WB_PESQ", "STOI", "eSTOI", "DNSMOS", "pDNSMOS"}

#: Output-key renames recording metric provenance: when the ITU P.862 C
#: library is absent, the native estimator's values are reported under
#: ``NB_PESQ_est`` so no results JSON can pass an estimate off as P.862
#: (the reference's metric names, models/utils/metrics.py:83-87).
_EST_SUFFIX = "_est"

try:
    from pesq import pesq as _pesq
except ImportError:  # pragma: no cover
    _pesq = None


def _nb_pesq(fs: int, t: np.ndarray, p: np.ndarray) -> Optional[float]:
    """NB-PESQ via the C ``pesq`` wheel when present (reference parity,
    metrics.py:83-87); otherwise the native P.862-chain fallback
    (eval/pesq_native.py) unless NBSS_PESQ_NATIVE=0."""
    if _pesq is not None:
        return float(_pesq(fs, t, p, "nb"))
    if os.environ.get("NBSS_PESQ_NATIVE", "1") == "0":
        return None
    from nbss_tpu_torch.eval.pesq_native import nb_pesq

    return float(nb_pesq(fs, t, p))


def _wb_pesq(fs: int, t: np.ndarray, p: np.ndarray) -> Optional[float]:
    """WB-PESQ via the C ``pesq`` wheel when present; otherwise the native
    P.862.2-chain fallback (eval/pesq_native.py, reported as
    ``WB_PESQ_est``) unless NBSS_PESQ_NATIVE=0. Undefined at 8 kHz either
    way (reference metrics.py:103-105)."""
    if fs == 8000:
        return None
    if _pesq is not None:
        return float(_pesq(fs, t, p, "wb"))
    if os.environ.get("NBSS_PESQ_NATIVE", "1") == "0":
        return None
    from nbss_tpu_torch.eval.pesq_native import wb_pesq

    return float(wb_pesq(fs, t, p))


def _one_metric(name: str, preds: np.ndarray, target: np.ndarray, fs: int) -> Optional[float]:
    """Mean metric over sources; None if unavailable, failed, or non-finite
    (e.g. STOI of a near-silent target segment)."""
    v = _one_metric_raw(name, preds, target, fs)
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


def _one_metric_raw(name: str, preds: np.ndarray, target: np.ndarray, fs: int) -> Optional[float]:
    try:
        p, t = torch.tensor(preds), torch.tensor(target)
        if name == "SDR":
            return float(M.sdr(p, t).mean())
        if name == "SI_SDR":
            return float(M.si_sdr(p, t).mean())
        if name == "SNR":
            return float(M.snr(p, t).mean())
        if name == "SI_SNR":
            return float(M.si_sdr(p, t, zero_mean=True).mean())
        if name == "NB_PESQ":
            vals = [_nb_pesq(fs, t, p) for p, t in zip(preds, target)]
            if any(v is None for v in vals):
                return None
            return float(np.mean(vals))
        if name == "WB_PESQ":
            vals = [_wb_pesq(fs, t, p) for p, t in zip(preds, target)]
            if any(v is None for v in vals):
                return None
            return float(np.mean(vals))
        if name == "STOI":
            return float(np.mean([stoi(t, p, fs) for p, t in zip(preds, target)]))
        if name == "eSTOI":
            return float(np.mean([stoi(t, p, fs, extended=True) for p, t in zip(preds, target)]))
        if name in ("DNSMOS", "pDNSMOS"):
            raise NotImplementedError("DNSMOS needs onnxruntime and is not ported")
    except Exception as e:  # degrade per-metric failures to None
        warnings.warn(f"metric {name} failed: {e}")
        return None
    raise KeyError(name)


def cal_metrics(
    metrics: Sequence[str],
    preds: np.ndarray,
    target: np.ndarray,
    original: np.ndarray,
    fs: int,
    device_only: Optional[str] = None,  # 'device' | 'host' | None
    chunk: Optional[Tuple[float, float]] = None,
) -> Tuple[Dict, Dict, Dict]:
    """preds/target/original: [spk, T]. Returns (metrics, input_metrics,
    improve_metrics) dicts; keys follow the reference naming
    (``input_<m>``, ``<m>_i``)."""
    preds = np.asarray(preds, np.float32)
    target = np.asarray(target, np.float32)
    original = np.asarray(original, np.float32)

    selected = []
    for m in metrics:
        if device_only == "device" and m not in DEVICE_METRICS:
            continue
        if device_only == "host" and m not in HOST_METRICS:
            continue
        selected.append(m)

    out: Dict = {}
    inp: Dict = {}
    imp: Dict = {}
    for m in selected:
        v = _one_metric(m, preds, target, fs)
        vi = _one_metric(m, original, target, fs)
        if isinstance(v, dict) or isinstance(vi, dict):
            # multi-valued metric (DNSMOS) -> '<m>_p808' / '_sig' / ... keys
            for sub in (v or vi or {}):
                sv = (v or {}).get(sub)
                si = (vi or {}).get(sub)
                out[f"{m}_{sub}"] = sv
                inp[f"input_{m}_{sub}"] = si
                imp[f"{m}_{sub}_i"] = ((sv - si) if (sv is not None and si is not None)
                                       else None)
            continue
        key = m
        if (m in ("NB_PESQ", "WB_PESQ") and _pesq is None
                and v is not None):
            key = m + _EST_SUFFIX  # native estimator, not ITU P.862
        out[key] = v
        inp[f"input_{key}"] = vi
        imp[f"{key}_i"] = (v - vi) if (v is not None and vi is not None) else None

        if chunk is not None and m in DEVICE_METRICS:
            clen, hop = int(chunk[0] * fs), int(chunk[1] * fs)
            T = preds.shape[-1]
            starts = range(0, max(T - clen + 1, 1), hop)
            for s in starts:
                pv = _one_metric(m, preds[:, s:s + clen], target[:, s:s + clen], fs)
                key = f"{m}_{s / fs:.0f}s-{min((s + clen) / fs, T / fs):.0f}s"
                out[key] = pv
    return out, inp, imp
