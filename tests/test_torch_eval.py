"""The port's evaluation (eval/metrics.py, stoi.py, pesq_native.py) and run
records (utils/logging.py, utils/audio_io.py) against nbss_tpu on the CPU.

``cal_metrics`` on the same prediction, target and mixture arrays gives the
same keys; the device metrics (SDR, SI-SDR, SNR, SI-SNR, also chunk-wise)
agree within 1e-3 dB (float32 sums in another library), the host metrics
(STOI, eSTOI, NB/WB-PESQ) exactly, as they are the same numpy code.
"""

import json
import math

import numpy as np
import pytest
import torch

from nbss_tpu.eval.metrics import cal_metrics as j_cal_metrics
from nbss_tpu.eval.stoi import stoi as j_stoi
from nbss_tpu.utils.audio_io import read_audio as j_read_audio
from nbss_tpu_torch.eval.metrics import DEVICE_METRICS, HOST_METRICS, cal_metrics
from nbss_tpu_torch.eval.stoi import stoi
from nbss_tpu_torch.utils.audio_io import read_audio, write_audio
from nbss_tpu_torch.utils.logging import TensorBoardLogger, write_model_summary


def _signals(fs, seconds, seed=0):
    rng = np.random.default_rng(seed)
    T = int(fs * seconds)
    t = np.arange(T) / fs
    clean = np.stack([np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                      for f in (220.0, 330.0)]).astype(np.float32)
    clean += 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    pred = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    mix = (clean.sum(0, keepdims=True) + 0.2 * rng.standard_normal((1, T))).astype(np.float32)
    return pred, clean, np.broadcast_to(mix, clean.shape)


def _equal_results(got, want, atol):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert g is None and w is None, k
        else:
            assert math.isclose(g, w, abs_tol=atol), (k, g, w)


@pytest.mark.parametrize("device_only", ["device", None])
def test_device_metrics_match_jax(device_only):
    pred, clean, mix = _signals(8000, 1.5)
    metrics = ["SDR", "SI_SDR", "SNR", "SI_SNR"]
    got = cal_metrics(metrics, pred, clean, mix, 8000, device_only=device_only, chunk=(1.0, 0.5))
    want = j_cal_metrics(metrics, pred, clean, mix, 8000, device_only=device_only,
                         chunk=(1.0, 0.5))
    for g, w in zip(got, want):
        _equal_results(g, w, atol=1e-3)
    assert "SDR_0s-1s" in got[0]


@pytest.mark.parametrize("fs", [8000, 16000])
def test_host_metrics_match_jax(fs):
    pred, clean, mix = _signals(fs, 1.5, seed=1)
    metrics = ["NB_PESQ", "WB_PESQ", "STOI", "eSTOI", "DNSMOS"]
    got = cal_metrics(metrics, pred, clean, mix, fs, device_only="host")
    want = j_cal_metrics(metrics, pred, clean, mix, fs, device_only="host")
    for g, w in zip(got, want):
        _equal_results(g, w, atol=1e-9)
    m = got[0]
    assert 0.0 < m["STOI"] <= 1.0
    if fs == 8000:
        assert m["WB_PESQ"] is None  # undefined at 8 kHz
    assert DEVICE_METRICS.isdisjoint(HOST_METRICS)


def test_stoi_is_jax():
    pred, clean, _ = _signals(10000, 2.0, seed=2)
    for ext in (False, True):
        assert stoi(clean[0], pred[0], 10000, extended=ext) == \
            j_stoi(clean[0], pred[0], 10000, extended=ext)


def test_audio_round_trip_and_logger(tmp_path):
    pred, _, _ = _signals(8000, 0.5)
    write_audio(str(tmp_path / "a.wav"), pred, 8000)  # [C, T] written as [T, C]
    data, sr = read_audio(str(tmp_path / "a.wav"))
    want, sr_j = j_read_audio(str(tmp_path / "a.wav"))
    assert sr == sr_j == 8000 and data.shape == (pred.shape[1], 2)
    np.testing.assert_array_equal(data, pred.T)
    np.testing.assert_array_equal(data, want)

    log = TensorBoardLogger(str(tmp_path / "run"))
    log("val/STOI", 0.5, 0)
    log("lr", 1e-3, 1)
    log.close()
    lines = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
    assert lines == [{"key": "val/STOI", "value": 0.5, "step": 0},
                     {"key": "lr", "value": 1e-3, "step": 1}]

    class _M:
        arch = torch.nn.Linear(3, 2)

    write_model_summary(str(tmp_path), _M())
    assert "params: 0.000 M (8)" in (tmp_path / "model.txt").read_text()
