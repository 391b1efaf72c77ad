"""The port's room simulation (sim/) against nbss_tpu.sim on the CPU.

``RirConfigSampler.sample(i)`` gives equal dicts (static and moving rooms);
``simulate_rir`` and ``render_room``'s npz agree with the JAX package within
1e-4 x max|rir| at RT60 0.15-0.2 (small rooms, as tests/test_sim.py renders
them), with the same keys and shapes; the direct path's delay and amplitude
match distance / c and 1 / (4 pi d); the generator's command line renders and
resumes on the CPU with ``--device cpu`` and raises without a card when the
card is asked for.
"""

import os

import numpy as np
import pytest
import torch

from nbss_tpu.sim.config import RirConfigSampler as JRirConfigSampler
from nbss_tpu.sim.generate import migrate_splits as j_migrate_splits
from nbss_tpu.sim.generate import render_room as j_render_room
from nbss_tpu.sim.ism import simulate_rir as j_simulate_rir
from nbss_tpu_torch.sim import RirConfigSampler, render_room, simulate_direct_path, simulate_rir
from nbss_tpu_torch.sim.generate import main as generate_main
from nbss_tpu_torch.sim.generate import migrate_splits

FS, C = 8000, 343.0


def _same(a, b, path="par"):
    if isinstance(a, np.ndarray) and a.dtype == object and a.ndim == 0:
        a, b = a.item(), b.item()
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) or (isinstance(a, np.ndarray) and a.dtype == object):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("kw", [
    dict(spk_num=2, noise_num=0, arr_geometry="circular+cm", mic_num=6, RT60_lim=(0.1, 0.6),
         seed=0),
    dict(spk_num=2, noise_num=1, RT60_lim=(0.15, 0.4), seed=7),
    dict(spk_num=2, noise_num=1, RT60_lim=(0.1, 0.6), trajectory=("4points+sin", 0.5), seed=0),
])
def test_config_sampler_dicts_are_jax(kw):
    for i in (0, 1, 5):
        _same(RirConfigSampler(fs=FS, **kw).sample(i), JRirConfigSampler(fs=FS, **kw).sample(i))


@pytest.mark.parametrize("t60", [0.0, 0.15])
def test_simulate_rir_matches_jax(t60):
    room = [5.0, 4.0, 3.0]
    src = [[1.0, 1.0, 1.5], [3.0, 2.5, 1.2]]
    rcv = [[2.0, 2.0, 1.5], [2.1, 2.0, 1.5], [2.5, 3.0, 1.4]]
    want = j_simulate_rir(room, src, rcv, t60, FS, length_round=512)
    got = simulate_rir(room, src, rcv, t60, FS, length_round=512, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_direct_path_delay_and_amplitude():
    rir = simulate_direct_path([5.0, 4.0, 3.0], [1.0, 2.0, 1.5], [[3.0, 2.0, 1.5]], FS,
                               device="cpu")
    assert rir.shape == (1, 1, int(0.1 * FS))
    d = 2.0
    assert abs(int(np.argmax(np.abs(rir[0, 0]))) - d / C * FS) <= 1
    np.testing.assert_allclose(rir[0, 0].sum(), 1 / (4 * np.pi * d), rtol=1e-3)


def _npz_equal(got_path, want_path):
    got, want = np.load(got_path, allow_pickle=True), np.load(want_path, allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        g, w = got[k], want[k]
        if w.dtype.kind == "f" and w.ndim == 3:  # rir, rir_dp, rir_noise
            assert g.shape == w.shape, k
            w32 = w.astype(np.float32)
            half = 1e-3 if w.dtype == np.float16 else 0.0  # a half-precision step on top
            np.testing.assert_allclose(g.astype(np.float32), w32,
                                       atol=1e-4 * np.abs(w32).max() + half, rtol=0, err_msg=k)
        else:
            _same(g, w, k)


def test_render_room_static_matches_jax(tmp_path):
    s = JRirConfigSampler(spk_num=2, noise_num=1, RT60_lim=(0.15, 0.2), seed=3)
    par = s.sample(0)
    want = j_render_room(par, FS, str(tmp_path / "jax"), "train")
    got = render_room(par, FS, str(tmp_path / "port"), "train", device="cpu")
    assert os.path.basename(got) == os.path.basename(want) == "0.npz"
    _npz_equal(got, want)


def test_render_room_trajectory_layout_and_first_point(tmp_path):
    """A moving room: the npz lists per-source fp16 stacks [points, mics, L]
    as the JAX generator names them, and the first point's RIR is JAX's."""
    s = JRirConfigSampler(spk_num=1, noise_num=0, RT60_lim=(0.13, 0.16),
                          trajectory=("4points+sin", 0.5), seed=5)
    par = s.sample(0)
    path = render_room(par, FS, str(tmp_path), "train", split_trajectory=8, device="cpu")
    d = np.load(path, allow_pickle=True)
    assert list(d["rir"]) == ["0_rir_0.npy"] and list(d["rir_dp"]) == ["0_rir_dp_0.npz"]
    r = np.load(tmp_path / "train" / "0_rir_0.npy")
    rdp = np.load(tmp_path / "train" / "0_rir_dp_0.npz")["arr"]
    n_pts = len(par["pos_src"][0])
    assert r.dtype == rdp.dtype == np.float16
    assert r.shape[:2] == rdp.shape[:2] == (n_pts, 6) and rdp.shape[2] == int(0.1 * FS)
    want = j_simulate_rir(par["room_sz"], par["pos_src"][0][:1], par["pos_rcv"], par["RT60"],
                          FS, beta=par.get("beta"))
    assert r.shape[2] == want.shape[2]
    # fp16 file: one half-precision step of the largest value on top
    np.testing.assert_allclose(r[0].astype(np.float32), want[0],
                               atol=1e-4 * np.abs(want).max() + 1e-3, rtol=0)


def test_generate_cli_renders_resumes_and_needs_a_device(tmp_path, capsys):
    argv = [f"--rir_dir={tmp_path}", "--spk_num=2", "--noise_num=0", "--rir_nums", "1", "1", "1",
            "--RT60_lim", "0.1", "0.12", "--mic_num=4", "--arr_geometry=circular", "--seed=2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            generate_main(argv)
        assert not any(tmp_path.iterdir())
    generate_main(argv + ["--device", "cpu"])
    files = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.npz"))
    assert files == ["test/2.npz", "train/0.npz", "validation/1.npz"]
    stamp = os.path.getmtime(tmp_path / "train" / "0.npz")
    generate_main(argv + ["--device", "cpu"])  # resumes: nothing rendered again
    assert os.path.getmtime(tmp_path / "train" / "0.npz") == stamp
    # growing the corpus moves room 1 into train, as the JAX generator does
    generate_main(argv[:4] + ["2", "1", "1"] + argv[7:] + ["--device", "cpu"])
    files = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.npz"))
    assert files == ["test/3.npz", "train/0.npz", "train/1.npz", "validation/2.npz"]
    assert "migrated" in capsys.readouterr().out


def test_migrate_splits_is_jax(tmp_path):
    for root in ("port", "jax"):
        for setdir, idxs in {"train": range(0, 8), "validation": range(8, 10),
                             "test": range(10, 12)}.items():
            d = tmp_path / root / setdir
            d.mkdir(parents=True)
            for i in idxs:
                (d / f"{i}.npz").write_bytes(b"x")
        (tmp_path / root / "train" / "3_rir_0.npy").write_bytes(b"x")
    assert migrate_splits(str(tmp_path / "port"), (4, 2, 2)) == \
        j_migrate_splits(str(tmp_path / "jax"), (4, 2, 2))
    assert sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*")) \
        == sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*"))
