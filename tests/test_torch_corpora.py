"""The port's corpus datasets (nbss_tpu_torch/data/) against the JAX package's.

Both packages read the same tiny fixtures, written with the port's
``write_audio`` in each corpus's layout (the fixtures of
tests/test_sms_wsj_plus.py, test_sms_wsj.py, test_chime3_moving.py and
test_more_datasets.py; rooms rendered on the CPU by the port's
``nbss_tpu_torch.sim``). Items are host numpy and scipy in both, so for the
same ``(index, seed)`` they must be equal: mixtures, targets and paras are
held with ``np.testing.assert_array_equal``. Each DataModule's first train
and test batch too, through the threaded loader.
"""

import json
import shutil

import numpy as np
import pytest

from nbss_tpu.data import chime3_moving as jx_chime3
from nbss_tpu.data import libricss as jx_libricss
from nbss_tpu.data import reverb as jx_reverb
from nbss_tpu.data import sms_wsj as jx_sms_wsj
from nbss_tpu.data import sms_wsj_plus as jx_plus
from nbss_tpu.data import spatialized_wsj0_mix as jx_spwsj
from nbss_tpu.data import spk4_wsj0_mix_sp as jx_spk4
from nbss_tpu.data import whamr as jx_whamr
from nbss_tpu_torch.data import chime3_moving, libricss, reverb, sms_wsj, sms_wsj_plus
from nbss_tpu_torch.data import spatialized_wsj0_mix, spk4_wsj0_mix_sp, whamr
from nbss_tpu_torch.sim.config import RirConfigSampler
from nbss_tpu_torch.sim.generate import render_room
from nbss_tpu_torch.utils.audio_io import write_audio

SEEDS = (5, 2, 3, 3)  # fixed stage seeds: the default train seed is drawn afresh


def assert_equal_items(got, want):
    """(mix, targets, paras) of the port equal the JAX package's."""
    assert type(got) is type(want) or (isinstance(got, (list, tuple))
                                       and isinstance(want, (list, tuple))), (got, want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_equal_items(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_equal_items(a, b)
    else:
        assert got == want


def noise(rng, shape, scale=0.1):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def render(root, fs, splits=("train", "validation", "test"), **sampler_kwargs):
    """One room rendered on the CPU by the port's generator, copied to each split."""
    par = RirConfigSampler(RT60_lim=(0.13, 0.16), fs=fs, **sampler_kwargs).sample(0)
    render_room(par, fs, str(root), splits[0], split_trajectory=16, device="cpu")
    for sub in splits[1:]:
        shutil.copytree(root / splits[0], root / sub)
    return str(root)


# ---------------------------------------------------------------- SMS-WSJ-Plus


@pytest.fixture(scope="module")
def plus_corpus(tmp_path_factory):
    """tests/test_sms_wsj_plus.py's fixture: 3 items a split, random rooms."""
    root = tmp_path_factory.mktemp("smswsj_plus")
    fs, rng = 8000, np.random.default_rng(0)
    wsj = root / "sms_wsj"
    (wsj / "wsj_8k_zeromean").mkdir(parents=True)
    info = {"datasets": {d: {} for d in ("train_si284", "cv_dev93", "test_eval92")}}
    for d in info["datasets"]:
        for k in range(3):
            key, srcs = f"{d}_{k}", []
            for s in range(2):
                name = f"wsj_8k_zeromean/{key}_{s}.wav"
                write_audio(str(wsj / name), noise(rng, fs * (2 + k + s)), fs)
                srcs.append(f"/original/sms_wsj/{name}")  # the json's own absolute paths
            info["datasets"][d][key] = {"audio_path": {"original_source": srcs}}
    (wsj / "sms_wsj.json").write_text(json.dumps(info))
    rirs = root / "rirs"
    for sub in ("train", "validation", "test"):
        (rirs / sub).mkdir(parents=True)
        for r in range(2):
            rir = noise(rng, (3, 4, 800), 0.02)
            rir[:, :, 40] = 1.0
            rir_dp = np.zeros_like(rir)
            rir_dp[:, :, 40] = 1.0
            pos_rcv = np.stack([np.zeros(4), np.arange(4) * 0.05, np.full(4, 1.5)], -1)
            np.savez(rirs / sub / f"rir_{r}.npz", fs=fs, RT60=0.3, rir=rir, rir_dp=rir_dp,
                     pos_src=rng.uniform(0, 5, (3, 3)), pos_rcv=pos_rcv)
    return str(wsj), str(rirs)


@pytest.mark.parametrize("target,dataset,ovlp,noise_type,atl", [
    ("direct_path", "train_si284", "mid", ("white",), 2.0),
    ("revb_image", "train_si284", "full", ("babble",), 2.0),
    ("RTS_0.1s", "cv_dev93", "headtail", ("babble", "white"), 1.0),
    ("direct_path", "test_eval92", "mid", ("babble", "white"), None),
])
def test_sms_wsj_plus_items(plus_corpus, target, dataset, ovlp, noise_type, atl):
    wsj, rirs = plus_corpus
    kw = dict(sms_wsj_dir=wsj, rir_dir=rirs, target=target, dataset=dataset, ovlp=ovlp,
              audio_time_len=atl, snr=(10, 20), noise_type=noise_type)
    port, ref = sms_wsj_plus.SmsWsjPlusDataset(**kw), jx_plus.SmsWsjPlusDataset(**kw)
    assert port.rirs == ref.rirs and port.noises == ref.noises
    np.testing.assert_array_equal(port.Cs, ref.Cs)
    for index, seed in ((0, 123), (2, 7), (1, 2 ** 62 + 11)):
        assert_equal_items(port[(index, seed)], ref[(index, seed)])


def test_sms_wsj_plus_datamodule(plus_corpus):
    wsj, rirs = plus_corpus
    kw = dict(sms_wsj_dir=wsj, rir_dir=rirs, audio_time_len=(1.0, 1.0, None, None),
              batch_size=(2, 1), seeds=SEEDS)
    port = sms_wsj_plus.SmsWsjPlusDataModule(**kw)
    ref = jx_plus.SmsWsjPlusDataModule(**kw, num_replicas=1, rank=0)
    assert port.num_workers == ref.num_workers == 2
    for stage in ("train_dataloader", "test_dataloader"):
        got, want = next(iter(getattr(port, stage)())), next(iter(getattr(ref, stage)()))
        assert_equal_items(got, want)
    assert got[0].shape[0] == 1  # whole utterances at batch 1


def test_sms_wsj_plus_writes_and_reads_its_diffuse_cache(plus_corpus, tmp_path):
    wsj, rirs = plus_corpus
    copy = tmp_path / "rirs"
    shutil.copytree(rirs, copy, ignore=shutil.ignore_patterns("diffuse.npz"))
    port = sms_wsj_plus.SmsWsjPlusDataset(sms_wsj_dir=wsj, rir_dir=str(copy),
                                          target="direct_path", dataset="cv_dev93", ovlp="mid")
    cached = np.load(copy / "diffuse.npz", allow_pickle=True)["Cs"]
    np.testing.assert_array_equal(cached, port.Cs)
    ref = jx_plus.SmsWsjPlusDataset(sms_wsj_dir=wsj, rir_dir=str(copy), target="direct_path",
                                    dataset="cv_dev93", ovlp="mid")
    np.testing.assert_array_equal(ref.Cs, port.Cs)


# ---------------------------------------------------------------- SMS-WSJ


@pytest.fixture(scope="module")
def sms_corpus(tmp_path_factory):
    """tests/test_sms_wsj.py's fixture (observations rendered by the JAX
    package's scenario_map), plus 'tail' files for 'image-from-file'."""
    root = tmp_path_factory.mktemp("smswsj_official")
    fs, rng, ds = 8000, np.random.default_rng(0), "cv_dev93"
    info = {"datasets": {ds: {}}}
    for sub in ("wsj_8k_zeromean", f"rirs/{ds}", f"rirs_direct_path/{ds}", f"observation/{ds}",
                f"early/{ds}", f"tail/{ds}"):
        (root / sub).mkdir(parents=True)
    for k in range(2):
        eid = f"ex_{k}"
        srcs, rirs, dps, src_paths, rir_paths = [], [], [], [], []
        lens, offsets = [fs * 2, fs * 2 - 777], [0, 500]
        for s in range(2):
            wav = rng.standard_normal(lens[s]) * 0.1
            p = f"wsj_8k_zeromean/{eid}_{s}.wav"
            write_audio(str(root / p), wav.astype(np.float32), fs)
            srcs.append(wav)
            src_paths.append(f"/original/{p}")
            rir = np.zeros((6, 800))
            d = 40 + s * 7
            rir[:, d] = 1.0
            rir[:, d + 50:] += rng.standard_normal((6, 750 - d)) * 0.05 * np.exp(
                -np.arange(750 - d) / 300)
            rp = f"rirs/{ds}/{eid}_{s}.wav"
            write_audio(str(root / rp), rir.T.astype(np.float32), fs)
            rirs.append(rir)
            rir_paths.append(f"/original/{rp}")
            dp = np.zeros_like(rir)
            dp[:, d] = 1.0
            write_audio(str(root / f"rirs_direct_path/{ds}/{eid}_{s}.wav"),
                        dp.T.astype(np.float32), fs)
            dps.append(dp)
        ex = {"example_id": eid, "num_speakers": 2, "log_weights": [0.8, -0.8],
              "offset": offsets, "sound_decay_time": 0.25,
              "num_samples": {"observation": max(l + o for l, o in zip(lens, offsets)),
                              "original_source": lens},
              "audio_path": {"original_source": src_paths, "rir": rir_paths}}
        work = dict(ex, audio_data={"original_source": [s.copy() for s in srcs],
                                    "rir": np.stack(rirs)})
        work = jx_sms_wsj.scenario_map(work, rir_target=np.stack(dps))
        write_audio(str(root / "observation" / ds / f"{eid}.wav"),
                    work["audio_data"]["observation"].T.astype(np.float32), fs)
        for s in range(2):
            early = work["audio_data"]["speech_target"][s]
            write_audio(str(root / "early" / ds / f"{eid}_{s}.wav"), early.T.astype(np.float32), fs)
            write_audio(str(root / "tail" / ds / f"{eid}_{s}.wav"),
                        (0.1 * early).T.astype(np.float32), fs)
        info["datasets"][ds][eid] = ex
    (root / "sms_wsj.json").write_text(json.dumps(info))
    return str(root), ds


def test_sms_wsj_helpers():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 3, 200)) * np.exp(-np.arange(200) / 30)
    assert sms_wsj.rir_start_sample(h) == jx_sms_wsj.rir_start_sample(h)
    assert sms_wsj.rir_start_sample(h[0, 1], 0.3) == jx_sms_wsj.rir_start_sample(h[0, 1], 0.3)
    a, b = sms_wsj.example_id_rng("ex_0"), jx_sms_wsj.example_id_rng("ex_0")
    np.testing.assert_array_equal(a.normal(size=8), b.normal(size=8))
    x = np.arange(20.0).reshape(2, 10)
    for off, n in ((3, 8), (-4, 5), (0, 12)):
        np.testing.assert_array_equal(sms_wsj.extract_piece(x, off, n),
                                      jx_sms_wsj.extract_piece(x, off, n))
    sig = rng.standard_normal((6, 400))
    np.testing.assert_array_equal(
        sms_wsj.white_noise_for_signal(sig, 25.0, sms_wsj.example_id_rng("e")),
        jx_sms_wsj.white_noise_for_signal(sig, 25.0, jx_sms_wsj.example_id_rng("e")))


@pytest.mark.parametrize("target,atl", [
    ("direct_path", None), ("direct_path", 1.0), ("direct_path", 3.0), ("image", None),
    ("RTS_0.1s", None), ("direct_path_2ms", 1.0), ("early", 1.0), ("image-from-file", None)])
def test_sms_wsj_items(sms_corpus, target, atl):
    root, ds = sms_corpus
    kw = dict(sms_wsj_dir=root, target=target, dataset=ds, audio_time_len=atl)
    port, ref = sms_wsj.SmsWsjDataset(**kw), jx_sms_wsj.SmsWsjDataset(**kw)
    for index_seed in ((0, 5), (1, 9), 1):
        assert_equal_items(port[index_seed], ref[index_seed])


def test_sms_wsj_regeneration_and_datamodule(sms_corpus):
    root, ds = sms_corpus
    port = sms_wsj.SmsWsjDataset(sms_wsj_dir=root, target="direct_path", dataset=ds,
                                 check_regenerated=True)
    port[(0, 5)]  # the observation regenerated from sources and RIRs equals the file's
    kw = dict(sms_wsj_dir=root, datasets=(ds, ds, ds, ds), audio_time_len=(1.0, 1.0, None),
              batch_size=(2, 1), seeds=SEEDS)
    port_dm = sms_wsj.SmsWsjDataModule(**kw)
    ref_dm = jx_sms_wsj.SmsWsjDataModule(**kw, num_replicas=1, rank=0)
    for stage in ("train_dataloader", "test_dataloader"):
        assert_equal_items(next(iter(getattr(port_dm, stage)())),
                           next(iter(getattr(ref_dm, stage)())))


# ---------------------------------------------------------------- WSJ0-mix readers


@pytest.fixture(scope="module")
def wsj0mix_corpus(tmp_path_factory):
    """Spatialized WSJ0-2mix (8 channels, as the corpus) and WHAMR! (2 channels)."""
    root = tmp_path_factory.mktemp("wsj0mix")
    rng = np.random.default_rng(1)
    for split in ("tr", "cv", "tt"):
        for n, name in enumerate(("u0.wav", "u1.wav")):
            frames = 4000 + 3000 * n
            for target in ("anechoic", "reverb"):
                d = root / "spwsj" / f"2speakers_{target}" / "wav8k" / "min" / split
                for sub in ("mix", "s1", "s2"):
                    (d / sub).mkdir(parents=True, exist_ok=True)
                    write_audio(str(d / sub / name), noise(rng, (frames, 8)), 8000)
            d = root / "whamr" / "wav8k" / "min" / split
            for sub in ("mix_both_reverb", "s1_anechoic", "s2_anechoic", "s1_reverb",
                        "s2_reverb"):
                (d / sub).mkdir(parents=True, exist_ok=True)
                write_audio(str(d / sub / name), noise(rng, (frames, 2)), 8000)
    return root


@pytest.mark.parametrize("target", ["anechoic", "reverb"])
@pytest.mark.parametrize("atl", [None, 0.4, 0.7])
def test_wsj0mix_reader_items(wsj0mix_corpus, target, atl):
    root = wsj0mix_corpus
    sp_kw = dict(sp_wsj0_dir=str(root / "spwsj"), dataset="tr", target=target,
                 audio_time_len=atl)
    wh_kw = dict(whamr_dir=str(root / "whamr"), dataset="cv", target=target, audio_time_len=atl)
    pairs = ((spatialized_wsj0_mix.SpatializedWSJMixDataset(**sp_kw),
              jx_spwsj.SpatializedWSJMixDataset(**sp_kw)),
             (whamr.WHAMRDataset(**wh_kw), jx_whamr.WHAMRDataset(**wh_kw)))
    for port, ref in pairs:
        for index_seed in ((0, 4), (1, 17)):
            got = port[index_seed]
            assert_equal_items(got, ref[index_seed])
    assert pairs[0][0][(1, 3)][0].shape[0] == 8


def test_wsj0mix_datamodules(wsj0mix_corpus):
    kw = dict(audio_time_len=(0.5, 0.5, None), batch_size=(2, 1), seeds=SEEDS)
    for port_cls, ref_cls, path in (
            (spatialized_wsj0_mix.SpatializedWSJ0MixDataModule,
             jx_spwsj.SpatializedWSJ0MixDataModule, {"sp_wsj0_dir": "spwsj"}),
            (whamr.WHAMRDataModule, jx_whamr.WHAMRDataModule, {"whamr_dir": "whamr"})):
        paths = {k: str(wsj0mix_corpus / v) for k, v in path.items()}
        port = port_cls(**kw, **paths)
        ref = ref_cls(**kw, **paths, num_replicas=1, rank=0)
        for stage in ("train_dataloader", "test_dataloader"):
            assert_equal_items(next(iter(getattr(port, stage)())),
                               next(iter(getattr(ref, stage)())))


# ---------------------------------------------------------------- CHiME3-moving


@pytest.fixture(scope="module")
def chime3_corpus(tmp_path_factory):
    """tests/test_chime3_moving.py's layout: wsj0 speakers, six 16-kHz
    backgrounds, one single-speaker moving room and its rir_cfg.npz; a second
    room directory without rir_cfg.npz (the 0.05 m fallback)."""
    root = tmp_path_factory.mktemp("chime3")
    rng = np.random.default_rng(0)
    for sub, spks in (("si_tr_s", ["011", "012"]), ("si_dt_05", ["020"]),
                      ("si_et_05", ["030"])):
        for spk in spks:
            d = root / "wsj0" / sub / spk
            d.mkdir(parents=True)
            for u in range(2):
                write_audio(str(d / f"{spk}x{u}.wav"), noise(rng, 8000 + 3000 * u), 8000)
    bg = root / "CHiME3" / "data" / "audio" / "16kHz" / "backgrounds"
    bg.mkdir(parents=True)
    for ch in range(1, 7):
        write_audio(str(bg / f"BGD_CAF.CH{ch}.wav"), noise(rng, 16000 * 12, 0.05), 16000)
    rirs = render(root / "rirs", 8000, spk_num=1, noise_num=0, mic_num=6, seed=11,
                  trajectory=("4points+sin", 0.7))
    shutil.copytree(rirs, root / "rirs_nocfg")
    np.savez(root / "rirs" / "rir_cfg.npz",
             args=np.array({"trajectory": ("4points+sin", 0.1)}, dtype=object))
    return root


@pytest.mark.parametrize("dataset,target,atl", [
    ("train_moving(0.5,1.0)", "direct_path", 1.0),
    ("train_moving(0.12,0.4,0.5)", "revb_image", 1.0),
    ("val", "revb_image", 1.0),
    ("test_moving(0.5,1.0)", "direct_path", None),
])
@pytest.mark.parametrize("rirs", ["rirs", "rirs_nocfg"])
def test_chime3_moving_items(chime3_corpus, dataset, target, atl, rirs):
    root = chime3_corpus
    kw = dict(wsj0_dir=str(root / "wsj0"), chime3_dir=str(root / "CHiME3"),
              rir_dir=str(root / rirs), target=target, dataset=dataset, audio_time_len=atl)
    port, ref = chime3_moving.CHiME3MovingDataset(**kw), jx_chime3.CHiME3MovingDataset(**kw)
    assert port.adjacent_points_distance == ref.adjacent_points_distance
    moving = set()
    for index_seed in ((0, 42), (1, 7), (3, 2 ** 40 + 1)):
        got = port[index_seed]
        assert_equal_items(got, ref[index_seed])
        moving.add(got[2]["moving"])
    if dataset.startswith("val"):
        assert moving == {False}  # static items cut from a trajectory
    elif "(0.5,1.0)" in dataset:
        assert moving == {True}


def test_chime3_moving_datamodule(chime3_corpus):
    root = chime3_corpus
    kw = dict(wsj0_dir=str(root / "wsj0"), chime3_dir=str(root / "CHiME3"),
              rir_dir=str(root / "rirs"), audio_time_len=(1.0, 1.0, 2.0, 2.0),
              batch_size=(2, 2), seeds=SEEDS)
    port = chime3_moving.CHiME3MovingDataModule(**kw)
    ref = jx_chime3.CHiME3MovingDataModule(**kw, num_replicas=1, rank=0)
    for stage in ("train_dataloader", "test_dataloader"):
        assert_equal_items(next(iter(getattr(port, stage)())), next(iter(getattr(ref, stage)())))


# ---------------------------------------------------------------- LibriCSS


@pytest.fixture(scope="module")
def libricss_corpus(tmp_path_factory):
    """tests/test_more_datasets.py's LibriSpeech layout and a 3-speaker
    LibriCSS-array room at 16 kHz, plus real-set utterances."""
    root = tmp_path_factory.mktemp("libricss")
    rng = np.random.default_rng(2)
    for sub in ("train-clean-100", "dev-clean", "test-clean"):
        d = root / "librispeech" / sub / "19" / "198"
        d.mkdir(parents=True)
        for u in range(3):
            write_audio(str(d / f"19-198-{u:04d}.wav"), noise(rng, 16000 + 4000 * u), 16000)
    (root / "noise").mkdir()
    write_audio(str(root / "noise" / "n0.wav"), noise(rng, (16000 * 4, 2), 0.05), 16000)
    rirs = render(root / "rirs", 16000, spk_num=3, noise_num=0, arr_geometry="libricss", seed=1)
    real = root / "libricss" / "exp" / "data" / "7ch" / "utterances"
    for session in ("session0", "session1"):
        (real / session).mkdir(parents=True)
        write_audio(str(real / session / "u0.wav"), noise(rng, (12000, 7)), 16000)
    (real / "utterance_transcription.txt").write_text("session0_u0\tHELLO WORLD\n")
    return root, rirs


@pytest.mark.parametrize("spk1_prob,spk2_prob", [(0.0, 1.0), (0.0, 0.0), (1.0, 0.0),
                                                 (0.1, 0.7)])
def test_libricss_sim_items(libricss_corpus, spk1_prob, spk2_prob):
    root, rirs = libricss_corpus
    kw = dict(librispeech_dir=str(root / "librispeech"), rir_dir=rirs,
              noise_dir=str(root / "noise"), dataset="SimTrain", audio_time_len=1.0,
              spk1_prob=spk1_prob, spk2_prob=spk2_prob)
    port, ref = libricss.LibriCSSDataset(**kw), jx_libricss.LibriCSSDataset(**kw)
    np.testing.assert_array_equal(port.Cs, ref.Cs)
    for index_seed in ((0, 3), (1, 11), (2, 13)):
        got = port[index_seed]
        assert_equal_items(got, ref[index_seed])
        assert got[0].shape == (7, 16000) and got[1].shape[0] == 2


def test_libricss_real_set_and_datamodule(libricss_corpus):
    root, rirs = libricss_corpus
    for dataset in ("utterances", "utterances/session0"):
        kw = dict(libricss_dir=str(root / "libricss"), dataset=dataset)
        port, ref = libricss.LibriCSSDataset(**kw), jx_libricss.LibriCSSDataset(**kw)
        assert len(port) == len(ref) == (1 if "session0" in dataset else 2)
        for i in range(len(port)):
            assert_equal_items(port[(i, 0)], ref[(i, 0)])
    kw = dict(libricss_dir=str(root / "libricss"), librispeech_dir=str(root / "librispeech"),
              rir_dir=rirs, noise_dir=str(root / "noise"), batch_size=(2, 1), seeds=SEEDS,
              audio_time_len=(1.0, 1.0, 1.0, None))  # 3-speaker items need a length
    port = libricss.LibriCSSDataModule(**kw)
    ref = jx_libricss.LibriCSSDataModule(**kw, num_replicas=1, rank=0)
    for stage in ("train_dataloader", "test_dataloader"):
        assert_equal_items(next(iter(getattr(port, stage)())), next(iter(getattr(ref, stage)())))


def test_libricss_array_geometry():
    from nbss_tpu.data.geometry import libricss_array as jx_array
    from nbss_tpu_torch.data.geometry import libricss_array

    np.testing.assert_array_equal(libricss_array(), jx_array())


# ---------------------------------------------------------------- 4-speaker WSJ0 pairs


@pytest.fixture(scope="module")
def spk4_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("spk4")
    rng = np.random.default_rng(4)
    for spk in ("s1", "s2", "s3", "s4"):
        d = root / "wsj0" / "si_tr_s" / spk
        d.mkdir(parents=True)
        for u in range(3):  # the third is under min_duration and left out
            frames = 16000 * (5 - u) if u < 2 else 16000
            write_audio(str(d / f"{spk}u{u}.wav"), noise(rng, frames), 16000)
    (root / "rirs4").mkdir()
    rir = np.zeros((2, 4, 400), np.float32)
    rir[:, :, 50] = 1.0
    rir[:, :, 60:] += noise(rng, (2, 4, 340), 0.01)
    np.savez(root / "rirs4" / "r0.npz", speech_rir=rir, sr=16000)
    return root


def test_spk4_pairs_and_items(spk4_corpus):
    root = spk4_corpus
    spks = ("si_tr_s/s1", "si_tr_s/s2", "si_tr_s/s3", "si_tr_s/s4")
    for spk in spks:
        assert spk4_wsj0_mix_sp.get_clean_wavs(spk, 4.0, str(root / "wsj0")) == \
            jx_spk4.get_clean_wavs(spk, 4.0, str(root / "wsj0"))
    assert spk4_wsj0_mix_sp.gen_pairs(["a", "b", "c"], ["x", "y"]) == \
        jx_spk4.gen_pairs(["a", "b", "c"], ["x", "y"])
    kw = dict(spks=spks, wsj0_dir=str(root / "wsj0"), rir_dir=str(root / "rirs4"))
    port, ref = spk4_wsj0_mix_sp.Spk4Wsj0MixSpDataset(**kw), jx_spk4.Spk4Wsj0MixSpDataset(**kw)
    assert port.pairs == ref.pairs and len(port) == 24
    for atl in ("nmix 2", "mix 2", "mix3 2", "all-mix 2", "frontend 2", "mid 2", "headtail 2",
                "min", "max", 2.0):
        port.audio_time_len = ref.audio_time_len = atl
        for index in ({"speech_index": 0, "rir_index": 0, "seed": 5},
                      {"speech_index": 3, "rir_index": 1, "seed": 9}):
            assert_equal_items(port[index], ref[index])


def test_spk4_datamodule(spk4_corpus):
    root = spk4_corpus
    kw = dict(spks=("si_tr_s/s1", "si_tr_s/s2", "si_tr_s/s3", "si_tr_s/s4"),
              wsj0_dir=str(root / "wsj0"), rir_dir=str(root / "rirs4"),
              audio_time_len="nmix 2", batch_size=(2, 1), seeds=SEEDS)
    port = spk4_wsj0_mix_sp.Spk4Wsj0MixSpDataModule(**kw)
    ref = jx_spk4.Spk4Wsj0MixSpDataModule(**kw, num_replicas=1, rank=0)
    for stage in ("train_dataloader", "test_dataloader"):
        assert_equal_items(next(iter(getattr(port, stage)())), next(iter(getattr(ref, stage)())))


# ---------------------------------------------------------------- REVERB


@pytest.fixture(scope="module")
def reverb_corpus(tmp_path_factory, libricss_corpus):
    """test_more_datasets.py's REVERB layouts: WSJCAM0 sources, the train
    and SimData tools (noise of each room size, measured RIRs) and the
    released real evaluation set; the simulated RIRs are the LibriCSS room."""
    root = tmp_path_factory.mktemp("reverb")
    rng = np.random.default_rng(5)
    for sub in ("si_tr", "si_dt", "si_et"):
        d = root / "wsjcam0" / "data" / "primary_microphone" / sub
        d.mkdir(parents=True)
        for u in range(2):
            write_audio(str(d / f"c0{sub[-1]}{u}.wav"), noise(rng, 16000 + 5000 * u), 16000)
    tools = root / "Reverb" / "reverb_tools_for_Generate_mcTrainData"
    (tools / "NOISE").mkdir(parents=True)
    (tools / "RIR").mkdir()
    for room in ("SmallRoom1", "MediumRoom1", "LargeRoom1"):
        write_audio(str(tools / "NOISE" / f"Noise_{room}_1.wav"),
                    noise(rng, (16000 * 3, 7), 0.05), 16000)
    rir = np.zeros((3200, 7), np.float32)
    rir[100 + np.arange(7) % 3, np.arange(7)] = 1.0
    rir[500:800:50, :] = 0.2
    write_audio(str(tools / "RIR" / "RIR_SmallRoom1_near_AnglA.wav"), rir, 16000)
    sim = root / "Reverb" / "reverb_tools_for_Generate_SimData"
    (sim / "NOISE").mkdir(parents=True)
    (sim / "RIR").mkdir()
    write_audio(str(sim / "NOISE" / "Noise_SimRoom1_1.wav"), noise(rng, (16000 * 3, 8), 0.05),
                16000)
    rir8 = np.zeros((3200, 8), np.float32)
    rir8[100, :] = 1.0
    rir8[400:900:70, :] = 0.1
    for name in ("near_AnglA", "far_AnglA", "near_AnglB", "far_AnglB"):
        write_audio(str(sim / "RIR" / f"RIR_SimRoom1_{name}.wav"), rir8, 16000)
    et = root / "Reverb" / "MC_WSJ_AV_Eval" / "audio"
    et.mkdir(parents=True)
    write_audio(str(et / "T1.wav"), noise(rng, (16000, 8)), 16000)
    return root, libricss_corpus[1]


def test_reverb_gen_obs():
    rng = np.random.default_rng(6)
    x, RIR, NOISE = rng.standard_normal(16000), np.zeros((1600, 2)), rng.standard_normal((32000, 2))
    RIR[100, :] = 1.0
    RIR[300:900:40, :] = 0.05
    np.testing.assert_array_equal(reverb.gen_obs(x, RIR, NOISE, 10.0),
                                  jx_reverb.gen_obs(x, RIR, NOISE, 10.0))


@pytest.mark.parametrize("dataset,target,real_rir,room_match", [
    ("train_with_simulated_rir", "direct_path", 0.0, False),
    ("train_with_simulated_rir", "dry_source", 0.0, True),
    ("train_with_simulated_rir", "direct_path", 1.0, True),
    ("val_with_simulated_rir", "direct_path", 0.0, False),
])
def test_reverb_trainval_items(reverb_corpus, dataset, target, real_rir, room_match):
    root, rirs = reverb_corpus
    kw = dict(wsjcam0_dir=str(root / "wsjcam0"), reverb_dir=str(root / "Reverb"),
              dataset=dataset, rir_dir=rirs, audio_time_len=1.0, target=target,
              use_real_rir_prop=real_rir, noise_room_match=room_match)
    port, ref = reverb.ReverbTrainValDataset(**kw), jx_reverb.ReverbTrainValDataset(**kw)
    for index_seed in ((0, 17), (1, 5)):
        assert_equal_items(port[index_seed], ref[index_seed])


@pytest.mark.parametrize("dataset", ["SimDtMC", "SimEtMC"])
def test_reverb_simdtet_and_et(reverb_corpus, dataset):
    root, _ = reverb_corpus
    kw = dict(wsjcam0_dir=str(root / "wsjcam0"), reverb_dir=str(root / "Reverb"),
              dataset=dataset)
    port, ref = reverb.ReverbSimDtEtMCDataset(**kw), jx_reverb.ReverbSimDtEtMCDataset(**kw)
    assert len(port) == len(ref) == 4
    for index_seed in ((1, 9), 2):
        assert_equal_items(port[index_seed], ref[index_seed])
    port = reverb.ReverbEtDataset(reverb_dir=str(root / "Reverb"), dataset="Et_real")
    ref = jx_reverb.ReverbEtDataset(reverb_dir=str(root / "Reverb"), dataset="Et_real")
    assert_equal_items(port[(0, 0)], ref[(0, 0)])


@pytest.mark.parametrize("test_set", ["Et_real", "SimDtMC"])
def test_reverb_datamodule(reverb_corpus, test_set):
    root, rirs = reverb_corpus
    kw = dict(wsjcam0_dir=str(root / "wsjcam0"), reverb_dir=str(root / "Reverb"), rir_dir=rirs,
              audio_time_len=(1.0, 1.0, None, None), batch_size=(2, 1), seeds=SEEDS,
              test_set=test_set)
    port = reverb.ReverbDataModule(**kw)
    ref = jx_reverb.ReverbDataModule(**kw, num_replicas=1, rank=0)
    for stage in ("train_dataloader", "test_dataloader"):
        assert_equal_items(next(iter(getattr(port, stage)())), next(iter(getattr(ref, stage)())))
