"""The port's on-device mixing (data/device_mix.py) against nbss_tpu on the CPU.

The same stage key, seeds and RIRs go through both. Discrete draws (overlap
type, segment lengths and shifts, noise type, room and source picks) must be
equal; waveforms within atol 2e-5 and rtol 1e-4 (float32 FFTs and
transcendental functions of two libraries). Covered: ``fft_convolve``,
``trajectory_windows``/``trajectory_convolve``, ``synth_speech``,
``_sample_overlap``, ``_diffuse_noise`` (white and babble), ``mix_batch`` with
ovlp mid, full and headtail, both noise types, static and moving sources,
and a delay that hits the slice's clamp; the first train and validation
batches of both ``DeviceSyntheticDataModule``s over one corpus rendered by
the JAX generator, with and without the corpus preloaded; and one
``training_step`` loss on that batch with the JAX weights carried over by
``utils/convert.py`` (rtol 1e-4, as tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.data import device_mix as J
from nbss_tpu.data.diffuse import spatial_coherence_mixing_matrices
from nbss_tpu.io import Loss as JLoss
from nbss_tpu.io import Norm as JNorm
from nbss_tpu.io import STFT as JSTFT
from nbss_tpu.models.spatialnet import SpatialNet as JSpatialNet
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu_torch.data import device_mix as P
from nbss_tpu_torch.io import STFT, Loss, Norm
from nbss_tpu_torch.models import SpatialNet
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils import prng
from nbss_tpu_torch.utils.convert import spatialnet_state_dict_from_flax

TOL = dict(atol=2e-5, rtol=1e-4)
FS = 8000


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), **TOL)


def _tk(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _cs(C, pos=None):
    pos = np.stack([np.zeros(C), np.arange(C) * 0.04, np.zeros(C)], -1) if pos is None else pos
    _, Cs = spatial_coherence_mixing_matrices(pos, fs=FS, nfft=256)
    return Cs.real.astype(np.float32), Cs.imag.astype(np.float32)


def _toy_rirs(rng, B, S, C, Lr, Ld, P_=None):
    lead = (B, S) if P_ is None else (B, S, P_)
    rir = (0.2 * rng.standard_normal(lead + (C, Lr))).astype(np.float32)
    rir *= np.exp(-np.arange(Lr) / 60.0).astype(np.float32)
    dp = np.zeros(lead + (C, Ld), np.float32)
    for idx in np.ndindex(*lead):
        d0 = rng.integers(10, 40)
        rir[idx + (slice(None), d0)] = 1.5
        dp[idx + (slice(None), d0)] = 1.0
    return rir, dp


def test_fft_convolve_and_trajectory_convolve_match_jax(rng):
    x = rng.standard_normal((3, 100)).astype(np.float32)
    h = rng.standard_normal((3, 17)).astype(np.float32)
    _close(P.fft_convolve(torch.from_numpy(x), torch.from_numpy(h), 128),
           J.fft_convolve(jnp.asarray(x), jnp.asarray(h), nfft=128))
    T, Pn = 1000, 4
    W = P.trajectory_windows(T, Pn)
    np.testing.assert_array_equal(W, J.trajectory_windows(T, Pn))
    dry = rng.standard_normal((2, T)).astype(np.float32)
    rir = rng.standard_normal((2, Pn, 3, 64)).astype(np.float32)
    _close(P.trajectory_convolve(torch.from_numpy(dry), torch.from_numpy(rir),
                                 torch.from_numpy(W), 2048),
           J.trajectory_convolve(jnp.asarray(dry), jnp.asarray(rir), jnp.asarray(W), 2048))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synth_speech_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = J.synth_speech(key, 8000, FS)
    _close(P.synth_speech(_tk(key), 8000, FS), want)
    keys = jax.random.split(key, 3)  # batched keys draw per key
    _close(P.synth_speech(_tk(keys), 4000, FS),
           jax.vmap(lambda k: J.synth_speech(k, 4000, FS))(keys))


@pytest.mark.parametrize("ovlp", ["mid", "full", "start", "end", "headtail", "hms", "fhms"])
def test_overlap_draws_equal_jax(ovlp):
    keys = jax.random.split(jax.random.PRNGKey(4), 64)
    T = 32000
    lens_j, shifts_j = jax.vmap(lambda k: J._sample_overlap(k, J.OVLP_SET[ovlp], (0.1, 1.0), T))(
        keys)
    lens, shifts = P._sample_overlap(_tk(keys), P.OVLP_SET[ovlp], (0.1, 1.0), T)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(shifts.numpy(), np.asarray(shifts_j))


@pytest.mark.parametrize("babble", [False, True])
def test_diffuse_noise_matches_jax(babble):
    C, T = 4, 4000
    cs_re, cs_im = _cs(C)
    key = jax.random.PRNGKey(3)
    shape = (lambda f: 1.0 / jnp.sqrt(1.0 + (f * (FS / T) / 500.0) ** 2)) if babble else None
    want = J._diffuse_noise(key, C, T, jnp.asarray(cs_re), jnp.asarray(cs_im),
                            JSTFT(n_fft=256, n_hop=64), babble_shape=shape)
    got = P._diffuse_noise(_tk(key), C, T, torch.from_numpy(cs_re), torch.from_numpy(cs_im),
                           STFT(n_fft=256, n_hop=64), babble_fs=FS if babble else None)
    _close(got, want)


def _mix_both(key_seed, seeds, rir, dp, cs, W=None, **kw):
    cs_re, cs_im = cs
    want = J.mix_batch(jax.random.PRNGKey(key_seed), jnp.asarray(seeds, jnp.int32),
                       jnp.asarray(rir), jnp.asarray(dp), jnp.asarray(cs_re), jnp.asarray(cs_im),
                       traj_win=None if W is None else jnp.asarray(W), **kw)
    got = P.mix_batch(prng.PRNGKey(key_seed), torch.tensor(seeds), torch.from_numpy(rir),
                      torch.from_numpy(dp), torch.from_numpy(cs_re), torch.from_numpy(cs_im),
                      traj_win=None if W is None else torch.from_numpy(W), **kw)
    return got, want


@pytest.mark.parametrize("ovlp,noise", [("mid", ("white",)), ("mid", ("babble", "white")),
                                        ("full", ("babble", "white")), ("headtail", ("white",)),
                                        ("fhms", ("babble",))])
def test_mix_batch_static_matches_jax(rng, ovlp, noise):
    B, S, C, T = 2, 2, 4, 8000
    rir, dp = _toy_rirs(rng, B, S, C, 512, 128)
    seeds = [11, 2 ** 31 - 5]
    (x, ys), (xj, ysj) = _mix_both(0, seeds, rir, dp, _cs(C), T=T, fs=FS, rir_len=512,
                                   dp_len=128, ovlp=ovlp, ratio_range=(0.1, 1.0),
                                   sir_range=(-5.0, 5.0), snr_range=(0.0, 20.0),
                                   noise_types=noise)
    assert x.shape == (B, C, T) and ys.shape == (B, S, C, T)
    _close(x, xj)
    _close(ys, ysj)
    d = P.mix_draws(prng.PRNGKey(0), torch.tensor(seeds), ovlp, (0.1, 1.0), T, len(noise))
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(0), s))(
        jnp.asarray(seeds, jnp.int32))
    ks = jax.vmap(lambda k: jax.random.split(k, 6))(keys)
    nt = jax.vmap(lambda k: jax.random.randint(k, (), 0, len(noise)))(ks[:, 3])
    np.testing.assert_array_equal(d["noise_type"].numpy(), np.asarray(nt))


def test_mix_batch_trajectory_matches_jax(rng):
    B, S, Pn, C, T = 2, 2, 4, 3, 4000
    rir, dp = _toy_rirs(rng, B, S, C, 256, 128, P_=Pn)
    W = P.trajectory_windows(T, Pn)
    (x, ys), (xj, ysj) = _mix_both(1, [3, 7], rir, dp, _cs(C), W=W, T=T, fs=FS, rir_len=256,
                                   dp_len=128, ovlp="full", snr_range=(5.0, 30.0),
                                   noise_types=("babble", "white"))
    _close(x, xj)
    _close(ys, ysj)


def test_mix_batch_delay_hits_the_slice_clamp(rng):
    """With nfft = T + 64 and direct paths near 100 samples, the slice start
    is clamped to nfft - T, as jax.lax.dynamic_slice_in_dim clamps it."""
    B, S, C, T = 2, 2, 3, 2000
    rir, dp = _toy_rirs(rng, B, S, C, 256, 128)
    rir[..., 100] = 3.0  # the peak the mixture aligns on
    (x, ys), (xj, ysj) = _mix_both(2, [5, 6], rir, dp, _cs(C), T=T, fs=FS, rir_len=256,
                                   dp_len=128, ovlp="mid", noise_types=("white",),
                                   nfft=T + 64)
    _close(x, xj)
    _close(ys, ysj)


# ------------------------------------------------------------------ data modules
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four small rooms (4 mics, RT60 0.1-0.15) from the JAX generator."""
    from nbss_tpu.sim.config import RirConfigSampler
    from nbss_tpu.sim.generate import generate_rir_files

    root = tmp_path_factory.mktemp("rirs")
    sampler = RirConfigSampler(spk_num=2, noise_num=0, arr_geometry="circular", mic_num=4,
                               fs=FS, RT60_lim=(0.1, 0.15), seed=1)
    generate_rir_files(sampler, str(root), (2, 1, 1), length_round=2048)
    return str(root)


def _modules(corpus, preload):
    kw = dict(rir_dir=corpus, num_spk=2, sample_rate=FS, audio_time_len=(1.0, 1.0, 1.0, 1.0),
              num_items=(4, 2, 2, 2), rir_len=2048, dp_len=1024, batch_size=(2, 2),
              seeds=(5, 2, 3, 3), preload_rir=preload)
    return (J.DeviceSyntheticDataModule(num_workers=0, **kw),
            P.DeviceSyntheticDataModule(device="cpu", **kw))


@pytest.mark.parametrize("preload", [False, True])
def test_first_batches_match_jax(corpus, preload):
    jdm, dm = _modules(corpus, preload)
    for stage in ("train_dataloader", "val_dataloader"):
        xj, ysj, pj = next(iter(getattr(jdm, stage)()))
        x, ys, p = next(iter(getattr(dm, stage)()))
        assert [q["seed"] for q in p] == [q["seed"] for q in pj]
        assert [q["rir_file"] for q in p] == [q["rir_file"] for q in pj]
        assert [q["dataset"] for q in p] == [q["dataset"] for q in pj]
        _close(x, xj)
        _close(ys, ysj)
    t, tj = next(iter(dm.test_dataloader())), next(iter(jdm.test_dataloader()))
    assert isinstance(t[0], np.ndarray)
    _close(t[0], tj[0])


def test_training_step_loss_on_a_device_batch_matches_jax(corpus):
    jdm, dm = _modules(corpus, True)
    xj, ysj, _ = next(iter(jdm.train_dataloader()))
    x, ys, _ = next(iter(dm.train_dataloader()))
    kw = dict(dim_input=8, dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32, num_heads=4,
              kernel_size=(5, 3), conv_groups=(4, 4), dim_squeeze=4, num_freqs=33)
    params = JSpatialNet(**kw, fused_block=False).init(jax.random.PRNGKey(3),
                                                       jnp.zeros((1, 33, 20, 8)))
    net = SpatialNet(**kw, fused_block=False, device="cpu")
    net.load_state_dict(spatialnet_state_dict_from_flax(params, kw["num_layers"]))
    common = dict(channels=(0, 1, 2, 3))
    j_module = JTrainModule(arch=JSpatialNet(**kw, fused_block=False), **common,
                            stft=JSTFT(n_fft=64, n_hop=32), norm=JNorm(mode="frequency"),
                            loss=JLoss("neg_si_sdr", pit=True))
    module = TrainModule(arch=net, **common, stft=STFT(n_fft=64, n_hop=32),
                         norm=Norm(mode="frequency"), loss=Loss("neg_si_sdr", pit=True))
    loss_j = jax.jit(j_module.training_step)(params, (xj, ysj))
    loss = module.training_step((x, ys))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)


def test_data_module_needs_a_device_unless_the_cpu_is_asked(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.DeviceSyntheticDataModule(rir_dir=corpus)
