"""The port's FLOP counter (utils/flops.py) and oracle MVDR beamformer
(eval/beamformer.py) against nbss_tpu on the CPU.

- ``count_flops`` on the tiny SpatialNet of tests/multihost_worker.py (1
  layer, H 16, 2 channels, 1 s): ``params`` equals the JAX count (the leaves
  of the flax tree, as ``nbss_tpu.utils.flops.count_flops`` counts them)
  exactly; the forward FLOPs equal a hand count of the model's matrix
  products and convolutions (2 a multiply-add); the backward counts more
  than half the forward; the kernel routes are off in the counted copy and
  the module's arch is left as it was; ``write_flops`` writes FLOPs.yaml
  with the JAX package's keys.
- ``mvdr`` and its parts against the JAX functions on the same numpy input
  (fp32): the covariance conditioning and MVDR weights to 1e-5, the
  steering vector (normalized to channel 0) and the output to >= 60 dB SNR;
  the oracle-noise and oracle-target beamformers improve SI-SDR by more than
  3 dB on a plane-wave mixture, as tests/test_beamformer.py asks of JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from nbss_tpu.eval import beamformer as jbf
from nbss_tpu.io.stft import STFT as JSTFT
from nbss_tpu_torch.eval import beamformer as bf
from nbss_tpu_torch.io import Loss, Norm, STFT
from nbss_tpu_torch.models import SpatialNet
from nbss_tpu_torch.ops.metrics import si_sdr
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.flops import KERNEL_FLAGS, count_flops, plain_copy, write_flops

KW = dict(dim_input=4, dim_output=4, num_layers=1, dim_hidden=16, dim_ffn=32, num_heads=2,
          kernel_size=(3, 3), conv_groups=(2, 2), dim_squeeze=4, num_freqs=129, full_share=0)
SAMPLES = 8000


@pytest.fixture(scope="module")
def counted():
    net = SpatialNet(**KW, device="cpu")
    module = TrainModule(arch=net, channels=(0, 1), stft=STFT(n_fft=256, n_hop=128),
                         norm=Norm(mode="frequency"), loss=Loss("neg_si_sdr", pit=True))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, SAMPLES),
                                                                  dtype=np.float32))
    return module, x, count_flops(module, x, audio_seconds=1.0)


def _hand_count(T: int) -> int:
    """2 x the multiply-adds of the tiny SpatialNet's products and convs
    for one item of T frames (the STFT, norms and elementwise work aside)."""
    F, H, FF, S, nh = KW["num_freqs"], KW["dim_hidden"], KW["dim_ffn"], KW["dim_squeeze"], 2
    fk, tk = KW["kernel_size"]
    fg, tg = KW["conv_groups"]
    macs = F * T * KW["dim_input"] * H * 5                  # encoder, k = 5 along T
    macs += 2 * F * T * H * (H // fg) * fk                  # fconv1, fconv2 along F
    macs += F * T * H * S + T * S * F * F + F * T * S * H   # squeeze, full band, unsqueeze
    macs += F * T * H * 3 * H                               # in-projection
    macs += 2 * F * nh * T * T * (H // nh)                  # scores and weighted values
    macs += F * T * H * H                                   # out-projection
    macs += F * T * (H * FF + 3 * FF * (FF // tg) * tk + FF * H)  # T-ConvFFN
    macs += F * T * H * KW["dim_output"]                    # decoder
    return 2 * macs


def test_params_equal_the_jax_count(counted):
    """The JAX ``count_flops``'s ``params``: the size of every leaf of the
    flax parameter tree (counted here without its two XLA compiles)."""
    import jax

    from nbss_tpu.models import SpatialNet as JSpatialNet

    params = jax.eval_shape(lambda: JSpatialNet(**KW, fused_block=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 129, 63, 4))))
    assert counted[2]["params"] == sum(p.size for p in jax.tree.leaves(params))


def test_forward_flops_equal_a_hand_count(counted):
    module, x, out = counted
    T = SAMPLES // 128 + 1
    assert out["flops_forward"] == _hand_count(T)
    assert out["flops_forward_avg"] == out["flops_forward"]  # 1 s of audio
    assert out["flops_backward"] > 0.5 * out["flops_forward"]
    assert out["bytes_accessed_forward"] > 4 * x.numel()


def test_count_runs_the_plain_composition_on_a_copy(counted):
    module = counted[0]
    plain = plain_copy(module.arch)
    flags = [(m, f) for m in plain.modules() for f in KERNEL_FLAGS
             if isinstance(getattr(m, f, None), bool)]
    assert flags and not any(getattr(m, f) for m, f in flags)
    assert module.arch.layers[0].fused_block and module.arch.layers[0].mhsa.fused
    for p in module.arch.parameters():
        assert p.grad is None


def test_write_flops_writes_the_jax_keys(counted, tmp_path):
    from nbss_tpu_torch.cli import yamlio

    module, x, _ = counted
    out = write_flops(str(tmp_path), module, x, audio_seconds=1.0)
    assert yamlio.load(str(tmp_path / "FLOPs.yaml")) == out
    assert set(out) == {"flops_forward", "flops_backward", "params", "bytes_accessed_forward",
                        "flops_forward_avg"}


def _scene(seed=0, C=4, T=2 * 8000):
    """A plane-wave target with per-channel delays, directional plus diffuse
    noise at 0.6 of its level (tests/test_beamformer.py's scene)."""
    rng = np.random.default_rng(seed)
    src = lfilter([0.2], [1, -0.8], rng.standard_normal(T)).astype(np.float32)
    target = np.zeros((C, T), np.float32)
    for c in range(C):
        target[c, 3 * c:] = src[:T - 3 * c]
    nsrc = lfilter([0.3], [1, -0.5], rng.standard_normal(T)).astype(np.float32)
    noise = np.zeros((C, T), np.float32)
    for c in range(C):
        d = 11 - 2 * c
        noise[c, d:] = nsrc[:T - d]
    noise += 0.2 * rng.standard_normal((C, T)).astype(np.float32)
    noise *= 0.6 * np.std(target) / np.std(noise)
    return target + noise, noise, target


def _snr_db(got, want) -> float:
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2))


@pytest.mark.parametrize("oracle", ["noise", "target"])
def test_mvdr_matches_jax_and_improves_si_sdr(oracle):
    mixture, noise, target = _scene()
    ref = {oracle: noise if oracle == "noise" else target}
    got = bf.mvdr(torch.from_numpy(mixture), **{k: torch.from_numpy(v) for k, v in ref.items()},
                  stft=STFT(n_fft=512, n_hop=128)).numpy()
    want = np.asarray(jbf.mvdr(jnp.asarray(mixture), **{k: jnp.asarray(v) for k, v in ref.items()},
                               stft=JSTFT(n_fft=512, n_hop=128)))
    assert got.shape == want.shape == (mixture.shape[-1],)
    assert _snr_db(got, want) >= 60.0
    t0 = torch.from_numpy(target[0])[None]
    before = float(si_sdr(torch.from_numpy(mixture[0])[None], t0)[0])
    after = float(si_sdr(torch.from_numpy(got)[None], t0)[0])
    assert after > before + 3, (before, after)


def test_beamformer_parts_match_jax():
    mixture, noise, _ = _scene(seed=1)
    stft, jstft = STFT(n_fft=512, n_hop=128), JSTFT(n_fft=512, n_hop=128)
    X, _ = stft.stft(torch.from_numpy(mixture))
    N, _ = stft.stft(torch.from_numpy(noise))
    JX, _ = jstft.stft(jnp.asarray(mixture))
    JN, _ = jstft.stft(jnp.asarray(noise))
    R = torch.einsum("cft,dft->fcd", X, X.conj()) / X.shape[-1]
    np.testing.assert_allclose(bf.condition_covariance(R, 1e-2).numpy(),
                               np.asarray(jbf.condition_covariance(jnp.asarray(R.numpy()), 1e-2)),
                               rtol=1e-5, atol=1e-6)
    h = bf.estimate_steering_vector(mixture_stft=X, noise_stft=N)
    jh = jbf.estimate_steering_vector(mixture_stft=JX, noise_stft=JN)
    assert h.shape == (257, 4)
    np.testing.assert_allclose(h[:, 0].numpy(), np.ones(257, np.complex64), atol=1e-6)
    assert _snr_db(h.numpy(), np.asarray(jh)) >= 60.0
    w = bf.mvdr_weights(X, torch.from_numpy(np.asarray(jh)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jbf.mvdr_weights(JX, jh)), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="target_stft"):
        bf.estimate_steering_vector(mixture_stft=X)
