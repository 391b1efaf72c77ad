"""The port's SpatialNet and TrainModule against nbss_tpu on the CPU.

A small SpatialNet (2 layers, F=9, T=20, H=16) with the JAX package's
weights carried over by utils/convert.py. The JAX fused block runs its Pallas
kernel in interpret mode; with it off, the JAX package runs the plain module
composition, and so does the port with ``fused_block=False``. Arch outputs
agree at atol 2e-4, rtol 1e-4 (the JAX package's kernel bounds); waveforms at
SI-SDR >= 60 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.io import Loss as JLoss
from nbss_tpu.io import Norm as JNorm
from nbss_tpu.io import STFT as JSTFT
from nbss_tpu.models.spatialnet import SpatialNet as JSpatialNet
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.ops import attention_block as ab
from nbss_tpu_torch.ops.metrics import si_sdr
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import spatialnet_state_dict_from_flax

N_FFT, HOP = 16, 8
KW = dict(dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32, num_heads=4,
          kernel_size=(5, 3), conv_groups=(4, 4), dim_squeeze=4, num_freqs=N_FFT // 2 + 1,
          full_share=0)


def _pair(fused, dim_input):
    j_net = JSpatialNet(dim_input=dim_input, **KW, fused_block=fused)
    params = JSpatialNet(dim_input=dim_input, **KW, fused_block=False).init(
        jax.random.PRNGKey(3), jnp.zeros((1, KW["num_freqs"], 20, dim_input)))
    net = SpatialNet(dim_input=dim_input, **KW, fused_block=fused, device="cpu")
    net.load_state_dict(spatialnet_state_dict_from_flax(params, KW["num_layers"]))
    return j_net, params, net


@pytest.mark.parametrize("fused", [True, False])
def test_arch_matches_jax(rng, fused):
    j_net, params, net = _pair(fused, dim_input=6)
    x = rng.standard_normal((2, KW["num_freqs"], 20, 6)).astype(np.float32)
    want = np.asarray(j_net.apply(params, jnp.asarray(x)))
    before = ab.launches
    got = net(torch.from_numpy(x)).detach().numpy()
    assert ab.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_forward_and_predict_step_match_jax(rng, fused):
    j_net, params, net = _pair(fused, dim_input=12)
    j_module = JTrainModule(arch=j_net, stft=JSTFT(n_fft=N_FFT, n_hop=HOP),
                            norm=JNorm(mode="frequency"), loss=JLoss("neg_si_sdr", pit=True))
    module = TrainModule(arch=net, stft=STFT(n_fft=N_FFT, n_hop=HOP),
                         norm=Norm(mode="frequency"), loss=Loss("neg_si_sdr", pit=True))
    x = rng.standard_normal((2, 6, HOP * 19)).astype(np.float32)
    yr = rng.standard_normal((2, 2, HOP * 19)).astype(np.float32)

    y, paras = module.forward(torch.from_numpy(x))
    y_j, _ = j_module.forward(params, jnp.asarray(x))
    y_j = torch.from_numpy(np.array(y_j))
    assert y.shape == y_j.shape == (2, 2, HOP * 19)
    assert si_sdr(y, y_j).min() >= 60.0
    assert set(paras) == {"out", "Xr", "stft", "XrMM"}

    pred = module.predict_step(torch.from_numpy(x), torch.from_numpy(yr))
    pred_j = np.asarray(j_module.predict_step(params, jnp.asarray(x), jnp.asarray(yr)))
    np.testing.assert_allclose(pred.numpy(), pred_j, atol=2e-5, rtol=1e-4)

    ys = np.repeat(yr[:, :, None], 6, axis=2)
    got = module.test_step((torch.from_numpy(x), torch.from_numpy(ys)))
    want = j_module.test_step(params, (jnp.asarray(x), jnp.asarray(ys)))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["yr_hat"].numpy(), np.asarray(want["yr_hat"]),
                               atol=2e-5, rtol=1e-4)


def test_bf16_network_stays_close_to_fp32(rng):
    """The bf16 compute dtype keeps parameters in float32 and returns float32."""
    _, _, net = _pair(True, dim_input=6)
    net_bf16 = SpatialNet(dim_input=6, **KW, dtype=torch.bfloat16, device="cpu")
    net_bf16.load_state_dict(net.state_dict())
    assert all(p.dtype == torch.float32 for p in net_bf16.parameters())
    x = torch.from_numpy(rng.standard_normal((1, KW["num_freqs"], 20, 6)).astype(np.float32))
    y32, y16 = net(x).detach(), net_bf16(x).detach()
    assert y16.dtype == torch.float32
    assert (y16 - y32).abs().max() <= 0.1 * y32.abs().max()


def _mha_before_masks(mha, x):
    """MultiheadAttention.forward as the port had it before attention masks
    and the fused path: the einsum composition, float32 scores and softmax."""
    import math

    import torch.nn.functional as F

    *lead, T, H = x.shape
    nh = mha.num_heads
    dh = H // nh
    qkv = F.linear(x, mha.in_proj_weight.to(x.dtype), mha.in_proj_bias.to(x.dtype))
    q, k, v = (t.reshape(*lead, T, nh, dh).float() for t in qkv.chunk(3, dim=-1))
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(dh)
    probs = torch.softmax(logits, dim=-1).to(x.dtype).float()
    out = torch.einsum("...hqk,...khd->...qhd", probs, v).to(x.dtype)
    return mha.out_proj(out.reshape(*lead, T, H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfused_paths_are_unchanged_by_attention_masks(rng, dtype, monkeypatch):
    """Regression guard: MultiheadAttention(fused=False) and SpatialNet with
    fused_block=False give, bit for bit, what the einsum composition gave
    before the mask and fused options existed, from the same weights."""
    from nbss_tpu_torch.models.base import MultiheadAttention

    mha = MultiheadAttention(16, 4, fused=False, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((2, 3, 20, 16)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        assert torch.equal(mha(x), _mha_before_masks(mha, x))
    _, _, net = _pair(False, dim_input=6)
    net.dtype = dtype
    x = torch.from_numpy(rng.standard_normal((2, KW["num_freqs"], 20, 6)).astype(np.float32))
    with torch.no_grad():
        y = net(x)
        assert not any(layer.mhsa.fused for layer in net.layers)
        monkeypatch.setattr(MultiheadAttention, "forward", _mha_before_masks)
        assert torch.equal(y, net(x))
