"""The port's T-ConvFFN (ops/tconvffn.py and SpatialNet(fused_ffn=True))
against nbss_tpu on the CPU.

``reference`` (the path a CPU tensor takes) is held against the JAX package's
``fused_tconvffn``, whose Pallas kernel runs in interpret mode on the CPU as
the JAX tests run it, and ``reference_xla`` against ``_ref_tconvffn``. The
JAX functions are compiled with XLA's ``xla_allow_excess_precision`` off, so
that XLA rounds each bf16 step as the Pallas kernel writes it; the port takes
grouped weights in torch layout, the JAX kernel their block-diagonal dense
expansion. Inputs are made from a seed with numpy and handed to both.

Bounds: the forward in float32 at atol 2e-4, rtol 1e-4 (the JAX package's
kernel bound); bf16 within one bf16 step (2**-6 for outputs in [2, 4)) of the
interpreted kernel; ``reference_xla`` in bf16 within three steps of
``_ref_tconvffn`` (PyTorch's bf16 SiLU rounds at other points than XLA's);
gradients against ``jax.vjp`` of the JAX op at atol and rtol 5e-3 (its
gradient bound), the grouped weights' against the block diagonal of the
dense ones. The model: arch outputs at atol 2e-4, rtol 1e-4; waveforms at
SI-SDR >= 60 dB; ``training_step``'s loss at rtol 1e-4 and its gradients at
5e-3. The tensor-core kernel's operand layout (``_tc_operands``) is held
against the rounded parameters. The CUDA kernels themselves are held against
``reference`` in test_torch_kernels_gpu.py, which needs a card.
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
from nbss_tpu.ops.tconvffn import _ref_tconvffn, expand_grouped_kernel, fused_tconvffn
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models import spatialnet as spatialnet_module
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.ops import tconvffn as tc
from nbss_tpu_torch.ops.metrics import si_sdr
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import spatialnet_state_dict_from_flax

H, FF, G = 32, 64, 8
CPG = FF // G
SHAPES = [(6, 17), (3, 1), (8, 9)]  # (M, T): ragged against the Pallas blocks of 8 frames
STRICT_BF16 = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    """fn jitted and run with XLA's bf16 excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT_BF16)(*args)


def _params(seed):
    """Seeded parameters in the flax layout (Dense [in, out], grouped conv
    [3, FF/G, FF]) and the same in the port's torch layout."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.2):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    flax = {"ln_scale": 1 + w(H, s=0.1), "ln_bias": w(H, s=0.1), "w_up": w(H, FF),
            "b_up": w(FF, s=0.1), "gn_scale": 1 + w(FF, s=0.1), "gn_bias": w(FF, s=0.1),
            "w_down": w(FF, H), "b_down": w(H, s=0.1)}
    for c in ("c1", "c2", "c3"):
        flax[f"w_{c}"], flax[f"b_{c}"] = w(3, CPG, FF), w(FF, s=0.1)
    torch_p = {}
    for k, v in flax.items():
        if k in ("w_up", "w_down"):
            v = v.T
        elif k.startswith("w_c"):
            v = np.transpose(v, (2, 1, 0))
        torch_p[k] = torch.from_numpy(np.ascontiguousarray(v))
    dense = {k: expand_grouped_kernel(jnp.asarray(v), G) if k.startswith("w_c") else
             jnp.asarray(v) for k, v in flax.items()}
    return dense, torch_p


def _x(seed, M, T):
    return np.random.default_rng(seed + 100).standard_normal((M, T, H)).astype(np.float32)


def _j_kernel(x, p):
    return fused_tconvffn(x, p, G, 4)


def _block_diagonal(dense):
    """Dense [3, FF, FF] (tap, input, output) -> torch grouped [FF, FF/G, 3]."""
    out = np.arange(FF)
    inp = (out // CPG)[None, :] * CPG + np.arange(CPG)[:, None]  # [CPG, FF]
    return np.transpose(np.asarray(dense)[:, inp, out[None, :]], (2, 1, 0))


@pytest.mark.parametrize("M,T", SHAPES)
def test_reference_matches_jax_kernel_and_reference(M, T):
    dense, p = _params(1)
    x = _x(1, M, T)
    y = tc.tconvffn(torch.from_numpy(x), p, G)
    assert y.dtype == torch.float32 and tuple(y.shape) == (M, T, H)
    want_kernel = np.asarray(_compiled(_j_kernel, jnp.asarray(x), dense))
    want_ref = np.asarray(_ref_tconvffn(jnp.asarray(x), dense, G))
    np.testing.assert_allclose(y.numpy(), want_kernel, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), want_ref, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(tc.reference_xla(torch.from_numpy(x), p, G).numpy(), want_ref,
                               atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("M,T", SHAPES[:2])
def test_bf16_within_one_step_of_jax(M, T):
    """bf16: ``reference`` rounds where the Pallas kernel rounds (within one
    bf16 step of the interpreted kernel); ``reference_xla`` within three
    steps of ``_ref_tconvffn``."""
    dense, p = _params(2)
    x = _x(2, M, T)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = tc.tconvffn(xb, p, G)
    assert y.dtype == torch.bfloat16
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(_compiled(_j_kernel, jx, dense).astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want, atol=2.0 ** -6, rtol=2.0 ** -8)
    want_ref = np.asarray(_compiled(lambda x, p: _ref_tconvffn(x, p, G), jx, dense)
                          .astype(jnp.float32))
    np.testing.assert_allclose(tc.reference_xla(xb, p, G).float().numpy(), want_ref,
                               atol=3 * 2.0 ** -6, rtol=0)


@pytest.mark.parametrize("M,T", [(4, 17), (2, 1)])
def test_gradients_match_jax_vjp(M, T):
    """The Function's gradient (autodiff of ``reference_xla``) against
    ``jax.vjp`` of ``fused_tconvffn`` (custom_vjp: the vjp of
    ``_ref_tconvffn``) for x and every parameter."""
    dense, p = _params(3)
    x = _x(3, M, T)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    y = tc.tconvffn(xt, leaves, G)
    grads = torch.autograd.grad(y, [xt, *leaves.values()], torch.from_numpy(g))
    jgx, jgp = jax.jit(lambda x, p, g: jax.vjp(_j_kernel, x, p)[1](g))(
        jnp.asarray(x), dense, jnp.asarray(g))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=5e-3, rtol=5e-3)
    for name, got in zip(leaves, grads[1:]):
        want = np.asarray(jgp[name])
        if name in ("w_up", "w_down"):
            want = want.T
        elif name.startswith("w_c"):
            want = _block_diagonal(want)
        assert got.shape == leaves[name].shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3, err_msg=name)


def test_cpu_tensor_takes_plain_path_without_launch():
    _, p = _params(5)
    x = torch.from_numpy(_x(5, 3, 11))
    before = tc.launches
    y = tc.tconvffn(x, p, G)
    assert tc.launches == before and y.grad_fn is None
    assert torch.equal(y, tc.reference(x, p, G))
    xg = x.clone().requires_grad_()
    tc.tconvffn(xg, p, G).sum().backward()
    assert tc.launches == before and xg.grad.abs().max() > 0


def test_no_plain_fallback_for_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, and the
    kernel's checks refuse a CPU tensor (the wrapper never hands it one)."""
    _, p = _params(6)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tc.tconvffn(torch.empty(2, 8, H, device="meta"), p, G)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tc.forward(torch.zeros(2, 8, H), p, G)


def _unfragment(frags, K, N):
    """[N/8, K/8, 32, 2] -> [K, N] by the layout the tensor-core kernel reads:
    entry (n, kb, lane, e) is w[8 kb + 2 (lane % 4) + e, 8 n + lane // 4]."""
    w = np.full((K, N), np.nan, np.float32)
    n, kb, lane, e = np.meshgrid(*(np.arange(d) for d in frags.shape), indexing="ij")
    w[8 * kb + 2 * (lane % 4) + e, 8 * n + lane // 4] = frags
    return w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,ff", [(H, FF), (96, 192)])
def test_tc_operands_lay_out_the_rounded_parameters(h, ff, dtype):
    """The bf16 kernel's operands: every weight rounded to bf16 as mma.sync B
    fragments (w_up, then each conv per tap and group, then w_down, each
    [input, output]), every vector rounded to bf16 and held as float32."""
    rng = np.random.default_rng(h)
    cpg = ff // G
    shapes = {"ln_scale": (h,), "ln_bias": (h,), "w_up": (ff, h), "b_up": (ff,),
              "gn_scale": (ff,), "gn_bias": (ff,), "w_down": (h, ff), "b_down": (h,),
              **{f"w_c{i}": (ff, cpg, 3) for i in (1, 2, 3)},
              **{f"b_c{i}": (ff,) for i in (1, 2, 3)}}
    p = {k: torch.from_numpy(rng.standard_normal(shapes[k]).astype(np.float32)).to(dtype)
         for k in tc.PARAM_NAMES}
    frags, vecs = tc._tc_operands(p)
    assert frags.dtype == torch.bfloat16 and vecs.dtype == torch.float32

    def rnd(t):
        return t.to(torch.bfloat16).float().numpy()

    flat, off = frags.float().numpy(), 0

    def take(K, N):
        nonlocal off
        block = flat[off:off + K * N].reshape(N // 8, K // 8, 32, 2)
        off += K * N
        return _unfragment(block, K, N)

    np.testing.assert_array_equal(take(h, ff), rnd(p["w_up"]).T)
    for i in (1, 2, 3):
        w = rnd(p[f"w_c{i}"])
        for tap in range(3):
            for g in range(G):
                np.testing.assert_array_equal(take(cpg, cpg), w[g * cpg:(g + 1) * cpg, :, tap].T)
    np.testing.assert_array_equal(take(ff, h), rnd(p["w_down"]).T)
    assert off == flat.size
    np.testing.assert_array_equal(vecs.numpy(),
                                  np.concatenate([rnd(p[k]) for k in tc.VECTOR_NAMES]))


# --- the model: SpatialNet(fused_ffn=True) against the JAX model ---------------

N_FFT, HOP, FRAMES = 16, 8, 20
KW = dict(dim_output=4, num_layers=2, dim_hidden=H, dim_ffn=FF, num_heads=4,
          kernel_size=(5, 3), conv_groups=(8, G), dim_squeeze=4, num_freqs=N_FFT // 2 + 1,
          full_share=0)


def _pair(dim_input, fused_block=False):
    j_net = JSpatialNet(dim_input=dim_input, **KW, fused_ffn=True, fused_block=fused_block)
    params = JSpatialNet(dim_input=dim_input, **KW, fused_block=False).init(
        jax.random.PRNGKey(7), jnp.zeros((1, KW["num_freqs"], FRAMES, dim_input)))
    net = SpatialNet(dim_input=dim_input, **KW, fused_ffn=True, fused_block=fused_block,
                     device="cpu")
    net.load_state_dict(spatialnet_state_dict_from_flax(params, KW["num_layers"]))
    return j_net, params, net


@pytest.mark.parametrize("fused_block", [False, True])
def test_arch_matches_jax(rng, fused_block):
    j_net, params, net = _pair(6, fused_block)
    assert all(layer.fused_ffn for layer in net.layers)
    x = rng.standard_normal((2, KW["num_freqs"], FRAMES, 6)).astype(np.float32)
    want = np.asarray(_compiled(lambda p, x: j_net.apply(p, x), params, jnp.asarray(x)))
    before = tc.launches
    got = net(torch.from_numpy(x)).detach().numpy()
    assert tc.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def _modules():
    j_net, params, net = _pair(12)
    j_module = JTrainModule(arch=j_net, stft=JSTFT(n_fft=N_FFT, n_hop=HOP),
                            norm=JNorm(mode="frequency"), loss=JLoss("neg_si_sdr", pit=True))
    module = TrainModule(arch=net, stft=STFT(n_fft=N_FFT, n_hop=HOP),
                         norm=Norm(mode="frequency"), loss=Loss("neg_si_sdr", pit=True))
    return j_module, params, module


def test_forward_and_predict_step_match_jax(rng):
    j_module, params, module = _modules()
    x = rng.standard_normal((2, 6, HOP * (FRAMES - 1))).astype(np.float32)
    yr = rng.standard_normal((2, 2, HOP * (FRAMES - 1))).astype(np.float32)
    y, _ = module.forward(torch.from_numpy(x))
    y_j = jax.jit(lambda p, x: j_module.forward(p, x)[0])(params, jnp.asarray(x))
    assert si_sdr(y, torch.from_numpy(np.array(y_j))).min() >= 60.0
    pred = module.predict_step(torch.from_numpy(x), torch.from_numpy(yr))
    pred_j = np.asarray(jax.jit(j_module.predict_step)(params, jnp.asarray(x), jnp.asarray(yr)))
    np.testing.assert_allclose(pred.numpy(), pred_j, atol=2e-5, rtol=1e-4)


def test_training_step_loss_and_gradients_match_jax():
    from nbss_tpu_torch.data.synthetic import SyntheticDataset

    j_module, params, module = _modules()
    data = SyntheticDataset(num_items=2, audio_time_len=HOP * (FRAMES - 1) / 8000)
    items = [data[(i, 10 + i)] for i in range(2)]
    batch = (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]))
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: j_module.training_step(p, b)))(params, tuple(map(jnp.asarray, batch)))
    loss = module.training_step(tuple(torch.from_numpy(b) for b in batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = spatialnet_state_dict_from_flax(grads_j, KW["num_layers"])
    for name, p in module.arch.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)
    ffn = [n for n, p in module.arch.named_parameters() if ".tconvffn." in n]
    assert len(ffn) == 14 * KW["num_layers"]
    assert all(module.arch.get_parameter(n).grad.abs().max() > 0 for n in ffn)


@pytest.mark.parametrize("kw", [
    {}, {"fused_ffn": None}, {"fused_ffn": False},
    {"fused_ffn": True, "norms": ("LN", "GN", "GN", "LN", "LN", "LN")},
    {"fused_ffn": True, "norms": ("LN", "LN", "LN", "LN", "LN", "LN")},
    {"fused_ffn": True, "kernel_size": (5, 5)},
])
def test_default_and_outside_the_conditions_run_the_composition(rng, kw, monkeypatch):
    """``fused_ffn`` defaults to None, which is off (JAX's ``bool(None)``);
    with it on, other norms or another temporal kernel size keep the
    ``nn.Sequential`` composition, as the JAX conditions do."""
    net = SpatialNet(dim_input=6, **{**KW, **kw}, device="cpu")
    assert not any(layer.fused_ffn for layer in net.layers)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused T-ConvFFN ran")

    monkeypatch.setattr(spatialnet_module, "tconvffn", refuse)
    x = torch.from_numpy(rng.standard_normal((1, KW["num_freqs"], 12, 6)).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(net(x)).all()


def test_fused_path_matches_the_composition_in_fp32(rng):
    """One weight set: the fused T-ConvFFN and the nn.Sequential composition
    give the same network output in float32."""
    _, _, net = _pair(6)
    plain = SpatialNet(dim_input=6, **KW, device="cpu")
    plain.load_state_dict(net.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, KW["num_freqs"], 12, 6)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(net(x), plain(x), atol=2e-4, rtol=1e-4)
