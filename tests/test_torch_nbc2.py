"""The port's NBC2, its norms and new_norm against nbss_tpu on the CPU.

A small NBC2 (2 layers, H=16, ffn 32, 2 heads, 4 conv groups; B=2 utterances
of F=3 frequencies and T=20 frames, 4 inputs) with the JAX package's initial
weights carried over by utils/convert.py; inputs made from a seed with numpy.
On the CPU the port's folded block is ``attention_block.reference`` and its
attention module runs ``ops.attention.reference``; the JAX package runs its
Pallas kernels (the attention block with ``fused_block=True``, the
narrow-band attention with ``NBSS_ATTN=pallas``) in interpret mode, jitted.

Bounds: float32 at atol 2e-4, rtol 1e-4 (the JAX package's kernel bound);
gradients at atol and rtol 5e-3 (its gradient bound); bf16 no farther from
the JAX float32 model than twice the JAX bf16 model is (both round at bf16
steps, in another order); the task's waveform at atol 2e-4 of its largest
value, rtol 1e-4, and its loss at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.io import Loss as JLoss
from nbss_tpu.io import Norm as JNorm
from nbss_tpu.io import STFT as JSTFT
from nbss_tpu.models import base as jbase
from nbss_tpu.models.nbc2 import NBC2 as JNBC2
from nbss_tpu.models.spatialnet import SpatialNet as JSpatialNet
from nbss_tpu.train.module import TrainModule as JTrainModule
from nbss_tpu.utils.torch_compat import nbc2_params_from_torch
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models import base
from nbss_tpu_torch.models import nbc2 as nbc2_module
from nbss_tpu_torch.models.nbc2 import NBC2
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.train.module import TrainModule
from nbss_tpu_torch.utils.convert import (
    nbc2_state_dict_from_flax,
    spatialnet_state_dict_from_flax,
)

CFG = dict(dim_input=4, dim_output=4, n_layers=2, dim_hidden=16, dim_ffn=32, n_heads=2,
           n_conv_groups=4, num_freqs=3)
B, F, T = 2, 3, 20
ROUTES = {"fused": dict(fused_block=True),
          "unfused_ln": dict(fused_block=False),
          "gbn": dict(norms=("GBN", "GBN", "GBN"))}


def _x(seed, shape=(B, F, T, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(seed=0, dtype=None, **kw):
    """JAX NBC2 params (its initial weights) and the port's NBC2 built with
    ``kw`` and loaded with them."""
    cfg = dict(CFG, **kw)
    j_cfg = {k: v for k, v in cfg.items() if k != "fused_block"}
    params = JNBC2(**j_cfg, fused_block=False).init(jax.random.PRNGKey(seed),
                                                     jnp.zeros((1, F, 10, 4)))
    net = NBC2(**cfg, dtype=dtype, device="cpu")
    net.load_state_dict(nbc2_state_dict_from_flax(params, cfg["n_layers"]), strict=True)
    return params, net


def _jax_apply(seed_params, x, dtype=None, pallas_attention=False, **kw):
    """The JAX NBC2's output, jitted (its Pallas kernels interpret slowly)."""
    j_net = JNBC2(**dict(CFG, **kw), dtype=dtype)
    with pytest.MonkeyPatch.context() as mp:
        if pallas_attention:
            mp.setenv("NBSS_ATTN", "pallas")
        return np.asarray(jax.jit(j_net.apply)(seed_params, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["gLN", "GBN", "GBNShare"])
def test_norm_matches_jax(kind):
    """gLN over (T, H) per sequence; GBN over (group, H) per frame and
    GBNShare over (group, T, H) of each utterance's F sequences; float32
    statistics, random affine parameters."""
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2 * 5, 7, 8)) + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    args = (jnp.asarray(x),) if kind == "gLN" else (jnp.asarray(x), 5)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    want = np.asarray(jbase.new_norm(kind).apply(params, *args))
    mod = base.new_norm(kind, 8)
    mod.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = (mod(torch.from_numpy(x)) if kind == "gLN" else mod(torch.from_numpy(x), 5)).detach()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def test_new_norm_returns_every_kind_the_jax_factory_does():
    """LN, GN, gLN, GBN and GBNShare map to the counterparts of the JAX
    classes (GBN unshared, GBNShare shared along the sequence); a name the
    JAX factory refuses raises KeyError in both."""
    want = {"LN": base.LayerNorm, "GN": base.GroupNorm, "gLN": base.GlobalLayerNorm,
            "GBN": base.GroupBatchNorm, "GBNShare": base.GroupBatchNorm}
    for kind, cls in want.items():
        mod = base.new_norm(kind, 8, num_groups=4)
        j_mod = jbase.new_norm(kind, num_groups=4)
        assert type(mod) is cls and type(j_mod).__name__ == cls.__name__, kind
        if cls is base.GroupBatchNorm:
            assert mod.share_along_sequence_dim == j_mod.share_along_sequence_dim, kind
    for name in ("BN", "gbnshare"):
        with pytest.raises(KeyError):
            jbase.new_norm(name)
        with pytest.raises(KeyError):
            base.new_norm(name, 8)


@pytest.mark.parametrize("route", list(ROUTES))
def test_nbc2_block_routes_match_jax(route, monkeypatch):
    """Each of NBC2Block's routes against the JAX model's: the folded block
    (JAX: its interpreted Pallas attention block), the LN attention module
    with ``fused_block=False`` (JAX: its XLA attention) and GBN first norms
    through the narrow-band attention (JAX: its interpreted Pallas kernel);
    the port takes the route it should, on every block."""
    kw = ROUTES[route]
    params, net = _pair(0, **kw)
    calls = {"block": 0, "attention": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(nbc2_module, "attention_block",
                        counting("block", nbc2_module.attention_block))
    monkeypatch.setattr(base, "narrowband_attention",
                        counting("attention", base.narrowband_attention))
    x = _x(2)
    with torch.no_grad():
        y = net.eval()(torch.from_numpy(x))
    assert y.shape == (B, F, T, 4) and y.dtype == torch.float32
    n = CFG["n_layers"]
    assert calls == ({"block": n, "attention": 0} if route == "fused"
                     else {"block": 0, "attention": n})
    want = _jax_apply(params, x, pallas_attention=route == "gbn", **kw)
    np.testing.assert_allclose(y.numpy(), want, atol=2e-4, rtol=1e-4)


def test_nbc2_bf16_within_twice_jax_bf16():
    """bf16 through the folded block (the plain version's rounding points)
    against JAX's bf16 model through its interpreted Pallas kernel: the
    port's distance from JAX float32 at most twice JAX bf16's. Parameters
    stay float32 and the output is float32."""
    params, net = _pair(1, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    x = _x(3)
    with torch.no_grad():
        port = net.eval()(torch.from_numpy(x))
    assert port.dtype == torch.float32
    j32 = _jax_apply(params, x, fused_block=True)
    jbf = _jax_apply(params, x, dtype=jnp.bfloat16, fused_block=True)
    err, j_err = np.abs(port.numpy() - j32).max(), np.abs(jbf - j32).max()
    assert 0 < err <= 2 * j_err, (err, j_err)


def test_nbc2_gradients_match_jax():
    """Every parameter's gradient of sum(y^2) through the port's folded
    block (``reference_bwd`` on the CPU) and its GroupBatchNorms against
    ``jax.grad`` of the JAX model, in training mode with dropout 0."""
    params, net = _pair(2)
    x = _x(4)
    loss = (net.train()(torch.from_numpy(x)) ** 2).sum()
    loss.backward()
    j_net = JNBC2(**CFG, fused_block=False)
    j_grads = jax.jit(jax.grad(lambda p: jnp.sum(j_net.apply(p, jnp.asarray(x)) ** 2)))(params)
    want = nbc2_state_dict_from_flax(j_grads, CFG["n_layers"])
    named = list(net.named_parameters())
    assert len(named) == len(want)
    for name, p in named:
        assert p.grad is not None and p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_module_forward_and_training_step_match_jax():
    """``TrainModule.forward``, ``predict_step`` and ``training_step`` with
    NBC2 (2 channels, STFT 8/4: F=5 frequencies, the GroupBatchNorms' group;
    frequency norm, neg-SA-SDR with PIT) against the JAX package's: the
    waveform, the scale-recovered prediction, the loss and every gradient."""
    params, net = _pair(3, num_freqs=5)
    kw = dict(channels=(0, 1), ref_channel=0)
    j_module = JTrainModule(arch=JNBC2(**dict(CFG, num_freqs=5), fused_block=False),
                            stft=JSTFT(n_fft=8, n_hop=4), norm=JNorm("frequency"),
                            loss=JLoss(name="neg_sa_sdr", pit=True), **kw)
    module = TrainModule(arch=net, stft=STFT(n_fft=8, n_hop=4), norm=Norm("frequency"),
                         loss=Loss(name="neg_sa_sdr", pit=True), **kw)
    rng = np.random.default_rng(5)
    wave = rng.standard_normal((2, 2, 96)).astype(np.float32)
    ys = rng.standard_normal((2, 2, 2, 96)).astype(np.float32)
    net.eval()
    y, _ = module.forward(torch.from_numpy(wave))
    j_y, _ = j_module.forward(params, jnp.asarray(wave))
    scale = float(np.abs(np.asarray(j_y)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=2e-4 * scale, rtol=1e-4)
    pred = module.predict_step(torch.from_numpy(wave))
    j_pred = j_module.predict_step(params, jnp.asarray(wave))
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), atol=2e-4, rtol=1e-4)
    net.train()
    loss = module.training_step((torch.from_numpy(wave), torch.from_numpy(ys)))
    loss.backward()
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_module.training_step(p, (jnp.asarray(wave), jnp.asarray(ys)))))(params)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    want = nbc2_state_dict_from_flax(j_grads, CFG["n_layers"])
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=name)


def test_converter_round_trip_is_exact():
    """nbc2_params_from_torch(nbc2_state_dict_from_flax(p)) is p bit for bit
    (the reference's norms, LN/GBN/GBN); with other norm kinds each norm maps
    by its kind and the state dict loads strictly."""
    params = JNBC2(**CFG).init(jax.random.PRNGKey(4), jnp.zeros((1, F, 10, 4)))
    back = nbc2_params_from_torch(
        {k: v.numpy() for k, v in nbc2_state_dict_from_flax(params, 2).items()}, 2)
    flat, flat_back = (jax.tree_util.tree_flatten_with_path(t) for t in (params["params"], back))
    assert flat[1] == flat_back[1]
    for (path, a), (_, b) in zip(flat[0], flat_back[0]):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    norms = ("GN", "GBNShare", "LN")
    other = JNBC2(**CFG, norms=norms).init(jax.random.PRNGKey(5), jnp.zeros((1, F, 10, 4)))
    NBC2(**CFG, norms=norms, device="cpu").load_state_dict(
        nbc2_state_dict_from_flax(other, 2), strict=True)


def test_spatialnet_with_gln_matches_jax():
    """SpatialNet with gLN norms (the cross-band blocks and the T-ConvFFN's
    first norm), now that ``new_norm`` returns one, against the JAX model on
    the CPU: 2 layers, H=16, F=9, T=20."""
    kw = dict(dim_input=6, dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32, num_heads=4,
              kernel_size=(5, 3), conv_groups=(4, 4), dim_squeeze=4, num_freqs=9,
              norms=("LN", "gLN", "GN", "gLN", "LN", "gLN"))
    params = JSpatialNet(**kw, fused_block=False).init(jax.random.PRNGKey(6),
                                                       jnp.zeros((1, 9, 20, 6)))
    net = SpatialNet(**kw, device="cpu")
    net.load_state_dict(spatialnet_state_dict_from_flax(params, kw["num_layers"]), strict=True)
    assert isinstance(net.layers[0].fconv1[0], base.GlobalLayerNorm)
    x = _x(7, (2, 9, 20, 6))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(JSpatialNet(**kw, fused_block=False).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_nbc2_large_widths_run_on_the_cpu():
    """NBC2-large's widths (H 192, ffn 384; ``configs/NBC2.yaml``) run on the
    CPU through the plain block, which takes any H; on a card the
    attention-block kernel refuses H = 192 (``test_torch_kernels_gpu.py``)."""
    net = NBC2(dim_input=4, dim_output=4, n_layers=1, dim_hidden=192, dim_ffn=384,
               generator=torch.Generator().manual_seed(0), device="cpu").eval()
    with torch.no_grad():
        y = net(torch.from_numpy(_x(8, (1, 3, 12, 4))))
    assert y.shape == (1, 3, 12, 4) and torch.isfinite(y).all()
