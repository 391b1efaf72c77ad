"""The port's NB-BLSTM and the NBSS wrapper against nbss_tpu on the CPU.

A small BLSTM2_FC1 (BLSTM 8 then 6, once or twice; B=2 utterances of F=3
frequencies and T=20 frames, 4 inputs) and small NBSS models of each arch
(4 channels, STFT 32/16, 400 samples) with the JAX package's initial
weights carried over by utils/convert.py; inputs made from a seed with
numpy. The JAX package runs its LSTMs as flax ``nn.RNN`` over
``OptimizedLSTMCell``, the port as ``torch.nn.LSTM``; NBSS's NBC and NBC2
run their plain blocks on the CPU in the port and their XLA paths in JAX.

Bounds: float32 at atol 2e-4, rtol 1e-4 (the JAX package's kernel bound;
the waveforms at atol 2e-4 of their largest value); gradients at atol and
rtol 5e-3 (its gradient bound); the converters' round trips bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu.models.nb_blstm import BLSTM2_FC1 as JBLSTM2_FC1
from nbss_tpu.models.nbss import NBSS as JNBSS
from nbss_tpu.utils.torch_compat import blstm2_fc1_params_from_torch
from nbss_tpu_torch.models.base import init_parameters
from nbss_tpu_torch.models.nb_blstm import BLSTM2_FC1
from nbss_tpu_torch.models.nbc2 import NBC2
from nbss_tpu_torch.models.nbss import NBSS
from nbss_tpu_torch.utils.convert import (
    blstm2_fc1_state_dict_from_flax,
    nbc2_state_dict_from_flax,
    nbc_state_dict_from_flax,
)

CFG = dict(dim_input=4, dim_output=4, hidden_size=(8, 6), dropout=0.5)
B, F, T = 2, 3, 20


def _x(seed, shape=(B, F, T, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(n_repeat, seed=0):
    cfg = dict(CFG, n_repeat_last_lstm=n_repeat)
    params = JBLSTM2_FC1(**cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, F, 10, 4)))
    net = BLSTM2_FC1(**cfg, device="cpu")
    net.load_state_dict(blstm2_fc1_state_dict_from_flax(params), strict=True)
    return params, net, JBLSTM2_FC1(**cfg)


@pytest.mark.parametrize("n_repeat", [1, 2])
def test_blstm2_fc1_matches_jax(n_repeat):
    """Both BLSTMs (the second repeated n_repeat times) and the decoder, in
    eval mode, where the dropout is inactive."""
    params, net, j_net = _pair(n_repeat)
    x = _x(1)
    with torch.no_grad():
        y = net.eval()(torch.from_numpy(x))
    assert y.shape == (B, F, T, 4) and y.dtype == torch.float32
    want = np.asarray(j_net.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n_repeat", [1, 2])
def test_blstm2_fc1_gradients_match_jax(n_repeat):
    """Every parameter's gradient of sum(y^2), dropout inactive, against
    ``jax.grad``; the JAX package's one bias a gate lands on bias_ih and
    bias_hh alike, as both add to the same pre-activation."""
    params, net, j_net = _pair(n_repeat, seed=1)
    x = _x(2)
    (net.eval()(torch.from_numpy(x)) ** 2).sum().backward()
    j_grads = jax.grad(lambda p: jnp.sum(j_net.apply(p, jnp.asarray(x)) ** 2))(params)
    want = blstm2_fc1_state_dict_from_flax(j_grads)
    named = list(net.named_parameters())
    assert len(named) == len(want)
    for name, p in named:
        w = want[name.replace("bias_hh", "bias_ih")].numpy()
        assert p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=5e-3, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("n_repeat", [1, 2])
def test_converter_round_trip_is_exact(n_repeat):
    """blstm2_fc1_params_from_torch(blstm2_fc1_state_dict_from_flax(p)) is p
    bit for bit: the flax bias goes to bias_ih and bias_hh is zero."""
    params = JBLSTM2_FC1(**CFG, n_repeat_last_lstm=n_repeat).init(
        jax.random.PRNGKey(3), jnp.zeros((1, F, 10, 4)))
    sd = blstm2_fc1_state_dict_from_flax(params)
    assert all(not v.any() for k, v in sd.items() if "bias_hh" in k)
    back = blstm2_fc1_params_from_torch({k: v.numpy() for k, v in sd.items()}, n_repeat)
    flat, flat_back = (jax.tree_util.tree_flatten_with_path(t) for t in (params["params"], back))
    assert flat[1] == flat_back[1]
    for (path, a), (_, b) in zip(flat[0], flat_back[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_parameters_are_drawn_from_the_generator():
    """``init_parameters`` (what ``Trainer.init`` calls) draws every LSTM and
    decoder parameter of BLSTM2_FC1, and every NBC2 parameter but the norms'
    ones and zeros, from the generator: one seed gives the same weights,
    another different ones."""
    for make in (lambda: BLSTM2_FC1(**CFG, device="cpu"),
                 lambda: NBC2(4, 4, 1, dim_hidden=16, dim_ffn=32, device="cpu")):
        nets = [make() for _ in range(3)]
        for net, seed in zip(nets, (0, 0, 1)):
            init_parameters(net, torch.Generator().manual_seed(seed))
        for (name, a), b, c in zip(nets[0].named_parameters(), nets[1].parameters(),
                                   nets[2].parameters()):
            assert torch.equal(a, b), name
            fixed = ("norm" in name or ".conv.4." in name  # norms: ones and zeros
                     or (".linear" in name and name.endswith("bias")))  # Xavier: zero bias
            drawn = not fixed
            assert drawn == (not torch.equal(a, c)), name


ARCHS = {
    "NB_BLSTM": (dict(hidden_size=(8, 6)), blstm2_fc1_state_dict_from_flax),
    "NBC2": (dict(n_layers=2, dim_hidden=16, dim_ffn=32, n_conv_groups=4),
             lambda p: nbc2_state_dict_from_flax(p, 2)),
    "NBC": (dict(n_layers=2, hidden_size=16, ffn_size=32, n_heads=2, inner_conv_groups=2,
                 inner_conv_layers=2, dropout=0.0), lambda p: nbc_state_dict_from_flax(p, 2, 2)),
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_nbss_matches_jax(arch):
    """The waveform-in, waveform-out wrapper with each arch: its STFT, the
    reference channel's mean-magnitude normalization, the arch and the
    iSTFT, against the JAX NBSS."""
    kw, convert = ARCHS[arch]
    common = dict(n_channel=4, n_speaker=2, n_fft=32, n_overlap=16, arch=arch, arch_kwargs=kw)
    wave = np.random.default_rng(4).standard_normal((2, 4, 400)).astype(np.float32)
    j_model = JNBSS(**common)
    params = j_model.init(jax.random.PRNGKey(5), jnp.asarray(wave))
    model = NBSS(**common, device="cpu")
    model.net.load_state_dict(convert(params["params"]["net"]), strict=True)
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(wave))
    want = np.asarray(jax.jit(j_model.apply)(params, jnp.asarray(wave)))
    assert y.shape == (2, 2, 400) and y.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(y.numpy(), want, atol=2e-4 * scale, rtol=1e-4)
