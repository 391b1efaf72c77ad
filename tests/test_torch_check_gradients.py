"""The port's gradient-parity rule (``nbss_tpu_torch.check_gradients``) on the CPU.

``hold`` is checked on made-up gradients at each side of its bound and
with a parameter left out, and ``gradients`` on a small SpatialNet (2
layers, H=16, F=9, 20 frames), where the fused block runs its plain
``reference`` and ``reference_bwd``, and on a small NBC2, its float32 runs
in one pass and in two parts.
"""

import numpy as np
import pytest
import torch

from nbss_tpu_torch import check_gradients as cg
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.spatialnet import SpatialNet
from nbss_tpu_torch.train.module import TrainModule

KW = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=16, dim_ffn=32, num_heads=4,
          kernel_size=(5, 3), conv_groups=(4, 4), dim_squeeze=4, num_freqs=9, full_share=0)


def _grads(kernel, plain32, g64=1.0):
    """One parameter of four entries, each gradient g64 off by the given relative gaps."""
    base = torch.tensor([g64, -0.5, 0.25, 0.0], dtype=torch.float64)
    off = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    return {"kernel": {"w": base + kernel * off}, "plain32": {"w": base + plain32 * off},
            "plain64": {"w": base}}


@pytest.mark.parametrize("kernel, plain32", [
    (0.0, 0.0),
    (4.9e-3, 0.0),  # within rtol of both
    (-1.5e-2, -1e-2),  # past rtol, within twice the plain fp32 run's own gap
    (1.9e-2, 1e-2),  # within 2 x 1e-2 of float64 and 0.9e-2 of plain fp32
])
def test_hold_accepts_within_the_rule(kernel, plain32):
    line = cg.hold(_grads(kernel, plain32))
    assert "1 parameters" in line and "(w)" in line


@pytest.mark.parametrize("kernel, plain32", [
    (5.1e-3, 0.0),  # past rtol where the plain fp32 run is exact
    (2.1e-2, 1e-2),  # past twice the plain fp32 run's gap from float64
    (-7.9e-3, 4e-3),  # within 2 x 4e-3 of float64 but 1.19e-2 from plain fp32
])
def test_hold_refuses_past_the_rule(kernel, plain32):
    with pytest.raises(AssertionError, match="gradient of w"):
        cg.hold(_grads(kernel, plain32))


def test_hold_refuses_a_zero_kernel_gradient():
    grads = _grads(0.0, 0.0)
    grads["kernel"]["w"] = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(AssertionError, match="is zero"):
        cg.hold(grads)


def test_gradients_of_a_small_spatialnet_hold():
    net = SpatialNet(**KW, generator=torch.Generator().manual_seed(3), device="cpu")
    module = TrainModule(arch=net, channels=tuple(range(6)), stft=STFT(n_fft=16, n_hop=8),
                         norm=Norm(mode="frequency"), loss=Loss("neg_si_sdr", pit=True))
    rng = np.random.default_rng(5)
    batch = (torch.as_tensor(rng.standard_normal((4, 6, 152)), dtype=torch.float32),
             torch.as_tensor(rng.standard_normal((4, 2, 6, 152)), dtype=torch.float32))
    grads = cg.gradients(module, batch, KW, torch.device("cpu"), parts64=2)
    names = [n for n, _ in net.named_parameters()]
    for key in ("kernel", "plain32", "plain64"):
        assert list(grads[key]) == names
        for n, p in net.named_parameters():
            assert grads[key][n].dtype == torch.float64 and grads[key][n].shape == p.shape
    line = cg.hold(grads)
    assert f"{len(names)} parameters" in line


def test_hold_leaves_out_exempt_parameters():
    """A parameter whose kernel gradient is zero is refused unless it is
    named in ``exempt`` (NBC's key biases, which the fold drops)."""
    grads = _grads(0.0, 0.0)
    for key in grads:
        grads[key]["b"] = torch.full((4,), 1e-12 if key == "plain64" else 0.0,
                                     dtype=torch.float64)
    with pytest.raises(AssertionError, match="gradient of b through the kernels is zero"):
        cg.hold(grads)
    assert "1 parameters" in cg.hold(grads, exempt=["b"])


def test_gradients_of_a_small_nbc2_in_parts_hold():
    """``gradients`` builds another arch (NBC2, its plain path without the
    folded block or the attention kernel); the float32 runs taken in two
    parts give what one pass gives, and the rule holds."""
    from nbss_tpu_torch.models.nbc2 import NBC2

    kw = dict(dim_input=12, dim_output=4, n_layers=2, dim_hidden=16, dim_ffn=32, n_heads=2,
              n_conv_groups=4, num_freqs=9)
    net = NBC2(**kw, generator=torch.Generator().manual_seed(4), device="cpu")
    module = TrainModule(arch=net, channels=tuple(range(6)), stft=STFT(n_fft=16, n_hop=8),
                         norm=Norm(mode="frequency"), loss=Loss("neg_sa_sdr", pit=True))
    rng = np.random.default_rng(6)
    batch = (torch.as_tensor(rng.standard_normal((4, 6, 152)), dtype=torch.float32),
             torch.as_tensor(rng.standard_normal((4, 2, 6, 152)), dtype=torch.float32))
    plain = dict(fused_block=False, attention_kernel=False)
    whole, parts = (cg.gradients(module, batch, kw, torch.device("cpu"), parts64=2,
                                 arch_cls=NBC2, plain=plain, parts32=n) for n in (1, 2))
    for key in ("kernel", "plain32"):
        for name, g in whole[key].items():
            torch.testing.assert_close(parts[key][name], g, atol=1e-6 * g.abs().max().item(),
                                       rtol=1e-5, msg=f"{key} {name}")
    assert f"{len(list(net.parameters()))} parameters" in cg.hold(parts)
