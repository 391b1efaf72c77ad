"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither JAX nor nbss_tpu, so it also runs where only the port is
installed. Every test is marked ``gpu`` and skips without a CUDA card. On a
machine with one (the repository's conftest imports JAX, so skip it there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Forward bounds: float32 with TF32 off at atol 2e-4, rtol 1e-4 (the JAX
package's own kernel bounds); bf16 no farther from the float32 plain result
than twice the plain bf16 version is, since the kernel rounds at no more
points than the plain version and only sums in another order. Backward
bounds: float32 at atol 5e-3 x max|plain| and rtol 5e-3 for each cotangent
(the JAX package's gradient bound, scaled to each output); bf16 as the
forward, or within the float32 bound where the plain bf16 version is exact.
A 2-layer SpatialNet's gradients through the kernels are held against the
plain module composition's.

The selective-scan kernels are held against ``ssm.reference`` and
``ssm.reference_bwd`` at the same bounds, at edge shapes: one frame, lengths
below, at and above the saved-state chunk of 8 frames, the serving length
251 and a long stream of 1000 frames; one sequence, a ragged count and the
training count 1032; channel counts below, at and above a block's 64; state
sizes 4, 8 and 16; two launches bit-identical. A 2-layer OnlineSpatialNet's
gradients through the scan kernels are held against its plain path's.

The tensor-core kernels, which bf16 inputs reach (the attention-block
forward and backward, the attention forward and backward), are held at the
edges of their tiles (T = 1, 13, 15, 16, 17, 64, 65, 250, 251, 256, and 257,
300 for the attention's 256-row chunks; one sequence; both masks and none;
q/k heads of 24, 64, 216) with bit-identical relaunches; the counters show
that float32 reaches the CUDA-core kernels and bf16 the tensor-core ones;
they refuse dh > 256, dv > 64, H != 96 and T > 256 (the block); and a
2-layer bf16 SpatialNet's, mhsa model's and NBC2's gradients through them
lie within the bf16 rule of the plain path's. The block is also held at
NBC2-small's two heads of 48 (forward and backward, fp32 and bf16, T = 1 ...
256 at the tiles' edges), the attention at NBC2's heads of 48 (dh = dv = 48,
two heads, masked and not), and NBC2-large (H 192) runs on
the card within the forward bounds of its plain composition.

The wide route of the block (H = 192, and H = 96 past 256 frames; bf16 on
``attention_block_wide_tc.cu``, float32 on ``attention_block_wide.cu``) is
held against the plain versions at one frame, either side of the bf16
kernels' 32-row stages, 64-row tiles and 128-row blocks of two warpgroups
(T = 31-33, 63-65, 127-129, 191-193, 255-257, 319-321, 383-385; an odd
number of tiles leaves a block's second warpgroup idle), the serving length
251 and 1001 frames (none of the scores is kept: every pass recomputes
them, so no length changes the route through memory), 4, 3 and 2 heads, M
odd or one, with bit-identical relaunches; the counters show that (H, T)
and the dtype pick the route; H = 128 is refused. A 2-layer
SpatialNet at the large widths trains through it (float32 gradients within
5e-3 x max|plain|, bf16 within the bf16 rule), and with a mask or active
attention dropout SpatialNet's MHSA runs rows 4-5 instead of the block.

The narrow-band attention kernels are held against ``attention.reference``
and ``attention.reference_bwd`` at the same bounds, with no mask, a causal
[T, T] mask and an ALiBi [nh, T, T] mask: one frame, lengths off and on the
tiles, 251 and 1024 frames, every compiled head width, dv != dh, one
sequence and the training count 1032, and the wide kernels' q/k heads (NBC's
216, a ragged 100, the widest 256); row-strided q, k, v slices; and a
2-layer OnlineSpatialNet mhsa model's gradients against its plain path's.

NBC's relative-position block kernels are held against
``attention_block.reference_relpos`` at the forward bounds (one frame,
ragged lengths, NBC's 248 frames, 1, 2, 4 and 8 heads, a run over several
workspace chunks), with bit-identical relaunches; bf16 reaches the
tensor-core kernel, which is held within one bf16 step of the plain bf16
version (of the largest term entering each element's sum: ``x``, ``c`` or a
head's ``vo``; T = 1, 13, 248, 256, 257 and 400, whose kept scores leave
shared memory; M = 1, 7 and several chunks) and refuses H != 192; a 2-layer
NBC's gradients through the kernels against the plain module composition's.

The T-ConvFFN kernels are held against ``tconvffn.reference`` at the
forward bounds (one and two frames, ragged and whole 32-frame tiles, 251 and
1000 frames, SpatialNet-small's and -large's widths), with bit-identical
relaunches; bf16 reaches the tensor-core kernel, which is held at the same
shapes and at the edges of its 16-frame tiles and 64-frame steps (T = 15,
16, 17, 62-65, 127, 128, 256, 300), and refuses what the CUDA-core kernel
refuses; a 2-layer SpatialNet(fused_ffn=True)'s
gradients against the plain module composition's.
"""

import numpy as np
import pytest
import torch

from nbss_tpu_torch.ops import attention_block as ab

# ragged and aligned lengths, one frame, the longest the kernel takes, odd nh
SHAPES = [(6, 40, 4), (5, 1, 4), (7, 64, 2), (3, 65, 3), (9, 256, 4), (37, 251, 4)]


def _operands(seed, M, T, nh, H=96):
    g = torch.Generator().manual_seed(seed)
    w_in = torch.randn(3 * H, H, generator=g) / H ** 0.5
    w_out = torch.randn(H, H, generator=g) / H ** 0.5
    b_in, b_out = 0.1 * torch.randn(3 * H, generator=g), 0.1 * torch.randn(H, generator=g)
    ln_w, ln_b = 1 + 0.1 * torch.randn(H, generator=g), 0.1 * torch.randn(H, generator=g)
    ln, A, Wvo, c, eps = ab.fold_weights(ln_w, ln_b, w_in, b_in, w_out, b_out, nh)
    x = torch.randn(M, T, H, generator=g)
    return x.cuda(), [t.cuda() for t in (ln, A, Wvo, c)], eps


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_kernel_matches_plain(card, M, T, nh, dtype):
    x, ops, eps = _operands(M * 1000 + T, M, T, nh)
    x = x.to(dtype)
    before = ab.launches
    y = ab.attention_block(x, *ops, eps, nh)
    torch.cuda.synchronize()
    assert ab.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    want = ab.reference(x.float(), *ops, eps, nh)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    else:
        plain_err = (ab.reference(x, *ops, eps, nh).float() - want).abs().max().item()
        err = (y.float() - want).abs().max().item()
        assert np.isfinite(err) and err <= 2 * plain_err, (err, plain_err)


@pytest.mark.gpu
def test_attention_block_kernel_refuses_what_it_does_not_take(card):
    x, ops, eps = _operands(0, 2, 40, 4, H=128)
    before = ab.launches
    with pytest.raises(ValueError, match="H = 96 or 192"):
        ab.attention_block(x, *ops, eps, 4)
    assert ab.launches == before
    x, ops, eps = _operands(0, 2, 257, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ab.attention_block(x[:, :8].half(), *ops, eps, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ab.attention_block(x[:, :8].transpose(0, 1), *ops, eps, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh", [(1, 1, 4), (5, 15, 4), (5, 16, 4), (5, 17, 4), (3, 64, 4),
                                    (3, 65, 4), (2, 250, 4), (1, 251, 4), (2, 256, 4),
                                    (4, 40, 3)])
def test_attention_block_tensor_core_kernel_at_tile_edges(card, M, T, nh):
    """bf16 through the tensor-core forward at the edges of its 16-frame
    tiles and 128-key halves: no farther from the fp32 plain result than
    twice the plain bf16 version, a relaunch bit-identical, one tensor-core
    launch each."""
    x, ops, eps = _operands(M * 100 + T + 7, M, T, nh)
    x = x.bfloat16()
    before = ab.tc_launches
    y = ab.attention_block(x, *ops, eps, nh)
    y2 = ab.attention_block(x, *ops, eps, nh)
    torch.cuda.synchronize()
    assert ab.tc_launches == before + 2
    assert torch.equal(y, y2)
    want = ab.reference(x.float(), *ops, eps, nh)
    err = (y.float() - want).abs().max().item()
    plain = (ab.reference(x, *ops, eps, nh).float() - want).abs().max().item()
    assert np.isfinite(err) and err <= max(2 * plain, 2e-4 + 1e-4 * want.abs().max().item()), (
        err, plain)


@pytest.mark.gpu
def test_dtype_picks_the_attention_block_forward_kernel(card):
    """float32 reaches the CUDA-core forward and bfloat16 the tensor-core
    one, as the counters show."""
    x, ops, eps = _operands(4, 2, 40, 4)
    for dtype, tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        f0, t0 = ab.launches, ab.tc_launches
        ab.attention_block(x.to(dtype), *ops, eps, 4)
        assert (ab.launches - f0, ab.tc_launches - t0) == (1, tc)


@pytest.mark.gpu
def test_tensor_core_attention_block_refuses_what_it_does_not_take(card):
    x, ops, eps = _operands(0, 2, 40, 4, H=128)
    with pytest.raises(ValueError, match="H = 96 or 192"):
        ab.attention_block(x.bfloat16(), *ops, eps, 4)
    x, ops, eps = _operands(0, 2, 257, 4)
    x = x.bfloat16()
    with pytest.raises(ValueError, match="nh dividing H"):
        ab.attention_block(x, *ops, eps, 5)
    x64 = x[:, :8, :64].contiguous()
    with pytest.raises(ValueError, match="H = 96"):
        ab.attention_block(x64, ops[0][:, :64].contiguous(), *ops[1:], eps, 4)


# NBC2-small's two heads of 48 at H = 96: one frame, the edges of the tensor-core kernels'
# 16-frame tiles and 128-key halves, the serving length and the longest the kernels take
NH2_T = [1, 13, 15, 16, 17, 64, 65, 250, 251, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("T", NH2_T)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_kernels_at_two_heads(card, T, dtype):
    """Rows 1-2 at NBC2-small's nh = 2: the forward within the forward
    bounds and each cotangent of the backward within the backward bounds of
    the plain versions, one launch each; in bf16 on the tensor-core kernels,
    relaunches bit-identical."""
    M, nh = 5, 2
    x, ops, eps = _operands(T + 2000, M, T, nh)
    g = torch.randn(M, T, 96, generator=torch.Generator().manual_seed(T)).cuda().to(dtype)
    x = x.to(dtype)
    f0, b0 = ab.tc_launches, ab.bwd_tc_launches
    y, y2 = (ab.attention_block(x, *ops, eps, nh) for _ in range(2))
    got, got2 = (ab.backward(x, *ops[:3], g, eps, nh) for _ in range(2))
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (ab.tc_launches - f0, ab.bwd_tc_launches - b0) == (2 * tc, 2 * tc)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    want = ab.reference(x.float(), *ops, eps, nh)
    ref = ab.reference_bwd(x.float(), *ops[:3], g.float(), eps, nh)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
        for name, a, r in zip(BWD_NAMES, got, ref):
            torch.testing.assert_close(a, r, atol=5e-3 * r.abs().max().item(), rtol=5e-3,
                                       msg=name)
        return
    err = (y.float() - want).abs().max().item()
    plain = (ab.reference(x, *ops, eps, nh).float() - want).abs().max().item()
    assert np.isfinite(err) and err <= max(2 * plain, 2e-4 + 1e-4 * want.abs().max().item())
    for name, a, p, r in zip(BWD_NAMES, got, ab.reference_bwd(x, *ops[:3], g, eps, nh), ref):
        e, ep = (a.float() - r).abs().max().item(), (p.float() - r).abs().max().item()
        assert np.isfinite(e) and e <= max(2 * ep, 5e-3 * r.abs().max().item()), (name, e, ep)


@pytest.mark.gpu
def test_nbc2_large_runs_through_the_wide_route(card):
    """NBC2-large (H 192, two heads, ``configs/NBC2.yaml``) runs on the card
    through the wide route of rows 1-2: one wide launch a layer, and in
    float32 within the forward bounds of its plain module composition."""
    from nbss_tpu_torch.models.nbc2 import NBC2

    kw = dict(dim_input=12, dim_output=4, n_layers=2, dim_hidden=192, dim_ffn=384, n_heads=2,
              device="cuda")
    gen = torch.Generator().manual_seed(0)
    net = NBC2(**kw, generator=gen).eval()
    plain = NBC2(**kw, fused_block=False, attention_kernel=False).eval()
    plain.load_state_dict(net.state_dict())
    x = torch.randn(1, 3, 20, 12, generator=gen).cuda()
    before = ab.wide_launches
    with torch.no_grad():
        y, want = net(x), plain(x)
    assert ab.wide_launches == before + 2
    torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)


BWD_NAMES = ("dx", "dln", "dA", "dWvo", "dc")


def _bwd_errors(got, want):
    return [(a.float() - b).abs().max().item() for a, b in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_bwd_kernel_matches_plain(card, M, T, nh, dtype):
    """fp32: each cotangent within atol 5e-3 x max|plain| and rtol 5e-3 (the
    JAX package's gradient bound, scaled to each output since the weight
    cotangents are sums over all M*T rows). bf16: no farther from the fp32
    plain result than twice the plain bf16 version is, or than the fp32
    bound where the plain bf16 version is exact (dc sums the same values)."""
    x, ops, eps = _operands(M * 1000 + T + 7, M, T, nh)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(T)).cuda()
    x, g = x.to(dtype), g.to(dtype)
    ln, A, Wvo, _ = ops
    before = ab.bwd_launches
    got = ab.backward(x, ln, A, Wvo, g, eps, nh)
    torch.cuda.synchronize()
    assert ab.bwd_launches == before + 1
    assert got[0].dtype == dtype and got[0].shape == x.shape
    assert [tuple(t.shape) for t in got[1:]] == [(2, 96), (nh, 98, 98), (nh, 98, 98), (1, 96)]
    want = ab.reference_bwd(x.float(), ln, A, Wvo, g.float(), eps, nh)
    errs = _bwd_errors(got, want)
    bounds = [5e-3 * w.abs().max().item() for w in want]
    if dtype == torch.float32:
        for name, a, w, b in zip(BWD_NAMES, got, want, bounds):
            torch.testing.assert_close(a, w, atol=b, rtol=5e-3, msg=name)
    else:
        plain = _bwd_errors(ab.reference_bwd(x, ln, A, Wvo, g, eps, nh), want)
        for name, e, p, b in zip(BWD_NAMES, errs, plain, bounds):
            assert np.isfinite(e) and e <= max(2 * p, b), (name, e, p, b)


@pytest.mark.gpu
def test_attention_block_bwd_kernel_refuses_what_it_does_not_take(card):
    x, (ln, A, Wvo, _), eps = _operands(0, 2, 40, 4, H=128)
    with pytest.raises(ValueError, match="H = 96 or 192"):
        ab.backward(x, ln, A, Wvo, x, eps, 4)
    x, (ln, A, Wvo, _), eps = _operands(0, 2, 257, 4)
    x64 = x[:, :8, :64].contiguous()
    with pytest.raises(ValueError, match="H = 96"):
        ab.backward(x64, ln[:, :64].contiguous(), A, Wvo, x64, eps, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh", [(5, T, 4) for T in (1, 13, 16, 17, 64, 65, 256)]
                         + [(1, 251, 4), (4, 40, 3)])
def test_attention_block_bwd_tensor_core_kernel_at_tile_edges(card, M, T, nh):
    """bf16 through the tensor-core backward at the edges of its 16-frame
    tiles: the bf16 rule of the test above, a relaunch bit-identical (the
    weight cotangents too: fixed-order sums, no atomics), one tensor-core
    launch each."""
    x, (ln, A, Wvo, _), eps = _operands(M * 100 + T, M, T, nh)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(T + 1)).cuda()
    x, g = x.bfloat16(), g.bfloat16()
    before = ab.bwd_tc_launches
    got = ab.backward(x, ln, A, Wvo, g, eps, nh)
    again = ab.backward(x, ln, A, Wvo, g, eps, nh)
    torch.cuda.synchronize()
    assert ab.bwd_tc_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ab.reference_bwd(x.float(), ln, A, Wvo, g.float(), eps, nh)
    plain = _bwd_errors(ab.reference_bwd(x, ln, A, Wvo, g, eps, nh), want)
    for name, e, p, w in zip(BWD_NAMES, _bwd_errors(got, want), plain, want):
        assert np.isfinite(e) and e <= max(2 * p, 5e-3 * w.abs().max().item()), (name, e, p)


@pytest.mark.gpu
def test_dtype_picks_the_attention_block_backward_kernel(card):
    """float32 reaches the CUDA-core backward and bfloat16 the tensor-core
    one, as the counters show."""
    x, (ln, A, Wvo, _), eps = _operands(3, 2, 40, 4)
    for dtype, tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        b0, t0 = ab.bwd_launches, ab.bwd_tc_launches
        ab.backward(x.to(dtype), ln, A, Wvo, x.to(dtype), eps, 4)
        assert (ab.bwd_launches - b0, ab.bwd_tc_launches - t0) == (1, tc)


@pytest.mark.gpu
def test_tensor_core_attention_block_bwd_refuses_what_it_does_not_take(card):
    x, (ln, A, Wvo, _), eps = _operands(0, 2, 40, 4, H=128)
    x = x.bfloat16()
    with pytest.raises(ValueError, match="H = 96 or 192"):
        ab.backward(x, ln, A, Wvo, x, eps, 4)
    x, (ln, A, Wvo, _), eps = _operands(0, 2, 257, 4)
    x = x.bfloat16()
    x64 = x[:, :8, :64].contiguous()
    with pytest.raises(ValueError, match="H = 96"):
        ab.backward(x64, ln[:, :64].contiguous(), A, Wvo, x64, eps, 4)


# The wide route: H = 192 (SpatialNet-large, NBC2-large) at 4, 2 and 3 heads, and H = 96
# past the shared-memory kernels' 256 frames. One frame; either side of the bf16 kernels'
# 32-row stages, 64-row tiles and 128-row blocks (two warpgroups of 64 rows; an odd number
# of tiles leaves the last block's second warpgroup idle); the serving length and 1001
# frames; one sequence, odd counts and a few dozen.
WIDE_SHAPES = [(3, 1, 4, 192), (5, 17, 4, 192), (1, 31, 4, 192), (3, 32, 2, 192),
               (1, 33, 4, 192), (3, 63, 4, 192), (2, 64, 3, 192), (5, 65, 4, 192),
               (3, 127, 2, 192), (2, 128, 4, 192), (3, 129, 3, 192), (3, 191, 4, 192),
               (1, 192, 2, 192), (3, 193, 4, 192), (4, 255, 4, 192), (3, 256, 2, 192),
               (3, 257, 2, 192), (2, 300, 4, 192), (2, 400, 4, 192), (2, 1001, 4, 192),
               (3, 1001, 2, 192), (37, 251, 4, 192), (4, 251, 3, 192), (2, 257, 4, 96),
               (3, 300, 2, 96), (3, 319, 4, 96), (1, 320, 3, 96), (3, 321, 4, 96),
               (2, 383, 2, 96), (1, 384, 4, 96), (3, 385, 3, 96), (2, 1001, 4, 96),
               (5, 400, 3, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh,H", WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_wide_route_matches_plain(card, M, T, nh, H, dtype):
    """Rows 1-2 on the wide route: the forward within the forward bounds of
    ``reference`` and each cotangent within the backward bounds of
    ``reference_bwd``; two launches give the same bits; the wide counters
    (and in bf16 the tensor-core ones) advance."""
    x, ops, eps = _operands(M * 1000 + T + H, M, T, nh, H)
    g = torch.randn(M, T, H, generator=torch.Generator().manual_seed(T + H)).cuda().to(dtype)
    x = x.to(dtype)
    counts = (ab.wide_launches, ab.wide_tc_launches, ab.bwd_wide_launches, ab.bwd_wide_tc_launches)
    y, y2 = (ab.attention_block(x, *ops, eps, nh) for _ in range(2))
    got, got2 = (ab.backward(x, *ops[:3], g, eps, nh) for _ in range(2))
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (ab.wide_launches - counts[0], ab.wide_tc_launches - counts[1],
            ab.bwd_wide_launches - counts[2], ab.bwd_wide_tc_launches - counts[3]) == (
                2, 2 * tc, 2, 2 * tc)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    want = ab.reference(x.float(), *ops, eps, nh)
    ref = ab.reference_bwd(x.float(), *ops[:3], g.float(), eps, nh)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
        for name, a, r in zip(BWD_NAMES, got, ref):
            torch.testing.assert_close(a, r, atol=5e-3 * r.abs().max().item(), rtol=5e-3,
                                       msg=name)
        return
    err = (y.float() - want).abs().max().item()
    plain = (ab.reference(x, *ops, eps, nh).float() - want).abs().max().item()
    assert np.isfinite(err) and err <= max(2 * plain, 2e-4 + 1e-4 * want.abs().max().item()), (
        err, plain)
    for name, a, p, r in zip(BWD_NAMES, got, ab.reference_bwd(x, *ops[:3], g, eps, nh), ref):
        e, ep = (a.float() - r).abs().max().item(), (p.float() - r).abs().max().item()
        assert np.isfinite(e) and e <= max(2 * ep, 5e-3 * r.abs().max().item()), (name, e, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("T,H,wide", [(40, 96, 0), (256, 96, 0), (257, 96, 1), (40, 192, 1)])
def test_shape_and_dtype_pick_the_attention_block_route(card, T, H, wide):
    """H = 96 with T <= 256 stays on the shared-memory kernels, H = 192 and
    T > 256 take the wide route; bf16 lands on a tensor-core kernel and
    float32 on a CUDA-core one, forward and backward, as the counters show."""
    x, (ln, A, Wvo, c), eps = _operands(T + H, 2, T, 4, H)
    for dtype in (torch.float32, torch.bfloat16):
        tc = int(dtype == torch.bfloat16)
        before = (ab.launches, ab.tc_launches, ab.wide_launches, ab.wide_tc_launches,
                  ab.bwd_launches, ab.bwd_tc_launches, ab.bwd_wide_launches,
                  ab.bwd_wide_tc_launches)
        ab.attention_block(x.to(dtype), ln, A, Wvo, c, eps, 4)
        ab.backward(x.to(dtype), ln, A, Wvo, x.to(dtype), eps, 4)
        after = (ab.launches, ab.tc_launches, ab.wide_launches, ab.wide_tc_launches,
                 ab.bwd_launches, ab.bwd_tc_launches, ab.bwd_wide_launches,
                 ab.bwd_wide_tc_launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            1, tc, wide, wide * tc, 1, tc, wide, wide * tc)


def _bf16_rule_on_gradients(kernel, plain, ref):
    """Each gradient of the bf16 kernel path no farther from the fp32 plain
    path's than twice the bf16 plain path's is, or than the fp32 bound
    (5e-3 x max|fp32|)."""
    for name, r in ref.items():
        e = (kernel[name].float() - r).abs().max().item()
        p = (plain[name].float() - r).abs().max().item()
        assert np.isfinite(e) and e <= max(2 * p, 5e-3 * r.abs().max().item()), (name, e, p)


def _gradients(net, x, w):
    xg = x.clone().requires_grad_()
    (net(xg).float() * w).sum().backward()
    return {"x": xg.grad, **{n: p.grad for n, p in net.named_parameters()}}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["spatialnet", "mhsa", "nbc2"])
def test_bf16_gradients_through_tensor_core_kernels_within_bf16_rule(card, arch):
    """A 2-layer bf16 SpatialNet, a 2-layer bf16 OnlineSpatialNet mhsa(16)
    and a 2-layer bf16 NBC2 (2 heads) at H=96, each through its tensor-core
    forward and backward: the kernel path's gradients against the plain
    path's under the bf16 rule, both held to the fp32 plain path."""
    from nbss_tpu_torch.models.nbc2 import NBC2
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
    from nbss_tpu_torch.models.spatialnet import SpatialNet

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=9)
    if arch == "spatialnet":
        make, off = (lambda **k: SpatialNet(**kw, **k, device="cuda")), {"fused_block": False}
        kernels = ab
    elif arch == "nbc2":
        make = lambda **k: NBC2(12, 4, 2, dim_hidden=96, dim_ffn=192, **k, device="cuda")
        off, kernels = {"fused_block": False, "attention_kernel": False}, ab
    else:
        from nbss_tpu_torch.ops import attention as att

        make = lambda **k: OnlineSpatialNet(**kw, attention="mhsa(16)", **k, device="cuda")
        off, kernels = {"fused_attention": False}, att
    gen = torch.Generator().manual_seed(0)
    kernel = make(dtype=torch.bfloat16, generator=gen)
    plain, ref = make(dtype=torch.bfloat16, **off), make(**off)
    plain.load_state_dict(kernel.state_dict())
    ref.load_state_dict(kernel.state_dict())
    x = torch.randn(2, 9, 40, 12, generator=gen).cuda()
    w = torch.randn(2, 9, 40, 4, generator=gen).cuda()
    before = (kernels.tc_launches, kernels.bwd_tc_launches)
    grads_kernel = _gradients(kernel, x, w)
    # one launch a layer of each
    assert (kernels.tc_launches - before[0], kernels.bwd_tc_launches - before[1]) == (2, 2)
    _bf16_rule_on_gradients(grads_kernel, _gradients(plain, x, w), _gradients(ref, x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatialnet_gradients_through_kernels_match_plain_path(card, dtype):
    """A 2-layer SpatialNet at H=96 (F=9, 20 frames): a loss through the
    default kernel path has a non-zero gradient for the input and every
    parameter, the backward kernel runs once per layer, and in fp32 each
    gradient is within 5e-3 x max|plain| of the plain module composition's."""
    from nbss_tpu_torch.models.spatialnet import SpatialNet

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=9)
    gen = torch.Generator().manual_seed(0)
    fused = SpatialNet(**kw, dtype=dtype, generator=gen, device="cuda")
    plain = SpatialNet(**kw, fused_block=False, device="cuda")
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 9, 20, 12, generator=gen).cuda()
    w = torch.randn(2, 9, 20, 4, generator=gen).cuda()
    grads = []
    for net in (fused, plain):
        xg = x.clone().requires_grad_()
        before = ab.bwd_launches
        (net(xg) * w).sum().backward()
        torch.cuda.synchronize()
        launched = ab.bwd_launches - before
        grads.append({"x": xg.grad, **{n: p.grad for n, p in net.named_parameters()}})
        assert launched == (2 if net is fused else 0)
    for name, gk in grads[0].items():
        assert gk is not None and gk.abs().max() > 0, name
        if dtype == torch.float32:
            gp = grads[1][name]
            torch.testing.assert_close(gk, gp, atol=5e-3 * gp.abs().max().item(), rtol=0,
                                       msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatialnet_large_gradients_through_the_wide_route(card, dtype):
    """A 2-layer SpatialNet at the large widths (H 192, ffn 384, 4 heads,
    squeeze 16; F = 9, 300 frames, past the shared-memory kernels' 256): one
    wide forward and one wide backward launch a layer; in float32 every
    gradient within 5e-3 x max|plain| of the plain module composition's, in
    bf16 within the bf16 rule of it."""
    from nbss_tpu_torch.models.spatialnet import SpatialNet

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=192, dim_ffn=384,
              num_heads=4, dim_squeeze=16, num_freqs=9)
    gen = torch.Generator().manual_seed(0)
    net = SpatialNet(**kw, dtype=dtype, generator=gen, device="cuda")
    plain = SpatialNet(**kw, dtype=dtype, fused_block=False, device="cuda")
    ref = SpatialNet(**kw, fused_block=False, device="cuda")
    plain.load_state_dict(net.state_dict())
    ref.load_state_dict(net.state_dict())
    x = torch.randn(2, 9, 300, 12, generator=gen).cuda()
    w = torch.randn(2, 9, 300, 4, generator=gen).cuda()
    before = (ab.wide_launches, ab.bwd_wide_launches)
    grads = _gradients(net, x, w)
    assert (ab.wide_launches - before[0], ab.bwd_wide_launches - before[1]) == (2, 2)
    want = _gradients(ref, x, w)
    if dtype == torch.float32:
        for name, r in want.items():
            torch.testing.assert_close(grads[name], r, atol=5e-3 * r.abs().max().item(), rtol=0,
                                       msg=name)
    else:
        _bf16_rule_on_gradients(grads, _gradients(plain, x, w), want)


@pytest.mark.gpu
def test_spatialnet_mask_or_active_dropout_takes_rows_4_5(card):
    """With an attention mask, or in training with the attention's dropout
    active, SpatialNet's folded block is off and its MHSA runs the
    narrow-band attention kernels (rows 4-5), as the JAX package's runs its
    Pallas kernel: no attention-block launch, one attention launch a layer
    (and one backward in training)."""
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import attention as att

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=9)
    gen = torch.Generator().manual_seed(0)
    net = SpatialNet(**kw, dropout=(0.1, 0.1, 0.1), dtype=torch.bfloat16, generator=gen,
                     device="cuda")
    x = torch.randn(2, 9, 40, 12, generator=gen).cuda()
    mask = torch.triu(torch.ones(40, 40, dtype=torch.bool, device="cuda"), 1)
    counts = (ab.launches, ab.bwd_launches, att.launches, att.bwd_launches)
    with torch.no_grad():
        y = net.eval()(x, att_mask=mask)
    net.train()(x).float().sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert tuple(a - b for a, b in zip(
        (ab.launches, ab.bwd_launches, att.launches, att.bwd_launches), counts)) == (0, 0, 4, 2)


# (M, T, D, N): T = 1, 7, 8, 9, 13 around the 8-frame chunk, 15, 16, 17 around half
# the forward's 32-frame span, 31, 33 around the span, 251, 1000; M = 1, 31, 1032; D = 192 (3 blocks), 64, 100,
# 70 and 33 (ragged), 40 (one partial block); N = 4, 8, 16 in one pass, and 17 (a second
# group of one state), 32, 64 and 128 in passes of 16 states, 24 and 40 (ragged last groups)
SCAN_SHAPES = [(1, 1, 192, 16), (31, 7, 192, 4), (31, 8, 64, 16), (1, 9, 100, 16),
               (1032, 251, 192, 16), (31, 1000, 192, 4), (1032, 9, 40, 4), (5, 251, 33, 16),
               (7, 251, 192, 8), (3, 13, 70, 8), (2, 15, 192, 16), (3, 16, 100, 16),
               (4, 17, 192, 4), (2, 31, 33, 8), (1, 33, 64, 16),
               (1, 1, 192, 17), (31, 40, 192, 17), (5, 251, 33, 17), (129, 251, 192, 32),
               (3, 33, 100, 64), (64, 251, 192, 64), (2, 17, 192, 128), (16, 251, 192, 128),
               (7, 9, 70, 24), (3, 65, 192, 40)]


def _scan_inputs(seed, M, T, D, N, dtype):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, T, D, generator=g)
    dt = 0.001 + 0.099 * torch.rand(M, T, D, generator=g)
    A = -(0.5 + 1.5 * torch.rand(D, N, generator=g))
    Bm, Cm = torch.randn(M, T, N, generator=g), torch.randn(M, T, N, generator=g)
    Dp, gy = torch.randn(D, generator=g), torch.randn(M, T, D, generator=g)
    return ([x.to(dtype).cuda(), dt.cuda(), A.cuda(), Bm.to(dtype).cuda(), Cm.to(dtype).cuda(),
             Dp.cuda()], gy.to(dtype).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,D,N", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(card, M, T, D, N, dtype):
    from nbss_tpu_torch.ops import ssm

    ins, _ = _scan_inputs(M + T + D + N, M, T, D, N, dtype)
    before = ssm.launches
    y, hb = ssm.forward(*ins, boundaries=True)
    torch.cuda.synchronize()
    assert ssm.launches == before + 1 and y.dtype == dtype and y.shape == ins[0].shape
    assert hb.shape == (-(-T // ssm.CHUNK), M, N, D)
    want = ssm.reference(*[t.float() for t in ins])
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    else:
        err = (y.float() - want).abs().max().item()
        plain = (ssm.reference(*ins).float() - want).abs().max().item()
        assert err <= max(2 * plain, 2e-4 + 1e-4 * want.abs().max().item()), (err, plain)
    y2, _ = ssm.forward(*ins)
    assert torch.equal(y, y2)  # writing the saved states changes nothing else


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,D,N", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_backward_kernel_matches_plain(card, M, T, D, N, dtype):
    from nbss_tpu_torch.ops import ssm

    ins, gy = _scan_inputs(M * T + D + N, M, T, D, N, dtype)
    _, hb = ssm.forward(*ins, boundaries=True)
    before = ssm.bwd_launches
    got = ssm.backward(*ins, hb, gy)
    torch.cuda.synchronize()
    assert ssm.bwd_launches == before + 1
    for g, t in zip(got, ins):
        assert g.dtype == t.dtype and g.shape == t.shape
    want = ssm.reference_bwd(*[t.float() for t in ins], gy.float())
    names = "gx gdt gA gB gC gD".split()
    if dtype == torch.float32:
        for name, g, w in zip(names, got, want):
            torch.testing.assert_close(g, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=name)
    else:
        plain = ssm.reference_bwd(*ins, gy)
        for name, g, p, w in zip(names, got, plain, want):
            err = (g.float() - w).abs().max().item()
            perr = (p.float() - w).abs().max().item()
            assert err <= max(2 * perr, 5e-3 * w.abs().max().item()), (name, err, perr)
    again = ssm.backward(*ins, hb, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_takes_views_off_16_bytes(card, dtype):
    """x, dt, B and C that start one element past a 16-byte boundary (contiguous
    views into a larger buffer) at D, N multiples of 8: the kernel stages them by
    plain loads and gives what it gives on aligned copies."""
    from nbss_tpu_torch.ops import ssm

    ins, _ = _scan_inputs(3, 3, 40, 192, 16, dtype)
    shifted = list(ins)
    for i in (0, 1, 3, 4):
        buf = torch.empty(ins[i].numel() + 1, dtype=ins[i].dtype, device="cuda")
        shifted[i] = buf[1:].view(ins[i].shape)
        shifted[i].copy_(ins[i])
        assert shifted[i].is_contiguous() and shifted[i].data_ptr() % 16 != 0
    y, hb = ssm.forward(*ins, boundaries=True)
    ys, hbs = ssm.forward(*shifted, boundaries=True)
    torch.cuda.synchronize()
    assert torch.equal(y, ys) and torch.equal(hb, hbs)


@pytest.mark.gpu
def test_selective_scan_kernels_refuse_what_they_do_not_take(card):
    from nbss_tpu_torch.ops import ssm

    ins, gy = _scan_inputs(0, 2, 9, 32, 4, torch.float32)
    with pytest.raises(ValueError, match="N >= 1"):  # any N >= 1 runs, in passes above 16
        ssm.selective_scan(*ins[:2], ins[2][:, :0], ins[3][..., :0], ins[4][..., :0], ins[5])
    with pytest.raises(ValueError, match="dt must be"):
        ssm.selective_scan(ins[0], ins[1].half(), *ins[2:])
    with pytest.raises(ValueError, match="hb must be"):
        ssm.backward(*ins, torch.zeros(1, device="cuda"), gy)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", [False, True])
def test_online_spatialnet_gradients_through_scan_kernels_match_plain_path(card, dtype, remat):
    """A 2-layer OnlineSpatialNet mamba(16,4) at H=96 (F=9, 30 frames): a loss
    through the kernels gives every parameter and the input a non-zero
    gradient, the backward kernel runs twice per layer (the forward twice
    more with remat), and in fp32 each gradient is within 5e-3 x max|plain|
    of the plain path's."""
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
    from nbss_tpu_torch.ops import ssm

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=96, dim_squeeze=8,
              num_freqs=9, attention="mamba(16,4)", remat=remat)
    gen = torch.Generator().manual_seed(0)
    fused = OnlineSpatialNet(**kw, dtype=dtype, generator=gen, device="cuda")
    plain = OnlineSpatialNet(**kw, fused_scan=False, device="cuda")
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 9, 30, 12, generator=gen).cuda()
    w = torch.randn(2, 9, 30, 4, generator=gen).cuda()
    grads = []
    for net in (fused, plain):
        xg = x.clone().requires_grad_()
        f0, b0 = ssm.launches, ssm.bwd_launches
        (net(xg) * w).sum().backward()
        torch.cuda.synchronize()
        launched = (ssm.launches - f0, ssm.bwd_launches - b0)
        grads.append({"x": xg.grad, **{n: p.grad for n, p in net.named_parameters()}})
        assert launched == (((8 if remat else 4), 4) if net is fused else (0, 0))
    for name, gk in grads[0].items():
        assert gk is not None and gk.abs().max() > 0, name
        if dtype == torch.float32:
            gp = grads[1][name]
            torch.testing.assert_close(gk, gp, atol=5e-3 * gp.abs().max().item(), rtol=0,
                                       msg=name)


# (M, T, nh, dh, dv): one frame and one sequence, lengths off and on the
# 32/64-row tiles, the serving length 251 at the model's widths, every
# compiled head width (16, 24, 32, 64), a v head wider than q/k, the longest
# stream the kernels are held to (1024 frames), and the training count 1032
ATTN_SHAPES = [(1, 1, 4, 24, 24), (5, 13, 4, 24, 24), (7, 64, 2, 16, 16), (3, 65, 3, 32, 32),
               (9, 251, 4, 24, 24), (2, 300, 2, 64, 64), (4, 37, 4, 8, 12), (2, 1024, 1, 24, 24),
               (1032, 251, 4, 24, 24),
               # NBC2's two heads of 48 (padded to the 64-wide kernels): ragged and serving length
               (3, 17, 2, 48, 48), (5, 251, 2, 48, 48),
               # the wide kernels (q/k heads above 64): NBC's augmented 216 with dv = 24, one
               # frame, off the 32-row tiles, a ragged width, the widest q/k 256 with dv 64
               (5, 13, 8, 216, 24), (1, 1, 2, 216, 24), (6, 251, 8, 216, 24), (3, 65, 2, 100, 16),
               (2, 37, 1, 256, 64)]
ATTN_MASKS = ["none", "causal", "alibi"]


def _attn_inputs(seed, M, T, nh, dh, dv, mask, dtype):
    from nbss_tpu_torch.models.online_spatialnet import alibi_mask, local_causal_mask

    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(M, T, nh * dh, generator=g) for _ in range(2))
    v, go = (torch.randn(M, T, nh * dv, generator=g) for _ in range(2))
    m = None
    if mask != "none":
        scope = max(T // 3, 1)
        m = torch.from_numpy(alibi_mask(T, scope, nh) if mask == "alibi"
                             else local_causal_mask(T, scope)).clamp(min=-1e30).cuda()
    return [t.to(dtype).cuda() for t in (q, k, v)], m, go.to(dtype).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh,dh,dv", ATTN_SHAPES)
@pytest.mark.parametrize("mask", ATTN_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrowband_attention_kernel_matches_plain(card, M, T, nh, dh, dv, mask, dtype):
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), m, _ = _attn_inputs(M + T + dh, M, T, nh, dh, dv, mask, dtype)
    before = att.launches
    o, st = att.forward(q, k, v, m, nh, stats=True)
    torch.cuda.synchronize()
    assert att.launches == before + 1 and o.dtype == dtype and o.shape == (M, T, nh * dv)
    assert st.shape == (2, M, nh, T)
    want = att.reference(q.float(), k.float(), v.float(), m, nh)
    if dtype == torch.float32:
        torch.testing.assert_close(o, want, atol=2e-4, rtol=1e-4)
    else:
        err = (o.float() - want).abs().max().item()
        plain = (att.reference(q, k, v, m, nh).float() - want).abs().max().item()
        assert np.isfinite(err) and err <= 2 * plain, (err, plain)
    o2, _ = att.forward(q, k, v, m, nh)
    assert torch.equal(o, o2)  # writing the statistics changes nothing else


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh,dh,dv", ATTN_SHAPES)
@pytest.mark.parametrize("mask", ATTN_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrowband_attention_backward_kernel_matches_plain(card, M, T, nh, dh, dv, mask, dtype):
    """fp32: each cotangent within atol 5e-3 x max|plain| and rtol 5e-3; bf16:
    no farther from the fp32 plain result than twice the plain bf16 version,
    or than the fp32 bound; two launches bit-identical."""
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), m, g = _attn_inputs(M * T + dv, M, T, nh, dh, dv, mask, dtype)
    _, st = att.forward(q, k, v, m, nh, stats=True)
    before = att.bwd_launches
    got = att.backward(q, k, v, m, g, nh, st)
    torch.cuda.synchronize()
    assert att.bwd_launches == before + 1
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
    want = att.reference_bwd(q.float(), k.float(), v.float(), m, g.float(), nh)
    names = ("dq", "dk", "dv")
    if dtype == torch.float32:
        for name, a, w in zip(names, got, want):
            torch.testing.assert_close(a, w, atol=5e-3 * w.abs().max().item(), rtol=5e-3,
                                       msg=name)
    else:
        plain = att.reference_bwd(q, k, v, m, g, nh)
        for name, a, p, w in zip(names, got, plain, want):
            err = (a.float() - w).abs().max().item()
            perr = (p.float() - w).abs().max().item()
            assert err <= max(2 * perr, 5e-3 * w.abs().max().item()), (name, err, perr)
    again = att.backward(q, k, v, m, g, nh, st)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.gpu
def test_narrowband_attention_takes_row_strided_slices(card):
    """q, k, v as slices of one packed [M, T, 3H] projection, as
    MultiheadAttention hands them over, give what contiguous copies give."""
    from nbss_tpu_torch.ops import attention as att

    qkv = torch.randn(6, 40, 3 * 96, generator=torch.Generator().manual_seed(0)).cuda()
    views = qkv.chunk(3, dim=-1)
    o, st = att.forward(*views, None, 4, stats=True)
    o2, st2 = att.forward(*(t.contiguous() for t in views), None, 4, stats=True)
    assert torch.equal(o, o2) and torch.equal(st, st2)
    g = torch.randn_like(o)
    for a, b in zip(att.backward(*views, None, g, 4, st),
                    att.backward(*(t.contiguous() for t in views), None, g, 4, st)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_narrowband_attention_kernels_refuse_what_they_do_not_take(card):
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), m, g = _attn_inputs(0, 2, 9, 2, 24, 24, "causal", torch.float32)
    wide = torch.zeros(2, 9, 2 * 257, device="cuda")  # one past the widest q/k head, 256
    with pytest.raises(ValueError, match="head widths"):
        att.narrowband_attention(wide, wide, v, None, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        att.narrowband_attention(q.half(), k.half(), v.half(), None, 2)
    with pytest.raises(ValueError, match="mask must be"):
        att.narrowband_attention(q, k, v, m[:8, :8], 2)
    with pytest.raises(ValueError, match="stats must be"):
        att.backward(q, k, v, m, g, 2, None)


# bf16 at the edges of the tensor-core forward's tiles: 16 query rows, 16-key blocks, the
# 256-key chunk (T > 256 takes two passes over the chunks); one sequence; q/k heads of 24,
# 64 and 216
TC_ATTN_SHAPES = [(3, T, 4, 24, 24) for T in (1, 13, 16, 17, 64, 65, 256, 257, 300)] + [
    (1, 251, 4, 24, 24), (2, 251, 4, 64, 64), (2, 65, 8, 216, 24), (2, 300, 8, 216, 24),
    (1, 248, 8, 216, 24), (3, 65, 2, 48, 48), (2, 251, 2, 48, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh,dh,dv", TC_ATTN_SHAPES)
@pytest.mark.parametrize("mask", ["causal", "alibi"])
def test_narrowband_attention_tensor_core_kernel_at_tile_edges(card, M, T, nh, dh, dv, mask):
    """bf16 through the tensor-core forward: no farther from the fp32 plain
    result than twice the plain bf16 version, a relaunch bit-identical
    (the row statistics too), one tensor-core launch each."""
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), m, _ = _attn_inputs(M * T + dh + 3, M, T, nh, dh, dv, mask, torch.bfloat16)
    before = att.tc_launches
    o, st = att.forward(q, k, v, m, nh, stats=True)
    o2, st2 = att.forward(q, k, v, m, nh, stats=True)
    torch.cuda.synchronize()
    assert att.tc_launches == before + 2
    assert torch.equal(o, o2) and torch.equal(st, st2)
    want = att.reference(q.float(), k.float(), v.float(), m, nh)
    err = (o.float() - want).abs().max().item()
    plain = (att.reference(q, k, v, m, nh).float() - want).abs().max().item()
    assert np.isfinite(err) and err <= max(2 * plain, 2e-4 + 1e-4 * want.abs().max().item()), (
        err, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh,dh,dv", TC_ATTN_SHAPES + [(1, 15, 4, 24, 24), (1, 1, 4, 24, 24)])
@pytest.mark.parametrize("mask", ["causal", "alibi", "none"])
def test_narrowband_attention_backward_tensor_core_kernel_at_tile_edges(card, M, T, nh, dh, dv,
                                                                      mask):
    """bf16 through the tensor-core backward at the edges of its 16-row tiles
    and 256-row chunks: each of dq, dk, dv no farther from the fp32 plain
    result than twice the plain bf16 version (or the fp32 bound where that
    is exact), a relaunch bit-identical, one tensor-core launch each."""
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), m, g = _attn_inputs(M * T + dh + 5, M, T, nh, dh, dv, mask, torch.bfloat16)
    _, st = att.forward(q, k, v, m, nh, stats=True)
    before = att.bwd_tc_launches
    got = att.backward(q, k, v, m, g, nh, st)
    again = att.backward(q, k, v, m, g, nh, st)
    torch.cuda.synchronize()
    assert att.bwd_tc_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = att.reference_bwd(q.float(), k.float(), v.float(), m, g.float(), nh)
    plain = att.reference_bwd(q, k, v, m, g, nh)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        e = (a.float() - w).abs().max().item()
        ep = (p.float() - w).abs().max().item()
        assert np.isfinite(e) and e <= max(2 * ep, 5e-3 * w.abs().max().item()), (name, e, ep)


@pytest.mark.gpu
def test_dtype_picks_the_attention_kernels(card):
    """float32 reaches the CUDA-core kernels and bfloat16 the tensor-core
    forward and backward, as the counters show."""
    from nbss_tpu_torch.ops import attention as att

    for dtype, tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        (q, k, v), m, g = _attn_inputs(1, 3, 40, 4, 24, 24, "causal", dtype)
        f0, t0, b0, bt0 = att.launches, att.tc_launches, att.bwd_launches, att.bwd_tc_launches
        _, st = att.forward(q, k, v, m, 4, stats=True)
        att.backward(q, k, v, m, g, 4, st)
        assert (att.launches - f0, att.tc_launches - t0, att.bwd_launches - b0,
                att.bwd_tc_launches - bt0) == (1, tc, 1, tc)


@pytest.mark.gpu
def test_tensor_core_attention_refuses_what_it_does_not_take(card):
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), _, _ = _attn_inputs(0, 2, 9, 2, 24, 24, "none", torch.bfloat16)
    wide = torch.zeros(2, 9, 2 * 257, dtype=torch.bfloat16, device="cuda")  # dh 257 > 256
    with pytest.raises(ValueError, match="head widths"):
        att.forward(wide, wide, v, None, 2)
    vwide = torch.zeros(2, 9, 2 * 65, dtype=torch.bfloat16, device="cuda")  # dv 65 > 64
    with pytest.raises(ValueError, match="head widths"):
        att.forward(q, k, vwide, None, 2)


@pytest.mark.gpu
def test_tensor_core_attention_backward_refuses_what_it_does_not_take(card):
    from nbss_tpu_torch.ops import attention as att

    (q, k, v), _, g = _attn_inputs(0, 2, 9, 2, 24, 24, "none", torch.bfloat16)
    st = torch.zeros(2, 2, 2, 9, device="cuda")
    wide = torch.zeros(2, 9, 2 * 257, dtype=torch.bfloat16, device="cuda")  # dh 257 > 256
    with pytest.raises(ValueError, match="head widths"):
        att.backward(wide, wide, v, None, g, 2, st)
    vwide = torch.zeros(2, 9, 2 * 65, dtype=torch.bfloat16, device="cuda")  # dv 65 > 64
    with pytest.raises(ValueError, match="head widths"):
        att.backward(q, k, vwide, None, vwide, 2, st)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat,rope", [(False, False), (True, "ALiBi")])
def test_online_spatialnet_gradients_through_attention_kernels_match_plain_path(
        card, dtype, remat, rope):
    """A 2-layer OnlineSpatialNet mhsa(16) at H=96, 4 heads (F=9, 40 frames):
    a loss through the kernels gives every parameter and the input a non-zero
    gradient, the backward kernel runs once per layer (the forward twice with
    remat), and in fp32 each gradient is within 5e-3 x max|plain| of the plain
    path's."""
    from nbss_tpu_torch.models.online_spatialnet import OnlineSpatialNet
    from nbss_tpu_torch.ops import attention as att

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=9, attention="mhsa(16)", rope=rope,
              remat=remat)
    gen = torch.Generator().manual_seed(0)
    fused = OnlineSpatialNet(**kw, dtype=dtype, generator=gen, device="cuda")
    plain = OnlineSpatialNet(**kw, fused_attention=False, device="cuda")
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 9, 40, 12, generator=gen).cuda()
    w = torch.randn(2, 9, 40, 4, generator=gen).cuda()
    grads = []
    for net in (fused, plain):
        xg = x.clone().requires_grad_()
        f0, b0 = att.launches, att.bwd_launches
        (net(xg) * w).sum().backward()
        torch.cuda.synchronize()
        launched = (att.launches - f0, att.bwd_launches - b0)
        grads.append({"x": xg.grad, **{n: p.grad for n, p in net.named_parameters()}})
        assert launched == (((4 if remat else 2), 2) if net is fused else (0, 0))
    for name, gk in grads[0].items():
        assert gk is not None and gk.abs().max() > 0, name
        if dtype == torch.float32:
            gp = grads[1][name]
            torch.testing.assert_close(gk, gp, atol=5e-3 * gp.abs().max().item(), rtol=0,
                                       msg=name)


# (M, T, nh) at NBC's H = 192: one frame, lengths off and on the 16-row tiles, NBC's
# 248 frames, 1, 2, 4 and 8 heads
RELPOS_SHAPES = [(5, 1, 8), (7, 13, 8), (3, 16, 8), (4, 17, 4), (2, 248, 8), (1, 33, 1),
                 (37, 64, 2)]


def _relpos_operands(seed, M, T, nh, H=192):
    from nbss_tpu_torch.models.nbc import sincos_position_tables

    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale):
        return scale * torch.randn(*shape, generator=g)

    wq, wk, wv, wo, wpos = (w(H, H, scale=H ** -0.5) for _ in range(5))
    bq, bk, bv, bo = (w(H, scale=0.1) for _ in range(4))
    u, v = w(nh, H // nh, scale=0.3), w(nh, H // nh, scale=0.3)
    ln_w, ln_b = 1 + w(H, scale=0.1), w(H, scale=0.1)
    *ops, eps = ab.fold_weights_nbc(ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, wpos, u, v, nh)
    tables = [torch.tensor(t) for t in sincos_position_tables(T, H)]
    x = torch.randn(M, T, H, generator=g)
    return x.cuda(), [t.cuda() for t in (*ops, *tables)], eps


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh", RELPOS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_relpos_kernel_matches_plain(card, M, T, nh, dtype):
    x, ops, eps = _relpos_operands(M * 1000 + T + nh, M, T, nh)
    x = x.to(dtype)
    before = ab.relpos_launches
    y = ab.attention_block_relpos(x, *ops, eps, nh)
    torch.cuda.synchronize()
    assert ab.relpos_launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    want = ab.reference_relpos(x.float(), *ops, eps, nh)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    else:
        plain_err = (ab.reference_relpos(x, *ops, eps, nh).float() - want).abs().max().item()
        err = (y.float() - want).abs().max().item()
        assert np.isfinite(err) and err <= 2 * plain_err, (err, plain_err)
    assert torch.equal(y, ab.attention_block_relpos(x, *ops, eps, nh))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_relpos_chunks_give_the_same_bits(card, dtype, monkeypatch):
    """Sequences go through the workspaces a chunk at a time: workspaces of
    one sequence (ten chunks) give the bits of one chunk of ten, on the
    CUDA-core kernel (float32) and the tensor-core kernel (bfloat16)."""
    x, ops, eps = _relpos_operands(5, 10, 29, 8)
    x = x.to(dtype)
    whole = ab.attention_block_relpos(x, *ops, eps, 8)
    monkeypatch.setattr(ab, "RELPOS_WORKSPACE_BYTES", 1)
    monkeypatch.setattr(ab, "RELPOS_TC_WORKSPACE_BYTES", 1)
    assert torch.equal(whole, ab.attention_block_relpos(x, *ops, eps, 8))


def _relpos_bf16_steps(got, want, x, ops, eps, nh):
    """|got - want| in bf16 steps (2**-7 of the binade) of the largest term
    that the block adds into each element (``relpos_term_scale``: |x|, |c|,
    each head's largest |vo| of that channel) or of the output."""
    ln, _, _, _, Wvo, c = ops[:6]
    mag = torch.maximum(ab.relpos_term_scale(x, ln, Wvo, c, eps, nh), want.float().abs())
    step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    return (got.float() - want.float()).abs() / step


# (M, T, nh): one frame, ragged lengths, NBC's 248 frames, 256 and 257 around the
# 256-frame query groups, 400 (its kept scores in a global workspace), 1, 2, 4, 8 heads
RELPOS_TC_SHAPES = [(1, 1, 8), (7, 1, 8), (1, 13, 8), (7, 13, 8), (1, 248, 8), (7, 248, 8),
                    (1, 256, 8), (7, 256, 8), (3, 257, 4), (2, 400, 8), (4, 33, 1), (5, 40, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,nh", RELPOS_TC_SHAPES)
def test_attention_block_relpos_tensor_core_kernel_within_one_bf16_step(card, M, T, nh):
    """bf16 through the tensor-core kernel against the plain bf16 version,
    which rounds where it does: every element within one bf16 step of the
    largest term that enters its sum (float32 sums in another order, and the
    special-function exp, can move an intermediate rounding by one step), at
    most 1% of elements differing at all (the share is printed; 0-0.4%
    measured on an H100), two tensor-core launches bit-identical."""
    x, ops, eps = _relpos_operands(M * 1000 + T + nh + 1, M, T, nh)
    x = x.bfloat16()
    before = ab.relpos_tc_launches
    y = ab.attention_block_relpos(x, *ops, eps, nh)
    y2 = ab.attention_block_relpos(x, *ops, eps, nh)
    torch.cuda.synchronize()
    assert ab.relpos_tc_launches == before + 2
    assert torch.equal(y, y2)
    want = ab.reference_relpos(x, *ops, eps, nh)
    steps = _relpos_bf16_steps(y, want, x, ops, eps, nh)
    share = (y != want).float().mean().item()
    print(f"relpos tensor-core kernel (M, T, nh) = {(M, T, nh)}: {share:.4%} of elements differ "
          f"from the plain bf16 version, at most {steps.max().item():.2f} bf16 steps")
    assert torch.isfinite(y.float()).all() and steps.max().item() <= 1.0
    assert share <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("T", [13, 248])
def test_attention_block_relpos_tensor_core_chunks_give_the_same_bits(card, T, monkeypatch):
    """Sequences go through the tensor-core kernel's workspace a chunk at a
    time: chunks of one sequence, and a budget of four that splits M = 5 in
    two, give the bits of one chunk of five."""
    from nbss_tpu_torch.ops import _build

    M, nh = 5, 8
    x, ops, eps = _relpos_operands(T + 3, M, T, nh)
    x = x.bfloat16()
    whole = ab.attention_block_relpos(x, *ops, eps, nh)
    four = _build.library().nbss_attention_block_relpos_tc_workspace_bytes(
        4, T, nh, ab._sm_count(0))
    for budget in (1, four):
        monkeypatch.setattr(ab, "RELPOS_TC_WORKSPACE_BYTES", budget)
        assert torch.equal(whole, ab.attention_block_relpos(x, *ops, eps, nh)), budget


@pytest.mark.gpu
def test_dtype_picks_the_relpos_kernel(card):
    """float32 reaches the CUDA-core kernel and bfloat16 the tensor-core one,
    as the counters show."""
    x, ops, eps = _relpos_operands(4, 2, 20, 8)
    for dtype, tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        f0, t0 = ab.relpos_launches, ab.relpos_tc_launches
        ab.attention_block_relpos(x.to(dtype), *ops, eps, 8)
        assert (ab.relpos_launches - f0, ab.relpos_tc_launches - t0) == (1, tc)


@pytest.mark.gpu
def test_attention_block_relpos_kernel_refuses_what_it_does_not_take(card):
    x, ops, eps = _relpos_operands(0, 2, 9, 8)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="H = 192"):
            ab.attention_block_relpos(x[..., :96].contiguous().to(dtype), *ops, eps, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ab.attention_block_relpos(x.half(), *ops, eps, 8)
    with pytest.raises(ValueError, match="sin must be"):
        ab.attention_block_relpos(x, *ops[:6], ops[6][:4], ops[7], eps, 8)
    with pytest.raises(ValueError, match="A must be"):
        ab.attention_block_relpos(x, *ops, eps, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ab.attention_block_relpos(x.transpose(1, 2).contiguous().transpose(1, 2), *ops, eps, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nbc_gradients_through_relpos_kernel_match_plain_path(card, dtype):
    """A 2-layer NBC at H=192, 8 heads (B=2, F=3, 20 frames): a loss through
    the default path launches the relative-position kernel once per layer,
    gives the input and every parameter but the key projection's bias (which
    the softmax removes) a non-zero gradient, and in fp32 each gradient is
    within 5e-3 x max|plain| of the plain module composition's (the attention
    module with the plain narrow-band attention)."""
    from nbss_tpu_torch.models.nbc import NBC

    kw = dict(dim_input=16, dim_output=4, n_layers=2, dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    fused = NBC(**kw, dtype=dtype, generator=gen, device="cuda")
    plain = NBC(**kw, fused_block=False, attention_kernel=False, device="cuda")
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 3, 20, 16, generator=gen).cuda()
    w = torch.randn(2, 3, 20, 4, generator=gen).cuda()
    grads = []
    for net in (fused, plain):
        xg = x.clone().requires_grad_()
        before = ab.relpos_launches
        (net(xg) * w).sum().backward()
        torch.cuda.synchronize()
        assert ab.relpos_launches - before == (2 if net is fused else 0)
        grads.append({"x": xg.grad, **{n: p.grad for n, p in net.named_parameters()}})
    for name, gk in grads[0].items():
        if name.endswith("key_proj.bias"):
            assert gk is None, name
            continue
        assert gk is not None and gk.abs().max() > 0, name
        if dtype == torch.float32:
            gp = grads[1][name]
            torch.testing.assert_close(gk, gp, atol=5e-3 * gp.abs().max().item(), rtol=0,
                                       msg=name)


# (M, T, H, FF): one frame, two frames, ragged and whole 32-frame tiles of the
# CUDA-core kernel, the edges of the tensor-core kernel's 16-frame tiles and
# 64-frame steps (15, 16, 17, 62-65, 127, 128, 256, 300), the serving length
# 251, a long stream; SpatialNet-small's and -large's widths
TCONVFFN_SHAPES = [(5, 1, 96, 192), (3, 2, 96, 192), (7, 13, 96, 192), (2, 32, 96, 192),
                   (3, 33, 96, 192), (1, 251, 96, 192), (129, 251, 96, 192),
                   (2, 1000, 96, 192), (4, 1, 192, 384), (3, 45, 192, 384),
                   (2, 251, 192, 384), (2, 15, 96, 192), (2, 16, 96, 192), (2, 17, 96, 192),
                   (1, 62, 96, 192), (1, 63, 96, 192), (2, 64, 96, 192), (1, 65, 96, 192),
                   (1, 127, 96, 192), (1, 128, 96, 192), (1, 256, 96, 192), (2, 300, 96, 192),
                   (2, 65, 192, 384)]


def _tconvffn_operands(seed, M, T, H, FF):
    from nbss_tpu_torch.ops.tconvffn import PARAM_NAMES

    g = torch.Generator().manual_seed(seed)
    shapes = {"ln_scale": (H,), "ln_bias": (H,), "w_up": (FF, H), "b_up": (FF,),
              "gn_scale": (FF,), "gn_bias": (FF,), "w_down": (H, FF), "b_down": (H,),
              **{f"w_c{i}": (FF, FF // 8, 3) for i in (1, 2, 3)},
              **{f"b_c{i}": (FF,) for i in (1, 2, 3)}}
    params = {}
    for k in PARAM_NAMES:
        fan_in = {"w_up": H, "w_down": FF}.get(k, 3 * FF // 8)
        v = torch.randn(*shapes[k], generator=g) / (fan_in ** 0.5 if k.startswith("w_") else 10)
        params[k] = (v + 1 if k.endswith("_scale") else v).cuda()
    return torch.randn(M, T, H, generator=g).cuda(), params


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,H,FF", TCONVFFN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tconvffn_kernel_matches_plain(card, M, T, H, FF, dtype):
    from nbss_tpu_torch.ops import tconvffn as tc

    x, p = _tconvffn_operands(M * 1000 + T + H, M, T, H, FF)
    x = x.to(dtype)
    before, before_tc = tc.launches, tc.tc_launches
    y = tc.tconvffn(x, p)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    assert tc.tc_launches == before_tc + (dtype == torch.bfloat16)
    assert y.dtype == dtype and y.shape == x.shape
    want = tc.reference(x.float(), p)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=2e-4, rtol=1e-4)
    else:
        plain_err = (tc.reference(x, p).float() - want).abs().max().item()
        err = (y.float() - want).abs().max().item()
        assert np.isfinite(err) and err <= 2 * plain_err, (err, plain_err)
    assert torch.equal(y, tc.tconvffn(x, p))  # no atomics


@pytest.mark.gpu
def test_dtype_picks_the_tconvffn_kernel(card):
    """float32 reaches the CUDA-core T-ConvFFN and bfloat16 the tensor-core
    one, as the counters show."""
    from nbss_tpu_torch.ops import tconvffn as tc

    x, p = _tconvffn_operands(4, 2, 40, 96, 192)
    for dtype, on_tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        f0, t0 = tc.launches, tc.tc_launches
        tc.tconvffn(x.to(dtype), p)
        assert (tc.launches - f0, tc.tc_launches - t0) == (1, on_tc)


@pytest.mark.gpu
@pytest.mark.parametrize("H,FF", [(96, 192), (192, 384)])
def test_tconvffn_tc_fragments_fill_the_kernels_buffer(card, H, FF):
    """The wrapper lays out as many bf16 fragment values as the tensor-core
    kernel reads, two a 32-bit word."""
    from nbss_tpu_torch.ops import _build, tconvffn as tc

    _, p = _tconvffn_operands(5, 1, 1, H, FF)
    frags, vecs = tc._tc_operands(p)
    assert frags.dtype == torch.bfloat16 and vecs.dtype == torch.float32
    assert frags.numel() == 2 * _build.library().nbss_tconvffn_tc_words(H, FF)


@pytest.mark.gpu
def test_tconvffn_plain_on_the_card_launches_nothing(card):
    from nbss_tpu_torch.ops import tconvffn as tc

    x, p = _tconvffn_operands(1, 3, 20, 96, 192)
    before = tc.launches
    y = tc.tconvffn(x, p, kernel=False)
    assert tc.launches == before
    assert torch.equal(y, tc.reference(x, p))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tconvffn_kernel_refuses_what_it_does_not_take(card, dtype):
    """Both kernels meet the same refusals, and nothing is launched for them."""
    from nbss_tpu_torch.ops import tconvffn as tc

    x, p = _tconvffn_operands(0, 2, 9, 96, 192)
    x = x.to(dtype)
    before = tc.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tc.tconvffn(x.half(), p)
    with pytest.raises(ValueError, match="contiguous"):
        tc.tconvffn(x.transpose(0, 1).contiguous().transpose(0, 1), p)
    with pytest.raises(ValueError, match="groups = 4"):
        tc.tconvffn(x, p, groups=4)
    x64, p64 = _tconvffn_operands(0, 2, 9, 64, 128)
    with pytest.raises(ValueError, match="H = 64"):
        tc.tconvffn(x64.to(dtype), p64)
    with pytest.raises(ValueError, match="w_c2 must be"):
        tc.tconvffn(x, {**p, "w_c2": p["w_c2"][..., :1]})
    with pytest.raises(ValueError, match="b_down must be"):
        tc.tconvffn(x, {**p, "b_down": p["b_down"].cpu()})
    assert tc.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatialnet_fused_ffn_gradients_match_plain_path(card, dtype):
    """A 2-layer SpatialNet at H=96 with fused_ffn=True (F=9, 20 frames): a
    forward launches the T-ConvFFN kernel once per layer, a loss gives the
    input and every parameter (each T-ConvFFN one among them) a non-zero
    gradient, and in fp32 each gradient is within 5e-3 x max|plain| of the
    plain module composition's."""
    from nbss_tpu_torch.models.spatialnet import SpatialNet
    from nbss_tpu_torch.ops import tconvffn as tc

    kw = dict(dim_input=12, dim_output=4, num_layers=2, dim_hidden=96, dim_ffn=192,
              num_heads=4, dim_squeeze=8, num_freqs=9)
    gen = torch.Generator().manual_seed(0)
    fused = SpatialNet(**kw, dtype=dtype, fused_ffn=True, generator=gen, device="cuda")
    plain = SpatialNet(**kw, fused_block=False, device="cuda")
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 9, 20, 12, generator=gen).cuda()
    w = torch.randn(2, 9, 20, 4, generator=gen).cuda()
    grads = []
    for net in (fused, plain):
        xg = x.clone().requires_grad_()
        before = tc.launches
        (net(xg) * w).sum().backward()
        torch.cuda.synchronize()
        assert tc.launches - before == (2 if net is fused else 0)
        grads.append({"x": xg.grad, **{n: p.grad for n, p in net.named_parameters()}})
    assert sum(".tconvffn." in n for n in grads[0]) == 28
    for name, gk in grads[0].items():
        assert gk is not None and gk.abs().max() > 0, name
        if dtype == torch.float32:
            gp = grads[1][name]
            torch.testing.assert_close(gk, gp, atol=5e-3 * gp.abs().max().item(), rtol=0,
                                       msg=name)


# ---------------------------------------------------------------- rooms and mixtures
@pytest.mark.gpu
def test_room_render_on_the_card_matches_the_cpu(card):
    """sim/ism.py on the card against the same code on the CPU: within 1e-4
    x max|rir|, and two renders on the card bit-identical."""
    from nbss_tpu_torch.sim import RirConfigSampler, simulate_rir

    par = RirConfigSampler(spk_num=2, noise_num=0, RT60_lim=(0.2, 0.4), seed=4).sample(0)
    args = (par["room_sz"], par["pos_src"], par["pos_rcv"], par["RT60"], 8000)
    kw = dict(beta=par.get("beta"), length_round=2048)
    cpu = simulate_rir(*args, **kw, device="cpu")
    got = simulate_rir(*args, **kw, device="cuda")
    np.testing.assert_allclose(got, cpu, atol=1e-4 * np.abs(cpu).max(), rtol=0)
    np.testing.assert_array_equal(simulate_rir(*args, **kw, device="cuda"), got)


@pytest.mark.gpu
@pytest.mark.parametrize("moving", [False, True])
def test_mixed_batch_on_the_card_matches_the_cpu(card, tmp_path, moving):
    """data/device_mix.py on the card against the CPU over a corpus the
    card rendered: the same host picks and draws, x and ys within atol 2e-5
    and rtol 1e-4."""
    from nbss_tpu_torch.data.device_mix import DeviceSyntheticDataModule
    from nbss_tpu_torch.sim.generate import main as generate

    flags = ["--trajectory=4points+sin,0.5"] if moving else []
    generate([f"--rir_dir={tmp_path}", "--spk_num=2", "--noise_num=0", "--rir_nums", "2", "1",
              "1", "--RT60_lim", "0.1", "0.3", "--mic_num=4", "--arr_geometry=circular",
              "--seed=3", *flags])
    kw = dict(rir_dir=str(tmp_path), audio_time_len=(2.0,) * 4, num_items=(8, 4, 4, 4),
              rir_len=4096, batch_size=(4, 4), seeds=(5, 2, 3, 3), preload_rir=True,
              trajectory_points=4 if moving else 0, ovlp="full" if moving else "mid")
    for stage in ("train_dataloader", "val_dataloader"):
        x, ys, p = next(iter(getattr(DeviceSyntheticDataModule(**kw, device="cuda"), stage)()))
        xc, ysc, pc = next(iter(getattr(DeviceSyntheticDataModule(**kw, device="cpu"), stage)()))
        assert x.device.type == "cuda" and x.shape == xc.shape
        assert [q["seed"] for q in p] == [q["seed"] for q in pc]
        assert [q["rir_file"] for q in p] == [q["rir_file"] for q in pc]
        torch.testing.assert_close(x.cpu(), xc, atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(ys.cpu(), ysc, atol=2e-5, rtol=1e-4)
