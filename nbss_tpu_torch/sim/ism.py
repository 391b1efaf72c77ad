"""Image-source room impulse responses on the device.

Counterpart of ``nbss_tpu/sim/ism.py``. The RIR is assembled in the frequency
domain,

    H[m, f] = sum_k amp[m, k] * exp(-2j*pi*f*delay[m, k]),

a dense reduction over image sources with ideal bandlimited fractional
delays, then one irfft. The phase is exact: each delay splits into whole
samples, whose twiddle index ``(k * (d_int % L)) % L`` stays in integers, and
a fractional part under one sample, whose small angle float32 holds well.
Images are decoded from a flat counter chunk by chunk, and the spectrum
accumulates in float32 over the chunks; ``_ism_rir`` says how a chunk's sum
over images becomes matrix products.

Reflection amplitudes follow Allen & Berkley with per-wall coefficients
beta[6] = [x0, x1, y0, y1, z0, z1]; the direct path is the T60 = 0 case
(one image).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from nbss_tpu_torch.utils.device import resolve


def sabine_t60(room_sz, beta) -> float:
    """Sabine T60 implied by room + reflection coefficients."""
    alpha = 1.0 - np.asarray(beta, np.float64) ** 2
    sx, sy, sz = room_sz
    Sa = (alpha[0] + alpha[1]) * sy * sz + (alpha[2] + alpha[3]) * sx * sz \
        + (alpha[4] + alpha[5]) * sx * sy
    V = sx * sy * sz
    return 0.161 * V / max(Sa, 1e-9)


def beta_from_t60(room_sz, T60: float, abs_weights=None) -> Tuple[np.ndarray, float]:
    """Reflection coefficients for a desired T60 via Sabine's formula in
    closed form. Returns (beta [6], |T60 error|)."""
    w = np.ones(6) if abs_weights is None else np.asarray(abs_weights, np.float64)
    w = w / w.max()
    sx, sy, sz = room_sz
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
    Saw = float((w * areas).sum())
    V = sx * sy * sz
    if T60 <= 0:
        return np.zeros(6, np.float32), 0.0
    x = 0.161 * V / (T60 * Saw)  # absorption scale achieving T60 exactly
    x = min(x, 1.0)
    err = abs(T60 - 0.161 * V / (x * Saw))
    beta = np.sqrt(np.clip(1.0 - x * w, 0.0, 1.0))
    return beta.astype(np.float32), float(err)


def _grid_dims(room_sz, T60: float, c: float) -> Tuple[int, int, int]:
    """Per-axis image orders n: images span [-n, n] on each axis."""
    if T60 <= 0:
        return (0, 0, 0)  # direct path only
    max_dist = c * (T60 + 0.1)
    return tuple(int(math.ceil(max_dist / (2.0 * L))) for L in room_sz)


def default_image_chunk(device) -> int:
    """Images a chunk: 4096 on the CPU, 8192 on a card."""
    return 8192 if torch.device(device).type == "cuda" else 4096


def _bins(F: int) -> Tuple[int, int]:
    """(K1, K0) with K1 * K0 >= F: bin k = k1 * K0 + k0."""
    K0 = math.isqrt(F - 1) + 1
    return -(-F // K0), K0


@torch.no_grad()
def _ism_rir(room_sz: torch.Tensor, pos_src: torch.Tensor, pos_rcv: torch.Tensor,
             beta: torch.Tensor, ns: Tuple[int, int, int], n_img: int, L: int, fs: int,
             c: float, chunk: int) -> torch.Tensor:
    """Whole-room image-source RIR: float32 tensors on one device in, rir
    [S, M, L] float32 out. ``ns`` is the per-axis image order (images span
    [-n, n]) and ``n_img`` = prod(2 ns + 1) * 8 the image count.

    Bin k is split as k1 * K0 + k0 with K0 near sqrt(F), so each image's
    phasor is the product of a coarse factor exp(-2 pi i k1 K0 delay / L) and
    a fine one exp(-2 pi i k0 delay / L); the sum over images of amp x coarse
    x fine is then one float32 product of [K1, images] by [images, K0] for
    each (source, mic), on the device's matrix units, instead of a cosine and
    a sine for every (image, bin). Both factors keep the exact modular
    twiddle of the whole samples, ``(k * (d_int % L)) % L``, in integers."""
    dev = room_sz.device
    S, M, F = pos_src.shape[0], pos_rcv.shape[0], L // 2 + 1
    K1, K0 = _bins(F)
    Dy, Dz = 2 * ns[1] + 1, 2 * ns[2] + 1
    ns_t = torch.tensor(ns, dtype=torch.int64, device=dev)
    b0 = beta[[0, 2, 4]][None, :]  # walls at 0
    b1 = beta[[1, 3, 5]][None, :]  # walls at L
    k1 = torch.arange(K1, dtype=torch.int32, device=dev) * K0
    k0 = torch.arange(K0, dtype=torch.int32, device=dev)
    re = torch.zeros(S * M, K1, K0, dtype=torch.float32, device=dev)
    im = torch.zeros_like(re)

    def phasor(kk, d_int, d_frac):
        """exp(-2 pi i kk delay / L) as (cos, sin), [K, S, M, len(kk)]."""
        m_int = (kk * (d_int % L)[..., None]) % L  # exact modular twiddle index
        ang = (-2.0 * math.pi / L) * (m_int.to(torch.float32)
                                       + kk.to(torch.float32) * d_frac[..., None])
        return torch.cos(ang), torch.sin(ang)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the sums over images need float32
    try:
        for start in range(0, n_img, chunk):
            q = torch.arange(start, min(start + chunk, n_img), dtype=torch.int64, device=dev)
            pb, r = q % 8, q // 8
            iz, r = r % Dz, r // Dz
            iy, ix = r % Dy, r // Dy
            n = torch.stack([ix, iy, iz], dim=-1) - ns_t  # [K, 3]
            p = torch.stack([(pb >> 2) & 1, (pb >> 1) & 1, pb & 1], dim=-1)

            # image positions: (1 - 2p) * s + 2 n room   -> [K, S, 3]
            nf, pf = n.to(torch.float32), p.to(torch.float32)
            img_pos = ((1.0 - 2.0 * pf)[:, None, :] * pos_src[None, :, :]
                       + (2.0 * nf * room_sz[None, :])[:, None, :])
            # reflection amplitude: beta1^|n| * beta0^|n - p| per axis
            refl = torch.prod(b1 ** n.abs().to(torch.float32)
                              * b0 ** (n - p).abs().to(torch.float32), dim=-1)  # [K]
            d = torch.linalg.vector_norm(img_pos[:, :, None, :] - pos_rcv[None, None, :, :],
                                         dim=-1)  # [K, S, M]
            amp = refl[:, None, None] / (4.0 * math.pi * torch.clamp(d, min=1e-2))
            delay = d * (fs / c)  # samples
            # images beyond the RIR's length are dropped (their energy would be
            # truncated); the clamp keeps the twiddle index small
            inside = delay < L - 1
            amp = torch.where(inside, amp, torch.zeros_like(amp))
            delay = torch.clamp(delay, max=float(L - 1))
            # about half the images of the cube lie past the RIR's end for
            # every (source, mic): leave them out of the products
            keep = inside.flatten(1).any(1).nonzero().squeeze(1)
            amp, delay = amp[keep], delay[keep]
            d_int = torch.floor(delay)
            d_frac = delay - d_int
            d_int = d_int.to(torch.int32)  # k * (d_int % L) < L**2 / 2 fits

            c1, s1 = phasor(k1, d_int, d_frac)
            c0, s0 = phasor(k0, d_int, d_frac)
            ar = (amp[..., None] * c1).permute(1, 2, 3, 0).reshape(S * M, K1, -1)
            ai = (amp[..., None] * s1).permute(1, 2, 3, 0).reshape(S * M, K1, -1)
            br = c0.permute(1, 2, 0, 3).reshape(S * M, -1, K0)
            bi = s0.permute(1, 2, 0, 3).reshape(S * M, -1, K0)
            re += torch.bmm(ar, br) - torch.bmm(ai, bi)
            im += torch.bmm(ar, bi) + torch.bmm(ai, br)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    spec = torch.complex(re, im).reshape(S, M, K1 * K0)[..., :F]
    return torch.fft.irfft(spec, n=L, dim=-1)


def simulate_rir(room_sz, pos_src, pos_rcv, T60: float, fs: int,
                 beta: Optional[np.ndarray] = None, c: float = 343.0,
                 image_chunk: Optional[int] = None, length_round: int = 1,
                 device="cuda") -> Optional[np.ndarray]:
    """RIRs [n_src, n_mic, L] float32 (numpy), L = int((T60 + 0.1) * fs)
    rounded up to a multiple of ``length_round``, computed on ``device``.

    ``T60 == 0`` gives the direct-path-only RIR; ``image_chunk`` (None: by
    device) is the number of images a chunk."""
    room_sz = np.asarray(room_sz, np.float32)
    pos_src = np.atleast_2d(np.asarray(pos_src, np.float32))
    pos_rcv = np.atleast_2d(np.asarray(pos_rcv, np.float32))
    if pos_src.size == 0:
        return None
    if not ((pos_src >= 0).all() and (pos_src <= room_sz + 1e-3).all()):
        raise ValueError("source outside the room")
    if beta is None:
        beta, _ = beta_from_t60(room_sz, T60)
    beta = np.asarray(beta, np.float32)
    device = resolve(device)

    L = int((T60 + 0.1) * fs)
    L = -(-L // length_round) * length_round
    ns = _grid_dims(room_sz, T60, c)
    n_img = (2 * ns[0] + 1) * (2 * ns[1] + 1) * (2 * ns[2] + 1) * 8
    room_t, src_t, rcv_t, beta_t = (torch.from_numpy(a).to(device)
                                    for a in (room_sz, pos_src, pos_rcv, beta))
    rir = _ism_rir(room_t, src_t, rcv_t, beta_t, ns, n_img, L, fs, c,
                   image_chunk or default_image_chunk(device))
    return rir.cpu().numpy()


def simulate_direct_path(room_sz, pos_src, pos_rcv, fs: int, c: float = 343.0,
                         device="cuda") -> Optional[np.ndarray]:
    """Direct-path RIR (the T60 = 0 case)."""
    return simulate_rir(room_sz, pos_src, pos_rcv, 0.0, fs, c=c, device=device)
