"""Oracle MVDR beamformer baseline, batched over frequencies.

Counterpart of ``nbss_tpu/eval/beamformer.py`` (itself after the
reference's oracle beamformer): frequency-domain MVDR with the steering
vector taken as the leading eigenvector of each frequency's target
covariance (or mixture-minus-noise covariance), the covariance conditioned
as fgnt/nn-gev does, and distortionless weights w = R^-1 h / (h^H R^-1 h).
The eigendecompositions (``torch.linalg.eigh`` on the Hermitian
covariances) and the solves are batched over all frequencies; the
eigenvector is normalized to channel 0, as in the JAX package, so the phase
an eigensolver leaves free cancels. Runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from nbss_tpu_torch.io.stft import STFT


def condition_covariance(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """(x + gamma * tr(x)/C * I) / (1 + gamma), batched on [..., C, C]."""
    C = x.shape[-1]
    scale = gamma * torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)[..., None, None] / C
    eye = torch.eye(C, dtype=x.dtype, device=x.device)
    return (x + scale * eye) / (1 + gamma)


def _covariance(X: torch.Tensor) -> torch.Tensor:
    """[C, F, T] -> sum over t of x x^H, [F, C, C]."""
    return torch.einsum("cft,dft->fcd", X, X.conj())


def estimate_steering_vector(target_stft: Optional[torch.Tensor] = None,
                             mixture_stft: Optional[torch.Tensor] = None,
                             noise_stft: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leading eigenvector per frequency, normalized to channel 0.

    inputs: [C, F, T] complex. Returns [F, C]."""
    if target_stft is not None:
        R = _covariance(target_stft)
    else:
        if mixture_stft is None or noise_stft is None:
            raise ValueError("give target_stft, or mixture_stft and noise_stft")
        R = _covariance(mixture_stft) - _covariance(noise_stft)
    _, vecs = torch.linalg.eigh(R)  # eigenvalues ascending: the leading one is last
    h = vecs[..., -1]  # [F, C]
    denom = h[..., :1]
    safe = denom.abs() > 1e-12
    return torch.where(safe, h / torch.where(safe, denom, torch.ones_like(denom)),
                       torch.ones_like(h))


def mvdr_weights(mixture_stft: torch.Tensor, h: torch.Tensor, gamma: float = 1e-6) -> torch.Tensor:
    """mixture_stft [C, F, T], h [F, C] -> weights [F, C]."""
    T = mixture_stft.shape[-1]
    R = condition_covariance(_covariance(mixture_stft) / T, gamma)
    R = R / (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-15)
    part = torch.linalg.solve(R, h[..., None])[..., 0]  # [F, C]
    denom = (h.conj() * part).sum(-1, keepdim=True)
    return part / torch.where(denom.abs() > 1e-15, denom, torch.ones_like(denom))


def mvdr(mixture: torch.Tensor, noise: Optional[torch.Tensor] = None,
         target: Optional[torch.Tensor] = None, stft: Optional[STFT] = None) -> torch.Tensor:
    """Oracle MVDR: [C, T] mixture (+ oracle noise or target) -> [T]."""
    stft = stft or STFT(n_fft=2048, n_hop=512)
    X, olen = stft.stft(mixture)  # [C, F, T]
    if target is not None:
        h = estimate_steering_vector(target_stft=stft.stft(target)[0])
    else:
        if noise is None:
            raise ValueError("provide the oracle noise or target")
        h = estimate_steering_vector(mixture_stft=X, noise_stft=stft.stft(noise)[0])
    w = mvdr_weights(X, h)
    Y = torch.einsum("fc,cft->ft", w.conj(), X)
    return stft.istft(Y, olen)
