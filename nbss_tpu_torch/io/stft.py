"""STFT / iSTFT: framed one-sided rfft and overlap-add.

Counterpart of ``nbss_tpu/io/stft.py``: ``center=True`` reflect padding by
``n_fft // 2``, a periodic hann (or sqrt-hann) window built with numpy on the
host, one-sided rfft to ``F = n_fft // 2 + 1`` bins; the inverse is a
per-frame irfft, synthesis window, overlap-add, division by the window-square
envelope, removal of the center padding and a trim or pad to the original
length. Both directions compute in float32 whatever the network's dtype.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PARAS_16K = dict(n_fft=512, n_hop=256, win_len=512)
PARAS_8K = dict(n_fft=256, n_hop=128, win_len=256)


def periodic_hann(n: int, dtype=np.float32) -> np.ndarray:
    """torch.hann_window(n, periodic=True) == 0.5 * (1 - cos(2*pi*k/n))."""
    k = np.arange(n, dtype=dtype)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))


def make_window(n_fft: int, win_len: int, win: str = "hann_window") -> np.ndarray:
    if win not in ("hann_window", "sqrt_hann_window"):
        raise ValueError(f"unknown window {win!r}")
    w = periodic_hann(win_len)
    if win == "sqrt_hann_window":
        w = np.sqrt(w)
    if win_len < n_fft:  # center the window inside n_fft, as torch.stft does
        left = (n_fft - win_len) // 2
        w = np.pad(w, (left, n_fft - win_len - left))
    return w


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, n_fft] -> [..., (T - 1) * hop + n_fft], frame t at t * hop."""
    *lead, T, n_fft = frames.shape
    out_len = (T - 1) * hop + n_fft
    cols = frames.reshape(-1, T, n_fft).transpose(1, 2)  # [N, n_fft, T]
    y = F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft), stride=(1, hop))
    return y.reshape(*lead, out_len)


@dataclass(frozen=True)
class STFT:
    n_fft: int = 256
    n_hop: int = 128
    win_len: Optional[int] = None
    win: str = "hann_window"

    @property
    def window_len(self) -> int:
        return self.win_len if self.win_len is not None else self.n_fft

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @functools.cached_property
    def _window(self) -> np.ndarray:
        return make_window(self.n_fft, self.window_len, self.win)

    def window(self, device) -> torch.Tensor:
        return torch.from_numpy(self._window).to(device)

    def stft(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """[..., time] -> (complex64 [..., F, T], original_len)."""
        original_len = x.shape[-1]
        lead = x.shape[:-1]
        x = x.to(torch.float32).reshape(-1, 1, original_len)
        pad = self.n_fft // 2
        x = F.pad(x, (pad, pad), mode="reflect").reshape(*lead, -1)
        frames = x.unfold(-1, self.n_fft, self.n_hop)  # [..., T, n_fft]
        X = torch.fft.rfft(frames * self.window(x.device), n=self.n_fft, dim=-1)
        return X.transpose(-1, -2).to(torch.complex64), original_len

    def istft(self, X: torch.Tensor, original_len: int) -> torch.Tensor:
        """complex [..., F, T] + length -> float32 [..., original_len]."""
        Xt = X.to(torch.complex64).transpose(-1, -2)  # [..., T, F]
        frames = torch.fft.irfft(Xt, n=self.n_fft, dim=-1)  # [..., T, n_fft]
        w = self.window(frames.device)
        y = _overlap_add(frames * w, self.n_hop)
        T = frames.shape[-2]
        env = _overlap_add((w * w).expand(T, self.n_fft), self.n_hop)
        y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
        y = y[..., self.n_fft // 2:]
        if y.shape[-1] >= original_len:
            return y[..., :original_len]
        return F.pad(y, (0, original_len - y.shape[-1]))
