"""NBSS: the waveform-in, waveform-out module of the narrow-band papers.

Counterpart of ``nbss_tpu/models/nbss.py``: its own STFT (512/256 by
default), division of every channel by the reference channel's mean
magnitude over time at each frequency (+ 1e-8), a narrow-band arch
(NB_BLSTM, NBC or NBC2) on the stacked real and imaginary parts, the
multiplication by that magnitude, and the iSTFT. ``TrainModule`` is the
full training stack; this module is the reference's standalone API.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.models.nb_blstm import BLSTM2_FC1
from nbss_tpu_torch.models.nbc import NBC
from nbss_tpu_torch.models.nbc2 import NBC2

ARCHS = {"NB_BLSTM": BLSTM2_FC1, "NBC": NBC, "NBC2": NBC2}


class NBSS(nn.Module):
    """x [B, C, T] waveforms -> [B, Spk, T] separated waveforms (float32).

    ``arch_kwargs`` go to the arch, with ``dtype`` (the compute dtype) unless
    they set it; the arch's weights are drawn from ``generator`` and moved to
    ``device``."""

    def __init__(self, n_channel: int = 8, n_speaker: int = 2, n_fft: int = 512,
                 n_overlap: int = 256, ref_channel: int = 0, arch: str = "NB_BLSTM",
                 arch_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        kwargs = dict(arch_kwargs or {})
        kwargs.setdefault("dtype", dtype)
        self.n_speaker, self.ref_channel = n_speaker, ref_channel
        self.net = ARCHS[arch](dim_input=2 * n_channel, dim_output=2 * n_speaker,
                               generator=generator, device=device, **kwargs)
        self.stft = STFT(n_fft=n_fft, n_hop=n_overlap)

    def forward(self, x):
        B, C, _ = x.shape
        X, original_len = self.stft.stft(x)  # [B, C, F, TF] complex
        X = X.permute(0, 2, 3, 1)  # [B, F, TF, C]
        _, F_, TF, _ = X.shape
        mag = X[..., self.ref_channel].abs().mean(2)[:, :, None, None]  # [B, F, 1, 1]
        Xin = torch.view_as_real(X / (mag + 1e-8)).reshape(B, F_, TF, 2 * C)
        out = self.net(Xin).float().reshape(B, F_, TF, self.n_speaker, 2)
        Y = torch.view_as_complex(out.contiguous()) * mag  # [B, F, TF, Spk]
        return self.stft.istft(Y.permute(0, 3, 1, 2), original_len)
