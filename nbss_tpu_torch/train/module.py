"""TrainModule: the task around an architecture.

Counterpart of ``nbss_tpu/train/module.py``: waveform -> STFT -> normalize ->
stack real/imag per channel -> arch -> complex STFT coefficients -> inverse
normalize -> iSTFT, then the uPIT loss (``training_step``,
``validation_step``) or scale recovery and PIT reordering (``test_step``,
``predict_step``). STFT, norm and loss run in float32 whatever the arch's
compute dtype. ``training_step`` records gradients; the serving entry points
``forward``, ``forward_streaming``, ``test_step`` and ``predict_step`` run
without them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from nbss_tpu_torch.eval.scale import recover_scale
from nbss_tpu_torch.io.loss import Loss
from nbss_tpu_torch.io.norm import Norm
from nbss_tpu_torch.io.stft import STFT
from nbss_tpu_torch.ops import metrics as M
from nbss_tpu_torch.ops.pit import permutate, pit


@dataclass
class TrainModule:
    """``arch`` maps [B, F, T, 2C] -> [B, F, T, 2*Spk] (real)."""

    arch: nn.Module
    channels: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    ref_channel: int = 0
    stft: STFT = field(default_factory=lambda: STFT(n_fft=256, n_hop=128))
    norm: Norm = field(default_factory=lambda: Norm(mode="utterance"))
    loss: Loss = field(default_factory=lambda: Loss(name="neg_si_sdr", pit=True))
    val_metric: str = "loss"  # 'loss' | 'si_sdr' | 'sdr'
    mchunk: Optional[Tuple[float, float]] = None  # (len_s, hop_s) chunked validation SI-SDR

    @property
    def ref_index(self) -> int:
        return self.channels.index(self.ref_channel)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, istft: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """x: [B, C, T] waveforms -> (yr_hat [B, Spk, T], loss_paras), without
        gradients."""
        return self._forward(x, istft)

    def _forward(self, x: torch.Tensor, istft: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``forward``, recording gradients when they are enabled."""
        X, stft_paras = self.stft.stft(x[:, list(self.channels)])  # [B, C, F, T] complex
        B, C, F, T = X.shape
        X, (Xr, XrMM) = self.norm.norm(X, ref_channel=self.ref_index)
        Xin = torch.view_as_real(X.permute(0, 2, 3, 1)).reshape(B, F, T, 2 * C)
        out = self.arch(Xin)
        return self._postprocess(out, B, F, T, Xr, XrMM, stft_paras, istft)

    @torch.no_grad()
    def forward_streaming(self, x: torch.Tensor,
                          istft: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``forward`` through the arch's streaming API: the same STFT and
        normalization front end, then one STFT frame at a time through
        ``arch.init_streaming_state`` / ``arch.streaming_step``, the
        deployment path of the online models. It equals ``forward`` only with
        a causal (online) norm, since an offline norm sees future frames."""
        X, stft_paras = self.stft.stft(x[:, list(self.channels)])
        B, C, F, T = X.shape
        X, (Xr, XrMM) = self.norm.norm(X, ref_channel=self.ref_index)
        Xin = torch.view_as_real(X.permute(0, 2, 3, 1)).reshape(B, F, T, 2 * C)
        state = self.arch.init_streaming_state(B)
        outs = []
        for t in range(T):
            y_t, state = self.arch.streaming_step(Xin[:, :, t], state)
            outs.append(y_t)
        out = torch.stack(outs, dim=2)  # [B, F, T, out]
        return self._postprocess(out, B, F, T, Xr, XrMM, stft_paras, istft)

    def _postprocess(self, out, B, F, T, Xr, XrMM, stft_paras, istft):
        """Arch output -> (yr_hat, loss_paras): complex fold, to_CC, inverse
        normalization, iSTFT."""
        if not out.is_complex():
            out = torch.view_as_complex(out.float().reshape(B, F, T, -1, 2).contiguous())
        out = out.permute(0, 3, 1, 2)  # [B, Spk, F, T]
        Yr_hat, loss_paras = self.loss.to_CC(out=out, Xr=Xr, XrMM=XrMM, stft=self.stft)
        if self.loss.mask is None:
            Yr_hat = self.norm.inorm(out, (Xr, XrMM))
        if istft:
            return self.stft.istft(Yr_hat, stft_paras), loss_paras
        return torch.view_as_real(Yr_hat), loss_paras

    def training_step(self, batch) -> torch.Tensor:
        """(x [B,C,T], ys [B,Spk,C,T]) -> scalar loss, with gradients."""
        x, ys = batch[0], batch[1]
        yr = ys[:, :, self.ref_channel, :].float()
        yr_hat, loss_paras = self._forward(x)
        loss, _, _ = self.loss(yr_hat=yr_hat.float(), yr=yr, reduce_batch=True, **loss_paras)
        return loss

    @torch.no_grad()
    def validation_step(self, batch) -> Dict[str, torch.Tensor]:
        """Loss and the SDR / SI-SDR logging metrics."""
        x, ys = batch[0], batch[1]
        yr = ys[:, :, self.ref_channel, :].float()
        yr_hat, loss_paras = self._forward(x)
        loss, _, yr_hat = self.loss(yr_hat=yr_hat.float(), yr=yr, reorder=True, **loss_paras)
        sdr_val = M.sdr(yr_hat, yr).mean()
        si_sdr_val = M.si_sdr(yr_hat, yr).mean()
        metric = {"loss": -loss, "si_sdr": si_sdr_val, "sdr": sdr_val}[self.val_metric]
        logs = {f"val/{self.loss.name}": loss, "val/metric": metric, "val/sdr": sdr_val,
                "val/neg_si_sdr": -si_sdr_val}
        if self.mchunk is not None:
            # chunk-wise SI-SDR over (len, hop)-second windows; the sample rate
            # is inferred from the STFT size, as the JAX package does
            fs = 8000 if self.stft.n_fft <= 256 else 16000
            chunklen = int(self.mchunk[0] * fs)
            B, Spk, T = yr.shape
            n_chk = T // chunklen
            if n_chk > 1:
                yrc = yr[..., :n_chk * chunklen].reshape(B, Spk, n_chk, chunklen)
                yhc = yr_hat[..., :n_chk * chunklen].reshape(B, Spk, n_chk, chunklen)
                v = M.si_sdr(yhc, yrc).reshape(B * Spk, n_chk).mean(0)
                for i in range(n_chk):
                    key = f"val/si_sdr_{i * self.mchunk[0] + 1:g}s-{(i + 1) * self.mchunk[0]:g}s"
                    logs[key] = v[i]
        return logs

    def _recover_scale(self, yr_hat, x):
        x_ref = x[:, self.ref_channel, :].float()
        return recover_scale(preds=yr_hat, mixture=x_ref,
                             scale_src_together=self.loss.name == "neg_sa_sdr",
                             norm_if_exceed_1=False)

    @torch.no_grad()
    def test_step(self, batch) -> Dict[str, torch.Tensor]:
        """(x [B,C,T], ys [B,Spk,C,T]) -> loss and scale-recovered predictions."""
        x, ys = batch[0], batch[1]
        yr = ys[:, :, self.ref_channel, :].float()
        yr_hat, loss_paras = self.forward(x)
        loss, _, yr_hat = self.loss(yr_hat=yr_hat.float(), yr=yr, reorder=True, **loss_paras)
        if self.loss.is_scale_invariant_loss:
            yr_hat = self._recover_scale(yr_hat, x)
        return {"loss": loss, "yr_hat": yr_hat, "yr": yr,
                "x_ref": x[:, self.ref_channel, :].float()}

    @torch.no_grad()
    def predict_step(self, x: torch.Tensor, yr: Optional[torch.Tensor] = None,
                     norm_if_exceed_1: bool = True) -> torch.Tensor:
        """x [B, C, T] -> yr_hat [B, Spk, T]."""
        yr_hat, _ = self.forward(x)
        yr_hat = yr_hat.float()
        if self.loss.is_scale_invariant_loss:
            yr_hat = self._recover_scale(yr_hat, x)
        if yr is not None:
            _, perms = pit(preds=yr_hat, target=yr, metric_func=_si_sdr_bmean, eval_func="max")
            yr_hat = permutate(yr_hat, perm=perms)
        if norm_if_exceed_1:
            max_vals = yr_hat.abs().amax(-1, keepdim=True)
            yr_hat = yr_hat / torch.where(max_vals > 1.0, max_vals, torch.ones_like(max_vals))
        return yr_hat


def _si_sdr_bmean(preds, target):
    v = M.si_sdr(preds, target)
    return v.reshape(v.shape[0], -1).mean(1)
