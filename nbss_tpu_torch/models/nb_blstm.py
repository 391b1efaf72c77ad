"""NB-BLSTM: the narrow-band BLSTM separator (ICASSP 2022).

Counterpart of ``nbss_tpu/models/nb_blstm.py``: two bidirectional LSTM
layers (hidden 256, then 128, the second repeated ``n_repeat_last_lstm``
times) over each narrow-band [B*F, T] sequence, optional dropout after each,
then a per-frame linear decoder and an optional activation.

The JAX package runs the recurrence as flax ``nn.RNN`` over
``OptimizedLSTMCell`` under ``lax.scan`` (no Pallas kernel); the port runs
it through ``torch.nn.LSTM``'s recurrence, which on a card is cuDNN's, in
the compute dtype: cuDNN takes bfloat16 (a matrix product and a cell kernel
with float32 arithmetic a step and direction), with the float32 parameters
cast to the input's dtype on every call, as the other blocks cast theirs.

Parameter names are the reference torch BLSTM2_FC1's (``blstm1.weight_ih_l0``,
``..._reverse``, ``blstm2.*``, ``linear.*``), which
``nbss_tpu.utils.torch_compat.blstm2_fc1_params_from_torch`` reads;
``utils/convert.py`` holds its inverse.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nbss_tpu_torch.models.base import Linear, _uniform_


class BiLSTM(nn.LSTM):
    """Bidirectional ``nn.LSTM`` over [N, T, in] (batch first) ->
    [N, T, 2 * hidden], computing in the input's dtype. Parameters are drawn
    as torch draws them (uniform with bound 1/sqrt(hidden)), from
    ``generator``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                         bidirectional=True)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for w in self.parameters():
            _uniform_(w, bound, generator)

    def forward(self, x):
        # nn.LSTM.forward runs in its parameters' dtype; its recurrence, torch._VF.lstm,
        # takes the weights cast to the compute dtype (cuDNN packs such copies on each call)
        h0 = x.new_zeros(2 * self.num_layers, x.shape[0], self.hidden_size)
        weights = [w.to(x.dtype) for w in self._flat_weights]
        y, _, _ = torch._VF.lstm(x, (h0, h0), weights, True, self.num_layers, self.dropout,
                                 self.training, True, True)
        return y


class BLSTM2_FC1(nn.Module):
    """[B, F, T, dim_input] -> [B, F, T, dim_output] (float32 out).

    ``dtype`` is the compute dtype (parameters stay float32). The weights are
    drawn on the CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, dim_input: int, dim_output: int, hidden_size: Sequence[int] = (256, 128),
                 n_repeat_last_lstm: int = 1, dropout: Optional[float] = None,
                 activation: Optional[str] = "", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator
        self.dtype, self.dropout, self.activation = dtype, dropout, activation
        self.blstm1 = BiLSTM(dim_input, hidden_size[0], generator=g)
        self.blstm2 = BiLSTM(2 * hidden_size[0], hidden_size[1], n_repeat_last_lstm, generator=g)
        self.linear = Linear(2 * hidden_size[1], dim_output, generator=g)
        self.to(device)

    def _drop(self, z):
        return F.dropout(z, self.dropout, training=self.training) if self.dropout else z

    def forward(self, x):
        B, F_, T, H0 = x.shape
        x = x.to(self.dtype or x.dtype).reshape(B * F_, T, H0)
        x = self._drop(self.blstm2(self._drop(self.blstm1(x))))
        y = self.linear(x)
        if self.activation:
            y = getattr(F, self.activation.lower())(y)
        return y.reshape(B, F_, T, -1).float()
