"""Optimizer, gradient clipping and the per-epoch learning-rate schedule.

Counterpart of ``nbss_tpu/train/optim.py``, whose optax chain is
clip-by-global-norm -> coupled weight decay -> optimizer. Here the optimizer
is a ``torch.optim`` class with torch-style kwargs, and ``Optimizer.step``
runs the two transformations before it, as the chain does:

- clipping by global norm as optax computes it: every gradient becomes
  ``(g / ||g||) * max_norm`` when ``||g|| >= max_norm``, with no epsilon;
- coupled weight decay ``g + wd * p`` for every optimizer but AdamW, whose
  decoupled decay is the optimizer's own (optax's default 1e-4).

``LRSchedule`` is the JAX package's host-side per-epoch controller
(ExponentialLR ``lr0 * gamma**(epoch + 1)``, ReduceLROnPlateau).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import torch

_OPTIMIZERS = {
    "adam": torch.optim.Adam,
    "adamw": torch.optim.AdamW,
    "sgd": torch.optim.SGD,
    "rmsprop": torch.optim.RMSprop,
    "adagrad": torch.optim.Adagrad,
}


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``, as
    ``optax.clip_by_global_norm`` does. Returns the norm before clipping."""
    grads = list(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


class Optimizer:
    """A ``torch.optim`` optimizer behind the JAX package's optax chain."""

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str = "Adam",
                 kwargs: Optional[Dict[str, Any]] = None,
                 gradient_clip_val: Optional[float] = 5.0):
        kwargs = dict(kwargs or {})
        key = name.lower()
        if key not in _OPTIMIZERS:
            raise KeyError(f"unknown optimizer {name!r}; known: {sorted(_OPTIMIZERS)}")
        wd = kwargs.pop("weight_decay", None)
        if key == "adamw":
            kwargs["weight_decay"] = 1e-4 if wd is None else wd
            wd = None
        self.params = [p for p in params if p.requires_grad]
        self.weight_decay = wd or 0.0
        self.gradient_clip_val = gradient_clip_val
        self.opt = _OPTIMIZERS[key](self.params, **kwargs)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Clip, add the coupled weight decay, then take the optimizer step.
        A parameter without a gradient gets a zero one, as in a JAX tree."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.gradient_clip_val is not None:
            clip_by_global_norm([p.grad for p in self.params], self.gradient_clip_val)
        if self.weight_decay:
            for p in self.params:
                p.grad.add_(p, alpha=self.weight_decay)
        self.opt.step()

    @property
    def lr(self) -> float:
        return float(self.opt.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = value

    def state_dict(self) -> Dict[str, Any]:
        return self.opt.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state)


@dataclass
class LRSchedule:
    """Host-side per-epoch LR controller.

    - ``ExponentialLR``: lr = lr0 * gamma^(epoch + 1), stepped per epoch.
    - ``ReduceLROnPlateau``: multiply by ``factor`` after ``patience`` epochs
      without improvement of the monitored value (mode min/max), floored at
      ``min_lr``.
    """

    name: Optional[str]
    lr0: float
    kwargs: Dict[str, Any]

    def __post_init__(self):
        self._lr = self.lr0
        self._best: Optional[float] = None
        self._bad_epochs = 0

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, epoch: int, monitored: Optional[float] = None) -> float:
        if self.name is None:
            return self._lr
        n = self.name.lower()
        if n == "exponentiallr":
            self._lr = self.lr0 * self.kwargs.get("gamma", 0.99) ** (epoch + 1)
        elif n == "reducelronplateau":
            mode = self.kwargs.get("mode", "min")
            if monitored is not None:
                better = (self._best is None
                          or (mode == "min" and monitored < self._best)
                          or (mode == "max" and monitored > self._best))
                if better:
                    self._best, self._bad_epochs = monitored, 0
                else:
                    self._bad_epochs += 1
                    if self._bad_epochs > self.kwargs.get("patience", 5):
                        self._lr = max(self._lr * self.kwargs.get("factor", 0.5),
                                       self.kwargs.get("min_lr", 0.0))
                        self._bad_epochs = 0
        else:
            raise KeyError(self.name)
        return self._lr
