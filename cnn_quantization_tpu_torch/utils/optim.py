"""Epoch/step-driven optimizer regime reconfiguration.

Port of ``cnn_quantization_tpu/utils/optim.py`` (reference utils/optim.py:
``OptimRegime`` rebuilds or retunes a torch optimizer from a list of
``{'epoch': e, 'optimizer': ..., 'lr': ..., ...}`` settings as training
progresses; a training-era leftover, unused on the reference's inference
path, SURVEY.md §2 #29).  The JAX package turns the regime into an optax
transform; here it drives a ``torch.optim`` optimizer, as the reference's
own did: ``lr_schedule`` is the piecewise-constant rate as a function of
the step, and ``OptimRegime.transform`` builds the optimizer of the active
setting or retunes the one it built.  Kept for capability parity (QAT
fine-tuning on top of the PTQ pipeline, with ``ops/ste.py``).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import torch

_OPTIMIZERS = {'sgd': torch.optim.SGD, 'adam': torch.optim.Adam}


def _normalize(regime: Sequence[Mapping[str, Any]], steps_per_epoch: int):
    """[{'epoch': e, 'lr': v, ...}] -> sorted [(boundary_step, settings)]."""
    out = []
    for entry in regime:
        e = entry.get('epoch', 0)
        step = entry.get('step', int(e * steps_per_epoch))
        out.append((step, dict(entry)))
    return sorted(out, key=lambda t: t[0])


def lr_schedule(regime: Sequence[Mapping[str, Any]], *, steps_per_epoch: int = 1,
                default_lr: float = 0.1):
    """Piecewise-constant ``fn(step) -> lr`` from a reference-style regime
    list (for ``torch.optim.lr_scheduler.LambdaLR``, divide by the base
    rate)."""
    rules = [(s, float(e['lr'])) for s, e in _normalize(regime, steps_per_epoch) if 'lr' in e]

    def schedule(step) -> float:
        lr = float(default_lr)
        for boundary, value in rules:
            if step >= boundary:
                lr = value
        return lr

    return schedule


class OptimRegime:
    """The reference's API: ``update(epoch, train_steps)`` applies the
    regime, ``setting`` holds the active hyperparameters, ``transform()``
    gives the ``torch.optim`` optimizer of that setting."""

    def __init__(self, regime: Sequence[Mapping[str, Any]], *,
                 steps_per_epoch: int = 1, optimizer: str = 'sgd'):
        self.rules = _normalize(regime, steps_per_epoch)
        self.steps_per_epoch = steps_per_epoch
        self.optimizer = optimizer
        self.setting: dict[str, Any] = {'lr': 0.1, 'momentum': 0.0, 'weight_decay': 0.0}
        self._opt: torch.optim.Optimizer | None = None
        self._kind: str | None = None
        self.update(0, 0)

    def update(self, epoch: int, train_steps: int) -> bool:
        step = int(epoch * self.steps_per_epoch + train_steps)
        changed = False
        for boundary, entry in self.rules:
            if step >= boundary:
                for k, v in entry.items():
                    if k in ('epoch', 'step'):
                        continue
                    if self.setting.get(k) != v:
                        self.setting[k] = v
                        changed = True
        return changed

    def _hyper(self, kind: str) -> dict[str, float]:
        hyper = {'lr': float(self.setting['lr']),
                 'weight_decay': float(self.setting.get('weight_decay', 0.0) or 0.0)}
        if kind == 'sgd':
            hyper['momentum'] = float(self.setting.get('momentum', 0.0) or 0.0)
        return hyper

    def transform(self, params: Iterable[torch.Tensor] | None = None) -> torch.optim.Optimizer:
        """The optimizer of the active setting: built over ``params`` on the
        first call (or when the regime switches the optimizer's kind), else
        the one built before with its hyperparameters retuned in place, so its
        state (momentum buffers) carries over."""
        kind = str(self.setting.get('optimizer', self.optimizer)).lower()
        if kind not in _OPTIMIZERS:
            raise ValueError(f'unknown optimizer: {kind}')
        if self._opt is None or kind != self._kind or params is not None:
            if params is None:
                if self._opt is None:
                    raise ValueError('the first transform() needs the parameters to optimize')
                params = [p for group in self._opt.param_groups for p in group['params']]
            self._opt, self._kind = _OPTIMIZERS[kind](params, **self._hyper(kind)), kind
        else:
            for group in self._opt.param_groups:
                group.update(self._hyper(kind))
        return self._opt
