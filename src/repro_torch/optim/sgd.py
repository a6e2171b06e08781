"""SGD (+momentum) over a list of parameters.

Counterpart of ``src/repro/optim/sgd.py``: updates in fp32 and writes the
result back in the parameter's dtype, ``p <- (p.float() + u).to(p.dtype)``
with ``u = -lr * g.float()`` (or ``-lr * m`` with momentum), in place.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float
    momentum: float = 0.0

    def init(self, params) -> list:
        if self.momentum == 0.0:
            return []
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]

    @torch.no_grad()
    def step(self, params, grads, state: list):
        """Apply one update to ``params`` in place; momentum ``state`` is
        updated in place too."""
        lr = self.lr
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            if self.momentum == 0.0:
                upd = -lr * g
            else:
                state[i] = self.momentum * state[i] + g
                upd = -lr * state[i]
            p.copy_((p.float() + upd).to(p.dtype))
