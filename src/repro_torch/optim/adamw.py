"""AdamW over a list of tensors (fp32 moments).

Counterpart of ``src/repro/optim/adamw.py``, with its arithmetic, which
``torch.optim.AdamW`` does not share: ``b2`` defaults to 0.95, the step
is ``lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with the bias corrections
``bc = 1 - b ** t`` in fp32, and weight decay is added to the step
(``+ lr * weight_decay * p``) before ``p <- (p.float() - step).to(p.dtype)``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> dict:
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return {"mu": [z(p) for p in params], "nu": [z(p) for p in params],
                "t": 0}

    @torch.no_grad()
    def step(self, params, grads, state: dict, lr_scale: float = 1.0):
        """Apply one update to ``params`` in place; ``state`` (from
        ``init``) is updated in place too."""
        state["t"] = t = state["t"] + 1
        lr = self.lr * lr_scale
        for i, (p, g) in enumerate(zip(params, grads)):
            f32 = lambda x: torch.tensor(x, dtype=torch.float32,
                                         device=p.device)
            bc1 = 1.0 - f32(self.b1) ** t
            bc2 = 1.0 - f32(self.b2) ** t
            g = g.float()
            mu = self.b1 * state["mu"][i] + (1 - self.b1) * g
            nu = self.b2 * state["nu"][i] + (1 - self.b2) * torch.square(g)
            state["mu"][i], state["nu"][i] = mu, nu
            step = lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                step = step + lr * self.weight_decay * p.float()
            p.copy_((p.float() - step).to(p.dtype))
