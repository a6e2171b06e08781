"""Client-side local training: E local epochs of SGD for one client,
returning the model DELTA (the uplink payload).

Counterpart of ``src/repro/fl/client.py``. One working copy of the model
is reused across clients: each ``local_update`` loads the global weights
into it, trains, and writes ``p_new.float() - p.float()`` straight into
the caller's flat fp32 row, so the server never stacks client deltas.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import zoo
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim.sgd import SGD


class LocalTrainer:
    def __init__(self, cfg: ModelConfig, lr: float, momentum: float = 0.0,
                 *, device):
        self.cfg = cfg
        self.opt = SGD(lr=lr, momentum=momentum)
        self.work = DecoderLM(cfg, device)
        self.device = device

    def step(self, params: list, state: list, tokens: torch.Tensor):
        """One SGD step on a (batch, seq_len) token batch; returns the
        loss (a 0-dim tensor, no host sync)."""
        tokens = tokens.long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = zoo.forward(self.cfg, self.work, inputs, remat=False)
        loss = zoo.token_loss(self.cfg, logits, labels, aux=aux)
        grads = torch.autograd.grad(loss, params)
        self.opt.step(params, grads, state)
        return loss.detach()

    def local_update(self, global_model: DecoderLM,
                     batches: Iterable[np.ndarray],
                     delta_out: torch.Tensor) -> torch.Tensor:
        """Train from ``global_model``'s weights on ``batches``; write the
        flattened fp32 delta into ``delta_out`` (P,) and return the mean
        loss (0-dim tensor)."""
        params = list(self.work.parameters())
        with torch.no_grad():
            for pw, pg in zip(params, global_model.parameters()):
                pw.copy_(pg)
        state = self.opt.init(params)
        losses = [self.step(params, state,
                            torch.as_tensor(tokens, device=self.device))
                  for tokens in batches]
        with torch.no_grad():
            off = 0
            for pw, pg in zip(params, global_model.parameters()):
                n = pw.numel()
                torch.sub(pw.float().reshape(-1), pg.float().reshape(-1),
                          out=delta_out[off:off + n])
                off += n
        if not losses:
            return torch.zeros((), device=self.device)
        return torch.stack(losses).mean()
