"""Client-side local training: E local epochs of SGD for one client,
returning the model DELTA (the uplink payload).

Counterpart of ``src/repro/fl/client.py``. One working copy of the model
is reused across clients: each ``local_update`` loads the global weights
into it, trains, and writes ``p_new.float() - p.float()`` straight into
the caller's flat fp32 row, so the server never stacks client deltas.

Spans (obs/trace.py): ``client.local_update`` (fenced on the delta; counts
``steps`` and ``tokens``) holds one ``client.step`` a batch (fenced on the
loss; ``tokens``), whose ``client.upload``, ``client.forward`` (forward and
loss), ``client.backward`` and ``client.sgd`` annotate the profiler's
timeline and time the host, and ``client.delta``. ``steps`` and
``tokens`` count every step the trainer has taken.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import zoo
from repro_torch.models.transformer import DecoderLM
from repro_torch.obs import trace
from repro_torch.optim.sgd import SGD


class LocalTrainer:
    def __init__(self, cfg: ModelConfig, lr: float, momentum: float = 0.0,
                 *, device):
        self.cfg = cfg
        self.opt = SGD(lr=lr, momentum=momentum)
        self.work = DecoderLM(cfg, device)
        self.device = device
        self.steps = 0
        self.tokens = 0

    def step(self, params: list, state: list, tokens: torch.Tensor):
        """One SGD step on a (batch, seq_len) token batch; returns the
        loss (a 0-dim tensor, no host sync)."""
        with trace.span("client.forward"):
            tokens = tokens.long()
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
            logits, aux = zoo.forward(self.cfg, self.work, inputs,
                                      remat=False)
            loss = zoo.token_loss(self.cfg, logits, labels, aux=aux)
        with trace.span("client.backward"):
            grads = torch.autograd.grad(loss, params)
        with trace.span("client.sgd"):
            self.opt.step(params, grads, state)
        return loss.detach()

    def local_update(self, global_model: DecoderLM,
                     batches: Iterable[np.ndarray],
                     delta_out: torch.Tensor) -> torch.Tensor:
        """Train from ``global_model``'s weights on ``batches``; write the
        flattened fp32 delta into ``delta_out`` (P,) and return the mean
        loss (0-dim tensor)."""
        with trace.span("client.local_update", fenced=True) as sp:
            params = list(self.work.parameters())
            with torch.no_grad():
                for pw, pg in zip(params, global_model.parameters()):
                    pw.copy_(pg)
            state = self.opt.init(params)
            losses = []
            steps0, tokens0 = self.steps, self.tokens
            for batch in batches:
                with trace.span("client.step", fenced=True,
                                tokens=batch.size) as st:
                    with trace.span("client.upload"):
                        tokens = torch.as_tensor(batch, device=self.device)
                    losses.append(self.step(params, state, tokens))
                    st.fence(losses[-1])
                self.steps += 1
                self.tokens += batch.size
            with trace.span("client.delta"), torch.no_grad():
                off = 0
                for pw, pg in zip(params, global_model.parameters()):
                    n = pw.numel()
                    torch.sub(pw.float().reshape(-1), pg.float().reshape(-1),
                              out=delta_out[off:off + n])
                    off += n
            sp.note(steps=self.steps - steps0, tokens=self.tokens - tokens0)
            sp.fence(delta_out)
        if not losses:
            return torch.zeros((), device=self.device)
        return torch.stack(losses).mean()
