"""Server-side update predictor for unselected clients (the paper's third
contribution, Sec. "ANN based FL model prediction").

Counterpart of ``src/repro/fl/predictor.py``. Every round only the
selected clients transmit; the server predicts the update of each
unselected client it has heard from before, so the aggregation sees a
full-population view:

  * each arriving flat delta is embedded by a fixed count-sketch (a random
    bucket and sign per coordinate), so the ANN input stays
    ``O(pred_embed_dim)`` whatever the model size. The buckets and signs
    are the reference's draw, ``np.random.default_rng(seed + 20_000)``,
    made per coordinate in its ``ravel_pytree`` order and permuted into
    the port's flat order (``convert.ravel_segments``);
  * a small MLP maps per-client features (the sketch of the client's last
    delta, the sketch of this round's aggregate, log-staleness, data
    weight, norm ratio, cosine) to two coefficients ``(a, b)``, and the
    prediction is ``a * delta_last + b * delta_mean``;
  * the MLP trains online with AdamW (optim/adamw.py) on the arrivals,
    each a labelled example with the leave-one-out aggregate in its
    features; the held-out ``pred_error`` is measured before the step.

``predictor="stale"`` reuses the last delta verbatim (a=1, b=0).

Memory layout: the last delta of every client lives in one preallocated
(n_clients, P) fp32 store with a known mask, and ``predict`` writes each
prediction straight into a row of the caller's fedagg buffer, never into
a separate P-vector. At the full width of smollm-135M and 50 clients the
store takes 25 GiB.

The sketch is plain PyTorch (``index_add_``): the reference's is XLA's
``segment_sum``, not a Pallas kernel. The MLP's initial weights come from
a CPU ``torch.Generator`` seeded ``seed + 20_001``, so every device starts
from the same weights (threefry cannot be reproduced;
``convert.predictor_from_numpy`` loads the reference's).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core import aoi
from repro_torch.optim import AdamW

MODES = ("none", "stale", "ann")

_EPS = 1e-12
_N_SCALARS = 4  # log-staleness, data weight, log norm ratio, cosine


# ---------------------------------------------------------------------------
# sketch + MLP
# ---------------------------------------------------------------------------


def make_sketch(n_params: int, dim: int, seed: int, segments, *,
                device="cpu"):
    """Count-sketch projection R^P -> R^dim: a random bucket and sign per
    coordinate, drawn in the reference's order and permuted into the
    port's by ``segments`` (``convert.ravel_segments``). Linear, O(P)
    memory, and E||Sx||^2 = ||x||^2."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, n_params).astype(np.int32)
    sign = rng.choice(np.float32([-1.0, 1.0]), n_params)
    idx = torch.from_numpy(convert.to_port_order(idx, segments)).to(device)
    sign = torch.from_numpy(convert.to_port_order(sign, segments)).to(device)

    def sk(vec: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(dim, dtype=torch.float32, device=vec.device)
        return out.index_add_(0, idx, vec * sign)

    return sk


class MLP(nn.Module):
    """Two-hidden-layer MLP (the reference's ``init_mlp``); the head is
    zero-initialised with bias (0.5, 0.5), so the untrained predictor
    already outputs 0.5 * last + 0.5 * aggregate."""

    def __init__(self, d_in: int, d_hidden: int, *, seed: int, device):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)

        def dense(shape):
            w = torch.empty(shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            return nn.Parameter((w * (1.0 / math.sqrt(shape[0]))).to(device))

        zeros = lambda *shape: nn.Parameter(torch.zeros(shape, device=device))
        self.w1 = dense((d_in, d_hidden))
        self.b1 = zeros(d_hidden)
        self.w2 = dense((d_hidden, d_hidden))
        self.b2 = zeros(d_hidden)
        self.w3 = zeros(d_hidden, 2)
        self.b3 = nn.Parameter(torch.tensor([0.5, 0.5], device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.silu(x @ self.w1 + self.b1)
        h = torch.nn.functional.silu(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3


def mlp_coeffs(net: MLP, x: torch.Tensor):
    """x (M, d_in) -> (a, b) each (M,), clipped to [-2, 2] for aggregation
    safety."""
    out = net(x)
    return out[:, 0].clamp(-2.0, 2.0), out[:, 1].clamp(-2.0, 2.0)


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------


class UpdatePredictor:
    """Per-client last-delta store + online-trained coefficient ANN, on the
    device of ``model`` (the parameter template: its flat layout is the
    port's ``model.parameters()`` order)."""

    def __init__(self, model: nn.Module, fl: FLConfig, n_clients: int, *,
                 mode: Optional[str] = None, seed: int = 0):
        self.mode = fl.predictor if mode is None else mode
        if self.mode not in MODES:
            raise ValueError(f"unknown predictor mode {self.mode!r}")
        self.fl = fl
        self.n_clients = n_clients
        named = [(n, p.shape) for n, p in model.named_parameters()]
        self.device = next(model.parameters()).device
        self.n_params = sum(math.prod(s) for _, s in named)
        self.embed_dim = min(fl.pred_embed_dim, self.n_params)
        self.sketch = make_sketch(self.n_params, self.embed_dim,
                                  seed + 20_000, convert.ravel_segments(named),
                                  device=self.device)

        # per-client state, valid where _known is set
        self.store = torch.zeros((n_clients, self.n_params),
                                 dtype=torch.float32, device=self.device)
        self.store_sk = torch.zeros((n_clients, self.embed_dim),
                                    dtype=torch.float32, device=self.device)
        self._known = np.zeros(n_clients, dtype=bool)

        self.d_in = 2 * self.embed_dim + _N_SCALARS
        self.net = MLP(self.d_in, fl.pred_hidden_dim, seed=seed + 20_001,
                       device=self.device)
        self.opt = AdamW(lr=fl.pred_lr, weight_decay=0.0)
        self.opt_state = self.opt.init(list(self.net.parameters()))

    # -- state -------------------------------------------------------------
    def has(self, client: int) -> bool:
        return bool(self._known[client])

    def known(self) -> np.ndarray:
        return self._known.copy()

    # -- features ----------------------------------------------------------
    def _features(self, clients: Sequence[int], ages: np.ndarray,
                  data_weights: np.ndarray, sk_mean: torch.Tensor):
        """Rows of ANN input for ``clients`` (all must have history).

        ``sk_mean`` is one shared aggregate sketch (E,) or one row per
        client (M, E): the leave-one-out means used in training, so the
        target never leaks into its own features."""
        stale = torch.as_tensor(
            aoi.staleness_features(ages, data_weights)[list(clients)],
            dtype=torch.float32, device=self.device)
        sl = self.store_sk[list(clients)]                       # (M, E)
        sm = torch.atleast_2d(sk_mean).expand_as(sl)
        nl = torch.linalg.vector_norm(sl, dim=1, keepdim=True) + _EPS
        nm = torch.linalg.vector_norm(sm, dim=1, keepdim=True) + _EPS
        cos = ((sl / nl) * (sm / nm)).sum(dim=1)
        scalars = torch.stack([stale[:, 0], stale[:, 1],
                               torch.log(nl[:, 0] / nm[:, 0]), cos], dim=1)
        return torch.cat([sl / nl, sm / nm, scalars], dim=1), sl

    # -- online training ---------------------------------------------------
    def _loss(self, x, sk_last, sk_mean, sk_true):
        a, b = mlp_coeffs(self.net, x)
        pred = a[:, None] * sk_last + b[:, None] * sk_mean
        num = ((pred - sk_true) ** 2).sum(dim=1)
        den = (sk_true ** 2).sum(dim=1) + _EPS
        return (num / den).mean()

    def train_on(self, x, sk_last, sk_mean, sk_true, steps: int = 1):
        """Run ``steps`` AdamW steps on one labelled batch; returns the
        loss of the FIRST step (the batch's pre-update loss)."""
        params = list(self.net.parameters())
        first = None
        for _ in range(max(1, steps)):
            loss = self._loss(x, sk_last, sk_mean, sk_true)
            grads = torch.autograd.grad(loss, params)
            self.opt.step(params, grads, self.opt_state)
            first = loss.detach() if first is None else first
        return float(first)

    # -- round interface ---------------------------------------------------
    def observe(self, clients: Sequence[int], rows: torch.Tensor,
                ages: np.ndarray, data_weights: np.ndarray) -> dict:
        """Ingest the deltas that arrived this round: ``rows`` (k, P), one
        per client of ``clients``, in order.

        Returns ``{"pred_loss", "pred_error"}`` where ``pred_error`` is the
        mean relative sketch-space error of predicting the arrivals from
        their pre-round state (measured before the store update and before
        the gradient step). Both use the leave-one-out aggregate: the
        client's own delta is removed from its ``sk_mean`` row, as at
        prediction time, where the predicted client sent nothing.
        """
        clients = [int(c) for c in clients]
        sk_new = [self.sketch(rows[i]) for i in range(len(clients))]
        w = np.asarray([data_weights[c] for c in clients], np.float64)
        w = w / max(w.sum(), _EPS)
        sk_mean = sum(float(wi) * s for wi, s in zip(w, sk_new))

        stats = {"pred_loss": float("nan"), "pred_error": float("nan")}
        # a lone arrival (w ~ 1) has no other update to form a
        # leave-one-out aggregate from: its row is dropped
        hist = [i for i, c in enumerate(clients)
                if self.has(c) and w[i] < 1.0 - 1e-6]
        if hist and self.mode in ("stale", "ann"):
            loo = torch.stack([(sk_mean - float(w[i]) * sk_new[i])
                               / float(1.0 - w[i]) for i in hist])
            x, sl = self._features([clients[i] for i in hist], ages,
                                   data_weights, loo)
            st = torch.stack([sk_new[i] for i in hist])
            if self.mode == "ann":
                with torch.no_grad():
                    a, b = mlp_coeffs(self.net, x)
            else:
                a = torch.ones(len(hist), device=self.device)
                b = torch.zeros(len(hist), device=self.device)
            pred = a[:, None] * sl + b[:, None] * loo
            err = (torch.linalg.vector_norm(pred - st, dim=1)
                   / (torch.linalg.vector_norm(st, dim=1) + _EPS))
            stats["pred_error"] = float(err.mean())
            if self.mode == "ann":
                stats["pred_loss"] = self.train_on(
                    x, sl, loo, st, steps=self.fl.pred_steps)
        for i, c in enumerate(clients):
            self.store[c].copy_(rows[i])
            self.store_sk[c] = sk_new[i]
            self._known[c] = True
        return stats

    def predictable(self, selected: np.ndarray, ages: np.ndarray
                    ) -> np.ndarray:
        """Client ids eligible for prediction this round: unselected, with
        a stored delta, and (if ``pred_max_age`` > 0) not too stale."""
        mask = self._known & ~np.asarray(selected, bool)
        if self.fl.pred_max_age > 0:
            mask &= np.asarray(ages) <= self.fl.pred_max_age
        return np.flatnonzero(mask)

    @torch.no_grad()
    def predict(self, clients: Sequence[int], ages: np.ndarray,
                data_weights: np.ndarray, mean_flat: torch.Tensor,
                out: torch.Tensor) -> None:
        """Write the predicted flat delta of each of ``clients`` (each with
        history) into the rows of ``out`` (len(clients), P), in order.
        ``mean_flat`` (P,) is this round's aggregate of the arrivals."""
        clients = [int(c) for c in clients]
        if not clients:
            return
        if self.mode == "stale":
            for i, c in enumerate(clients):
                out[i].copy_(self.store[c])
            return
        x, _ = self._features(clients, ages, data_weights,
                              self.sketch(mean_flat))
        a, b = mlp_coeffs(self.net, x)
        for i, c in enumerate(clients):
            torch.mul(self.store[c], a[i], out=out[i])
            out[i].addcmul_(mean_flat, b[i])
