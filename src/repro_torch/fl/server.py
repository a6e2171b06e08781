"""FL server: round orchestration joining the scheduler (core/) to the
training substrate (models/, optim/, data/), on one device.

Counterpart of ``FLServer`` and ``History`` in ``src/repro/fl/server.py``:
every policy (``age_noma_budget`` included),
every registered scenario (``FLConfig.scenario`` or the ``scenario=``
override), one cell or ``FLConfig.n_cells > 1``, under every pairing
policy and both selection modes (``FLConfig.pairing`` / ``selection``, or
the ``pairing=`` / ``selection=`` overrides). ``run`` records the
reference's ``fl_run`` ledger (obs/ledger.py). As on the reference's engine
path, ``History.joint_swaps`` reads 0: the engine's joint refinement is
branch-free and reports no swap count.

``age_noma_budget`` is the age priority under a round-time budget:
``FLConfig.t_budget_s`` if set, else twice the channel-greedy round time
of the first round (at least 1e-6 s), computed once. The reference
calibrates on its fp64 numpy planner; here the engine computes it (channel
priority, no budget, the config's pairing and selection) in fp32. Per
round:

  1. step the wireless scenario (sim/numpy_ref.py, the reference's
     ``NumpyScenario``) -> gains/n_samples/cpu; build RoundEnv (incl. the
     current AoU ages). Under dynamic scenarios the env's n_samples and
     cpu only shape the scheduler's view (age priority, T_cmp): local
     batches and aggregation weights stay tied to the fixed datasets;
  2. run the selection policy through the engine (core/engine.py) ->
     Schedule (mask, pairs, powers, rates, T_round), with the pairing
     policy and the selection mode of the config;
  3. run local SGD for each selected client, writing its delta into one
     row of a (C, P) fp32 buffer (C: the most clients the planner can
     select, the sum over cells of min(slots, cell capacity), at most
     ``n_clients``);
  4. with ``predictor`` "stale" or "ann" (fl/predictor.py): train the
     server-side ANN on the arrivals, write a predicted delta for each
     unselected client with history into the buffer rows after the
     arrivals (the buffer then has ``n_clients`` rows), and weight them
     ``n_c * pred_blend * pred_discount^(A_c - 1)`` (one more fedagg
     launch: the arrivals' mean, which the ANN's predictions mix in);
  5. FedAvg-aggregate the rows (one fedagg launch) and apply;
  6. advance the ages and the simulated wall clock by T_round.

``self.rng`` is consumed in exactly the reference's order (scenario init;
then per round the scenario step and each selected client's batches in
ascending client order), so a seed gives the same selections in both
packages; the predictor never draws from it, so ``none``, ``stale`` and
``ann`` select the same clients.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import FLConfig, ModelConfig, NOMAConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import aoi, plan
from repro_torch.core.engine import WirelessEngine, round_robin_priority
from repro_torch.core.plan import RoundEnv, Schedule, cell_capacity
from repro_torch.data import (TaskConfig, balanced_eval_set, client_batches,
                              partition_clients)
from repro_torch.fl.aggregate import (aggregate_deltas, apply_aggregate,
                                      blend_deltas)
from repro_torch.fl.client import LocalTrainer
from repro_torch.fl.predictor import UpdatePredictor
from repro_torch.models import zoo
from repro_torch.obs import RunLedger, json_safe, trace
from repro_torch.sim import NumpyScenario, get_scenario_config

# a round's predictor telemetry when nothing was predicted
# families the FL round does not train. The reference's round cannot
# either: its client batches carry tokens only, so ``zoo.token_loss`` cuts
# ``n_prefix_tokens`` logits that a prefix-less vlm batch never had
# (src/repro/models/zoo.py:221-222; a shape error), and ``zoo.forward``
# reads the encdec batch's missing ``"frames"`` (zoo.py:197-198; a
# KeyError).
UNTRAINED_FAMILIES = ("vlm", "encdec")


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse a config whose family the FL round does not train."""
    if cfg.family in UNTRAINED_FAMILIES:
        raise ValueError(
            f"the FL round does not train the {cfg.family} family "
            f"({cfg.name}): its client batches are tokens only, with no "
            f"image prefix or encoder frames, and the reference's round "
            f"fails on them too (vlm: zoo.token_loss cuts "
            f"{cfg.n_prefix_tokens} prefix logits the batch never had, "
            f"src/repro/models/zoo.py:221-222; encdec: zoo.forward reads "
            f"the missing batch['frames'], zoo.py:197-198)")


_NO_PREDICTION = {"n_predicted": 0, "pred_loss": float("nan"),
                  "pred_error": float("nan")}


@dataclasses.dataclass
class History:
    rounds: list = dataclasses.field(default_factory=list)
    sim_time: list = dataclasses.field(default_factory=list)
    round_time: list = dataclasses.field(default_factory=list)
    accuracy: list = dataclasses.field(default_factory=list)
    loss: list = dataclasses.field(default_factory=list)
    max_age: list = dataclasses.field(default_factory=list)
    mean_age: list = dataclasses.field(default_factory=list)
    n_selected: list = dataclasses.field(default_factory=list)
    # update-predictor telemetry (all-nan / zeros when predictor == "none")
    n_predicted: list = dataclasses.field(default_factory=list)
    pred_loss: list = dataclasses.field(default_factory=list)
    pred_error: list = dataclasses.field(default_factory=list)
    # round-time decomposition + planner diagnostics (DESIGN.md section 11)
    t_comp_bottleneck: list = dataclasses.field(default_factory=list)
    t_up_bottleneck: list = dataclasses.field(default_factory=list)
    n_evicted: list = dataclasses.field(default_factory=list)
    joint_swaps: list = dataclasses.field(default_factory=list)
    aou_hist: list = dataclasses.field(default_factory=list)
    # per-cell selection + handover counts (empty lists when n_cells == 1)
    sel_per_cell: list = dataclasses.field(default_factory=list)
    handovers: list = dataclasses.field(default_factory=list)
    participation: Optional[np.ndarray] = None

    def as_dict(self):
        """JSON-safe dict via ``obs.json_safe``: array leaves become
        (nested) lists, non-finite floats None (the predictor telemetry is
        NaN on rounds without predictions, and bare NaN tokens break
        strict JSON parsers)."""
        return {k: json_safe(v)
                for k, v in dataclasses.asdict(self).items()}


class FLServer:
    """FL over NOMA on ``device`` (default ``"cuda"``).

    ``kernel_backend`` (default ``FLConfig.kernel_backend``) is checked
    against the device (kernels/backend.py); on a CUDA device the engine
    and the aggregation launch the CUDA kernels.
    ``params`` optionally supplies the initial weights as the reference's
    numpy parameter tree (convert.py); else ``zoo.init_model`` draws them.
    ``predictor`` (default ``FLConfig.predictor``): none | stale | ann.
    """

    def __init__(self, model_cfg: ModelConfig, fl: FLConfig,
                 nomacfg: NOMAConfig, task: TaskConfig, *,
                 policy: str = "age_noma", eval_every: int = 5,
                 seed: Optional[int] = None, device="cuda",
                 kernel_backend: Optional[str] = None,
                 params: Optional[dict] = None,
                 scenario: Optional[str] = None,
                 pairing: Optional[str] = None,
                 selection: Optional[str] = None,
                 predictor: Optional[str] = None):
        check_trainable(model_cfg)
        if pairing is not None:
            fl = dataclasses.replace(fl, pairing=pairing)
        if selection is not None:
            fl = dataclasses.replace(fl, selection=selection)
        self.cfg = model_cfg
        self.fl = fl
        self.noma = nomacfg
        self.task = task
        self.policy = policy
        self.eval_every = eval_every
        self.predictor_mode = fl.predictor if predictor is None else predictor
        self.engine = WirelessEngine(nomacfg, fl, device=device,
                                     kernel_backend=kernel_backend)
        self.device = self.engine.device
        seed = fl.seed if seed is None else seed
        self.rng = np.random.default_rng(seed + 10_000)

        # clients + wireless environment (the numpy scenario twin)
        self.clients = partition_clients(fl, task)
        self.n_samples = np.array([c.n_samples for c in self.clients],
                                  dtype=np.float64)
        self.scenario_name = fl.scenario if scenario is None else scenario
        self.scenario = NumpyScenario(
            get_scenario_config(self.scenario_name), nomacfg, fl)
        self.distances, self.cpu_freq = self.scenario.init(
            self.rng, fl.n_clients, n_samples=self.n_samples)

        # model, trainer, update predictor and the (C, P) fp32 delta buffer
        if params is None:
            self.model = zoo.init_model(model_cfg, seed=seed,
                                        device=self.device)
        else:
            self.model = zoo.DecoderLM(model_cfg, self.device)
            self.model.load_state_dict(
                params_from_numpy(params, model_cfg, self.device))
        self.trainer = LocalTrainer(model_cfg, fl.lr, fl.momentum,
                                    device=self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.model_bits = fl.model_bits or float(n_params) * 32.0
        # the predictor has its own seed: it must not perturb the
        # selection rng stream, so none/stale/ann stay paired
        self.predictor = None
        if self.predictor_mode != "none":
            self.predictor = UpdatePredictor(
                self.model, fl, fl.n_clients, mode=self.predictor_mode,
                seed=seed)
        slots = nomacfg.n_subchannels * nomacfg.users_per_subchannel
        per_cell = min(slots, cell_capacity(fl.n_clients, fl.n_cells, slots))
        # arrivals, then (with the predictor) a prediction for every
        # other client
        rows = (fl.n_clients if self.predictor is not None
                else min(fl.n_cells * per_cell, fl.n_clients))
        self.deltas = torch.empty((rows, n_params), dtype=torch.float32,
                                  device=self.device)

        self.ages = aoi.init_ages(fl.n_clients)
        self._auto_budget: Optional[float] = None
        self.pred_stats = dict(_NO_PREDICTION)
        self.t_sim = 0.0
        self.round_idx = 0
        self.eval_tokens = torch.as_tensor(balanced_eval_set(task),
                                           device=self.device).long()

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def evaluate(self):
        tokens = self.eval_tokens
        labels = tokens[:, 1:]
        logits, _ = zoo.forward(self.cfg, self.model, tokens[:, :-1])
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        loss = zoo.token_loss(self.cfg, logits, labels)
        return float(acc), float(loss)

    # -- scheduling --------------------------------------------------------
    def select(self, env: RoundEnv) -> Schedule:
        """Every policy resolves to the engine's age priority (under the
        budget for ``age_noma_budget``) or an explicit priority vector (no
        budget); with ``n_cells > 1`` the engine plans each cell on the
        scenario's current association."""
        p = self.policy
        n = self.fl.n_clients
        multicell = self.fl.n_cells > 1
        cell = self.scenario.cell if multicell else None
        t_budget = None          # None: FLConfig.t_budget_s
        priority = None          # None: the paper's age priority
        if p == "age_noma_budget":
            t_budget = self._budget(env, cell)
        elif p == "random":
            priority, t_budget = self.rng.uniform(size=n), 0.0
        elif p == "channel":
            priority, t_budget = env.gains, 0.0
        elif p == "round_robin":
            slots = min(self.noma.n_subchannels
                        * self.noma.users_per_subchannel, n)
            priority = round_robin_priority(self.round_idx, n, slots,
                                            self.device)
            t_budget = 0.0
        elif p not in ("age_noma", "oma_age"):
            raise ValueError(f"unknown policy {p!r}")
        return self.engine.schedule(env, t_budget=t_budget,
                                    oma=p == "oma_age", policy=p,
                                    priority=priority, cell=cell)

    def _budget(self, env: RoundEnv, cell) -> float:
        """The ``age_noma_budget`` round-time budget, fixed on first use."""
        if self._auto_budget is None:
            budget = self.fl.t_budget_s
            if budget <= 0.0:
                budget = 2.0 * max(self._channel_greedy_time(env, cell),
                                   1e-6)
            self._auto_budget = budget
        return self._auto_budget

    def _channel_greedy_time(self, env: RoundEnv, cell) -> float:
        """Round time of the channel-greedy schedule (channel priority, no
        budget). With cells, each cell is planned alone on its real
        members (the first ``cell_capacity`` in index order) and the
        slowest cell's time is taken, as ``plan.plan_multicell`` does."""
        if cell is None:
            return self.engine.schedule(env, t_budget=0.0, policy="channel",
                                        priority=env.gains).t_round
        slots = self.noma.n_subchannels * self.noma.users_per_subchannel
        cap = cell_capacity(len(env.gains), self.fl.n_cells, slots)
        t_round = 0.0
        for k in range(self.fl.n_cells):
            mem = np.flatnonzero(cell == k)[:cap]
            if mem.size:
                sub = RoundEnv(gains=env.gains[mem],
                               n_samples=env.n_samples[mem],
                               cpu_freq=env.cpu_freq[mem],
                               ages=env.ages[mem], model_bits=env.model_bits)
                t_round = max(t_round, self.engine.schedule(
                    sub, t_budget=0.0, policy="channel",
                    priority=sub.gains).t_round)
        return t_round

    def run_round(self) -> Schedule:
        """One round (steps 1-6 above). Spans: ``server.round`` (fenced on
        the model; ``r``, the selected ids, local ``steps`` and ``tokens``
        and the kernel wrappers' ``launches`` in the round) holds
        ``server.scenario``, ``server.select``, one ``client.local_update``
        a selected client (fl/client.py), then ``server.aggregate`` and
        ``server.apply`` (``rows``), or the predictor's spans."""
        tracing = trace.get_tracer().enabled
        if tracing:
            steps0, tokens0 = self.trainer.steps, self.trainer.tokens
            launches0 = kernels.launch_counts()
        with trace.span("server.round", fenced=True,
                        r=self.round_idx) as sp:
            with trace.span("server.scenario"):
                gains, env_n_samples, env_cpu = self.scenario.step(self.rng)
            env = RoundEnv(gains=gains, n_samples=env_n_samples,
                           cpu_freq=env_cpu, ages=self.ages,
                           model_bits=self.model_bits)
            with trace.span("server.select", fenced=True):
                sched = self.select(env)

            sel = np.flatnonzero(sched.selected)
            for row, ci in enumerate(sel):
                batches = client_batches(self.rng, self.clients[ci],
                                         self.fl.local_batch,
                                         self.fl.local_epochs)
                self.trainer.local_update(self.model, batches,
                                          self.deltas[row])
            self.pred_stats = dict(_NO_PREDICTION)
            if len(sel) and self.predictor is None:
                with trace.span("server.aggregate", fenced=True,
                                rows=len(sel)) as ag:
                    agg = aggregate_deltas(self.deltas[:len(sel)],
                                           self.n_samples[sel])
                    ag.fence(agg)
                with trace.span("server.apply", fenced=True,
                                rows=len(sel)):
                    apply_aggregate(self.model, agg)
            elif len(sel):
                self._aggregate_with_predictions(sel)

            self.ages = aoi.update_ages(self.ages, sched.selected)
            self.t_sim += sched.t_round
            self.round_idx += 1
            if tracing:
                launches = kernels.launch_counts()
                sp.note(selected=sel.tolist(),
                        steps=self.trainer.steps - steps0,
                        tokens=self.trainer.tokens - tokens0,
                        launches={k: v - launches0[k]
                                  for k, v in launches.items()})
            sp.fence(list(self.model.parameters()))
        return sched

    def _aggregate_with_predictions(self, sel: np.ndarray) -> None:
        """Predictor path: train on the arrivals (buffer rows ``:k``),
        write the unselected clients' predictions into rows ``k:k + M``,
        blend all ``k + M`` rows with age-discounted weights, apply."""
        pred = self.predictor
        k = len(sel)
        real = self.deltas[:k]
        data_w = self.n_samples / self.n_samples.sum()
        with trace.span("predictor.observe", fenced=True, k=k) as sp:
            stats = pred.observe(sel, real, self.ages, data_w)
            sp.fence(pred.store_sk)

        w_real = self.n_samples[sel]
        mean_flat = aggregate_deltas(real, w_real)
        selected = np.zeros(self.fl.n_clients, bool)
        selected[sel] = True
        targets = pred.predictable(selected, self.ages)
        m = len(targets)
        with trace.span("predictor.predict", fenced=True, m=m) as sp:
            pred.predict(targets, self.ages, data_w, mean_flat,
                         out=self.deltas[k:k + m])
            sp.fence(self.deltas)
        w_pred = (self.n_samples[targets] * self.fl.pred_blend
                  * aoi.age_discount(self.ages[targets],
                                     self.fl.pred_discount))
        with trace.span("server.blend", fenced=True, rows=k + m) as sp:
            agg = blend_deltas(self.deltas[:k + m], w_real, w_pred)
            sp.fence(agg)
        apply_aggregate(self.model, agg)
        self.pred_stats = {"n_predicted": m, **stats}

    # -- full experiment ---------------------------------------------------
    def run(self, rounds: Optional[int] = None, *, verbose: bool = False,
            ledger: Optional[RunLedger] = None) -> History:
        """Run ``rounds`` FL rounds -> ``History``, recorded to a JSONL run
        ledger under ``experiments/runs/`` (pass ``ledger`` to reuse an
        open one; ``REPRO_LEDGER=0`` disables)."""
        rounds = rounds or self.fl.rounds
        own_ledger = ledger is None
        if own_ledger:
            ledger = RunLedger.open("fl_run", {
                "policy": self.policy, "rounds": rounds,
                "engine": self.fl.engine, "scenario": self.scenario_name,
                "predictor": self.predictor_mode,
                "fl": dataclasses.asdict(self.fl),
                "noma": dataclasses.asdict(self.noma),
                "model": dataclasses.asdict(self.cfg)})
        try:
            return self._run(rounds, verbose, ledger)
        finally:
            if own_ledger:
                ledger.close()

    def _run(self, rounds: int, verbose: bool, ledger: RunLedger) -> History:
        hist = History()
        part = np.zeros(self.fl.n_clients)
        multicell = self.fl.n_cells > 1
        prev_cell = self.scenario.cell.copy()
        for r in range(rounds):
            sched = self.run_round()
            part += sched.selected
            if r % self.eval_every == 0 or r == rounds - 1:
                acc, loss = self.evaluate()
            cell = self.scenario.cell
            diag = plan.schedule_diag(sched, self.ages,
                                      cell=cell if multicell else None,
                                      n_cells=self.fl.n_cells)
            hist.rounds.append(r)
            hist.sim_time.append(self.t_sim)
            hist.round_time.append(sched.t_round)
            hist.accuracy.append(acc)
            hist.loss.append(loss)
            hist.max_age.append(aoi.max_age(self.ages))
            hist.mean_age.append(aoi.mean_age(self.ages))
            hist.n_selected.append(int(sched.selected.sum()))
            hist.n_predicted.append(self.pred_stats["n_predicted"])
            hist.pred_loss.append(self.pred_stats["pred_loss"])
            hist.pred_error.append(self.pred_stats["pred_error"])
            hist.t_comp_bottleneck.append(diag["t_comp_bottleneck"])
            hist.t_up_bottleneck.append(diag["t_up_bottleneck"])
            hist.n_evicted.append(diag["n_evicted"])
            hist.joint_swaps.append(diag["joint_swaps_accepted"])
            hist.aou_hist.append(diag["aou_hist"].tolist())
            if multicell:
                hist.sel_per_cell.append(diag["sel_per_cell"].tolist())
                hist.handovers.append(int(np.sum(cell != prev_cell)))
                prev_cell = cell.copy()
            ledger.event(
                "round", r=r, t_round=sched.t_round, sim_time=self.t_sim,
                accuracy=acc, loss=loss, n_selected=hist.n_selected[-1],
                max_age=hist.max_age[-1],
                t_comp_bottleneck=diag["t_comp_bottleneck"],
                t_up_bottleneck=diag["t_up_bottleneck"],
                n_evicted=diag["n_evicted"],
                n_predicted=self.pred_stats["n_predicted"])
            if verbose and r % self.eval_every == 0:
                print(f"[{self.policy}] round {r:3d} t={self.t_sim:9.1f}s "
                      f"acc={acc:.4f} loss={loss:.4f} "
                      f"max_age={hist.max_age[-1]}")
        hist.participation = part
        ledger.event("history", **hist.as_dict())
        return hist
