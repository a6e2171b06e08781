"""Experiment entry points: run one policy or compare all (the paper's
figures), plus the Monte-Carlo wireless sweep (``run_montecarlo``) of
every selection/RA policy over S environment seeds, the scenario stepping
on the engine's device between batched rounds.

Counterpart of ``src/repro/fl/rounds.py``: ``run_experiment``,
``compare_policies``, ``compare_predictors``, ``run_montecarlo``,
``time_to_accuracy`` and ``MC_POLICIES``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (  # noqa: F401  (POLICIES re-export)
    POLICIES, FLConfig, ModelConfig, NOMAConfig,
)
from repro_torch.core.engine import WirelessEngine
from repro_torch.data import TaskConfig
from repro_torch.fl.server import FLServer, History
from repro_torch.obs import RunLedger
from repro_torch.sim import as_scenario

# the Monte-Carlo sweep covers every FLServer policy
MC_POLICIES = POLICIES


def run_experiment(model_cfg: ModelConfig, fl: FLConfig,
                   nomacfg: NOMAConfig, task: TaskConfig, policy: str, *,
                   rounds: Optional[int] = None, verbose: bool = False,
                   seed: Optional[int] = None, device="cuda",
                   kernel_backend: Optional[str] = None,
                   pairing: Optional[str] = None,
                   selection: Optional[str] = None,
                   predictor: Optional[str] = None) -> History:
    server = FLServer(model_cfg, fl, nomacfg, task, policy=policy,
                      seed=seed, device=device,
                      kernel_backend=kernel_backend, pairing=pairing,
                      selection=selection, predictor=predictor)
    return server.run(rounds, verbose=verbose)


def compare_policies(model_cfg: ModelConfig, fl: FLConfig,
                     nomacfg: NOMAConfig, task: TaskConfig, *,
                     policies=POLICIES, rounds: Optional[int] = None,
                     verbose: bool = False, seed: Optional[int] = None,
                     predictor: Optional[str] = None,
                     device="cuda") -> dict[str, History]:
    """Same seed => identical client data/topology across policies; only
    the selection/RA differs (paired comparison, as the paper's figures
    do)."""
    return {p: run_experiment(model_cfg, fl, nomacfg, task, p,
                              rounds=rounds, verbose=verbose, seed=seed,
                              predictor=predictor, device=device)
            for p in policies}


def compare_predictors(model_cfg: ModelConfig, fl: FLConfig,
                       nomacfg: NOMAConfig, task: TaskConfig, *,
                       policy: str = "age_noma",
                       modes=("none", "stale", "ann"),
                       rounds: Optional[int] = None, verbose: bool = False,
                       seed: Optional[int] = None,
                       device="cuda") -> dict[str, History]:
    """A/B the update predictor under ONE selection policy. Same seed =>
    identical topology, gains, selections and local batches across modes
    (the predictor never touches the server rng), so differences are
    purely the blended predicted updates."""
    return {m: run_experiment(model_cfg, fl, nomacfg, task, policy,
                              rounds=rounds, verbose=verbose, seed=seed,
                              predictor=m, device=device)
            for m in modes}


def run_montecarlo(nomacfg: Optional[NOMAConfig] = None,
                   flcfg: Optional[FLConfig] = None, *,
                   n_clients: int = 64, n_seeds: int = 32, rounds: int = 20,
                   policies=MC_POLICIES, model_bits: float = 1e6,
                   t_budget: float = 0.0, seed: int = 0,
                   kernel_backend: Optional[str] = None,
                   scenario="static_iid", presampled: bool = False,
                   shard: bool = False, pairing: Optional[str] = None,
                   selection: Optional[str] = None,
                   admission: Optional[str] = None,
                   device="cuda") -> dict:
    """Wireless-layer Monte-Carlo: compare selection/RA policies over
    ``n_seeds`` environment seeds x ``rounds``, one batched engine call a
    round, on ``device`` (default ``"cuda"``).

    ``scenario`` (registry name, ``ScenarioConfig`` or ``Scenario``)
    selects the environment dynamics (``repro_torch.sim``); its state
    steps on the device inside the rollout under the integer key ``seed``
    (``WirelessEngine.montecarlo_scenario``). ``presampled=True``
    generates the same env sequence with ``Scenario.rollout`` and replays
    it through ``montecarlo_rounds``: bitwise the same results. Every
    policy sees the same key, hence the same environments (paired
    comparison). ``shard=True`` splits the seeds over the visible cards
    (core/engine.py).

    ``age_noma_budget`` with ``t_budget <= 0`` calibrates its budget to
    2x the mean channel-greedy round time of round 0. With
    ``FLConfig.n_cells > 1`` each round's cell association drives the
    cell-partitioned planner and ``handover_rate`` is the mean fraction of
    clients whose serving BS changed a round. Returns per-policy raw
    arrays (numpy), a ``summary`` per policy with the reference's key set
    for every policy and cell count (``handover_rate`` / ``t_budget_s``
    None where they do not apply), and ``meta``. The sweep is recorded to
    a ``montecarlo`` run ledger (one ``policy_done`` event a policy;
    ``REPRO_LEDGER=0`` disables).
    """
    nomacfg = nomacfg or NOMAConfig()
    flcfg = flcfg or FLConfig()
    eng = WirelessEngine(nomacfg, flcfg, device=device,
                         kernel_backend=kernel_backend, pairing=pairing,
                         selection=selection, admission=admission)
    scn = as_scenario(scenario, nomacfg, flcfg, device=eng.device)
    s, n, r = n_seeds, n_clients, rounds
    multicell = flcfg.n_cells > 1
    envs = (scn.rollout(seed, r, (s, n), device=eng.device) if presampled
            else None)
    auto_budget = None
    if "age_noma_budget" in policies and t_budget <= 0.0:
        # round 0 of the same key schedule the policies run on
        env0 = (tuple(a[0] for a in envs) if envs is not None
                else scn.first_env(seed, r, (s, n), device=eng.device))
        ref = eng.schedule_batch(
            env0[0], env0[1], env0[2],
            torch.ones((s, n), dtype=torch.float32, device=eng.device),
            model_bits, priority=env0[0],
            cell=env0[3] if multicell else None)
        auto_budget = 2.0 * max(float(ref.t_round.mean()), 1e-6)

    results: dict = {"summary": {}, "meta": {
        "n_clients": n, "n_seeds": s, "rounds": r,
        "model_bits": model_bits, "t_budget": t_budget,
        "scenario": scn.name, "presampled": bool(presampled),
        "slots": eng.prm.slots,
        "kernel_backend": (flcfg.kernel_backend if kernel_backend is None
                           else kernel_backend),
        "kernel_impl": "cuda" if eng.device.type == "cuda" else "torch",
        "pairing": eng.pairing, "selection": eng.selection,
        "admission": eng.admission,
        "n_cells": flcfg.n_cells, "cell_layout": flcfg.cell_layout,
        "device": str(eng.device)}}
    ledger = RunLedger.open("montecarlo", {
        **results["meta"], "policies": list(policies), "seed": seed})
    try:
        for policy in policies:
            tb = t_budget
            if policy == "age_noma_budget" and tb <= 0.0:
                tb = auto_budget
            if envs is not None:
                out = eng.montecarlo_rounds(
                    envs.gains, envs.n_samples, envs.cpu_freq, model_bits,
                    policy=policy, t_budget=tb, seed=seed, shard=shard,
                    cell_seq=envs.cell if multicell else None)
            else:
                out = eng.montecarlo_scenario(
                    scn, rounds=r, n_seeds=s, n_clients=n,
                    model_bits=model_bits, policy=policy, t_budget=tb,
                    seed=seed, key=seed, shard=shard)
            results[policy] = {k: v.cpu().numpy() for k, v in out.items()}
            results["summary"][policy] = _summarize(results[policy], n,
                                                    policy, tb)
            ledger.event("policy_done", policy=policy,
                         summary=results["summary"][policy])
    finally:
        ledger.close()
    return results


def _summarize(out: dict, n: int, policy: str, t_budget) -> dict:
    """One policy's summary from its raw numpy arrays: the reference's key
    set for every policy and cell count (``handover_rate`` and
    ``t_budget_s`` None where they do not apply)."""
    t_round = np.asarray(out["t_round"])          # (R, S)
    part = np.asarray(out["participation"])       # (S, N)
    jain = (part.sum(1) ** 2
            / np.maximum(n * (part ** 2).sum(1), 1e-12))  # (S,)
    return {
        "mean_t_round_s": float(t_round.mean()),
        "total_time_s": float(t_round.sum(0).mean()),
        "max_age": int(np.asarray(out["max_age"]).max()),
        "mean_max_age": float(np.asarray(out["max_age"]).mean()),
        "jain_participation": float(jain.mean()),
        # round-time decomposition of the bottleneck pair
        "mean_t_comp_bottleneck_s": float(
            np.asarray(out["t_comp_bottleneck"]).mean()),
        "mean_t_up_bottleneck_s": float(
            np.asarray(out["t_up_bottleneck"]).mean()),
        "mean_n_evicted": float(np.asarray(out["n_evicted"]).mean()),
        # population AoU histogram summed over rounds x seeds
        "aou_hist": np.asarray(out["aou_hist"]).sum(axis=(0, 1)).tolist(),
        "handover_rate": (float(np.asarray(out["handovers"]).mean() / n)
                          if "handovers" in out else None),
        "t_budget_s": (float(t_budget) if policy == "age_noma_budget"
                       else None),
    }


def time_to_accuracy(hist: History, target: float) -> Optional[float]:
    """Simulated seconds to first reach ``target`` accuracy (None = never)."""
    for t, a in zip(hist.sim_time, hist.accuracy):
        if a >= target:
            return t
    return None
