"""Experiment driver: run one policy.

Counterpart of ``run_experiment`` in ``src/repro/fl/rounds.py``. The
policy comparisons and the Monte-Carlo sweep (``run_montecarlo``) are
ROADMAP queue 2; the pre-sampled rollout it drives is
``WirelessEngine.montecarlo_rounds`` (core/engine.py).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import FLConfig, ModelConfig, NOMAConfig
from repro_torch.data import TaskConfig
from repro_torch.fl.server import FLServer, History


def run_experiment(model_cfg: ModelConfig, fl: FLConfig,
                   nomacfg: NOMAConfig, task: TaskConfig, policy: str, *,
                   rounds: Optional[int] = None, verbose: bool = False,
                   seed: Optional[int] = None, device="cuda",
                   kernel_backend: Optional[str] = None,
                   pairing: Optional[str] = None,
                   selection: Optional[str] = None) -> History:
    server = FLServer(model_cfg, fl, nomacfg, task, policy=policy,
                      seed=seed, device=device,
                      kernel_backend=kernel_backend, pairing=pairing,
                      selection=selection)
    return server.run(rounds, verbose=verbose)
