"""Wireless environment of the FL server (numpy, host side).

Counterpart of the ``static_iid`` branch of ``NumpyScenario``
(``src/repro/sim/numpy_ref.py``), single- and multi-cell, with the
``ScenarioConfig`` registry of ``src/repro/sim/scenario.py``. It consumes
the server's ``np.random.Generator`` exactly as the reference does, so the
same seed gives the same cells and gains, and hence the same selections,
in both packages:

  * one cell: at ``init`` the distances, then the CPU base frequencies;
    at each ``step`` one Exp(1) fading vector;
  * ``n_cells > 1``: at ``init`` a uniform home cell per client, an
    annulus offset around its BS (sim/topology.py), the nearest-BS
    association, then the CPU base frequencies; at each ``step`` the
    association, ``last_handovers`` and the distances are recomputed
    (placement is fixed, so no client moves), then one Exp(1) vector.

The dynamic scenarios of the reference (mobility, correlated fading,
shadowing, bursty compute, data arrival) are ROADMAP queue 2 and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig, NOMAConfig
from repro_torch.core import noma
from repro_torch.sim import topology


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Scenario description; the port runs ``static_iid`` only: fixed
    placement, i.i.d. block fading, static compute and data."""
    name: str = "static_iid"


SCENARIOS = {"static_iid": ScenarioConfig(name="static_iid")}

# the reference's other registered scenarios (src/repro/sim/scenario.py)
LATER_SCENARIOS = ("pedestrian", "vehicular", "iot_bursty",
                   "hotspot_shadowed")


def get_scenario_config(name: str) -> ScenarioConfig:
    if name in SCENARIOS:
        return SCENARIOS[name]
    if name in LATER_SCENARIOS:
        raise NotImplementedError(
            f"scenario {name!r} is ROADMAP queue 2 (scenario sampler); "
            f"the port runs {sorted(SCENARIOS)}")
    raise ValueError(f"unknown scenario {name!r} "
                     f"(registered: {sorted(SCENARIOS) + list(LATER_SCENARIOS)})")


class Scenario:
    """Single-env ``static_iid`` environment: (N,)-shaped fp64 state, with
    the serving cell ``cell`` (N,) int32 (all 0 in one cell)."""

    def __init__(self, scfg: ScenarioConfig, ncfg: NOMAConfig,
                 flcfg: FLConfig):
        self.cfg = scfg
        self.ncfg = ncfg
        self.n_cells = flcfg.n_cells
        self.bs = topology.bs_layout(flcfg.n_cells, flcfg.cell_layout,
                                     ncfg.cell_radius_m)
        self.cpu_lo = flcfg.cpu_freq_range_ghz[0] * 1e9
        self.cpu_hi = flcfg.cpu_freq_range_ghz[1] * 1e9
        self.distances: Optional[np.ndarray] = None

    def init(self, rng: np.random.Generator, n: int,
             n_samples: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Draw the initial environment; returns (distances, cpu_freq)."""
        self.last_handovers = 0
        if self.n_cells > 1:
            home = rng.integers(0, self.n_cells, n)
            self.pos = self.bs[home] + noma.sample_positions(rng, n,
                                                             self.ncfg)
            self.cell, d = topology.nearest_cell(self.pos, self.bs)
            self.distances = np.maximum(d, self.ncfg.min_radius_m)
        else:
            self.distances = noma.sample_distances(rng, n, self.ncfg)
            self.pos = None
            self.cell = np.zeros(n, np.int32)
        self.cpu_base = rng.uniform(self.cpu_lo, self.cpu_hi, n)
        self.n_cur = np.asarray(n_samples, np.float64).copy()
        return self.distances, self.cpu_base.copy()

    def step(self, rng: np.random.Generator
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance one round; returns (gains, n_samples, cpu_freq) fp64."""
        if self.n_cells > 1:
            cell, d = topology.nearest_cell(self.pos, self.bs)
            self.last_handovers = int(np.sum(cell != self.cell))
            self.cell = cell
            self.distances = np.maximum(d, self.ncfg.min_radius_m)
        gains = noma.sample_gains(rng, self.distances, self.ncfg)
        return gains, self.n_cur.copy(), self.cpu_base.copy()
