"""Numpy fp64 twin of the scenario processes: the FLServer's wireless
environment.

Copy of ``NumpyScenario`` from ``src/repro/sim/numpy_ref.py``, every
branch: waypoint and drift mobility, single- and multi-cell, AR(1)
fading, shadowing, bursty CPU and dynamic data. It drives one (N,)-shaped
environment from a shared ``np.random.Generator`` and consumes it draw for
draw as the reference does, so a seed gives bitwise the same environment
in both packages. Under ``static_iid`` the draws are the legacy stream:
``noma.sample_distances`` then the CPU uniform at init, one ``Exp(1)``
vector a round. Draws of disabled processes are skipped, never burned.

A step draws in this order, each only where its process is enabled: the
waypoint target (home cell, then the annulus radius and angle) and speed;
the AR(1) normal (or the i.i.d. exponential); the shadowing normal; the
bursty uniform; the data normal. ``sim/processes.py`` holds the same
transitions on tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig, NOMAConfig
from repro_torch.core import noma
from repro_torch.sim import topology as T
from repro_torch.sim.scenario import ScenarioConfig, ScenarioParams


class NumpyScenario:
    """Single-env fp64 scenario with the same process semantics as the
    device ``Scenario`` (sim/scenario.py)."""

    def __init__(self, scfg: ScenarioConfig, ncfg: NOMAConfig,
                 flcfg: FLConfig):
        self.cfg = scfg
        self.ncfg = ncfg
        self.prm = ScenarioParams.from_configs(scfg, ncfg, flcfg)
        self.distances: Optional[np.ndarray] = None

    @property
    def name(self) -> str:
        return self.cfg.name

    # -- init --------------------------------------------------------------

    def _annulus(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return noma.sample_positions(rng, n, self.ncfg)

    def _multicell_annulus(self, rng: np.random.Generator,
                           n: int) -> np.ndarray:
        """Uniform home cell + annulus offset around its BS; collapses to
        the plain (stream-identical) annulus draw when n_cells == 1."""
        if not self.multicell:
            return self._annulus(rng, n)
        home = rng.integers(0, self.prm.n_cells, n)
        return self.bs[home] + self._annulus(rng, n)

    def init(self, rng: np.random.Generator, n: int,
             n_samples: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw the initial environment; returns (distances, cpu_freq).

        ``n_samples`` (the server's real client dataset sizes) seeds the
        data-arrival base; left None they are drawn uniform in the
        configured range (the Monte-Carlo convention).
        """
        prm = self.prm
        self.n = n
        self.multicell = prm.n_cells > 1
        self.bs = T.bs_layout(prm.n_cells, prm.cell_layout,
                              prm.cell_radius_m)
        self.last_handovers = 0
        if self.multicell:
            # multi-cell is always position-based (the serving BS is
            # derived from position even under fixed mobility); the
            # legacy-stream pin below only covers the n_cells=1 default
            self.pos = self._multicell_annulus(rng, n)
            self.cell, d = T.nearest_cell(self.pos, self.bs)
            self.distances = np.maximum(d, prm.min_radius_m)
        elif prm.mobility == "fixed":
            # legacy stream: one uniform draw via noma.sample_distances
            self.distances = noma.sample_distances(rng, n, self.ncfg)
            self.pos = None
            self.cell = np.zeros(n, np.int32)
        else:
            self.pos = self._annulus(rng, n)
            self.distances = np.maximum(
                np.linalg.norm(self.pos, axis=-1), prm.min_radius_m)
            self.cell = np.zeros(n, np.int32)
        self.cpu_base = rng.uniform(prm.cpu_lo, prm.cpu_hi, n)
        # draws below only exist for the processes that are enabled, so the
        # static_iid stream stays exactly (distances, cpu)
        if prm.mobility != "fixed":
            self.speed = rng.uniform(prm.v_min, prm.v_max, n)
            if prm.mobility == "waypoint":
                self.aux = self._multicell_annulus(rng, n)
            else:
                th = rng.uniform(0.0, 2.0 * np.pi, n)
                self.aux = self.speed[:, None] * np.stack(
                    [np.cos(th), np.sin(th)], axis=-1)
        else:
            self.speed = np.zeros(n)
            self.aux = None
        if prm.channel == "ar1":
            self.h = rng.normal(size=(n, 2)) * np.sqrt(0.5)
        if prm.shadow_sigma_db > 0.0:
            self.shadow_db = rng.normal(0.0, prm.shadow_sigma_db, n)
        else:
            self.shadow_db = np.zeros(n)
        self.throttled = np.zeros(n, bool)
        self.n_base = (np.asarray(n_samples, np.float64)
                       if n_samples is not None
                       else rng.uniform(prm.ns_lo, prm.ns_hi, n))
        self.n_cur = self.n_base.copy()
        return self.distances, self.cpu_base.copy()

    # -- step --------------------------------------------------------------

    def step(self, rng: np.random.Generator
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance one round; returns (gains, n_samples, cpu_freq) fp64."""
        prm = self.prm
        n = self.n

        if prm.mobility == "waypoint":
            delta = self.aux - self.pos
            d = np.linalg.norm(delta, axis=-1)
            step_len = self.speed * prm.move_s
            arrived = d <= step_len
            unit = delta / np.maximum(d, 1e-9)[:, None]
            self.pos = np.where(arrived[:, None], self.aux,
                                self.pos + unit * step_len[:, None])
            new_wp = self._multicell_annulus(rng, n)
            new_v = rng.uniform(prm.v_min, prm.v_max, n)
            self.aux = np.where(arrived[:, None], new_wp, self.aux)
            self.speed = np.where(arrived, new_v, self.speed)
        elif prm.mobility == "drift" and not self.multicell:
            # reflect at the cell edge AND the BS exclusion disc
            # (bit-identical to processes.drift_step with r_min set)
            pos2 = self.pos + self.aux * prm.move_s
            r = np.linalg.norm(pos2, axis=-1)
            hit = (r > prm.cell_radius_m) | (r < prm.min_radius_m)
            self.aux = np.where(hit[:, None], -self.aux, self.aux)
            target = np.clip(r, prm.min_radius_m, prm.cell_radius_m)
            self.pos = np.where(
                hit[:, None],
                pos2 * (target / np.maximum(r, 1e-9))[:, None], pos2)
        elif prm.mobility == "drift":
            # multi-cell twin of processes.drift_step_multicell: reflect
            # at the deployment's outer radius and the nearest BS's disc
            pos2 = self.pos + self.aux * prm.move_s
            r = np.linalg.norm(pos2, axis=-1)
            region_r = T.region_radius(prm.n_cells, prm.cell_layout,
                                       prm.cell_radius_m)
            out = r > region_r
            ci, rb = T.nearest_cell(pos2, self.bs)
            db = pos2 - self.bs[ci]
            inn = rb < prm.min_radius_m
            self.aux = np.where((out | inn)[:, None], -self.aux, self.aux)
            pos_out = pos2 * (region_r / np.maximum(r, 1e-9))[:, None]
            pos_inn = (self.bs[ci]
                       + db * (prm.min_radius_m
                               / np.maximum(rb, 1e-9))[:, None])
            self.pos = np.where(inn[:, None], pos_inn,
                                np.where(out[:, None], pos_out, pos2))
        if self.multicell:
            cell, d = T.nearest_cell(self.pos, self.bs)
            self.last_handovers = int(np.sum(cell != self.cell))
            self.cell = cell
            self.distances = np.maximum(d, prm.min_radius_m)
        elif prm.mobility != "fixed":
            self.distances = np.maximum(
                np.linalg.norm(self.pos, axis=-1), prm.min_radius_m)

        if prm.channel == "ar1":
            w = rng.normal(size=(n, 2)) * np.sqrt(0.5)
            rho = prm.rho_fading
            self.h = rho * self.h + np.sqrt(max(1.0 - rho * rho, 0.0)) * w
            fpow = np.sum(self.h * self.h, axis=-1)
            gains = (prm.ref_path_loss
                     * self.distances ** (-prm.path_loss_exp) * fpow)
        else:
            # exactly noma.sample_gains: one Exp(1) draw (legacy stream)
            gains = noma.sample_gains(rng, self.distances, self.ncfg)
        if prm.shadow_sigma_db > 0.0:
            if prm.mobility != "fixed":
                rho_s = np.exp(-self.speed * prm.move_s
                               / prm.shadow_decorr_m)
                z = rng.normal(size=n)
                self.shadow_db = (rho_s * self.shadow_db
                                  + np.sqrt(1.0 - rho_s * rho_s)
                                  * prm.shadow_sigma_db * z)
            gains = gains * 10.0 ** (self.shadow_db / 10.0)

        cpu = self.cpu_base
        if prm.compute == "bursty":
            u = rng.uniform(size=n)
            self.throttled = np.where(self.throttled, u >= prm.p_recover,
                                      u < prm.p_throttle)
            cpu = cpu * np.where(self.throttled, prm.throttle_factor, 1.0)

        if prm.data == "dynamic":
            eps = rng.normal(size=n)
            n2 = (self.n_base + prm.data_phi * (self.n_cur - self.n_base)
                  + prm.data_jitter * self.n_base * eps)
            self.n_cur = np.clip(n2, np.maximum(0.2 * self.n_base, 1.0),
                                 2.0 * self.n_base)

        return gains, self.n_cur.copy(), np.asarray(cpu, np.float64).copy()
