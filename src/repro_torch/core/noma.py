"""Uplink NOMA topology and fading samplers (numpy, host side).

Copy of ``sample_distances``, ``sample_positions`` and ``sample_gains``
from ``src/repro/core/noma.py``. They consume a ``np.random.Generator``
exactly as the reference does, so the same seed gives the same
placements and gains in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import NOMAConfig


def sample_distances(rng: np.random.Generator, n: int,
                     cfg: NOMAConfig) -> np.ndarray:
    """Uniform-in-annulus client placement around the BS."""
    r2 = rng.uniform(cfg.min_radius_m ** 2, cfg.cell_radius_m ** 2, size=n)
    return np.sqrt(r2)


def sample_positions(rng: np.random.Generator, n: int,
                     cfg: NOMAConfig) -> np.ndarray:
    """(n, 2) uniform-in-annulus (x, y) positions."""
    r = np.sqrt(rng.uniform(cfg.min_radius_m ** 2, cfg.cell_radius_m ** 2,
                            size=n))
    th = rng.uniform(0.0, 2.0 * np.pi, size=n)
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)


def sample_gains(rng: np.random.Generator, distances: np.ndarray,
                 cfg: NOMAConfig) -> np.ndarray:
    """Block-fading channel power gains g_n = rho0 * d^-kappa * |h|^2,
    |h|^2 ~ Exp(1) (Rayleigh)."""
    fading = rng.exponential(1.0, size=distances.shape)
    return cfg.ref_path_loss * distances ** (-cfg.path_loss_exp) * fading
