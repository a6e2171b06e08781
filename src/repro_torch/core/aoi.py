"""Age-of-Update (AoU) state machine — the paper's selection signal.

Copy of ``src/repro/core/aoi.py`` (numpy, no framework): the state
machine and the update predictor's staleness helpers.

A_n(t) counts rounds since client n's update was last aggregated:
reset to 1 on selection, +1 otherwise. Ages start at 1 so every client has
non-zero priority in round 0.
"""
from __future__ import annotations

import numpy as np


def init_ages(n_clients: int) -> np.ndarray:
    return np.ones(n_clients, dtype=np.int64)


def update_ages(ages: np.ndarray, selected: np.ndarray) -> np.ndarray:
    """selected: bool mask of aggregated clients this round."""
    ages = np.asarray(ages)
    selected = np.asarray(selected, dtype=bool)
    return np.where(selected, 1, ages + 1)


def max_age(ages: np.ndarray) -> int:
    return int(np.max(ages))


def mean_age(ages: np.ndarray) -> float:
    return float(np.mean(ages))


def age_discount(ages: np.ndarray, rho: float) -> np.ndarray:
    """Geometric staleness discount rho^(A_n - 1): 1.0 for a fresh update,
    fading with every round a client goes unserved. Used to down-weight
    predicted updates in the aggregation blend."""
    return np.asarray(rho, np.float64) ** (np.asarray(ages) - 1)


def staleness_features(ages: np.ndarray, data_weights: np.ndarray
                       ) -> np.ndarray:
    """(N, 2) per-round staleness features for the server-side update
    predictor: log-staleness log1p(A_n - 1) and the mean-normalized data
    weight N * w_n (both O(1)-scaled for MLP input)."""
    a = np.log1p(np.asarray(ages, np.float64) - 1.0)
    w = np.asarray(data_weights, np.float64) * len(ages)
    return np.stack([a, w], axis=-1)
