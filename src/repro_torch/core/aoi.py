"""Age-of-Update (AoU) state machine — the paper's selection signal.

Copy of the state machine in ``src/repro/core/aoi.py`` (numpy, no
framework); the predictor's staleness helpers are ROADMAP queue 3.

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
