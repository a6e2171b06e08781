"""Multi-cell topology: base-station layouts and nearest-BS association
(numpy, host side; the association also on tensors).

Copy of ``bs_layout``, ``region_radius``, ``nearest_cell`` and
``CellTopology`` from ``src/repro/sim/topology.py`` (DESIGN.md section
10): ``n_cells`` base stations on a hex spiral or a square grid with
inter-BS spacing ``sqrt(3) * cell_radius_m``, and each client served by
its nearest BS (Voronoi association). A client that crosses a Voronoi
boundary is handed over: only its association index changes.

Layouts are fp64, cached per ``(n_cells, layout, radius)`` and read-only.
``nearest_cell_torch`` is the association on tensors (the device scenario,
sim/scenario.py).
``n_cells == 1`` is one BS at the origin.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import CELL_LAYOUTS, FLConfig, NOMAConfig

__all__ = ["CellTopology", "bs_layout", "region_radius", "nearest_cell",
           "nearest_cell_torch"]


@functools.lru_cache(maxsize=None)
def bs_layout(n_cells: int, layout: str, cell_radius_m: float) -> np.ndarray:
    """Deterministic ``(n_cells, 2)`` fp64 BS coordinates (read-only).

    Candidate sites are enumerated out to a ring/box that holds
    ``n_cells`` points, then taken in ``(distance-from-origin, angle)``
    order, so the first C sites of a (C+1)-cell layout are the C-cell
    layout.
    """
    if n_cells < 1:
        raise ValueError(f"n_cells must be >= 1, got {n_cells}")
    if layout not in CELL_LAYOUTS:
        raise ValueError(f"unknown cell layout {layout!r} "
                         f"(expected one of {CELL_LAYOUTS})")
    if n_cells == 1:
        pts = np.zeros((1, 2))
    elif layout == "hex":
        k = 0
        while 3 * k * (k + 1) + 1 < n_cells:
            k += 1
        d = np.sqrt(3.0) * cell_radius_m
        sites = []
        for q in range(-k, k + 1):
            for r in range(-k, k + 1):
                if max(abs(q), abs(r), abs(-q - r)) <= k:
                    sites.append((d * (q + 0.5 * r),
                                  d * (np.sqrt(3.0) / 2.0) * r))
        pts = _closest_first(np.array(sites))[:n_cells]
    else:  # grid
        k = int(np.ceil(np.sqrt(n_cells)))
        d = np.sqrt(3.0) * cell_radius_m
        ij = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
        xx, yy = np.meshgrid(ij * d, ij * d, indexing="ij")
        pts = _closest_first(np.stack([xx.ravel(), yy.ravel()],
                                      axis=-1))[:n_cells]
    pts = np.ascontiguousarray(pts)
    pts.flags.writeable = False
    return pts


def _closest_first(pts: np.ndarray) -> np.ndarray:
    """Order sites by (rounded distance, angle): rounding makes same-ring
    ties resolve by angle instead of fp noise."""
    dist = np.hypot(pts[:, 0], pts[:, 1])
    ang = np.arctan2(pts[:, 1], pts[:, 0])
    return pts[np.lexsort((ang, np.round(dist, 6)))]


def region_radius(n_cells: int, layout: str, cell_radius_m: float) -> float:
    """Outer radius of the whole deployment: the farthest BS plus one cell
    radius (``cell_radius_m`` when ``n_cells == 1``)."""
    bs = bs_layout(n_cells, layout, cell_radius_m)
    return float(np.linalg.norm(bs, axis=-1).max()) + cell_radius_m


def nearest_cell(pos, bs):
    """Voronoi association: ``(cell int32, dist)`` of the nearest BS for
    ``pos`` (..., 2) against ``bs`` (C, 2). ``dist`` is the true distance
    to the serving BS; callers floor it at ``min_radius_m``."""
    pos = np.asarray(pos)
    d2 = ((pos[..., None, :] - bs) ** 2).sum(-1)
    cell = np.argmin(d2, axis=-1)
    d2c = np.take_along_axis(d2, cell[..., None], axis=-1)[..., 0]
    return cell.astype(np.int32), np.sqrt(d2c)


def nearest_cell_torch(pos, bs):
    """``nearest_cell`` on tensors: ``pos`` (..., 2) against ``bs`` (C, 2),
    a tensor of pos's dtype and device; ``(cell int32, dist)``. Exact ties
    go to the lower cell index, as with ``np.argmin``."""
    d2 = ((pos[..., None, :] - bs) ** 2).sum(-1)
    cell = torch.argmin(d2, dim=-1)
    d2c = d2.gather(-1, cell[..., None])[..., 0]
    return cell.to(torch.int32), torch.sqrt(d2c)


@dataclasses.dataclass(frozen=True)
class CellTopology:
    """Resolved multi-cell geometry (layout + radii), the config-facing
    companion of ``FLConfig.n_cells``/``cell_layout``."""

    n_cells: int = 1
    layout: str = "hex"
    cell_radius_m: float = 500.0
    min_radius_m: float = 50.0

    def __post_init__(self) -> None:
        if self.n_cells < 1:
            raise ValueError(f"n_cells must be >= 1, got {self.n_cells}")
        if self.layout not in CELL_LAYOUTS:
            raise ValueError(f"unknown cell layout {self.layout!r} "
                             f"(expected one of {CELL_LAYOUTS})")
        if self.min_radius_m < 0.0 or self.min_radius_m >= self.cell_radius_m:
            raise ValueError(
                f"need 0 <= min_radius_m < cell_radius_m, got "
                f"({self.min_radius_m}, {self.cell_radius_m})")

    @classmethod
    def from_configs(cls, ncfg: NOMAConfig, flcfg: FLConfig) -> "CellTopology":
        return cls(n_cells=flcfg.n_cells, layout=flcfg.cell_layout,
                   cell_radius_m=ncfg.cell_radius_m,
                   min_radius_m=ncfg.min_radius_m)

    @property
    def bs_xy(self) -> np.ndarray:
        return bs_layout(self.n_cells, self.layout, self.cell_radius_m)

    @property
    def region_radius_m(self) -> float:
        return region_radius(self.n_cells, self.layout, self.cell_radius_m)

    def cell_of(self, pos):
        return nearest_cell(pos, self.bs_xy)
