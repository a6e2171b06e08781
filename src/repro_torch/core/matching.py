"""Batched assignment solvers of the matching pairing policies.

Counterpart of ``src/repro/core/matching.py``: ``hungarian_assignment``,
``greedy_assignment``, ``_gather_pairs``, ``pair_bottleneck``,
``best_bottleneck_matching``, ``two_opt_refine`` (whose six table
lookups per step are one ``_gather_pairs`` call, so the reference's
per-entry ``_gather2`` has no counterpart) and ``pad_cost_table``. The reference runs them as
XLA loops (``fori_loop`` / ``while_loop`` under ``vmap``), not in a Pallas
kernel, so here they are plain batched tensor code on the tensors'
device: a leading batch dim written out, and every loop a Python loop of
fixed length.

No loop reads a tensor back to the host. Each ``while_loop`` of the
reference has a bound: the Dijkstra scan for row r ends within r + 1
scans (only r columns are assigned, so the (r + 1)-th scanned column is
free) and the augmentation within r + 1 steps. Both run exactly that many
iterations here, with a "still searching" / "still augmenting" mask that
makes the extra ones no-ops.

Tiebreaks: ``torch.argmin``/``argmax`` return the first extremum, as
``jnp.argmin``/``argmax`` do, and the fp32 operation order of the reduced
costs and the dual updates is the reference's, so ``col4row`` equals the
reference's bit for bit on the same fp32 table.

The budget path's candidate count varies per row, so it passes a per-row
``m_valid`` (B,): ``pad_cost_table`` masks the static (P, P) cost table
(valid-valid entries keep their cost, mixed entries get ``BIG``,
invalid-invalid ones ``fill_invalid``), ``pair_bottleneck`` scores padded
trailing rows -inf and ``two_opt_refine`` applies an update only where
``y < m_valid``. With ``m_valid=None`` every result is bitwise what it is
without the mask.
"""
from __future__ import annotations

import torch

INF = float("inf")
BIG = 1e30   # >> any real completion time (<= ~1e16 s), << fp32 max


def _flat(table: torch.Tensor) -> torch.Tensor:
    return table.reshape(-1, *table.shape[-2:])


def hungarian_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Min-sum assignment over (..., m, m) cost tables -> (..., m) int64
    ``col4row`` per instance (shortest augmenting paths with dual
    potentials)."""
    lead, m = cost.shape[:-2], cost.shape[-1]
    cost = _flat(cost)
    b, dev, dt = cost.shape[0], cost.device, cost.dtype
    rows = torch.arange(b, device=dev)
    idx = torch.arange(m, device=dev)
    u = torch.zeros((b, m), dtype=dt, device=dev)
    v = torch.zeros((b, m), dtype=dt, device=dev)
    col4row = torch.full((b, m), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((b, m), -1, dtype=torch.int64, device=dev)
    for cur_row in range(m):
        shortest = torch.full((b, m), INF, dtype=dt, device=dev)
        path = torch.full((b, m), -1, dtype=torch.int64, device=dev)
        scanned_r = torch.zeros((b, m), dtype=torch.bool, device=dev)
        scanned_c = torch.zeros((b, m), dtype=torch.bool, device=dev)
        i = torch.full((b,), cur_row, dtype=torch.int64, device=dev)
        min_val = torch.zeros((b,), dtype=dt, device=dev)
        sink = torch.full((b,), -1, dtype=torch.int64, device=dev)
        for _ in range(cur_row + 1):            # Dijkstra column scan
            act = sink < 0
            scanned_r[rows, i] |= act
            red = min_val[:, None] + cost[rows, i] - u[rows, i][:, None] - v
            upd = act[:, None] & ~scanned_c & (red < shortest)
            shortest = torch.where(upd, red, shortest)
            path = torch.where(upd, i[:, None], path)
            masked = torch.where(scanned_c, INF, shortest)
            j = masked.argmin(dim=1)
            min_val = torch.where(act, masked[rows, j], min_val)
            scanned_c[rows, j] |= act
            owner = row4col[rows, j]
            free = owner < 0
            sink = torch.where(act & free, j, sink)
            i = torch.where(act & ~free, owner, i)

        # dual update (scanned rows other than cur_row are all assigned, so
        # col4row is a valid index there; the clamp guards masked lanes)
        u[:, cur_row] += min_val
        other = scanned_r & (idx != cur_row)
        u = u + torch.where(
            other, min_val[:, None]
            - shortest.gather(1, col4row.clamp(0, m - 1)), 0.0)
        v = v - torch.where(scanned_c, min_val[:, None] - shortest, 0.0)

        j = sink                                 # augment along the path
        for _ in range(cur_row + 1):
            act = j >= 0
            jc = j.clamp(min=0)
            i = path[rows, jc]
            ic = i.clamp(min=0)
            row4col[rows, jc] = torch.where(act, i, row4col[rows, jc])
            nxt = torch.where(i == cur_row, -1, col4row[rows, ic])
            col4row[rows, ic] = torch.where(act, jc, col4row[rows, ic])
            j = torch.where(act, nxt, j)
    return col4row.reshape(*lead, m)


def greedy_assignment(score: torch.Tensor) -> torch.Tensor:
    """Greedy max-score matching over (..., m, m) -> (..., m) int64: m
    times, take the highest-scoring available (row, column) cell."""
    lead, m = score.shape[:-2], score.shape[-1]
    score = _flat(score)
    b, dev = score.shape[0], score.device
    rows = torch.arange(b, device=dev)
    col4row = torch.full((b, m), -1, dtype=torch.int64, device=dev)
    avail_r = torch.ones((b, m), dtype=torch.bool, device=dev)
    avail_c = torch.ones((b, m), dtype=torch.bool, device=dev)
    for _ in range(m):
        masked = torch.where(avail_r[:, :, None] & avail_c[:, None, :],
                             score, -INF)
        flat = masked.reshape(b, m * m).argmax(dim=1)
        p, j = flat // m, flat % m
        col4row[rows, p] = j
        avail_r[rows, p] = False
        avail_c[rows, j] = False
    return col4row.reshape(*lead, m)


def _gather_pairs(table: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """table (..., c, c) at per-pair indices rows/cols (..., k) -> (..., k)
    (clamped into the table)."""
    c = table.shape[-1]
    flat_idx = rows.clamp(0, c - 1) * c + cols.clamp(0, c - 1)
    return table.flatten(-2).gather(-1, flat_idx)


def pair_bottleneck(table: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, m_valid=None) -> torch.Tensor:
    """Worst pair completion of the matching {(rows[k], cols[k])}: the
    metric the hungarian policy's restarts and never-slower guard compare
    on. ``m_valid`` (...,) masks padded trailing rows; an all-pad matching
    scores -inf, so strict-< guards reject it."""
    vals = _gather_pairs(table, rows, cols)
    if m_valid is not None:
        k = torch.arange(rows.shape[-1], device=rows.device)
        vals = torch.where(k < m_valid[..., None], vals, -INF)
    return vals.amax(dim=-1)


def best_bottleneck_matching(table: torch.Tensor, inits, m_valid=None,
                             sweeps: int = 2):
    """Multi-start bottleneck 2-opt: refine each (a0, b0) init and keep the
    matching with the smallest worst-pair completion (strict improvement
    only, earliest init wins ties)."""
    a_p = b_p = best_t = None
    for a0, b0 in inits:
        ca, cb = two_opt_refine(table, a0, b0, m_valid=m_valid,
                                sweeps=sweeps)
        t = pair_bottleneck(table, ca, cb, m_valid)
        if a_p is None:
            a_p, b_p, best_t = ca, cb, t
        else:
            better = (t < best_t)[..., None]
            a_p = torch.where(better, ca, a_p)
            b_p = torch.where(better, cb, b_p)
            best_t = torch.minimum(best_t, t)
    return a_p, b_p


def two_opt_refine(table: torch.Tensor, strong_pos: torch.Tensor,
                   weak_pos: torch.Tensor, m_valid=None, sweeps: int = 2):
    """Bottleneck 2-opt over the full (..., c, c) sorted-rank completion
    table, walking the reference's static (sweep, x, y) schedule. For each
    pair of pairs the two re-pairings are adopted only on a strict
    improvement of the max completion; equal alternatives prefer the
    first. The six table entries of a step are one gather. ``m_valid``
    (...,) gates the updates where trailing rows are padding."""
    m = strong_pos.shape[-1]
    a = strong_pos.to(torch.int64).clone()
    b = weak_pos.to(torch.int64).clone()
    for _ in range(sweeps):
        for x in range(m):
            for y in range(x + 1, m):
                pa, pb, qa, qb = a[..., x], b[..., x], a[..., y], b[..., y]
                # option 1: (pa, qa) + (pb, qb); option 2: (pa, qb) + (pb, qa)
                o1 = (torch.minimum(pa, qa), torch.maximum(pa, qa),
                      torch.minimum(pb, qb), torch.maximum(pb, qb))
                o2 = (torch.minimum(pa, qb), torch.maximum(pa, qb),
                      torch.minimum(pb, qa), torch.maximum(pb, qa))
                vals = _gather_pairs(
                    table, torch.stack([pa, qa, o1[0], o1[2], o2[0], o2[2]],
                                       dim=-1),
                    torch.stack([pb, qb, o1[1], o1[3], o2[1], o2[3]],
                                dim=-1))
                cur = torch.maximum(vals[..., 0], vals[..., 1])
                alt1 = torch.maximum(vals[..., 2], vals[..., 3])
                alt2 = torch.maximum(vals[..., 4], vals[..., 5])
                ok = True if m_valid is None else y < m_valid
                take1 = ok & (alt1 < cur) & (alt1 <= alt2)
                take2 = ok & (alt2 < cur) & ~take1
                pick = lambda v1, v2, keep: torch.where(
                    take1, v1, torch.where(take2, v2, keep))
                new = (pick(o1[0], o2[0], pa), pick(o1[1], o2[1], pb),
                       pick(o1[2], o2[2], qa), pick(o1[3], o2[3], qb))
                a[..., x], b[..., x], a[..., y], b[..., y] = new
    return a, b


def pad_cost_table(cost: torch.Tensor, m_valid: torch.Tensor,
                   fill_invalid: float = 0.0) -> torch.Tensor:
    """Mask a fixed-shape (..., P, P) table for a per-instance valid size
    ``m_valid`` (...,): rows/cols >= m_valid are invalid. Valid-invalid
    entries get ``BIG`` so the min-sum assignment never mixes them;
    invalid-invalid entries get ``fill_invalid``."""
    p = cost.shape[-1]
    i = torch.arange(p, device=cost.device)
    mv = m_valid[..., None]
    vr = (i < mv)[..., :, None]
    vc = (i < mv)[..., None, :]
    return torch.where(vr & vc, cost, torch.where(
        vr ^ vc, torch.tensor(BIG, dtype=cost.dtype, device=cost.device),
        torch.tensor(fill_invalid, dtype=cost.dtype, device=cost.device)))
