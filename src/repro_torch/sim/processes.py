"""Stochastic process primitives of the dynamic wireless scenarios, on
(S, N) tensors.

Counterpart of ``src/repro/sim/processes.py``. ``bessel_j0`` and
``jakes_rho`` are copies (host-side numpy, evaluated once per scenario
config). Every other process is split in two:

  * a draw, which takes a ``torch.Generator`` where the reference takes a
    key (``annulus_positions``, ``multicell_positions``, ``iid_fading_pow``
    and the plain ``torch.rand`` / ``torch.randn`` calls of
    ``sim/scenario.py``);
  * a pure transition, which takes the draw as a tensor
    (``waypoint_step``, ``drift_step``, ``drift_step_multicell``,
    ``ar1_fading_step``, ``shadow_step``, ``bursty_cpu_step``,
    ``data_arrival_step``), so the same transition can be fed the numpy
    draws of ``sim/numpy_ref.py`` in fp64.

Transitions keep the dtype and device of their inputs.

Channel models: i.i.d. block fading (fresh ``|h|^2 ~ Exp(1)`` a round);
Gauss-Markov AR(1) Rayleigh ``h' = rho h + sqrt(1-rho^2) w``, ``w ~
CN(0,1)``, with the Jakes correlation ``rho = J0(2 pi f_d T)``; log-normal
shadowing as an AR(1) in dB with the per-client correlation
``exp(-v T_move / d_corr)`` (Gudmundson). Mobility: fixed, random waypoint
inside the annulus, or constant-velocity drift reflected at the cell edge
and at the BS exclusion disc (multi-cell: at the deployment's outer radius
and at the nearest BS's disc).
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Bessel J0 (host-side, config time): the Jakes autocorrelation
# ---------------------------------------------------------------------------


def bessel_j0(x):
    """J0 via the Abramowitz & Stegun 9.4.1 / 9.4.3 polynomial
    approximations (|err| < 5e-8 over the real line), in numpy."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    small = x <= 3.0
    t = np.where(small, x / 3.0, 0.0)
    t2 = t * t
    p_small = (1.0 + t2 * (-2.2499997 + t2 * (1.2656208 + t2 * (
        -0.3163866 + t2 * (0.0444479 + t2 * (-0.0039444 + t2 * 0.00021))))))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(small, 1.0, 3.0 / np.maximum(x, 3.0))
    f0 = (0.79788456 + s * (-0.00000077 + s * (-0.00552740 + s * (
        -0.00009512 + s * (0.00137237 + s * (-0.00072805
                                             + s * 0.00014476))))))
    th0 = (x - 0.78539816 + s * (-0.04166397 + s * (-0.00003954 + s * (
        0.00262573 + s * (-0.00054125 + s * (-0.00029333
                                             + s * 0.00013558))))))
    p_large = f0 * np.cos(th0) / np.sqrt(np.maximum(x, 3.0))
    out = np.where(small, p_small, p_large)
    return out if out.ndim else float(out)


def jakes_rho(doppler_hz: float, slot_s: float) -> float:
    """Per-round fading autocorrelation ``J0(2 pi f_d T)`` (Jakes)."""
    return float(bessel_j0(2.0 * np.pi * doppler_hz * slot_s))


# ---------------------------------------------------------------------------
# placement (draws)
# ---------------------------------------------------------------------------


def uniform(gen: torch.Generator, shape, lo: float, hi: float, *,
            dtype=torch.float32) -> torch.Tensor:
    """Uniform draw in [lo, hi) on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return lo + (hi - lo) * u


def annulus_xy(r2, th):
    """(x, y) of squared radius ``r2`` and angle ``th``, shape + (2,)."""
    r = torch.sqrt(r2)
    return torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)


def annulus_positions(gen: torch.Generator, shape, r_min: float,
                      r_max: float, *, dtype=torch.float32) -> torch.Tensor:
    """Uniform-in-annulus (x, y) positions, shape ``shape + (2,)``."""
    r2 = uniform(gen, shape, r_min ** 2, r_max ** 2, dtype=dtype)
    th = uniform(gen, shape, 0.0, 2.0 * np.pi, dtype=dtype)
    return annulus_xy(r2, th)


def multicell_positions(gen: torch.Generator, shape, bs: torch.Tensor,
                        r_min: float, r_max: float) -> torch.Tensor:
    """Uniform home cell, then a uniform-in-annulus offset around its BS.
    ``bs`` is the ``(C, 2)`` layout (sim/topology.bs_layout) as a tensor."""
    home = torch.randint(0, bs.shape[0], shape, generator=gen,
                         device=gen.device)
    return bs[home] + annulus_positions(gen, shape, r_min, r_max,
                                        dtype=bs.dtype)


def distances_of(pos, r_min: float):
    """BS distance of (..., 2) positions, floored at the exclusion radius."""
    return torch.clamp(torch.linalg.vector_norm(pos, dim=-1), min=r_min)


def iid_fading_pow(gen: torch.Generator, shape, *,
                   dtype=torch.float32) -> torch.Tensor:
    """Fresh Rayleigh power ``|h|^2 ~ Exp(1)`` (block fading)."""
    return torch.empty(shape, dtype=dtype, device=gen.device).exponential_(
        1.0, generator=gen)


# ---------------------------------------------------------------------------
# mobility transitions
# ---------------------------------------------------------------------------


def waypoint_step(pos, waypoint, speed, new_wp, new_v, *, move_s: float):
    """Random waypoint: advance toward the target by ``speed * move_s``;
    on arrival take the drawn waypoint ``new_wp`` and speed ``new_v``."""
    delta = waypoint - pos
    d = torch.linalg.vector_norm(delta, dim=-1)
    step_len = speed * move_s
    arrived = d <= step_len
    unit = delta / torch.clamp(d, min=1e-9)[..., None]
    pos2 = torch.where(arrived[..., None], waypoint,
                       pos + unit * step_len[..., None])
    waypoint2 = torch.where(arrived[..., None], new_wp, waypoint)
    speed2 = torch.where(arrived, new_v, speed)
    return pos2, waypoint2, speed2


def drift_step(pos, vel, *, move_s: float, r_max: float, r_min: float = 0.0):
    """Vehicular drift: constant velocity, reflected at the cell edge and at
    the ``r_min`` exclusion disc (velocity reversed, position pulled onto
    the violated boundary circle)."""
    pos2 = pos + vel * move_s
    r = torch.linalg.vector_norm(pos2, dim=-1)
    hit = (r > r_max) | (r < r_min)
    vel2 = torch.where(hit[..., None], -vel, vel)
    target = torch.clamp(r, r_min, r_max)
    pos2 = torch.where(hit[..., None],
                       pos2 * (target / torch.clamp(r, min=1e-9))[..., None],
                       pos2)
    return pos2, vel2


def drift_step_multicell(pos, vel, bs, *, move_s: float, region_r: float,
                         r_min: float):
    """Multi-cell drift: reflect at the deployment's outer radius
    (``region_r``, origin-centred) and at the nearest BS's ``r_min``
    disc. The nearest BS is ``torch.argmin``'s, which like ``jnp.argmin``
    and ``np.argmin`` returns the first minimal index, so an exact tie goes
    to the lower cell index in all three packages."""
    pos2 = pos + vel * move_s
    r = torch.linalg.vector_norm(pos2, dim=-1)
    out = r > region_r
    d2 = ((pos2[..., None, :] - bs) ** 2).sum(-1)
    ci = torch.argmin(d2, dim=-1)
    db = pos2 - bs[ci]
    rb = torch.sqrt(d2.gather(-1, ci[..., None])[..., 0])
    inn = rb < r_min
    vel2 = torch.where((out | inn)[..., None], -vel, vel)
    pos_out = pos2 * (region_r / torch.clamp(r, min=1e-9))[..., None]
    pos_inn = bs[ci] + db * (r_min / torch.clamp(rb, min=1e-9))[..., None]
    pos2 = torch.where(inn[..., None], pos_inn,
                       torch.where(out[..., None], pos_out, pos2))
    return pos2, vel2


# ---------------------------------------------------------------------------
# channel transitions
# ---------------------------------------------------------------------------


def ar1_fading_step(h, z, *, rho: float):
    """Gauss-Markov complex fading ``h' = rho h + sqrt(1-rho^2) w`` with
    ``w = z sqrt(0.5) ~ CN(0,1)`` stored as (..., 2) real/imag; ``z`` is a
    standard normal draw of h's shape. Returns (h', |h'|^2)."""
    w = z * float(np.sqrt(0.5))
    h2 = rho * h + float(np.sqrt(max(1.0 - rho * rho, 0.0))) * w
    return h2, (h2 * h2).sum(-1)


def shadow_step(shadow_db, speed, z, *, sigma_db: float, move_s: float,
                decorr_m: float):
    """Gudmundson AR(1) shadowing in dB with the per-client correlation
    ``exp(-v T / d_corr)``; ``z`` is a standard normal draw."""
    rho_s = torch.exp(-speed * move_s / decorr_m)
    return rho_s * shadow_db + torch.sqrt(1.0 - rho_s * rho_s) * sigma_db * z


# ---------------------------------------------------------------------------
# client heterogeneity transitions
# ---------------------------------------------------------------------------


def bursty_cpu_step(throttled, u, *, p_throttle: float, p_recover: float):
    """Two-state (normal/throttled) Markov chain per client; ``u`` is a
    uniform [0, 1) draw."""
    return torch.where(throttled, u >= p_recover, u < p_throttle)


def data_arrival_step(n_cur, n_base, eps, *, phi: float, jitter: float):
    """Mean-reverting AR(1) ``n' = base + phi (n - base) + jitter base eps``
    clipped to [max(1, 0.2 base), 2 base]; ``eps`` is a standard normal
    draw."""
    n2 = n_base + phi * (n_cur - n_base) + jitter * n_base * eps
    return torch.minimum(torch.maximum(n2, torch.clamp(0.2 * n_base,
                                                       min=1.0)),
                         2.0 * n_base)
