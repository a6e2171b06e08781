"""Dynamic wireless scenarios as batched state transitions on (S, N)
tensors, stepped on the engine's device between Monte-Carlo rounds.

Counterpart of ``src/repro/sim/scenario.py``: ``ScenarioConfig``,
``ScenarioParams`` (same ``ValueError``s), ``ScenarioState`` and
``RoundEnvBatch`` as NamedTuples of tensors (under ``channel="iid"`` the
fading leaf is a zero-size ``(S, N, 0)`` tensor), ``Scenario`` with
``init`` / ``step`` / ``init_and_keys`` / ``first_env`` / ``rollout``, the
five-entry ``SCENARIOS`` registry, ``get_scenario_config`` and
``as_scenario``. The FLServer's single-env numpy twin is
``sim/numpy_ref.py``.

A scenario composes three processes (sim/processes.py): the channel (iid or
AR(1) fading, optional log-normal shadowing), mobility (fixed, waypoint or
drift) and client heterogeneity (bursty CPU, time-varying data). A step
is a draw (``Scenario.draw``: every random tensor of the round, from one
``torch.Generator``, in the numpy twin's order) and a pure transition
(``Scenario.transition``), which keeps its inputs' dtype and device.

The key schedule. JAX's threefry schedule cannot be reproduced, so a key
here is an integer: ``init_and_keys(key, rounds, shape)`` derives one seed
for init and one a round from ``np.random.SeedSequence(key)``, and each
seeds a ``torch.Generator`` on the scenario's device. ``rollout`` and the
engine's fused loop (``WirelessEngine.montecarlo_scenario``) therefore see
identical draws, ``first_env`` is init plus round 0 alone, and a run is
reproducible on one device. CUDA and CPU generators draw different
numbers from one seed, so a scenario on the card is not the CPU's.

``block=(start, stop, total)`` runs rows ``start:stop`` of a ``total``-row
batch: the draws are made for all ``total`` rows and sliced, and every
transition is per client, so a block's state is bitwise its rows of the
whole batch's (the seed split of ``shard=True``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, NOMAConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.sim import processes as P
from repro_torch.sim import topology as T

Block = Optional[Tuple[int, int, int]]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """User-facing scenario description (see ``SCENARIOS`` for presets).

    ``channel="iid"`` redraws ``|h|^2 ~ Exp(1)`` each round (the paper's
    block fading); ``"ar1"`` evolves complex Gauss-Markov fading with
    Jakes correlation ``rho = J0(2 pi doppler_hz slot_s)``. Shadowing is
    enabled by ``shadow_sigma_db > 0`` and composes with either channel.
    ``move_s`` is the mobility/shadowing timestep per FL round (seconds).
    """
    name: str = "static_iid"
    # channel
    channel: str = "iid"                 # iid | ar1
    doppler_hz: float = 0.0              # f_d for the Jakes correlation
    slot_s: float = 1e-3                 # coherence step T in rho=J0(2pi f T)
    shadow_sigma_db: float = 0.0         # 0 = no shadowing
    shadow_decorr_m: float = 50.0        # Gudmundson decorrelation distance
    # mobility
    mobility: str = "fixed"              # fixed | waypoint | drift
    speed_mps: Tuple[float, float] = (0.0, 0.0)
    move_s: float = 1.0                  # wall-clock advanced per round
    # compute heterogeneity
    compute: str = "static"              # static | bursty
    throttle_factor: float = 0.4         # cpu multiplier while throttled
    p_throttle: float = 0.05             # P(normal -> throttled) per round
    p_recover: float = 0.25              # P(throttled -> normal) per round
    # data arrival
    data: str = "static"                 # static | dynamic
    data_phi: float = 0.9                # AR(1) mean reversion
    data_jitter: float = 0.1             # innovation std / base size


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """Hashable scalars of a scenario, resolved against the NOMA and FL
    configs."""
    channel: str
    rho_fading: float
    shadow_sigma_db: float
    shadow_decorr_m: float
    mobility: str
    v_min: float
    v_max: float
    move_s: float
    compute: str
    throttle_factor: float
    p_throttle: float
    p_recover: float
    data: str
    data_phi: float
    data_jitter: float
    ref_path_loss: float
    path_loss_exp: float
    min_radius_m: float
    cell_radius_m: float
    cpu_lo: float
    cpu_hi: float
    ns_lo: float
    ns_hi: float
    n_cells: int = 1
    cell_layout: str = "hex"

    @classmethod
    def from_configs(cls, scfg: ScenarioConfig, ncfg: NOMAConfig,
                     flcfg: FLConfig) -> "ScenarioParams":
        if scfg.channel not in ("iid", "ar1"):
            raise ValueError(f"unknown channel model {scfg.channel!r}")
        if scfg.mobility not in ("fixed", "waypoint", "drift"):
            raise ValueError(f"unknown mobility model {scfg.mobility!r}")
        if scfg.compute not in ("static", "bursty"):
            raise ValueError(f"unknown compute model {scfg.compute!r}")
        if scfg.data not in ("static", "dynamic"):
            raise ValueError(f"unknown data model {scfg.data!r}")
        if scfg.speed_mps[0] > scfg.speed_mps[1]:
            raise ValueError(f"speed_mps range must be (v_min <= v_max), "
                             f"got {scfg.speed_mps}")
        if scfg.speed_mps[0] < 0.0:
            raise ValueError(f"speed_mps must be non-negative, "
                             f"got {scfg.speed_mps}")
        if scfg.shadow_sigma_db < 0.0:
            raise ValueError(f"shadow_sigma_db must be >= 0, "
                             f"got {scfg.shadow_sigma_db}")
        if scfg.shadow_decorr_m <= 0.0:
            raise ValueError(f"shadow_decorr_m must be > 0, "
                             f"got {scfg.shadow_decorr_m}")
        if scfg.move_s <= 0.0:
            raise ValueError(f"move_s must be > 0, got {scfg.move_s}")
        return cls(
            channel=scfg.channel,
            rho_fading=P.jakes_rho(scfg.doppler_hz, scfg.slot_s),
            shadow_sigma_db=scfg.shadow_sigma_db,
            shadow_decorr_m=scfg.shadow_decorr_m,
            mobility=scfg.mobility,
            v_min=scfg.speed_mps[0], v_max=scfg.speed_mps[1],
            move_s=scfg.move_s,
            compute=scfg.compute,
            throttle_factor=scfg.throttle_factor,
            p_throttle=scfg.p_throttle, p_recover=scfg.p_recover,
            data=scfg.data,
            data_phi=scfg.data_phi, data_jitter=scfg.data_jitter,
            ref_path_loss=ncfg.ref_path_loss,
            path_loss_exp=ncfg.path_loss_exp,
            min_radius_m=ncfg.min_radius_m,
            cell_radius_m=ncfg.cell_radius_m,
            cpu_lo=flcfg.cpu_freq_range_ghz[0] * 1e9,
            cpu_hi=flcfg.cpu_freq_range_ghz[1] * 1e9,
            ns_lo=float(flcfg.samples_per_client[0]),
            ns_hi=float(flcfg.samples_per_client[1]),
            n_cells=flcfg.n_cells,
            cell_layout=flcfg.cell_layout,
        )


# ---------------------------------------------------------------------------
# state, per-round env, draws
# ---------------------------------------------------------------------------


class ScenarioState(NamedTuple):
    """The environment state; every leaf's leading dims are (S, N).
    ``aux`` is the waypoint target (waypoint) or the velocity (drift),
    zeros under fixed mobility. ``fading`` is the complex AR(1) state, a
    zero-size ``(S, N, 0)`` leaf under ``channel="iid"``. ``cell`` is the
    serving BS, derived from position every step (all 0 in one cell)."""
    pos: torch.Tensor          # (S, N, 2) m
    aux: torch.Tensor          # (S, N, 2) m | m/s
    speed: torch.Tensor        # (S, N) m/s
    fading: torch.Tensor       # (S, N, 2) re/im (ar1; else (S, N, 0))
    shadow_db: torch.Tensor    # (S, N) dB
    cpu_base: torch.Tensor     # (S, N) Hz
    throttled: torch.Tensor    # (S, N) bool
    n_base: torch.Tensor       # (S, N) samples
    n_cur: torch.Tensor        # (S, N) samples
    cell: torch.Tensor         # (S, N) int32 serving-BS index


class RoundEnvBatch(NamedTuple):
    """What the engine schedules each round: (S, N) fp32 and the int32
    ``cell``; ``rollout`` stacks R of them into (R, S, N)."""
    gains: torch.Tensor
    n_samples: torch.Tensor
    cpu_freq: torch.Tensor
    cell: torch.Tensor


class StepDraws(NamedTuple):
    """One round's random tensors, in draw order; None where the process
    is disabled (nothing is drawn for it)."""
    new_wp: Optional[torch.Tensor]     # (S, N, 2) waypoint redraw
    new_v: Optional[torch.Tensor]      # (S, N) waypoint speed redraw
    fading_z: Optional[torch.Tensor]   # (S, N, 2) AR(1) standard normal
    fpow: Optional[torch.Tensor]       # (S, N) iid Exp(1) power
    shadow_z: Optional[torch.Tensor]   # (S, N) shadowing standard normal
    cpu_u: Optional[torch.Tensor]      # (S, N) bursty uniform
    data_eps: Optional[torch.Tensor]   # (S, N) data standard normal


def _rows(x, block: Block):
    return x if block is None else x[block[0]:block[1]]


def key_seeds(key: int, rounds: int) -> list:
    """The key schedule: one seed for init, then one a round."""
    return [int(x) for x in np.random.SeedSequence(int(key)).generate_state(
        rounds + 1, np.uint64)]


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


class Scenario:
    """A (ScenarioConfig, NOMAConfig, FLConfig) triple on ``device``
    (default ``"cuda"``). Duck-typed by
    ``WirelessEngine.montecarlo_scenario``, which calls
    ``init_and_keys(key, rounds, (S, N), device=..., block=...)`` and
    ``step(state, seed, block=...)``. Every method takes ``device`` to
    override the scenario's own (the engine runs it on its device)."""

    def __init__(self, scfg: ScenarioConfig, ncfg: NOMAConfig,
                 flcfg: FLConfig, device="cuda"):
        self.cfg = scfg
        self.prm = ScenarioParams.from_configs(scfg, ncfg, flcfg)
        self.device = resolve_device(device)
        self._bs_cache: dict = {}

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def multicell(self) -> bool:
        return self.prm.n_cells > 1

    def _bs(self, device, dtype=torch.float32) -> torch.Tensor:
        """The (C, 2) BS layout as a tensor (cached per device and dtype)."""
        k = (device, dtype)
        if k not in self._bs_cache:
            prm = self.prm
            self._bs_cache[k] = torch.tensor(
                T.bs_layout(prm.n_cells, prm.cell_layout, prm.cell_radius_m),
                dtype=dtype, device=device)
        return self._bs_cache[k]

    def _positions(self, gen, shape):
        prm = self.prm
        if self.multicell:
            return P.multicell_positions(
                gen, shape, self._bs(gen.device),
                prm.min_radius_m, prm.cell_radius_m)
        return P.annulus_positions(gen, shape, prm.min_radius_m,
                                   prm.cell_radius_m)

    # -- init ----------------------------------------------------------------

    def init(self, key: int, shape: Tuple[int, int], *, device=None,
             block: Block = None) -> ScenarioState:
        """The initial state of an (S, N) batch from the integer seed
        ``key`` (rows ``block[0]:block[1]`` of it under ``block``)."""
        prm = self.prm
        shape = tuple(shape)
        dev = self.device if device is None else torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
        pos = self._positions(gen, shape)
        if prm.mobility == "fixed":
            # static clients: speed 0 keeps the shadowing at its init draw
            speed = torch.zeros(shape, device=dev)
        else:
            speed = P.uniform(gen, shape, prm.v_min, prm.v_max)
        if prm.mobility == "waypoint":
            aux = self._positions(gen, shape)
        elif prm.mobility == "drift":
            th = P.uniform(gen, shape, 0.0, 2.0 * np.pi)
            aux = speed[..., None] * torch.stack([torch.cos(th),
                                                  torch.sin(th)], -1)
        else:
            aux = torch.zeros_like(pos)
        if prm.channel == "ar1":
            fading = torch.randn(shape + (2,), generator=gen,
                                 device=dev) * float(np.sqrt(0.5))
        else:
            fading = torch.zeros(shape + (0,), device=dev)
        if prm.shadow_sigma_db > 0.0:
            shadow = torch.randn(shape, generator=gen,
                                 device=dev) * prm.shadow_sigma_db
        else:
            shadow = torch.zeros(shape, device=dev)
        cpu = P.uniform(gen, shape, prm.cpu_lo, prm.cpu_hi)
        n_base = P.uniform(gen, shape, prm.ns_lo, prm.ns_hi)
        if self.multicell:
            cell = T.nearest_cell_torch(pos, self._bs(dev))[0]
        else:
            cell = torch.zeros(shape, dtype=torch.int32, device=dev)
        state = ScenarioState(
            pos=pos, aux=aux, speed=speed, fading=fading, shadow_db=shadow,
            cpu_base=cpu, throttled=torch.zeros(shape, dtype=torch.bool,
                                                device=dev),
            n_base=n_base, n_cur=n_base, cell=cell)
        return ScenarioState(*(_rows(x, block) for x in state))

    # -- step ----------------------------------------------------------------

    def draw(self, gen: torch.Generator, shape: Tuple[int, int],
             block: Block = None) -> StepDraws:
        """One round's draws for an (S, N) batch, in the numpy twin's order:
        the waypoint target and speed, the AR(1) normal or the iid Exp(1),
        the shadowing normal (moving clients only), the bursty uniform, the
        data normal."""
        prm = self.prm
        shape = tuple(shape)
        dev = gen.device
        new_wp = new_v = fading_z = fpow = shadow_z = cpu_u = eps = None
        if prm.mobility == "waypoint":
            new_wp = self._positions(gen, shape)
            new_v = P.uniform(gen, shape, prm.v_min, prm.v_max)
        if prm.channel == "ar1":
            fading_z = torch.randn(shape + (2,), generator=gen, device=dev)
        else:
            fpow = P.iid_fading_pow(gen, shape)
        if prm.shadow_sigma_db > 0.0 and prm.mobility != "fixed":
            shadow_z = torch.randn(shape, generator=gen, device=dev)
        if prm.compute == "bursty":
            cpu_u = torch.rand(shape, generator=gen, device=dev)
        if prm.data == "dynamic":
            eps = torch.randn(shape, generator=gen, device=dev)
        return StepDraws(*(None if x is None else _rows(x, block)
                           for x in (new_wp, new_v, fading_z, fpow,
                                     shadow_z, cpu_u, eps)))

    def transition(self, state: ScenarioState, d: StepDraws):
        """The pure step: mobility, then association and distances, then
        fading x path loss x shadowing, CPU and data. Returns
        ``(state', RoundEnvBatch)`` in the state's dtype."""
        prm = self.prm
        pos, aux, speed = state.pos, state.aux, state.speed
        if prm.mobility == "waypoint":
            pos, aux, speed = P.waypoint_step(pos, aux, speed, d.new_wp,
                                              d.new_v, move_s=prm.move_s)
        elif prm.mobility == "drift" and self.multicell:
            pos, aux = P.drift_step_multicell(
                pos, aux, self._bs(pos.device, pos.dtype), move_s=prm.move_s,
                region_r=T.region_radius(prm.n_cells, prm.cell_layout,
                                         prm.cell_radius_m),
                r_min=prm.min_radius_m)
        elif prm.mobility == "drift":
            pos, aux = P.drift_step(pos, aux, move_s=prm.move_s,
                                    r_max=prm.cell_radius_m,
                                    r_min=prm.min_radius_m)
        if self.multicell:
            cell, dist = T.nearest_cell_torch(pos,
                                              self._bs(pos.device, pos.dtype))
            dist = torch.clamp(dist, min=prm.min_radius_m)
        else:
            cell = state.cell
            dist = P.distances_of(pos, prm.min_radius_m)

        if prm.channel == "ar1":
            fading, fpow = P.ar1_fading_step(state.fading, d.fading_z,
                                             rho=prm.rho_fading)
        else:
            fading, fpow = state.fading, d.fpow
        gains = prm.ref_path_loss * dist ** (-prm.path_loss_exp) * fpow
        shadow = state.shadow_db
        if prm.shadow_sigma_db > 0.0:
            if prm.mobility != "fixed":
                shadow = P.shadow_step(shadow, speed, d.shadow_z,
                                       sigma_db=prm.shadow_sigma_db,
                                       move_s=prm.move_s,
                                       decorr_m=prm.shadow_decorr_m)
            gains = gains * 10.0 ** (shadow / 10.0)

        throttled, cpu = state.throttled, state.cpu_base
        if prm.compute == "bursty":
            throttled = P.bursty_cpu_step(throttled, d.cpu_u,
                                          p_throttle=prm.p_throttle,
                                          p_recover=prm.p_recover)
            cpu = cpu * torch.ones_like(cpu).masked_fill(
                throttled, prm.throttle_factor)
        n_cur = state.n_cur
        if prm.data == "dynamic":
            n_cur = P.data_arrival_step(n_cur, state.n_base, d.data_eps,
                                        phi=prm.data_phi,
                                        jitter=prm.data_jitter)
        new = ScenarioState(pos=pos, aux=aux, speed=speed, fading=fading,
                            shadow_db=shadow, cpu_base=state.cpu_base,
                            throttled=throttled, n_base=state.n_base,
                            n_cur=n_cur, cell=cell)
        return new, RoundEnvBatch(gains=gains, n_samples=n_cur,
                                  cpu_freq=cpu, cell=cell)

    def step(self, state: ScenarioState, key: int, *, block: Block = None):
        """Advance one round from the integer seed ``key`` on the state's
        device; returns ``(state', RoundEnvBatch)`` with fp32 env leaves."""
        s, n = state.speed.shape
        dev = state.speed.device
        gen = torch.Generator(device=dev).manual_seed(int(key))
        new, env = self.transition(
            state, self.draw(gen, (s if block is None else block[2], n),
                             block))
        return new, RoundEnvBatch(env.gains.float(), env.n_samples.float(),
                                  env.cpu_freq.float(), env.cell)

    def init_and_keys(self, key: int, rounds: int, shape: Tuple[int, int],
                      *, device=None, block: Block = None):
        """The one key schedule of the fused loop and ``rollout``:
        ``(initial state, [seed of round 0, ...])``."""
        seeds = key_seeds(key, rounds)
        return (self.init(seeds[0], shape, device=device, block=block),
                seeds[1:])

    def first_env(self, key: int, rounds: int, shape: Tuple[int, int], *,
                  device=None) -> RoundEnvBatch:
        """Round 0's env under the key schedule of a ``rounds``-long run
        (the budget auto-calibration)."""
        state, keys = self.init_and_keys(key, rounds, shape, device=device)
        return self.step(state, keys[0])[1]

    def rollout(self, key: int, rounds: int, shape: Tuple[int, int], *,
                device=None) -> RoundEnvBatch:
        """The whole (R, S, N) env sequence (the ``presampled=`` path):
        the fused loop's key schedule, so feeding it to
        ``WirelessEngine.montecarlo_rounds`` reproduces that loop bitwise."""
        state, keys = self.init_and_keys(key, rounds, shape, device=device)
        envs = []
        for k in keys:
            state, env = self.step(state, k)
            envs.append(env)
        return RoundEnvBatch(*(torch.stack(x) for x in zip(*envs)))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCENARIOS: dict[str, ScenarioConfig] = {
    # static topology, i.i.d. block fading, static compute
    "static_iid": ScenarioConfig(name="static_iid"),
    # walking users: slow waypoint mobility, highly correlated fading,
    # moderate shadowing with a short decorrelation distance
    "pedestrian": ScenarioConfig(
        name="pedestrian", channel="ar1", doppler_hz=10.0, slot_s=1e-3,
        shadow_sigma_db=4.0, shadow_decorr_m=25.0,
        mobility="waypoint", speed_mps=(0.5, 1.5)),
    # vehicles: fast drift across the cell, weakly correlated fading
    # (rho = J0(2 pi 200 Hz 1 ms) ~ 0.64), heavier shadowing
    "vehicular": ScenarioConfig(
        name="vehicular", channel="ar1", doppler_hz=200.0, slot_s=1e-3,
        shadow_sigma_db=6.0, shadow_decorr_m=50.0,
        mobility="drift", speed_mps=(10.0, 30.0)),
    # static sensors with duty-cycled CPUs and bursty data arrival
    "iot_bursty": ScenarioConfig(
        name="iot_bursty", compute="bursty", throttle_factor=0.35,
        p_throttle=0.08, p_recover=0.3,
        data="dynamic", data_phi=0.85, data_jitter=0.15),
    # dense indoor hotspot: near-static users behind heavy, slowly
    # decorrelating shadowing
    "hotspot_shadowed": ScenarioConfig(
        name="hotspot_shadowed", channel="ar1", doppler_hz=3.0, slot_s=1e-3,
        shadow_sigma_db=8.0, shadow_decorr_m=20.0,
        mobility="waypoint", speed_mps=(0.1, 0.5)),
}


def get_scenario_config(name: str) -> ScenarioConfig:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(registered: {sorted(SCENARIOS)})") from None


def as_scenario(spec: Union[str, ScenarioConfig, Scenario],
                ncfg: NOMAConfig, flcfg: FLConfig,
                device="cuda") -> Scenario:
    """Resolve a registry name / config / ready scenario to a Scenario."""
    if isinstance(spec, Scenario):
        return spec
    if isinstance(spec, str):
        spec = get_scenario_config(spec)
    return Scenario(spec, ncfg, flcfg, device=device)
