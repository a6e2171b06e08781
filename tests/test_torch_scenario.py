"""The port's scenario layer (src/repro_torch/sim) against the reference
(src/repro/sim).

* ``NumpyScenario`` against ``repro.sim.NumpyScenario``: every registered
  scenario at one and three cells, init and 5 steps from one seed,
  bitwise (gains, n_samples, cpu, cell, distances, handovers, and the
  generator's next draw).
* Every torch transition in fp64 on the CPU, fed the numpy draws that
  ``NumpyScenario.step`` takes in its documented order, against that step
  at rtol 1e-12.
* The device ``Scenario``'s statistics against the reference's JAX
  ``Scenario`` (the estimators and tolerances of tests/test_scenario.py,
  each held on both).
* The fused Monte-Carlo loop against the pre-sampled one, bitwise, for
  every scenario and policy at one and three cells.
* ``ScenarioParams`` raises the reference's ``ValueError``s.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro import sim as jsim
from repro_torch.configs import FLConfig, NOMAConfig
from repro_torch.configs.base import POLICIES
from repro_torch.fl import run_montecarlo
from repro_torch import sim
from repro_torch.sim.scenario import ScenarioState, StepDraws

NAMES = list(sim.SCENARIOS)
NCFG = NOMAConfig(n_subchannels=3)
JNCFG = JNOMAConfig(n_subchannels=3)


def test_registry_matches_the_reference():
    assert list(sim.SCENARIOS) == list(jsim.SCENARIOS)
    for name in NAMES:
        assert (sim.get_scenario_config(name).__dict__
                == jsim.get_scenario_config(name).__dict__)
        for c in (1, 3):
            assert (sim.ScenarioParams.from_configs(
                sim.SCENARIOS[name], NCFG, FLConfig(n_cells=c)).__dict__
                == jsim.ScenarioParams.from_configs(
                    jsim.SCENARIOS[name], JNCFG,
                    JFLConfig(n_cells=c)).__dict__)
    with pytest.raises(ValueError, match="unknown scenario"):
        sim.get_scenario_config("warp_drive")
    s1 = sim.as_scenario("vehicular", NCFG, FLConfig(), device="cpu")
    assert sim.as_scenario(s1, NCFG, FLConfig()) is s1
    assert sim.as_scenario(sim.SCENARIOS["vehicular"], NCFG, FLConfig(),
                           device="cpu").prm == s1.prm


# ---------------------------------------------------------------------------
# (a) the numpy twin, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cells", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_numpy_scenario_matches_reference_bitwise(name, n_cells):
    n = 40
    port = sim.NumpyScenario(sim.get_scenario_config(name), NCFG,
                             FLConfig(n_cells=n_cells))
    ref = jsim.NumpyScenario(jsim.get_scenario_config(name), JNCFG,
                             JFLConfig(n_cells=n_cells))
    rp, rr = np.random.default_rng(11), np.random.default_rng(11)
    ns = None if name == "iot_bursty" else np.full(n, 300.0)
    for a, b in zip(port.init(rp, n, ns), ref.init(rr, n, ns)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.cell, ref.cell)
    for _ in range(5):
        for a, b in zip(port.step(rp), ref.step(rr)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.cell, ref.cell)
        np.testing.assert_array_equal(port.distances, ref.distances)
        assert port.last_handovers == ref.last_handovers
    assert rp.random() == rr.random()


# ---------------------------------------------------------------------------
# (b) the torch transitions in fp64, fed the twin's draws
# ---------------------------------------------------------------------------


def twin_state(tw: sim.NumpyScenario) -> ScenarioState:
    """The twin's state as a (1, N) fp64 ScenarioState; a fixed
    single-cell client sits at (distance, 0)."""
    n = tw.n
    t = lambda a: torch.from_numpy(np.asarray(a)).unsqueeze(0)
    pos = tw.pos if tw.pos is not None else np.stack(
        [tw.distances, np.zeros(n)], axis=-1)
    fading = tw.h if tw.prm.channel == "ar1" else np.zeros((n, 0))
    return ScenarioState(
        pos=t(pos), aux=t(tw.aux if tw.aux is not None else np.zeros((n, 2))),
        speed=t(tw.speed), fading=t(fading), shadow_db=t(tw.shadow_db),
        cpu_base=t(tw.cpu_base), throttled=t(tw.throttled),
        n_base=t(tw.n_base), n_cur=t(tw.n_cur),
        cell=t(np.asarray(tw.cell, np.int32)))


def twin_draws(tw: sim.NumpyScenario, rng: np.random.Generator) -> StepDraws:
    """The draws of one ``NumpyScenario.step``, in its documented order:
    the waypoint target and speed, the AR(1) normal (or the iid
    exponential), the shadowing normal, the bursty uniform, the data
    normal."""
    prm, n = tw.prm, tw.n
    t = lambda a: None if a is None else torch.from_numpy(
        np.asarray(a, np.float64)).unsqueeze(0)
    new_wp = new_v = z = fpow = sz = u = eps = None
    if prm.mobility == "waypoint":
        new_wp = tw._multicell_annulus(rng, n)
        new_v = rng.uniform(prm.v_min, prm.v_max, n)
    if prm.channel == "ar1":
        z = rng.normal(size=(n, 2))
    else:
        fpow = rng.exponential(1.0, size=n)
    if prm.shadow_sigma_db > 0.0 and prm.mobility != "fixed":
        sz = rng.normal(size=n)
    if prm.compute == "bursty":
        u = rng.uniform(size=n)
    if prm.data == "dynamic":
        eps = rng.normal(size=n)
    return StepDraws(t(new_wp), t(new_v), t(z), t(fpow), t(sz), t(u),
                     t(eps))


@pytest.mark.parametrize("n_cells", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_transitions_match_the_twin_in_fp64(name, n_cells):
    """rtol 1e-12: the torch and numpy fp64 expressions differ only in the
    order of a few roundings (norms, powers)."""
    n = 48
    fl = FLConfig(n_cells=n_cells)
    tw = sim.NumpyScenario(sim.get_scenario_config(name), NCFG, fl)
    scn = sim.Scenario(sim.get_scenario_config(name), NCFG, fl,
                       device="cpu")
    rng = np.random.default_rng(5)
    tw.init(rng, n)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a).reshape(-1), np.asarray(b).reshape(-1), rtol=1e-12,
        atol=0)
    for _ in range(5):
        state = twin_state(tw)
        mirror = copy.deepcopy(rng)
        draws = twin_draws(tw, mirror)
        new, env = scn.transition(state, draws)
        gains, n_samples, cpu = tw.step(rng)
        assert mirror.random() == copy.deepcopy(rng).random()
        assert new.pos.dtype == env.gains.dtype == torch.float64
        close(env.gains[0], gains)
        close(env.n_samples[0], n_samples)
        close(env.cpu_freq[0], cpu)
        np.testing.assert_array_equal(env.cell[0].numpy(), tw.cell)
        assert int((new.cell != state.cell).sum()) == tw.last_handovers
        if tw.pos is not None:
            close(new.pos[0], tw.pos)
        if tw.aux is not None:
            close(new.aux[0], tw.aux)
        close(new.speed[0], tw.speed)
        close(new.shadow_db[0], tw.shadow_db)
        if tw.prm.channel == "ar1":
            close(new.fading[0], tw.h)
        np.testing.assert_array_equal(new.throttled[0].numpy(), tw.throttled)


# ---------------------------------------------------------------------------
# (c) statistics of the device scenario, against the JAX scenario
# ---------------------------------------------------------------------------


def roll(scfg, seed, rounds, shape, *, port):
    """(states, envs) of a ``rounds``-step run, as numpy, of the port's
    device Scenario on the CPU or the reference's JAX Scenario."""
    if port:
        scn = sim.Scenario(scfg, NCFG, FLConfig(), device="cpu")
        state, keys = scn.init_and_keys(seed, rounds, shape)
        to_np = lambda t: t.numpy()
    else:
        scn = jsim.Scenario(scfg, JNCFG, JFLConfig())
        state, keys = scn.init_and_keys(jax.random.PRNGKey(seed), rounds,
                                        shape)
        to_np = np.asarray
    states, envs = [], []
    for i in range(rounds):
        state, env = scn.step(state, keys[i])
        states.append(type(state)(*(to_np(x) for x in state)))
        envs.append(type(env)(*(to_np(x) for x in env)))
    return scn, states, envs


def stat_ar1_rho(port):
    scfg = sim.ScenarioConfig(name="t", channel="ar1", doppler_hz=200.0,
                              slot_s=1e-3)
    scn, states, _ = roll(scfg, 0, 300, (4, 64), port=port)
    x = np.stack([s.fading[..., 0] for s in states])
    x0, x1 = x[:-1].ravel(), x[1:].ravel()
    # +-1/sqrt(chains * T) estimator noise at 4*64 chains x 300 steps
    assert np.sum(x0 * x1) / np.sum(x0 * x0) == pytest.approx(
        scn.prm.rho_fading, abs=0.02)


def stat_ar1_power(port):
    scfg = sim.ScenarioConfig(name="t", channel="ar1", doppler_hz=100.0,
                              slot_s=1e-3)
    _, states, _ = roll(scfg, 1, 200, (4, 64), port=port)
    p = np.stack([np.sum(s.fading ** 2, -1) for s in states[50:]]).ravel()
    assert p.mean() == pytest.approx(1.0, abs=0.05)
    assert p.var() == pytest.approx(1.0, abs=0.12)


def stat_iid_exp1(port):
    _, states, envs = roll(sim.SCENARIOS["static_iid"], 2, 50, (8, 128),
                           port=port)
    dist = np.maximum(np.linalg.norm(states[0].pos, axis=-1),
                      NCFG.min_radius_m)
    pl = NCFG.ref_path_loss * dist ** (-NCFG.path_loss_exp)
    xs = np.sort(np.stack([e.gains / pl for e in envs]).ravel())
    # KS distance over 51,200 samples
    ks = np.abs(np.arange(1, xs.size + 1) / xs.size
                - (1.0 - np.exp(-xs))).max()
    assert ks < 0.01


def stat_shadow_persistence(port):
    scfg = sim.ScenarioConfig(name="t", shadow_sigma_db=6.0)
    _, states, _ = roll(scfg, 3, 5, (16, 128), port=port)
    assert states[0].shadow_db.std() == pytest.approx(6.0, rel=0.05)
    np.testing.assert_array_equal(states[0].shadow_db, states[-1].shadow_db)


def stat_shadow_decorrelation(port):
    scfg = sim.ScenarioConfig(name="t", shadow_sigma_db=6.0,
                              shadow_decorr_m=20.0, mobility="waypoint",
                              speed_mps=(2.0, 2.0))
    _, states, _ = roll(scfg, 4, 200, (4, 64), port=port)
    x = np.stack([s.shadow_db for s in states[20:]])
    x0, x1 = x[:-1].ravel(), x[1:].ravel()
    assert np.sum(x0 * x1) / np.sum(x0 * x0) == pytest.approx(
        np.exp(-2.0 / 20.0), abs=0.03)
    assert x.std() == pytest.approx(6.0, rel=0.1)


def stat_waypoint_bounds(port):
    scfg = sim.ScenarioConfig(name="t", mobility="waypoint",
                              speed_mps=(0.5, 1.5), move_s=2.0)
    _, states, _ = roll(scfg, 5, 60, (4, 32), port=port)
    pos = np.stack([s.pos for s in states])
    assert np.linalg.norm(np.diff(pos, axis=0), axis=-1).max() \
        <= 1.5 * 2.0 + 1e-4
    speeds = np.stack([s.speed for s in states])
    assert speeds.min() >= 0.5 - 1e-6 and speeds.max() <= 1.5 + 1e-6
    assert np.linalg.norm(pos, axis=-1).max() <= NCFG.cell_radius_m + 1e-3
    # and it moves
    assert np.linalg.norm(pos[-1] - pos[0], axis=-1).mean() > 1.0


def stat_drift_reflection(port):
    scfg = sim.ScenarioConfig(name="t", mobility="drift",
                              speed_mps=(20.0, 30.0), move_s=2.0)
    _, states, envs = roll(scfg, 7, 100, (4, 32), port=port)
    r = np.stack([np.linalg.norm(s.pos, axis=-1) for s in states])
    assert r.max() <= NCFG.cell_radius_m + 1e-3
    for e in envs[:5]:
        assert np.isfinite(e.gains).all() and (e.gains > 0).all()


def stat_bursty_occupancy(port):
    p_t, p_r = 0.1, 0.3
    scfg = sim.ScenarioConfig(name="t", compute="bursty",
                              throttle_factor=0.4, p_throttle=p_t,
                              p_recover=p_r)
    _, states, envs = roll(scfg, 9, 400, (2, 64), port=port)
    base = states[0].cpu_base.astype(np.float32)
    for e in envs[:10]:
        ratio = e.cpu_freq / base
        assert np.all(np.isclose(ratio, 1.0, rtol=1e-5)
                      | np.isclose(ratio, 0.4, rtol=1e-5))
    thr = np.stack([s.throttled for s in states[100:]])
    assert thr.mean() == pytest.approx(p_t / (p_t + p_r), abs=0.04)


def stat_data_bounds(port):
    scfg = sim.ScenarioConfig(name="t", data="dynamic", data_phi=0.85,
                              data_jitter=0.15)
    _, states, envs = roll(scfg, 10, 100, (2, 64), port=port)
    base = states[0].n_base
    ns = np.stack([e.n_samples for e in envs])
    assert (ns >= np.maximum(0.2 * base, 1.0) - 1e-3).all()
    assert (ns <= 2.0 * base + 1e-3).all()
    assert ns.std(axis=0).min() > 0.0


def stat_static_keeps_cpu_and_data(port):
    _, states, envs = roll(sim.SCENARIOS["static_iid"], 11, 5, (2, 16),
                           port=port)
    np.testing.assert_array_equal(envs[0].cpu_freq, envs[-1].cpu_freq)
    np.testing.assert_array_equal(envs[0].n_samples, envs[-1].n_samples)
    np.testing.assert_array_equal(states[0].pos, states[-1].pos)


STATS = [stat_ar1_rho, stat_ar1_power, stat_iid_exp1,
         stat_shadow_persistence, stat_shadow_decorrelation,
         stat_waypoint_bounds, stat_drift_reflection, stat_bursty_occupancy,
         stat_data_bounds, stat_static_keeps_cpu_and_data]


@pytest.mark.parametrize("stat", STATS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("port", [True, False], ids=["port", "reference"])
def test_device_scenario_statistics(stat, port):
    """The same estimator, at the same tolerance, holds on the port's
    scenario and on the reference's."""
    stat(port)


def test_bessel_and_jakes_are_the_reference_values():
    xs = np.linspace(0.0, 20.0, 41)
    np.testing.assert_array_equal(sim.bessel_j0(xs), jsim.bessel_j0(xs))
    for f in (0.0, 3.0, 10.0, 200.0):
        assert sim.jakes_rho(f, 1e-3) == jsim.jakes_rho(f, 1e-3)


def test_key_schedule():
    """first_env is round 0 of rollout; the same key gives the same run;
    under iid the fading leaf is (S, N, 0)."""
    for name in NAMES:
        scn = sim.Scenario(sim.SCENARIOS[name], NCFG, FLConfig(n_cells=3),
                           device="cpu")
        a = scn.rollout(9, 4, (3, 8))
        b = scn.rollout(9, 4, (3, 8))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        for x, y in zip(scn.first_env(9, 4, (3, 8)), a):
            assert torch.equal(x, y[0])
        assert a.gains.shape == (4, 3, 8) and a.cell.dtype == torch.int32
    state = sim.Scenario(sim.SCENARIOS["static_iid"], NCFG, FLConfig(),
                         device="cpu").init(0, (3, 8))
    assert state.fading.shape == (3, 8, 0)


def test_block_rows_are_the_whole_batch_rows():
    """A block's init and steps are bitwise its rows of the whole batch."""
    scn = sim.Scenario(sim.SCENARIOS["pedestrian"], NCFG,
                       FLConfig(n_cells=3), device="cpu")
    full, keys = scn.init_and_keys(4, 3, (4, 32))
    part, _ = scn.init_and_keys(4, 3, (4, 32), block=(2, 4, 4))
    for k in keys:
        full, ef = scn.step(full, k)
        part, ep = scn.step(part, k, block=(2, 4, 4))
        for x, y in zip(ef, ep):
            assert torch.equal(x[2:4], y)


# ---------------------------------------------------------------------------
# (d) fused == presampled, bitwise
# ---------------------------------------------------------------------------

MC_KW = dict(n_clients=16, n_seeds=4, rounds=4, model_bits=4e6, seed=3,
             device="cpu")


@pytest.mark.parametrize("n_cells", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_fused_matches_presampled_bitwise(name, n_cells, monkeypatch):
    monkeypatch.setenv("REPRO_LEDGER", "0")
    fl = FLConfig(n_cells=n_cells)
    fused = run_montecarlo(NCFG, fl, policies=POLICIES, scenario=name,
                           **MC_KW)
    pre = run_montecarlo(NCFG, fl, policies=POLICIES, scenario=name,
                         presampled=True, **MC_KW)
    for p in POLICIES:
        assert sorted(fused[p]) == sorted(pre[p])
        for k in fused[p]:
            np.testing.assert_array_equal(fused[p][k], pre[p][k],
                                          err_msg=f"{p}/{k}")
        assert fused["summary"][p] == pre["summary"][p]
    if n_cells > 1:
        assert "handovers" in fused["age_noma"]


# ---------------------------------------------------------------------------
# (e) the reference's ValueErrors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(channel="quantum"), dict(mobility="teleport"),
    dict(compute="gpu"), dict(data="stream"), dict(speed_mps=(2.0, 1.0)),
    dict(speed_mps=(-1.0, 1.0)), dict(shadow_sigma_db=-1.0),
    dict(shadow_decorr_m=0.0), dict(move_s=0.0)])
def test_scenario_params_raise_the_reference_errors(bad):
    with pytest.raises(ValueError) as ref:
        jsim.ScenarioParams.from_configs(jsim.ScenarioConfig(**bad), JNCFG,
                                         JFLConfig())
    with pytest.raises(ValueError) as got:
        sim.ScenarioParams.from_configs(sim.ScenarioConfig(**bad), NCFG,
                                        FLConfig())
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError):
        sim.Scenario(sim.ScenarioConfig(**bad), NCFG, FLConfig(),
                     device="cpu")
