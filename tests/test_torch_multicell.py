"""The port's multi-cell planning against the reference (DESIGN.md section
10): the topology (exact), the multi-cell ``static_iid`` scenario (exact,
same rng stream), the cell-partitioned engine against the JAX engine and
``plan.plan_multicell`` (masks and pair tables exact, rates and round
times rtol 2e-5 as the reference's own C=3 parity test holds them), the
C=1 equivalence (bitwise), the Monte-Carlo rollout with a ``cell_seq``
(handovers exact) and ``FLServer`` at ``n_cells=3``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.configs import get_config as jget_config
from repro.core import plan as jplan
from repro.core.engine import WirelessEngine as JEngine
from repro.core.scheduler import RoundEnv as JRoundEnv
from repro.data import TaskConfig as JTaskConfig
from repro.fl import FLServer as JFLServer
from repro.sim import NumpyScenario, as_scenario, get_scenario_config
from repro.sim import topology as jtopology
from repro_torch import convert
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.core import engine as E
from repro_torch.core import plan
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer
from repro_torch import sim as S
from repro_torch.sim import topology

RTOL = 2e-5


class TestTopology:
    @pytest.mark.parametrize("c,layout", [(1, "hex"), (3, "hex"), (7, "hex"),
                                          (12, "hex"), (4, "grid"),
                                          (9, "grid")])
    def test_layout_and_region_radius(self, c, layout):
        got = topology.bs_layout(c, layout, 500.0)
        np.testing.assert_array_equal(got, jtopology.bs_layout(c, layout,
                                                               500.0))
        assert not got.flags.writeable
        assert topology.region_radius(c, layout, 500.0) \
            == jtopology.region_radius(c, layout, 500.0)

    def test_nearest_cell(self):
        rng = np.random.default_rng(0)
        pos = rng.uniform(-1500, 1500, (5, 40, 2))
        bs = topology.bs_layout(7, "hex", 500.0)
        cell, dist = topology.nearest_cell(pos, bs)
        jcell, jdist = jtopology.nearest_cell(pos, bs)
        np.testing.assert_array_equal(cell, jcell)
        np.testing.assert_array_equal(dist, jdist)
        assert cell.dtype == np.int32

    def test_cell_topology(self):
        ncfg, fl = NOMAConfig(), FLConfig(n_cells=3, cell_layout="grid")
        top = topology.CellTopology.from_configs(ncfg, fl)
        ref = jtopology.CellTopology.from_configs(JNOMAConfig(),
                                                  JFLConfig(n_cells=3,
                                                            cell_layout="grid"))
        assert dataclasses.asdict(top) == dataclasses.asdict(ref)
        np.testing.assert_array_equal(top.bs_xy, ref.bs_xy)
        assert top.region_radius_m == ref.region_radius_m
        pos = np.random.default_rng(1).uniform(-900, 900, (30, 2))
        for a, b in zip(top.cell_of(pos), ref.cell_of(pos)):
            np.testing.assert_array_equal(a, b)
        for kw in (dict(n_cells=0), dict(layout="ring"),
                   dict(min_radius_m=600.0)):
            with pytest.raises(ValueError):
                topology.CellTopology(**kw)
        with pytest.raises(ValueError):
            topology.bs_layout(2, "ring", 500.0)


@pytest.mark.parametrize("n_cells", [1, 3])
def test_scenario_matches_numpy_scenario(n_cells):
    """Cells, distances, gains and handovers over 3 steps, from one seed:
    the port consumes the rng exactly as ``NumpyScenario`` does."""
    n = 40
    ns = np.random.default_rng(9).uniform(100, 1000, n)
    port = S.NumpyScenario(S.get_scenario_config("static_iid"), NOMAConfig(),
                           FLConfig(n_cells=n_cells))
    ref = NumpyScenario(get_scenario_config("static_iid"), JNOMAConfig(),
                        JFLConfig(n_cells=n_cells))
    rp, rr = np.random.default_rng(4), np.random.default_rng(4)
    for a, b in zip(port.init(rp, n, ns), ref.init(rr, n, ns)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.cell, ref.cell)
    if n_cells > 1:
        assert len(np.unique(port.cell)) == n_cells
    for _ in range(3):
        for a, b in zip(port.step(rp), ref.step(rr)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.cell, ref.cell)
        np.testing.assert_array_equal(port.distances, ref.distances)
        assert port.last_handovers == ref.last_handovers
    assert rp.random() == rr.random()


def test_cell_capacity():
    for args in ((1000, 1, 10), (1000, 4, 10), (100, 50, 10), (12, 2, 10),
                 (120, 3, 10), (50, 3, 10)):
        assert plan.cell_capacity(*args) == jplan.cell_capacity(*args)


def envs(seed, b, n, c):
    rng = np.random.default_rng(seed)
    gains = rng.exponential(size=(b, n)) * 1e-9
    return (gains, rng.uniform(200, 1200, (b, n)),
            rng.uniform(0.5e9, 2e9, (b, n)),
            rng.integers(1, 20, (b, n)).astype(float),
            rng.integers(0, c, (b, n)))


@pytest.fixture(scope="module")
def c3_runs():
    """C=3, N=120 (every cell well over its 10 slots), budget and no
    budget, both selections: the port, the JAX engine, and the numpy
    planner per row."""
    batch = envs(1, 3, 120, 3)
    *env, cell = batch
    out = {}
    for selection in ("greedy_set", "joint"):
        port = E.WirelessEngine(NOMAConfig(), FLConfig(selection=selection),
                                device="cpu")
        ref = JEngine(JNOMAConfig(), JFLConfig(selection=selection),
                      kernel_backend="xla")
        for tb in (0.0, 0.6):
            kw = dict(t_budget=tb, cell=cell, n_cells=3)
            out[selection, tb] = (port.schedule_batch(*env, 1e6, **kw),
                                  ref.schedule_batch(*env, 1e6, **kw))
    return batch, out


@pytest.mark.parametrize("tb", [0.0, 0.6])
@pytest.mark.parametrize("selection", ["greedy_set", "joint"])
def test_c3_matches_jax_and_plan_multicell(c3_runs, selection, tb):
    (gains, ns, cpu, ages, cell), runs = c3_runs
    out, ref = runs[selection, tb]
    for f in ("selected", "evicted", "pair_strong", "pair_weak"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("rates", "powers", "t_round", "agg_weights"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=1e-8, err_msg=f)
    if tb:
        assert out.evicted.any()
    fl = JFLConfig(selection=selection)
    for b in range(gains.shape[0]):
        env = JRoundEnv(gains=gains[b], n_samples=ns[b], cpu_freq=cpu[b],
                        ages=ages[b], model_bits=1e6)
        want = jplan.plan_multicell(env, cell[b], 3, JNOMAConfig(), fl,
                                    priority=jplan.age_score(env, fl),
                                    t_budget=tb or None)
        got = E.engine_schedule_to_numpy(out, b)
        np.testing.assert_array_equal(got.selected, want.selected)
        assert sorted(got.pairs) == sorted(want.pairs)
        np.testing.assert_allclose(got.rates, want.rates, rtol=RTOL)
        assert got.t_round == pytest.approx(want.t_round, rel=RTOL)
        np.testing.assert_allclose(got.agg_weights, want.agg_weights,
                                   rtol=RTOL, atol=1e-8)
        diag = plan.schedule_diag(got, ages[b], cell=cell[b], n_cells=3)
        want_diag = jplan.schedule_diag(want, ages[b], cell=cell[b],
                                        n_cells=3)
        np.testing.assert_array_equal(diag["sel_per_cell"],
                                      want_diag["sel_per_cell"])
        assert (diag["sel_per_cell"] <= 10).all()
        batch_diag = E.schedule_diag(out, cell=torch.as_tensor(cell),
                                     n_cells=3)
        np.testing.assert_array_equal(batch_diag["sel_per_cell"][b].numpy(),
                                      diag["sel_per_cell"])


@pytest.mark.parametrize("budget", [False, True])
@pytest.mark.parametrize("selection", ["greedy_set", "joint"])
def test_one_cell_is_bitwise_the_single_cell_path(selection, budget):
    """At C=1 the member table is the identity (cap = N): the partitioned
    planner gives the single-cell schedule bit for bit, and
    ``schedule_batch`` ignores ``cell`` when ``n_cells == 1``."""
    gains, ns, cpu, ages, _ = envs(6, 3, 48, 1)
    eng = E.WirelessEngine(NOMAConfig(), FLConfig(selection=selection),
                           device="cpu")
    T = lambda x: torch.as_tensor(x, dtype=torch.float32)
    prio = E._age_priority(T(ages), T(ns), 1.0)
    t_cmp = E._compute_times(eng.prm, T(ns), T(cpu))
    mb = torch.full((3,), 1e6)
    tb = torch.full((3,), 0.5)
    c = min(eng.prm.slots, 48)
    if budget:
        ref = E._budget_schedule(prio, T(gains), t_cmp, T(ns), mb, tb,
                                 eng.prm, False, c, "strong_weak", selection)
    else:
        ref = E._fast_schedule_batch(prio, T(gains), t_cmp, T(ns), mb,
                                     eng.prm, False, c, "strong_weak",
                                     selection)
    out = E._multicell_schedule(
        prio, T(gains), t_cmp, T(ns), mb, tb if budget else None,
        torch.zeros((3, 48), dtype=torch.int64), prm=eng.prm, oma=False,
        pairing="strong_weak", selection=selection, n_cells=1, cap=48)
    for name, a, b in zip(ref._fields, ref, out):
        assert torch.equal(a, b), name
    kw = dict(t_budget=0.5) if budget else {}
    a = eng.schedule_batch(gains, ns, cpu, ages, 1e6, **kw)
    b = eng.schedule_batch(gains, ns, cpu, ages, 1e6,
                           cell=np.ones((3, 48), int), n_cells=1, **kw)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_underfull_cells_admit_padding_on_the_fast_path():
    """A cell with fewer real members than slots admits padding lanes on
    the fast path (the reference engine's documented divergence from the
    numpy planner): they are dropped on the merge, and the result equals
    the JAX engine's."""
    gains, ns, cpu, ages, _ = envs(7, 2, 30, 3)
    cell = np.zeros((2, 30), int)
    cell[:, :5] = 1                       # cell 1: 5 members < 10 slots
    cell[:, 5:9] = 2                      # cell 2: 4 members
    kw = dict(cell=cell, n_cells=3)
    out = E.WirelessEngine(NOMAConfig(), FLConfig(),
                           device="cpu").schedule_batch(gains, ns, cpu, ages,
                                                        1e6, **kw)
    ref = JEngine(JNOMAConfig(), JFLConfig(),
                  kernel_backend="xla").schedule_batch(gains, ns, cpu, ages,
                                                       1e6, **kw)
    for f in ("selected", "pair_strong", "pair_weak"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(out.t_round.numpy(), np.asarray(ref.t_round),
                               rtol=RTOL)
    assert (out.selected[:, :9].sum(1) == 9).all()
    assert torch.isfinite(out.rates).all()


@pytest.mark.parametrize("policy", ["age_noma", "age_noma_budget"])
def test_montecarlo_cell_seq_matches_jax(policy):
    """``montecarlo_rounds(cell_seq=...)`` on the JAX scenario's rollout
    (vehicular mobility, so clients change cells), fed pre-sampled to both
    engines."""
    ncfg, fl = JNOMAConfig(), JFLConfig(n_cells=3)
    scn = as_scenario(get_scenario_config("vehicular"), ncfg, fl)
    env = [np.asarray(a) for a in scn.rollout(jax.random.PRNGKey(0), 5,
                                              (3, 64))]
    gains, n_samples, cpu_freq, cell = env[0], env[1], env[2], env[3]
    kw = dict(policy=policy, cell_seq=cell,
              t_budget=0.2 if policy == "age_noma_budget" else 0.0)
    out = E.WirelessEngine(NOMAConfig(), FLConfig(n_cells=3),
                           device="cpu").montecarlo_rounds(
        gains, n_samples, cpu_freq, 1e6, **kw)
    ref = JEngine(ncfg, fl, kernel_backend="xla").montecarlo_rounds(
        gains, n_samples, cpu_freq, 1e6, **kw)
    assert sorted(out) == sorted(ref)
    for key in ("n_selected", "max_age", "participation", "final_ages",
                "aou_hist", "n_evicted", "handovers"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("t_round", "t_comp_bottleneck", "t_up_bottleneck"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, err_msg=key)
    assert out["handovers"].sum() > 0
    if policy == "age_noma_budget":
        assert out["n_evicted"].sum() > 0


# ---------------------------------------------------------------------------
# FLServer at n_cells=3
# ---------------------------------------------------------------------------

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
TASK_KW = dict(vocab_size=32, n_topics=4, seq_len=17, seed=0)
FL_KW = dict(n_clients=16, rounds=3, local_epochs=1, local_batch=8, lr=0.2,
             samples_per_client=(24, 48), seed=2, n_cells=3)
ROUNDS = 3


def recording(server):
    masks = []
    select = server.select

    def wrapped(env):
        sched = select(env)
        masks.append(np.asarray(sched.selected).copy())
        return sched

    server.select = wrapped
    return masks


@pytest.fixture(scope="module", params=["age_noma", "age_noma_budget"])
def fl_runs(request):
    policy = request.param
    ref = JFLServer(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**FL_KW), JNOMAConfig(n_subchannels=2),
        JTaskConfig(**TASK_KW), policy=policy, engine="jax", eval_every=1)
    port = FLServer(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
        TaskConfig(**TASK_KW), policy=policy, eval_every=1, device="cpu",
        params=jax.tree.map(np.asarray, ref.params))
    ref_masks, port_masks = recording(ref), recording(port)
    return (policy, (ref, ref.run(ROUNDS), ref_masks),
            (port, port.run(ROUNDS), port_masks))


def test_fl_multicell_selections(fl_runs):
    policy, (ref, ref_h, ref_masks), (port, port_h, port_masks) = fl_runs
    assert len(port_masks) == len(ref_masks) == ROUNDS
    for r, (a, b) in enumerate(zip(port_masks, ref_masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
    for key in ("n_selected", "n_evicted", "sel_per_cell", "handovers",
                "max_age", "aou_hist"):
        assert getattr(port_h, key) == getattr(ref_h, key), key
    assert len(port_h.sel_per_cell) == ROUNDS
    assert all(len(x) == 3 for x in port_h.sel_per_cell)
    if policy == "age_noma_budget":
        assert max(port_h.n_evicted) > 0
        assert port._auto_budget == pytest.approx(ref._auto_budget,
                                                  rel=1e-6)
    # the delta buffer holds every client the planner can select
    assert port.deltas.shape[0] == min(3 * 4, 16)


def test_fl_multicell_times_losses_and_parameters(fl_runs):
    _, (ref, ref_h, _), (port, port_h, _) = fl_runs
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=1e-4)
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=1e-4)
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, ref.params))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   atol=1e-5, rtol=0, err_msg=name)
