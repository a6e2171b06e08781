"""The port's round-time budget path against the reference.

The same numpy inputs go to the port's ``schedule_batch(t_budget=...)`` on
the CPU, the reference JAX engine's budget core (``kernel_backend="xla"``)
and the numpy fp64 scheduler (``schedule_age_noma`` with ``t_budget_s``).
Tiers (DESIGN.md section 5.4): selected, evicted and pair tables exact;
powers atol 1e-5; rates and round times rtol 1e-4.

One exception, for the hungarian policy: a strong user's SIC rate does
not depend on its partner (p_j g_j = y(g_i) below the power cap), so
matchings that share the bottleneck strong client tie in exact
arithmetic, and which one the enumeration's argmin (or the min-sum
Hungarian init above ENUM_MAX_PAIRS pairs) takes is decided by the fp32
rounding of the completion table. The reference's table inside its jit
rounds differently from the same expression computed eagerly (one ulp in
some entries; the port equals the eager one), so a hungarian row may pair
its non-bottleneck clients differently. Such a row keeps the reference's
selected and evicted sets and its round time within rtol 1e-6 (the same
bottleneck); the other rows are held to the full tiers.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.configs import get_config as jget_config
from repro.core import matching as jmatching
from repro.core import noma as jnoma
from repro.core.engine import WirelessEngine as JEngine
from repro.core.scheduler import RoundEnv as JRoundEnv
from repro.core.scheduler import schedule_age_noma
from repro.data import TaskConfig as JTaskConfig
from repro.fl import FLServer as JFLServer
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.core import engine as E
from repro_torch.core import matching
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer
from repro_torch.kernels import pairscore

RTOL = 1e-4
ATOL_P = 1e-5
MODEL_BITS = 2e7
PAIRINGS = ("strong_weak", "adjacent", "greedy_matching", "hungarian")
SELECTIONS = ("greedy_set", "joint")
K = 3                                   # 6 slots, 3 pairs: enumeration


def make_batch(seed, b, n, *, tied=False):
    rng = np.random.default_rng(seed)
    ncfg = JNOMAConfig(n_subchannels=K)
    gains = np.stack([jnoma.sample_gains(
        rng, jnoma.sample_distances(rng, n, ncfg), ncfg) for _ in range(b)])
    n_samples = rng.uniform(100, 1000, (b, n))
    cpu_freq = rng.uniform(0.5e9, 2e9, (b, n))
    ages = rng.integers(1, 30, (b, n)).astype(float)
    if tied:
        ages = rng.integers(1, 4, (b, n)) * 1.0
        n_samples = rng.integers(1, 4, (b, n)) * 100.0
    return gains, n_samples, cpu_freq, ages


def budgets(eng, batch):
    """Per-row budgets: rows 0-1 evict (half the free round time), rows 2-3
    drain to <= 1 client (1 ms), the rest are loose (10x, no eviction)."""
    free = eng.schedule_batch(*batch, MODEL_BITS).t_round.numpy()
    fac = np.array([0.5, 0.5] + [0.0, 0.0] + [10.0] * (len(free) - 4))
    return np.where(fac > 0, free * fac, 1e-3).astype(np.float32)


CASES = {"mixed": dict(seed=3, b=6, n=16),
         "odd count": dict(seed=4, b=5, n=5),
         "tied ages": dict(seed=5, b=6, n=16, tied=True)}


@pytest.fixture(scope="module")
def runs():
    """Port and reference budget schedules for every pairing, selection and
    case, computed once."""
    out = {}
    for pairing in PAIRINGS:
        for selection in SELECTIONS:
            kw = dict(pairing=pairing, selection=selection)
            port = E.WirelessEngine(NOMAConfig(n_subchannels=K), FLConfig(),
                                    device="cpu", **kw)
            ref = JEngine(JNOMAConfig(n_subchannels=K), JFLConfig(),
                          kernel_backend="xla", **kw)
            for case, spec in CASES.items():
                batch = make_batch(**spec)
                tb = budgets(port, batch)
                out[pairing, selection, case] = (
                    batch, tb,
                    port.schedule_batch(*batch, MODEL_BITS, t_budget=tb),
                    ref.schedule_batch(*batch, MODEL_BITS, t_budget=tb))
    return out


def same_pairs(out, ref):
    """(B,) rows whose pair tables equal the reference's."""
    return ((out.pair_strong.numpy() == np.asarray(ref.pair_strong))
            & (out.pair_weak.numpy() == np.asarray(ref.pair_weak))).all(1)


def assert_matches_jax(out, ref, pairing):
    for f in ("selected", "evicted"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    same = same_pairs(out, ref)
    if pairing != "hungarian":
        assert same.all(), f"{(~same).sum()} rows pair differently"
    np.testing.assert_allclose(out.t_round.numpy()[~same],
                               np.asarray(ref.t_round)[~same], rtol=1e-6)
    np.testing.assert_allclose(out.powers.numpy()[same],
                               np.asarray(ref.powers)[same], atol=ATOL_P)
    sel = out.selected.numpy()[same]
    for f in ("rates", "t_round", "t_com", "agg_weights"):
        got = getattr(out, f).numpy()[same]
        want = np.asarray(getattr(ref, f))[same]
        if f == "t_com":                  # 1e15 placeholders off the set
            got, want = got[sel], want[sel]
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=f)
    return same


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("selection", SELECTIONS)
@pytest.mark.parametrize("pairing", PAIRINGS)
def test_budget_matches_jax(runs, pairing, selection, case):
    _, tb, out, ref = runs[pairing, selection, case]
    assert_matches_jax(out, ref, pairing)
    n_ev = out.evicted.sum(1)
    if case == "mixed":
        assert (n_ev[:2] > 0).all() and (n_ev[4:] == 0).all()
        assert (out.selected.sum(1)[2:4] <= 1).all()   # drained
    # a row that still misses its budget has one client left
    over = out.t_round.numpy() > tb
    assert (out.selected.sum(1).numpy()[over] <= 1).all()


@pytest.mark.parametrize("selection", SELECTIONS)
@pytest.mark.parametrize("pairing", PAIRINGS)
def test_budget_matches_numpy(runs, pairing, selection):
    """Against the fp64 scheduler row by row (continuous inputs: exact
    priority ties resolve by rounding, DESIGN.md section 5.4)."""
    for case in ("mixed", "odd count"):
        (gains, n_samples, cpu_freq, ages), tb, out, _ = runs[
            pairing, selection, case]
        ncfg = JNOMAConfig(n_subchannels=K)
        for b in range(gains.shape[0]):
            env = JRoundEnv(gains=gains[b], n_samples=n_samples[b],
                            cpu_freq=cpu_freq[b], ages=ages[b],
                            model_bits=MODEL_BITS)
            fl = JFLConfig(pairing=pairing, selection=selection,
                           t_budget_s=float(tb[b]))
            ref = schedule_age_noma(env, ncfg, fl)
            got = E.engine_schedule_to_numpy(out, b)
            np.testing.assert_array_equal(got.selected, ref.selected)
            assert sorted(np.flatnonzero(out.evicted[b].numpy())) \
                == sorted(ref.info["evicted"])
            if sorted(got.pairs) != sorted(ref.pairs):
                assert pairing == "hungarian", (b, got.pairs, ref.pairs)
                assert got.t_round == pytest.approx(ref.t_round, rel=1e-6)
                continue
            np.testing.assert_allclose(got.powers, ref.powers, atol=ATOL_P)
            np.testing.assert_allclose(got.rates, ref.rates, rtol=RTOL)
            assert got.t_round == pytest.approx(ref.t_round, rel=RTOL)


@pytest.mark.parametrize("selection", SELECTIONS)
def test_hungarian_budget_above_enumeration(selection):
    """K=5 (P=5 > ENUM_MAX_PAIRS): the Hungarian init and the masked 2-opt
    run inside the loop."""
    rng = np.random.default_rng(9)
    b, n, k = 8, 23, 5
    gains = rng.exponential(size=(b, n)) * 1e-9
    batch = (gains, rng.uniform(100, 1000, (b, n)),
             rng.uniform(0.5e9, 2e9, (b, n)),
             rng.integers(1, 30, (b, n)).astype(float))
    kw = dict(pairing="hungarian", selection=selection)
    port = E.WirelessEngine(NOMAConfig(n_subchannels=k), FLConfig(),
                            device="cpu", **kw)
    free = port.schedule_batch(*batch, 1e6).t_round.numpy()
    tb = (free * np.linspace(0.4, 1.2, b)).astype(np.float32)
    out = port.schedule_batch(*batch, 1e6, t_budget=tb)
    ref = JEngine(JNOMAConfig(n_subchannels=k), JFLConfig(),
                  kernel_backend="xla", **kw).schedule_batch(
        *batch, 1e6, t_budget=tb)
    same = assert_matches_jax(out, ref, "hungarian")
    assert out.evicted.sum() > 0
    assert same.sum() >= b // 2


def test_loop_rates_are_the_pairscore_rates():
    """The loop scores its pairs through ``pairscore.pairscore``, so its
    final rates and powers are bitwise what the wrapper gives over the
    final pair tables: the reference's post-hoc ``_rescore_pallas`` would
    recompute the same values and has no counterpart."""
    batch = make_batch(11, 6, 16)
    eng = E.WirelessEngine(NOMAConfig(n_subchannels=K), FLConfig(),
                           device="cpu")
    out = eng.schedule_batch(*batch, MODEL_BITS,
                             t_budget=budgets(eng, batch))
    assert out.evicted.any()
    gains = torch.as_tensor(batch[0], dtype=torch.float32)
    strong, weak = out.pair_strong, out.pair_weak
    pair = weak >= 0
    n = gains.shape[1]
    prm = eng.prm
    p_i, p_j, r_i, r_j = pairscore.pairscore(
        gains.gather(1, torch.where(pair, strong, 0)),
        gains.gather(1, weak.clamp(0, n - 1)), n0b=prm.noise_power_w,
        pmax=prm.max_power_w, bw=prm.bandwidth_hz)
    for idx, r, p in ((strong, r_i, p_i), (weak, r_j, p_j)):
        got_r = out.rates.gather(1, idx.clamp(0, n - 1))
        got_p = out.powers.gather(1, idx.clamp(0, n - 1))
        assert torch.equal(got_r[pair], r[pair])
        assert torch.equal(got_p[pair], p[pair])
    solo = (strong >= 0) & ~pair
    assert solo.any()
    assert (out.powers.gather(1, strong.clamp(0, n - 1))[solo]
            == prm.max_power_w).all()


class TestMaskedMatching:
    """The masked solvers against the reference's on random tables."""

    @staticmethod
    def tables(b=12, p=6, seed=0):
        rng = np.random.default_rng(seed)
        table = rng.uniform(1.0, 2.0, (b, 2 * p, 2 * p)).astype(np.float32)
        m_valid = rng.integers(0, p + 1, b)
        return table, m_valid

    def test_pad_cost_table(self):
        table, mv = self.tables()
        cost = table[:, :6, 6:]
        for fill in (0.0, 7.0):
            got = matching.pad_cost_table(torch.as_tensor(cost),
                                          torch.as_tensor(mv), fill)
            want = jmatching.pad_cost_table(cost, mv, fill_invalid=fill)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_two_opt_and_bottleneck(self):
        table, mv = self.tables(seed=1)
        b, p = table.shape[0], 6
        a0 = np.tile(np.arange(p), (b, 1))
        b0 = np.tile(np.arange(2 * p - 1, p - 1, -1), (b, 1))
        T = torch.as_tensor
        for m_valid in (None, mv):
            tm = None if m_valid is None else T(m_valid)
            a, w = matching.two_opt_refine(T(table), T(a0), T(b0),
                                           m_valid=tm)
            ja, jw = jmatching.two_opt_refine(table, a0, b0,
                                              m_valid=m_valid)
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(
                matching.pair_bottleneck(T(table), a, w, tm).numpy(),
                np.asarray(jmatching.pair_bottleneck(table, ja, jw,
                                                     m_valid)))
        adj = 2 * a0
        inits = ((a0, b0), (adj, adj + 1))
        got = matching.best_bottleneck_matching(
            T(table), [(T(x), T(y)) for x, y in inits], m_valid=T(mv))
        want = jmatching.best_bottleneck_matching(table, inits, m_valid=mv)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # an all-pad matching scores -inf
        assert (matching.pair_bottleneck(
            T(table), T(a0), T(b0), torch.zeros(b, dtype=torch.int64))
            == -torch.inf).all()

    def test_padded_hungarian_matches_valid_block(self):
        """Hungarian on the padded table assigns valid rows to valid
        columns exactly as on the valid block alone."""
        table, mv = self.tables(seed=2)
        cost = torch.as_tensor(table[:, :6, 6:])
        sigma = matching.hungarian_assignment(
            matching.pad_cost_table(cost, torch.as_tensor(mv)))
        for r in range(len(mv)):
            m = int(mv[r])
            if m:
                alone = matching.hungarian_assignment(cost[r, :m, :m])
                assert torch.equal(sigma[r, :m], alone)


def mc_inputs(r, s, n, seed=0):
    rng = np.random.default_rng(seed)
    ncfg = JNOMAConfig(n_subchannels=K)
    dist = np.stack([jnoma.sample_distances(rng, n, ncfg) for _ in range(s)])
    gains = np.stack([np.stack([jnoma.sample_gains(rng, dist[j], ncfg)
                                for j in range(s)]) for _ in range(r)])
    return (gains, rng.uniform(100, 1000, (s, n)),
            rng.uniform(0.5e9, 2e9, (s, n)))


MC_EXACT = ("n_selected", "max_age", "participation", "final_ages",
            "aou_hist", "n_evicted")


@pytest.mark.parametrize("pairing", ["strong_weak", "hungarian"])
def test_montecarlo_budget_matches_jax(pairing):
    """``montecarlo_rounds(policy="age_noma_budget")`` with a budget that
    evicts in most rounds, on the same pre-sampled inputs."""
    inputs = mc_inputs(4, 3, 24)
    kw = dict(policy="age_noma_budget", t_budget=0.35)
    out = E.WirelessEngine(NOMAConfig(n_subchannels=K), FLConfig(),
                           device="cpu", pairing=pairing).montecarlo_rounds(
        *inputs, 1e6, **kw)
    ref = JEngine(JNOMAConfig(n_subchannels=K), JFLConfig(),
                  kernel_backend="xla", pairing=pairing).montecarlo_rounds(
        *inputs, 1e6, **kw)
    assert sorted(out) == sorted(ref)
    for key in MC_EXACT:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("t_round", "t_comp_bottleneck", "t_up_bottleneck"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, err_msg=key)
    assert (out["n_evicted"] > 0).float().mean() > 0.5


def test_zero_budget_array_runs_the_loop_without_eviction():
    """An array budget <= 0 takes the loop (the reference's rule) and
    evicts nothing: the schedule is the fast path's."""
    batch = make_batch(12, 4, 16)
    eng = E.WirelessEngine(NOMAConfig(n_subchannels=K), FLConfig(),
                           device="cpu")
    fast = eng.schedule_batch(*batch, MODEL_BITS)
    loop = eng.schedule_batch(*batch, MODEL_BITS, t_budget=np.zeros(4))
    assert torch.equal(fast.selected, loop.selected)
    assert not loop.evicted.any()
    torch.testing.assert_close(loop.t_round, fast.t_round, rtol=1e-6,
                               atol=0.0)


# ---------------------------------------------------------------------------
# FLServer(policy="age_noma_budget")
# ---------------------------------------------------------------------------

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
TASK_KW = dict(vocab_size=32, n_topics=4, seq_len=17, seed=0)
FL_KW = dict(n_clients=8, rounds=3, local_epochs=1, local_batch=8, lr=0.2,
             samples_per_client=(24, 48), seed=0)
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


def fl_pair(fl_kw, n_sub=2):
    ref = JFLServer(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**fl_kw), JNOMAConfig(n_subchannels=n_sub),
        JTaskConfig(**TASK_KW), policy="age_noma_budget", engine="jax",
        eval_every=1)
    port = FLServer(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**fl_kw), NOMAConfig(n_subchannels=n_sub),
        TaskConfig(**TASK_KW), policy="age_noma_budget", eval_every=1,
        device="cpu", params=jax.tree.map(np.asarray, ref.params))
    ref_masks, port_masks = recording(ref), recording(port)
    return ((ref, ref.run(ROUNDS), ref_masks),
            (port, port.run(ROUNDS), port_masks))


@pytest.fixture(scope="module", params=["auto", "explicit"])
def budget_runs(request):
    """The auto-calibrated budget (a seed whose first round's calibration
    binds in every round), and an explicit ``t_budget_s`` that evicts."""
    if request.param == "explicit":
        return fl_pair(dict(FL_KW, t_budget_s=0.5))
    return fl_pair(dict(FL_KW, seed=1))


def test_fl_budget_selections(budget_runs):
    (ref, ref_h, ref_masks), (port, port_h, port_masks) = budget_runs
    assert len(port_masks) == len(ref_masks) == ROUNDS
    for r, (a, b) in enumerate(zip(port_masks, ref_masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
    assert port_h.n_selected == ref_h.n_selected
    assert port_h.n_evicted == ref_h.n_evicted
    assert max(port_h.n_evicted) > 0
    assert port_h.max_age == ref_h.max_age
    assert port._auto_budget == pytest.approx(ref._auto_budget, rel=1e-6)


def test_fl_budget_times_losses_and_parameters(budget_runs):
    from repro_torch import convert
    (ref, ref_h, _), (port, port_h, _) = budget_runs
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=RTOL)
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=RTOL)
    assert all(t <= port._auto_budget or n <= 1 for t, n in
               zip(port_h.round_time, port_h.n_selected))
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, ref.params))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   atol=1e-5, rtol=0, err_msg=name)
