"""Port engine (src/repro_torch/core/engine.py) against the reference.

The same numpy inputs go to the port's ``schedule_batch`` on the CPU, the
reference JAX engine (``kernel_backend="xla"``) and the numpy fp64
scheduler. Masks and pair tables match exactly; powers to atol 1e-5;
rates and round times to rtol 1e-4 (DESIGN.md section 5).

The hungarian policy reads the planner's bf16 table, so it is held against
the reference under ``kernel_backend="pallas_interpret"``, whose table is
the same bf16 round trip. ``montecarlo_rounds`` is held against the
reference's rollout on the same pre-sampled gains; its ``random`` policy
draws from a ``torch.Generator`` and cannot reproduce ``jax.random``, so it
is tested by its invariants.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.core import noma as jnoma
from repro.core.engine import WirelessEngine as JEngine
from repro.core.scheduler import RoundEnv as JRoundEnv
from repro.core.scheduler import schedule_age_noma
from repro_torch.configs import FLConfig, NOMAConfig
from repro_torch.core import engine as E
from repro_torch.core import plan
from repro_torch.core.plan import RoundEnv

RTOL = 1e-4
ATOL_P = 1e-5
MODEL_BITS = 1e6


def make_batch(seed, drops, n, k, *, int_samples=False):
    """The engine_throughput recipe (benchmarks/engine_throughput.py)."""
    rng = np.random.default_rng(seed)
    ncfg = JNOMAConfig(n_subchannels=k)
    dist = np.stack([jnoma.sample_distances(rng, n, ncfg)
                     for _ in range(drops)])
    gains = np.stack([jnoma.sample_gains(rng, dist[b], ncfg)
                      for b in range(drops)])
    n_samples = rng.uniform(100, 1000, (drops, n))
    if int_samples:
        n_samples = np.round(n_samples)
    cpu_freq = rng.uniform(0.5e9, 2e9, (drops, n))
    ages = rng.integers(1, 30, (drops, n)).astype(float)
    return gains, n_samples, cpu_freq, ages


def port_engine(k, **kw):
    return E.WirelessEngine(NOMAConfig(n_subchannels=k), FLConfig(),
                            device="cpu", **kw)


def jax_engine(k, kernel_backend="xla", **kw):
    return JEngine(JNOMAConfig(n_subchannels=k), JFLConfig(),
                   kernel_backend=kernel_backend, **kw)


# the reference backend whose tables match the port's for each policy
REF_BACKEND = {"strong_weak": "xla", "adjacent": "xla",
               "greedy_matching": "xla", "hungarian": "pallas_interpret"}


def assert_matches_jax(out, ref):
    np.testing.assert_array_equal(out.selected.numpy(),
                                  np.asarray(ref.selected))
    np.testing.assert_array_equal(out.pair_strong.numpy(),
                                  np.asarray(ref.pair_strong))
    np.testing.assert_array_equal(out.pair_weak.numpy(),
                                  np.asarray(ref.pair_weak))
    np.testing.assert_allclose(out.powers.numpy(), np.asarray(ref.powers),
                               atol=ATOL_P)
    np.testing.assert_allclose(out.rates.numpy(), np.asarray(ref.rates),
                               rtol=RTOL)
    np.testing.assert_allclose(out.t_round.numpy(), np.asarray(ref.t_round),
                               rtol=RTOL)
    np.testing.assert_allclose(out.agg_weights.numpy(),
                               np.asarray(ref.agg_weights), rtol=RTOL)
    np.testing.assert_allclose(out.t_cmp.numpy(), np.asarray(ref.t_cmp),
                               rtol=RTOL)


def assert_matches_numpy(out, batch, k, *, oma=False):
    gains, n_samples, cpu_freq, ages = batch
    ncfg = JNOMAConfig(n_subchannels=k)
    for b in range(gains.shape[0]):
        env = JRoundEnv(gains=gains[b], n_samples=n_samples[b],
                        cpu_freq=cpu_freq[b], ages=ages[b],
                        model_bits=MODEL_BITS)
        ref = schedule_age_noma(env, ncfg, JFLConfig(), oma=oma)
        got = E.engine_schedule_to_numpy(out, b)
        np.testing.assert_array_equal(got.selected, ref.selected)
        assert sorted(got.pairs) == sorted(ref.pairs)
        np.testing.assert_allclose(got.powers, ref.powers, atol=ATOL_P)
        np.testing.assert_allclose(got.rates, ref.rates, rtol=RTOL)
        assert got.t_round == pytest.approx(ref.t_round, rel=RTOL)


GRID = [(8, 64, 16), (4, 256, 64), (2, 1000, 128)]


class TestScheduleBatch:
    @pytest.mark.parametrize("b,n,k", GRID)
    def test_matches_jax_and_numpy(self, b, n, k):
        batch = make_batch(n, b, n, k)
        out = port_engine(k).schedule_batch(*batch, MODEL_BITS)
        ref = jax_engine(k).schedule_batch(*batch, MODEL_BITS)
        assert_matches_jax(out, ref)
        assert_matches_numpy(out, batch, k)
        assert (out.selected.sum(1) == min(2 * k, n)).all()

    @pytest.mark.parametrize("n,k", [(5, 3), (9, 8)])
    def test_odd_candidate_count_parks_a_solo(self, n, k):
        batch = make_batch(40 + n, 4, n, k)
        out = port_engine(k).schedule_batch(*batch, MODEL_BITS)
        assert_matches_jax(out, jax_engine(k).schedule_batch(*batch,
                                                             MODEL_BITS))
        assert_matches_numpy(out, batch, k)
        assert ((out.pair_strong >= 0) & (out.pair_weak < 0)).sum(1).eq(1).all()

    def test_oma(self):
        batch = make_batch(7, 4, 64, 16)
        out = port_engine(16).schedule_batch(*batch, MODEL_BITS, oma=True)
        ref = jax_engine(16).schedule_batch(*batch, MODEL_BITS, oma=True)
        assert_matches_jax(out, ref)
        assert_matches_numpy(out, batch, 16, oma=True)

    @pytest.mark.parametrize("n,k", [(64, 16), (300, 20)])
    def test_tied_priorities_match_jax_bit_for_bit(self, n, k):
        """Integer ages and sample counts: many exact priority ties, which
        resolve by gain then index exactly as in the reference."""
        gains, n_samples, cpu_freq, ages = make_batch(
            11, 4, n, k, int_samples=True)
        ages = np.random.default_rng(3).integers(1, 4, ages.shape) * 1.0
        n_samples = np.random.default_rng(4).integers(1, 4, ages.shape) * 100.0
        batch = (gains, n_samples, cpu_freq, ages)
        out = port_engine(k).schedule_batch(*batch, MODEL_BITS)
        ref = jax_engine(k).schedule_batch(*batch, MODEL_BITS)
        prio = E._age_priority(torch.as_tensor(ages, dtype=torch.float32),
                               torch.as_tensor(n_samples,
                                               dtype=torch.float32), 1.0)
        kth = torch.sort(prio, dim=1, descending=True).values[:, 2 * k - 1]
        assert ((prio == kth[:, None]).sum(1) > 1).all()  # ties straddle
        assert_matches_jax(out, ref)

    def test_admission_modes_and_explicit_priority(self):
        batch = make_batch(5, 4, 256, 16)
        eng = port_engine(16)
        outs = [eng.schedule_batch(*batch, MODEL_BITS, admission=a)
                for a in ("auto", "full_sort", "segmented")]
        for o in outs[1:]:
            assert torch.equal(o.selected, outs[0].selected)
        prio = batch[0]                               # channel priority
        out = eng.schedule_batch(*batch, MODEL_BITS, priority=prio)
        ref = jax_engine(16).schedule_batch(*batch, MODEL_BITS,
                                            priority=prio)
        assert_matches_jax(out, ref)


class TestContract:
    def test_schedule_matches_reference_schedule(self):
        gains, n_samples, cpu_freq, ages = make_batch(2, 1, 40, 10)
        env = RoundEnv(gains=gains[0], n_samples=n_samples[0],
                       cpu_freq=cpu_freq[0], ages=ages[0], model_bits=4e6)
        got = port_engine(10).schedule(env)
        ref = jax_engine(10).schedule(JRoundEnv(**dataclasses.asdict(env)))
        np.testing.assert_array_equal(got.selected, ref.selected)
        assert got.pairs == ref.pairs
        assert got.t_round == pytest.approx(ref.t_round, rel=RTOL)
        assert got.info["evicted"] == []

    def test_schedule_diag_matches_numpy_diag(self):
        batch = make_batch(9, 3, 64, 16)
        out = port_engine(16).schedule_batch(*batch, MODEL_BITS)
        diag = E.schedule_diag(out, batch[3])
        for b in range(3):
            ref = plan.schedule_diag(E.engine_schedule_to_numpy(out, b),
                                     batch[3][b])
            assert diag["t_comp_bottleneck"][b].item() == pytest.approx(
                ref["t_comp_bottleneck"], rel=1e-6)
            assert diag["t_up_bottleneck"][b].item() == pytest.approx(
                ref["t_up_bottleneck"], rel=1e-6)
            assert diag["n_selected"][b].item() == ref["n_selected"] == 32
            assert diag["n_evicted"][b].item() == ref["n_evicted"] == 0
            np.testing.assert_array_equal(diag["aou_hist"][b].numpy(),
                                          ref["aou_hist"])
            # the bottleneck split sums to the round time
            assert (ref["t_comp_bottleneck"] + ref["t_up_bottleneck"]
                    == pytest.approx(ref["t_round"], rel=1e-6))

    def test_round_robin_priority_window(self):
        prio = E.round_robin_priority(3, 10, 4, "cpu")
        top = torch.sort(prio, descending=True, stable=True).indices[:4]
        assert sorted(top.tolist()) == sorted((3 * 4 + i) % 10
                                              for i in range(4))

    @pytest.mark.parametrize("method,kw,exc", [
        ("schedule_batch", dict(pairing="nope"), ValueError),
        ("schedule_batch", dict(admission="nope"), ValueError),
        ("montecarlo_rounds", dict(policy="nope"), ValueError),
    ])
    def test_out_of_scope_raises(self, method, kw, exc):
        gains, n_samples, cpu_freq, ages = make_batch(1, 2, 16, 4)
        eng = port_engine(4)
        with pytest.raises(exc, match="ROADMAP queue|unknown"):
            if method == "schedule_batch":
                eng.schedule_batch(gains, n_samples, cpu_freq, ages,
                                   MODEL_BITS, **kw)
            else:
                eng.montecarlo_rounds(np.stack([gains, gains]), n_samples,
                                      cpu_freq, MODEL_BITS, **kw)


    @pytest.mark.parametrize("policy", ["age_noma", "random"])
    def test_shard_equals_unsplit(self, policy):
        """``shard=True`` on a host without several cards runs as
        ``shard=False``: bitwise the same result."""
        gains, n_samples, cpu_freq, ages = make_batch(1, 2, 16, 4)
        eng = port_engine(4)
        seq = np.stack([gains, gains * 0.5])
        a, b = (eng.montecarlo_rounds(seq, n_samples, cpu_freq, MODEL_BITS,
                                      policy=policy, shard=shard)
                for shard in (False, True))
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def assert_pairs_match_or_near_tie(out, ref, k, batch):
    """Pair tables equal the reference's; a row that differs must be a
    bf16 near-tie: both matchings' round times within the bf16 tier."""
    same = ((out.pair_strong.numpy() == np.asarray(ref.pair_strong))
            & (out.pair_weak.numpy() == np.asarray(ref.pair_weak))).all(1)
    for b in np.flatnonzero(~same):
        assert out.t_round[b].item() == pytest.approx(
            float(ref.t_round[b]), rel=1e-2), f"row {b}: not a near-tie"
    assert same.all(), (f"{(~same).sum()} of {len(same)} rows pair "
                        f"differently (near-ties at the bf16 tier)")


PAIRING_GRID = [(4, 24, 3), (2, 64, 5), (2, 256, 16)]


class TestPairingPolicies:
    @pytest.mark.parametrize("b,n,k", PAIRING_GRID)
    @pytest.mark.parametrize("pairing", ["adjacent", "greedy_matching"])
    def test_index_and_greedy_policies_match_jax(self, pairing, b, n, k):
        batch = make_batch(n + k, b, n, k)
        out = port_engine(k, pairing=pairing).schedule_batch(*batch,
                                                             MODEL_BITS)
        ref = jax_engine(k, pairing=pairing).schedule_batch(*batch,
                                                            MODEL_BITS)
        assert_matches_jax(out, ref)

    @pytest.mark.parametrize("b,n,k", PAIRING_GRID + [(3, 16, 2)])
    def test_hungarian_matches_jax_bf16_tables(self, b, n, k):
        """K=2 (m=2 <= ENUM_MAX_PAIRS) takes the enumeration branch, the
        rest the assignment + bottleneck 2-opt branch."""
        batch = make_batch(n + k, b, n, k)
        out = port_engine(k, pairing="hungarian").schedule_batch(
            *batch, MODEL_BITS)
        ref = jax_engine(k, "pallas_interpret",
                         pairing="hungarian").schedule_batch(*batch,
                                                             MODEL_BITS)
        np.testing.assert_array_equal(out.selected.numpy(),
                                      np.asarray(ref.selected))
        np.testing.assert_allclose(out.t_round.numpy(),
                                   np.asarray(ref.t_round), rtol=RTOL)
        assert_pairs_match_or_near_tie(out, ref, k, batch)
        # never slower than strong_weak (the guard compares in fp32)
        sw = port_engine(k).schedule_batch(*batch, MODEL_BITS)
        assert (out.t_round <= sw.t_round * (1 + 1e-2)).all()

    @pytest.mark.parametrize("oma", [False, True])
    def test_hungarian_oma_odd(self, oma):
        """An odd slot count (the weakest candidate parks alone) under
        both rate models."""
        batch = make_batch(21, 3, 40, 11)
        eng = port_engine(11, pairing="hungarian")
        out = eng.schedule_batch(*batch, MODEL_BITS, oma=oma)
        ref = jax_engine(11, "pallas_interpret",
                         pairing="hungarian").schedule_batch(
            *batch, MODEL_BITS, oma=oma)
        np.testing.assert_array_equal(out.selected.numpy(),
                                      np.asarray(ref.selected))
        np.testing.assert_allclose(out.t_round.numpy(),
                                   np.asarray(ref.t_round), rtol=RTOL)
        assert_pairs_match_or_near_tie(out, ref, 11, batch)


class TestJointSelection:
    @pytest.mark.parametrize("n,k", [(8, 3), (24, 5)])
    @pytest.mark.parametrize("pairing", ["strong_weak", "hungarian"])
    def test_joint_matches_jax(self, pairing, n, k):
        """N=8 takes the exhaustive enumeration, N=24 the swap search."""
        batch = make_batch(n + k + 1, 4, n, k)
        out = port_engine(k, pairing=pairing,
                          selection="joint").schedule_batch(*batch,
                                                            MODEL_BITS)
        ref = jax_engine(k, REF_BACKEND[pairing], pairing=pairing,
                         selection="joint").schedule_batch(*batch,
                                                           MODEL_BITS)
        np.testing.assert_array_equal(out.selected.numpy(),
                                      np.asarray(ref.selected))
        np.testing.assert_allclose(out.t_round.numpy(),
                                   np.asarray(ref.t_round), rtol=RTOL)
        greedy = port_engine(k, pairing=pairing).schedule_batch(*batch,
                                                                MODEL_BITS)
        assert (out.t_round <= greedy.t_round).all()     # never worse
        assert (out.selected.sum(1) == min(2 * k, n)).all()


def mc_inputs(r, s, n, k, seed=0):
    rng = np.random.default_rng(seed)
    ncfg = JNOMAConfig(n_subchannels=k)
    dist = np.stack([jnoma.sample_distances(rng, n, ncfg) for _ in range(s)])
    gains = np.stack([np.stack([jnoma.sample_gains(rng, dist[j], ncfg)
                                for j in range(s)]) for _ in range(r)])
    return (gains, rng.uniform(100, 1000, (s, n)),
            rng.uniform(0.5e9, 2e9, (s, n)))


MC_EXACT = ("n_selected", "max_age", "participation", "final_ages",
            "aou_hist", "n_evicted")


class TestMonteCarlo:
    R, S, N, K = 4, 3, 24, 3

    @pytest.mark.parametrize("policy", ["age_noma", "oma_age", "channel",
                                        "round_robin"])
    @pytest.mark.parametrize("pairing", ["strong_weak", "hungarian"])
    def test_rounds_match_jax(self, pairing, policy):
        inputs = mc_inputs(self.R, self.S, self.N, self.K)
        out = port_engine(self.K, pairing=pairing).montecarlo_rounds(
            *inputs, MODEL_BITS, policy=policy)
        ref = jax_engine(self.K, REF_BACKEND[pairing],
                         pairing=pairing).montecarlo_rounds(
            *inputs, MODEL_BITS, policy=policy)
        assert sorted(out) == sorted(ref)
        for key in MC_EXACT:
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        for key in ("t_round", "t_comp_bottleneck", "t_up_bottleneck"):
            np.testing.assert_allclose(out[key].numpy(),
                                       np.asarray(ref[key]), rtol=RTOL,
                                       err_msg=key)

    def test_per_round_inputs_and_joint(self):
        """(R, S, N) per-round sample counts and cpu, joint selection."""
        gains, n_samples, cpu_freq = mc_inputs(self.R, self.S, self.N,
                                               self.K, seed=4)
        rng = np.random.default_rng(5)
        ns = n_samples * rng.uniform(0.5, 1.5, (self.R, 1, 1))
        cf = cpu_freq * rng.uniform(0.5, 1.5, (self.R, 1, 1))
        kw = dict(pairing="hungarian", selection="joint")
        out = port_engine(self.K, **kw).montecarlo_rounds(gains, ns, cf,
                                                          MODEL_BITS)
        ref = jax_engine(self.K, "pallas_interpret",
                         **kw).montecarlo_rounds(gains, ns, cf, MODEL_BITS)
        for key in MC_EXACT:
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        np.testing.assert_allclose(out["t_round"].numpy(),
                                   np.asarray(ref["t_round"]), rtol=RTOL)

    def test_random_policy_invariants_and_seed(self):
        inputs = mc_inputs(6, self.S, self.N, self.K)
        eng = port_engine(self.K)
        a = eng.montecarlo_rounds(*inputs, MODEL_BITS, policy="random",
                                  seed=3)
        b = eng.montecarlo_rounds(*inputs, MODEL_BITS, policy="random",
                                  seed=3)
        c = eng.montecarlo_rounds(*inputs, MODEL_BITS, policy="random",
                                  seed=4)
        slots = 2 * self.K
        assert (a["n_selected"] == slots).all()
        assert a["participation"].sum().item() == 6 * self.S * slots
        for key in a:
            assert torch.equal(a[key], b[key]), key
        assert not torch.equal(a["participation"], c["participation"])
        # ages: 1 where selected in the last round, else grown by one
        assert (a["final_ages"] >= 1).all()
        assert ((a["final_ages"] == 1).sum(1) == slots).all()
