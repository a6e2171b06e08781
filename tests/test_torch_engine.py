"""Port engine (src/repro_torch/core/engine.py) against the reference.

The same numpy inputs go to the port's ``schedule_batch`` on the CPU, the
reference JAX engine (``kernel_backend="xla"``) and the numpy fp64
scheduler. Masks and pair tables match exactly; powers to atol 1e-5;
rates and round times to rtol 1e-4 (DESIGN.md section 5).
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


def jax_engine(k):
    return JEngine(JNOMAConfig(n_subchannels=k), JFLConfig(),
                   kernel_backend="xla")


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

    @pytest.mark.parametrize("kw,exc", [
        (dict(pairing="hungarian"), NotImplementedError),
        (dict(selection="joint"), NotImplementedError),
        (dict(t_budget=1.0), NotImplementedError),
        (dict(pairing="nope"), ValueError),
        (dict(admission="nope"), ValueError),
    ])
    def test_out_of_scope_raises(self, kw, exc):
        batch = make_batch(1, 2, 16, 4)
        with pytest.raises(exc):
            port_engine(4).schedule_batch(*batch, MODEL_BITS, **kw)

    def test_multicell_raises(self):
        with pytest.raises(NotImplementedError):
            E.WirelessEngine(NOMAConfig(), FLConfig(n_cells=3),
                             device="cpu")
