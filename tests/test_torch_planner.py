"""Port planner tables and matching solvers against the reference.

The plain planner (``repro_torch.kernels.planner.planner_tables_plain``,
what the wrapper runs for CPU tensors) is held against the reference's
Pallas planner kernel in interpret mode: the bf16 table within one bf16
ulp (rtol 2**-7), ``row_min`` and ``t_sw`` to rtol 1e-6; and against the
reference's fp32 XLA twin at the bf16 tier (rtol 1e-2). The matching
solvers (``repro_torch.core.matching``) equal ``repro.core.matching``
exactly on the same fp32 tables. The CUDA kernel itself runs only on a
card (tests/test_torch_cuda.py).
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matching as jmatching
from repro.core import pairing as jpairing
from repro.core import plan as jplan
from repro.kernels import planner as jplanner
from repro_torch.core import matching, pairing, plan
from repro_torch.kernels import build, planner

REPO = Path(__file__).resolve().parents[1]
KW = dict(n0b=1e-14, pmax=0.2, bw=1e6)
BF16_ULP = 2.0 ** -7          # one bf16 ulp, relative, at worst
MB = 4e6


def cands(seed, b, c):
    """Gain-sorted candidates and their compute times (fp32)."""
    rng = np.random.default_rng(seed)
    g = np.sort(rng.uniform(1e-14, 1e-10, (b, c)), axis=-1)[:, ::-1]
    tc = rng.uniform(0.05, 0.5, (b, c))
    return g.astype(np.float32).copy(), tc.astype(np.float32)


def port_tables(g, tc, **kw):
    return planner.planner_tables(torch.from_numpy(g), torch.from_numpy(tc),
                                  MB, **KW, **kw)


def as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


class TestPlannerTables:
    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("c", [1, 2, 3, 7, 10, 129])
    def test_plain_matches_interpret_kernel(self, c, oma):
        g, tc = cands(11 * c + oma, 2, c)
        ref_t, ref_rm, ref_sw = jplanner.planner_tables(
            g, tc, MB, impl="interpret", oma=oma, **KW)
        tab, rm, sw = port_tables(g, tc, oma=oma)
        assert tab.dtype == torch.bfloat16 and tab.shape == (2, c, c)
        np.testing.assert_allclose(tab.float().numpy(), as_f32(ref_t),
                                   rtol=BF16_ULP, atol=0)
        np.testing.assert_allclose(rm.numpy(), np.asarray(ref_rm),
                                   rtol=1e-6)
        np.testing.assert_allclose(sw.numpy(), np.asarray(ref_sw),
                                   rtol=1e-6)

    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("c", [1, 2, 3, 7, 10, 129])
    def test_plain_matches_xla_twin_at_bf16_tier(self, c, oma):
        g, tc = cands(13 * c + oma, 2, c)
        ref_t, ref_rm, ref_sw = jplanner.planner_tables(
            g, tc, MB, impl="xla", oma=oma, **KW)
        tab, rm, sw = port_tables(g, tc, oma=oma)
        np.testing.assert_allclose(tab.float().numpy(), np.asarray(ref_t),
                                   rtol=1e-2)
        np.testing.assert_allclose(rm.numpy(), np.asarray(ref_rm),
                                   rtol=1e-6)
        np.testing.assert_allclose(sw.numpy(), np.asarray(ref_sw),
                                   rtol=1e-6)

    def test_single_pair_semantics(self):
        """c=2: t_sw is exactly the one off-diagonal pair entry and
        row_min the off-diagonal minimum (fp32, before the bf16 cast)."""
        g, tc = cands(7, 1, 2)
        ref_t, _, _ = jplanner.planner_tables(g, tc, MB, impl="xla", **KW)
        _, rm, sw = port_tables(g, tc)
        assert float(sw[0]) == pytest.approx(float(ref_t[0, 0, 1]),
                                             rel=1e-6)
        assert float(rm[0, 0]) == pytest.approx(float(ref_t[0, 0, 1]),
                                                rel=1e-6)
        assert float(rm[0, 1]) == pytest.approx(float(ref_t[0, 1, 0]),
                                                rel=1e-6)

    def test_no_pairs_gives_zero_bottleneck(self):
        g, tc = cands(3, 3, 1)
        _, rm, sw = port_tables(g, tc)
        assert torch.equal(sw, torch.zeros(3))
        assert torch.isinf(rm).all()

    def test_completion_table_matches_xla_twin(self):
        """The fp32 table of the joint enumeration, with extra leading
        dims and a per-row model size."""
        from repro.kernels import pairscore as jpair
        from repro_torch.kernels import pairscore
        g, tc = cands(5, 6, 4)
        g, tc = g.reshape(2, 3, 4), tc.reshape(2, 3, 4)
        mb = np.array([[2e6], [4e6]], np.float32)
        ref = jpair.completion_table(g, tc, mb, impl="xla", **KW)
        out = pairscore.completion_table(
            torch.from_numpy(g), torch.from_numpy(tc), torch.from_numpy(mb),
            **KW)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)

    def test_effective_power_table_is_exact(self):
        from repro.kernels import pairscore as jpair
        from repro_torch.kernels import pairscore
        g, _ = cands(9, 2, 10)
        ref = jpair.effective_power_table(g[:, :5], g[:, 5:], n0b=KW["n0b"],
                                          pmax=KW["pmax"])
        out = pairscore.effective_power_table(
            torch.from_numpy(g[:, :5]), torch.from_numpy(g[:, 5:]),
            n0b=KW["n0b"], pmax=KW["pmax"])
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    def test_cpu_wrapper_takes_plain_and_counts_nothing(self):
        g, tc = cands(1, 2, 6)
        before = planner.planner_tables.launches
        out = port_tables(g, tc)
        ref = planner.planner_tables_plain(torch.from_numpy(g),
                                           torch.from_numpy(tc), MB, **KW)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        assert planner.planner_tables.launches == before

    def test_import_needs_no_nvcc(self, tmp_path):
        code = ("import repro_torch.kernels.planner, "
                "repro_torch.core.matching, repro_torch.core.engine; "
                "from repro_torch.kernels import build; "
                "assert build.load.cache_info().currsize == 0")
        env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       cwd=REPO / "src")

    def test_header_edit_changes_library_hash(self, tmp_path, monkeypatch):
        """pair_math.cuh is shared by pairscore.cu and planner.cu: editing
        it must rebuild the library, so it is part of the digest."""
        for src in build.CSRC.iterdir():
            shutil.copy(src, tmp_path / src.name)
        monkeypatch.setattr(build, "CSRC", tmp_path)
        srcs = build.sources()
        before = build._digest(srcs)
        with open(tmp_path / "pair_math.cuh", "a") as f:
            f.write("// edited\n")
        assert build._digest(srcs) != before


def tables(seed, b, m):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 5.0, (b, m, m)).astype(np.float32)


def coarse_tables(seed, b, m):
    """Costs on a coarse grid: many exact ties, so the tiebreaks show."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, (b, m, m)).astype(np.float32)


MS = [1, 2, 5, 9, 16]


class TestMatching:
    @pytest.mark.parametrize("make", [tables, coarse_tables])
    @pytest.mark.parametrize("m", MS)
    def test_hungarian_exact(self, m, make):
        cost = make(m, 3, m)
        out = matching.hungarian_assignment(torch.from_numpy(cost))
        ref = jmatching.hungarian_assignment(jnp.asarray(cost))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        # a permutation per row
        assert (np.sort(out.numpy(), axis=1) == np.arange(m)).all()

    @pytest.mark.parametrize("make", [tables, coarse_tables])
    @pytest.mark.parametrize("m", MS)
    def test_greedy_exact(self, m, make):
        score = make(100 + m, 3, m)
        out = matching.greedy_assignment(torch.from_numpy(score))
        ref = jmatching.greedy_assignment(jnp.asarray(score))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("make", [tables, coarse_tables])
    @pytest.mark.parametrize("m", MS)
    def test_two_opt_and_best_bottleneck_exact(self, m, make):
        """The engine's three inits (assignment, reversal, adjacent) over
        the full (2m, 2m) table."""
        c = 2 * m
        table = make(200 + m, 3, c)
        tt, tj = torch.from_numpy(table), jnp.asarray(table)
        sigma = np.asarray(jmatching.hungarian_assignment(
            tj[:, :m, m:]))
        ar = np.broadcast_to(np.arange(m), (3, m))
        rev = np.broadcast_to(np.arange(c - 1, m - 1, -1), (3, m))
        adj = np.broadcast_to(2 * np.arange(m), (3, m))
        inits = [(ar, m + sigma), (ar, rev), (adj, adj + 1)]
        ca, cb = matching.two_opt_refine(
            tt, torch.as_tensor(ar.copy()), torch.as_tensor(rev.copy()))
        ra, rb = jmatching.two_opt_refine(tj, jnp.asarray(ar),
                                          jnp.asarray(rev))
        np.testing.assert_array_equal(ca.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(cb.numpy(), np.asarray(rb))
        a_p, b_p = matching.best_bottleneck_matching(
            tt, [(torch.as_tensor(a.copy()), torch.as_tensor(b.copy()))
                 for a, b in inits])
        ra, rb = jmatching.best_bottleneck_matching(
            tj, [(jnp.asarray(a), jnp.asarray(b)) for a, b in inits])
        np.testing.assert_array_equal(a_p.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(b_p.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(
            matching.pair_bottleneck(tt, a_p, b_p).numpy(),
            np.asarray(jmatching.pair_bottleneck(tj, ra, rb)))

    def test_enumerations_match_reference(self):
        for m in range(1, 5):
            np.testing.assert_array_equal(pairing.enumerate_matchings(m),
                                          jpairing.enumerate_matchings(m))
        assert pairing.ENUM_MAX_PAIRS == jpairing.ENUM_MAX_PAIRS
        for n, c in [(8, 4), (8, 3), (6, 1), (5, 5), (7, 2)]:
            np.testing.assert_array_equal(plan.enumerate_subsets(n, c),
                                          jplan.enumerate_subsets(n, c))
        assert plan.JOINT_ENUM_MAX_N == jplan.JOINT_ENUM_MAX_N
        assert plan.JOINT_SWAP_ITERS == jplan.JOINT_SWAP_ITERS
