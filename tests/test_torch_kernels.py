"""Port kernels (src/repro_torch/kernels) against the reference.

On the CPU every wrapper takes its plain PyTorch version; those are held
against the reference package's XLA twins and its Pallas kernels in
interpret mode, on the same numpy inputs. The CUDA kernels themselves run
only on a card: tests/test_torch_cuda.py holds them.
"""
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import pairscore as jpair
from repro_torch.kernels import backend, build, fedagg, ops, pairscore

REPO = Path(__file__).resolve().parents[1]
KW = dict(n0b=1e-14, pmax=0.2, bw=1e6)
PAIR_TOL = dict(rtol=1e-6, atol=1e-9)


def gains(m, seed, *, shape=None):
    rng = np.random.default_rng(seed)
    g_i = rng.uniform(1e-16, 1e-9, m).astype(np.float32)
    g_j = np.minimum(g_i, rng.uniform(1e-16, 1e-9, m)).astype(np.float32)
    if shape is not None:
        g_i, g_j = g_i.reshape(shape), g_j.reshape(shape)
    return g_i, g_j


def c_params(name):
    """Parameters of ``extern "C" int name(...)`` in csrc/*.cu, as text."""
    found = [m for src in build.sources() for m in re.finditer(
        r'extern "C" int ' + name + r"\(([^)]*)\)", src.read_text())]
    assert len(found) == 1, f"{name}: {len(found)} definitions"
    return [p.strip() for p in found[0][1].split(",")]


def updates(c, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n)).astype(np.float32),
            rng.uniform(0.0, 1.0, c).astype(np.float32))


def bf16_pair(x):
    """The same bf16 values as a jax array and a torch tensor."""
    xj = jnp.asarray(x, jnp.bfloat16)
    bits = np.asarray(xj).view(np.uint16)
    return xj, torch.from_numpy(bits.copy()).view(torch.bfloat16)


class TestPairScore:
    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("m", [1, 7, 300, 1025])
    def test_plain_matches_xla_twin(self, m, oma):
        g_i, g_j = gains(m, m)
        ref = jpair.pair_alloc_rates(g_i, g_j, oma=oma, impl="xla", **KW)
        out = pairscore.pairscore(torch.from_numpy(g_i),
                                  torch.from_numpy(g_j), oma=oma, **KW)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **PAIR_TOL)

    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("m", [1, 7, 300, 1025])
    def test_plain_matches_pallas_interpret(self, m, oma):
        g_i, g_j = gains(m, 100 + m)
        ref = jpair.pairscore_pallas(jnp.asarray(g_i), jnp.asarray(g_j),
                                     oma=oma, interpret=True, **KW)
        out = pairscore.pair_math(torch.from_numpy(g_i),
                                  torch.from_numpy(g_j), oma=oma, **KW)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **PAIR_TOL)

    def test_batched_shape_and_solo_rate(self):
        g_i, g_j = gains(8 * 5, 3, shape=(8, 5))
        out = pairscore.pairscore(torch.from_numpy(g_i),
                                  torch.from_numpy(g_j), **KW)
        ref = jpair.pair_alloc_rates(g_i, g_j, impl="xla", **KW)
        for o, r in zip(out, ref):
            assert o.shape == (8, 5)
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **PAIR_TOL)
        solo = pairscore.solo_rate_math(torch.from_numpy(g_i), **KW)
        np.testing.assert_allclose(
            solo.numpy(), np.asarray(jpair.solo_rate_math(g_i, **KW)),
            **PAIR_TOL)

    def test_cpu_wrapper_does_not_count_a_launch(self):
        before = pairscore.pairscore.launches
        g_i, g_j = gains(5, 0)
        pairscore.pairscore(torch.from_numpy(g_i), torch.from_numpy(g_j),
                            **KW)
        assert pairscore.pairscore.launches == before

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            pairscore.pairscore(torch.zeros(3), torch.zeros(4), **KW)


class TestFedAgg:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("c,n", [(1, 512), (4, 2048), (10, 70_000)])
    def test_plain_matches_pallas_interpret(self, dtype, c, n):
        u, w = updates(c, n, c * n)
        if dtype == "float32":
            uj, ut = jnp.asarray(u), torch.from_numpy(u)
            tol = 1e-6
        else:
            uj, ut = bf16_pair(u)
            tol = 2e-2
        ref = jops.weighted_sum(uj, jnp.asarray(w), impl="interpret")
        out = ops.weighted_sum(ut, torch.from_numpy(w))
        assert out.dtype == torch.float32 and out.shape == (n,)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                                   atol=tol)

    def test_wrapper_on_cpu_is_the_plain_version(self):
        u, w = updates(3, 1001, 7)
        ut, wt = torch.from_numpy(u), torch.from_numpy(w)
        before = fedagg.fedagg.launches
        np.testing.assert_array_equal(fedagg.fedagg(ut, wt).numpy(),
                                      fedagg.fedagg_plain(ut, wt).numpy())
        assert fedagg.fedagg.launches == before

    def test_multi_dim_updates(self):
        u, w = updates(3, 17 * 33, 2)
        out = ops.weighted_sum(torch.from_numpy(u).reshape(3, 17, 33),
                               torch.from_numpy(w))
        np.testing.assert_allclose(
            out.numpy(), np.einsum("cn,c->n", u, w).reshape(17, 33),
            rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("bad", [(0, 4), (2, 4, 1)])
    def test_bad_shapes_raise(self, bad):
        with pytest.raises(ValueError):
            fedagg.fedagg(torch.zeros(bad[:2]), torch.zeros(bad[-1]))


class TestBackend:
    def test_auto_on_cpu_is_plain(self):
        assert backend.resolve_backend("auto", "cpu").type == "cpu"
        assert backend.resolve_backend("torch", "cpu").type == "cpu"

    def test_cuda_on_cpu_raises(self):
        with pytest.raises(RuntimeError):
            backend.resolve_backend("cuda", "cpu")

    @pytest.mark.parametrize("bad", ["xla", "pallas", "triton", ""])
    def test_unknown_backend_raises(self, bad):
        with pytest.raises(ValueError):
            backend.resolve_backend(bad, "cpu")

    @pytest.mark.parametrize("device", ["cuda", "cuda:0"])
    def test_torch_on_cuda_raises(self, device):
        """The plain versions never run on the card: asking for them on a
        CUDA device raises, with or without a card present."""
        with pytest.raises(RuntimeError, match="only on the CPU"):
            backend.resolve_backend("torch", device)

    def test_probe_plain_on_cpu(self):
        x = torch.zeros(8, 128)
        assert torch.equal(backend.probe_kernel(x), x + 1.0)


class TestBuild:
    def test_import_needs_no_nvcc(self, tmp_path):
        code = ("import repro_torch.kernels, repro_torch.kernels.ops, "
                "repro_torch.core.engine, repro_torch.fl; "
                "from repro_torch.kernels import build; "
                "assert build.load.cache_info().currsize == 0")
        env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       cwd=REPO / "src")

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(build, "DEFAULT_CUDA_ROOTS", ())
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()

    def test_sources_and_flags(self):
        assert {s.name for s in build.sources()} == {
            "fedagg.cu", "pairscore.cu", "planner.cu", "probe.cu", "swa.cu",
            "swa_bwd.cu", "wkv6.cu", "wkv6_bwd.cu"}
        assert "--use_fast_math" not in build.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

    @pytest.mark.parametrize("name", sorted(build.SIGNATURES))
    def test_ctypes_signature_matches_source(self, name):
        """``build.SIGNATURES[name]`` has the parameters, in number and kind
        (pointer, int64_t, int, float), of ``extern "C" int name(...)`` in
        csrc: a mismatch would show only as a crash on the card."""
        params = c_params(name)
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int64
                 if "int64_t" in p else ctypes.c_float if "float" in p
                 else ctypes.c_int for p in params]
        assert len(params) == len(build.SIGNATURES[name]), params
        assert kinds == list(build.SIGNATURES[name]), params

    def test_planner_consts_match_the_struct(self):
        """``planner.PlannerConsts`` lays out ``struct PlannerConsts`` of
        csrc/planner.cu: the same float fields in the same order."""
        from repro_torch.kernels import planner
        src = (build.CSRC / "planner.cu").read_text()
        body = re.search(r"struct PlannerConsts \{(.*?)\};", src, re.S)[1]
        fields = [f.strip() for f in body.replace("float", "").replace(
            ";", ",").split(",") if f.strip()]
        assert body.split()[0] == "float" and body.count("float") == 1
        assert fields == [f for f, _ in planner.PlannerConsts._fields_]
        assert all(t is ctypes.c_float
                   for _, t in planner.PlannerConsts._fields_)
