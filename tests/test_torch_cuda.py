"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. This file imports no jax, so it
runs on a GPU host without the reference package's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import FLConfig, NOMAConfig
from repro_torch.core.engine import WirelessEngine
from repro_torch.fl.aggregate import aggregate_deltas
from repro_torch.kernels import backend, fedagg, pairscore

KW = dict(n0b=1e-14, pmax=0.2, bw=1e6)
PAIR_TOL = dict(rtol=1e-6, atol=1e-9)


def gains(m, seed, *, shape):
    rng = np.random.default_rng(seed)
    g_i = rng.uniform(1e-16, 1e-9, m).astype(np.float32)
    g_j = np.minimum(g_i, rng.uniform(1e-16, 1e-9, m)).astype(np.float32)
    return g_i.reshape(shape), g_j.reshape(shape)


def updates(c, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n)).astype(np.float32),
            rng.uniform(0.0, 1.0, c).astype(np.float32))


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
class TestOnCard:
    """The CUDA kernels against their plain versions on the card."""

    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("shape", [(1, 5), (256, 128), (1,), (7,),
                                       (1025,)])
    def test_pairscore(self, shape, oma):
        dev = cuda_device()
        g_i, g_j = gains(int(np.prod(shape)), 1, shape=shape)
        gi, gj = torch.from_numpy(g_i).to(dev), torch.from_numpy(g_j).to(dev)
        out = pairscore.pairscore(gi, gj, oma=oma, **KW)
        ref = pairscore.pair_math(gi, gj, oma=oma, **KW)
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, **PAIR_TOL)

    # both sides accumulate in fp32 from the same bf16 inputs, so bf16
    # takes a tolerance that a kernel accumulating in bf16 would miss
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                           (torch.bfloat16, 1e-5)])
    @pytest.mark.parametrize("c,n", [(1, 512), (4, 2048), (10, 70_001)])
    def test_fedagg(self, dtype, tol, c, n):
        dev = cuda_device()
        u, w = updates(c, n, 5)
        ut = torch.from_numpy(u).to(dev, dtype)
        wt = torch.from_numpy(w).to(dev)
        torch.testing.assert_close(fedagg.fedagg(ut, wt),
                                   fedagg.fedagg_plain(ut, wt), rtol=tol,
                                   atol=tol)

    def test_probe(self):
        dev = cuda_device()
        backend.probe(dev)
        x = torch.randn(8, 128, device=dev)
        assert torch.equal(backend.probe_kernel(x), x + 1.0)

    def test_fedagg_row_slice_and_launch_count(self):
        dev = cuda_device()
        u, w = updates(3, 1032, 9)
        ut = torch.from_numpy(u).to(dev)[:, :1027]      # aligned rows, tail
        wt = torch.from_numpy(w).to(dev)
        before = fedagg.fedagg.launches
        torch.testing.assert_close(fedagg.fedagg(ut, wt),
                                   fedagg.fedagg_plain(ut, wt), rtol=1e-6,
                                   atol=1e-6)
        assert fedagg.fedagg.launches == before + 1

    def test_engine_and_aggregation_launch_the_kernels(self):
        """On a CUDA device the engine scores pairs with the pairscore
        kernel and aggregation sums with the fedagg kernel."""
        dev = cuda_device()
        rng = np.random.default_rng(3)
        n = 40
        g = rng.uniform(1e-14, 1e-9, (2, n))
        ones = np.ones((2, n))
        eng = WirelessEngine(NOMAConfig(), FLConfig(), device=dev)
        before = pairscore.pairscore.launches
        out = eng.schedule_batch(g, 100 * ones, 1e9 * ones, ones, 1e6)
        assert pairscore.pairscore.launches == before + 1
        assert bool((out.selected.sum(1) == 10).all())
        u, w = updates(4, 1000, 2)
        before = fedagg.fedagg.launches
        agg = aggregate_deltas(torch.from_numpy(u).to(dev), w)
        assert fedagg.fedagg.launches == before + 1
        torch.testing.assert_close(
            agg.cpu(), torch.from_numpy(np.einsum("cn,c->n", u, w / w.sum())),
            rtol=1e-5, atol=1e-6)
