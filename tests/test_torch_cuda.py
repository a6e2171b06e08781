"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. This file imports no jax, so it
runs on a GPU host without the reference package's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import FLConfig, NOMAConfig
from repro_torch.core.engine import WirelessEngine
from repro_torch.fl.aggregate import aggregate_deltas
from repro_torch.configs import get_config
from repro_torch.kernels import backend, fedagg, pairscore, planner, swa, wkv6
from repro_torch.launch.serve import run_serve
from repro_torch.models import zoo

KW = dict(n0b=1e-14, pmax=0.2, bw=1e6)
PAIR_TOL = dict(rtol=1e-6, atol=1e-9)
BF16_ULP = 2.0 ** -7


def gains(m, seed, *, shape):
    rng = np.random.default_rng(seed)
    g_i = rng.uniform(1e-16, 1e-9, m).astype(np.float32)
    g_j = np.minimum(g_i, rng.uniform(1e-16, 1e-9, m)).astype(np.float32)
    return g_i.reshape(shape), g_j.reshape(shape)


def updates(c, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n)).astype(np.float32),
            rng.uniform(0.0, 1.0, c).astype(np.float32))


def planner_inputs(b, c, seed, dev):
    rng = np.random.default_rng(seed)
    g = np.sort(rng.uniform(1e-14, 1e-9, (b, c)), axis=1)[:, ::-1].copy()
    t = rng.uniform(0.05, 0.5, (b, c))
    to = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    return to(g), to(t), to(np.full(b, 4e6))


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

    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("b,c", [(1, 10), (32, 10), (64, 32), (64, 256),
                                     (4, 1030), (1, 16385), (3, 1), (3, 2),
                                     (3, 3), (3, 7), (3, 129)])
    def test_planner(self, b, c, oma):
        """The bf16 table within one bf16 ulp; row_min and t_sw, reduced
        from fp32, to rtol 1e-6; a second call bitwise equal. (64, 32) is
        the policy batch's shape; (4, 1030) runs ``planner_rows`` with c
        not a multiple of 32 and a last CTA of fewer rows; (1, 16385) its
        unstaged route, past 128 KB of staged g and t, at an odd c."""
        dev = cuda_device()
        g, t, mb = planner_inputs(b, c, b + c, dev)
        before = planner.planner_tables.launches
        out = planner.planner_tables(g, t, mb, oma=oma, **KW)
        assert planner.planner_tables.launches == before + 1
        again = planner.planner_tables(g, t, mb, oma=oma, **KW)
        ref = planner.planner_tables_plain(g, t, mb, oma=oma, **KW)
        torch.cuda.synchronize()
        assert out[0].dtype == torch.bfloat16
        torch.testing.assert_close(out[0].float(), ref[0].float(),
                                   rtol=BF16_ULP, atol=0.0)
        torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(out[2], ref[2], rtol=1e-6, atol=0.0)
        for x, y in zip(out, again):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))

    @pytest.mark.parametrize("oma", [False, True])
    @pytest.mark.parametrize("b,c", [(1, 10), (64, 256)])
    def test_planner_one_kernel_a_call(self, b, c, oma):
        """A call is one device kernel (no second t_sw pass), as
        ``torch.profiler`` counts the kernels of five calls."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        dev = cuda_device()
        g, t, mb = planner_inputs(b, c, 3, dev)
        planner.planner_tables(g, t, mb, oma=oma, **KW)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                planner.planner_tables(g, t, mb, oma=oma, **KW)
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        assert sum(kernels.values()) == 5, kernels
        assert all("planner" in k for k in kernels), kernels

    def test_planner_strided_rows_and_scalar_bits(self):
        """The engine's (B, c_pair) slice of (B, c) rows goes in without a
        copy, and S as one number (a stride-0 view) equals S as a row
        tensor bit for bit."""
        dev = cuda_device()
        g, t, mb = planner_inputs(8, 33, 4, dev)
        gs, ts = g[:, :32], t[:, :32]
        out = planner.planner_tables(gs, ts, 4e6, **KW)
        ref = planner.planner_tables(gs.contiguous(), ts.contiguous(), mb,
                                     **KW)
        for x, y in zip(out, ref):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))

    def test_hungarian_and_montecarlo_launch_the_planner(self):
        """The engine's hungarian finish takes its table from the planner
        kernel (one launch per finish), so does every round of the
        Monte-Carlo rollout, and the card agrees with the CPU."""
        dev = cuda_device()
        rng = np.random.default_rng(5)
        n = 40
        g = rng.uniform(1e-14, 1e-9, (2, n))
        ns, cpu = rng.uniform(100, 1000, (2, n)), rng.uniform(5e8, 2e9, (2, n))
        ages = rng.integers(1, 30, (2, n)).astype(float)
        card = WirelessEngine(NOMAConfig(), FLConfig(), device=dev,
                              pairing="hungarian")
        before = planner.planner_tables.launches
        out = card.schedule_batch(g, ns, cpu, ages, 1e6)
        assert planner.planner_tables.launches == before + 1
        ref = WirelessEngine(NOMAConfig(), FLConfig(), device="cpu",
                             pairing="hungarian").schedule_batch(
            g, ns, cpu, ages, 1e6)
        assert torch.equal(out.selected.cpu(), ref.selected)
        torch.testing.assert_close(out.t_round.cpu(), ref.t_round,
                                   rtol=1e-2, atol=0.0)
        gains = rng.uniform(1e-14, 1e-9, (4, 3, n))
        before = planner.planner_tables.launches
        mc = card.montecarlo_rounds(gains, ns[:1].repeat(3, 0),
                                    cpu[:1].repeat(3, 0), 1e6)
        assert planner.planner_tables.launches == before + 4
        assert bool((mc["n_selected"] == 10).all())


def bf16_ulp(x) -> float:
    """One bf16 ulp at max|x|."""
    m = float(x.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7)


# Per-row tolerance of swa, in bf16 ulps of the row's max|ref|. The bf16
# kernel rounds P to bf16 before P V (2^-9 relative per weight); a row with
# few keys does not average that out, and where its values cancel it can
# move the output by more than half an ulp before the output's own
# rounding.
ROW_ULPS = {torch.bfloat16: 2.0, torch.float32: 1.0}


def row_ulps(out, ref):
    """Per (b, query, head) row: max |out - ref| in bf16 ulps of the row's
    max|ref|, (B, S, H)."""
    err = (out.float() - ref.float()).abs().amax(-1)
    peak = ref.float().abs().amax(-1).clamp_min(2.0 ** -126)
    return err / torch.exp2(torch.floor(torch.log2(peak)) - 7)


def assert_swa_close(out, ref):
    """Globally within one bf16 ulp of max|ref|, and every row within
    ROW_ULPS bf16 ulps of its own max|ref|: a late row with |out| ~ 0.05
    wrong by 30 % would pass the global check alone."""
    err = float((out.float() - ref.float()).abs().max())
    assert err <= bf16_ulp(ref)
    rows = row_ulps(out, ref)
    bad = rows > ROW_ULPS[out.dtype]
    assert not bool(bad.any()), (
        f"{int(bad.sum())} rows above {ROW_ULPS[out.dtype]} bf16 ulps of "
        f"their max|ref|, worst {float(rows.max())}")


def seeded(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev)


@pytest.mark.cuda
class TestServingKernels:
    """swa and wkv6 against their plain versions on the card, and the
    serving path of the hybrid and ssm families through them."""

    @pytest.mark.parametrize("b,s,h,kh,hd,w,cap", [
        (2, 4096, 25, 5, 64, 2048, 0.0),     # hymba's prefill
        (1, 700, 25, 5, 64, 2048, 0.0),      # S < W
        (2, 1000, 6, 3, 64, 300, 0.0),       # S, W off the block
        (1, 129, 4, 2, 64, 1, 0.0),          # W = 1
        (1, 500, 4, 4, 64, 100, 0.0),        # g = 1
        (1, 600, 8, 2, 64, 200, 5.0),        # softcap
        (2, 300, 4, 1, 16, 256, 0.0),        # reduced hymba
        # head_dim 128: moonshot (g = 1), chatglm3 (32:2), grok with its
        # softcap 30, and S, W off the tiles
        (1, 4096, 16, 16, 128, 2048, 0.0),
        (1, 2048, 32, 2, 128, 1024, 0.0),
        (1, 4096, 48, 8, 128, 2048, 30.0),
        (2, 1000, 6, 3, 128, 300, 0.0),
        (1, 129, 4, 2, 128, 1, 0.0),
    ])
    def test_swa(self, b, s, h, kh, hd, w, cap):
        """bf16 output from fp32 accumulation on both sides: max abs err
        within one bf16 ulp of max|out|, and every row within two bf16
        ulps of its own max (the kernel rounds P to bf16)."""
        self._check_swa(b, s, h, kh, hd, w, cap, torch.bfloat16)

    @pytest.mark.parametrize("b,s,h,kh,hd,w,cap", [
        (2, 4096, 25, 5, 64, 2048, 0.0),
        (2, 1000, 6, 3, 64, 300, 0.0),
        (1, 600, 8, 2, 64, 200, 5.0),
        (2, 300, 4, 1, 16, 256, 0.0),
        (1, 2048, 32, 2, 128, 1024, 0.0),
        (1, 4096, 48, 8, 128, 2048, 30.0),
        (2, 1000, 6, 3, 128, 300, 0.0),
    ])
    def test_swa_fp32(self, b, s, h, kh, hd, w, cap):
        """The fp32 kernel (CUDA cores) under the same two checks."""
        self._check_swa(b, s, h, kh, hd, w, cap, torch.float32)

    @pytest.mark.parametrize("hd", [64, 128, 256])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("w", [63, 64, 65, 128, 4096])
    @pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129])
    def test_swa_tile_edges(self, s, w, dtype, hd):
        """S and W on, one below and one past the 64-key tile and the
        128-query block."""
        self._check_swa(2, s, 6, 2, hd, w, 0.0, dtype)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("b,s,h,kh,hd,w,prefix,cap", [
        # head_dim 256: paligemma's 8:1 with its 256-token prefix at a
        # quarter of its windowed prefill, 4:4, every prefix against W
        (1, 4096, 8, 1, 256, 2048, 256, 0.0),
        (2, 1000, 4, 4, 256, 300, 0, 0.0),
        (2, 1000, 8, 1, 256, 300, 1, 0.0),
        (2, 1000, 8, 1, 256, 300, 100, 0.0),
        (1, 700, 8, 1, 256, 300, 256, 0.0),
        (1, 700, 8, 1, 256, 300, 500, 0.0),       # prefix > W
        (1, 700, 8, 1, 256, 300, 256, 30.0),      # softcap
        (2, 129, 4, 2, 256, 65, 70, 0.0),         # S, W, P off the tiles
        (1, 200, 8, 1, 256, 64, 300, 0.0),        # prefix > S
        # the other head dims with a prefix
        (2, 300, 4, 1, 16, 256, 8, 0.0),
        (2, 1000, 6, 3, 64, 300, 100, 0.0),
        (2, 1000, 16, 16, 64, 300, 0, 0.0),       # seamless's 16:16
        (2, 1000, 6, 3, 128, 300, 100, 30.0),
    ])
    def test_swa_prefix(self, b, s, h, kh, hd, w, prefix, cap, dtype):
        """The prefix-LM band (keys j < prefix seen by every query within
        the window), under the two checks of ``test_swa``."""
        self._check_swa(b, s, h, kh, hd, w, cap, dtype, prefix)

    def test_swa_refuses_what_the_kernel_does_not_take(self):
        """On the card a head_dim or prefix the kernel does not take
        raises; nothing runs ``swa_plain`` instead."""
        dev = cuda_device()
        q = seeded((1, 64, 2, 32), 1, dev).bfloat16()
        with pytest.raises(ValueError, match="head_dim"):
            swa.swa(q, q[:, :, :1], q[:, :, :1], window=8)
        q = seeded((1, 64, 2, 256), 1, dev).bfloat16()
        with pytest.raises(ValueError, match="prefix"):
            swa.swa(q, q[:, :, :1], q[:, :, :1], window=8, prefix=-1)

    @staticmethod
    def _check_swa(b, s, h, kh, hd, w, cap, dtype, prefix=0):
        dev = cuda_device()
        q = seeded((b, s, h, hd), 1, dev).to(dtype) * (8.0 if cap else 1.0)
        k = seeded((b, s, kh, hd), 2, dev).to(dtype)
        v = seeded((b, s, kh, hd), 3, dev).to(dtype)
        before = swa.swa.launches
        out = swa.swa(q, k, v, window=w, softcap=cap, prefix=prefix)
        assert swa.swa.launches == before + 1
        ref = swa.swa_plain(q, k, v, window=w, softcap=cap, prefix=prefix)
        assert out.dtype == dtype
        assert_swa_close(out, ref)

    @pytest.mark.parametrize("b,h,t,c,chunk,clip,with_s0,dtype", [
        (1, 64, 4096, 64, 128, False, False, torch.bfloat16),
        (1, 64, 4096, 64, 128, True, True, torch.bfloat16),
        (2, 64, 77, 64, 128, False, True, torch.bfloat16),
        (1, 8, 1000, 64, 64, False, True, torch.bfloat16),
        (2, 8, 300, 16, 128, False, True, torch.float32),
        # the kernels' edges: one (b, h) whose chunks alone fill the card;
        # T around the 16-step sub-chunk and the 64-step chunk; T off the
        # caller's chunk; the clip with s0 in fp32 and at chunk 64
        (1, 1, 4096, 64, 128, False, True, torch.bfloat16),
        (2, 4, 1, 64, 128, False, True, torch.bfloat16),
        (2, 4, 15, 64, 128, False, True, torch.float32),
        (2, 4, 16, 16, 128, False, True, torch.bfloat16),
        (2, 4, 17, 64, 128, True, True, torch.bfloat16),
        (2, 4, 63, 16, 128, False, False, torch.float32),
        (2, 4, 65, 64, 128, False, True, torch.bfloat16),
        (1, 4, 200, 64, 48, False, True, torch.float32),
        (1, 4, 300, 64, 128, True, True, torch.float32),
        (1, 4, 1000, 64, 64, True, True, torch.bfloat16),
    ])
    def test_wkv6(self, b, h, t, c, chunk, clip, with_s0, dtype):
        """out and s_T in fp32: max abs err <= 1e-4 of the max magnitude."""
        dev = cuda_device()
        r, k, v = (seeded((b, h, t, c), i, dev).to(dtype) * 0.5
                   for i in range(3))
        wt = (torch.full((b, h, t, c), 4.0, device=dev) if clip
              else seeded((b, h, t, c), 4, dev) - 1.0)
        w_log = -torch.exp(torch.clamp(wt, -8.0, 4.0))
        u = seeded((h, c), 5, dev) * 0.5
        s0 = seeded((b, h, c, c), 6, dev) * 0.1 if with_s0 else None
        before = wkv6.wkv6.launches
        out, s_t = wkv6.wkv6(r, k, v, w_log, u, s0, chunk=chunk)
        assert wkv6.wkv6.launches == before + 1
        ref, ref_s = wkv6.wkv6_plain(r, k, v, w_log, u, s0, chunk=chunk)
        for got, want in ((out, ref), (s_t, ref_s)):
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max())

    def test_wkv6_refuses_a_scratch_of_another_chunk(self, monkeypatch):
        """The C entry takes the scratch's chunk count and refuses it unless
        it is ceil(T / L) of the kernels' own L."""
        dev = cuda_device()
        args = (seeded((1, 2, 100, 16), 1, dev), seeded((1, 2, 100, 16), 2,
                                                        dev),
                seeded((1, 2, 100, 16), 3, dev),
                -torch.ones(1, 2, 100, 16, device=dev),
                torch.zeros(2, 16, device=dev))
        monkeypatch.setattr(wkv6, "KERNEL_CHUNK", wkv6.KERNEL_CHUNK // 2)
        with pytest.raises(RuntimeError, match="wkv6: CUDA error"):
            wkv6.wkv6(*args, chunk=64)

    @pytest.mark.parametrize("arch,kernel,windowed", [
        ("hymba_1_5b", "swa", False), ("rwkv6_7b", "wkv6", False),
        ("moonshot_v1_16b_a3b", "swa", True), ("chatglm3_6b", "swa", True),
        ("grok_1_314b", "swa", True)])
    def test_prefill_launches_its_kernel_once_per_layer(self, arch, kernel,
                                                        windowed):
        """The hybrid prefill always takes the window; the others with
        ``make_prefill_step(window=cfg.long_context_window)`` (256 in the
        reduced configs, below the 300-token prompt)."""
        dev = cuda_device()
        cfg = get_config(arch).reduced()
        model = zoo.init_model(cfg, seed=0, device=dev)
        fn = {"swa": swa.swa, "wkv6": wkv6.wkv6}[kernel]
        before = fn.launches
        toks = torch.randint(0, cfg.vocab_size, (2, 300), device=dev)
        window = cfg.long_context_window if windowed else 0
        last, _ = zoo.make_prefill_step(cfg, window=window)(
            model, {"tokens": toks})
        assert fn.launches == before + cfg.n_layers
        assert bool(torch.isfinite(last).all())

    # (B, S, H, KH, hd, window, prefix, softcap): hd 16, 64, 128, 256; GQA
    # 1:1, 5:1, 8:1 at every head dim (bf16: with and without the group-sum
    # launch); W < S and W >= S; prefix 0 and > 0 (crossing the 64-row
    # tile); softcap 0 and 30; S off the 64-row tile (32 at fp32's hd 256)
    SWA_GRAD = [(2, 100, 4, 4, 16, 30, 0, 0.0),
                (1, 150, 8, 1, 16, 40, 70, 30.0),
                (1, 300, 5, 1, 64, 70, 20, 30.0),
                (2, 129, 10, 2, 64, 1000, 0, 0.0),
                (1, 140, 8, 1, 64, 64, 70, 30.0),
                (1, 200, 8, 1, 128, 64, 0, 30.0),
                (1, 170, 8, 8, 128, 45, 70, 0.0),
                (1, 130, 8, 1, 256, 50, 70, 0.0),
                (1, 97, 8, 8, 256, 33, 40, 30.0)]
    # bf16 gradients: two bf16 ulps of max|g|. The wgmma kernels round P
    # and dS to bf16 for the tensor cores and take D = dO . O from the
    # forward's bf16 output; an fp32 emulation of that rounding lands up to
    # 1.70 ulps from autograd through swa_plain (1.08 with D from an fp32
    # O: P and dS alone pass one ulp)
    SWA_BWD_ULPS = 2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,s,h,kh,hd,w,prefix,cap", SWA_GRAD)
    def test_swa_gradient_matches_the_plain_version(self, b, s, h, kh, hd, w,
                                                    prefix, cap, dtype):
        """Autograd through ``swa`` (the forward kernel, then ``swa_bwd``'s:
        the wgmma kernels with the forward's output and lse for bf16, the
        CUDA-core ones for fp32) against autograd through ``swa_plain`` in
        fp32 on the same values: dq, dk, dv in q's dtype, each within 1e-4
        of its max|g| (fp32) or ``SWA_BWD_ULPS`` bf16 ulps of it (bf16),
        and at least 1e-6 of max(1, max|dq, dk, dv|); the backward
        launched once, the forward once."""
        dev = cuda_device()
        q = seeded((b, s, h, hd), 1, dev) * (8.0 if cap else 1.0)
        k, v = seeded((b, s, kh, hd), 2, dev), seeded((b, s, kh, hd), 3, dev)
        dout = seeded((b, s, h, hd), 4, dev)
        band = dict(window=w, softcap=cap, prefix=prefix)
        t = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        before = (swa.swa.launches, swa.swa_bwd.launches)
        got = torch.autograd.grad(swa.swa(*t, **band), t, dout.to(dtype))
        assert (swa.swa.launches, swa.swa_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        r = [x.detach().float().requires_grad_() for x in t]
        want = torch.autograd.grad(swa.swa_plain(*r, **band), r,
                                   dout.to(dtype).float())
        scale = max(1.0, *(float(x.abs().max()) for x in want))
        for g, x in zip(got, want):
            assert g.dtype == dtype
            peak = float(x.abs().max())
            tol = (1e-4 * peak if dtype == torch.float32
                   else self.SWA_BWD_ULPS
                   * 2.0 ** (math.floor(math.log2(peak)) - 7))
            assert float((g.float() - x).abs().max()) <= max(tol,
                                                             1e-6 * scale)

    @pytest.mark.parametrize("b,s,h,kh,hd,w,prefix,cap", SWA_GRAD)
    def test_swa_forward_lse(self, b, s, h, kh, hd, w, prefix, cap):
        """The bf16 forward under autograd writes each row's lse: within
        1e-5 of max|lse| of ``swa_lse_plain``; its output equals the
        serving path's (lse pointer null) bit for bit."""
        dev = cuda_device()
        q = seeded((b, s, h, hd), 1, dev).bfloat16() * (8.0 if cap else 1.0)
        k, v = (seeded((b, s, kh, hd), i, dev).bfloat16() for i in (2, 3))
        out, lse = swa._forward(q, k, v, w, cap, prefix, with_lse=True)
        assert lse.shape == (b, h, s) and lse.dtype == torch.float32
        assert torch.equal(out, swa._forward(q, k, v, w, cap, prefix))
        want = swa.swa_lse_plain(q.float(), k.float(), v.float(), window=w,
                                 softcap=cap, prefix=prefix)
        assert float((lse - want).abs().max()) <= 1e-5 * float(
            want.abs().max())

    def test_swa_bwd_bf16_takes_the_forwards_out_and_lse(self):
        """On bf16 CUDA tensors ``swa_bwd`` reads the forward's output and
        lse and refuses a call without them; fp32 recomputes and refuses
        them."""
        dev = cuda_device()
        q = seeded((1, 70, 4, 64), 1, dev)
        k, v = (seeded((1, 70, 2, 64), i, dev) for i in (2, 3))
        dout = seeded((1, 70, 4, 64), 4, dev)
        bf = [x.bfloat16() for x in (q, k, v, dout)]
        out, lse = swa._forward(*bf[:3], 32, 0.0, 0, with_lse=True)
        with pytest.raises(ValueError):
            swa.swa_bwd(*bf, window=32)
        with pytest.raises(ValueError):
            swa.swa_bwd(*bf, window=32, out=out)
        with pytest.raises(ValueError):
            swa.swa_bwd(q, k, v, dout, window=32, out=out.float(), lse=lse)
        assert all(g.dtype == torch.bfloat16 for g in swa.swa_bwd(
            *bf, window=32, out=out, lse=lse))

    # (B, H, T, C, clip, s0)
    WKV6_GRAD = [(1, 2, 1, 16, False, True), (2, 3, 77, 16, False, False),
                 (1, 4, 200, 64, False, True), (1, 4, 130, 64, True, True),
                 (2, 8, 64, 64, False, True)]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,h,t,c,clip,with_s0", WKV6_GRAD)
    def test_wkv6_gradient_matches_the_plain_version(self, b, h, t, c, clip,
                                                     with_s0, dtype):
        """Autograd through ``wkv6`` (the forward kernels, then
        ``wkv6_bwd``'s) with cotangents on out and s_T against autograd
        through ``wkv6_plain`` in fp32: dr, dk, dv in r's dtype within 1e-4
        of max|g| (one bf16 ulp in bf16), dw_log, du, ds0 within 1e-4; with
        every w_log at the +4 clip, 2^-11 of max|g| (the plain chunked
        form's one-ulp frame of lp) and dw_log, whose exact value is
        ~e^{-e^4}, within 1e-6 of max(1, max|dr, dk, dv|)
        (tests/test_torch_wkv6_grad.py)."""
        dev = cuda_device()
        rng = np.random.default_rng(t + c)
        f = np.float32
        r, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, c))
                                    .astype(f) * 0.5).to(dev)
                   for _ in range(3))
        wt = (np.full((b, h, t, c), 4.0, f) if clip
              else rng.standard_normal((b, h, t, c)).astype(f))
        w_log = torch.from_numpy(-np.exp(np.clip(wt, -8.0, 4.0))).to(dev)
        u = torch.from_numpy(rng.standard_normal((h, c)).astype(f)).to(dev)
        s0 = (torch.from_numpy(rng.standard_normal((b, h, c, c)).astype(f)
                               * 0.1).to(dev) if with_s0 else None)
        dout, ds_t = seeded((b, h, t, c), 5, dev), seeded((b, h, c, c), 6,
                                                          dev)
        args = [r.to(dtype), k.to(dtype), v.to(dtype), w_log, u, s0]
        leaves = [x.requires_grad_() for x in args if x is not None]
        before = (wkv6.wkv6.launches, wkv6.wkv6_bwd.launches)
        got = torch.autograd.grad(wkv6.wkv6(*args), leaves, (dout, ds_t))
        assert (wkv6.wkv6.launches, wkv6.wkv6_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        ref = [x.detach().float().requires_grad_() for x in leaves]
        full = ref + [None] * (6 - len(ref))
        want = torch.autograd.grad(wkv6.wkv6_plain(*full, chunk=128), ref,
                                   (dout, ds_t))
        scale = max(1.0, *(float(x.abs().max()) for x in want[:3]))
        for i, (g, x) in enumerate(zip(got, want)):
            assert g.dtype == leaves[i].dtype
            peak = float(x.abs().max())
            if clip and i == 3:
                tol = 1e-6 * scale
            elif dtype == torch.bfloat16 and i < 3:
                tol = 2.0 ** (math.floor(math.log2(peak)) - 7)
            else:
                tol = (2.0 ** -11 if clip else 1e-4) * peak
            assert float((g.float() - x).abs().max()) <= tol, i

    def test_two_backward_calls_are_bitwise_equal(self):
        """The backward kernels sum in a fixed order (no atomics): the
        same inputs give the same bits, at hymba's heads (swa_bwd's bf16
        and fp32 routes) and rwkv6's."""
        dev = cuda_device()
        q = seeded((1, 700, 25, 64), 1, dev).bfloat16()
        k, v = (seeded((1, 700, 5, 64), i, dev).bfloat16() for i in (2, 3))
        dout = seeded((1, 700, 25, 64), 4, dev).bfloat16()
        out, lse = swa._forward(q, k, v, 256, 0.0, 0, with_lse=True)
        first = swa.swa_bwd(q, k, v, dout, window=256, out=out, lse=lse)
        assert all(torch.equal(a, b) for a, b in zip(
            first, swa.swa_bwd(q, k, v, dout, window=256, out=out,
                               lse=lse)))
        first = swa.swa_bwd(*(x.float() for x in (q, k, v, dout)),
                            window=256)
        assert all(torch.equal(a, b) for a, b in zip(first, swa.swa_bwd(
            *(x.float() for x in (q, k, v, dout)), window=256)))
        r, kk, vv = (seeded((2, 8, 300, 64), i, dev).bfloat16()
                     for i in (5, 6, 7))
        w_log = -torch.exp(seeded((2, 8, 300, 64), 8, dev))
        u = seeded((8, 64), 9, dev)
        args = (r, kk, vv, w_log, u, None, seeded((2, 8, 300, 64), 10, dev),
                None)
        states = wkv6._forward(r, kk, vv, w_log, u, None, 64)[2]
        first = wkv6.wkv6_bwd(*args, states=states)
        assert all(torch.equal(a, b) for a, b in zip(
            first, wkv6.wkv6_bwd(*args, states=states)))

    @pytest.mark.parametrize("arch", ["hymba_1_5b", "rwkv6_7b",
                                      "moonshot_v1_16b_a3b", "chatglm3_6b",
                                      "paligemma_3b", "seamless_m4t_medium"])
    def test_run_serve_on_the_card_never_takes_the_plain_path(
            self, arch, monkeypatch):
        dev = cuda_device()

        def refuse(*args, **kwargs):
            raise AssertionError("a plain kernel version ran on the card")

        monkeypatch.setattr(swa, "swa_plain", refuse)
        monkeypatch.setattr(wkv6, "wkv6_plain", refuse)
        cfg = get_config(arch).reduced()
        res = run_serve(cfg, batch=2, prompt_len=300, gen=4, seed=0,
                        device=dev)
        assert res["tokens"].shape == (2, 4)
        assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)).all()


def budget_batch(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.exponential(size=(b, n)) * 1e-9,
            rng.uniform(100, 1000, (b, n)), rng.uniform(5e8, 2e9, (b, n)),
            rng.integers(1, 30, (b, n)).astype(float))


def assert_card_matches_cpu(out, ref, pairing):
    """Masks exact; pair tables exact except hungarian rows that share the
    bottleneck (fp32 rounding decides between tied matchings); rates and
    round times rtol 1e-5."""
    for f in ("selected", "evicted"):
        assert torch.equal(getattr(out, f).cpu(), getattr(ref, f)), f
    same = ((out.pair_strong.cpu() == ref.pair_strong)
            & (out.pair_weak.cpu() == ref.pair_weak)).all(1)
    if pairing != "hungarian":
        assert bool(same.all())
    torch.testing.assert_close(out.t_round.cpu(), ref.t_round, rtol=1e-5,
                               atol=0.0)
    torch.testing.assert_close(out.rates.cpu()[same], ref.rates[same],
                               rtol=1e-5, atol=0.0)


@pytest.mark.cuda
class TestBudgetAndCells:
    """The budget loop and the cell-partitioned planner on the card."""

    @pytest.mark.parametrize("pairing", ["strong_weak", "adjacent",
                                         "greedy_matching", "hungarian"])
    def test_budget_schedule(self, pairing):
        dev = cuda_device()
        batch = budget_batch(16, 64, 3)
        kw = dict(pairing=pairing)
        cpu = WirelessEngine(NOMAConfig(), FLConfig(), device="cpu", **kw)
        tb = (cpu.schedule_batch(*batch, 1e6).t_round * 0.5).numpy()
        ref = cpu.schedule_batch(*batch, 1e6, t_budget=tb)
        card = WirelessEngine(NOMAConfig(), FLConfig(), device=dev, **kw)
        before = pairscore.pairscore.launches
        out = card.schedule_batch(*batch, 1e6, t_budget=tb)
        assert_card_matches_cpu(out, ref, pairing)
        assert bool(ref.evicted.any())
        if pairing == "strong_weak":
            iters = int(out.evicted.sum(1).max())
            assert pairscore.pairscore.launches == before + 1 + iters

    def test_pairscore_on_padding_pairs(self):
        """Padding lanes of the multi-cell planner have gain 0: the kernel
        gives finite powers and rate 0 for them, as the plain math does."""
        dev = cuda_device()
        g = torch.tensor([1e-9, 0.0, 3e-12, 0.0], device=dev)
        gj = torch.tensor([0.0, 0.0, 0.0, 2e-12], device=dev)
        gi = torch.where(gj > g, gj, g)
        out = pairscore.pairscore(gi, gj, **KW)
        ref = pairscore.pair_math(gi, gj, **KW)
        for o, r in zip(out, ref):
            assert bool(torch.isfinite(o).all())
            torch.testing.assert_close(o, r, **PAIR_TOL)
        assert bool((out[3][gj == 0] == 0).all())
        assert bool((out[2][gi == 0] == 0).all())

    def test_budget_loop_never_takes_the_plain_path(self, monkeypatch):
        dev = cuda_device()

        def refuse(*args, **kwargs):
            raise AssertionError("the plain pair math ran on the card")

        monkeypatch.setattr(pairscore, "pair_math", refuse)
        batch = budget_batch(8, 40, 5)
        for pairing in ("strong_weak", "hungarian"):
            eng = WirelessEngine(NOMAConfig(), FLConfig(), device=dev,
                                 pairing=pairing)
            out = eng.schedule_batch(*batch, 1e6, t_budget=0.05)
            assert bool(out.evicted.any())
            mc = eng.montecarlo_rounds(np.stack([batch[0]] * 3), batch[1],
                                       batch[2], 1e6,
                                       policy="age_noma_budget",
                                       t_budget=0.05)
            assert bool((mc["n_evicted"] > 0).any())

    @pytest.mark.parametrize("budget", [0.0, 0.3])
    def test_multicell_schedule(self, budget):
        dev = cuda_device()
        batch = budget_batch(8, 120, 7)
        cell = np.random.default_rng(8).integers(0, 3, (8, 120))
        cell[:, :100] = np.minimum(cell[:, :100], 1)     # cell 2 underfull
        kw = dict(t_budget=budget, cell=cell, n_cells=3)
        ref = WirelessEngine(NOMAConfig(), FLConfig(),
                             device="cpu").schedule_batch(*batch, 1e6, **kw)
        out = WirelessEngine(NOMAConfig(), FLConfig(),
                             device=dev).schedule_batch(*batch, 1e6, **kw)
        assert_card_matches_cpu(out, ref, "strong_weak")
        assert bool(torch.isfinite(out.rates).all())


@pytest.mark.cuda
class TestScenarioSweeps:
    """The device scenario, the fused Monte-Carlo sweep, the seed split
    and a bf16 checkpoint on the card. The run ledgers go to a temporary
    directory (``--noconftest`` skips tests/conftest.py's REPRO_LEDGER=0)."""

    @pytest.fixture
    def dev(self, tmp_path, monkeypatch):
        d = cuda_device()
        monkeypatch.setenv("REPRO_RUNS_DIR", str(tmp_path / "runs"))
        return d

    @pytest.mark.parametrize("n_cells", [1, 3])
    @pytest.mark.parametrize("scenario", ["vehicular", "pedestrian",
                                          "iot_bursty"])
    def test_fused_equals_presampled(self, dev, scenario, n_cells):
        from repro_torch.configs.base import POLICIES
        from repro_torch.fl import run_montecarlo
        kw = dict(n_clients=32, n_seeds=8, rounds=4, model_bits=4e6,
                  seed=1, scenario=scenario, device=dev, policies=POLICIES)
        fl = FLConfig(n_cells=n_cells)
        fused = run_montecarlo(NOMAConfig(), fl, **kw)
        pre = run_montecarlo(NOMAConfig(), fl, presampled=True, **kw)
        for p in POLICIES:
            for k in fused[p]:
                np.testing.assert_array_equal(fused[p][k], pre[p][k],
                                              err_msg=f"{p}/{k}")
            assert fused["summary"][p] == pre["summary"][p]

    @pytest.mark.parametrize("policy", ["age_noma", "random",
                                        "age_noma_budget"])
    def test_one_card_shard(self, dev, policy):
        """``shard=True`` on one card runs as ``shard=False``; the split
        helper over [card, card] (two worker threads on one card) gives
        the same result too, bitwise."""
        from repro_torch.core import engine as E
        from repro_torch.sim import SCENARIOS, Scenario
        eng = WirelessEngine(NOMAConfig(), FLConfig(n_cells=3), device=dev)
        scn = Scenario(SCENARIOS["vehicular"], NOMAConfig(),
                       FLConfig(n_cells=3), device=dev)
        kw = dict(rounds=3, n_seeds=8, n_clients=64, model_bits=1e6,
                  policy=policy, seed=2,
                  t_budget=2.0 if policy == "age_noma_budget" else 0.0)
        whole = eng.montecarlo_scenario(scn, **kw)
        one = eng.montecarlo_scenario(scn, shard=True, **kw)
        orig = E.shard_devices
        E.shard_devices = lambda d: [dev, dev]
        try:
            two = eng.montecarlo_scenario(scn, shard=True, **kw)
        finally:
            E.shard_devices = orig
        for k in whole:
            assert torch.equal(whole[k], one[k]), k
            assert torch.equal(whole[k], two[k]), k

    def test_bf16_checkpoint_round_trip(self, dev, tmp_path):
        from repro_torch import checkpoint as ckpt
        from repro_torch.configs import get_config
        cfg = get_config("smollm_135m").reduced()
        model = zoo.init_model(cfg, seed=3, device=dev)
        state = {k: v.to(torch.bfloat16) for k, v in
                 model.state_dict().items()}
        ckpt.save(str(tmp_path / "ck"), state, step=5)
        like = {k: torch.zeros_like(v) for k, v in state.items()}
        back, manifest = ckpt.restore(str(tmp_path / "ck"), like)
        assert manifest["step"] == 5
        for k, v in state.items():
            assert back[k].device == v.device and back[k].dtype == v.dtype
            assert torch.equal(back[k], v), k


class _Template(torch.nn.Module):
    """Two parameters whose flat order differs from the reference's ravel
    order (``w`` then ``b`` here, ``b`` then ``w`` there)."""

    def __init__(self, device):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(300, 70, device=device))
        self.b = torch.nn.Parameter(torch.zeros(1001, device=device))


@pytest.mark.cuda
class TestPredictorOnCard:
    """The update predictor's fedagg blend and one observe / predict round,
    card against CPU."""

    @pytest.mark.parametrize("start", [0, 7])
    def test_fedagg_over_a_blend_row_slice(self, start):
        """(50, N) rows of a larger buffer, as the blend reads them: at
        row 0 (16-byte aligned) and at row 7 of an odd N (unaligned)."""
        dev = cuda_device()
        u, w = updates(64, 70_001, 9)
        rows = torch.from_numpy(u).to(dev)[start:start + 50]
        wt = torch.from_numpy(w[:50] / w[:50].sum()).to(dev)
        before = fedagg.fedagg.launches
        torch.testing.assert_close(fedagg.fedagg(rows, wt),
                                   fedagg.fedagg_plain(rows, wt), rtol=1e-6,
                                   atol=1e-6)
        assert fedagg.fedagg.launches == before + 1

    @pytest.mark.parametrize("mode", ["stale", "ann"])
    def test_observe_predict_round(self, mode):
        """Two observed rounds and a prediction: the same stats (rtol
        1e-4) and rows (atol 1e-5) on the card as on the CPU; the sketch
        and the MLP's initial weights do not depend on the device."""
        from repro_torch.fl.predictor import UpdatePredictor
        dev = cuda_device()
        fl = FLConfig(n_clients=6, predictor=mode)
        rng = np.random.default_rng(6)
        w = np.full(6, 1.0 / 6)
        preds = {d: UpdatePredictor(_Template(d), fl, 6, seed=1)
                 for d in ("cpu", dev)}
        n = preds["cpu"].n_params
        for clients, ages in (([0, 1, 2], np.ones(6, np.int64)),
                              ([1, 3], np.array([2, 1, 2, 1, 2, 2]))):
            rows = torch.from_numpy(
                rng.standard_normal((len(clients), n)).astype(np.float32))
            got = preds[dev].observe(clients, rows.to(dev), ages, w)
            want = preds["cpu"].observe(clients, rows, ages, w)
            for key, v in want.items():
                if np.isnan(v):
                    assert np.isnan(got[key]), key
                else:
                    np.testing.assert_allclose(got[key], v, rtol=1e-4,
                                               err_msg=key)
        assert np.isfinite(got["pred_error"])
        selected = np.zeros(6, bool)
        selected[[1, 3]] = True
        targets = preds["cpu"].predictable(selected, ages)
        np.testing.assert_array_equal(targets, [0, 2])
        mean = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        out = {d: torch.full((len(targets), n), float("nan"), device=d)
               for d in ("cpu", dev)}
        for d, p in preds.items():
            p.predict(targets, ages, w, mean.to(d), out=out[d])
        torch.testing.assert_close(out[dev].cpu(), out["cpu"], rtol=0,
                                   atol=1e-5)

    def test_predictor_round_launches_fedagg_twice(self, monkeypatch):
        """An FL round with the predictor launches fedagg for the
        arrivals' mean and for the blend, and never takes the plain
        version on the card."""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.data import TaskConfig
        from repro_torch.fl import FLServer
        dev = cuda_device()
        monkeypatch.setattr(fedagg, "fedagg_plain", None)
        cfg = dataclasses.replace(get_config("smollm_135m").reduced(),
                                  d_model=32, d_ff=64, vocab_size=32,
                                  n_layers=2)
        srv = FLServer(cfg, FLConfig(n_clients=8, local_batch=8, lr=0.2,
                                     samples_per_client=(24, 48)),
                       NOMAConfig(n_subchannels=2),
                       TaskConfig(vocab_size=32, n_topics=4, seq_len=17),
                       device=dev, predictor="ann", eval_every=10)
        before = fedagg.fedagg.launches
        hist = srv.run(3)
        assert fedagg.fedagg.launches == before + 6
        assert hist.n_predicted == [0, 4, 4]
        assert srv.deltas.shape[0] == 8


@pytest.mark.cuda
class TestMoEOnCard:
    """The MoE layer on the card against the same layer on the CPU."""

    def test_queue_positions_card_equals_cpu(self):
        """moonshot's 64 experts top-6 at a 16,384-token prefill: the same
        queue places on both devices, exactly."""
        from repro_torch.models import moe
        dev = cuda_device()
        gen = torch.Generator().manual_seed(0)
        idx = torch.stack([torch.randperm(64, generator=gen)[:6]
                           for _ in range(16_384)])
        want = moe.queue_positions(idx, 64)
        assert torch.equal(moe.queue_positions(idx.to(dev), 64).cpu(), want)

    @pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
    def test_apply_moe_card_equals_cpu(self, capacity_factor):
        """moonshot's 64 experts top-6 over 512 tokens at a narrow width,
        with and without drops: outputs within 1e-5 of max|out| and aux
        to rtol 1e-5 in fp32 (a router near-tie could flip a choice
        between the devices; at 512 tokens that is unlikely)."""
        import dataclasses
        from repro_torch.models import moe
        dev = cuda_device()
        cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b"),
                                  d_model=64, d_ff=96,
                                  capacity_factor=capacity_factor)
        layer = moe.MoE(cfg, torch.float32, torch.device("cpu"))
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        x = torch.randn((2, 256, 64), generator=gen)
        with torch.no_grad():
            want, want_aux = moe.apply_moe(layer, x, cfg)
            got, aux = moe.apply_moe(layer.to(dev), x.to(dev), cfg)
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.cuda
class TestVlmEncdecOnCard:
    """The reduced paligemma and seamless (fp32) on the card against the
    same weights on the CPU."""

    @pytest.mark.parametrize("arch", ["paligemma_3b", "seamless_m4t_medium"])
    def test_card_equals_cpu(self, arch):
        """The windowed prefill (S=300 past the reduced 256 window; one swa
        launch a layer, the prefix band in paligemma's) and the full one,
        4 decode steps from the prefill's cache, and ``run_serve``'s
        tokens: logits and caches within 1e-4 of their max magnitude."""
        dev = cuda_device()
        cfg = get_config(arch).reduced()
        models = {"cpu": zoo.init_model(cfg, seed=0, device="cpu")}
        models[dev] = zoo.init_model(cfg, seed=0, device=dev)
        models[dev].load_state_dict(models["cpu"].state_dict())
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab_size, (2, 300))
        extra = rng.standard_normal((2, cfg.n_prefix_tokens, cfg.prefix_dim))
        name = "prefix" if cfg.family == "vlm" else "frames"
        pref = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        for w in (0, cfg.long_context_window):
            res = {}
            for d, m in models.items():
                batch = {"tokens": torch.as_tensor(toks, device=d),
                         name: torch.as_tensor(extra, dtype=torch.float32,
                                               device=d)}
                before = swa.swa.launches
                last, cache = zoo.make_prefill_step(cfg, window=w)(m, batch)
                if d != "cpu":
                    assert swa.swa.launches == before + (
                        cfg.n_layers if w else 0)
                full = zoo.init_cache(cfg, 2, pref + 304, device=d)
                for n in full:
                    if n in ("xk", "xv"):
                        full[n].copy_(cache[n])
                    else:
                        full[n][:, :, :pref + 300] = cache[n]
                step, logits = zoo.make_serve_step(cfg), [last]
                tok = torch.argmax(last, -1)
                for i in range(4):
                    tok, lg, full = step(m, full, tok, pref + 300 + i)
                    logits.append(lg)
                res[d] = [x.cpu() for x in (torch.stack(logits), cache["k"],
                                            cache["v"])]
            for a, b in zip(res[dev], res["cpu"]):
                assert float((a - b).abs().max()) <= 1e-4 * float(
                    b.abs().max())
        served = {d: run_serve(cfg, batch=2, prompt_len=40, gen=6, seed=0,
                               device=d, model=m)["tokens"]
                  for d, m in models.items()}
        assert (served[dev] == served["cpu"]).all()


@pytest.mark.cuda
class TestTrainOnCard:
    """The chunked attention and the train step on the card: the chunked
    path against ``direct_attention`` at a shape both fit, and the step of
    reduced models against the CPU, the hybrid, ssm and windowed ones
    through the backward kernels."""

    @pytest.mark.parametrize("causal,window,prefix,softcap",
                             [(True, 0, 0, 0.0), (True, 0, 100, 30.0),
                              (False, 0, 0, 0.0), (False, 64, 0, 30.0)])
    def test_chunked_attention_matches_direct(self, causal, window, prefix,
                                              softcap):
        """(2, 640, 8, 2, 64) fp32 in 128-wide blocks: the output within
        2e-5 and the gradients of q, k, v of autograd through the direct
        path within rtol 1e-4 / atol 1e-6 of max(1, the largest gradient),
        the CPU test's tolerance (tests/test_torch_attention.py)."""
        from repro_torch.models import layers
        dev = cuda_device()
        cfg = dataclasses.replace(get_config("stablelm_1_6b").reduced(),
                                  n_heads=8, n_kv_heads=2, head_dim=64,
                                  logit_softcap=softcap)
        gen = torch.Generator(device=dev).manual_seed(1)
        shapes = [(2, 640, 8, 64), (2, 640, 2, 64), (2, 640, 2, 64)]
        arrays = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        w = torch.randn(shapes[0], generator=gen, device=dev)
        kw = dict(causal=causal, window=window, prefix_len=prefix)

        def run(fn):
            t = [a.clone().requires_grad_() for a in arrays]
            out = fn(*t, cfg, **kw)
            return out, torch.autograd.grad((out * w).sum(), t)

        got, g_got = run(lambda *a, **k: layers.chunked_attention(
            *a, q_chunk=128, kv_chunk=128, **k))
        want, g_want = run(layers.direct_attention)
        assert float((got - want).abs().max()) <= 2e-5
        for g, r in zip(g_got, g_want):
            torch.testing.assert_close(
                g, r, rtol=1e-4, atol=1e-6 * max(1.0, float(r.abs().max())))

    @pytest.mark.parametrize("arch,window", [("stablelm_1_6b", 0),
                                             ("hymba_1_5b", 0),
                                             ("rwkv6_7b", 0),
                                             ("stablelm_1_6b", 8)])
    def test_reduced_train_step_equals_the_cpu(self, arch, window):
        """One step of ``arch`` reduced (fp32, 2 microbatches, remat) at
        S=300, card against CPU from the same weights: loss and grad_norm
        rtol 1e-4, parameters atol 1e-6. Unwindowed stablelm launches no
        kernel; hymba (its window), rwkv6 and stablelm at window 8 launch
        swa or wkv6 twice a layer a microbatch (remat recomputes each
        layer) and its backward once."""
        dev = cuda_device()
        cfg = get_config(arch).reduced()
        models = {"cpu": zoo.init_model(cfg, seed=0, device="cpu")}
        models[dev] = zoo.init_model(cfg, seed=0, device=dev)
        models[dev].load_state_dict(models["cpu"].state_dict())
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab_size, (4, 301))
        step = zoo.make_train_step(cfg, lr=1e-2, microbatches=2,
                                   window=window)
        kernel = ("wkv6" if cfg.family == "ssm" else "swa"
                  if cfg.family == "hybrid" or window else None)
        out = {}
        for d, m in models.items():
            batch = {"tokens": torch.as_tensor(toks[:, :-1], device=d),
                     "labels": torch.as_tensor(toks[:, 1:], device=d),
                     "weight": torch.linspace(0.5, 2.0, 4, device=d)}
            before = dict(kernels.launch_counts())
            out[d] = {n: float(v) for n, v in step(m, batch).items()}
            want = dict(before)
            if kernel and d == dev:
                want[kernel] += 4 * cfg.n_layers
                want[f"{kernel}_bwd"] += 2 * cfg.n_layers
            assert kernels.launch_counts() == want
        for n in ("loss", "grad_norm"):
            assert out[dev][n] == pytest.approx(out["cpu"][n], rel=1e-4)
        for p, q in zip(models[dev].parameters(),
                        models["cpu"].parameters()):
            assert float((p.detach().cpu() - q.detach()).abs().max()) <= 1e-6
