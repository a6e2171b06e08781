#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # + a timed and a profiled FL round,
                                     # profiled prefills and decode steps

Phases, each fatal on failure:
  1. the card's name and power limit; build the CUDA kernels from
     src/repro_torch/csrc (timed as set-up); launch the probe kernel;
  2. every kernel (probe, pairscore, fedagg, planner, swa, wkv6) against
     its plain PyTorch version on the card, with its time (CUDA events,
     median), its plain version's time, a library yardstick where one
     PyTorch call computes the same function, and its bound on the H100;
     wkv6 also with the device time of each of its three kernels, both
     terms of its bound, the former kernel's fp32 operation term and its
     compiler report; swa also at head_dim 128 (grok's attention at full
     width with its softcap 30, tile edges), at head_dim 256 and with the
     prefix-LM band (prefixes 0, 1, 100, 256 and past the window, on
     every head dim), and timed at the windowed prefill shapes of
     moonshot, chatglm3, paligemma (with its prefix) and seamless against
     band-masked SDPA; the backward kernels swa_bwd and wkv6_bwd against
     ``torch.autograd.grad`` through swa_plain and wkv6_plain in fp32:
     swa_bwd at hymba's (1, 4096, 25, 5, 64) W=2048 and at paligemma's hd
     256 with its 256-token prefix in bf16 (the wgmma kernels, with the
     forward's output and lse, whose lse is checked too), in bf16 at every
     head dim with a prefix, softcap 30 and groups 1, 5 and 8, in fp32
     (the CUDA-core kernels) at hd 16 and 128 with softcap 30 and at the
     tiles' edges, timed beside SDPA's backward alone and its forward and
     backward; wkv6_bwd (the chunked kernels on the tensor cores) at
     (1, 64, 4096, 64) in bf16 and fp32, with every w_log at the +4 clip
     (there also against ``wkv6_bwd_plain``, the kernels' algorithm);
     each twice, bitwise equal, and timed beside its bound, with the
     device time of each of its five kernels and its scratch;
  3. the wireless engine at Monte-Carlo scale (B=64, N=10,000, K=128),
     checked for its invariants and against the same engine on the CPU;
  4. the pairing policies and joint selection (B=64, N=10,000, K=16):
     adjacent, hungarian, greedy_matching and hungarian+joint, checked for
     their invariants and against the CPU;
  5. the Monte-Carlo rollout (``montecarlo_rounds``, R=20, S=32, N=64) for
     five policies under strong_weak and hungarian, card against CPU;
  6. the FL round on a small model, card against CPU (the reference),
     also under the vehicular scenario at n_cells=3, under iot_bursty,
     and through ``compare_policies`` (every policy, 2 rounds);
  6a. the budget eviction loop (B=64, N=64, K=5, half the no-budget round
     time) for all four pairings x both selections, card against CPU, and
     the pairscore kernel at the loop's shapes and on padding pairs;
  6b. ``montecarlo_rounds(policy="age_noma_budget")`` (R=20, S=32, N=64)
     under strong_weak and hungarian, and at n_cells=3 with a drifting
     ``cell_seq``, card against CPU; the small FL run (phase 6) also under
     age_noma_budget and at n_cells=3;
  7. the slice-1 main path: ``FLServer`` at the full width of smollm-135M
     in bf16, 50 clients, 10 slots, 3 rounds each evaluated;
  8. the same FL round under ``pairing="hungarian", selection="joint"``,
     3 rounds; then under ``policy="age_noma_budget"`` (budget calibrated
     on the first round), 3 rounds, and at n_cells=3, 2 rounds, with
     fedagg timed over that path's (30, P) delta buffer;
  9. the serving path of hymba_1_5b at full width in bf16: ``run_serve``
     with B=2, a 4096-token prompt (longer than the 2048 window) and 16
     greedy decode steps; the last-token logits of the prefill against the
     same prefill with the plain attention on the card, in bf16 and with
     the same weights in fp32;
 10. rwkv6_7b at full width in bf16: ``make_prefill_step`` at B=1,
     T=4096; ``run_serve`` with a 64-token prompt and 16 generated
     tokens; at T=256 the prefill's per-layer states and last logits
     against 256 decode steps from an empty cache, reported in bf16 and
     held in fp32;
 11. every registered scenario through ``run_montecarlo`` with the six
     policies (R=16, S=64, N=128): fused against presampled bitwise,
     ``first_env`` against round 0 of ``rollout``, the card's rollout
     through the CPU engine; n_cells=3 under vehicular and pedestrian
     with handovers;
 12. vehicular fused and presampled at N=10,000, S=64, R=5, K=128;
 13. ``shard=True`` on one card, and the seed split over [card, card],
     against the unsplit run, bitwise, for every policy;
 14. ``repro_torch.launch.train.main`` at the full width of smollm-135M
     (age_noma_budget, 30 clients, 3 rounds): strict history JSON, the
     checkpoint restored bitwise into a fresh model, the ledger manifest;
 15. the update predictor: (a) the small FL run of phase 6 under
     predictor none, stale and ann, 6 rounds from one set of weights,
     card against CPU (selections, predictions, losses, pred_error and
     pred_loss rtol 1e-4, final parameters atol 1e-5), and
     ``compare_predictors`` on both; (b) ``FLServer(predictor="ann")``
     at the full width of smollm-135M (phase 7's config, 8 rounds each
     evaluated, tracing spans on, a (50, P) delta buffer and a (50, P)
     store): predictions from round 1, pred_loss finite in two rounds or
     more, the spans, the sketch's time a call, and fedagg over the
     largest blend against its plain version, ``torch.mv`` and its bound;
 16. moonshot_v1_16b_a3b whole (48 layers, 28.06 B parameters, bf16):
     ``run_serve`` at B=1, a 4096-token prompt, 16 greedy tokens (window
     0, the chunked attention); ``make_prefill_step(window=8192)`` at
     B=1, T=16,384 (one swa launch a layer), layer 0's q, k, v caught by
     a forward hook and the kernel on them held against ``swa_plain``;
     then the config cut to 2 layers in fp32, its windowed prefill's
     last logits against the same prefill with the plain attention;
 17. chatglm3_6b whole (serve and the windowed prefill, as 16) and
     stablelm_1_6b whole (serve);
 18. grok_1_314b and llama4_maverick_400b_a17b reduced, fp32, card
     against CPU: prefill (windowed and not), decode, ``run_serve``;
 19. ``launch.train.main(["--arch", "moonshot_v1_16b_a3b", ...])`` at the
     reference CLI's reduced config, 3 rounds, card against CPU from one
     draw of the weights (the MoE aux loss in local SGD);
 20. paligemma_3b whole (18 layers, 2.51 B parameters, bf16):
     ``run_serve`` at B=1, its 256 image-prefix tokens, a 4096-token
     prompt and 16 greedy tokens (the chunked attention with the prefix-LM
     mask); ``make_prefill_step(window=8192)`` at T=16,384 (256 prefix +
     16,128 text; one swa launch a layer, head_dim 256 with the prefix
     band), layer 0's q, k, v caught by a forward hook and held against
     ``swa_plain(prefix=256)``; the config cut to 2 layers in fp32 against
     the plain attention;
 21. seamless_m4t_medium whole (12 + 12 layers, 0.88 B parameters):
     ``run_serve`` at B=1, 512 encoder frames, a 4096-token prompt and 16
     tokens; the windowed prefill at T=16,384 (one swa launch a decoder
     layer; the encoder and the cross-attention are chunked), the first
     swa call's inputs held against ``swa_plain``; then paligemma and
     seamless reduced, fp32, card against CPU (as 18);
 22. the train step: stablelm_1_6b whole (bf16, 1,644,414,976
     parameters): ``make_prefill_step`` (window 0: the chunked
     running-softmax attention) at B=1, T=4096 and T=16,384, then
     ``make_train_step(lr=1e-3, microbatches=4, remat=True)`` at B=8,
     S=2048 for 3 steps (s a step, tokens/s, loss, grad_norm, peak GiB);
     the chunked attention against the direct one on the card at
     stablelm's heads, fp32 and bf16; one step of reduced stablelm,
     moonshot (capacity_factor 8), paligemma and seamless in fp32 at
     S=1280 (two Q and two KV blocks of the chunked attention), card
     against CPU (loss and grad_norm rtol 1e-4, parameters
     atol 1e-6); so too reduced hymba, rwkv6, stablelm at window 8,
     paligemma at window 64 (its prefix inside) and grok at window 64
     (softcap 30, GQA, moe), which train through swa or wkv6 and their
     backward kernels;
 23. training through the backward kernels: hymba_1_5b and rwkv6_7b whole
     in bf16, ``make_train_step(lr=1e-3, microbatches=2, remat=True)`` at
     B=2, S=4096 (hymba's 2,048 window bites), a warm-up step and 2
     timed steps (s a step, tokens/s, loss, grad_norm, peak GiB, the
     launches of swa and swa_bwd or wkv6 and wkv6_bwd); then
     ``launch.train.main(["--arch", "hymba_1_5b" | "rwkv6_7b", ...])``
     reduced, 3 rounds, card against CPU from one CPU draw of the weights:
     at the CLI's lr 0.3 within 4x the gap of the same round on the card
     through the plain versions (the card's rounding, amplified), and
     at lr 3e-4 within phase 15a's tiers;
 24. the dry-run tools (launch/dryrun.py): ``dryrun_one`` on a one-rank
     host mesh (a fake world of 1) traces the train step of
     stablelm_1_6b at phase 22's (B=8, S=2048, 4 microbatches) and of
     hymba_1_5b and rwkv6_7b at phase 23's (B=2, S=4096, 2 microbatches)
     on the fake card; one real step of each on the card under the same
     ``FlopCounterMode`` and ``OpBytesMode`` gives the same FLOPs and op
     bytes, exactly (hymba's and rwkv6's count swa, swa_bwd, wkv6 and
     wkv6_bwd through their ``repro_torch::`` ops' formulas), its peak
     within a factor 2 of the predicted argument + temp bytes; the FLOPs
     over phase 22's and 23's s a step as a share of the bf16 peak;
     ``python -m repro_torch.launch.dryrun --arch smollm_135m --shape
     train_4k`` in a subprocess (the fake 256-rank group and mesh on the
     fake card); ``layers.ring_flash_attention`` on a one-rank NCCL group
     against ``flash_attention``, fp32, within 1e-5, at the reference
     test's shape, and reduced smollm's ring prefill against its prefill.
Phases 6a, 7, 8 (each FL path), 9 (run_serve), 10 (the T=4096 prefill),
14, 15b, 16, 17, 20 and 21 (each serve and windowed prefill), 19 and 22
(each prefill and the full-width train step), 22's reduced steps and 23
(each full-width step and FL round) each set every kernel's launch count
to 0 just before and read it just after.
The run ledgers go to a temporary directory (``REPRO_RUNS_DIR``), removed
at the end. The phases run in the order 1-5, 6a, 6b, 11-13, 6, 7, 8, 14,
15, 9, 10, 16-24.

With ``--profile`` it then times the stages of one more FL round and
traces another with ``torch.profiler``, and traces one prefill and one
decode step in each of phases 9, 10, 16, 17, 20 and 21 (naming the swa
and wkv6 kernels' calls and device time within the prefill; in 16, 17,
20 and 21 also the serve path's unwindowed 4096-token prefill, through
the chunked attention), and one full-width train step in phases 22 and
23. It prints a ``{"kernels": [...]}``
line (launches of the four FL kernels from phase 8's hungarian + joint
path, of swa from phase 9, of wkv6 from phase 10, of swa_bwd from
hymba's full-width train steps and of wkv6_bwd from rwkv6's, phase 23;
each entry also has
the launches of the budget FL path, of the multi-cell budget FL path, of
the train CLI's path, ``launches_train``, of the predictor FL path,
``launches_predictor_fl``, of the MoE FL path, ``launches_moe_fl``, and
of the windowed prefills of moonshot and chatglm3,
``launches_moonshot_prefill`` and ``launches_chatglm3_prefill``, and of
paligemma's and seamless's, ``launches_paligemma_prefill`` and
``launches_seamless_prefill``, and of the full-width train step,
``launches_train_step``: 0 for every kernel, none is on its path, and
of phase 23's paths, ``launches_hymba_1_5b_train``,
``launches_rwkv6_7b_train``, ``launches_hymba_1_5b_fl`` and
``launches_rwkv6_7b_fl``),
the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json. Without a CUDA card, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

PAIR_TOL = dict(rtol=1e-6, atol=1e-9)
# both sides accumulate in fp32 from the same inputs, so bf16 takes a
# tolerance that a kernel accumulating in bf16 would miss
FEDAGG_TOL = {"float32": 1e-6, "bfloat16": 1e-5}
PAIR_OPS = 23            # fp32 operations per element (csrc/pairscore.cu)
PLANNER_OPS = 30         # fp32 operations per pair (csrc/planner.cu)
BF16_ULP = 2.0 ** -7     # one bf16 ulp, relative, at worst
FL_ROUNDS = 3
SMOLLM_PARAMS = 134_515_008

RESULT: dict = {}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float,
          peak_ops_s: Optional[float] = None) -> tuple[float, str]:
    """The least time (ms) of a kernel that moves ``bytes_moved`` and does
    ``ops`` operations (at ``peak_ops_s``, default fp32), and which term
    bounds it, from ``launch.roofline.kernel_roof_point``."""
    from repro_torch.launch import roofline
    rp = roofline.kernel_roof_point(
        ops, bytes_moved, peak_flops=peak_ops_s or roofline.PEAK_FP32_S)
    return (max(rp.t_memory, rp.t_compute) * 1e3,
            "bytes" if rp.t_memory >= rp.t_compute else "operations")


def time_ms(torch, fn, *, reps: int = 20, runs: int = 7) -> float:
    """Median over ``runs`` of the mean device time of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_times(torch, fn, *, reps: int = 10) -> dict:
    """Mean device time of one call of ``fn`` by kernel name (ms): the
    kernels it launched, as ``torch.profiler`` records them, over ``reps``
    calls (host time, such as a ctypes wrapper's, is not in it)."""
    return {k: ms for k, (_, ms) in kernel_calls(torch, fn, reps=reps).items()}


def kernel_calls(torch, fn, *, reps: int = 10) -> dict:
    """{kernel name: (launches a call, device ms a call)} of ``fn`` under
    ``torch.profiler``, over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then comes back without its device records: take
    # a fresh one, at most three
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if kern:
            return {e.key: (e.count / reps,
                            e.self_device_time_total / 1e3 / reps)
                    for e in kern}
    raise NoDeviceRecords("torch.profiler recorded no device kernel in three "
                          "sessions")


class NoDeviceRecords(AssertionError):
    pass


def device_ms(torch, fn, *, reps: int = 10) -> float:
    """Mean device time of one call of ``fn``, all its kernels. Where the
    profiler records no device kernel, the CUDA-event time of the calls
    instead (host time included), listed by the caller's line under
    ``device_ms_from_events`` in the result."""
    try:
        return sum(kernel_times(torch, fn, reps=reps).values())
    except NoDeviceRecords:
        what = f"chip_smoke.py:{sys._getframe(1).f_lineno}"
        ms = time_ms(torch, fn, reps=reps, runs=3)
        RESULT.setdefault("device_ms_from_events", {})[what] = ms
        log(f"torch.profiler recorded no device kernel for {what}: CUDA "
            f"events give {ms} ms a call")
        return ms


def ptxas_report(log_text: str) -> dict:
    """The compiler's register and spill lines by kernel (mangled name)."""
    out, entry = {}, "?"
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            out.setdefault(entry, []).append(line.strip())
    return out


def max_err(torch, out, ref) -> float:
    return max(float((o.float() - r.float()).abs().max()) if o.numel()
               else 0.0 for o, r in zip(out, ref))


# ---------------------------------------------------------------------------
# phase 1-2: build, probe, kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_probe(torch, dev, kinfo):
    from repro_torch.kernels import backend
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    y = backend.probe_kernel(x)
    torch.cuda.synchronize()
    ref = backend.probe_plain(x)
    if not torch.equal(y, ref):
        raise AssertionError("probe_kernel disagrees with x + 1")
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel())
    kinfo["probe_kernel"] = dict(
        max_abs_err=max_err(torch, [y], [ref]),
        ms=time_ms(torch, lambda: backend.probe_kernel(x)),
        device_ms=device_ms(torch, lambda: backend.probe_kernel(x)),
        plain_ms=time_ms(torch, lambda: backend.probe_plain(x)),
        library_ms=time_ms(torch, lambda: torch.add(x, 1.0)),
        library_device_ms=device_ms(torch, lambda: torch.add(x, 1.0)),
        bound_ms=b_ms, bound_by=b_by, tolerance="exact", shape=[8, 128])


def pair_inputs(torch, dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_i = torch.rand(shape, generator=gen, device=dev) * 1e-9 + 1e-16
    g_j = torch.minimum(g_i, torch.rand(shape, generator=gen,
                                        device=dev) * 1e-9 + 1e-16)
    return g_i, g_j


def phase_pairscore(torch, dev, kinfo):
    from repro_torch.kernels import pairscore as P
    kw = dict(n0b=1e-14, pmax=0.2, bw=1e6)
    errs = {}
    for shape in [(1, 5), (256, 128), (1,), (7,), (1025,)]:
        for oma in (False, True):
            g_i, g_j = pair_inputs(torch, dev, shape, sum(shape))
            out = P.pairscore(g_i, g_j, oma=oma, **kw)
            ref = P.pair_math(g_i, g_j, oma=oma, **kw)
            torch.cuda.synchronize()
            for o, r in zip(out, ref):
                torch.testing.assert_close(o, r, **PAIR_TOL)
            errs[f"{shape}{'/oma' if oma else ''}"] = max_err(torch, out,
                                                               ref)
    log(f"pairscore agrees with its plain version (rtol 1e-6, atol 1e-9): "
        f"{errs}")
    timings = {}
    for name, shape in (("fl", (1, 5)), ("montecarlo", (256, 128))):
        g_i, g_j = pair_inputs(torch, dev, shape, 7)
        n = g_i.numel()
        b_ms, b_by = bound(24 * n, PAIR_OPS * n)
        timings[name] = dict(
            shape=list(shape),
            ms=time_ms(torch, lambda: P.pairscore(g_i, g_j, **kw)),
            device_ms=device_ms(torch, lambda: P.pairscore(g_i, g_j, **kw)),
            plain_ms=time_ms(torch, lambda: P.pair_math(g_i, g_j, **kw)),
            bound_ms=b_ms, bound_by=b_by)
        log(f"pairscore {shape}: {timings[name]}")
    fl = timings["fl"]
    kinfo["pairscore"] = dict(
        max_abs_err=max(errs[k] for k in ("(1, 5)", "(1, 5)/oma")),
        ms=fl["ms"], device_ms=fl["device_ms"], plain_ms=fl["plain_ms"],
        library_ms=None, library_device_ms=None,
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"],
        tolerance="rtol 1e-6, atol 1e-9", shape=fl["shape"],
        at_montecarlo_shape=timings["montecarlo"])


def phase_fedagg(torch, dev, kinfo):
    from repro_torch.kernels import fedagg as F
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {}
    # bf16, and odd tails on both the vector and the one-element path
    wide = torch.randn(3, 1032, generator=gen, device=dev)
    cases = {
        "bf16 (10, 4000000)": torch.randn(10, 4_000_000, generator=gen,
                                          device=dev).to(torch.bfloat16),
        "bf16 (10, 1000003)": torch.randn(10, 1_000_003, generator=gen,
                                          device=dev).to(torch.bfloat16),
        "fp32 (3, 1027) unaligned": torch.randn(3, 1027, generator=gen,
                                                device=dev),
        "fp32 (3, 1027) row slice": wide[:, :1027],
    }
    for name, u in cases.items():
        w = torch.rand(u.shape[0], generator=gen, device=dev)
        tol = FEDAGG_TOL[str(u.dtype).split(".")[1]]
        out, ref = F.fedagg(u, w), F.fedagg_plain(u, w)
        torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
        checks[name] = max_err(torch, [out], [ref])
    del cases, wide
    # one FL round of smollm-135M: C = 10 client rows of every parameter
    c, n = 10, SMOLLM_PARAMS
    u = torch.randn(c, n, generator=gen, device=dev)
    w = torch.rand(c, generator=gen, device=dev)
    w = w / w.sum()
    out, ref = F.fedagg(u, w), F.fedagg_plain(u, w)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    checks[f"fp32 ({c}, {n})"] = err = max_err(torch, [out], [ref])
    log(f"fedagg agrees with its plain version (fp32 1e-6, bf16 1e-5): "
        f"{checks}")
    del out, ref
    b_ms, b_by = bound(c * n * 4 + c * 4 + n * 4, 2 * c * n)
    kinfo["fedagg"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: F.fedagg(u, w), reps=10, runs=5),
        device_ms=device_ms(torch, lambda: F.fedagg(u, w)),
        plain_ms=time_ms(torch, lambda: F.fedagg_plain(u, w), reps=3,
                         runs=5),
        library_ms=time_ms(torch, lambda: torch.mv(u.t(), w), reps=10,
                           runs=5),
        library_device_ms=device_ms(torch, lambda: torch.mv(u.t(), w)),
        bound_ms=b_ms, bound_by=b_by, tolerance="fp32 1e-6, bf16 1e-5",
        shape=[c, n], checks=checks)
    log(f"fedagg ({c}, {n}) fp32: {kinfo['fedagg']}")


def phase_planner(torch, dev, kinfo):
    """The planner kernel against its plain version: the bf16 table within
    one bf16 ulp elementwise, row_min and t_sw to rtol 1e-6, two calls
    bitwise equal; then timed, NOMA and OMA, at the path's shapes: the FL
    round (1, 10), the Monte-Carlo rollout (32, 10), the policy batch
    (64, 32) and the engine cell (64, 256), with the kernels that
    ``torch.profiler`` records in one call (one launch a call)."""
    from repro_torch.kernels import planner as PL
    kw = dict(n0b=1e-14, pmax=0.2, bw=1e6)

    def inputs(b, c, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        g = torch.sort(torch.rand((b, c), generator=gen, device=dev) * 1e-9
                       + 1e-14, dim=1, descending=True).values
        t = torch.rand((b, c), generator=gen, device=dev) * 0.45 + 0.05
        return g, t, torch.full((b,), 4e6, device=dev)

    def bits(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32)

    errs = {}
    shapes = [(1, 10), (32, 10), (64, 32), (64, 256), (4, 1030)] + [
        (3, c) for c in (1, 2, 3, 7, 129)]
    for b, c in shapes:
        for oma in (False, True):
            g, t, mb = inputs(b, c, b * 1000 + c)
            out = PL.planner_tables(g, t, mb, oma=oma, **kw)
            again = PL.planner_tables(g, t, mb, oma=oma, **kw)
            ref = PL.planner_tables_plain(g, t, mb, oma=oma, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(out[0].float(), ref[0].float(),
                                       rtol=BF16_ULP, atol=0.0)
            torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0.0)
            torch.testing.assert_close(out[2], ref[2], rtol=1e-6, atol=0.0)
            if not all(torch.equal(bits(x), bits(y))
                       for x, y in zip(out, again)):
                raise AssertionError(f"planner ({b}, {c}), oma={oma}: two "
                                     f"calls differ")
            errs[f"({b}, {c}){'/oma' if oma else ''}"] = max_err(
                torch, [out[0], out[1][torch.isfinite(out[1])], out[2]],
                [ref[0], ref[1][torch.isfinite(ref[1])], ref[2]])
    log(f"planner agrees with its plain version (table 1 bf16 ulp, "
        f"row_min/t_sw rtol 1e-6), two calls bitwise equal: {errs}")
    timings = {}
    for name, (b, c) in (("fl", (1, 10)), ("montecarlo", (32, 10)),
                         ("policies", (64, 32)), ("k128", (64, 256))):
        g, t, mb = inputs(b, c, 7)
        for oma in (False, True):
            call = lambda: PL.planner_tables(g, t, mb, oma=oma, **kw)
            # OMA: one rate and v a candidate, then one max a pair
            ops = (PLANNER_OPS * b * c + b * c * c if oma
                   else PLANNER_OPS * b * c * c)
            b_ms, b_by = bound(b * (8 * c + 4) + 2 * b * c * c + 4 * b * c
                               + 4 * b, ops)
            # the one-launch claim: a profiler with no device records
            # (NoDeviceRecords) fails the phase
            kernels = kernel_calls(torch, call)
            dev_ms = sum(ms for _, ms in kernels.values())
            if sum(n for n, _ in kernels.values()) != 1:
                raise AssertionError(f"planner ({b}, {c}): {kernels} device "
                                     f"kernels a call, not one")
            key = name + ("_oma" if oma else "")
            timings[key] = dict(
                shape=[b, c], oma=oma, ms=time_ms(torch, call),
                device_ms=dev_ms,
                plain_ms=time_ms(torch, lambda: PL.planner_tables_plain(
                    g, t, mb, oma=oma, **kw)),
                bound_ms=b_ms, bound_by=b_by,
                kernels_a_call={k: n for k, (n, _) in kernels.items()})
            log(f"planner ({b}, {c}){' OMA' if oma else ''}: "
                f"{timings[key]}")
    fl = timings["fl"]
    kinfo["planner"] = dict(
        max_abs_err=max(errs[k] for k in ("(1, 10)", "(1, 10)/oma")),
        ms=fl["ms"], device_ms=fl["device_ms"], plain_ms=fl["plain_ms"],
        library_ms=None, library_device_ms=None,
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"],
        tolerance="table 1 bf16 ulp (rtol 2^-7); row_min, t_sw rtol 1e-6",
        shape=fl["shape"], shapes=timings, errors=errs)


def bf16_ulp(x) -> float:
    """One bf16 ulp at max|x| (the largest spacing among x's values)."""
    m = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def row_ulps(torch, out, ref):
    """Per (b, query, head) row: max |out - ref| in bf16 ulps of that row's
    max|ref|; the largest over the rows."""
    err = (out.float() - ref.float()).abs().amax(-1)
    peak = ref.float().abs().amax(-1).clamp_min(2.0 ** -126)
    return float((err / torch.exp2(torch.floor(torch.log2(peak)) - 7)).max())


# Per-row tolerance of swa, in bf16 ulps of the row's max|ref|. The bf16
# kernel rounds P to bf16 before P V (2^-9 relative per weight); a row with
# few keys does not average that out, and where its values cancel it can
# move the output by more than half an ulp before the output's own
# rounding. phase_swa's seed sweep shows where it comes from: on the same
# inputs the fp32 kernel (the same walk with P in fp32), its output rounded
# to bf16, stays within one ulp on every row.
SWA_ROW_ULPS = {"bfloat16": 2.0, "float32": 1.0}


def swa_pairs(s: int, w: int, p: int = 0) -> int:
    """(query, key) pairs of a causal band of width w over s positions,
    with the prefix-LM band's extra pairs (``kernels.swa.band_pairs``,
    which the swa ops' FLOP formulas count)."""
    from repro_torch.kernels.swa import band_pairs
    return band_pairs(s, w, p)


def phase_swa(torch, dev, kinfo):
    """swa against its plain version, held twice: max abs err within one
    bf16 ulp of max|out| over the whole output, and within SWA_ROW_ULPS
    bf16 ulps of its own max|out| on every (b, query, head) row. bf16 runs
    the tensor-core kernel, fp32 the CUDA-core one."""
    import torch.nn.functional as F
    from repro_torch.kernels import swa as SW
    from repro_torch.launch.roofline import PEAK_BF16_S
    gen = torch.Generator(device=dev).manual_seed(11)

    def qkv(b, s, h, kh, hd, dtype=torch.bfloat16):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]

    hymba = (2, 4096, 25, 5, 64, 2048, 0.0)
    shapes = {"hymba prefill": hymba,
              "S < W": (1, 700, 25, 5, 64, 2048, 0.0),
              "S, W off the block": (2, 1000, 6, 3, 64, 300, 0.0),
              "W = 1": (1, 129, 4, 2, 64, 1, 0.0),
              "g = 1": (1, 500, 4, 4, 64, 100, 0.0),
              "softcap 5": (1, 600, 8, 2, 64, 200, 5.0),
              "hd 16 (reduced)": (2, 300, 4, 1, 16, 256, 0.0)}
    # S and W on, one below and one past the 64-key tile and the 128-query
    # block
    shapes.update({f"tile edge S={s} W={w}": (2, s, 6, 2, 64, w, 0.0)
                   for s in (63, 64, 65, 127, 128, 129)
                   for w in (63, 64, 65, 128, 4096)})
    # head_dim 128 (two 64-column slabs a tile): grok's attention at full
    # width with its softcap 30, moonshot's g = 1 and chatglm3's 32:2 at
    # a quarter of their prefill length, S and W off the blocks and the
    # tile edges
    shapes.update({
        "hd 128 grok (softcap 30)": (1, 4096, 48, 8, 128, 2048, 30.0),
        "hd 128 moonshot g = 1": (1, 4096, 16, 16, 128, 2048, 0.0),
        "hd 128 chatglm3 32:2": (1, 4096, 32, 2, 128, 2048, 0.0),
        "hd 128 S, W off the block": (2, 1000, 6, 3, 128, 300, 0.0),
        "hd 128 W = 1": (1, 129, 4, 2, 128, 1, 0.0)})
    shapes.update({f"hd 128 tile edge S={s} W={w}": (2, s, 6, 2, 128, w, 0.0)
                   for s in (63, 64, 65, 127, 128, 129)
                   for w in (63, 64, 65, 128, 4096)})
    # head_dim 256 (four slabs, setmaxnreg) and the prefix-LM band (an 8th
    # entry, the prefix): paligemma's 8:1 with its 256-token prefix at a
    # quarter of its prefill, 4:4, prefixes 0, 1, 100, 256 and past W,
    # softcap 30, S, W and P off the tiles; seamless's 16:16 at hd 64; the
    # hd 16, 64 and 128 kernels with a prefix
    shapes.update({
        "hd 256 paligemma 8:1 prefix 256": (1, 4096, 8, 1, 256, 2048, 0.0,
                                            256),
        "hd 256 4:4": (2, 1000, 4, 4, 256, 300, 0.0),
        **{f"hd 256 prefix {p}": (2, 1000, 8, 1, 256, 300, 0.0, p)
           for p in (0, 1, 100, 256, 500)},
        "hd 256 softcap 30 prefix 256": (1, 700, 8, 1, 256, 300, 30.0, 256),
        "hd 256 prefix past S": (1, 200, 8, 1, 256, 64, 0.0, 300),
        "hd 64 seamless 16:16": (1, 4096, 16, 16, 64, 2048, 0.0),
        "hd 16 prefix 8": (2, 300, 4, 1, 16, 256, 0.0, 8),
        "hd 64 prefix 100": (2, 1000, 6, 3, 64, 300, 0.0, 100),
        "hd 128 prefix 100 softcap 30": (2, 1000, 6, 3, 128, 300, 30.0, 100)})
    shapes.update({f"hd 256 tile edge S={s} W={w} P=70":
                   (2, s, 6, 2, 256, w, 0.0, 70)
                   for s in (63, 65, 127, 129) for w in (63, 65, 4096)})
    errs = {}
    for (name, (b, s, h, kh, hd, w, cap, *pre)), dt in itertools.product(
            shapes.items(), SWA_ROW_ULPS):
        p = pre[0] if pre else 0
        q, k, v = qkv(b, s, h, kh, hd, getattr(torch, dt))
        if cap:
            q = q * 8.0                       # scores well past the cap
        out = SW.swa(q, k, v, window=w, softcap=cap, prefix=p)
        torch.cuda.synchronize()
        ref = SW.swa_plain(q, k, v, window=w, softcap=cap, prefix=p)
        err, tol = max_err(torch, [out], [ref]), bf16_ulp(ref)
        rows = row_ulps(torch, out, ref)
        if not (err <= tol and rows <= SWA_ROW_ULPS[dt]):
            raise AssertionError(
                f"swa {name} {dt}: max abs err {err} (one bf16 ulp of "
                f"max|out| {tol}), worst row {rows} bf16 ulps of its max "
                f"(held at {SWA_ROW_ULPS[dt]})")
        errs[f"{name} {dt}"] = dict(max_abs_err=err, tolerance=tol,
                                    worst_row_ulps=rows)
        del q, k, v, out, ref
    # the reduced hymba shape over 16 seeds, worst row against the plain
    # version: the bf16 kernel within SWA_ROW_ULPS, the fp32 kernel on the
    # same values (P in fp32), rounded to bf16, within one ulp
    b, s, h, kh, hd, w, _ = shapes["hd 16 (reduced)"]
    sweep = {"bf16_kernel": 0.0, "fp32_kernel_rounded": 0.0}
    for seed in range(16):
        gen.manual_seed(1000 + seed)
        q, k, v = qkv(b, s, h, kh, hd)
        ref = SW.swa_plain(q, k, v, window=w)
        sweep["bf16_kernel"] = max(sweep["bf16_kernel"], row_ulps(
            torch, SW.swa(q, k, v, window=w), ref))
        sweep["fp32_kernel_rounded"] = max(
            sweep["fp32_kernel_rounded"], row_ulps(torch, SW.swa(
                q.float(), k.float(), v.float(), window=w).bfloat16(), ref))
    if not (sweep["bf16_kernel"] <= SWA_ROW_ULPS["bfloat16"]
            and sweep["fp32_kernel_rounded"] <= 1.0):
        raise AssertionError(f"swa seed sweep, worst row in bf16 ulps: "
                             f"{sweep}")
    worst = {dt: max(e["worst_row_ulps"] for n, e in errs.items()
                     if n.endswith(dt)) for dt in SWA_ROW_ULPS}
    log(f"swa agrees with its plain version in {len(errs)} cases (1 bf16 "
        f"ulp of max|out|; per row {SWA_ROW_ULPS}); worst row in ulps "
        f"{worst}; reduced shape over 16 seeds {sweep}: {errs}")
    b, s, h, kh, hd, w, _ = hymba
    q, k, v = qkv(b, s, h, kh, hd)
    # the library yardstick: SDPA with the band as a boolean mask, (B,H,S,hd)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    i = torch.arange(s, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                              enable_gqa=True)

    lib_err = max_err(torch, [sdpa().transpose(1, 2)],
                      [SW.swa_plain(q, k, v, window=w)])
    pairs = swa_pairs(s, w) * b * h
    b_ms, b_by = bound(2 * b * s * (2 * h + 2 * kh) * hd, 4 * hd * pairs,
                       PEAK_BF16_S)
    main = errs["hymba prefill bfloat16"]
    kinfo["swa"] = dict(
        max_abs_err=main["max_abs_err"],
        worst_row_ulps=main["worst_row_ulps"],
        ms=time_ms(torch, lambda: SW.swa(q, k, v, window=w), reps=20,
                   runs=7),
        device_ms=device_ms(torch, lambda: SW.swa(q, k, v, window=w)),
        plain_ms=time_ms(torch, lambda: SW.swa_plain(q, k, v, window=w),
                         reps=2, runs=3),
        library_ms=time_ms(torch, sdpa, reps=5, runs=5),
        library_device_ms=device_ms(torch, sdpa, reps=5),
        library="scaled_dot_product_attention(attn_mask=band, "
                "enable_gqa=True)",
        library_max_abs_err=lib_err,
        bound_ms=b_ms, bound_by=b_by, bound_peak="989 TFLOP/s bf16, "
                                                 "3.35 TB/s",
        tolerance=f"1 bf16 ulp of max|out|; per row "
                  f"{SWA_ROW_ULPS['bfloat16']} bf16 ulps of the row's max",
        shape=list(hymba[:6]), worst_row_ulps_by_dtype=worst,
        seed_sweep_worst_row_ulps=sweep, checks=errs)
    del q, k, v, qt, kt, vt, band
    kinfo["swa"]["head_dim_128"] = {
        name: swa_prefill_times(torch, dev, shape, qkv)
        for name, shape in SWA_128_PREFILLS.items()}
    kinfo["swa"]["vlm_encdec"] = {
        name: swa_prefill_times(torch, dev, shape, qkv)
        for name, shape in SWA_VLM_ENCDEC_PREFILLS.items()}
    log(f"swa {hymba[:6]}: {kinfo['swa']}")


# the windowed prefills of the head_dim-128 decoders: (B, S, H, KH, hd, W)
SWA_128_PREFILLS = {"moonshot_v1_16b_a3b": (1, 16_384, 16, 16, 128, 8192),
                    "chatglm3_6b": (1, 16_384, 32, 2, 128, 8192)}
# and of paligemma (its 256-token image prefix first) and seamless's
# decoder: (B, S, H, KH, hd, W, prefix)
SWA_VLM_ENCDEC_PREFILLS = {
    "paligemma_3b": (1, 16_384, 8, 1, 256, 8192, 256),
    "seamless_m4t_medium": (1, 16_384, 16, 16, 64, 8192, 0)}


def swa_prefill_times(torch, dev, shape, qkv) -> dict:
    """swa at a windowed prefill shape (a 7th entry: the prefix): the
    kernel's time and device time, the plain version's (one query head at
    a time: whole, its fp32 scores would take H x 1 GiB three times over),
    SDPA's with the band (and prefix) as a boolean mask, and the bound,
    its pairs counted with the prefix's extra pairs."""
    import torch.nn.functional as F
    from repro_torch.kernels import swa as SW
    from repro_torch.launch.roofline import PEAK_BF16_S
    b, s, h, kh, hd, w, *pre = shape
    p = pre[0] if pre else 0
    q, k, v = qkv(b, s, h, kh, hd)
    # SDPA with K and V expanded to the H query heads: with a mask and
    # enable_gqa it could take its math path, whose (1, H, S, S) scores
    # would not fit
    qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2).transpose(
        1, 2).contiguous() for x in (q, k, v))
    i = torch.arange(s, device=dev)
    band = (((i[None, :] <= i[:, None]) | (i[None, :] < p))
            & (i[None, :] > i[:, None] - w))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    def kernel():
        return SW.swa(q, k, v, window=w, prefix=p)

    out = kernel()
    ref = swa_plain_by_head(torch, q, k, v, window=w, prefix=p)
    err, tol, rows = (max_err(torch, [out], [ref]), bf16_ulp(ref),
                      row_ulps(torch, out, ref))
    if not (err <= tol and rows <= SWA_ROW_ULPS["bfloat16"]):
        raise AssertionError(f"swa {shape}: max abs err {err} (tolerance "
                             f"{tol}), worst row {rows} bf16 ulps")
    lib_err = max_err(torch, [sdpa().transpose(1, 2)], [ref])
    del out, ref
    b_ms, b_by = bound(2 * b * s * (2 * h + 2 * kh) * hd,
                       4 * hd * swa_pairs(s, w, p) * b * h, PEAK_BF16_S)
    return dict(
        shape=list(shape), max_abs_err=err, tolerance=tol,
        worst_row_ulps=rows,
        ms=time_ms(torch, kernel, reps=10, runs=7),
        device_ms=device_ms(torch, kernel),
        plain_ms_by_head=time_ms(torch, lambda: swa_plain_by_head(
            torch, q, k, v, window=w, prefix=p), reps=1, runs=3),
        library_ms=time_ms(torch, sdpa, reps=5, runs=5),
        library_device_ms=device_ms(torch, sdpa, reps=5),
        library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)


def swa_plain_by_head(torch, q, k, v, *, window, softcap=0.0, prefix=0):
    """``swa_plain`` one query head at a time against its KV head: the
    same function, with one head's fp32 scores (1 GiB at S=16,384) at a
    time instead of all H."""
    from repro_torch.kernels import swa as SW
    h, kh = q.shape[2], k.shape[2]
    g = h // kh
    out = torch.empty_like(q)
    for i in range(h):
        j = i // g
        out[:, :, i:i + 1] = SW.swa_plain(
            q[:, :, i:i + 1], k[:, :, j:j + 1], v[:, :, j:j + 1],
            window=window, softcap=softcap, prefix=prefix)
    return out


def wkv6_inputs(torch, dev, b, h, t, c, seed, *, clip=False, s0=True,
                dtype=None):
    """r, k, v (bf16 unless ``dtype``), w_log, u and s0 (None without
    ``s0``); ``clip`` puts every decay at the +4 clip."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype or torch.bfloat16
    r, k, v = (torch.randn((b, h, t, c), generator=gen, device=dev) * 0.5
               for _ in range(3))
    wt = (torch.full((b, h, t, c), 4.0, device=dev) if clip
          else torch.randn((b, h, t, c), generator=gen, device=dev) - 1.0)
    w_log = -torch.exp(torch.clamp(wt, -8.0, 4.0))
    u = torch.randn((h, c), generator=gen, device=dev) * 0.5
    st = (torch.randn((b, h, c, c), generator=gen, device=dev) * 0.1
          if s0 else None)
    return r.to(dtype), k.to(dtype), v.to(dtype), w_log, u, st


def phase_wkv6(torch, dev, kinfo):
    """wkv6 against its plain version, out and s_T, fp32: max abs err <=
    1e-4 * max|out| (and the same for s_T)."""
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.launch.roofline import (PEAK_BYTES_S, PEAK_FP32_S,
                                             PEAK_TF32_S)
    cases = {"rwkv6 prefill": ((1, 64, 4096, 64), 128, {}),
             "rwkv6 prefill, s0, w at the +4 clip":
                 ((1, 64, 4096, 64), 128, dict(clip=True)),
             "short T, s0": ((2, 64, 77, 64), 128, {}),
             "short T, zero s0": ((2, 64, 77, 64), 128, dict(s0=False)),
             "T off the chunk, chunk 64": ((1, 8, 1000, 64), 64, {}),
             "C 16 (reduced), fp32": ((2, 8, 300, 16), 128,
                                      dict(dtype=torch.float32)),
             "one head, T 4096": ((1, 1, 4096, 64), 128, {})}
    errs = {}
    for name, ((b, h, t, c), chunk, kw) in cases.items():
        args = wkv6_inputs(torch, dev, b, h, t, c, seed=t + c, **kw)
        out, s_t = WK.wkv6(*args, chunk=chunk)
        torch.cuda.synchronize()
        ref, ref_s = WK.wkv6_plain(*args, chunk=chunk)
        e_o, e_s = max_err(torch, [out], [ref]), max_err(torch, [s_t], [ref_s])
        t_o = 1e-4 * float(ref.abs().max())
        t_s = 1e-4 * float(ref_s.abs().max())
        if not (e_o <= t_o and e_s <= t_s):
            raise AssertionError(f"wkv6 {name}: out err {e_o} (tol {t_o}), "
                                 f"s_T err {e_s} (tol {t_s})")
        errs[name] = dict(out_err=e_o, out_tol=t_o, s_T_err=e_s, s_T_tol=t_s)
        del args, out, s_t, ref, ref_s
    log(f"wkv6 agrees with its plain version (1e-4 of max|out|, max|s_T|): "
        f"{errs}")
    b, h, t, c = 1, 64, 4096, 64
    args = wkv6_inputs(torch, dev, b, h, t, c, seed=5, s0=False)
    n = b * h * t * c
    bytes_moved = 3 * n * 2 + 2 * n * 4 + h * c * 4 + 2 * b * h * c * c * 4
    ops = 5 * c * c * t * h * b          # the recurrence's count
    # each product three times over on the TF32 tensor cores (3xTF32)
    b_ms, b_by = bound(bytes_moved, 3 * ops, PEAK_TF32_S)
    call = lambda: WK.wkv6(*args, chunk=128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
    call()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20 - base_mib
    by_kernel = kernel_times(torch, call, reps=5)
    kinfo["wkv6"] = dict(
        max_abs_err=errs["rwkv6 prefill"]["out_err"],
        s_T_max_abs_err=errs["rwkv6 prefill"]["s_T_err"],
        ms=time_ms(torch, call, reps=5, runs=5),
        device_ms=sum(by_kernel.values()), device_ms_by_kernel=by_kernel,
        plain_ms=time_ms(torch, lambda: WK.wkv6_plain(*args, chunk=128),
                         reps=2, runs=3),
        library_ms=None, library_device_ms=None, bound_ms=b_ms,
        bound_by=b_by, bound_bytes_ms=bytes_moved / PEAK_BYTES_S * 1e3,
        bound_ops_ms=3 * ops / PEAK_TF32_S * 1e3,
        bound_peak="495 TFLOP/s TF32 x 3 products, 3.35 TB/s",
        # the former kernel's operation term, for comparison with its row
        bound_fp32_ops_ms=ops / PEAK_FP32_S * 1e3,
        peak_mem_above_inputs_mib=peak_mib,
        ptxas={k: v for k, v in RESULT.get("ptxas", {}).items()
               if "wkv6" in k},
        tolerance="1e-4 of max|out| (and of max|s_T|)",
        shape=[b, h, t, c], chunk=128, checks=errs)
    log(f"wkv6 {(b, h, t, c)} chunk 128: {kinfo['wkv6']}")


# the backward kernels' cases: (B, S, H, KH, hd, W, softcap, prefix, dtype):
# hymba's training shape (its 2,048 window bites at S = 4096), paligemma's
# head_dim 256 with its 256-token prefix; bf16 (the wgmma kernels) at every
# head dim with S off the 64-row tile, a prefix that crosses a tile,
# softcap 30 and group sizes 1, 5 and 8, and at W = 1; fp32 (the CUDA-core
# kernels) at hd 16 and 128 with softcap 30 and at the tiles' edges (64
# rows, 32 at hd 256) with and without a prefix
SWA_BWD_CASES = {
    "hymba train": (1, 4096, 25, 5, 64, 2048, 0.0, 0, "bfloat16"),
    "paligemma hd 256 prefix 256": (1, 4096, 8, 1, 256, 2048, 0.0, 256,
                                    "bfloat16"),
    "bf16 hd 16 g 5 prefix 70 softcap 30": (2, 333, 5, 1, 16, 100, 30.0, 70,
                                            "bfloat16"),
    "bf16 hd 64 g 1 prefix 90 softcap 30": (1, 200, 4, 4, 64, 70, 30.0, 90,
                                            "bfloat16"),
    "bf16 hd 128 g 8 prefix 70 softcap 30": (1, 197, 8, 1, 128, 33, 30.0, 70,
                                             "bfloat16"),
    "bf16 hd 256 g 8 prefix 70 softcap 30": (1, 97, 8, 1, 256, 33, 30.0, 70,
                                             "bfloat16"),
    "bf16 hd 256 g 1 prefix 70": (1, 130, 4, 4, 256, 50, 0.0, 70,
                                  "bfloat16"),
    "hd 16 softcap 30": (2, 300, 4, 1, 16, 256, 30.0, 0, "float32"),
    "hd 128 softcap 30": (1, 1024, 16, 2, 128, 512, 30.0, 0, "float32"),
    "hd 64 tile edges prefix 70": (2, 129, 6, 3, 64, 65, 0.0, 70, "float32"),
    "hd 256 tile edges prefix 40": (1, 97, 8, 1, 256, 33, 30.0, 40,
                                    "float32"),
    "hd 64 W = 1": (1, 129, 4, 2, 64, 1, 0.0, 0, "bfloat16"),
    "hd 128 g = 1": (1, 1000, 4, 4, 128, 300, 0.0, 0, "bfloat16"),
    "hd 16 S < W": (2, 63, 4, 1, 16, 256, 0.0, 0, "float32"),
}
GRAD_RTOL = 1e-4         # fp32 gradients: of max|g|
# swa_bwd's bf16 gradients: two bf16 ulps of max|g|. The wgmma kernels
# round P and dS to bf16 for the tensor cores and take D = dO . O from the
# forward's bf16 output (as FlashAttention-2/3 do); an fp32 emulation of
# that rounding on the CPU lands up to 1.70 ulps from autograd through
# swa_plain in fp32 over 20 seeds of the card tests' shapes, and up to 1.08
# with D from an fp32 O, so P and dS alone pass one ulp
SWA_BWD_ULPS = 2


def grad_tolerance(torch, ref, dtype: str, scale: float = 0.0,
                   ulps: int = 1) -> float:
    """A gradient's tolerance: ``ulps`` bf16 ulps of max|ref| where the
    kernel writes bf16 (its fp32 sums rounded once), else GRAD_RTOL of
    max|ref|; at least 1e-6 of ``scale`` (max(1, the largest of the call's
    gradients)), the CPU tests' atol, for a gradient whose exact value
    cancels to about 0 (swa at W = 1: dS = P (dP - D) = 0)."""
    tol = (ulps * bf16_ulp(ref) if dtype == "bfloat16"
           else GRAD_RTOL * float(ref.abs().max()))
    return max(tol, 1e-6 * scale)


def swa_plain_grads(torch, q, k, v, dout, **band):
    """``torch.autograd.grad`` through ``swa_plain`` in fp32: the
    backward kernels' yardstick."""
    from repro_torch.kernels import swa as SW
    t = [x.detach().float().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(SW.swa_plain(*t, **band), t, dout.float())


def swa_fwd_saved(torch, q, k, v, band) -> tuple:
    """What ``_SwaGrad`` saves for ``swa_bwd``: the forward's output and
    lse for bf16 (checked here: lse within 1e-5 of max|lse| of
    ``swa_lse_plain``, the output equal to the serving path's, lse null,
    bit for bit), None and None for fp32."""
    from repro_torch.kernels import swa as SW
    if q.dtype != torch.bfloat16:
        return None, None, {}
    w, cap, p = band["window"], band["softcap"], band["prefix"]
    out, lse = SW._forward(q, k, v, w, cap, p, with_lse=True)
    served = SW._forward(q, k, v, w, cap, p)
    ref = SW.swa_lse_plain(q.float(), k.float(), v.float(), **band)
    err = float((lse - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    if not (err <= tol and torch.equal(out, served)):
        raise AssertionError(f"swa forward with lse: lse err {err} "
                             f"(tolerance {tol}), output equal to the "
                             f"serving path's: {torch.equal(out, served)}")
    return out, lse, dict(lse_max_abs_err=err, lse_tolerance=tol)


def phase_swa_bwd(torch, dev, kinfo):
    """swa's backward kernels (``swa_bwd``, csrc/swa_bwd.cu: the wgmma
    kernels for bf16 with the forward's output and lse, the CUDA-core ones
    for fp32) against autograd through ``swa_plain`` in fp32 on the card,
    each of dq, dk, dv within ``grad_tolerance``; twice on the same inputs,
    bitwise equal; timed at hymba's and paligemma's shapes beside their
    bound (10 hd operations a pair of the band: q.k, dO.v, dS k, dS q,
    P dO) and beside SDPA's backward alone and its forward and backward
    with the band as a mask."""
    from repro_torch.kernels import swa as SW
    gen = torch.Generator(device=dev).manual_seed(23)
    checks, timed = {}, {}
    for name, (b, s, h, kh, hd, w, cap, p, dt) in SWA_BWD_CASES.items():
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, s, h, hd), (b, s, kh, hd),
                                 (b, s, kh, hd)))
        if cap:
            q = q * 8.0                       # scores well past the cap
        dout = torch.randn((b, s, h, hd), generator=gen, device=dev)
        q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
        band = dict(window=w, softcap=cap, prefix=p)
        out, lse, fwd_errs = swa_fwd_saved(torch, q, k, v, band)
        got = SW.swa_bwd(q, k, v, dout, out=out, lse=lse, **band)
        torch.cuda.synchronize()
        again = SW.swa_bwd(q, k, v, dout, out=out, lse=lse, **band)
        ref = swa_plain_grads(torch, q, k, v, dout, **band)
        errs = dict(fwd_errs)
        scale = max(1.0, *(float(r.abs().max()) for r in ref))
        for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
            err = max_err(torch, [g], [r])
            tol = grad_tolerance(torch, r, dt, scale, SWA_BWD_ULPS)
            errs[gname] = dict(max_abs_err=err, tolerance=tol,
                               ulps=err / bf16_ulp(r) if bf16_ulp(r) else 0)
            if not (g.dtype == dtype and err <= tol):
                raise AssertionError(f"swa_bwd {name} {gname}: max abs err "
                                     f"{err} (tolerance {tol}), dtype "
                                     f"{g.dtype}")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"swa_bwd {name}: two calls differ")
        checks[name] = errs
        if name in ("hymba train", "paligemma hd 256 prefix 256"):
            timed[name] = swa_bwd_times(torch, dev, (q, k, v, dout), band,
                                        (out, lse), errs)
        del q, k, v, dout, out, lse, got, again, ref
    log(f"swa_bwd agrees with autograd through swa_plain (fp32) in "
        f"{len(checks)} cases, bitwise equal over two calls: {checks}")
    b, s, h, kh, hd, w, _, p, _ = SWA_BWD_CASES["hymba train"]
    pairs = swa_pairs(s, w) * b * h
    main = timed["hymba train"]
    kinfo["swa_bwd"] = dict(
        max_abs_err=max(e["max_abs_err"] for key, e in
                        checks["hymba train"].items()
                        if key in ("dq", "dk", "dv")),
        **{key: main[key] for key in (
            "ms", "device_ms", "device_ms_by_kernel", "plain_ms",
            "library_ms", "library_device_ms", "library_fwd_bwd_ms",
            "library_fwd_bwd_device_ms", "fwd_bwd_ms", "bound_ms",
            "bound_by", "bytes_with_scratch")},
        routes={"bfloat16": "wgmma + TMA on the tensor cores, lse and the "
                            "output from the forward: swa_bwd_dq_wgmma, "
                            "swa_bwd_dkv_wgmma, swa_bwd_group_sum (H > KH)",
                "float32": "the CUDA cores, lse and O recomputed: "
                           "swa_bwd_dq, swa_bwd_dkv"},
        library="scaled_dot_product_attention(attn_mask=band, "
                "enable_gqa=True): its backward alone (autograd.grad with "
                "retain_graph on one forward), like for like; "
                "library_fwd_bwd_ms its forward and backward (beside "
                "fwd_bwd_ms: swa then swa_bwd)",
        plain="torch.autograd.grad through swa_plain in fp32, forward and "
              "backward",
        bound_peak="989 TFLOP/s bf16, 3.35 TB/s (the bytes: q, k, v, dout, "
                   "out, lse read once, dq, dk, dv written once)",
        tolerance=f"each of dq, dk, dv within {SWA_BWD_ULPS} bf16 ulps of "
                  f"its max|ref| (bf16: P and dS rounded to bf16 for the "
                  f"tensor cores, D from the bf16 output), 1e-4 of it "
                  f"(fp32), and at least 1e-6 of max(1, max|dq, dk, dv|), "
                  f"against autograd through swa_plain in fp32; the "
                  f"forward's lse within 1e-5 of max|lse|",
        shape=[b, s, h, kh, hd, w], pairs=pairs,
        bound_ops_gflop=10 * hd * pairs / 1e9, timed=timed, checks=checks)
    log(f"swa_bwd {SWA_BWD_CASES['hymba train'][:6]}: {kinfo['swa_bwd']}")


def swa_bwd_times(torch, dev, qkvo, band, saved, errs) -> dict:
    """swa_bwd's time and device time by kernel at one shape, autograd
    through the plain version's forward and backward, SDPA's backward
    alone and its forward and backward with the band (and prefix) as a
    boolean mask, and the bound: one read of q, k, v, dout, the forward's
    output and lse and one write of dq, dk, dv, against 10 hd operations a
    pair of the band at the inputs' type's peak."""
    import torch.nn.functional as F
    from repro_torch.kernels import swa as SW
    from repro_torch.launch.roofline import PEAK_BF16_S, PEAK_FP32_S
    q, k, v, dout = qkvo
    out, lse = saved
    b, s, h, hd = q.shape
    kh = k.shape[2]
    w, p = band["window"], band["prefix"]
    call = lambda: SW.swa_bwd(q, k, v, dout, out=out, lse=lse, **band)

    def fwd_bwd():
        t = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(SW.swa(*t, **band), t, dout)

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ot = dout.transpose(1, 2).contiguous()
    i = torch.arange(s, device=dev)
    mask = (((i[None, :] <= i[:, None]) | (i[None, :] < p))
            & (i[None, :] > i[:, None] - w))

    def sdpa():
        t = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        o = F.scaled_dot_product_attention(*t, attn_mask=mask,
                                           enable_gqa=True)
        return torch.autograd.grad(o, t, ot)

    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                              enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, leaves, ot, retain_graph=True)

    pairs = swa_pairs(s, w, p) * b * h
    ops = 10 * hd * pairs
    elem = q.element_size()
    bytes_moved = (elem * (5 * b * s * h * hd + 4 * b * s * kh * hd)
                   + 4 * b * h * s)
    # + the bf16 kernels' scratch, written and read once: D and lse (B, H,
    # S rounded up to 64), and under GQA the fp32 partials of dk and dv
    rows = -(-s // 64) * 64
    scratch = 2 * 2 * 4 * b * h * rows + (2 * 2 * 4 * b * s * h * hd
                                          if h > kh else 0)
    peak = PEAK_BF16_S if q.dtype == torch.bfloat16 else PEAK_FP32_S
    b_ms, b_by = bound(bytes_moved, ops, peak)
    by_kernel = kernel_times(torch, call, reps=5)
    return dict(
        shape=[b, s, h, kh, hd, w, p], dtype=str(q.dtype).split(".")[-1],
        errors=errs, ms=time_ms(torch, call, reps=5, runs=5),
        device_ms=sum(by_kernel.values()), device_ms_by_kernel=by_kernel,
        fwd_bwd_ms=time_ms(torch, fwd_bwd, reps=3, runs=5),
        plain_ms=time_ms(torch, lambda: swa_plain_grads(
            torch, q, k, v, dout, **band), reps=1, runs=3),
        library_ms=time_ms(torch, sdpa_bwd, reps=3, runs=5),
        library_device_ms=device_ms(torch, sdpa_bwd, reps=3),
        library_fwd_bwd_ms=time_ms(torch, sdpa, reps=3, runs=5),
        library_fwd_bwd_device_ms=device_ms(torch, sdpa, reps=3),
        bound_ms=b_ms, bound_by=b_by, pairs=pairs,
        bytes_with_scratch=bytes_moved + scratch)


# the wkv6 backward's cases: (B, H, T, C, dtype, inputs' options, ds_T)
WKV6_BWD_CASES = {
    "rwkv6 train bf16": ((1, 64, 4096, 64), "bfloat16", {}, True),
    "rwkv6 fp32": ((1, 64, 4096, 64), "float32", {}, True),
    "rwkv6 fp32, w at the +4 clip": ((1, 64, 4096, 64), "float32",
                                     dict(clip=True), True),
    "C 16, T off the chunk": ((2, 8, 300, 16), "float32", {}, True),
    "T = 1": ((1, 4, 1, 64), "float32", {}, True),
    "zero s0, no ds_T, bf16": ((2, 8, 200, 64), "bfloat16",
                               dict(s0=False), False),
}
WKV6_GRADS = ("dr", "dk", "dv", "dw_log", "du", "ds0")
# every w_log at the +4 clip: the plain chunked form moves the adjacent
# step's decay by up to one ulp of lp (2^-11 at |lp| in [4096, 8192)), and
# its dw_log is the residue of terms that cancel through lp's cumulative
# sum, where the exact gradient is ~e^{-e^4} (tests/test_torch_wkv6_grad.py)
WKV6_CLIP_RTOL = 2.0 ** -11


def wkv6_plain_grads(torch, args, dout, ds_t):
    """``torch.autograd.grad`` through ``wkv6_plain`` (chunk 128, the
    model's) in fp32, for the inputs that are given (s0 None: zero)."""
    from repro_torch.kernels import wkv6 as WK
    t = [None if x is None else x.detach().float().requires_grad_()
         for x in args]
    out, s_t = WK.wkv6_plain(*t, chunk=128)
    outs, cots = [out], [dout]
    if ds_t is not None:
        outs.append(s_t)
        cots.append(ds_t)
    leaves = [x for x in t if x is not None]
    return torch.autograd.grad(outs, leaves, cots)


def phase_wkv6_bwd(torch, dev, kinfo):
    """wkv6's backward kernels (``wkv6_bwd``, csrc/wkv6_bwd.cu) against
    autograd through ``wkv6_plain`` in fp32 on the card: each gradient
    within ``grad_tolerance`` (dr, dk, dv in r's dtype; dw_log, du, ds0
    fp32), at the +4 clip within WKV6_CLIP_RTOL and dw_log within 1e-6 of
    the larger of 1 and max|dr, dk, dv|; at the clip also against
    ``wkv6_bwd_plain``, the kernels' algorithm (the same chunks, frames
    and sums over spanned steps): GRAD_RTOL for dr, dk, dv, du and ds0,
    1e-6 of that scale for dw_log. Twice on the same inputs, bitwise
    equal; timed at rwkv6's shape beside its bound, with its peak memory
    above the inputs (outputs and scratch)."""
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.launch.roofline import PEAK_BYTES_S, PEAK_TF32_S
    checks = {}
    for name, ((b, h, t, c), dt, kw, with_ds) in WKV6_BWD_CASES.items():
        clip = kw.get("clip", False)
        args = wkv6_inputs(torch, dev, b, h, t, c, seed=t + c + 1,
                           dtype=getattr(torch, dt), **kw)
        gen = torch.Generator(device=dev).manual_seed(t)
        dout = torch.randn((b, h, t, c), generator=gen, device=dev)
        ds_t = (torch.randn((b, h, c, c), generator=gen, device=dev)
                if with_ds else None)
        states = WK._forward(*args[:3], args[3].float(), args[4].float(),
                             args[5], 128)[2]
        got = WK.wkv6_bwd(*args, dout, ds_t, states=states, chunk=128)
        torch.cuda.synchronize()
        again = WK.wkv6_bwd(*args, dout, ds_t, states=states, chunk=128)
        ref = wkv6_plain_grads(torch, args, dout, ds_t)
        names = [n for n, x in zip(WKV6_GRADS, (*args[:5], args[5]))
                 if x is not None]
        got_by = dict(zip(WKV6_GRADS, got))
        scale = max(1.0, *(float(r.abs().max()) for r in ref[:3]))
        errs = {}
        for gname, r in zip(names, ref):
            g = got_by[gname]
            err = max_err(torch, [g], [r])
            if clip and gname == "dw_log":
                tol = 1e-6 * scale
            elif clip:
                tol = max(WKV6_CLIP_RTOL * float(r.abs().max()),
                          grad_tolerance(torch, r, dt if gname in
                                         ("dr", "dk", "dv") else "float32",
                                         scale))
            else:
                tol = grad_tolerance(torch, r, dt if gname in
                                     ("dr", "dk", "dv") else "float32",
                                     scale)
            errs[gname] = dict(max_abs_err=err, tolerance=tol)
            if not err <= tol:
                raise AssertionError(f"wkv6_bwd {name} {gname}: max abs err "
                                     f"{err} (tolerance {tol})")
        if not all(torch.equal(a, x) for a, x in zip(got, again)):
            raise AssertionError(f"wkv6_bwd {name}: two calls differ")
        if clip:
            # the kernels' algorithm: their lp, their pairs; what is left
            # apart is the rounding of the products and of exp
            plain = WK.wkv6_bwd_plain(*args, dout, ds_t, chunk=128)
            for gname, g, r in zip(WKV6_GRADS, got, plain):
                err = max_err(torch, [g], [r])
                tol = (1e-6 * scale if gname == "dw_log" else
                       GRAD_RTOL * max(float(r.abs().max()), 1e-30))
                errs[f"{gname} vs wkv6_bwd_plain"] = dict(max_abs_err=err,
                                                          tolerance=tol)
                if not err <= tol:
                    raise AssertionError(f"wkv6_bwd {name} {gname} against "
                                         f"wkv6_bwd_plain: {err} "
                                         f"(tolerance {tol})")
        checks[name] = errs
        del args, dout, ds_t, states, got, again, ref
    log(f"wkv6_bwd agrees with autograd through wkv6_plain (fp32) in "
        f"{len(checks)} cases, bitwise equal over two calls: {checks}")
    b, h, t, c = 1, 64, 4096, 64
    args = wkv6_inputs(torch, dev, b, h, t, c, seed=5, s0=False)
    gen = torch.Generator(device=dev).manual_seed(6)
    dout = torch.randn((b, h, t, c), generator=gen, device=dev)
    states = WK._forward(*args[:3], args[3], args[4], None, 128)[2]
    call = lambda: WK.wkv6_bwd(*args, dout, None, states=states, chunk=128)
    n = b * h * t * c
    # read r, k, v (bf16), w_log, dout (fp32), u; write dr, dk, dv (bf16),
    # dw_log (fp32), du, ds0
    bytes_moved = (3 * n * 2 + 2 * n * 4 + h * c * 4
                   + 3 * n * 2 + n * 4 + h * c * 4 + b * h * c * c * 4)
    # a step and head: dr, dk, dv, dw_log (C^2 FMAs each), G's update and
    # the state (a multiply and an FMA each), the work of the recurrence
    # whatever computes it; priced as the forward's are, each product
    # three times over on the TF32 tensor cores (3xTF32)
    ops = 14 * c * c * t * h * b
    b_ms, b_by = bound(bytes_moved, 3 * ops, PEAK_TF32_S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
    call()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20 - base_mib
    by_kernel = kernel_times(torch, call, reps=5)
    main = checks["rwkv6 train bf16"]
    kinfo["wkv6_bwd"] = dict(
        max_abs_err=max(e["max_abs_err"] for e in main.values()),
        ms=time_ms(torch, call, reps=5, runs=5),
        device_ms=sum(by_kernel.values()), device_ms_by_kernel=by_kernel,
        plain_ms=time_ms(torch, lambda: wkv6_plain_grads(
            torch, args, dout, None), reps=1, runs=3),
        plain="torch.autograd.grad through wkv6_plain (chunk 128) in fp32, "
              "forward and backward",
        library_ms=None, library_device_ms=None, bound_ms=b_ms,
        bound_by=b_by, bound_bytes_ms=bytes_moved / PEAK_BYTES_S * 1e3,
        bound_ops_ms=3 * ops / PEAK_TF32_S * 1e3,
        bound_peak="495 TFLOP/s TF32 x 3 products, 3.35 TB/s",
        peak_mem_above_inputs_mib=peak_mib,
        ptxas={k: v for k, v in RESULT.get("ptxas", {}).items()
               if "wkv6_bwd" in k},
        tolerance="dr, dk, dv one bf16 ulp of max|ref| (bf16) or 1e-4 of "
                  "it (fp32); dw_log, du, ds0 1e-4 of max|ref|; at the +4 "
                  "clip 2^-11 of max|ref|, dw_log 1e-6 of max(1, "
                  "max|dr, dk, dv|)",
        shape=[b, h, t, c], checks=checks)
    log(f"wkv6_bwd {(b, h, t, c)}: {kinfo['wkv6_bwd']}")


# ---------------------------------------------------------------------------
# phase 3: engine at Monte-Carlo scale
# ---------------------------------------------------------------------------


def make_batch(rng, drops, n, ncfg):
    """The benchmarks/engine_throughput.py recipe, numpy rng only."""
    from repro_torch.core import noma
    import numpy as np
    dist = np.stack([noma.sample_distances(rng, n, ncfg)
                     for _ in range(drops)])
    gains = np.stack([noma.sample_gains(rng, dist[b], ncfg)
                      for b in range(drops)])
    n_samples = rng.uniform(100, 1000, (drops, n))
    cpu_freq = rng.uniform(0.5e9, 2e9, (drops, n))
    ages = rng.integers(1, 30, (drops, n)).astype(float)
    return gains, n_samples, cpu_freq, ages


def phase_engine(torch, dev):
    import numpy as np
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.core.engine import WirelessEngine
    b, n, k = 64, 10_000, 128
    ncfg = NOMAConfig(n_subchannels=k)
    batch = make_batch(np.random.default_rng(0), b, n, ncfg)
    eng = WirelessEngine(ncfg, FLConfig(), device=dev)
    out = eng.schedule_batch(*batch, 1e6)
    torch.cuda.synchronize()
    c = 2 * k
    if not bool((out.selected.sum(1) == c).all()):
        raise AssertionError("engine did not select exactly c per row")
    tot = torch.where(out.selected, out.t_cmp + out.t_com, 0.0)
    torch.testing.assert_close(out.t_round, tot.max(1).values, rtol=1e-6,
                               atol=0.0)
    if not bool((out.powers <= ncfg.max_power_w).all()):
        raise AssertionError("a power exceeds P_max")
    cpu = WirelessEngine(ncfg, FLConfig(), device="cpu").schedule_batch(
        *batch, 1e6)
    for f in ("selected", "pair_strong", "pair_weak"):
        if not torch.equal(getattr(out, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"engine {f} differs card vs CPU")
    torch.testing.assert_close(out.rates.cpu(), cpu.rates, rtol=1e-5,
                               atol=0.0)
    torch.testing.assert_close(out.t_round.cpu(), cpu.t_round, rtol=1e-5,
                               atol=0.0)
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        eng.schedule_batch(*batch, 1e6)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    RESULT["engine"] = dict(B=b, N=n, K=k, c=c,
                            batch_ms=statistics.median(times) * 1e3,
                            drops_per_s=b / statistics.median(times))
    log(f"engine B={b} N={n} K={k}: c per row, t_round, P_max and card == "
        f"CPU hold; {RESULT['engine']}")


def phase_policies(torch, dev):
    """The pairing policies and joint selection at B=64, N=10,000, K=16
    (c=32, m=16): invariants on the card, and the CPU plain path on the
    same batch."""
    import numpy as np
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.core.engine import WirelessEngine
    b, n, k = 64, 10_000, 16
    c = 2 * k
    ncfg = NOMAConfig(n_subchannels=k)
    batch = make_batch(np.random.default_rng(1), b, n, ncfg)
    sw = WirelessEngine(ncfg, FLConfig(), device=dev).schedule_batch(
        *batch, 1e6)
    res = {}
    for pairing, selection in (("adjacent", "greedy_set"),
                               ("hungarian", "greedy_set"),
                               ("greedy_matching", "greedy_set"),
                               ("hungarian", "joint")):
        name = pairing if selection == "greedy_set" else f"{pairing}+joint"
        eng = WirelessEngine(ncfg, FLConfig(), device=dev, pairing=pairing,
                             selection=selection)
        out = eng.schedule_batch(*batch, 1e6)
        torch.cuda.synchronize()
        sel = out.selected
        if not bool((sel.sum(1) == c).all()):
            raise AssertionError(f"{name}: not exactly c selected per row")
        ids = torch.cat([out.pair_strong, out.pair_weak], 1)
        ids = torch.where(ids >= 0, ids, n)
        hits = torch.zeros((b, n + 1), dtype=torch.int64, device=dev)
        hits.scatter_add_(1, ids, torch.ones_like(ids))
        if not bool((hits[:, :n] == sel.long()).all()):
            raise AssertionError(f"{name}: a selected client is not in "
                                 f"exactly one pair row")
        tot = torch.where(sel, out.t_cmp + out.t_com, 0.0)
        torch.testing.assert_close(out.t_round, tot.max(1).values,
                                   rtol=1e-6, atol=0.0)
        if not bool((out.powers <= ncfg.max_power_w).all()):
            raise AssertionError(f"{name}: a power exceeds P_max")
        if pairing == "hungarian" and not bool(
                (out.t_round <= sw.t_round * (1 + 1e-2)).all()):
            raise AssertionError(f"{name}: slower than strong_weak beyond "
                                 f"the bf16 tier")
        cpu = WirelessEngine(ncfg, FLConfig(), device="cpu",
                             pairing=pairing,
                             selection=selection).schedule_batch(*batch, 1e6)
        if not torch.equal(sel.cpu(), cpu.selected):
            raise AssertionError(f"{name}: selected sets differ card vs CPU")
        same = ((out.pair_strong.cpu() == cpu.pair_strong)
                & (out.pair_weak.cpu() == cpu.pair_weak)).all(1)
        if pairing != "hungarian" and not bool(same.all()):
            raise AssertionError(f"{name}: pair tables differ card vs CPU")
        torch.testing.assert_close(
            out.t_round.cpu(), cpu.t_round, atol=0.0,
            rtol=1e-2 if pairing == "hungarian" else 1e-5)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.schedule_batch(*batch, 1e6)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[name] = dict(batch_ms=statistics.median(times) * 1e3,
                         rows_pairing_differently_vs_cpu=int((~same).sum()),
                         mean_t_round_s=float(out.t_round.mean()))
        log(f"policy {name} B={b} N={n} K={k}: invariants and card == CPU "
            f"hold; {res[name]}")
    # where hungarian's time goes: the matching solvers alone on a
    # (B, c, c) table, host-timed to a synchronise
    from repro_torch.core import matching
    gen = torch.Generator(device=dev).manual_seed(4)
    table = torch.rand((b, c, c), generator=gen, device=dev) + 1.0
    m = c // 2
    ar = torch.arange(m, device=dev).expand(b, m)
    rev = torch.arange(c - 1, m - 1, -1, device=dev).expand(b, m)
    adj = (2 * torch.arange(m, device=dev)).expand(b, m)
    solvers = {
        "hungarian_assignment": lambda: matching.hungarian_assignment(
            table[:, :m, m:]),
        "best_bottleneck_matching (3 inits)":
            lambda: matching.best_bottleneck_matching(
                table, ((ar, rev), (ar, rev), (adj, adj + 1))),
        "greedy_assignment": lambda: matching.greedy_assignment(
            table[:, :m, m:]),
    }
    split = {}
    for name, fn in solvers.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        split[name] = statistics.median(times) * 1e3
    log(f"matching solvers at B={b}, m={m} (ms): {split}")
    RESULT["policies"] = dict(B=b, N=n, K=k, c=c, solver_ms=split, **res)


def mc_gains(rng, r, s, n, ncfg):
    from repro_torch.core import noma
    import numpy as np
    dist = np.stack([noma.sample_distances(rng, n, ncfg) for _ in range(s)])
    gains = np.stack([np.stack([noma.sample_gains(rng, dist[j], ncfg)
                                for j in range(s)]) for _ in range(r)])
    return (gains, rng.uniform(100, 1000, (s, n)),
            rng.uniform(0.5e9, 2e9, (s, n)))


def phase_montecarlo(torch, dev):
    """``montecarlo_rounds`` at run_montecarlo's defaults (R=20, S=32,
    N=64, default NOMAConfig) for five policies under strong_weak and
    hungarian, card against CPU; then strong_weak at R=5, S=64,
    N=10,000, K=128."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.core.engine import MC_POLICIES, WirelessEngine
    r, s, n = 20, 32, 64
    ncfg = NOMAConfig()
    c = min(ncfg.n_subchannels * ncfg.users_per_subchannel, n)
    inputs = mc_gains(np.random.default_rng(2), r, s, n, ncfg)
    res = {}
    for pairing in ("strong_weak", "hungarian"):
        card = WirelessEngine(ncfg, FLConfig(), device=dev, pairing=pairing)
        cpu = WirelessEngine(ncfg, FLConfig(), device="cpu",
                             pairing=pairing)
        for policy in MC_POLICIES:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = card.montecarlo_rounds(*inputs, 1e6, policy=policy)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = kernels.launch_counts()
            want = r if pairing == "hungarian" else 0
            if counts["planner"] != want:
                raise AssertionError(f"{pairing}/{policy}: planner launched "
                                     f"{counts['planner']} times, not {want}")
            if not bool((out["n_selected"] == c).all()):
                raise AssertionError(f"{pairing}/{policy}: not c per round")
            if policy != "random":
                ref = cpu.montecarlo_rounds(*inputs, 1e6, policy=policy)
                for key in ("n_selected", "participation", "final_ages"):
                    if not torch.equal(out[key].cpu(), ref[key]):
                        raise AssertionError(f"{pairing}/{policy}: {key} "
                                             f"differs card vs CPU")
                torch.testing.assert_close(
                    out["t_round"].cpu(), ref["t_round"], atol=0.0,
                    rtol=1e-2 if pairing == "hungarian" else 1e-5)
            res[f"{pairing}/{policy}"] = dict(
                s=sec, drops_per_s=r * s / sec, launches=counts)
            log(f"montecarlo {pairing}/{policy} R={r} S={s} N={n}: "
                f"{res[f'{pairing}/{policy}']}")
    RESULT["montecarlo"] = dict(R=r, S=s, N=n, K=ncfg.n_subchannels)
    rb, sb, nb, kb = 5, 64, 10_000, 128
    ncfg = NOMAConfig(n_subchannels=kb)
    big = mc_gains(np.random.default_rng(3), rb, sb, nb, ncfg)
    eng = WirelessEngine(ncfg, FLConfig(), device=dev)
    eng.montecarlo_rounds(*big, 1e6)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.montecarlo_rounds(*big, 1e6)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if not bool((out["n_selected"] == 2 * kb).all()):
        raise AssertionError("montecarlo K=128: not c per round")
    res["strong_weak/age_noma K=128"] = dict(
        R=rb, S=sb, N=nb, K=kb, s=sec, drops_per_s=rb * sb / sec)
    log(f"montecarlo strong_weak R={rb} S={sb} N={nb} K={kb}: "
        f"{res['strong_weak/age_noma K=128']}")
    RESULT["montecarlo"].update(res)


def same_or_tied(torch, out, ref, pairing, t_budget=None):
    """Card against CPU on a budget or multi-cell schedule: masks and pair
    tables exact, rates and t_round rtol 1e-5. Under hungarian a strong
    user's completion does not depend on its partner, so matchings tie in
    exact arithmetic and the last bit of the fp32 table (CUDA's log1pf
    against the CPU's) picks one: a row may pair differently (held by
    t_round to rtol 1e-6) and, in the budget loop, evict differently from
    there on (at most 2 rows, each meeting its budget or down to one
    client on both sides). Returns (rows pairing differently, rows
    selecting differently)."""
    masks = torch.ones(out.t_round.shape, dtype=torch.bool)
    for f in ("selected", "evicted"):
        masks &= (getattr(out, f).cpu() == getattr(ref, f)).all(1)
    if not bool(masks.all()):
        if pairing != "hungarian" or t_budget is None or \
                int((~masks).sum()) > 2:
            raise AssertionError(f"{pairing}: selected/evicted differ card "
                                 f"vs CPU in {int((~masks).sum())} rows")
        tb = torch.as_tensor(t_budget)[~masks]
        for o in (out, ref):
            ok = (o.t_round.cpu()[~masks] <= tb) | (
                o.selected.cpu()[~masks].sum(1) <= 1)
            if not bool(ok.all()):
                raise AssertionError(f"{pairing}: a row selecting "
                                     f"differently misses its budget")
    same = ((out.pair_strong.cpu() == ref.pair_strong)
            & (out.pair_weak.cpu() == ref.pair_weak)).all(1) & masks
    if pairing != "hungarian" and not bool(same.all()):
        raise AssertionError(f"{pairing}: pair tables differ card vs CPU")
    tied = masks & ~same
    torch.testing.assert_close(out.t_round.cpu()[tied], ref.t_round[tied],
                               rtol=1e-6, atol=0.0)
    torch.testing.assert_close(out.t_round.cpu()[masks], ref.t_round[masks],
                               rtol=1e-5, atol=0.0)
    torch.testing.assert_close(out.rates.cpu()[same], ref.rates[same],
                               rtol=1e-5, atol=0.0)
    return int(tied.sum()), int((~masks).sum())


def host_ms(torch, fn, reps=5):
    """Median wall time of ``fn`` to a synchronise (ms)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_budget_engine(torch, dev):
    """The budget eviction loop at B=64, N=64, default NOMAConfig (K=5, 10
    slots), a budget of half each row's no-budget round time, for all four
    pairings x both selections, card against CPU; the pairscore kernel at
    the loop's shapes (B x P pairs, the hungarian table B x s2 x s2), and
    on padding pairs (gain 0)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.core.engine import WirelessEngine
    from repro_torch.kernels import pairscore as P
    b, n = 64, 64
    ncfg = NOMAConfig()
    batch = make_batch(np.random.default_rng(5), b, n, ncfg)
    res = {}
    for pairing, selection in itertools.product(
            ("strong_weak", "adjacent", "greedy_matching", "hungarian"),
            ("greedy_set", "joint")):
        name = f"{pairing}/{selection}"
        kw = dict(pairing=pairing, selection=selection)
        card = WirelessEngine(ncfg, FLConfig(), device=dev, **kw)
        cpu = WirelessEngine(ncfg, FLConfig(), device="cpu", **kw)
        free = card.schedule_batch(*batch, 1e6)
        tb = (free.t_round * 0.5).cpu().numpy()
        kernels.reset_launch_counts()
        out = card.schedule_batch(*batch, 1e6, t_budget=tb)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ref = cpu.schedule_batch(*batch, 1e6, t_budget=tb)
        tied, split = same_or_tied(torch, out, ref, pairing, tb)
        n_ev = out.evicted.sum(1)
        iters = int(n_ev.max())
        if not float((n_ev > 0).float().mean()) > 0.5:
            raise AssertionError(f"budget {name}: evicts in too few rows "
                                 f"{n_ev.tolist()}")
        if name == "strong_weak/greedy_set" and \
                counts["pairscore"] != 1 + iters:
            raise AssertionError(f"budget {name}: pairscore launched "
                                 f"{counts['pairscore']} times, not 1 + "
                                 f"{iters} loop iterations")
        res[name] = dict(
            batch_ms=host_ms(torch, lambda: card.schedule_batch(
                *batch, 1e6, t_budget=tb)),
            no_budget_batch_ms=host_ms(torch, lambda: card.schedule_batch(
                *batch, 1e6)),
            iterations=iters, mean_evicted=float(n_ev.float().mean()),
            rows_evicting=int((n_ev > 0).sum()),
            rows_pairing_differently_vs_cpu=tied,
            rows_selecting_differently_vs_cpu=split, launches=counts)
        log(f"budget engine {name} B={b} N={n} K=5: card == CPU; "
            f"{res[name]}")
    # the pairscore kernel at the loop's shapes
    kw = dict(n0b=ncfg.noise_density * ncfg.bandwidth_hz,
              pmax=ncfg.max_power_w, bw=ncfg.bandwidth_hz)
    shapes = {}
    for label, shape in (("loop B x P", (b, 5)),
                         ("hungarian table B x s2 x s2", (b, 10, 10))):
        g_i, g_j = pair_inputs(torch, dev, shape, 17)
        out, ref = P.pairscore(g_i, g_j, **kw), P.pair_math(g_i, g_j, **kw)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, **PAIR_TOL)
        m = g_i.numel()
        b_ms, b_by = bound(24 * m, PAIR_OPS * m)
        shapes[label] = dict(
            shape=list(shape), max_abs_err=max_err(torch, out, ref),
            ms=time_ms(torch, lambda: P.pairscore(g_i, g_j, **kw)),
            device_ms=device_ms(torch, lambda: P.pairscore(g_i, g_j, **kw)),
            plain_ms=time_ms(torch, lambda: P.pair_math(g_i, g_j, **kw)),
            bound_ms=b_ms, bound_by=b_by)
    # padding lanes: the strong or the weak gain 0, or both
    g_i = torch.tensor([1e-9, 0.0, 3e-12, 2e-12], device=dev)
    g_j = torch.tensor([0.0, 0.0, 0.0, 2e-12], device=dev)
    out, ref = P.pairscore(g_i, g_j, **kw), P.pair_math(g_i, g_j, **kw)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(o).all()) for o in out) or bool(
            (out[3][:3] != 0).any()) or bool(out[2][1] != 0):
        raise AssertionError(f"pairscore on padding pairs: {out}")
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, **PAIR_TOL)
    log(f"pairscore at the budget loop's shapes: {shapes}; padding pairs "
        f"finite, rate 0 for gain 0")
    RESULT["budget_engine"] = dict(B=b, N=n, K=5, budget="0.5 x no-budget "
                                   "t_round", pairscore_shapes=shapes, **res)


def cell_positions(rng, s, n, r, ncfg, n_cells):
    """(R, S, N) serving cells and distances of clients placed like the
    multi-cell scenario (home cell, annulus offset) that then walk at
    1-3 m/s for 10 s a round, so some change cells."""
    import numpy as np
    from repro_torch.core import noma
    from repro_torch.sim import topology
    bs = topology.bs_layout(n_cells, "hex", ncfg.cell_radius_m)
    pos = bs[rng.integers(0, n_cells, (s, n))] + np.stack(
        [noma.sample_positions(rng, n, ncfg) for _ in range(s)])
    th = rng.uniform(0, 2 * np.pi, (s, n))
    v = rng.uniform(1, 3, (s, n))[..., None] * np.stack(
        [np.cos(th), np.sin(th)], -1)
    cells, dists = zip(*(topology.nearest_cell(pos + v * 10.0 * i, bs)
                         for i in range(r)))
    return np.stack(cells), np.maximum(np.stack(dists), ncfg.min_radius_m)


def phase_budget_montecarlo(torch, dev):
    """``montecarlo_rounds(policy="age_noma_budget")`` at R=20, S=32, N=64
    under strong_weak and hungarian, the budget 2x the mean channel-greedy
    round time of round 0 (run_montecarlo's calibration), card against
    CPU; then at n_cells=3 with a drifting ``cell_seq`` for age_noma and
    age_noma_budget, handovers included."""
    import numpy as np
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.core.engine import WirelessEngine
    r, s, n = 20, 32, 64
    ncfg = NOMAConfig()
    gains, ns, cpu_f = mc_gains(np.random.default_rng(2), r, s, n, ncfg)
    cell_seq, dist = cell_positions(np.random.default_rng(6), s, n, r, ncfg, 3)
    rng = np.random.default_rng(7)
    cell_gains = (ncfg.ref_path_loss * dist ** (-ncfg.path_loss_exp)
                  * rng.exponential(1.0, dist.shape))
    res = {}
    keys = ("n_selected", "n_evicted", "participation", "final_ages")
    for n_cells, pairing in ((1, "strong_weak"), (1, "hungarian"),
                             (3, "strong_weak")):
        fl = FLConfig(n_cells=n_cells)
        card = WirelessEngine(ncfg, fl, device=dev, pairing=pairing)
        cpu = WirelessEngine(ncfg, fl, device="cpu", pairing=pairing)
        g = gains if n_cells == 1 else cell_gains
        extra = {} if n_cells == 1 else dict(cell_seq=cell_seq)
        cal = card.schedule_batch(g[0], ns, cpu_f, np.ones((s, n)), 1e6,
                                  priority=g[0], cell=cell_seq[0],
                                  n_cells=n_cells)
        tb = 2.0 * max(float(cal.t_round.mean()), 1e-6)
        for policy in ("age_noma", "age_noma_budget"):
            kw = dict(policy=policy, **extra)
            if policy == "age_noma_budget":
                kw["t_budget"] = tb
            t0 = time.perf_counter()
            out = card.montecarlo_rounds(g, ns, cpu_f, 1e6, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            ref = cpu.montecarlo_rounds(g, ns, cpu_f, 1e6, **kw)
            name = f"C={n_cells} {pairing}/{policy}"
            # seeds whose trajectories agree (all of them but, under
            # hungarian's fp32 ties (same_or_tied), at most 2)
            agree = torch.ones(s, dtype=torch.bool)
            for key in keys + (("handovers",) if n_cells > 1 else ()):
                per_round = key not in ("participation", "final_ages")
                agree &= (out[key].cpu() == ref[key]).all(
                    dim=0 if per_round else 1)
            if int((~agree).sum()) > (2 if pairing == "hungarian" else 0):
                raise AssertionError(f"montecarlo {name}: {int((~agree).sum())}"
                                     f" seeds differ card vs CPU")
            torch.testing.assert_close(out["t_round"].cpu()[:, agree],
                                       ref["t_round"][:, agree], rtol=1e-5,
                                       atol=0.0)
            res[name] = dict(s=sec, drops_per_s=r * s / sec,
                             mean_n_selected=float(
                                 out["n_selected"].float().mean()),
                             mean_n_evicted=float(
                                 out["n_evicted"].float().mean()),
                             # the loop runs until its slowest seed is done
                             # (C=1: one eviction a live seed an iteration)
                             mean_max_evicted_per_round=float(
                                 out["n_evicted"].amax(1).float().mean()),
                             mean_t_round_s=float(out["t_round"].mean()),
                             seeds_differing_vs_cpu=int((~agree).sum()))
            if policy == "age_noma_budget":
                res[name]["t_budget_s"] = tb
                if not bool((out["n_evicted"] > 0).any()):
                    raise AssertionError(f"montecarlo {name}: no eviction")
            if n_cells > 1:
                res[name]["handovers_per_round"] = float(
                    out["handovers"][1:].float().mean())
            log(f"montecarlo {name} R={r} S={s} N={n}: card == CPU; "
                f"{res[name]}")
    RESULT["budget_montecarlo"] = dict(R=r, S=s, N=n, K=5, **res)


# ---------------------------------------------------------------------------
# phase 4-5: the FL round
# ---------------------------------------------------------------------------


SMALL = dict(d_model=32, d_ff=64, vocab_size=32)


def small_server(device, state, policy="age_noma", **fl_kw):
    """A 2-layer, 32-wide FL server with the initial weights ``state`` (CPU
    and CUDA generators draw different numbers from one seed)."""
    from repro_torch.configs import FLConfig, NOMAConfig, get_config
    from repro_torch.data import TaskConfig
    from repro_torch.fl import FLServer
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **SMALL)
    srv = FLServer(cfg, FLConfig(n_clients=8, local_batch=8, lr=0.2,
                                 samples_per_client=(24, 48), **fl_kw),
                   NOMAConfig(n_subchannels=2),
                   TaskConfig(vocab_size=32, n_topics=4, seq_len=17),
                   policy=policy, eval_every=1, device=device)
    srv.model.load_state_dict(state)
    return srv


def small_fl(device, state, rounds=2, policy="age_noma", **fl_kw):
    """``rounds`` rounds of ``small_server`` -> History."""
    return small_server(device, state, policy, **fl_kw).run(rounds)


def phase_small_fl(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **SMALL)
    state = zoo.init_model(cfg, seed=0, device="cpu").state_dict()
    h_cpu = small_fl("cpu", state)
    h_card = small_fl(dev, state)
    if h_card.n_selected != h_cpu.n_selected or not (
            h_card.participation == h_cpu.participation).all():
        raise AssertionError("small FL run selects differently on the card")
    for a, b in zip(h_card.loss, h_cpu.loss):
        if not math.isclose(a, b, rel_tol=1e-3):
            raise AssertionError(f"small FL loss card {a} vs CPU {b}")
    for a, b in zip(h_card.round_time, h_cpu.round_time):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"round time card {a} vs CPU {b}")
    log(f"small FL run: card == CPU (selections, loss rtol 1e-3); "
        f"loss {h_card.loss}")
    # the budget policy with a budget that evicts, and three cells
    runs = {"age_noma_budget": dict(policy="age_noma_budget",
                                    t_budget_s=0.6 * h_cpu.round_time[0]),
            "n_cells=3": dict(n_cells=3),
            "n_cells=3 age_noma_budget": dict(policy="age_noma_budget",
                                              n_cells=3)}
    res = {}
    for name, kw in runs.items():
        h_cpu, h_card = (small_fl(d, state, rounds=3, **kw)
                         for d in ("cpu", dev))
        for key in ("n_selected", "n_evicted", "sel_per_cell"):
            if getattr(h_card, key) != getattr(h_cpu, key):
                raise AssertionError(f"small FL {name}: {key} card "
                                     f"{getattr(h_card, key)} vs CPU "
                                     f"{getattr(h_cpu, key)}")
        if not (h_card.participation == h_cpu.participation).all():
            raise AssertionError(f"small FL {name} selects differently")
        for a, b in zip(h_card.loss, h_cpu.loss):
            if not math.isclose(a, b, rel_tol=1e-3):
                raise AssertionError(f"small FL {name} loss card {a} vs "
                                     f"CPU {b}")
        for a, b in zip(h_card.round_time, h_cpu.round_time):
            if not math.isclose(a, b, rel_tol=1e-4):
                raise AssertionError(f"small FL {name} round time card {a} "
                                     f"vs CPU {b}")
        res[name] = dict(n_selected=h_card.n_selected,
                         n_evicted=h_card.n_evicted,
                         sel_per_cell=h_card.sel_per_cell)
    if not any(sum(r["n_evicted"]) for r in res.values()):
        raise AssertionError(f"small FL budget runs evicted nobody: {res}")
    # dynamic scenarios: the numpy twin draws the same environment on both
    for name, kw in {"vehicular n_cells=3": dict(scenario="vehicular",
                                                 n_cells=3),
                     "iot_bursty": dict(scenario="iot_bursty")}.items():
        h_cpu, h_card = (small_fl(d, state, rounds=3, **kw)
                         for d in ("cpu", dev))
        check_small_fl(h_card, h_cpu, name)
        res[name] = dict(n_selected=h_card.n_selected,
                         sel_per_cell=h_card.sel_per_cell,
                         handovers=h_card.handovers)
    res["compare_policies"] = compare_small(dev)
    RESULT["small_fl"] = res
    log(f"small FL budget, multi-cell, scenario and compare_policies runs: "
        f"card == CPU; {res}")


def check_small_fl(h_card, h_cpu, name, loss=True):
    """Selections, evictions, cells and handovers equal; loss rtol 1e-3
    (same initial weights only); round time rtol 1e-4."""
    for key in ("n_selected", "n_evicted", "sel_per_cell", "handovers"):
        if getattr(h_card, key) != getattr(h_cpu, key):
            raise AssertionError(f"small FL {name}: {key} card "
                                 f"{getattr(h_card, key)} vs CPU "
                                 f"{getattr(h_cpu, key)}")
    if not (h_card.participation == h_cpu.participation).all():
        raise AssertionError(f"small FL {name} selects differently")
    for a, b in zip(h_card.loss, h_cpu.loss):
        if not (math.isclose(a, b, rel_tol=1e-3) if loss
                else math.isfinite(a)):
            raise AssertionError(f"small FL {name} loss card {a} vs CPU {b}")
    for a, b in zip(h_card.round_time, h_cpu.round_time):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"small FL {name} round time card {a} "
                                 f"vs CPU {b}")


def compare_small(dev):
    """``compare_policies`` on the tiny config, 2 rounds, card against
    CPU: the initial weights come from each device's generator, so the
    losses are held finite, the selections and round times equal."""
    from repro_torch.configs import FLConfig, NOMAConfig, get_config
    from repro_torch.configs.base import POLICIES
    from repro_torch.data import TaskConfig
    from repro_torch.fl import compare_policies
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **SMALL)
    runs = {d: compare_policies(
        cfg, FLConfig(n_clients=8, local_batch=8, lr=0.2,
                      samples_per_client=(24, 48)),
        NOMAConfig(n_subchannels=2),
        TaskConfig(vocab_size=32, n_topics=4, seq_len=17), rounds=2,
        device=d) for d in ("cpu", dev)}
    for p in POLICIES:
        check_small_fl(runs[dev][p], runs["cpu"][p], f"compare/{p}",
                       loss=False)
    return {p: runs[dev][p].n_selected for p in POLICIES}


def phase_main_path(torch, dev, label="fl", policy="age_noma",
                    rounds=FL_ROUNDS, **fl_kw):
    """FLServer at the full width of smollm-135M, ``rounds`` rounds each
    evaluated, with every launch count set to 0 just before and read just
    after. ``fl_kw`` adds FLConfig fields (the pairing, the selection,
    n_cells)."""
    from repro_torch import kernels
    from repro_torch.configs import FLConfig, NOMAConfig, get_config
    from repro_torch.data import TaskConfig
    from repro_torch.fl import FLServer
    from repro_torch.kernels import backend

    cfg = get_config("smollm_135m")
    fl = FLConfig(n_clients=50, samples_per_client=(64, 128),
                  local_batch=32, **fl_kw)
    # counts to 0, and the once-per-process probe forgotten, just before
    # the main path: it runs as in a fresh process
    backend.probe.cache_clear()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = FLServer(cfg, fl, NOMAConfig(), TaskConfig(), policy=policy,
                   eval_every=1, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    round_s = []
    run_round = srv.run_round

    def timed_round():
        t = time.perf_counter()
        sched = run_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t)
        return sched

    srv.run_round = timed_round
    hist = srv.run(rounds)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    n_params = sum(p.numel() for p in srv.model.parameters())
    if n_params != SMOLLM_PARAMS:
        raise AssertionError(f"model has {n_params} parameters")
    budget = policy == "age_noma_budget"
    if fl.n_cells > 1:
        # the delta buffer holds the most clients the cells can select:
        # fedagg sums up to that many rows
        if any(len(c) != fl.n_cells or max(c) > 10 or sum(c) != k
               for c, k in zip(hist.sel_per_cell, hist.n_selected)) \
                or srv.deltas.shape[0] != min(10 * fl.n_cells, 50):
            raise AssertionError(f"selected per cell {hist.sel_per_cell}, "
                                 f"{srv.deltas.shape[0]} delta rows")
    elif (any(not 1 <= k <= 10 for k in hist.n_selected) if budget
          else hist.n_selected != [10] * rounds):
        raise AssertionError(f"selected per round {hist.n_selected}")
    if fl.predictor != "none" and srv.deltas.shape[0] != fl.n_clients:
        raise AssertionError(f"{srv.deltas.shape[0]} delta rows with the "
                             f"predictor, want {fl.n_clients}")
    if not all(math.isfinite(x) for x in hist.loss + hist.round_time):
        raise AssertionError(f"non-finite loss/round time {hist.loss}")
    if not all(torch.isfinite(p).all() for p in srv.model.parameters()):
        raise AssertionError("non-finite parameters after training")
    if fl.pairing == "hungarian" and fl.selection == "joint":
        # per round: two finishes (the greedy set and the refined one), each
        # one planner and one pairscore launch; the swap search scores
        # 1 + JOINT_SWAP_ITERS sets through pairscore
        want = dict(planner=2 * rounds, pairscore=7 * rounds)
    elif budget and fl.n_cells == 1:
        # the first round's channel-greedy calibration, then per round the
        # admitted set and one re-assembly per loop iteration (one client
        # evicted per iteration)
        want = dict(planner=0, pairscore=1 + sum(1 + e
                                                 for e in hist.n_evicted))
    elif fl.n_cells == 1:
        want = dict(planner=0, pairscore=rounds)
    else:
        want = {}
    # with the predictor, one fedagg for the arrivals' mean and one for
    # the blend a round
    fedagg_want = rounds * (2 if fl.predictor != "none" else 1)
    # a dense model without a window: no attention kernel, forward or
    # backward
    want.update(swa=0, wkv6=0, swa_bwd=0, wkv6_bwd=0)
    if any(counts[k] != v for k, v in want.items()) \
            or counts["fedagg"] != fedagg_want \
            or counts["probe_kernel"] != 1:
        raise AssertionError(f"kernel launches on the {label} path: "
                             f"{counts}")
    RESULT[label] = dict(
        policy=policy, pairing=fl.pairing, selection=fl.selection,
        n_cells=fl.n_cells, model=cfg.name, n_params=n_params,
        dtype=cfg.dtype, rounds=rounds, n_selected=hist.n_selected,
        n_evicted=hist.n_evicted, loss=hist.loss,
        accuracy=hist.accuracy, round_time_sim_s=hist.round_time,
        setup_s=setup_s, wall_s_per_round=list(round_s),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        delta_rows=srv.deltas.shape[0], launches=counts)
    if budget:
        RESULT[label]["t_budget_s"] = srv._auto_budget
    if fl.predictor != "none":
        finite = lambda xs: [x if math.isfinite(x) else None for x in xs]
        RESULT[label].update(predictor=fl.predictor,
                             n_predicted=hist.n_predicted,
                             pred_loss=finite(hist.pred_loss),
                             pred_error=finite(hist.pred_error))
    if fl.n_cells > 1:
        RESULT[label].update(sel_per_cell=hist.sel_per_cell,
                             handovers=hist.handovers)
    log(f"FL {label} path (smollm-135M bf16, 50 clients, 10 slots a cell, "
        f"{policy}, {fl.pairing}/{fl.selection}): {RESULT[label]}")
    return srv, counts


# ---------------------------------------------------------------------------
# phases 11-14: the scenario sampler, the fused Monte-Carlo sweep, the
# seed split and the train CLI
# ---------------------------------------------------------------------------

MC_R, MC_S, MC_N = 16, 64, 128     # benchmarks/scenario_throughput.py:74


def equal_runs(fused, pre, policies, label):
    """Raw arrays bitwise and summaries equal, policy by policy."""
    import numpy as np
    for p in policies:
        if sorted(fused[p]) != sorted(pre[p]):
            raise AssertionError(f"{label}/{p}: keys differ")
        for k in fused[p]:
            if not np.array_equal(fused[p][k], pre[p][k]):
                raise AssertionError(f"{label}/{p}: {k} differs")
        if fused["summary"][p] != pre["summary"][p]:
            raise AssertionError(f"{label}/{p}: summaries differ")


def card_vs_cpu(torch, res, env, fl, ncfg, policies, seed, label):
    """The card's rollout, moved to the CPU, through the CPU engine's
    ``montecarlo_rounds``: integer leaves equal, t_round rtol 1e-5; random
    is left out (its priorities come from the card's generator)."""
    import numpy as np
    from repro_torch.core.engine import WirelessEngine
    cpu = WirelessEngine(ncfg, fl, device="cpu")
    g, ns, cf, cell = (x.cpu() for x in env)
    keys = ("n_selected", "n_evicted", "participation", "final_ages")
    if fl.n_cells > 1:
        keys += ("handovers",)
    for p in policies:
        if p == "random":
            continue
        tb = res["summary"][p]["t_budget_s"] or 0.0
        ref = cpu.montecarlo_rounds(g, ns, cf, res["meta"]["model_bits"],
                                    policy=p, t_budget=tb, seed=seed,
                                    cell_seq=cell if fl.n_cells > 1
                                    else None)
        for k in keys:
            if not np.array_equal(res[p][k], ref[k].numpy()):
                raise AssertionError(f"{label}/{p}: {k} card vs CPU")
        np.testing.assert_allclose(res[p]["t_round"], ref["t_round"].numpy(),
                                   rtol=1e-5, atol=0.0,
                                   err_msg=f"{label}/{p}: t_round")


def phase_scenarios(torch, dev):
    """Every registered scenario through ``run_montecarlo`` with all six
    policies (R=16, S=64, N=128, strong_weak, default NOMAConfig), fused
    and presampled, bitwise; ``first_env`` is round 0 of ``rollout``; the
    card's rollout through the CPU engine. Then n_cells=3 under vehicular
    and pedestrian for age_noma and age_noma_budget, with handovers."""
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.configs.base import POLICIES
    from repro_torch.fl import run_montecarlo
    from repro_torch.sim import SCENARIOS, as_scenario
    r, s, n, seed = MC_R, MC_S, MC_N, 0
    ncfg = NOMAConfig()
    run_montecarlo(ncfg, FLConfig(), n_clients=n, n_seeds=s, rounds=2,
                   policies=("age_noma",), scenario="vehicular",
                   device=dev)                                # warm-up
    cases = [(name, 1, POLICIES) for name in SCENARIOS] + [
        (name, 3, ("age_noma", "age_noma_budget"))
        for name in ("vehicular", "pedestrian")]
    res = {}
    for name, n_cells, policies in cases:
        fl = FLConfig(n_cells=n_cells)
        label = f"{name} C={n_cells}"
        kw = dict(n_clients=n, n_seeds=s, rounds=r, policies=policies,
                  seed=seed, scenario=name, device=dev)
        times = {}
        for presampled in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_montecarlo(ncfg, fl, presampled=presampled, **kw)
            torch.cuda.synchronize()
            times[presampled] = (time.perf_counter() - t0, out)
        (t_f, fused), (t_p, pre) = times[False], times[True]
        equal_runs(fused, pre, policies, label)
        scn = as_scenario(name, ncfg, fl, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env = scn.rollout(seed, r, (s, n))
        torch.cuda.synchronize()
        t_roll = time.perf_counter() - t0
        for a, b in zip(scn.first_env(seed, r, (s, n)), env):
            if not torch.equal(a, b[0]):
                raise AssertionError(f"{label}: first_env is not round 0")
        card_vs_cpu(torch, fused, env, fl, ncfg, policies, seed, label)
        drops = s * r * len(policies)
        summ = fused["summary"]
        res[label] = dict(
            policies=list(policies), fused_s=t_f, presampled_s=t_p,
            # one scenario step (the fused loop takes one a round a policy)
            step_ms=t_roll / r * 1e3,
            fused_drops_per_s=drops / t_f, presampled_drops_per_s=drops / t_p,
            auto_budget_s=summ["age_noma_budget"]["t_budget_s"],
            mean_t_round_s={p: summ[p]["mean_t_round_s"] for p in policies},
            mean_n_evicted=summ["age_noma_budget"]["mean_n_evicted"],
            handover_rate={p: summ[p]["handover_rate"] for p in policies})
        if n_cells > 1 and not all(summ[p]["handover_rate"] > 0
                                   for p in policies):
            raise AssertionError(f"{label}: no handover under mobility")
        log(f"scenario {label} R={r} S={s} N={n}: fused == presampled "
            f"bitwise, first_env == round 0, card == CPU; {res[label]}")
    RESULT["scenarios"] = dict(R=r, S=s, N=n, K=ncfg.n_subchannels, **res)


def phase_scenario_scale(torch, dev):
    """vehicular fused (and presampled) at N=10,000, S=64, R=5, K=128."""
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.fl import run_montecarlo
    r, s, n, k = 5, 64, 10_000, 128
    ncfg = NOMAConfig(n_subchannels=k)
    kw = dict(n_clients=n, n_seeds=s, rounds=r, policies=("age_noma",),
              seed=1, scenario="vehicular", device=dev)
    run_montecarlo(ncfg, FLConfig(), **dict(kw, rounds=1))     # warm-up
    res = {}
    outs = {}
    for presampled in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        outs[presampled] = run_montecarlo(ncfg, FLConfig(),
                                          presampled=presampled, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        tag = "presampled" if presampled else "fused"
        res[tag] = dict(s=sec, drops_per_s=r * s / sec,
                        peak_mem_gib=(torch.cuda.max_memory_allocated(dev)
                                      - base) / 2 ** 30)
    equal_runs(outs[False], outs[True], ("age_noma",), "vehicular N=10,000")
    if not (outs[False]["age_noma"]["n_selected"] == 2 * k).all():
        raise AssertionError("vehicular N=10,000: not c per round")
    RESULT["scenario_scale"] = dict(R=r, S=s, N=n, K=k, **res)
    log(f"scenario vehicular R={r} S={s} N={n} K={k}: {res}")


def phase_shard(torch, dev):
    """``montecarlo_scenario(shard=True)`` on one card equals
    ``shard=False`` bitwise for every policy, and so does the seed split
    over [card, card] (two worker threads on one card)."""
    from repro_torch.configs import FLConfig, NOMAConfig
    from repro_torch.configs.base import POLICIES
    from repro_torch.core import engine as E
    from repro_torch.sim import as_scenario
    ncfg, fl = NOMAConfig(), FLConfig()
    eng = E.WirelessEngine(ncfg, fl, device=dev)
    scn = as_scenario("vehicular", ncfg, fl, device=dev)
    tb = RESULT["scenarios"]["vehicular C=1"]["auto_budget_s"]
    orig = E.shard_devices
    res = {}
    for p in POLICIES:
        kw = dict(rounds=MC_R, n_seeds=MC_S, n_clients=MC_N, model_bits=1e6,
                  policy=p, seed=0,
                  t_budget=tb if p == "age_noma_budget" else 0.0)
        whole = eng.montecarlo_scenario(scn, **kw)
        one = eng.montecarlo_scenario(scn, shard=True, **kw)
        E.shard_devices = lambda d: [dev, dev]
        try:
            t0 = time.perf_counter()
            two = eng.montecarlo_scenario(scn, shard=True, **kw)
            torch.cuda.synchronize()
            res[p] = dict(split_s=time.perf_counter() - t0)
        finally:
            E.shard_devices = orig
        for k in whole:
            if not (torch.equal(whole[k], one[k])
                    and torch.equal(whole[k], two[k])):
                raise AssertionError(f"shard/{p}: {k} differs")
    RESULT["shard"] = dict(devices=torch.cuda.device_count(), **res)
    log(f"shard=True (one card) and the [card, card] split == unsplit, "
        f"bitwise, every policy; {res}")


def phase_train(torch, dev):
    """``repro_torch.launch.train.main`` at the full width of smollm-135M
    (age_noma_budget, 30 clients, 3 rounds each evaluated), every launch
    count set to 0 just before and read just after; the history JSON
    loads as strict JSON, the checkpoint restores bitwise into a fresh
    model (parameters and eval loss), the fl_run ledger's manifest has
    every key."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        return train_checks(torch, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_checks(torch, dev, work: Path) -> dict:
    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.obs import ledger as L
    runs = Path(os.environ["REPRO_RUNS_DIR"])
    before = set(runs.glob("*_fl_run_*")) if runs.exists() else set()
    rounds = 3
    backend.probe.cache_clear()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rec = train.main(["--full-size", "--rounds", str(rounds),
                      "--eval-every", "1", "--ckpt-dir", str(work / "ck"),
                      "--out", str(work / "fl"), "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    srv = rec.pop("server")
    hist = rec["history"]

    def strict(tok):
        raise AssertionError(f"history JSON holds {tok}")

    (out_file,) = (work / "fl").glob("*.json")
    loaded = json.loads(out_file.read_text(), parse_constant=strict)
    if loaded["history"]["n_selected"] != hist["n_selected"]:
        raise AssertionError("history JSON differs from the run")
    n_params = sum(p.numel() for p in srv.model.parameters())
    if n_params != SMOLLM_PARAMS:
        raise AssertionError(f"train model has {n_params} parameters")
    if any(not 1 <= k <= 10 for k in hist["n_selected"]):
        raise AssertionError(f"train selected {hist['n_selected']}")
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"train loss {hist['loss']}")
    want = dict(probe_kernel=1, fedagg=rounds, planner=0, swa=0, wkv6=0,
                swa_bwd=0, wkv6_bwd=0,
                pairscore=1 + sum(1 + e for e in hist["n_evicted"]))
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"train launches {counts}, want {want}")
    acc, loss = srv.evaluate()
    trained = {k: v.clone() for k, v in srv.model.state_dict().items()}
    fresh = zoo.init_model(get_config("smollm_135m"), seed=123, device=dev)
    state, manifest = ckpt.restore(str(work / "ck"), fresh.state_dict())
    fresh.load_state_dict(state)
    for k, v in fresh.state_dict().items():
        if v.dtype != trained[k].dtype or not torch.equal(v, trained[k]):
            raise AssertionError(f"checkpoint leaf {k} differs")
    srv.model = fresh
    if srv.evaluate() != (acc, loss) or manifest["step"] != rounds:
        raise AssertionError("restored model evaluates differently")
    (run_dir,) = set(runs.glob("*_fl_run_*")) - before
    man = json.loads((run_dir / "manifest.json").read_text())
    missing = [k for k in L.MANIFEST_KEYS if k not in man]
    if missing or man["backend"] != "cuda":
        raise AssertionError(f"ledger manifest: missing {missing}, "
                             f"backend {man.get('backend')}")
    events = [json.loads(x) for x in
              (run_dir / "events.jsonl").read_text().splitlines()]
    t_rounds = [e["t_wall_s"] for e in events if e["event"] == "round"]
    RESULT["train"] = dict(
        model="smollm_135m", n_params=n_params, dtype=str(
            next(srv.model.parameters()).dtype), clients=30, rounds=rounds,
        policy="age_noma_budget", wall_s=wall, run_wall_s=rec["wall_s"],
        s_per_round=[b - a for a, b in zip([0.0] + t_rounds, t_rounds)],
        n_selected=hist["n_selected"], n_evicted=hist["n_evicted"],
        loss=hist["loss"], accuracy=hist["accuracy"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        ckpt_bytes=sum(f.stat().st_size for f in (work / "ck").iterdir()),
        launches=counts, ledger_events=len(events))
    log(f"train CLI (smollm-135M full width, age_noma_budget, 30 "
        f"clients): history strict JSON, checkpoint restores bitwise, "
        f"ledger manifest complete; {RESULT['train']}")
    return counts


# ---------------------------------------------------------------------------
# phase 15: the update predictor
# ---------------------------------------------------------------------------

PRED_ROUNDS = 8
PRED_MODES = ("none", "stale", "ann")


def phase_predictor_small(torch, dev):
    """15a: the small FL run (phase 6's config) under each predictor mode,
    6 rounds from one set of initial weights on the card and on the CPU:
    selections and predictions counted alike; losses, pred_error and
    pred_loss to rtol 1e-4; final parameters to atol 1e-5 (the CPU tests'
    tiers). Then ``compare_predictors`` on both devices (each drawing its
    own weights): every mode selects the same clients on both."""
    from repro_torch.configs import FLConfig, NOMAConfig, get_config
    from repro_torch.data import TaskConfig
    from repro_torch.fl import compare_predictors
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **SMALL)
    state = zoo.init_model(cfg, seed=0, device="cpu").state_dict()
    rounds = 6
    res = {}
    for mode in PRED_MODES:
        srv = {d: small_server(d, state, predictor=mode)
               for d in ("cpu", dev)}
        hist = {d: s.run(rounds) for d, s in srv.items()}
        h_card, h_cpu = hist[dev], hist["cpu"]
        name = f"predictor {mode}"
        check_small_fl(h_card, h_cpu, name)
        if h_card.n_predicted != h_cpu.n_predicted:
            raise AssertionError(f"{name}: n_predicted card "
                                 f"{h_card.n_predicted} vs CPU "
                                 f"{h_cpu.n_predicted}")
        for key in ("loss", "pred_error", "pred_loss"):
            for a, b in zip(getattr(h_card, key), getattr(h_cpu, key)):
                if math.isnan(a) != math.isnan(b) or not (
                        math.isnan(a) or math.isclose(a, b, rel_tol=1e-4)):
                    raise AssertionError(f"{name}: {key} card {a} vs CPU "
                                         f"{b}")
        err = max(float((p.detach().float().cpu() - q.detach().float())
                        .abs().max())
                  for p, q in zip(srv[dev].model.parameters(),
                                  srv["cpu"].model.parameters()))
        if err > 1e-5:
            raise AssertionError(f"{name}: final parameters {err} apart")
        if mode != "none" and not (max(h_card.n_predicted) > 0 and any(
                math.isfinite(x) for x in h_card.pred_error)):
            raise AssertionError(f"{name}: no prediction "
                                 f"{h_card.n_predicted}")
        res[mode] = dict(n_predicted=h_card.n_predicted,
                         pred_error=[x if math.isfinite(x) else None
                                     for x in h_card.pred_error],
                         pred_loss=[x if math.isfinite(x) else None
                                    for x in h_card.pred_loss],
                         loss=h_card.loss, params_max_abs_err=err)
    base = res["none"]
    runs = {d: compare_predictors(
        cfg, FLConfig(n_clients=8, local_batch=8, lr=0.2,
                      samples_per_client=(24, 48)),
        NOMAConfig(n_subchannels=2),
        TaskConfig(vocab_size=32, n_topics=4, seq_len=17), rounds=rounds,
        device=d) for d in ("cpu", dev)}
    for m in PRED_MODES:
        check_small_fl(runs[dev][m], runs["cpu"][m], f"compare/{m}",
                       loss=False)
        if not ((runs[dev][m].participation
                 == runs[dev]["none"].participation).all()
                and runs[dev][m].n_predicted == runs["cpu"][m].n_predicted):
            raise AssertionError(f"compare_predictors/{m} is not paired")
    res["compare_predictors"] = {m: runs[dev][m].n_predicted
                                 for m in PRED_MODES}
    RESULT["predictor_small"] = res
    log(f"small FL predictor runs (6 rounds): card == CPU (selections, "
        f"n_predicted; loss, pred_error, pred_loss rtol 1e-4; parameters "
        f"atol 1e-5), compare_predictors paired; none {base['loss']}; "
        f"{res}")


def phase_predictor(torch, dev, kinfo):
    """15b: ``FLServer(predictor="ann")`` at the full width of
    smollm-135M (phase 7's config, ``PRED_ROUNDS`` rounds each evaluated,
    spans on), the launch counts set to 0 just before and read just
    after; then the sketch's time a call and fedagg over the largest blend
    it ran, against its plain version, ``torch.mv`` and its bound."""
    from repro_torch.kernels import fedagg as F
    from repro_torch.obs import trace
    with trace.tracing() as tr:
        srv, counts = phase_main_path(torch, dev, "fl_predictor",
                                      rounds=PRED_ROUNDS, predictor="ann")
    res = RESULT["fl_predictor"]
    n_pred = res["n_predicted"]
    finite_loss = [x for x in res["pred_loss"] if x is not None]
    if n_pred[0] != 0 or min(n_pred[1:]) <= 0 or len(finite_loss) < 2:
        raise AssertionError(f"predictor path: n_predicted {n_pred}, "
                             f"pred_loss {res['pred_loss']}")
    spans = {r["name"]: r for r in trace.summarize(tr.spans)}
    res["spans"] = {k: dict(count=v["count"], total_s=v["total_s"],
                            mean_s=v["mean_s"], max_s=v["max_s"])
                    for k, v in spans.items()}
    pred = srv.predictor
    res["sketch_ms"] = time_ms(torch, lambda: pred.sketch(srv.deltas[0]),
                               reps=3, runs=3)
    res["sketch_device_ms"] = device_ms(
        torch, lambda: pred.sketch(srv.deltas[0]), reps=3)
    # the vector, its buckets (int32) and signs read once; a multiply
    # and an add a coordinate
    p_n = srv.deltas.shape[1]
    res["sketch_bound_ms"], res["sketch_bound_by"] = bound(
        3 * p_n * 4 + pred.embed_dim * 4, 2 * p_n)
    res["store_gib"] = (pred.store.numel() * 4) / 2 ** 30
    # fedagg over the largest blend: the arrivals and M_max predictions
    c = 10 + max(n_pred)
    u = srv.deltas[:c]
    n = u.shape[1]
    w = torch.rand(c, generator=torch.Generator(device=dev).manual_seed(4),
                   device=dev)
    w = w / w.sum()
    out, ref = F.fedagg(u, w), F.fedagg_plain(u, w)
    tol = FEDAGG_TOL["float32"]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    err = max_err(torch, [out], [ref])
    del out, ref
    b_ms, b_by = bound(c * n * 4 + c * 4 + n * 4, 2 * c * n)
    kinfo["fedagg"]["at_predictor_blend_shape"] = blend = dict(
        shape=[c, n], max_abs_err=err,
        ms=time_ms(torch, lambda: F.fedagg(u, w), reps=5, runs=5),
        device_ms=device_ms(torch, lambda: F.fedagg(u, w), reps=5),
        plain_ms=time_ms(torch, lambda: F.fedagg_plain(u, w), reps=2,
                         runs=3),
        library_ms=time_ms(torch, lambda: torch.mv(u.t(), w), reps=5,
                           runs=5),
        library_device_ms=device_ms(torch, lambda: torch.mv(u.t(), w),
                                    reps=5),
        bound_ms=b_ms, bound_by=b_by, tolerance="fp32 1e-6")
    shown = {k: res["spans"][k] for k in ("server.round",
                                           "predictor.observe",
                                           "predictor.predict",
                                           "server.blend")}
    log(f"predictor FL path spans: {shown}; sketch {res['sketch_ms']} ms "
        f"a call ({res['sketch_device_ms']} device, bound "
        f"{res['sketch_bound_ms']}); fedagg {(c, n)} (the blend): {blend}")
    del srv, pred, u
    return counts


def phase_fedagg_rows(torch, dev, srv, kinfo):
    """fedagg over the multi-cell FL path's whole delta buffer (its rows
    are the most clients three cells can select), against its plain
    version and ``torch.mv``."""
    from repro_torch.kernels import fedagg as F
    u = srv.deltas
    c, n = u.shape
    w = torch.rand(c, generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    w = w / w.sum()
    out, ref = F.fedagg(u, w), F.fedagg_plain(u, w)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    b_ms, b_by = bound(c * n * 4 + c * 4 + n * 4, 2 * c * n)
    kinfo["fedagg"]["at_budget_cells_shape"] = res = dict(
        shape=[c, n], max_abs_err=max_err(torch, [out], [ref]),
        ms=time_ms(torch, lambda: F.fedagg(u, w), reps=5, runs=5),
        device_ms=device_ms(torch, lambda: F.fedagg(u, w), reps=5),
        plain_ms=time_ms(torch, lambda: F.fedagg_plain(u, w), reps=2,
                         runs=3),
        library_ms=time_ms(torch, lambda: torch.mv(u.t(), w), reps=5,
                           runs=5),
        library_device_ms=device_ms(torch, lambda: torch.mv(u.t(), w),
                                    reps=5),
        bound_ms=b_ms, bound_by=b_by)
    log(f"fedagg {(c, n)} (the multi-cell delta buffer): {res}")


def phase_profile(torch, srv):
    """Optional (``--profile``), after the main path: one more round under
    the port's tracer, its stages read from the program's fenced spans,
    then one under ``torch.profiler`` for the kernels' device time and the
    device's busy share of the round."""
    from repro_torch.obs import trace
    stages = (("server.select", "schedule"),
              ("client.local_update", "local_sgd"),
              ("server.aggregate", "fedagg"), ("server.apply", "apply"))
    with trace.tracing() as tr:
        t0 = time.perf_counter()
        srv.run_round()
        round_s = time.perf_counter() - t0
    spans: dict = {}
    for name, key in stages:
        hits = [s.duration_s for s in tr.spans if s.name == name]
        if hits:
            spans[key] = sum(hits)
    spans["round"] = round_s
    t0 = time.perf_counter()
    srv.evaluate()
    spans["evaluate"] = time.perf_counter() - t0
    RESULT["profile"] = dict(spans_s=spans,
                             round=profile_call(torch, srv.run_round))
    log(f"profile: {RESULT['profile']}")


# ---------------------------------------------------------------------------
# phases 9-10: the serving path of the hybrid and ssm families
# ---------------------------------------------------------------------------

# Tolerance of the model-level checks, relative to the largest magnitude
# of the compared tensor. A wrong band, softmax, decay or state moves the
# result by the order of that magnitude. Two paths that round the last
# bf16 bit differently drift apart through 32 layers of random weights
# (rwkv6 prefill vs decode in bf16: 1.4e-6 of max at layer 0, 0.26 at
# layer 31), so the checks are held with the same weights in fp32, where
# the same drift stays near 1e-4, and the bf16 errors are reported.
FP32_REL_TOL = 1e-3


def rel_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def profile_call(torch, fn, names=()) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the device's
    kernel time and busy share, the kernels that took most of it, and the
    calls and time of every kernel whose name holds one of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_ms=wall_ms, device_kernel_ms=dev_ms,
                device_busy_share=dev_ms / wall_ms if wall_ms else None,
                kernel_launches=sum(e.count for e in kern),
                top_kernels=[dict(name=e.key[:90], count=e.count,
                                  device_ms=e.self_device_time_total / 1e3)
                             for e in top],
                named_kernels={e.key[:90]: dict(
                    count=e.count, device_ms=e.self_device_time_total / 1e3)
                    for e in kern if any(n in e.key for n in names)})


def release(torch):
    """Return the memory of what the caller has deleted to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_hymba(torch, dev, profile=False):
    """hymba_1_5b at full width in bf16 through ``run_serve`` (B=2, prompt
    4096, 16 tokens) with the launch counts set to 0 just before and read
    just after; then the prefill's last logits against the same prefill
    with the plain attention (``swa_plain``) on the card, in bf16 and
    with the weights cast to fp32."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, swa as SW
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import zoo
    cfg = get_config("hymba_1_5b")
    b, s, gen = 2, 4096, 16
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = zoo.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    kernels.reset_launch_counts()
    res = run_serve(cfg, batch=b, prompt_len=s, gen=gen, seed=0, device=dev,
                    model=model)
    counts = kernels.launch_counts()
    if counts["swa"] != cfg.n_layers or counts["wkv6"] != 0 \
            or counts["swa_bwd"] != 0 or counts["wkv6_bwd"] != 0:
        raise AssertionError(f"hymba serve launches: {counts}")
    toks = res["tokens"]
    if toks.shape != (b, gen) or not ((toks >= 0)
                                      & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"hymba generated {toks}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device=dev)
    prefill = zoo.make_prefill_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del cache
    if profile:
        RESULT["hymba_1_5b_profile"] = dict(
            prefill=profile_call(torch, lambda: prefill(
                model, {"tokens": prompt}), names=("swa",)),
            decode_step=profile_call(torch, lambda: zoo.make_serve_step(cfg)(
                model, zoo.init_cache(cfg, b, s + gen, device=dev),
                prompt[:, 0], 0)))
        log(f"hymba profile: {RESULT['hymba_1_5b_profile']}")
    if not (bool(torch.isfinite(last).all())
            and last.shape == (b, cfg.padded_vocab)):
        raise AssertionError("hymba prefill logits not finite or misshaped")
    nv = cfg.vocab_size                 # the padded columns hold -1e9

    def plain_prefill():
        saved = ops.swa
        ops.swa = lambda q, k, v, *, window, softcap=0.0, prefix=0: \
            SW.swa_plain(q, k, v, window=window, softcap=softcap,
                         prefix=prefix)
        try:
            return prefill(model, {"tokens": prompt})[0]
        finally:
            ops.swa = saved

    errs = {"bf16": rel_err(torch, last[:, :nv], plain_prefill()[:, :nv])}
    model.float()                       # the same weights in fp32
    errs["fp32"] = rel_err(torch,
                           prefill(model, {"tokens": prompt})[0][:, :nv],
                           plain_prefill()[:, :nv])
    if not errs["fp32"] <= FP32_REL_TOL:
        raise AssertionError(f"hymba fp32 last logits, kernel vs plain "
                             f"attention: relative max err {errs['fp32']} > "
                             f"{FP32_REL_TOL}")
    RESULT["hymba_1_5b"] = dict(
        n_params=n_params, dtype=cfg.dtype, batch=b, prompt=s, gen=gen,
        window=cfg.long_context_window, setup_s=setup_s,
        serve_prefill_ms=res["prefill_s"] * 1e3, prefill_ms=prefill_ms,
        decode_ms=res["decode_s"] * 1e3,
        decode_tokens_per_s=res["decode_tokens_per_s"],
        peak_mem_gib=peak, launches=counts,
        logits_rel_err_vs_plain_attention=errs,
        logits_rel_tolerance=dict(fp32=FP32_REL_TOL,
                                  bf16="reported, not held"),
        tokens=toks.tolist())
    log(f"hymba_1_5b serve (B={b}, prompt {s}, {gen} tokens): "
        f"{RESULT['hymba_1_5b']}")
    del model, last
    release(torch)
    return counts


def phase_rwkv(torch, dev, profile=False):
    """rwkv6_7b at full width in bf16: ``make_prefill_step`` at B=1, T=4096
    with the launch counts set to 0 just before and read just after;
    ``run_serve``; then at T=256 the prefill's states and last logits
    against 256 decode steps from an empty cache (the plain one-token
    recurrence, so the kernel's s_T is held against an independent path),
    in bf16 (reported) and with the weights cast to fp32 (held)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import zoo
    cfg = get_config("rwkv6_7b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = zoo.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 4096)), device=dev)
    prefill = zoo.make_prefill_step(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    last, cache = prefill(model, {"tokens": toks})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    if counts["wkv6"] != cfg.n_layers or counts["swa"] != 0 \
            or counts["swa_bwd"] != 0 or counts["wkv6_bwd"] != 0:
        raise AssertionError(f"rwkv6 prefill launches: {counts}")
    if not bool(torch.isfinite(last).all()) or not all(
            bool(torch.isfinite(v).all()) for v in cache.values()):
        raise AssertionError("rwkv6 prefill: non-finite logits or states")
    del last, cache
    t0 = time.perf_counter()
    last, cache = prefill(model, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del last, cache
    if profile:
        RESULT["rwkv6_7b_profile"] = dict(
            prefill=profile_call(torch, lambda: prefill(
                model, {"tokens": toks}), names=("wkv6",)),
            decode_step=profile_call(torch, lambda: zoo.make_serve_step(cfg)(
                model, zoo.init_cache(cfg, 1, 1, device=dev), toks[:, 0],
                0)))
        log(f"rwkv6 profile: {RESULT['rwkv6_7b_profile']}")

    res = run_serve(cfg, batch=1, prompt_len=64, gen=16, seed=0, device=dev,
                    model=model)
    if res["tokens"].shape != (1, 16):
        raise AssertionError(f"rwkv6 generated {res['tokens']}")

    t = 256

    def prefill_vs_decode(dtype):
        """Relative max errors of the prefill's states and last logits
        against t decode steps from an empty cache."""
        c = dataclasses.replace(cfg, dtype=dtype)
        last, pcache = zoo.make_prefill_step(c)(model,
                                                {"tokens": toks[:, :t]})
        serve = zoo.make_serve_step(c)
        cache = zoo.init_cache(c, 1, t, device=dev)
        for i in range(t):
            _, logits, cache = serve(model, cache, toks[:, i], i)
        out = {name: rel_err(torch, pcache[name], cache[name])
               for name in ("wkv", "tm_shift", "cm_shift")}
        out["wkv_per_layer"] = [rel_err(torch, a, b) for a, b in
                                zip(pcache["wkv"], cache["wkv"])]
        out["last_logits"] = rel_err(torch, last, logits)
        return out

    errs = {"bf16": prefill_vs_decode("bfloat16")}
    model.float()                       # the same weights in fp32
    errs["fp32"] = prefill_vs_decode("float32")
    bad = {k: v for k, v in errs["fp32"].items()
           if k != "wkv_per_layer" and not v <= FP32_REL_TOL}
    if bad:
        raise AssertionError(f"rwkv6 fp32 prefill vs {t} decode steps, "
                             f"relative max err above {FP32_REL_TOL}: {bad}")
    RESULT["rwkv6_7b"] = dict(
        n_params=n_params, dtype=cfg.dtype, setup_s=setup_s,
        prefill_T=4096, prefill_first_ms=first_ms, prefill_ms=prefill_ms,
        peak_mem_gib=peak, launches=counts,
        prefill_vs_decode_T=t, prefill_vs_decode_rel_err=errs,
        rel_tolerance=dict(fp32=FP32_REL_TOL, bf16="reported, not held"),
        serve_prompt=64, serve_gen=16,
        serve_prompt_ms=res["prefill_s"] * 1e3,
        serve_decode_ms=res["decode_s"] * 1e3,
        decode_tokens_per_s=res["decode_tokens_per_s"],
        tokens=res["tokens"].tolist())
    log(f"rwkv6_7b (B=1, T=4096 prefill; serve 64 + 16): "
        f"{RESULT['rwkv6_7b']}")
    del model
    release(torch)
    return counts


# ---------------------------------------------------------------------------
# phases 16-19: the moe family and the head_dim-128 decoders
# ---------------------------------------------------------------------------

LONG_T = 16_384          # the windowed prefill: twice the 8192 window
SERVE_PROMPT, SERVE_GEN = 4096, 16


def layer0_hook(model):
    """Keep layer 0's attention inputs to the kernel: q, k, v (post RoPE),
    the window and the prefix. A decoder's: a forward hook on layer 0's
    attention, which also keeps its (projected) output. An encdec's
    (its decoder self-attention calls ``layers.flash_attention`` itself):
    the first call of ``ops.swa``, and its output. Returns (record, the
    callable that removes the hook)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    got: dict = {}
    if not hasattr(model, "blocks"):
        real = ops.swa

        def first(q, k, v, *, window, softcap=0.0, prefix=0):
            out = real(q, k, v, window=window, softcap=softcap,
                       prefix=prefix)
            if not got:
                got.update(q=q, k=k, v=v, attn=out, window=window,
                           prefix=prefix)
            return out

        ops.swa = first
        return got, lambda: setattr(ops, "swa", real)

    def hook(mod, args, kwargs, out):
        h, cos, sin = args
        q = L.apply_rope(mod.qkv_proj(h)[0], cos, sin, mod.cfg.rope_frac)
        got.update(q=q, k=out[1][0], v=out[1][1], out=out[0],
                   window=kwargs["window"],
                   prefix=kwargs.get("prefix_len", 0))

    return got, model.blocks[0].attn.register_forward_hook(
        hook, with_kwargs=True).remove


def check_layer0(torch, model, got, softcap) -> dict:
    """The kernel on layer 0's captured q, k, v: it reproduces the model's
    attention output bitwise (projected, for a decoder); against
    ``swa_plain`` (head by head) within phase 2's bf16 tolerances."""
    from repro_torch.kernels import swa as SW
    q, k, v, w, p = (got[n] for n in ("q", "k", "v", "window", "prefix"))
    out = SW.swa(q, k, v, window=w, softcap=softcap, prefix=p)
    same = bool(torch.equal(out, got["attn"]) if "attn" in got else
                torch.equal(model.blocks[0].attn.out_proj(out), got["out"]))
    ref = swa_plain_by_head(torch, q, k, v, window=w, softcap=softcap,
                            prefix=p)
    err, tol, rows = (max_err(torch, [out], [ref]), bf16_ulp(ref),
                      row_ulps(torch, out, ref))
    if not (same and err <= tol and rows <= SWA_ROW_ULPS["bfloat16"]):
        raise AssertionError(
            f"layer 0 swa {tuple(q.shape)} W={w} P={p}: the model's output "
            f"reproduced {same}; max abs err {err} (tolerance {tol}), worst "
            f"row {rows} bf16 ulps (held at {SWA_ROW_ULPS['bfloat16']})")
    return dict(shape=list(q.shape), window=w, prefix=p,
                model_output_reproduced=same, max_abs_err=err,
                tolerance=tol, worst_row_ulps=rows)


def model_inputs(torch, dev, cfg, t: int, seed: int, batch: int = 1) -> dict:
    """A batch of ``t`` positions for ``cfg`` from ``default_rng(seed)``:
    random tokens, then a vlm's image prefix (its ``n_prefix_tokens`` of
    the ``t``) or an encdec's encoder frames."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pref = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    out = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (batch, t - pref)), device=dev)}
    if cfg.family in ("vlm", "encdec"):
        out["prefix" if cfg.family == "vlm" else "frames"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.n_prefix_tokens,
                                 cfg.prefix_dim)),
            dtype=getattr(torch, cfg.dtype), device=dev)
    return out


def serve_whole(torch, dev, model, cfg) -> dict:
    """``run_serve`` at B=1, a 4096-token prompt and 16 greedy tokens
    (window 0: the chunked attention), launch counts set to 0 just before
    and read just after."""
    from repro_torch import kernels
    from repro_torch.launch.serve import run_serve
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    res = run_serve(cfg, batch=1, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                    seed=0, device=dev, model=model)
    counts = kernels.launch_counts()
    toks = res["tokens"]
    if toks.shape != (1, SERVE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all() \
            or any(counts.values()):
        raise AssertionError(f"{cfg.name} serve: tokens {toks}, launches "
                             f"{counts}")
    return dict(batch=1, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                prefill_ms=res["prefill_s"] * 1e3,
                decode_ms=res["decode_s"] * 1e3,
                decode_tokens_per_s=res["decode_tokens_per_s"],
                peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                launches=counts, tokens=toks.tolist())


def windowed_prefill(torch, dev, model, cfg) -> tuple[dict, dict]:
    """``make_prefill_step(cfg, window=cfg.long_context_window)`` at B=1,
    T=16,384 (a vlm's image prefix among them; an encdec's 512 frames
    beside them), launch counts set to 0 just before and read just after:
    one swa launch a (decoder) layer, finite logits and cache, and layer
    0's kernel output held against the plain version. A second, timed
    run."""
    from repro_torch import kernels
    from repro_torch.models import zoo
    w = cfg.long_context_window
    prefill = zoo.make_prefill_step(cfg, window=w)
    batch = model_inputs(torch, dev, cfg, LONG_T, 1)
    got, remove = layer0_hook(model)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        last, cache = prefill(model, batch)
        torch.cuda.synchronize()
    finally:
        remove()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = dict.fromkeys(counts, 0) | {"swa": cfg.n_layers}
    if counts != want:
        raise AssertionError(f"{cfg.name} windowed prefill launches "
                             f"{counts}, want {want}")
    if not (bool(torch.isfinite(last).all()) and all(
            bool(torch.isfinite(cache[n]).all()) for n in ("k", "v"))):
        raise AssertionError(f"{cfg.name} windowed prefill: non-finite "
                             f"logits or cache")
    cache_gib = sum(cache[n].numel() * cache[n].element_size()
                    for n in cache) / 2 ** 30
    del last, cache
    layer0 = check_layer0(torch, model, got, cfg.logit_softcap)
    got.clear()
    t0 = time.perf_counter()
    last, cache = prefill(model, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del last, cache
    return dict(T=LONG_T, window=w, first_ms=first_ms, ms=ms,
                peak_mem_gib=peak, cache_gib=cache_gib, launches=counts,
                layer0_swa=layer0), counts


def fp32_two_layers(torch, dev, cfg) -> dict:
    """The config cut to 2 layers at full width in fp32: the windowed
    prefill's last logits with the kernel (``swa_fp32``) against the same
    prefill with the plain attention (head by head), within
    FP32_REL_TOL of their largest magnitude."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    c2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = zoo.init_model(c2, seed=0, device=dev)
    prefill = zoo.make_prefill_step(c2, window=c2.long_context_window)
    toks = model_inputs(torch, dev, c2, LONG_T, 2)
    last = prefill(model, toks)[0]
    saved = ops.swa
    ops.swa = lambda q, k, v, *, window, softcap=0.0, prefix=0: \
        swa_plain_by_head(torch, q, k, v, window=window, softcap=softcap,
                          prefix=prefix)
    try:
        ref = prefill(model, toks)[0]
    finally:
        ops.swa = saved
    nv = c2.vocab_size
    err = rel_err(torch, last[:, :nv], ref[:, :nv])
    if not (bool(torch.isfinite(last).all()) and err <= FP32_REL_TOL):
        raise AssertionError(f"{cfg.name} 2 layers fp32: last logits, "
                             f"kernel vs plain attention, relative max err "
                             f"{err} > {FP32_REL_TOL}")
    del model
    release(torch)
    return dict(n_layers=2, dtype="float32", T=LONG_T,
                window=c2.long_context_window,
                logits_rel_err_vs_plain_attention=err,
                rel_tolerance=FP32_REL_TOL)


def expected_params(cfg) -> int:
    """``param_count()`` plus what it leaves out: the norms, the qkv
    biases, the padded vocabulary rows and the input projection of a vlm's
    prefix (``prefix_proj``) or an encdec's frames (``frontend_proj``)."""
    d = cfg.d_model
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * cfg.qkv_bias
    pad = (cfg.padded_vocab - cfg.vocab_size) * d
    if cfg.family == "encdec":
        return (cfg.param_count()
                + (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2) * d
                + (cfg.n_enc_layers + 2 * cfg.n_layers) * bias + 2 * pad
                + cfg.prefix_dim * d)
    return (cfg.param_count() + (2 * cfg.n_layers + 1) * d
            + cfg.n_layers * bias + pad * (1 if cfg.tie_embeddings else 2)
            + (cfg.prefix_dim * d if cfg.n_prefix_tokens else 0))


def phase_decoder(torch, dev, arch, *, windowed: bool,
                  fp32_check: bool = False,
                  profile: bool = False) -> Optional[dict]:
    """``arch`` whole at full width in bf16 from seeded weights: serving
    (``serve_whole``), then with ``windowed`` the T=16,384 windowed
    prefill, and with ``fp32_check`` the 2-layer fp32 check; with
    ``profile``, one traced prefill (the windowed one where there is one,
    else the serve path's 4096 tokens) and one traced decode step. Returns
    the windowed prefill's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = zoo.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != expected_params(cfg):
        raise AssertionError(f"{arch} has {n_params} parameters, "
                             f"param_count() {cfg.param_count()}")
    rec = dict(n_params=n_params, dtype=cfg.dtype, setup_s=setup_s,
               weights_gib=sum(p.numel() * p.element_size()
                               for p in model.parameters()) / 2 ** 30,
               serve=serve_whole(torch, dev, model, cfg))
    counts = None
    if windowed:
        rec["windowed_prefill"], counts = windowed_prefill(torch, dev, model,
                                                           cfg)
    if profile:
        rec["profile"] = profile_decoder(torch, dev, model, cfg, windowed)
    del model
    release(torch)
    if fp32_check:
        rec["fp32_2_layers"] = fp32_two_layers(torch, dev, cfg)
    RESULT[arch] = rec
    log(f"{arch} whole ({n_params} parameters, {cfg.dtype}): {rec}")
    return counts


def profile_decoder(torch, dev, model, cfg, windowed: bool) -> dict:
    """One prefill and one decode step under ``torch.profiler``; with
    ``windowed``, also the serve path's unwindowed prefill of 4096 text
    tokens (the chunked attention)."""
    from repro_torch.models import zoo
    t = LONG_T if windowed else SERVE_PROMPT
    prefill = zoo.make_prefill_step(
        cfg, window=cfg.long_context_window if windowed else 0)
    batch = model_inputs(torch, dev, cfg, t, 1)
    toks = batch["tokens"]
    out = dict(prefill_T=t, prefill=profile_call(
        torch, lambda: prefill(model, batch), names=("swa",)))
    if windowed:
        full = zoo.make_prefill_step(cfg)
        pref = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        short = model_inputs(torch, dev, cfg, pref + SERVE_PROMPT, 1)
        out["prefill_unwindowed"] = profile_call(
            torch, lambda: full(model, short))
    cache = zoo.init_cache(cfg, 1, SERVE_PROMPT + SERVE_GEN, device=dev)
    step = zoo.make_serve_step(cfg)
    step(model, cache, toks[:, 0], 0)
    out["decode_step"] = profile_call(
        torch, lambda: step(model, cache, toks[:, 1], 1))
    log(f"{cfg.name} profile: {out}")
    return out


def phase_reduced_moe(torch, dev):
    """grok_1_314b and llama4_maverick_400b_a17b (589.5 and 1,449.5 GiB in
    bf16: no one card holds them) reduced, in fp32, card against CPU from
    the same weights: the windowed prefill (S=300 past the reduced 256
    window; grok's softcap 30 in the kernel) and the full one, 4 decode
    steps from the prefill's cache, and ``run_serve``'s tokens."""
    out = {arch: reduced_card_vs_cpu(torch, dev, arch)
           for arch in ("grok_1_314b", "llama4_maverick_400b_a17b")}
    RESULT["reduced_moe"] = out
    log(f"grok and llama4 reduced, fp32, card == CPU: {out}")


def reduced_card_vs_cpu(torch, dev, arch) -> dict:
    """``arch`` reduced, in fp32, card against CPU from the same weights:
    the windowed prefill (300 text positions past the reduced 256 window,
    after a vlm's 8-token prefix or beside an encdec's 8 frames) and the
    full one, 4 decode steps from the prefill's cache, and ``run_serve``'s
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import zoo
    cfg = get_config(arch).reduced()
    pref = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    models = {"cpu": zoo.init_model(cfg, seed=0, device="cpu")}
    models[dev] = zoo.init_model(cfg, seed=0, device=dev)
    models[dev].load_state_dict(models["cpu"].state_dict())
    errs = {}
    for w in (0, cfg.long_context_window):
        res = {}
        for d, m in models.items():
            batch = model_inputs(torch, d, cfg, pref + 300, 3, batch=2)
            last, cache = zoo.make_prefill_step(cfg, window=w)(m, batch)
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
        errs[f"window {w}"] = e = [rel_err(torch, a, b) for a, b in
                                   zip(res[dev], res["cpu"])]
        if not max(e) <= 1e-4:
            raise AssertionError(f"{arch} reduced, window {w}: card vs CPU "
                                 f"relative max err (logits, k, v) {e}")
    served = {d: run_serve(cfg, batch=2, prompt_len=40, gen=6, seed=0,
                           device=d, model=m)["tokens"]
              for d, m in models.items()}
    if not (served[dev] == served["cpu"]).all():
        raise AssertionError(f"{arch} reduced run_serve tokens: card "
                             f"{served[dev]} vs CPU {served['cpu']}")
    return dict(rel_err_logits_k_v=errs, rel_tolerance=1e-4,
                tokens=served[dev].tolist())


# The train CLI's round at its default lr 0.3 amplifies rounding for the
# hybrid and ssm families: there the card's losses land ~1e-3 of
# themselves from the CPU's, past phase 15a's tiers, though both run the
# same arithmetic in another order. The witness is the same round on the
# card with the plain versions in the kernels' place (``plain_kernels``):
# its gap from the CPU is the card's rounding alone, amplified alike. At
# the CLI's defaults the kernels' gap from the CPU is held to
# FL_WITNESS_FACTOR times the witness's (never below the tiers), so that
# a gross fault of a kernel still fails there; the tiers themselves are
# held at FL_KERNEL_LR, where the card and the CPU stay an ulp or two
# apart.
FL_KERNEL_LR = "0.0003"
FL_WITNESS_FACTOR = 4.0


@contextlib.contextmanager
def plain_kernels():
    """``ops.swa`` and ``ops.wkv6`` take their plain versions on every
    device, as they do for CPU tensors: the model path on the card with
    no swa or wkv6 kernel, the witness of the card's own rounding."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa as SW
    from repro_torch.kernels import wkv6 as WK
    saved = ops.swa, ops.wkv6

    def swa(q, k, v, *, window, softcap=0.0, prefix=0):
        return SW.swa_plain(q, k, v, window=window, softcap=softcap,
                            prefix=prefix)

    def wkv6(r, k, v, w_log, u, s0=None, *, chunk=WK.CHUNK):
        return WK.wkv6_plain(r, k, v, w_log, u, s0, chunk=chunk)

    ops.swa, ops.wkv6 = swa, wkv6
    try:
        yield
    finally:
        ops.swa, ops.wkv6 = saved


@contextlib.contextmanager
def one_cpu_thread(torch):
    """PyTorch's CPU ops on one thread inside the block, the count
    restored after: a reduction split over threads adds its parts in an
    order that follows the threads' schedule."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def fl_cli_card_vs_cpu(torch, dev, arch: str, label: str) -> dict:
    """``launch.train.main(["--arch", arch, ...])`` at the reference CLI's
    reduced config (age_noma_budget, 30 clients, 3 rounds each evaluated),
    on the card with every launch count set to 0 just before and read just
    after. Against the CPU, both from the same CPU draw of the weights:
    selections and evictions equal, losses rtol 1e-4, final parameters
    atol 1e-5 (phase 15a's tiers). For a hybrid or ssm model the counted
    run is at the CLI's defaults, where its gap from the CPU (the mean of
    the rounds' loss gaps, the largest parameter gap) is held to
    FL_WITNESS_FACTOR times that of the same round on the card through
    ``plain_kernels`` (and never below the tiers), and the tiers are held
    at ``--lr`` FL_KERNEL_LR. The CPU runs take one thread
    (``one_cpu_thread``), so that their sums, like the card's, add in
    one order from run to run. Launches: probe 1,
    fedagg 3, planner 0, pairscore 1 + sum(1 + n_evicted); a hybrid
    model's local SGD steps through swa and swa_bwd, an ssm one's through
    wkv6 and wkv6_bwd (once a layer a step; the evaluations launch the
    forward once a layer more), every other kernel 0."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    from repro_torch.launch import train
    from repro_torch.models import zoo
    init = zoo.init_model

    def cpu_drawn(cfg, *, seed=0, device="cuda"):
        return init(cfg, seed=seed, device="cpu").to(
            backend.resolve_device(device))

    def apart(a, b) -> dict:
        """Per-round loss gaps and the largest parameter gap of two runs."""
        return dict(loss=[abs(x - y) for x, y in zip(
            a["history"]["loss"], b["history"]["loss"])],
            params=max(float((p.detach().float().cpu()
                              - q.detach().float().cpu()).abs().max())
                       for p, q in zip(a["server"].model.parameters(),
                                       b["server"].model.parameters())))

    work = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{label}_"))
    argv = ["--arch", arch, "--rounds", "3", "--eval-every", "1", "--out",
            str(work)]
    kernel_family = get_config(arch).family in ("hybrid", "ssm")
    slow = ["--lr", FL_KERNEL_LR] if kernel_family else []
    zoo.init_model = cpu_drawn
    try:
        backend.probe.cache_clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = train.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        with one_cpu_thread(torch):
            cpu_default = train.main(argv + ["--device", "cpu"])
        if kernel_family:
            kernels.reset_launch_counts()
            with plain_kernels():
                plain = train.main(argv + ["--device", str(dev)])
            torch.cuda.synchronize()
            plain_counts = kernels.launch_counts()
            if plain_counts["swa"] + plain_counts["wkv6"] + plain_counts[
                    "swa_bwd"] + plain_counts["wkv6_bwd"]:
                raise AssertionError(f"{arch} FL witness launched "
                                     f"{plain_counts}")
            card_slow = train.main(argv + slow + ["--device", str(dev)])
            with one_cpu_thread(torch):
                cpu = train.main(argv + slow + ["--device", "cpu"])
        else:
            plain, card_slow, cpu = None, card, cpu_default
    finally:
        zoo.init_model = init
        shutil.rmtree(work, ignore_errors=True)
    h_card, h_cpu = card_slow["history"], cpu["history"]
    for run in (card, cpu_default, card_slow, plain or card):
        for key in ("n_selected", "n_evicted", "participation"):
            if run["history"][key] != h_cpu[key]:
                raise AssertionError(f"{arch} FL {key}: {run['history'][key]}"
                                     f" vs CPU {h_cpu[key]}")
    loss_tol = [1e-4 * abs(b) for b in h_cpu["loss"]]
    gap = apart(card_slow, cpu)
    if not all(g <= t for g, t in zip(gap["loss"], loss_tol)):
        raise AssertionError(f"{arch} FL loss card {h_card['loss']} vs CPU "
                             f"{h_cpu['loss']} (tolerance {loss_tol})")
    if gap["params"] > 1e-5:
        raise AssertionError(f"{arch} FL final parameters {gap['params']} "
                             f"apart")
    default_lr = None
    if kernel_family:
        # the kernels at the CLI's own lr, against the witness
        default_lr = dict(
            gap=apart(card, cpu_default), witness=apart(plain, cpu_default),
            kernels_vs_witness=apart(card, plain),
            factor=FL_WITNESS_FACTOR)
        w, g = default_lr["witness"], default_lr["gap"]
        default_lr["limit"] = limit = dict(
            mean_loss=max(FL_WITNESS_FACTOR * statistics.fmean(w["loss"]),
                          1e-4 * max(abs(x) for x in
                                     cpu_default["history"]["loss"])),
            params=max(FL_WITNESS_FACTOR * w["params"], 1e-5))
        if not (statistics.fmean(g["loss"]) <= limit["mean_loss"]
                and g["params"] <= limit["params"]):
            raise AssertionError(f"{arch} FL at the CLI's lr: card {g} from "
                                 f"the CPU, past {limit} ({FL_WITNESS_FACTOR}"
                                 f" x the plain path's {w})")
    cfg = card["server"].cfg
    want = dict.fromkeys(counts, 0) | dict(
        probe_kernel=1, fedagg=3,
        pairscore=1 + sum(1 + e for e in card["history"]["n_evicted"]))
    kernel = {"hybrid": "swa", "ssm": "wkv6"}.get(cfg.family)
    if kernel:
        # local SGD steps (forward and backward) and the evaluations'
        # forwards, each once a layer
        n_bwd, n_fwd = counts[f"{kernel}_bwd"], counts[kernel]
        if not (n_bwd > 0 and n_bwd % cfg.n_layers == 0 and n_fwd > n_bwd
                and (n_fwd - n_bwd) % cfg.n_layers == 0):
            raise AssertionError(f"{arch} FL launches {counts}")
        want.update({kernel: n_fwd, f"{kernel}_bwd": n_bwd})
    if counts != want or (label == "moe_fl") != cfg.is_moe:
        raise AssertionError(f"{arch} FL launches {counts}, want {want}")
    RESULT[label] = dict(
        arch=arch, config=dict(
            family=cfg.family, d_model=cfg.d_model, d_ff=cfg.d_ff,
            n_layers=cfg.n_layers, n_experts=cfg.n_experts,
            top_k=cfg.top_k, vocab_size=cfg.vocab_size),
        n_params=sum(p.numel() for p in card["server"].model.parameters()),
        wall_s=wall, n_selected=h_card["n_selected"],
        n_evicted=h_card["n_evicted"], loss_default_lr=card["history"]
        ["loss"], default_lr=default_lr,
        compared_lr=FL_KERNEL_LR if kernel_family else "default",
        loss=h_card["loss"], loss_cpu=h_cpu["loss"], loss_gap=gap["loss"],
        loss_tolerance=loss_tol, params_max_abs_err=gap["params"],
        launches=counts)
    log(f"{arch} FL round (train CLI, reduced): card == CPU (selections, "
        f"loss rtol 1e-4, parameters atol 1e-5"
        f"{'; at the default lr within the witness limit' if plain else ''}"
        f"); {RESULT[label]}")
    return counts


TRAIN_ARCH = "stablelm_1_6b"
TRAIN_B, TRAIN_S, TRAIN_MICRO, TRAIN_STEPS = 8, 2048, 4, 3
TRAIN_PARAMS = 1_644_414_976
PREFILL_TS = (4096, LONG_T)
# reduced steps card against CPU: name -> (arch, config overrides, window).
# The first four take no kernel (window 0: the chunked attention); hymba
# (its window), rwkv6 and the windowed three train through swa or wkv6 and
# their backward kernels. capacity_factor 8 keeps every token in its
# experts, so that a near tie of the router cannot drop one on one side.
REDUCED_TRAIN = {
    "stablelm_1_6b": ("stablelm_1_6b", {}, 0),
    "paligemma_3b": ("paligemma_3b", {}, 0),
    "seamless_m4t_medium": ("seamless_m4t_medium", {}, 0),
    "moonshot_v1_16b_a3b": ("moonshot_v1_16b_a3b",
                            {"capacity_factor": 8.0}, 0),
    "hymba_1_5b": ("hymba_1_5b", {}, 0),
    "rwkv6_7b": ("rwkv6_7b", {}, 0),
    "stablelm_1_6b window 8": ("stablelm_1_6b", {}, 8),
    "paligemma_3b window 64": ("paligemma_3b", {}, 64),
    "grok_1_314b window 64": ("grok_1_314b", {"capacity_factor": 8.0}, 64)}
REDUCED_TRAIN_S, REDUCED_TRAIN_LR = 1280, 1e-2


def train_batch(torch, dev, cfg, b: int, s: int, seed: int) -> dict:
    """``model_inputs`` of s + 1 positions cut into tokens and next-token
    labels (a few -1, ignored), with a non-uniform ``weight``."""
    import numpy as np
    pref = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    batch = model_inputs(torch, dev, cfg, pref + s + 1, seed, batch=b)
    toks = batch.pop("tokens")
    labels = toks[:, 1:].clone()
    labels[:, ::7] = -1
    w = np.linspace(0.5, 2.0, b)
    return batch | {"tokens": toks[:, :-1], "labels": labels,
                    "weight": torch.as_tensor(w, dtype=torch.float32,
                                              device=dev)}


def attention_on_card(torch, dev) -> dict:
    """The chunked path against ``direct_attention`` on the card at
    stablelm's (1, 4096, 32, 64) heads, causal: fp32 within 2e-5, bf16
    within one bf16 rounding of the fp32 direct result."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 4096, 32, 64), generator=gen, device=dev)
               for _ in range(3))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dt) for x in (q, k, v))
        got = layers.chunked_attention(qd, kd, vd, cfg)
        want = layers.direct_attention(qd.float(), kd.float(), vd.float(),
                                       cfg)
        err = float((got.float() - want).abs().max())
        tol = 2e-5 if dt == torch.float32 else 2.0 ** -8 * float(
            want.abs().max())
        if not err <= tol:
            raise AssertionError(f"chunked attention {dt} on the card: max "
                                 f"abs err {err} > {tol} vs direct")
        out[str(dt).split(".")[-1]] = dict(max_abs_err=err, tolerance=tol)
    return out


def long_prefills(torch, dev, model, cfg) -> dict:
    """``make_prefill_step(cfg)`` (window 0: the chunked attention) at B=1
    and each of PREFILL_TS, launch counts set to 0 just before and read
    just after (no kernel on this path): finite logits and cache, peak
    GiB, a first and a timed second run."""
    from repro_torch import kernels
    from repro_torch.models import zoo
    prefill = zoo.make_prefill_step(cfg)
    out = {}
    for t in PREFILL_TS:
        batch = model_inputs(torch, dev, cfg, t, 4)
        release(torch)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        last, cache = prefill(model, batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if any(counts.values()) or not (
                bool(torch.isfinite(last).all())
                and all(bool(torch.isfinite(cache[n]).all())
                        for n in ("k", "v"))):
            raise AssertionError(f"{cfg.name} prefill T={t}: launches "
                                 f"{counts}, or non-finite logits or cache")
        del last, cache
        t0 = time.perf_counter()
        last, cache = prefill(model, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        del last, cache
        out[f"T={t}"] = dict(first_ms=first_ms, ms=ms, peak_mem_gib=peak,
                             launches=counts)
        log(f"{cfg.name} unwindowed prefill B=1, T={t} (chunked "
            f"attention): {ms:.1f} ms (first {first_ms:.1f}), peak "
            f"{peak:.2f} GiB")
    return out


def full_width_train(torch, dev, model, cfg, profile: bool) -> tuple:
    """``make_train_step(lr=1e-3, microbatches=4, remat=True)`` at B=8,
    S=2048 for TRAIN_STEPS steps, launch counts set to 0 just before and
    read just after: finite loss, grad_norm > 0, the weights moved, peak
    under the card's 80 GB."""
    from repro_torch import kernels
    from repro_torch.models import zoo
    step = zoo.make_train_step(cfg, lr=1e-3, microbatches=TRAIN_MICRO,
                               remat=True)
    batch = train_batch(torch, dev, cfg, TRAIN_B, TRAIN_S, 6)
    before = model.embed.detach()[:64].float().clone()
    release(torch)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    secs, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(model, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({n: float(v) for n, v in m.items()})
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    moved = float((model.embed.detach()[:64].float() - before).abs().max())
    if not (all(math.isfinite(x["loss"]) and x["grad_norm"] > 0
                and math.isfinite(x["grad_norm"]) for x in metrics)
            and moved > 0 and peak < 80 and not any(counts.values())):
        raise AssertionError(f"{cfg.name} train step: {metrics}, moved "
                             f"{moved}, peak {peak} GiB, launches {counts}")
    s_step = statistics.median(secs[1:])
    rec = dict(batch=TRAIN_B, seq=TRAIN_S, microbatches=TRAIN_MICRO,
               remat=True, lr=1e-3, steps=TRAIN_STEPS, step_s=secs,
               s_per_step=s_step,
               tokens_per_s=TRAIN_B * TRAIN_S / s_step,
               loss=[x["loss"] for x in metrics],
               grad_norm=[x["grad_norm"] for x in metrics],
               peak_gib=peak, launches=counts)
    if profile:
        rec["profile"] = profile_call(torch, lambda: step(model, batch))
    log(f"{cfg.name} train step at full width (B={TRAIN_B}, S={TRAIN_S}, "
        f"{TRAIN_MICRO} microbatches, remat): s_per_step {s_step:.3f}, "
        f"tokens_per_s {rec['tokens_per_s']:.0f}, loss {rec['loss']}, "
        f"grad_norm {rec['grad_norm']}, peak_gib {peak:.2f}")
    return rec, counts


def train_launches_want(cfg, window: int, steps: int, micro: int,
                        remat: bool, counts: dict) -> dict:
    """The launch counts of ``steps`` train steps: swa (hybrid, or a
    window) or wkv6 (ssm) once a layer a microbatch forward, once more
    under remat (the backward recomputes each layer), and its backward
    once a layer a microbatch; every other kernel 0."""
    kernel = ("wkv6" if cfg.family == "ssm" else "swa"
              if cfg.family == "hybrid" or window > 0 else None)
    want = dict.fromkeys(counts, 0)
    if kernel:
        n = steps * micro * cfg.n_layers
        want[kernel] = n * (2 if remat else 1)
        want[f"{kernel}_bwd"] = n
    return want


def reduced_train_card_vs_cpu(torch, dev, arch, over: dict,
                              window: int = 0) -> dict:
    """One ``make_train_step(window=window)`` step of ``arch`` reduced,
    fp32, 2 microbatches with remat, at S=1280 (window 0: the chunked
    attention in 640-row blocks, 644 for paligemma's 8-token prefix: the
    running softmax crosses KV blocks and the backward recomputes several
    Q blocks; hymba, rwkv6 and a window: swa or wkv6 and their backward
    kernels), on the card with the launch counts set to 0 just before and
    read just after, and on the CPU, from the same weights: loss and
    grad_norm rtol 1e-4, every updated parameter atol 1e-6 (the CPU
    tests')."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    models = {"cpu": zoo.init_model(cfg, seed=0, device="cpu")}
    models[dev] = zoo.init_model(cfg, seed=0, device=dev)
    models[dev].load_state_dict(models["cpu"].state_dict())
    step = zoo.make_train_step(cfg, lr=REDUCED_TRAIN_LR, microbatches=2,
                               remat=True, window=window)
    metrics = {}
    for d, m in models.items():
        batch = train_batch(torch, "cpu", cfg, 4, REDUCED_TRAIN_S, 8)
        kernels.reset_launch_counts()
        metrics[d] = {n: float(v) for n, v in step(
            m, {n: x.to(d) for n, x in batch.items()}).items()}
        if d == dev:
            counts = kernels.launch_counts()
    want = train_launches_want(cfg, window, 1, 2, True, counts)
    err = max(float((p.detach().cpu() - q.detach()).abs().max())
              for p, q in zip(models[dev].parameters(),
                              models["cpu"].parameters()))
    card, cpu = metrics[dev], metrics["cpu"]
    if not (err <= 1e-6 and all(math.isclose(card[n], cpu[n], rel_tol=1e-4)
                                for n in cpu) and counts == want):
        raise AssertionError(f"{arch} reduced train step, window {window}: "
                             f"card {card} vs CPU {cpu}, parameters {err} "
                             f"apart, launches {counts} (want {want})")
    return dict(window=window, card=card, cpu=cpu, params_max_abs_err=err,
                launches=counts,
                tolerance=dict(loss_grad_norm_rtol=1e-4, params_atol=1e-6))


# the families that train through the backward kernels at their published
# widths: (B, S, microbatches). S = 4096 lets hymba's 2,048 window bite;
# the reference's policy is 4 microbatches of a global batch of 256, cut to
# B = 2 in 2 (rwkv6: weights, fp32 accumulator and gradients ~61 GB)
KERNEL_TRAIN = {"hymba_1_5b": (2, 4096, 2), "rwkv6_7b": (2, 4096, 2)}
KERNEL_TRAIN_STEPS = 2           # after a warm-up step


def full_width_kernel_train(torch, dev, arch: str,
                            profile: bool) -> tuple[dict, dict]:
    """``arch`` whole in bf16: ``make_train_step(lr=1e-3, microbatches,
    remat=True)`` at KERNEL_TRAIN's (B, S), a warm-up step, then
    KERNEL_TRAIN_STEPS steps with the launch counts set to 0 just before
    and read just after (``train_launches_want``: swa or wkv6 and its
    backward): finite loss, grad_norm > 0, the weights moved, peak under
    the card's 80 GB."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = get_config(arch)
    b, s, micro = KERNEL_TRAIN[arch]
    torch.cuda.reset_peak_memory_stats(dev)
    model = zoo.init_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = zoo.make_train_step(cfg, lr=1e-3, microbatches=micro, remat=True)
    batch = train_batch(torch, dev, cfg, b, s, 7)
    before = model.embed.detach()[:64].float().clone()
    t0 = time.perf_counter()
    warm = {n: float(v) for n, v in step(model, batch).items()}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    secs, metrics = [], []
    for _ in range(KERNEL_TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(model, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({n: float(v) for n, v in m.items()})
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    moved = float((model.embed.detach()[:64].float() - before).abs().max())
    want = train_launches_want(cfg, 0, KERNEL_TRAIN_STEPS, micro, True,
                               counts)
    if not (all(math.isfinite(x["loss"]) and x["grad_norm"] > 0
                and math.isfinite(x["grad_norm"]) for x in metrics)
            and moved > 0 and peak < 80 and counts == want):
        raise AssertionError(f"{arch} train step: {metrics}, moved {moved}, "
                             f"peak {peak} GiB, launches {counts} (want "
                             f"{want})")
    s_step = statistics.median(secs)
    rec = dict(arch=arch, n_params=n_params, dtype=cfg.dtype, batch=b,
               seq=s, microbatches=micro, remat=True, lr=1e-3,
               warmup=dict(s=first_s, **warm), steps=KERNEL_TRAIN_STEPS,
               step_s=secs, s_per_step=s_step, tokens_per_s=b * s / s_step,
               loss=[x["loss"] for x in metrics],
               grad_norm=[x["grad_norm"] for x in metrics], peak_gib=peak,
               launches=counts)
    if profile:
        # the device time of the model's kernels, forward and backward,
        # by name (swa, swa_bwd_* or wkv6_*, wkv6_bwd_*)
        rec["profile"] = profile_call(
            torch, lambda: step(model, batch),
            names=("swa",) if cfg.family == "hybrid" else ("wkv6",))
    del model, step, batch
    release(torch)
    log(f"{arch} train step at full width (B={b}, S={s}, {micro} "
        f"microbatches, remat): s_per_step {s_step:.3f}, tokens_per_s "
        f"{rec['tokens_per_s']:.0f}, loss {rec['loss']}, grad_norm "
        f"{rec['grad_norm']}, peak_gib {peak:.2f}, launches {counts}")
    return rec, counts


def phase_train_step(torch, dev, profile: bool = False) -> dict:
    """22. The train step: stablelm_1_6b whole in bf16, its unwindowed
    prefills (``long_prefills``) and the full-width step
    (``full_width_train``); the chunked attention against the direct one
    on the card; the reduced families card against CPU, hymba, rwkv6 and
    three windowed models among them through the backward kernels.
    Returns the full-width step's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = get_config(TRAIN_ARCH)
    model = zoo.init_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{TRAIN_ARCH} has {n_params} parameters")
    rec = dict(arch=TRAIN_ARCH, n_params=n_params, dtype=cfg.dtype,
               prefill=long_prefills(torch, dev, model, cfg))
    rec["train"], counts = full_width_train(torch, dev, model, cfg, profile)
    del model
    release(torch)
    rec["attention_on_card"] = attention_on_card(torch, dev)
    rec["reduced_card_vs_cpu"] = {
        name: reduced_train_card_vs_cpu(torch, dev, arch, over, window)
        for name, (arch, over, window) in REDUCED_TRAIN.items()}
    RESULT["train_step"] = rec
    log(f"train step phase: chunked attention on the card "
        f"{rec['attention_on_card']}; reduced card == CPU "
        f"{rec['reduced_card_vs_cpu']}")
    release(torch)
    return counts


def phase_kernel_train(torch, dev, profile: bool = False) -> dict:
    """23. Training through the backward kernels: hymba_1_5b and rwkv6_7b
    whole (``full_width_kernel_train``), then the FL round of each through
    the train CLI, reduced, card against CPU (``fl_cli_card_vs_cpu``).
    Returns the launch counts by path."""
    out = {}
    for arch in KERNEL_TRAIN:
        RESULT.setdefault("kernel_train", {})[arch], out[f"{arch} train"] = \
            full_width_kernel_train(torch, dev, arch, profile)
    for arch in KERNEL_TRAIN:
        out[f"{arch} fl"] = fl_cli_card_vs_cpu(torch, dev, arch,
                                               f"fl_{arch}")
        release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 24: the dry-run tools on the card
# ---------------------------------------------------------------------------

# arch -> (B, S, microbatches): phase 22's and 23's train steps
DRYRUN_CARD = {TRAIN_ARCH: (TRAIN_B, TRAIN_S, TRAIN_MICRO), **KERNEL_TRAIN}
# the custom ops each family's step must count through their formulas
DRYRUN_OPS = {"hybrid": ("repro_torch.swa_fwd", "repro_torch.swa_bwd"),
              "ssm": ("repro_torch.wkv6_fwd", "repro_torch.wkv6_bwd")}
PREDICTION_FACTOR = 2.0       # predicted argument + temp bytes against peak


def counted_step(torch, dev, arch: str, b: int, s: int, micro: int) -> dict:
    """One real train step of ``arch`` whole on the card (the dry run's
    step: ``make_train_step(lr=1e-3, microbatches, remat)``, int32 tokens
    and labels as ``zoo.batch_shapes`` has them) under FlopCounterMode and
    OpBytesMode: its FLOPs by op, op bytes and peak allocated bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as RL
    from repro_torch.models import zoo
    cfg = get_config(arch)
    model = zoo.init_model(cfg, seed=0, device=dev)
    step = zoo.make_train_step(cfg, lr=1e-3, microbatches=micro)
    batch = {k: v.to(torch.int32) if k in ("tokens", "labels") else v
             for k, v in train_batch(torch, dev, cfg, b, s, 8).items()}
    release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    fc, ob = FlopCounterMode(display=False), RL.OpBytesMode()
    t0 = time.perf_counter()
    with fc, ob:
        m = step(model, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = dict(flops=fc.get_total_flops(), op_bytes=ob.total,
               by_op={str(k): v for k, v in
                      fc.get_flop_counts()["Global"].items()},
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               counted_step_s=secs, loss=float(m["loss"]))
    if not math.isfinite(out["loss"]):
        raise AssertionError(f"{arch} counted step: loss {out['loss']}")
    del model, step, batch, m
    release(torch)
    return out


def ring_on_card(torch, dev) -> dict:
    """``ring_flash_attention`` on a one-rank NCCL group ((1, 1) mesh)
    against ``flash_attention`` in fp32 at the reference test's shape
    (reduced llama4 with 5 heads, 1 KV head, hd 16; B=4, S=64), and
    reduced smollm's ring prefill (its last logits all-gathered over the
    sequence group) against its prefill; the group is torn down after."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import zoo
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(
            get_config("llama4_maverick_400b_a17b").reduced(), n_heads=5,
            n_kv_heads=1, head_dim=16)
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((4, 64, h, 16), generator=gen, device=dev)
                   for h in (5, 1, 1))
        ring = L.Ring(mesh, "data", "model")
        spec = ("batch", "seq", None, None)
        got = L.ring_flash_attention(
            *(ring.shard(t, spec) for t in (q, k, v)), cfg, mesh,
            batch_axis="data", seq_axis="model").full_tensor()
        err = float((got - L.flash_attention(q, k, v, cfg)).abs().max())
        small = get_config("smollm_135m").reduced()
        model = zoo.init_model(small, seed=1, device=dev)
        batch = model_inputs(torch, dev, small, 64, 9, batch=4)
        want, cache = zoo.make_prefill_step(small)(model, batch)
        logits, rcache = zoo.make_prefill_step(
            small, ring=(mesh, "data", "model"))(model, batch)
        scale = max(1.0, float(want.abs().max()))
        prefill_err = float((logits.full_tensor() - want).abs().max())
        cache_err = max(float((rcache[n].full_tensor().float()
                               - c.float()).abs().max()) for n, c in
                        cache.items())
    finally:
        dist.destroy_process_group()
    if not (err <= 1e-5 and prefill_err <= 1e-5 * scale
            and cache_err <= 1e-5 * scale):
        raise AssertionError(f"ring on the card: attention err {err}, "
                             f"prefill {prefill_err}, cache {cache_err} "
                             f"(tol 1e-5, x {scale} for the prefill)")
    return dict(attention_max_abs_err=err, prefill_max_abs_err=prefill_err,
                cache_max_abs_err=cache_err, tolerance=1e-5,
                prefill_scale=scale, backend="nccl", world_size=1)


def production_dryrun(torch) -> dict:
    """``python -m repro_torch.launch.dryrun --arch smollm_135m --shape
    train_4k`` in a subprocess: the fake 256-rank group, its (16, 16)
    mesh and the FLOP formulas on the fake card. Returns its record and
    its printed line."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "smollm_135m", "--shape", "train_4k", "--out", out],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=os.environ | {"PYTHONPATH": str(ROOT / "src")})
        if proc.returncode != 0:
            raise AssertionError(f"the production dry run exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        rec = json.loads((Path(out) / "smollm_135m__train_4k__single.json")
                         .read_text())
    line = [x for x in proc.stdout.splitlines() if x.startswith("[dryrun]")]
    if not (rec["ok"] and rec["device"] == "cuda" and rec["chips"] == 256
            and rec["hlo_flops"] > 0 and rec["collective_bytes"] > 0
            and line):
        raise AssertionError(f"the production dry run's record: {rec}")
    return dict(record=rec, line=line[0])


def phase_dryrun(torch, dev) -> dict:
    """24. The dry run against the card (see the module docstring)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.launch.roofline import PEAK_BF16_S
    step_s = {TRAIN_ARCH: RESULT["train_step"]["train"]["s_per_step"],
              **{a: RESULT["kernel_train"][a]["s_per_step"]
                 for a in KERNEL_TRAIN}}
    out = {}
    for arch, (b, s, micro) in DRYRUN_CARD.items():
        t0 = time.perf_counter()
        rec = dryrun_one(arch, ShapeConfig(f"card_b{b}_s{s}", s, b, "train"),
                         mesh=(1, 1), device="cuda",
                         variant={"micro": micro}, verbose=False)
        trace_s = time.perf_counter() - t0
        card = counted_step(torch, dev, arch, b, s, micro)
        predicted = rec["argument_bytes_per_dev"] + rec["temp_bytes_per_dev"]
        ratio = predicted / card["peak_bytes"]
        ops = DRYRUN_OPS.get(get_config(arch).family, ())
        share = card["flops"] / step_s[arch] / PEAK_BF16_S
        res = dict(batch=b, seq=s, microbatches=micro, trace_s=trace_s,
                   fake_flops=rec["traced_flops"],
                   fake_op_bytes=rec["traced_op_bytes"],
                   card_flops=card["flops"], card_op_bytes=card["op_bytes"],
                   card_flops_by_op=card["by_op"],
                   predicted_bytes=predicted,
                   argument_bytes=rec["argument_bytes_per_dev"],
                   temp_bytes=rec["temp_bytes_per_dev"],
                   peak_bytes=card["peak_bytes"], predicted_over_peak=ratio,
                   s_per_step=step_s[arch], bf16_peak_share=share,
                   counted_step_s=card["counted_step_s"], loss=card["loss"])
        out[arch] = res
        log(f"dry run against the card, {arch} train (B={b}, S={s}, "
            f"{micro} microbatches): FLOPs fake {rec['traced_flops']} card "
            f"{card['flops']}, op bytes fake {rec['traced_op_bytes']} card "
            f"{card['op_bytes']}; predicted argument + temp "
            f"{predicted / 2 ** 30:.3f} GiB, max_memory_allocated "
            f"{card['peak_bytes'] / 2 ** 30:.3f} GiB (ratio {ratio:.3f}); "
            f"FLOPs / {step_s[arch]:.3f} s a step / 989e12 = {share:.4f}")
        if not (rec["traced_flops"] == card["flops"]
                and rec["traced_op_bytes"] == card["op_bytes"]
                and all(card["by_op"].get(op, 0) > 0 for op in ops)
                and 1 / PREDICTION_FACTOR <= ratio <= PREDICTION_FACTOR):
            raise AssertionError(f"dry run against the card, {arch}: {res}")
    prod = production_dryrun(torch)
    log(f"production dry run: {prod['line']}")
    ring = ring_on_card(torch, dev)
    log(f"ring on the card (one-rank NCCL group): {ring}")
    RESULT["dryrun"] = dict(card=out, production=prod, ring=ring)
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port (src/repro_torch) is not beside "
              f"{Path(__file__).name}; run it from the repository root",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the run ledgers go to a directory of this run's own
    runs_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    os.environ["REPRO_RUNS_DIR"] = runs_dir
    try:
        return run_phases(torch)
    finally:
        shutil.rmtree(runs_dir, ignore_errors=True)


def run_phases(torch) -> int:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load()
    RESULT["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {RESULT['build_s']:.2f} s -> "
        f"{build.BuildInfo.path.name}")
    RESULT["ptxas"] = ptxas_report(build.BuildInfo.log)
    for entry, lines in RESULT["ptxas"].items():
        for line in lines:
            log(f"ptxas: {entry}: {line}")

    kinfo: dict = {}
    # seconds a phase (or group), for the script's time budget
    laps, last = RESULT.setdefault("phase_s", {}), [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now
        log(f"phase {name}: {laps[name]:.1f} s")

    phase_probe(torch, dev, kinfo)
    phase_pairscore(torch, dev, kinfo)
    phase_fedagg(torch, dev, kinfo)
    phase_planner(torch, dev, kinfo)
    phase_swa(torch, dev, kinfo)
    phase_wkv6(torch, dev, kinfo)
    lap("2 forward kernels")
    phase_swa_bwd(torch, dev, kinfo)
    lap("2 swa_bwd")
    phase_wkv6_bwd(torch, dev, kinfo)
    lap("2 wkv6_bwd")
    torch.cuda.empty_cache()
    phase_engine(torch, dev)
    phase_policies(torch, dev)
    phase_montecarlo(torch, dev)
    phase_budget_engine(torch, dev)
    phase_budget_montecarlo(torch, dev)
    phase_scenarios(torch, dev)
    phase_scenario_scale(torch, dev)
    phase_shard(torch, dev)
    lap("3-5, 6a, 6b, 11-13")
    release(torch)
    phase_small_fl(torch, dev)
    srv, _ = phase_main_path(torch, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, srv)
    del srv
    gc.collect()            # the timed run_round closure keeps a cycle
    torch.cuda.empty_cache()
    srv, fl_counts = phase_main_path(torch, dev, "fl_hungarian_joint",
                                     pairing="hungarian", selection="joint")
    del srv
    release(torch)
    srv, budget_counts = phase_main_path(torch, dev, "fl_budget",
                                         policy="age_noma_budget")
    del srv
    release(torch)
    srv, cells_counts = phase_main_path(torch, dev, "fl_budget_cells",
                                        policy="age_noma_budget", rounds=2,
                                        n_cells=3)
    phase_fedagg_rows(torch, dev, srv, kinfo)
    lap("6-8")
    del srv
    release(torch)
    train_counts = phase_train(torch, dev)
    lap("14")
    release(torch)
    phase_predictor_small(torch, dev)
    predictor_counts = phase_predictor(torch, dev, kinfo)
    lap("15")
    release(torch)
    profile = "--profile" in sys.argv[1:]
    hymba_counts = phase_hymba(torch, dev, profile)
    lap("9")
    rwkv_counts = phase_rwkv(torch, dev, profile)
    lap("10")
    moonshot_counts = phase_decoder(torch, dev, "moonshot_v1_16b_a3b",
                                    windowed=True, fp32_check=True,
                                    profile=profile)
    chatglm_counts = phase_decoder(torch, dev, "chatglm3_6b", windowed=True,
                                   profile=profile)
    phase_decoder(torch, dev, "stablelm_1_6b", windowed=False,
                  profile=profile)
    lap("16-17")
    phase_reduced_moe(torch, dev)
    moe_fl_counts = fl_cli_card_vs_cpu(torch, dev, "moonshot_v1_16b_a3b",
                                       "moe_fl")
    lap("18-19")
    release(torch)
    pali_counts = phase_decoder(torch, dev, "paligemma_3b", windowed=True,
                                fp32_check=True, profile=profile)
    seamless_counts = phase_decoder(torch, dev, "seamless_m4t_medium",
                                    windowed=True, profile=profile)
    out = {arch: reduced_card_vs_cpu(torch, dev, arch)
           for arch in ("paligemma_3b", "seamless_m4t_medium")}
    RESULT["reduced_vlm_encdec"] = out
    log(f"paligemma and seamless reduced, fp32, card == CPU: {out}")
    lap("20-21")
    release(torch)
    train_step_counts = phase_train_step(torch, dev, profile)
    lap("22")
    kernel_train_counts = phase_kernel_train(torch, dev, profile)
    lap("23")
    phase_dryrun(torch, dev)
    lap("24")

    fl_path = f"FLServer smollm-135M, hungarian + joint, {FL_ROUNDS} rounds"
    paths = {
        "probe_kernel": ("src/repro_torch/csrc/probe.cu",
                         "src/repro/kernels/backend.py:59", fl_counts,
                         fl_path),
        "pairscore": ("src/repro_torch/csrc/pairscore.cu",
                      "src/repro/kernels/pairscore.py:75", fl_counts,
                      fl_path),
        "fedagg": ("src/repro_torch/csrc/fedagg.cu",
                   "src/repro/kernels/fedagg.py:24", fl_counts, fl_path),
        "planner": ("src/repro_torch/csrc/planner.cu",
                    "src/repro/kernels/planner.py:47", fl_counts, fl_path),
        "swa": ("src/repro_torch/csrc/swa.cu",
                "src/repro/kernels/swa.py:27", hymba_counts,
                "run_serve hymba_1_5b bf16, B=2, prompt 4096, 16 tokens"),
        "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                 "src/repro/kernels/wkv6.py:36", rwkv_counts,
                 "make_prefill_step rwkv6_7b bf16, B=1, T=4096"),
        "swa_bwd": ("src/repro_torch/csrc/swa_bwd.cu",
                    "src/repro/models/layers.py:214",
                    kernel_train_counts["hymba_1_5b train"],
                    f"make_train_step hymba_1_5b bf16, B=2, S=4096, 2 "
                    f"microbatches, remat, {KERNEL_TRAIN_STEPS} steps"),
        "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu",
                     "src/repro/models/rwkv.py:80",
                     kernel_train_counts["rwkv6_7b train"],
                     f"make_train_step rwkv6_7b bf16, B=2, S=4096, 2 "
                     f"microbatches, remat, {KERNEL_TRAIN_STEPS} steps")}
    # the backward kernels replace no TPU kernel: the reference takes these
    # gradients by JAX's autodiff of the jnp function at "replaces"
    kinfo["swa_bwd"]["replaces_note"] = kinfo["wkv6_bwd"]["replaces_note"] = (
        "no Pallas kernel: jax autodiff of the reference's jnp function")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "launches_path": path,
         "launches_budget_fl": budget_counts[name],
         "launches_budget_cells_fl": cells_counts[name],
         "launches_train": train_counts[name],
         "launches_predictor_fl": predictor_counts[name],
         "launches_moe_fl": moe_fl_counts[name],
         "launches_moonshot_prefill": moonshot_counts[name],
         "launches_chatglm3_prefill": chatglm_counts[name],
         "launches_paligemma_prefill": pali_counts[name],
         "launches_seamless_prefill": seamless_counts[name],
         "launches_train_step": train_step_counts[name],
         **{f"launches_{key.replace(' ', '_')}": c[name]
            for key, c in kernel_train_counts.items()}, **kinfo[name]}
        for name, (src, rep, counts, path) in paths.items()]}
    RESULT.update(card=smi, kernels=line["kernels"],
                  script_s=time.perf_counter() - t_start)
    log(f"all phases passed in {RESULT['script_s']:.1f} s")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(
        json.dumps(RESULT, indent=1, allow_nan=False))
    print(json.dumps(line, allow_nan=False), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
