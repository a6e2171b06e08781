"""The port's dry run (launch/dryrun.py, launch/roofline.py) and the
kernels' custom ops: the ops' fake outputs and FLOP formulas, a fake
trace of a step against the real step on the CPU, the depth and
microbatch extension against a full trace, the collective model term by
term, ``dryrun_one`` on reduced models over a fake world of 8 and 256,
and the analytic helpers and ``build_roofline`` against the reference's.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices when imported,
so its functions run in one subprocess (``reference_values``)."""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.kernels import swa as SW
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import fake_world
from repro_torch.models import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = zoo.MeshInfo(axis_names=("data", "model"),
                    axis_sizes={"data": 1, "model": 1})
SD = zoo.ShapeDtype


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------


def test_custom_ops_fake_outputs_are_the_plain_versions():
    """Under FakeTensorMode each ``repro_torch::`` op gives its plain
    version's output shapes and dtypes (the forward's lse that of
    ``swa_lse_plain``, wkv6's chunk states (B, H, ceil(T/64), C, C))."""
    b, s, h, kh, hd, t, c = 2, 70, 4, 2, 16, 100, 16
    real = dict(q=torch.randn(b, s, h, hd), k=torch.randn(b, s, kh, hd),
                r=torch.randn(b, 2, t, c), u=torch.randn(2, c))
    band = dict(window=8, softcap=0.0, prefix=3)
    want = {
        "swa": (SW.swa_plain(real["q"], real["k"], real["k"], **band),
                SW.swa_lse_plain(real["q"], real["k"], real["k"], **band)),
        "swa_bwd": SW.swa_bwd_plain(real["q"], real["k"], real["k"],
                                    real["q"], **band),
        "wkv6": WK.wkv6_plain(*(real["r"],) * 4, real["u"]),
        "wkv6_bwd": WK.wkv6_bwd_plain(*(real["r"],) * 4, real["u"], None,
                                      real["r"], None)}
    for dtype in (torch.float32, torch.bfloat16):
        conv = {k: v.to(dtype) if k != "u" else v for k, v in real.items()}
        with FakeTensorMode() as mode:
            f = {k: mode.from_tensor(v) for k, v in conv.items()}
            q, k, r, u = f["q"], f["k"], f["r"], f["u"]
            out, lse = torch.ops.repro_torch.swa_fwd(q, k, k, 8, 0.0, 3,
                                                     True)
            _, no_lse = torch.ops.repro_torch.swa_fwd(q, k, k, 8, 0.0, 3,
                                                      False)
            grads = torch.ops.repro_torch.swa_bwd(q, k, k, q, out, lse, 8,
                                                  0.0, 3)
            w_log = r.float()
            fwd = torch.ops.repro_torch.wkv6_fwd(r, r, r, w_log, u, None, 64)
            bwd = torch.ops.repro_torch.wkv6_bwd(r, r, r, w_log, u, w_log,
                                                 None, fwd[2], 64)
        assert (out.shape, lse.shape) == (want["swa"][0].shape,
                                          want["swa"][1].shape)
        assert out.dtype == dtype and lse.dtype == torch.float32
        assert no_lse.numel() == 0
        for g, w in zip(grads, want["swa_bwd"]):
            assert g.shape == w.shape and g.dtype == dtype
        for o, w in zip(fwd[:2], want["wkv6"]):
            assert o.shape == w.shape and o.dtype == torch.float32
        assert fwd[2].shape == (b, 2, -(-t // 64), c, c)
        for i, (g, w) in enumerate(zip(bwd, want["wkv6_bwd"])):
            assert g.shape == w.shape
            assert g.dtype == (dtype if i < 3 else torch.float32)


def test_flop_formulas_are_the_bounds_operations():
    """The ops count exactly the operations the kernels' bounds price
    (PERF.md section 6): swa 4 hd a band pair and query head, swa_bwd 10
    hd, wkv6 5 C^2 a step and head, wkv6_bwd 14 C^2. hymba's (1, 4096,
    25, 5, 64) at W=2048 has 157,312,000 pairs."""
    assert SW.band_pairs(4096, 2048) * 25 == 157_312_000
    for s, w, p in [(1, 1, 0), (70, 8, 3), (100, 200, 0), (64, 16, 64),
                    (33, 5, 40)]:
        brute = sum(min(i + 1, w) for i in range(s))
        brute += min(p, s) * (min(p, s) - 1) // 2
        assert SW.band_pairs(s, w, p) == brute
    with FakeTensorMode():
        q = torch.empty(1, 4096, 25, 64, dtype=torch.bfloat16)
        k = torch.empty(1, 4096, 5, 64, dtype=torch.bfloat16)
        r = torch.empty(1, 64, 4096, 64, dtype=torch.bfloat16)
        u = torch.empty(64, 64)
        with FlopCounterMode(display=False) as fc:
            out, lse = torch.ops.repro_torch.swa_fwd(q, k, k, 2048, 0.0, 0,
                                                     True)
            torch.ops.repro_torch.swa_bwd(q, k, k, q, out, lse, 2048, 0.0,
                                          0)
            states = torch.ops.repro_torch.wkv6_fwd(r, r, r, r.float(), u,
                                                    None, 128)[2]
            torch.ops.repro_torch.wkv6_bwd(r, r, r, r.float(), u,
                                           r.float(), None, states, 128)
    got = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert got == {"repro_torch.swa_fwd": 4 * 64 * 157_312_000,
                   "repro_torch.swa_bwd": 10 * 64 * 157_312_000,
                   "repro_torch.wkv6_fwd": 5 * 64 * 64 * 4096 * 64,
                   "repro_torch.wkv6_bwd": 14 * 64 * 64 * 4096 * 64}


# ---------------------------------------------------------------------------
# the trace: fake against real, and the depth/microbatch extension
# ---------------------------------------------------------------------------


def _reduced(arch, **over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


@pytest.mark.parametrize("arch,kind", [
    ("smollm_135m", "train"), ("moonshot_v1_16b_a3b", "train"),
    ("hymba_1_5b", "train"), ("rwkv6_7b", "train"),
    ("seamless_m4t_medium", "train"), ("paligemma_3b", "prefill"),
    ("grok_1_314b", "decode")])
def test_fake_trace_counts_the_real_step(arch, kind):
    """On the CPU route, the dry run's counters over a fake-traced reduced
    step give exactly the FLOPs and op bytes of the same step on real
    tensors (train with 2 microbatches, prefill, decode): nothing in the
    step's program depends on the data."""
    cfg = _reduced(arch)
    shape = ShapeConfig("t", 16, 4, kind)
    counts = []
    for fake in (True, False):
        with FakeTensorMode() if fake else contextlib.nullcontext():
            model, run = D._step_runner(
                cfg, shape, device="cpu", rows=4,
                micro=2 if kind == "train" else 1,
                accum_dtype=torch.float32, cache_len=16, ring=None)
            if not fake:
                with torch.no_grad():
                    g = torch.Generator().manual_seed(0)
                    for p in model.parameters():
                        p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            c = D._trace(run, model, cfg, HOST, zoo.policy_for(cfg),
                         comm=False)
        counts.append((c["flops"], c["bytes"]))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


@pytest.mark.parametrize("arch,kind,micro", [
    ("smollm_135m", "train", 4), ("seamless_m4t_medium", "prefill", 1),
    ("moonshot_v1_16b_a3b", "train", 2), ("hymba_1_5b", "prefill", 1),
    ("rwkv6_7b", "decode", 1)])
def test_depth_and_microbatch_extension_is_a_full_trace(arch, kind, micro):
    """``dryrun_one``'s counts from its depth-1/2 (and 2/3-microbatch)
    traces equal one trace of the whole step (3 layers a stack, ``micro``
    microbatches), exactly."""
    cfg = _reduced(arch, n_layers=3, vocab_size=64)
    if cfg.n_enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=3)
    shape = ShapeConfig("t", 8, 12, kind)
    rec = D.dryrun_one(arch, shape, cfg=cfg, mesh=(1, 1), device="cpu",
                       variant={"micro": micro} if kind == "train" else None,
                       verbose=False)
    assert rec["micro"] == micro
    with fake_world(1), FakeTensorMode():
        model, run = D._step_runner(
            cfg, shape, device="cpu", rows=12, micro=micro,
            accum_dtype=torch.float32, cache_len=8, ring=None)
        full = D._trace(run, model, cfg, HOST, zoo.policy_for(cfg),
                        comm=False)
    assert rec["traced_flops"] == full["flops"]
    assert rec["traced_op_bytes"] == full["bytes"]
    assert rec["hlo_flops"] == full["flops"]          # one rank: no share


# ---------------------------------------------------------------------------
# dryrun_one over fake worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm_135m", "grok_1_314b", "rwkv6_7b",
                                  "hymba_1_5b", "seamless_m4t_medium"])
def test_dryrun_one_on_a_fake_world_of_8(arch):
    """The reference's small-mesh case (vocab 64, a (2, 4) mesh, 8 rows of
    64, 2 microbatches): every record is ok, the train step's FLOPs and
    collective bytes are positive, and it is sharded: the per-device
    FLOPs are below the traced (full-width) ones."""
    cfg = _reduced(arch, vocab_size=64)
    rec = D.dryrun_one(arch, ShapeConfig("t", 64, 8, "train"), cfg=cfg,
                       mesh=(2, 4), device="cpu", variant={"micro": 2},
                       verbose=False)
    assert rec["ok"] and rec["chips"] == 8 and rec["micro"] == 2
    assert rec["hlo_flops"] > 0 and rec["collective_bytes"] > 0
    assert rec["hlo_flops"] < rec["traced_flops"]
    assert rec["temp_bytes_per_dev"] > 0
    assert rec["argument_bytes_per_dev"] > 0


@pytest.mark.parametrize("arch", ["smollm_135m", "moonshot_v1_16b_a3b"])
def test_ring_term_is_what_comm_debug_mode_counts(arch):
    """At world 256 ((16, 16) mesh) the ring prefill's traced permutes
    (``permute_tensor`` is an ``all_to_all_single``) are the collective
    model's ring_permute count: 2 (n_ring - 1) a layer; its other
    gathers (the last logits, the MoE's counts) are its ring_* terms."""
    cfg = _reduced(arch, vocab_size=64)
    rec = D.dryrun_one(arch, ShapeConfig("p", 64, 16, "prefill"), cfg=cfg,
                       device="cpu", variant={"ring_attn": True},
                       verbose=False)
    terms = {t["name"]: t for t in rec["collective_terms"]}
    comm = rec["comm_counts"]
    assert terms["ring_permute"]["times"] == 2 * 15 * cfg.n_layers
    assert comm["c10d_functional.all_to_all_single"] == \
        terms["ring_permute"]["times"]
    gathers = terms["ring_logits"]["times"] + (
        terms["ring_moe_counts"]["times"] if cfg.is_moe else 0)
    assert comm["c10d_functional.all_gather_into_tensor"] == gathers


def test_resolve_device_passes_the_fake_card_only_under_fake_mode():
    """The dry run's fake card: ``resolve_device("cuda")`` without a card
    returns cuda:0 under an active FakeTensorMode and raises outside."""
    from repro_torch.kernels.backend import resolve_device
    if torch.cuda.is_available():
        pytest.skip("checks a host without a CUDA card")
    with FakeTensorMode():
        assert resolve_device("cuda") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_variants_refused_by_name():
    with pytest.raises(ValueError, match="moe_shard_hints.*refused"):
        D.dryrun_one("grok_1_314b", "train_4k", device="cpu",
                     variant={"moe_shard_hints": True})
    with pytest.raises(ValueError, match="ring_attn.*refused"):
        D.dryrun_one("hymba_1_5b", "prefill_32k", device="cpu",
                     variant={"ring_attn": True})
    with pytest.raises(ValueError, match="act_model_shard.*refused"):
        D.dryrun_one("smollm_135m", "decode_32k", device="cpu",
                     variant={"act_model_shard": True})
    with pytest.raises(ValueError, match="unknown variant"):
        D.dryrun_one("smollm_135m", "train_4k", device="cpu",
                     variant={"nope": 1})


def test_variants_move_the_record():
    """Each accepted variant key changes the record through its term."""
    cfg = _reduced("moonshot_v1_16b_a3b", vocab_size=64, n_layers=1)
    shape = ShapeConfig("t", 16, 8, "train")
    run = lambda **v: D.dryrun_one(                       # noqa: E731
        "moonshot_v1_16b_a3b", shape, cfg=cfg, mesh=(2, 4), device="cpu",
        variant={"micro": 2, **v}, verbose=False)
    base = run()
    bf16 = run(accum_dtype="bfloat16")
    assert bf16["temp_bytes_per_dev"] < base["temp_bytes_per_dev"]
    assert bf16["hlo_bytes"] != base["hlo_bytes"]
    shard = run(act_model_shard=True)
    assert shard["temp_bytes_per_dev"] < base["temp_bytes_per_dev"]
    assert "all-gather" in shard["collectives"]
    one = run(micro=1)
    assert one["micro"] == 1 and one["hlo_bytes"] != base["hlo_bytes"]
    assert run(capacity_factor=4.0)["hlo_flops"] > base["hlo_flops"]


# ---------------------------------------------------------------------------
# the collective model, term by term
# ---------------------------------------------------------------------------


def test_collective_model_hand_computed():
    """Every term on a hand-made model: a (2, 4) mesh, bf16, d=32."""
    cfg = dataclasses.replace(_reduced("moonshot_v1_16b_a3b"), d_model=32,
                              n_heads=4, n_kv_heads=4, head_dim=8,
                              n_experts=4, top_k=2, d_ff=16,
                              dtype="bfloat16", vocab_size=64,
                              capacity_factor=1.0)
    info = zoo.MeshInfo(axis_names=("data", "model"),
                        axis_sizes={"data": 2, "model": 4})
    bf = torch.bfloat16
    params = {"embed": SD((64, 32), bf), "lm_head": SD((32, 64), bf),
              "blocks.0.attn.wq": SD((32, 32), bf),
              "blocks.0.attn.wo": SD((32, 32), bf),
              "blocks.0.moe.router": SD((32, 4), torch.float32),
              "blocks.0.moe.wo": SD((4, 16, 32), bf)}
    specs = {"embed": ("model", "data"), "lm_head": ("data", "model"),
             "blocks.0.attn.wq": ("data", "model"),
             "blocks.0.attn.wo": ("model", None),
             "blocks.0.moe.router": (None, None),
             "blocks.0.moe.wo": ("model", None, None)}
    terms = RL.collective_terms(cfg, "train", info, params, specs,
                                tokens=10, micro=3, moe_tokens=10,
                                act_model_shard=True)
    got = {t.name: (t.kind, t.nbytes, t.group, t.times) for t in terms}
    # FSDP: embed, lm_head, wq gathered over data (model shard kept)
    fsdp = (64 * 32 * 2 + 32 * 64 * 2 + 32 * 32 * 2) // 4
    assert got["fsdp_all_gather"] == ("all-gather", fsdp, 2, 6)
    assert got["fsdp_reduce_scatter"] == ("reduce-scatter", fsdp, 2, 3)
    # replicated: wo / 4 (model), router, experts' wo / 4, in fp32
    repl = 32 * 32 // 4 * 4 + 32 * 4 * 4 + 4 * 16 * 32 // 4 * 4
    assert got["grad_all_reduce"] == ("all-reduce", repl, 2, 1)
    # attn.wo contracts on the model axis: (10 tokens, 32) bf16, 3 passes
    # of 3 microbatches
    assert got["row_parallel"] == ("all-reduce", 10 * 32 * 2, 4, 9)
    assert got["lse_all_reduce"] == ("all-reduce", 10 * 4, 4, 6)
    # experts on the model axis: cap = ceil(10 * 2 / 4) = 5
    assert got["moe_all_to_all"] == ("all-to-all", 4 * 5 * 32 * 2, 4, 18)
    assert got["act_all_gather"] == ("all-gather", 10 * 32 * 2, 4,
                                     9 * cfg.n_layers)
    half = RL.collective_terms(cfg, "train", info, params, specs,
                               tokens=10, micro=3, moe_tokens=10,
                               accum_dtype=torch.bfloat16)
    assert {t.name: t.nbytes for t in half}["grad_all_reduce"] == repl // 2
    stats = RL.collective_stats(terms)
    assert stats.count == sum(t.times for t in terms)
    assert stats.by_kind["all-gather"] == pytest.approx(
        fsdp / 2 * 6 + 10 * 32 * 2 * 3 / 4 * 9 * cfg.n_layers)
    # decode with a sequence-sharded cache; the ring prefill
    dec = RL.collective_terms(cfg, "decode", info, params, specs, tokens=3,
                              batch=3, moe_tokens=3,
                              cache_specs={"k": (None, None, "model", None,
                                                 None)})
    got = {t.name: (t.kind, t.nbytes, t.group, t.times) for t in dec}
    assert got["kvseq_all_reduce"] == ("all-reduce", 3 * 4 * (8 + 2) * 4, 4,
                                       1)
    assert got["fsdp_all_gather"][3] == 1 and "grad_all_reduce" not in got
    ring = RL.collective_terms(cfg, "prefill", info, params, specs,
                               tokens=8, batch=2, moe_tokens=8,
                               ring_hops=4, ring_kv_bytes=100)
    got = {t.name: (t.kind, t.nbytes, t.group, t.times) for t in ring}
    assert got["ring_permute"] == ("collective-permute", 100, 4, 6)
    assert got["ring_logits"] == ("all-gather", 4 * 2 * 64 * 2, 4, 1)
    assert got["ring_moe_counts"] == ("all-gather", 8 * 2 * 2 * 4 * 8, 8, 1)
    assert RL._wire_bytes("collective-permute", 100, 4) == 100.0


def test_op_bytes_mode_counts_inputs_outputs_and_the_peak():
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    mode = RL.OpBytesMode()
    mode.track([a, b])
    with mode:
        c = a @ b                     # 128 + 64 in, 32 out
        d = c.view(-1)                # a view: not counted
        e = d * 2.0                   # 32 in, 32 out
    del c, d, e
    assert mode.total == 128 + 64 + 32 + 32 + 32
    assert mode.peak == 128 + 64 + 32 + 32
    assert mode.live == 128 + 64


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


REFERENCE_SCRIPT = r"""
import json, math, sys
sys.path.insert(0, "src")
import jax
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun as D
from repro.models import zoo
meshes = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params, _ = D.abstract_params_and_specs(cfg)
    sizes_ = [math.prod(p.shape) for p in jax.tree.leaves(params)]
    rec = out[arch] = {"outer": {}, "outer_exact": {},
                       "largest_leaf": max(sizes_)}
    for mesh, (names, sizes) in meshes.items():
        minfo = zoo.MeshInfo(axis_names=names,
                             axis_sizes=dict(zip(names, sizes)))
        rec["outer"][mesh] = D.outer_flops_train(cfg, params, minfo)
        rec["outer_exact"][mesh] = 3.0 * sum(sizes_) / minfo.model_size
        for name, shape in SHAPES.items():
            micro = zoo.effective_microbatches(
                shape.global_batch, zoo.policy_for(cfg).micro_for(name),
                minfo.batch_size_total) if shape.kind == "train" else 1
            rec[f"head {name} {mesh}"] = (
                micro, D.head_flops_per_microbatch_device(
                    cfg, shape, minfo, micro, shape.kind == "train"))
    for name, shape in SHAPES.items():
        rec[f"analytic {name}"] = D.analytic_model_flops(cfg, shape)
        rec[f"cache_len {name}"] = D.decode_cache_len(cfg, shape)
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_values():
    out = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300, env=os.environ | {
                             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("JSON", 1)[1])


def test_analytic_helpers_are_the_references(reference_values):
    """``analytic_model_flops``, ``decode_cache_len``,
    ``head_flops_per_microbatch_device`` (with the dry run's microbatches)
    and ``outer_flops_train`` equal the reference's for every arch, shape
    and production mesh (``outer_flops_train`` the reference's formula in
    exact integers: its int32 element counts wrap for a stacked leaf of
    2**31 elements or more)."""
    meshes = {"pod": (("data", "model"), (16, 16)),
              "multipod": (("pod", "data", "model"), (2, 16, 16))}
    for arch in ARCH_IDS:
        cfg, ref = get_config(arch), reference_values[arch]
        with FakeTensorMode():
            params = zoo.param_shapes(zoo.build_model(cfg,
                                                      torch.device("cpu")))
        for mesh, (names, sizes) in meshes.items():
            minfo = zoo.MeshInfo(axis_names=names,
                                 axis_sizes=dict(zip(names, sizes)))
            # the reference counts each leaf's elements in int32, which
            # wraps past 2**31 (the stacked experts of the MoE archs)
            outer = D.outer_flops_train(cfg, params, minfo)
            assert outer == ref["outer_exact"][mesh]
            if ref["largest_leaf"] < 2 ** 31:
                assert outer == ref["outer"][mesh]
            for name, shape in SHAPES.items():
                micro = zoo.effective_microbatches(
                    shape.global_batch, zoo.policy_for(cfg).micro_for(name),
                    minfo.batch_size_total) if shape.kind == "train" else 1
                assert [micro, D.head_flops_per_microbatch_device(
                    cfg, shape, minfo, micro, shape.kind == "train")] == \
                    ref[f"head {name} {mesh}"]
        for name, shape in SHAPES.items():
            assert D.analytic_model_flops(cfg, shape) == \
                ref[f"analytic {name}"]
            assert D.decode_cache_len(cfg, shape) == ref[f"cache_len {name}"]


def test_wire_bytes_and_shape_bytes_are_the_references():
    from repro.launch import roofline as R
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for n, g in [(100, 4), (4096, 16), (7, 1), (1 << 30, 512)]:
            assert RL._wire_bytes(kind, n, g) == R._wire_bytes(kind, n, g)
    for dtype, dims in [("bf16", "4,8"), ("f32", ""), ("s8", "3,5,7"),
                        ("weird", "2")]:
        assert RL._shape_bytes(dtype, dims) == R._shape_bytes(dtype, dims)
    assert RL._shape_bytes(torch.bfloat16, (4, 8)) == 64


class _Mem:
    argument_size_in_bytes = 1_000_000
    output_size_in_bytes = 400_000
    alias_size_in_bytes = 300_000
    temp_size_in_bytes = 2_500_000


@pytest.mark.parametrize("scan_trips,outer", [(1, 0.0), (48, 1e9)])
def test_build_roofline_is_the_references(scan_trips, outer):
    """With the reference's constants passed in (TPU v5e: 197 TFLOP/s, 819
    GB/s, 50 GB/s a link), ``build_roofline`` gives the reference's record
    from the same cost, memory and collectives (the latter parsed by the
    reference from its HLO)."""
    from repro.launch import roofline as R
    hlo = """
%cond (p: (s32[], f32[4])) -> pred[] {
  %c = s32[] constant(48)
  ROOT %cmp = pred[] compare(%iter, %c), direction=LT
}
%body (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ar = f32[4096]{0} all-reduce(%x), channel_id=1, replica_groups=[2,4]<=[8], to_apply=%add
}
ENTRY %main (a: f32[4]) -> f32[4] {
  %ag = bf16[64,32]{1,0} all-gather(%a), replica_groups=[4,2]<=[8]
  %w = (s32[], f32[4]) while(%init), condition=%cond, body=%body
}
"""
    cost = {"flops": 3.2e12, "bytes accessed": 7.5e10}
    kw = dict(arch="a", shape="s", mesh_name="m", chips=8, cost=cost,
              mem=_Mem(), scan_trips=scan_trips, outer_flops_per_dev=outer,
              model_flops=2e13, note="n")
    ref = R.build_roofline(hlo=hlo, **kw)
    cs = R.collective_stats(hlo)
    got = RL.build_roofline(
        collectives=RL.CollectiveStats(cs.wire_bytes, cs.by_kind, cs.count),
        peak_flops=R.PEAK_FLOPS, hbm_bw=R.HBM_BW, link_bw=R.ICI_BW, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.terms() == ref.terms()
    h100 = RL.build_roofline(collectives=RL.CollectiveStats(
        cs.wire_bytes, cs.by_kind, cs.count), **kw)
    assert h100.t_collective == cs.wire_bytes / RL.LINK_BYTES_S
    assert h100.t_memory == got.hlo_bytes / RL.PEAK_BYTES_S


def test_main_writes_records_and_fails_on_a_bad_combination(tmp_path,
                                                            monkeypatch):
    """The CLI writes one record a combination (the reference's tag) and
    exits 1 when one fails, with an ``ok: false`` record."""
    def fake(arch, shape, *, multi_pod=False, device=None, **kw):
        if multi_pod:
            raise RuntimeError("boom")
        return {"ok": True, "arch": arch, "shape": shape}

    monkeypatch.setattr(D, "dryrun_one", fake)
    D.main(["--arch", "smollm_135m", "--shape", "train_4k",
            "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "smollm_135m__train_4k__single.json")
                     .read_text())
    assert rec["ok"]
    with pytest.raises(SystemExit) as exc:
        D.main(["--arch", "smollm_135m", "--shape", "train_4k",
                "--both-meshes", "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "smollm_135m__train_4k__multi.json")
                     .read_text())
    assert not rec["ok"] and "boom" in rec["error"]
    assert D.default_device() == ("cuda" if torch.backends.cuda.is_built()
                                  else "cpu")
    assert math.isfinite(D.analytic_model_flops(get_config("rwkv6_7b"),
                                                SHAPES["long_500k"]))
