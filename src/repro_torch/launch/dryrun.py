"""Multi-pod dry run: trace every (architecture x input shape x mesh)
combination's per-device step on a fake process group of 256 or 512
ranks, and fill the reference's record (memory, FLOPs, op bytes,
collective bytes, roofline bottleneck) from the stand-ins of
``launch/roofline.py``.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
the GSPMD program on 512 placeholder host devices. Here one combination
is: a fake default process group of the mesh's ranks
(``mesh.fake_world``) and its ``DeviceMesh``; the model at published
width under ``FakeTensorMode`` (no weight drawn, no memory used); its
parameters' placements resolved (``zoo.param_specs``,
``zoo.specs_with_dims``); one rank's program of the train, prefill or
decode step traced on the per-device batch, the microbatches of
``zoo.effective_microbatches`` and the decode cache of
``decode_cache_len``; and the record filled.

The traced device is the fake ``cuda`` (the kernels' route: swa and wkv6
as the ``repro_torch::`` custom ops, counted by their FLOP formulas) on a
PyTorch built with CUDA, no card needed; ``--device cpu`` traces the
plain route instead (the default where PyTorch has no CUDA, which cannot
make a fake CUDA tensor). The record's ``device`` says which.

Depth and microbatches. A step runs the same layer program n_layers times
(n_enc_layers and n_layers for encdec) and the same microbatch program
``micro`` times, so its FLOPs, op bytes and collectives are affine in
each depth and, past the first microbatch, in ``micro``. The dry run
traces the step at depth 1 and 2 of each stack (at 2 and 3 microbatches
where ``micro`` > 2) and extends the counts to the full depth and
``micro`` exactly (``_extend``; tests/test_torch_dryrun.py holds the
result to a full trace); the peak of live bytes is extended in depth the
same way, which is a model. The ring prefill (``variant ring_attn``) is traced
whole.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m \\
        --shape train_4k [--multipod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh, mesh_info)
from repro_torch.models import zoo

# the reference's variant keys (launch/perf.py); moe_shard_hints pins the
# reference's GSPMD buffers, which the port's rank-local dispatch has not
REFUSED_VARIANTS = {
    "moe_shard_hints": "the port's MoE dispatch is rank-local (no GSPMD "
                       "expert buffers to pin), so the hint has no "
                       "counterpart"}
VARIANT_KEYS = ("note", "accum_dtype", "act_model_shard", "micro",
                "capacity_factor", "ring_attn", "long_context_window")
GC_EVERY_OPS = 100       # the trace's garbage collections (OpBytesMode)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def abstract_params_and_specs(cfg: ModelConfig, device):
    """The model of ``cfg`` on ``device`` (under the caller's
    ``FakeTensorMode``: no weight drawn) and its parameters' logical
    axes."""
    model = zoo.build_model(cfg, torch.device(device))
    return model, zoo.param_specs(cfg, model)


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """long_500k uses the sliding-window ring cache for attention archs
    (the sub-quadratic carve-in)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.long_context_window
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig, minfo):
    """``ShapeDtype`` stand-ins and resolved specs of every model input."""
    return zoo.batch_shapes(cfg, shape), zoo.batch_specs(cfg, shape, minfo)


# ---------------------------------------------------------------------------
# analytic flop helpers
# ---------------------------------------------------------------------------


def head_flops_per_microbatch_device(cfg, shape, minfo, micro, train):
    tokens = shape.global_batch * shape.seq_len
    tok_dev = tokens / minfo.batch_size_total / micro
    vsh = minfo.model_size if cfg.vocab_size % minfo.model_size == 0 else 1
    f = 2.0 * tok_dev * cfg.d_model * cfg.vocab_size / vsh
    return f * (3.0 if train else 1.0)


def outer_flops_train(cfg, params: dict, minfo):
    """Parameter update ~3 flops/param, model-axis sharding only assumed;
    ``params``: name -> ``ShapeDtype`` (or anything with ``shape``)."""
    n = sum(math.prod(p.shape) for p in params.values())
    return 3.0 * n / minfo.model_size


def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global 'useful' flops per step: 6*N_active*T (train) / 2*N_active*T
    (prefill) / 2*N_active*B (decode) + attention term."""
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.n_heads, cfg.head_dim
    if shape.kind == "train":
        base = 6.0 * n_active * b * s
        attn = 12.0 * b * s * s * h * hd * cfg.n_layers * 0.5
    elif shape.kind == "prefill":
        base = 2.0 * n_active * b * s
        attn = 4.0 * b * s * s * h * hd * cfg.n_layers * 0.5
    else:  # decode: one token, attention over the (possibly windowed) cache
        base = 2.0 * n_active * b
        ctx = min(s, cfg.long_context_window) if s > 40_000 else s
        attn = 4.0 * b * ctx * h * hd * cfg.n_layers
    if cfg.family == "ssm":
        attn = 0.0
    return base + attn


# ---------------------------------------------------------------------------
# tracing one rank's step
# ---------------------------------------------------------------------------


def default_device() -> str:
    """The fake card where PyTorch can make fake CUDA tensors (a CUDA
    build, with or without a card), else the CPU's plain route."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _exclusive(by_module: dict) -> dict:
    """{module fqn: its count less its recorded submodules'} from counts
    that include every enclosing module (FlopCounterMode's), and "" for
    what ran outside any module."""
    names = [m for m in by_module if m != "Global"]
    out = dict.fromkeys(names, 0) | {"": by_module.get("Global", 0)}
    for m in names:
        out[m] += by_module[m]
        parent = max((p for p in names if m.startswith(p + ".")), key=len,
                     default="")
        out[parent] -= by_module[m]
    return out


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _owned_params(mod, recorded: set, path: str):
    """The parameters ``mod`` (at ``path``) owns in a trace: its own, and
    those of its submodules that recorded nothing (ran inside it as
    functions)."""
    yield from (_join(path, n) for n, _ in mod.named_parameters(
        recurse=False))
    for n, child in mod.named_children():
        if _join(path, n) not in recorded:
            yield from _owned_params(child, recorded, _join(path, n))


def per_device(by_module: dict, model, specs: dict, msize: int) -> float:
    """``by_module``'s total with each module's own share divided by
    ``msize`` where its weights shard on the model axis: a layer's share
    where any parameter of the layer's subtree does (the backward of a
    checkpointed region may land on the enclosing module), the root's
    (the embedding, the unembedding, and what ran outside every module)
    where a parameter it owns does."""
    if msize == 1:
        return float(by_module.get("Global", 0))
    root = type(model).__name__
    recorded = {m.split(".", 1)[1] if "." in m else "" for m in by_module
                if m.startswith(root)}
    total = 0.0
    for fqn, n in _exclusive(by_module).items():
        path = fqn.split(".", 1)[1] if "." in fqn else ""
        mod = model.get_submodule(path)
        names = (_owned_params(mod, recorded, path) if not path else
                 (_join(path, k) for k, _ in mod.named_parameters()))
        on_model = any("model" in zoo.spec_axes(e) for name in names
                       for e in specs[name])
        total += n / msize if on_model else n
    return total


def _trace(run, model, cfg, minfo, policy, *, comm: bool) -> dict:
    """Counts of one traced call ``run()`` under FlopCounterMode and
    OpBytesMode (and CommDebugMode with ``comm``)."""
    from contextlib import ExitStack
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    specs = zoo.specs_with_dims(zoo.param_shapes(model),
                                zoo.param_specs(cfg, model), cfg, minfo,
                                policy)
    # a parameter's shape -> its pieces (the fewest where shapes repeat)
    shard_of: dict = {}
    for name, p in model.named_parameters():
        n = minfo.shards(specs[name])
        shard_of[tuple(p.shape)] = min(n, shard_of.get(tuple(p.shape), n))
    fc = FlopCounterMode(display=False)
    ob = RL.OpBytesMode(GC_EVERY_OPS, shard_of)
    cm = CommDebugMode() if comm else None
    params = list(model.parameters())
    ob.track(params)
    # storages held only by reference cycles (autograd's) are freed every
    # GC_EVERY_OPS ops, not when the collector happens to run: the peak
    # is the same from run to run. The heap from before the trace is
    # frozen, so that a collection scans only the trace's objects.
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        with ExitStack() as stack:
            for mode in (fc, ob, cm):
                if mode is not None:
                    stack.enter_context(mode)
            run()
    finally:
        gc.enable()
        gc.unfreeze()
    flops = {m: sum(v.values()) for m, v in fc.get_flop_counts().items()}
    out = dict(flops=flops.get("Global", 0), bytes=ob.total,
               flops_dev=per_device(flops, model, specs, minfo.model_size),
               bytes_dev=per_device(ob.by_module, model, specs,
                                    minfo.model_size),
               peak=ob.peak, params=sum(
                   p.numel() * p.element_size() // shard_of[tuple(p.shape)]
                   for p in params))
    if cm is not None:
        out["comm"] = {str(k): v for k, v in cm.get_comm_counts().items()}
    return out


def _depth_fields(cfg: ModelConfig) -> tuple:
    return (("n_enc_layers", "n_layers") if cfg.family == "encdec"
            else ("n_layers",))


def _extend(points: dict, key: str, depths: dict, m0: int, micro: int):
    """The count ``key`` at full ``depths`` and ``micro`` microbatches from
    traces at m0 microbatches of depth 1 (``points["base"]``) and of depth
    2 in each stack (``points[field]``), and, where ``micro`` > m0, the
    same at m0 + 1 microbatches (``"micro"``, ``field + "+micro"``). A
    count is a + sum(d_i e_i) + M (b + sum(d_i c_i)) over depths d_i and
    microbatches M (e_i: a layer's share once a step, such as its
    parameters' update; c_i: once a microbatch), which these points fix
    exactly."""
    f0 = points["base"][key]
    total = f0
    if micro != m0:
        total += (micro - m0) * (points["micro"][key] - f0)
    for f in depths:
        per_layer = points[f][key] - f0                # e + m0 c
        if micro != m0:
            c = points[f + "+micro"][key] - points["micro"][key] - per_layer
            per_layer += (micro - m0) * c
        total += (depths[f] - 1) * per_layer
    return total


def _zeros(sd: zoo.ShapeDtype, rows: int, device):
    return torch.zeros((rows,) + tuple(sd.shape[1:]), dtype=sd.dtype,
                       device=device)


def _step_runner(cfg, shape, *, device, rows, micro, accum_dtype,
                 cache_len, ring):
    """A function that builds the model of ``cfg`` on ``device`` and
    returns (model, run): run() is one rank's step on ``rows`` rows of the
    per-device batch (a train step of ``micro`` microbatches, a prefill, or
    a decode step over a cache of ``cache_len``)."""
    model = zoo.build_model(cfg, torch.device(device))
    if shape.kind == "decode":
        cache = zoo.init_cache(cfg, rows, cache_len, device=device)
        step = zoo.make_serve_step(cfg, ring=(shape.name == "long_500k"
                                              and cfg.family != "ssm"))
        token = torch.zeros((rows,), dtype=torch.int32, device=device)
        return model, lambda: step(model, cache, token, cache_len - 1)
    step = (zoo.make_train_step(cfg, lr=1e-3, microbatches=micro,
                                accum_dtype=accum_dtype)
            if shape.kind == "train" else zoo.make_prefill_step(cfg, ring=ring))
    batch = {k: _zeros(v, rows, device)
             for k, v in zoo.batch_shapes(cfg, shape).items()}
    return model, lambda: step(model, batch)


def _shards_bytes(shapes: dict, specs: dict, minfo) -> int:
    return sum(sd.nbytes // minfo.shards(specs[k]) for k, sd in shapes.items())


def _check_variant(cfg: ModelConfig, shape: ShapeConfig, variant: dict):
    for key in variant:
        if key in REFUSED_VARIANTS:
            raise ValueError(f"variant {key!r} refused: "
                             f"{REFUSED_VARIANTS[key]}")
        if key not in VARIANT_KEYS:
            raise ValueError(f"unknown variant key {key!r}")
    if variant.get("ring_attn") and (shape.kind != "prefill"
                                     or cfg.family not in ("dense", "moe")):
        raise ValueError(f"variant 'ring_attn' refused for {cfg.name} x "
                         f"{shape.name}: the ring is the dense and moe "
                         f"families' prefill")
    if variant.get("act_model_shard") and shape.kind != "train":
        raise ValueError("variant 'act_model_shard' refused: it shards the "
                         "train step's remat residual")


# ---------------------------------------------------------------------------
# one (arch, shape, mesh) dry-run
# ---------------------------------------------------------------------------


def dryrun_one(arch: str, shape_name, *, multi_pod: bool = False,
               verbose: bool = True, variant: dict | None = None,
               device: str | None = None, mesh=None,
               cfg: ModelConfig | None = None) -> dict:
    """``shape_name``: a key of ``SHAPES`` or a ``ShapeConfig``. ``mesh``:
    None for the production mesh (``multi_pod`` picks it), else the
    (data, model) sizes of a host mesh (``make_host_mesh``) on a fake
    world of data * model ranks. ``cfg`` overrides ``get_config(arch)``
    (the tests' reduced configs). ``variant``: optional §Perf-lever
    overrides, e.g. {"accum_dtype": "bfloat16", "act_model_shard": True,
    "micro": 8, "capacity_factor": 1.0, "ring_attn": True, "note":
    "tag"}; ``moe_shard_hints`` is refused (``REFUSED_VARIANTS``)."""
    variant = variant or {}
    device = device or default_device()
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    _check_variant(cfg, shape, variant)
    for key in ("capacity_factor", "long_context_window"):
        if key in variant:
            cfg = dataclasses.replace(cfg, **{key: variant[key]})
    dims = mesh or ((2, 16, 16) if multi_pod else (16, 16))
    if mesh is None:
        mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    else:
        mesh_name = f"host_{dims[0]}x{dims[1]}"

    t0 = time.time()
    with fake_world(math.prod(dims)):
        dmesh = (make_production_mesh(multi_pod=multi_pod, device_type=device)
                 if mesh is None else
                 make_host_mesh(dims[1], device_type=device))
        record = _dryrun_on_mesh(arch, cfg, shape, dmesh, mesh_name,
                                 variant, device, t0)
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {mesh_name} ({device}): "
              f"args={record['argument_bytes_per_dev']/2**30:.2f}GiB "
              f"temp={record['temp_bytes_per_dev']/2**30:.2f}GiB "
              f"flops/dev={record['hlo_flops']:.3e} "
              f"coll={record['collective_bytes']:.3e}B "
              f"bottleneck={record['bottleneck']} "
              f"(trace {record['lower_s']:.1f}s)", flush=True)
    return record


def _dryrun_on_mesh(arch, cfg, shape, dmesh, mesh_name, variant, device,
                    t0) -> dict:
    """``dryrun_one`` on a built (fake-world) ``dmesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    policy = zoo.policy_for(cfg)
    accum_dtype = getattr(torch, variant.get("accum_dtype", "float32"))
    with FakeTensorMode():
        minfo = mesh_info(dmesh)
        chips = minfo.batch_size_total * minfo.model_size
        model, spec_tree = abstract_params_and_specs(cfg, device)
        params = zoo.param_shapes(model)
        del model
        pspecs = zoo.specs_with_dims(params, spec_tree, cfg, minfo, policy)
        bshapes, bspecs = input_specs(cfg, shape, minfo)
        bsz = minfo.batch_size_total
        b = shape.global_batch
        rows = b // bsz if b % bsz == 0 else b
        micro, cache_len, ring = 1, 0, None
        if shape.kind == "train":
            micro = zoo.effective_microbatches(
                b, variant.get("micro", policy.micro_for(shape.name)), bsz)
        elif shape.kind == "prefill" and variant.get("ring_attn"):
            ring = (dmesh, minfo.batch_axis(), "model")
        elif shape.kind == "decode":
            cache_len = decode_cache_len(cfg, shape)

        # the traces: depth 1, depth 2 of each stack, m0 + 1 microbatches
        depths = {f: getattr(cfg, f) for f in _depth_fields(cfg)}
        m0 = micro if micro <= 2 else 2
        plan = {"base": ({f: 1 for f in depths}, m0)}
        plan |= {f: ({g: 2 if g == f else 1 for g in depths}, m0)
                 for f in depths}
        if micro != m0:
            plan |= {k + "+micro": (dep, m0 + 1)
                     for k, (dep, _) in list(plan.items())
                     if k != "base"} | {"micro": ({f: 1 for f in depths},
                                                  m0 + 1)}
        if ring is not None:         # traced whole: the ring's hops a layer
            plan, m0 = {"base": (depths, 1)}, 1
        points = {}
        for key, (dep, m) in plan.items():
            cfg_t = dataclasses.replace(cfg, **dep)
            mb_rows = rows // micro * m if shape.kind == "train" else rows
            run_rows = b if ring is not None else mb_rows
            model, run = _step_runner(cfg_t, shape,
                                      device=device, rows=run_rows, micro=m,
                                      accum_dtype=accum_dtype,
                                      cache_len=cache_len, ring=ring)
            points[key] = _trace(run, model, cfg_t, minfo, policy,
                                 comm=ring is not None)
            del model, run
        if ring is not None:
            counts = dict(points["base"])
        else:
            counts = {k: _extend(points, k, depths, m0, micro)
                      for k in ("flops", "bytes", "flops_dev", "bytes_dev")}
            counts["peak"] = _extend(points, "peak", depths, m0, m0)
            counts["params"] = _extend(points, "params", depths, m0, m0)

        # per-device memory: exact bytes of the arguments and outputs
        arg_params = _shards_bytes(params, pspecs, minfo)
        arg_batch = _shards_bytes(bshapes, bspecs, minfo)
        cache_shapes, cspecs = {}, {}
        if shape.kind in ("prefill", "decode"):
            c_len = cache_len or (shape.seq_len + (
                cfg.n_prefix_tokens if cfg.family == "vlm" else 0))
            cache = zoo.init_cache(cfg, b, c_len, device=device)
            cache_shapes = {k: zoo.ShapeDtype(tuple(v.shape), v.dtype)
                            for k, v in cache.items()}
            del cache
            cspecs = zoo.specs_with_dims(cache_shapes, zoo.cache_specs(cfg),
                                         cfg, minfo, policy)
        cache_dev = _shards_bytes(cache_shapes, cspecs, minfo)
        vsh = minfo.model_size if cfg.padded_vocab % minfo.model_size == 0 \
            else 1
        act = getattr(torch, cfg.dtype).itemsize
        logits_dev = rows * cfg.padded_vocab // vsh * act
        if shape.kind == "train":
            args, out, alias = arg_params + arg_batch, arg_params + 8, \
                arg_params
        elif shape.kind == "prefill":
            args, out, alias = arg_params + arg_batch, \
                logits_dev + cache_dev, 0
        else:
            args = arg_params + arg_batch + cache_dev + 4
            out, alias = rows * 4 + logits_dev + cache_dev, cache_dev

        # temp: the traced peak less the parameters, both with every
        # tensor of a parameter's shape at its per-device size
        temp = counts["peak"] - counts["params"]
        tokens = (shape.seq_len + (cfg.n_prefix_tokens
                                   if cfg.family == "vlm" else 0))
        if variant.get("act_model_shard"):
            saved = (cfg.n_layers + cfg.n_enc_layers) * (rows // micro) \
                * tokens * cfg.d_model * act
            temp = max(0, temp - saved * (1 - 1 / minfo.model_size))

        # the collective model
        tok_dev = (rows // micro * tokens if shape.kind == "train"
                   else rows * tokens if shape.kind == "prefill" else rows)
        ring_kw = {}
        if ring is not None:
            n_ring = minfo.model_size
            ring_kw = dict(ring_hops=n_ring, ring_kv_bytes=(
                rows * (shape.seq_len // n_ring) * cfg.n_kv_heads
                * cfg.head_dim * act))
            tok_dev = rows * shape.seq_len // n_ring
        terms = RL.collective_terms(
            cfg, shape.kind, minfo, params, pspecs, tokens=tok_dev,
            micro=micro, accum_dtype=accum_dtype,
            enc_tokens=rows // micro * cfg.n_prefix_tokens
            if shape.kind == "train" else rows * cfg.n_prefix_tokens,
            moe_tokens=tok_dev, cache_specs=cspecs, batch=rows,
            act_model_shard=bool(variant.get("act_model_shard")), **ring_kw)
        colls = RL.collective_stats(terms)
        # the reference's outer (unscanned) FLOPs a device: with
        # scan_trips 1 they correct nothing
        outer = 0.0
        if shape.kind == "train":
            outer = outer_flops_train(cfg, params, minfo) \
                + head_flops_per_microbatch_device(cfg, shape, minfo, micro,
                                                   True)
        elif shape.kind == "prefill":
            outer = head_flops_per_microbatch_device(
                cfg, shape, minfo, 1, False) / shape.seq_len
        else:
            vs = minfo.model_size if cfg.vocab_size % minfo.model_size == 0 \
                else 1
            outer = 2.0 * rows * cfg.d_model * cfg.vocab_size / vs
    t_trace = time.time() - t0

    mem = RL.MemoryStats(argument_size_in_bytes=int(args),
                         output_size_in_bytes=int(out),
                         alias_size_in_bytes=int(alias),
                         temp_size_in_bytes=int(temp))
    rf = RL.build_roofline(
        arch=arch, shape=shape.name, mesh_name=mesh_name, chips=chips,
        cost={"flops": counts["flops_dev"],
              "bytes accessed": counts["bytes_dev"]},
        mem=mem, collectives=colls, outer_flops_per_dev=outer,
        model_flops=analytic_model_flops(cfg, shape),
        note=variant.get("note", ""))
    record = dataclasses.asdict(rf)
    record.update({
        "micro": micro, "scan_trips": 1,
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "argument_bytes_per_dev": mem.argument_size_in_bytes,
        "temp_bytes_per_dev": mem.temp_size_in_bytes,
        "output_bytes_per_dev": mem.output_size_in_bytes,
        "alias_bytes_per_dev": mem.alias_size_in_bytes,
        "collectives": colls.by_kind,
        "collective_terms": [dataclasses.asdict(t) for t in terms],
        "device": device, "traced_flops": counts["flops"],
        "traced_op_bytes": counts["bytes"], "traced_peak_bytes":
            counts["peak"], "trace_points": len(points),
        "ok": True,
    })
    if "comm" in counts:
        record["comm_counts"] = counts["comm"]
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ["all"])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all archs x shapes x both meshes")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the fake device traced (default: cuda where "
                         "PyTorch is built with CUDA, else cpu)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multipod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                try:
                    rec = dryrun_one(arch, shape, multi_pod=mp,
                                     device=args.device)
                except Exception as e:  # noqa: BLE001 (one record a combo)
                    traceback.print_exc()
                    rec = {"ok": False, "error": str(e)[-2000:], "arch": arch,
                           "shape": shape,
                           "mesh": "multi" if mp else "single"}
                    failures.append(tag)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1, allow_nan=False)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run: all combinations traced")


if __name__ == "__main__":
    main()
