"""§Perf hillclimb runner: dry-run a named variant list for one (arch x
shape) pair and tabulate the roofline deltas.

Counterpart of ``src/repro/launch/perf.py``, over the port's dry run
(launch/dryrun.py). Each variant key moves the record through a term of
the dry run, or the dry run refuses it by name
(``dryrun.REFUSED_VARIANTS``, whose row here says so):

  accum_dtype      the gradient accumulators' dtype: the traced op bytes,
                   the temp bytes and the grad_all_reduce term
  act_model_shard  the remat residual sharded over the model axis: the
                   temp bytes and the act_all_gather term
  micro            the microbatch count: FLOPs, op bytes and every
                   per-microbatch collective
  capacity_factor  the MoE capacity: the experts' FLOPs and op bytes and
                   the moe_all_to_all term
  ring_attn        the ring prefill: the traced program (each rank's
                   sequence chunk) and the ring_* terms
  moe_shard_hints  refused (``dryrun.REFUSED_VARIANTS``)

    PYTHONPATH=src python -m repro_torch.launch.perf --pair grok_train
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

from repro_torch.launch.dryrun import dryrun_one

# hypothesis -> change, per hillclimb pair (the reference's pairs)
PAIRS = {
    "grok_train": {
        "arch": "grok_1_314b", "shape": "train_4k",
        "variants": [
            {"note": "baseline"},
            {"note": "bf16_accum", "accum_dtype": "bfloat16"},
            {"note": "act_model_shard", "act_model_shard": True},
            {"note": "bf16+actshard", "accum_dtype": "bfloat16",
             "act_model_shard": True},
            {"note": "bf16+actshard+cap1.0", "accum_dtype": "bfloat16",
             "act_model_shard": True, "capacity_factor": 1.0},
        ],
    },
    "llama4_prefill": {
        "arch": "llama4_maverick_400b_a17b", "shape": "prefill_32k",
        "variants": [
            {"note": "baseline"},
            {"note": "cap1.0", "capacity_factor": 1.0},
            {"note": "moe_hints", "moe_shard_hints": True},
            {"note": "moe_hints+cap1.0", "moe_shard_hints": True,
             "capacity_factor": 1.0},
            {"note": "ring_attn", "ring_attn": True},
            {"note": "ring_attn+cap1.0", "ring_attn": True,
             "capacity_factor": 1.0},
        ],
    },
    "smollm_train": {
        "arch": "smollm_135m", "shape": "train_4k",
        "variants": [
            {"note": "baseline"},
            {"note": "micro1", "micro": 1},
            {"note": "bf16_accum", "accum_dtype": "bfloat16"},
            {"note": "actshard", "act_model_shard": True},
        ],
    },
}


def run_pair(name: str, out_dir: str = "experiments/perf_torch", *,
             profile_dir: str | None = None, device: str | None = None):
    """Run one hillclimb pair; a variant the dry run refuses gets a row
    with ``"refused"`` and the reason. ``profile_dir`` wraps the sweep in
    ``obs.trace.tracing()`` (a ``perf.variant`` span a variant) and writes
    its report to ``profile_dir/<pair>_trace.txt``."""
    from repro_torch.obs import trace

    spec = PAIRS[name]
    rows = []
    tracing = trace.tracing() if profile_dir else contextlib.nullcontext()
    with tracing as tr:
        for variant in spec["variants"]:
            with trace.span("perf.variant", pair=name,
                            note=variant.get("note", "")):
                try:
                    rec = dryrun_one(spec["arch"], spec["shape"],
                                     variant=variant, device=device)
                except ValueError as e:
                    if "refused" not in str(e):
                        raise
                    rec = {"note": variant.get("note", ""), "ok": False,
                           "refused": str(e)}
            rows.append(rec)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, f"{name}_trace.txt"), "w") as f:
            f.write(trace.format_report(tr.summarize()))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(rows, f, indent=1, allow_nan=False)
    print(f"\n{'variant':24s} {'mem/chip':>9s} {'t_c_s':>8s} {'t_m_s':>8s} "
          f"{'t_floor':>8s} {'t_l_s':>8s}")
    for r in rows:
        if "refused" in r:
            print(f"{r['note']:24s} refused: {r['refused']}")
            continue
        print(f"{r['note']:24s} {r['memory_per_chip']/2**30:8.2f}G "
              f"{r['t_compute']:8.2f} {r['t_memory']:8.2f} "
              f"{r['t_memory_floor']:8.3f} {r['t_collective']:8.2f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, choices=list(PAIRS))
    ap.add_argument("--out", default="experiments/perf_torch")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the sweep with obs.trace (a span a variant) "
                         "and write its report under DIR")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the fake device the dry run traces")
    args = ap.parse_args(argv)
    run_pair(args.pair, args.out, profile_dir=args.profile,
             device=args.device)


if __name__ == "__main__":
    main()
