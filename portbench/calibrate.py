"""Readings that the limits of a cell's compared numbers are set from:
the program against the plain reference over many seeds, and the control
(the reference in the precision below the configuration's) and each
planted fault against it on a few, all at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--faults half_batch,altered_answer] \
        [--out <file.jsonl>]

One JSON line a reading (seed, kind, then the compared numbers) on
standard output and, with ``--out``, in that file. No window is timed:
each seed's program runs its set-up (the checked rounds or the warm-up
rollout) and is compared.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def _release(torch):
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def calibrate(name: str, seeds: list, control_seeds: list, faults: list,
              emit, *, device="cuda", wl=None, cfg=None) -> None:
    import torch

    from portbench import faults as F
    from portbench import harness
    wl = wl or harness.workload(name)
    cfg = cfg or harness.config(wl["config"])
    mod = harness.driver(wl["driver"])
    dev = torch.device(device)

    def program(seed, fault=None):
        with F.plant(wl["driver"], fault) if fault else nullcontext():
            cell = mod.Cell(cfg, wl, seed, dev)
            cell.warm_up()
        cell.release()
        return cell

    for seed in seeds:
        t0 = time.perf_counter()
        cell = program(seed)
        t1 = time.perf_counter()
        ref = cell.follow()
        t2 = time.perf_counter()
        emit({"seed": seed, "kind": "program",
              **cell.compare(cell.outputs(), ref),
              "program_s": t1 - t0, "reference_s": t2 - t1})
        if seed in control_seeds:
            t3 = time.perf_counter()
            ctl = cell.control()
            emit({"seed": seed, "kind": "control", **cell.compare(ctl, ref),
                  "control_s": time.perf_counter() - t3})
            del ctl
            for fault in faults:
                bad = program(seed, fault)
                emit({"seed": seed, "kind": "fault:" + fault,
                      **bad.compare(bad.outputs(), ref)})
                del bad
                _release(torch)
        del cell, ref
        _release(torch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench import run  # the environment the benchmark's runs use
    run._environment()
    from portbench import harness
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = harness.json_line({"workload": args.workload, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        calibrate(args.workload, args.seeds, args.control_seeds,
                  [f for f in args.faults.split(",") if f], emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
