#!/usr/bin/env python3
"""Time the wrappers of swa, swa_bwd, wkv6 and wkv6_bwd of two source
trees of the PyTorch port on one GPU, in turns (A, B, B, A), each turn a
fresh process, so that two versions of the wrappers compare within one
machine and one card.

    python3 tools/wrapper_ab.py A_DIR B_DIR [--out FILE]

A_DIR and B_DIR each hold a ``src/repro_torch`` (for example a
``git archive`` of another commit unpacked under ``build/``). The shapes
are those of the kernels' rows in PERF.md: swa at hymba_1_5b's serving
(2, 4096, 25, 5, 64) and swa_bwd at (1, 4096, 25, 5, 64), W=2048, bf16
(swa_bwd with the forward's output and lse); wkv6 and wkv6_bwd at
rwkv6_7b's (1, 64, 4096, 64), bf16, chunk 128.
Each time is the median over 7 runs of the mean CUDA-event time of 20
wrapper calls (host time included). Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

TURN = r"""
import json, statistics, sys
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import build, swa as SW, wkv6 as WK
build.load()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)


def time_ms(fn, reps=20, runs=7):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


q2, k2, v2 = (torch.randn(s, generator=gen, device=dev).bfloat16()
              for s in ((2, 4096, 25, 64), (2, 4096, 5, 64),
                        (2, 4096, 5, 64)))
q, k, v, dout = (x[:1].contiguous() for x in (q2, k2, v2, q2))
out, lse = SW._forward(q, k, v, 2048, 0.0, 0, with_lse=True)
r, kk, vv = (torch.randn((1, 64, 4096, 64), generator=gen,
                         device=dev).bfloat16() for _ in range(3))
w_log = -torch.rand((1, 64, 4096, 64), generator=gen, device=dev)
u = torch.randn((64, 64), generator=gen, device=dev)
do = torch.randn((1, 64, 4096, 64), generator=gen, device=dev)
states = WK._forward(r, kk, vv, w_log, u, None, 128)[2]
print(json.dumps({
    "swa": time_ms(lambda: SW.swa(q2, k2, v2, window=2048)),
    "swa_bwd": time_ms(lambda: SW.swa_bwd(q, k, v, dout, window=2048,
                                          out=out, lse=lse)),
    "wkv6": time_ms(lambda: WK.wkv6(r, kk, vv, w_log, u, chunk=128)),
    "wkv6_bwd": time_ms(lambda: WK.wkv6_bwd(r, kk, vv, w_log, u, None, do,
                                            None, states=states,
                                            chunk=128))}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    turns = []
    for tree in (args.a, args.b, args.b, args.a):
        proc = subprocess.run([sys.executable, "-c", TURN, tree],
                              capture_output=True, text=True, timeout=900,
                              check=True)
        turns.append({"tree": tree,
                      "ms": json.loads(proc.stdout.splitlines()[-1])})
    res = {"turns": turns,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip()}
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
