"""End-to-end FL training CLI: the paper's experiment, on the card.

Counterpart of ``src/repro/launch/train.py``, with its flags and defaults
plus ``--device`` (default ``cuda``). Runs federated training of the
reduced or the full ``smollm_135m`` over the simulated NOMA cell under a
scheduling policy, logging accuracy against rounds and against simulated
wall-clock, and writes the history JSON (strict: ``allow_nan=False``)
and, with ``--ckpt-dir``, a checkpoint of the final parameters.

    PYTHONPATH=src python -m repro_torch.launch.train --policy age_noma \\
        --rounds 60 --clients 30 [--full-size] [--ckpt-dir ckpts/run0] \\
        [--out experiments/fl] [--device cpu]

Without ``--full-size`` the model is the reduced variant (``d_model=64``,
``d_ff=128``, ``vocab_size=64``); ``--full-size`` runs the arch at its
published widths. ``main(argv)`` runs in-process. ``--arch`` takes the ten
archs, and refuses the vlm and encdec ones (paligemma_3b,
seamless_m4t_medium) with a ValueError: the round feeds clients tokens
only, and the reference's round fails on those families too
(``fl.server.check_trainable``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

from repro_torch import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, FLConfig, NOMAConfig, get_config
from repro_torch.configs.base import POLICIES
from repro_torch.data import TaskConfig, bayes_optimal_accuracy
from repro_torch.fl import FLServer
from repro_torch.fl.server import check_trainable


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m", choices=ARCH_IDS)
    ap.add_argument("--policy", default="age_noma_budget",
                    choices=list(POLICIES))
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--subchannels", type=int, default=5)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--local-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--alpha", type=float, default=0.3,
                    help="Dirichlet non-IID concentration")
    ap.add_argument("--age-exponent", type=float, default=1.0)
    ap.add_argument("--t-budget", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full published config")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--out", default="experiments/fl")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    written record (args, history, wall_s) with the server under
    ``"server"``."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    check_trainable(cfg)         # the vlm and encdec families: ValueError
    if not args.full_size:
        cfg = dataclasses.replace(cfg.reduced(), d_model=64, d_ff=128,
                                  vocab_size=64)
    fl = FLConfig(n_clients=args.clients, rounds=args.rounds,
                  local_epochs=args.local_epochs,
                  local_batch=args.local_batch, lr=args.lr,
                  dirichlet_alpha=args.alpha, policy=args.policy,
                  age_exponent=args.age_exponent, t_budget_s=args.t_budget,
                  samples_per_client=(64, 192), seed=args.seed)
    nomacfg = NOMAConfig(n_subchannels=args.subchannels)
    task = TaskConfig(vocab_size=min(cfg.vocab_size, 64), n_topics=8,
                      seq_len=33, seed=args.seed)

    print(f"[train] arch={args.arch} policy={args.policy} "
          f"clients={args.clients} rounds={args.rounds} "
          f"device={args.device}")
    print(f"[train] bayes-optimal accuracy ceiling: "
          f"{bayes_optimal_accuracy(task):.4f}")
    server = FLServer(cfg, fl, nomacfg, task, policy=args.policy,
                      eval_every=args.eval_every, seed=args.seed,
                      device=args.device)
    t0 = time.time()
    hist = server.run(args.rounds, verbose=True)
    wall = time.time() - t0
    print(f"[train] done in {wall:.1f}s wall; simulated t={server.t_sim:.1f}s"
          f"; final acc={hist.accuracy[-1]:.4f}")

    if args.ckpt_dir:
        path = ckpt.save(args.ckpt_dir, server.model.state_dict(),
                         step=server.round_idx,
                         extra={"policy": args.policy, "arch": args.arch})
        print(f"[train] checkpoint -> {path}")

    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}__{args.policy}__s{args.seed}"
    record = {"args": vars(args), "history": hist.as_dict(), "wall_s": wall}
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1, allow_nan=False)
    print(f"[train] history -> {args.out}/{tag}.json")
    return {**record, "server": server}


if __name__ == "__main__":
    main()
