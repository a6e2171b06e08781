"""Batched decode driver: prefill a prompt batch, then step the KV cache.

Counterpart of ``src/repro/launch/serve.py``, with the same command line
and behaviour (the reduced config of ``--arch``; the card unless the
caller of ``run_serve`` asks for the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
        --batch 4 --prompt-len 32 --gen 16

``run_serve`` is the body as a function, which ``chip_smoke.py`` calls with
the full configurations. Attention families prefill the prompt with
``make_prefill_step`` and copy the prefill's k, v and pos (and the hybrid
family's final SSM state) into a linear decode cache; the ssm family runs
the prompt through decode steps. Then ``gen - 1`` greedy decode steps
follow the first generated token.

The vlm and encdec families take a second input, drawn from the same
``default_rng(seed)`` after the prompt, in the reference's order: the
vlm's ``n_prefix_tokens`` image embeddings (``prefix``), put before the
prompt, so the prefill fills ``P + prompt_len`` positions and decode step
i runs at position ``P + prompt_len + i``; the encdec family's encoder
frames, whose cross ``xk``, ``xv`` the prefill places in the cache beside
the prompt's self k, v. The cache holds ``P + prompt_len + gen`` positions
(P = 0 but for the vlm family). The reference's command line sizes it
``prompt_len + gen``, which the vlm prefill overflows (ROADMAP, "Behaviours
of the reference"); the tests hold the port against the reference's own
``zoo`` steps driven with a cache of this size.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import zoo


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
              seed: int = 0, device="cuda", model=None) -> dict:
    """Serve one prompt batch greedily (a vlm's with its image prefix, an
    encdec's with its encoder frames). ``model`` (built by
    ``zoo.init_model(cfg, seed=seed)`` when None) holds the weights. Returns
    the generated tokens (batch, gen) as numpy and the timings (host clock,
    ending in a synchronise on the card)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if model is None:
        model = zoo.init_model(cfg, seed=seed, device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    b, s = batch, prompt_len
    pref = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.long, device=dev)
    inputs = {"tokens": prompt}
    if cfg.family in ("vlm", "encdec"):
        inputs["prefix" if cfg.family == "vlm" else "frames"] = \
            torch.as_tensor(rng.normal(size=(b, cfg.n_prefix_tokens,
                                             cfg.prefix_dim)),
                            dtype=getattr(torch, cfg.dtype), device=dev)

    serve = zoo.make_serve_step(cfg)
    cache = zoo.init_cache(cfg, b, pref + s + gen, device=dev)
    t0 = time.perf_counter()
    if cfg.family == "ssm":
        # recurrent archs: run the prompt through decode steps
        for i in range(s):
            tok, _, cache = serve(model, cache, prompt[:, i], i)
    else:
        prefill = zoo.make_prefill_step(cfg)
        last_logits, pcache = prefill(model, inputs)
        # place the prefill KV (post-RoPE) into the serving cache
        plen = pref + s
        for name in ("k", "v", "pos"):
            cache[name][:, :, :plen] = pcache[name][:, :, :plen].to(
                cache[name].dtype)
        for name in ("ssm_h", "xk", "xv"):   # hybrid SSM state; encdec
            if name in cache:                # cross k, v over the frames
                cache[name].copy_(pcache[name])
        del pcache
        tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, _, cache = serve(model, cache, tok, pref + s + i)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return dict(tokens=torch.stack(out_tokens, dim=1).cpu().numpy(),
                setup_s=setup_s, prefill_s=t_prefill, decode_s=t_decode,
                decode_tokens_per_s=(gen - 1) * b / max(t_decode, 1e-9))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    res = run_serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, seed=args.seed)
    print(f"[serve] {args.arch}: prefill {args.prompt_len} tok in "
          f"{res['prefill_s'] * 1e3:.1f} ms; {args.gen - 1} steps in "
          f"{res['decode_s'] * 1e3:.1f} ms "
          f"({res['decode_tokens_per_s']:.1f} tok/s)")
    print("[serve] generated:", res["tokens"][:2].tolist())


if __name__ == "__main__":
    main()
