"""Convert the reference package's parameters into the port's modules.

The input is the reference's parameter tree as numpy arrays — what
``jax.tree.map(np.asarray, params)`` gives: a nested dict whose stacked
subtrees (``"blocks"``; the encdec family's ``"enc_blocks"`` and
``"dec_blocks"``) hold every layer on a leading axis. Nothing here
imports jax: bf16 leaves (numpy's ``bfloat16`` extension dtype) are read
through their uint16 bits.

The port's module names mirror the reference's tree, so one flattening
serves every family: the dense tree (``attn``, ``mlp``, ``ln1``,
``ln2``), the hybrid tree (adds ``ssm``, ``ln_attn_o``, ``ln_ssm_o``), the
ssm (RWKV6) tree (``tm``, ``cm``, ``ln1``, ``ln2``), the vlm tree (adds
``prefix_proj``) and the encdec tree (``frontend_proj``, ``enc_blocks``,
``enc_norm``, ``dec_blocks`` with ``lnx`` and ``xattn``, ``lm_head``).
Loading the result with ``load_state_dict`` (strict) checks every name and
shape.

A flat update vector has two layouts. The port's (fl/aggregate.py) is
``model.parameters()`` order, one layer after another. The reference's is
``ravel_pytree`` order: its tree's leaves in sorted-key order, each
stacked leaf (L, ...) whole. ``ravel_segments`` maps one onto
the other, so the update predictor's count-sketch, drawn per coordinate in
the reference's order, lands on the same coordinates in the port's.
``predictor_from_numpy`` carries the reference predictor's MLP weights.
"""
from __future__ import annotations

from collections import OrderedDict
from math import prod

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# top-level subtrees that stack their layers on a leading axis
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def flatten_tree(tree: dict, prefix: str = "") -> "OrderedDict[str, np.ndarray]":
    """Flatten a reference parameter tree to the port's state-dict names:
    nested keys joined by '.', the stacked subtrees (``STACKED``) unstacked
    on axis 0 (``blocks.{i}.attn.wq``, ``dec_blocks.{i}.xattn.wq``)."""
    out: OrderedDict[str, np.ndarray] = OrderedDict()
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if key in STACKED and not prefix:
            stacked = flatten_tree(val)
            n_layers = len(next(iter(stacked.values())))
            for i in range(n_layers):
                for sub, arr in stacked.items():
                    out[f"{key}.{i}.{sub}"] = arr[i]
        elif isinstance(val, dict):
            out.update(flatten_tree(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch on ``device``, bf16 included."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device) -> "OrderedDict[str, torch.Tensor]":
    """State dict for ``zoo.build_model(cfg)`` (``DecoderLM``, or
    ``EncDecLM`` for encdec) from the reference's numpy tree."""
    flat = flatten_tree(tree)
    want = ({"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
            if cfg.family == "encdec" else {"blocks": cfg.n_layers})
    for stack, n_layers in want.items():
        n_blocks = len({k.split(".")[1] for k in flat
                        if k.startswith(stack + ".")})
        if n_blocks != n_layers:
            raise ValueError(f"tree has {n_blocks} {stack}, config "
                             f"{cfg.name!r} has {n_layers}")
    return OrderedDict((k, to_tensor(v, device)) for k, v in flat.items())


def ravel_segments(named_shapes) -> list:
    """``[(port_offset, ravel_offset, size), ...]``, one per parameter, from
    ``(name, shape)`` pairs in the port's order (``(n, p.shape) for n, p in
    model.named_parameters()``). Each parameter is one contiguous run in
    both layouts: ``blocks.{i}.{sub}`` (or ``enc_blocks``, ``dec_blocks``)
    is layer i of the reference's stacked leaf ``blocks/{sub}``, every
    other name a leaf of its own."""
    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    leaves: dict = {}        # reference leaf path -> (layer size, layers)
    where = []               # per port parameter: (leaf path, layer)
    for name, shape in named_shapes:
        parts = name.split(".")
        if parts[0] in STACKED:
            path, layer = (parts[0], *parts[2:]), int(parts[1])
        else:
            path, layer = tuple(parts), 0
        size, layers = leaves.get(path, (prod(shape), 0))
        leaves[path] = (size, max(layers, layer + 1))
        where.append((path, layer))
    start, off = {}, 0
    for path in sorted(leaves):
        start[path] = off
        size, layers = leaves[path]
        off += size * layers
    segs, port_off = [], 0
    for (path, layer), (_, shape) in zip(where, named_shapes):
        size = leaves[path][0]
        segs.append((port_off, start[path] + layer * size, size))
        port_off += size
    return segs


def _permuted(x, segments, port_to_ravel: bool):
    out = torch.empty_like(x) if torch.is_tensor(x) else np.empty_like(x)
    for p, r, n in segments:
        if port_to_ravel:
            out[r:r + n] = x[p:p + n]
        else:
            out[p:p + n] = x[r:r + n]
    return out


def to_port_order(x, segments):
    """A flat (P, ...) array or tensor in ravel order -> port order."""
    return _permuted(x, segments, port_to_ravel=False)


def to_ravel_order(x, segments):
    """A flat (P, ...) array or tensor in port order -> ravel order."""
    return _permuted(x, segments, port_to_ravel=True)


def predictor_from_numpy(net: dict,
                         device="cpu") -> "OrderedDict[str, torch.Tensor]":
    """State dict for ``fl.predictor.MLP`` from the reference's MLP weights
    (``init_mlp`` in ``src/repro/fl/predictor.py``, as numpy arrays)."""
    return OrderedDict((k, to_tensor(np.asarray(net[k], np.float32), device))
                       for k in ("w1", "b1", "w2", "b2", "w3", "b3"))
