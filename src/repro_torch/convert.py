"""Convert the reference package's parameters into the port's modules.

The input is the reference's parameter tree as numpy arrays — what
``jax.tree.map(np.asarray, params)`` gives: a nested dict whose
``"blocks"`` subtree stacks every layer on a leading axis. Nothing here
imports jax: bf16 leaves (numpy's ``bfloat16`` extension dtype) are read
through their uint16 bits.

The port's module names mirror the reference's tree, so one flattening
serves every ported family: the dense tree (``attn``, ``mlp``, ``ln1``,
``ln2``), the hybrid tree (adds ``ssm``, ``ln_attn_o``, ``ln_ssm_o``) and
the ssm (RWKV6) tree (``tm``, ``cm``, ``ln1``, ``ln2``). Loading the result
with ``load_state_dict`` (strict) checks every name and shape.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def flatten_tree(tree: dict, prefix: str = "") -> "OrderedDict[str, np.ndarray]":
    """Flatten a reference parameter tree to the port's state-dict names:
    nested keys joined by '.', the stacked ``blocks`` unstacked on axis 0
    (``blocks.{i}.attn.wq``)."""
    out: OrderedDict[str, np.ndarray] = OrderedDict()
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if key == "blocks" and not prefix:
            stacked = flatten_tree(val)
            n_layers = len(next(iter(stacked.values())))
            for i in range(n_layers):
                for sub, arr in stacked.items():
                    out[f"blocks.{i}.{sub}"] = arr[i]
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
    """State dict for ``DecoderLM(cfg)`` from the reference's numpy tree."""
    flat = flatten_tree(tree)
    n_blocks = len({k.split(".")[1] for k in flat if k.startswith("blocks.")})
    if n_blocks != cfg.n_layers:
        raise ValueError(f"tree has {n_blocks} layers, config "
                         f"{cfg.name!r} has {cfg.n_layers}")
    return OrderedDict((k, to_tensor(v, device)) for k, v in flat.items())
