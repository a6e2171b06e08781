"""Checkpointing: a tree of tensors <-> ``.npz`` with a JSON manifest,
written by atomic renames.

Counterpart of ``save``, ``restore`` and ``latest_step`` in
``src/repro/checkpoint/ckpt.py``, with its on-disk format:
``<path>/ckpt_<step>.npz`` holds one array per leaf, named by the leaf's
keys joined by ``/``, and ``<path>/manifest.json`` holds ``step``,
``file`` and ``extra``. The tree is the port's parameter dict or a
module's ``state_dict()`` (nested dicts, lists and tuples of tensors).

numpy has no bf16, so a bf16 leaf is stored as fp32, which holds it
exactly; ``restore`` casts every leaf back to the dtype, and moves it to
the device, of the matching leaf of ``like``, as the reference's
``restore`` casts to ``like``'s dtype.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, prefix=()):
    """(key path, leaf) pairs in the tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.float()
    return leaf.cpu().numpy()


def save(path: str, tree: Any, *, step: int = 0,
         extra: Optional[dict] = None) -> str:
    """Atomically write ``<path>/ckpt_<step>.npz`` + manifest; returns the
    file path."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _leaves(tree)}
    fname = os.path.join(path, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    manifest = {"step": step, "file": os.path.basename(fname),
                "extra": extra or {}}
    mtmp = fname + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, allow_nan=False)
    os.replace(mtmp, os.path.join(path, "manifest.json"))
    return fname


def restore(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like``, each leaf in the dtype and
    on the device of ``like``'s. Returns (tree, manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, manifest["file"])) as data:
        def build(node, prefix=()):
            if isinstance(node, dict):
                return type(node)((k, build(v, prefix + (str(k),)))
                                  for k, v in node.items())
            if isinstance(node, (list, tuple)):
                return type(node)(build(v, prefix + (str(i),))
                                  for i, v in enumerate(node))
            return torch.from_numpy(data["/".join(prefix)]).to(
                device=node.device, dtype=node.dtype)

        return build(like), manifest


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)["step"]
    except FileNotFoundError:
        return None
