"""Dependency-free checkpoints: a tree of tensors <-> ``arrays.npz`` plus
``structure.json``, the reference's format (``repro.training.checkpoint``).

Leaf ``i`` of a tree is ``leaf_{i}`` in ``arrays.npz``, in
``jax.tree.flatten``'s order (``training/tree.py``: dict keys sorted, a
NamedTuple's fields in order), so either package reads the other's files.
``structure.json`` holds ``treedef`` (informational, never read back),
``n_leaves`` and ``meta``. bfloat16 tensors are written as float32 (numpy
has no bfloat16); a reference file's bfloat16 arrays (2-byte records without
a numpy type here) are read back bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.training import tree


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # bfloat16 records
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, tree_: Any, meta: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    leaves, treedef = tree.flatten(tree_)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)})
    with open(os.path.join(path, "structure.json"), "w") as f:
        json.dump({"treedef": tree.treedef_str(treedef), "n_leaves": len(leaves),
                   "meta": meta or {}}, f)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf checked against its
    shape, and given ``like``'s dtype and device."""
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves, treedef = tree.flatten(like)
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {i}: shape {arr.shape}, expected "
                             f"{tuple(ref.shape)}")
        out.append(_to_tensor(arr, ref))
    return tree.unflatten(treedef, out)


def checkpoint_meta(path: str) -> dict:
    with open(os.path.join(path, "structure.json")) as f:
        return json.load(f)["meta"]
