"""Checkpoint / resume for pipeline and SLAM state.

Port of the JAX package's ``utils/checkpoint.py``, in its numpy format: the
leaves of a flat dict or a dataclass of tensors go into one ``.npz`` as
``leaf_0 … leaf_n``, their key paths into a ``.json`` beside it, written the
way the JAX package writes its paths (``['key']`` for a dict key, ``.name``
for a dataclass field, ``[i]`` for a list item, joined by ``/``; dict keys
in sorted order). A checkpoint written by either package is therefore read
by the other. The format stores arrays and their paths only: restoring
runs no code from the file, which a pickle (``torch.save``) would. Orbax
directories, which the JAX package writes where orbax is installed, are
refused.

``mem://`` paths live in this process (:data:`_MEM_STORE`): the streaming
SLAM session resumes the back end once per window, and a disk round trip
per step is pure overhead there. A ``mem://`` "directory" behaves like a
rolling on-disk checkpoint of flat dicts; arrays are copied on save and on
restore so the store never aliases live mutable state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

_MEM_STORE: dict[str, dict] = {}


def _to_numpy(value) -> np.ndarray:
    """A copy of a tensor (on any device), array or scalar as numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value)


def checkpoint_exists(path: str) -> bool:
    """True if a checkpoint exists at ``path`` (disk or mem://)."""
    if path.startswith("mem://"):
        return path in _MEM_STORE
    return os.path.exists(path) or os.path.exists(path + ".npz")


def remove_checkpoint(path: str) -> None:
    """Delete the checkpoint(s) under ``path`` (mem:// prefix or disk).

    A :class:`~..models.streaming.SlamSession` stores rolling state under
    one mem:// prefix; without eviction every finished session would leak
    its final pose and observation buffers in :data:`_MEM_STORE` for the
    life of the process.
    """
    if path.startswith("mem://"):
        prefix = path.rstrip("/") + "/"
        for key in [k for k in _MEM_STORE if k == path or k.startswith(prefix)]:
            del _MEM_STORE[key]
        return
    for candidate in (path, path + ".npz", path + ".json"):
        if os.path.isdir(candidate):
            shutil.rmtree(candidate)
        elif os.path.exists(candidate):
            os.remove(candidate)


def flatten_with_paths(tree, prefix: str = ""):
    """``(paths, leaves)`` of a tree of dicts, dataclasses, lists and
    tuples, in the JAX package's order and path spelling (the checkpoint
    format; ``utils/debug.py`` and ``utils/profile.py`` walk trees with it
    too)."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for key, value in items:
        p, l = flatten_with_paths(value, f"{prefix}/{key}" if prefix else key)
        paths += p
        leaves += l
    return paths, leaves


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise RuntimeError(
            f"{path} is an orbax checkpoint; this package reads and writes "
            "the npz + JSON format only"
        )


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Save a flat dict or a dataclass of tensors; returns the path written.

    A stale orbax directory of the same name is removed after a successful
    save, so a resume can never read it.
    """
    name = f"step_{step}" if step is not None else "state"
    if path.startswith("mem://"):
        if not isinstance(tree, dict):
            raise TypeError("mem:// checkpoints take flat dicts")
        key = path.rstrip("/") + "/" + name
        _MEM_STORE[key] = {k: _to_numpy(v) for k, v in tree.items()}
        return key
    os.makedirs(path, exist_ok=True)
    ckpt_path = os.path.abspath(os.path.join(path, name))
    paths, leaves = flatten_with_paths(tree)
    np.savez(ckpt_path + ".npz", **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)})
    with open(ckpt_path + ".json", "w") as f:
        json.dump({"paths": paths}, f)
    if os.path.isdir(ckpt_path):
        shutil.rmtree(ckpt_path)
    return ckpt_path + ".npz"


def _load(path: str) -> tuple[list[str], dict[str, np.ndarray]]:
    """``(paths, {"leaf_i": array})`` of an npz + JSON checkpoint."""
    _refuse_orbax(path)
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        leaves = {k: data[k] for k in data.files}
    with open(npz[:-4] + ".json") as f:
        return json.load(f)["paths"], leaves


def restore_checkpoint_flat(path: str) -> dict:
    """Template-free restore of a checkpoint saved from a FLAT dict.

    Returns ``{key: np.ndarray}``. SLAM resume (``models/slam.py``) uses it
    where leaf shapes (observation counts, frame index) are unknown until
    the checkpoint is read, so no template can exist.
    """
    if path.startswith("mem://"):
        return {k: np.array(v) for k, v in _MEM_STORE[path].items()}
    paths, leaves = _load(path)

    def clean(p):
        # Flat-dict key paths are spelled "['key']".
        return p[2:-2] if p.startswith("['") and p.endswith("']") else p

    return {clean(p): leaves[f"leaf_{i}"] for i, p in enumerate(paths)}


def restore_checkpoint(path: str, like):
    """Restore a checkpoint into the structure of ``like``: a flat dict or a
    dataclass whose tensor leaves give each restored tensor its dtype and
    device. Leaves are matched by path."""
    paths, leaves = _load(path)
    by_path = {p: leaves[f"leaf_{i}"] for i, p in enumerate(paths)}
    like_paths, like_leaves = flatten_with_paths(like)
    missing = [p for p in like_paths if p not in by_path]
    if missing:
        raise KeyError(f"{path} holds no leaves {missing}")
    restored = [
        torch.as_tensor(by_path[p], dtype=l.dtype, device=l.device)
        if isinstance(l, torch.Tensor)
        else by_path[p]
        for p, l in zip(like_paths, like_leaves)
    ]
    if isinstance(like, dict):
        return {k: v for (k, _), v in zip(sorted(like.items()), restored)}
    names = [f.name for f in dataclasses.fields(like)]
    return dataclasses.replace(like, **dict(zip(names, restored)))
