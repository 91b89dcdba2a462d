"""Checkpoint / resume for pipeline and SLAM state.

Port of the JAX package's ``utils/checkpoint.py``, in its numpy format: the
leaves of a flat dict or a dataclass of tensors go into one ``.npz`` as
``leaf_0 … leaf_n``, their key paths into a ``.json`` beside it, written the
way the JAX package writes its paths (``['key']`` for a dict key, ``.name``
for a dataclass field, ``[i]`` for a list item, joined by ``/``; dict keys
in sorted order). A checkpoint written by either package is therefore read
by the other. The format stores arrays and their paths only: restoring
runs no code from the file, which a pickle (``torch.save``) would.

Where orbax is installed, the JAX package saves a directory instead: an
orbax checkpoint in OCDBT with zarr v2 arrays. Both restores read it here
with the port's own readers (``utils/ocdbt.py``, ``utils/zstd.py``; no
orbax, tensorstore or zstandard), taking each leaf's keys from the
directory's ``_METADATA`` and matching them to the template's paths (a dict
key ``['key']``, a dataclass field ``.name``), as for npz. A directory that
is no OCDBT checkpoint raises a ``RuntimeError``; a read error propagates.
Saves stay npz + JSON, the format the JAX package itself writes where orbax
is absent.

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

from . import ocdbt

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


def _children(tree):
    """``(path piece, orbax key, child)`` of each child of a tree node, in
    the JAX package's order, or ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, path: str = "", keys: tuple = ()):
    """``(path, orbax keys, leaf)`` of every leaf of ``tree``."""
    children = _children(tree)
    if children is None:
        return [(path, keys, tree)]
    return [
        item
        for piece, key, child in children
        for item in _flatten(child, f"{path}/{piece}" if path else piece, (*keys, key))
    ]


def flatten_with_paths(tree, prefix: str = ""):
    """``(paths, leaves)`` of a tree of dicts, dataclasses, lists and
    tuples, in the JAX package's order and path spelling (the checkpoint
    format; ``utils/debug.py`` and ``utils/profile.py`` walk trees with it
    too)."""
    items = _flatten(tree, prefix)
    return [p for p, _, _ in items], [leaf for _, _, leaf in items]


# Leaf types of orbax's tree metadata that hold one zarr array each.
_ORBAX_ARRAYS = ("np.ndarray", "jax.Array", "scalar")


def _orbax_leaves(path: str) -> dict[tuple, np.ndarray]:
    """``{keys: array}`` of the orbax OCDBT checkpoint directory ``path``,
    keyed by each leaf's key tuple in ``_METADATA``."""
    meta_path = os.path.join(path, "_METADATA")
    if not (os.path.isfile(meta_path) and os.path.isfile(os.path.join(path, "manifest.ocdbt"))):
        raise RuntimeError(
            f"{path} is a directory but no orbax OCDBT checkpoint (it lacks _METADATA or "
            "manifest.ocdbt); this package reads orbax checkpoints in OCDBT with zarr v2, "
            "and npz + JSON"
        )
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise RuntimeError(
            f"{path} is an orbax checkpoint with use_ocdbt={meta.get('use_ocdbt')} and "
            f"use_zarr3={meta.get('use_zarr3')}; this package reads OCDBT with zarr v2 only"
        )
    db = ocdbt.Database(path)
    leaves = {}
    for name, entry in meta["tree_metadata"].items():
        kind = entry["value_metadata"]["value_type"]
        if kind not in _ORBAX_ARRAYS:
            raise RuntimeError(f"{path}: orbax leaf {name} of type {kind!r} is not an array")
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        leaves[keys] = ocdbt.read_zarr_v2(db, ".".join(keys))
    return leaves


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


def _load_npz(path: str) -> dict[str, np.ndarray]:
    """``{path: array}`` of an npz + JSON checkpoint."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        leaves = {k: data[k] for k in data.files}
    with open(npz[:-4] + ".json") as f:
        return {p: leaves[f"leaf_{i}"] for i, p in enumerate(json.load(f)["paths"])}


def restore_checkpoint_flat(path: str) -> dict:
    """Template-free restore of a checkpoint saved from a FLAT dict (npz +
    JSON, or an orbax directory of the JAX package).

    Returns ``{key: np.ndarray}``. SLAM resume (``models/slam.py``) uses it
    where leaf shapes (observation counts, frame index) are unknown until
    the checkpoint is read, so no template can exist.
    """
    if path.startswith("mem://"):
        return {k: np.array(v) for k, v in _MEM_STORE[path].items()}
    if os.path.isdir(path):
        # Without a template every key is taken for a dict key.
        by_path = {
            "/".join(f"[{k!r}]" for k in keys): v for keys, v in _orbax_leaves(path).items()
        }
    else:
        by_path = _load_npz(path)

    def clean(p):
        # Flat-dict key paths are spelled "['key']".
        return p[2:-2] if p.startswith("['") and p.endswith("']") else p

    return {clean(p): v for p, v in by_path.items()}


def restore_checkpoint(path: str, like):
    """Restore a checkpoint (npz + JSON, or an orbax directory of the JAX
    package) into the structure of ``like``: a flat dict or a dataclass
    whose tensor leaves give each restored tensor its dtype and device.
    Leaves are matched by path (an orbax leaf by its keys along the
    template's path)."""
    items = _flatten(like)
    like_paths = [p for p, _, _ in items]
    like_leaves = [leaf for _, _, leaf in items]
    if os.path.isdir(path):
        by_keys = _orbax_leaves(path)
        by_path = {p: by_keys[k] for p, k, _ in items if k in by_keys}
    else:
        by_path = _load_npz(path)
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
