"""Atomic, integrity-checked, resumable checkpoints (port of
repro/checkpoint/ckpt.py, with the same on-disk layout).

Layout:  <dir>/step_00001234/
             manifest.json       {step, meta, leaves: {key: {shape, dtype,
                                  crc32, file}}}
             leaf_00000.npy ...

Leaf keys are the reference's `jax.tree_util.keystr` strings
("['params']['segs'][0]['attn']['wq']"), built by the port's own tree
walk (dict keys in sorted order, list indices), so either package reads
the other's checkpoints of the same tree.  A bfloat16 leaf is written
as its 16-bit patterns (uint16 in the .npy) with "dtype": "bfloat16" in
the manifest; the reference stores bfloat16 through ml_dtypes and does
not read these back as numbers.

Write protocol: serialize into ``<dir>/.tmp_step_N`` then ``os.replace``
to the final name -- a crash mid-write never produces a directory that
parses as a checkpoint.  Load protocol: newest step whose manifest
exists AND whose every leaf passes a crc32 check; corrupt or partial
checkpoints are skipped.  Tensors are copied to the host to be written.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


class CheckpointShapeError(ValueError):
    """A checkpoint leaf's shape differs from the tree it is read into
    (the elastic re-mesh path catches it)."""


def _key_paths(tree, prefix=""):
    """(keystr, leaf) of every leaf, in tree_map's visiting order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _key_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _key_paths(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {key: _to_numpy(leaf) for key, leaf in _key_paths(tree)}


def _unflatten_into(tree_like, leaves: Dict[str, torch.Tensor]):
    vals = {}
    for key, proto in _key_paths(tree_like):
        t = leaves[key]
        shape = tuple(proto.shape) if hasattr(proto, "shape") else ()
        if tuple(t.shape) != shape:
            raise CheckpointShapeError(f"{key}: checkpoint {tuple(t.shape)}"
                                       f", tree {shape}")
        if isinstance(proto, torch.Tensor):
            t = t.to(device=proto.device, dtype=proto.dtype)
        vals[key] = t
    return _rebuild(tree_like, vals)


def _rebuild(tree, vals, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], vals, f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, vals, f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return vals[prefix]


def save_checkpoint(directory: str, step: int, tree,
                    meta: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:010d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for i, (key, (arr, dtype)) in enumerate(_flatten(tree).items()):
        fname = f"leaf_{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype,
                                   "crc32": crc, "file": fname}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _validate(path: str) -> Optional[dict]:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isfile(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for rec in manifest["leaves"].values():
            with open(os.path.join(path, rec["file"]), "rb") as fh:
                if zlib.crc32(fh.read()) != rec["crc32"]:
                    return None
        return manifest
    except (OSError, ValueError, KeyError):
        return None


def list_checkpoints(directory: str):
    if not os.path.isdir(directory):
        return []
    return [os.path.join(directory, name)
            for name in sorted(os.listdir(directory))
            if name.startswith("step_")]


def load_checkpoint(directory: str, tree_like=None,
                    step: Optional[int] = None
                    ) -> Optional[Tuple[int, Any, dict]]:
    """Newest VALID checkpoint (or exact step).  Returns (step, tree, meta)
    with `tree` structured like `tree_like` (tensors on its leaves'
    devices and dtypes) or a flat {key: CPU tensor} dict.  Raises
    CheckpointShapeError if a leaf's shape differs from tree_like's."""
    cands = list_checkpoints(directory)
    if step is not None:
        cands = [c for c in cands if c.endswith(f"step_{step:010d}")]
    for path in reversed(cands):
        manifest = _validate(path)
        if manifest is None:
            continue
        leaves = {key: _to_tensor(np.load(os.path.join(path, rec["file"])),
                                  rec["dtype"])
                  for key, rec in manifest["leaves"].items()}
        tree = (leaves if tree_like is None
                else _unflatten_into(tree_like, leaves))
        return manifest["step"], tree, manifest.get("meta", {})
    return None


class CheckpointManager:
    """Cadenced saves + rotation + resume."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree, meta: Optional[dict] = None,
                   force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return None
        path = save_checkpoint(self.directory, step, tree, meta)
        self._rotate()
        return path

    def _rotate(self):
        cands = list_checkpoints(self.directory)
        for old in cands[: max(0, len(cands) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    def restore(self, tree_like=None):
        return load_checkpoint(self.directory, tree_like)
