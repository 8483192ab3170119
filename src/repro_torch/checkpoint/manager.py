"""Fault-tolerant checkpointing: atomic step directories of per-leaf
``.npy`` files and a JSON manifest.

Port of ``repro.checkpoint.manager``, in its on-disk format: a step is
the directory ``step_XXXXXXXX/``, written as ``step_XXXXXXXX.tmp`` and
renamed (rename is atomic on POSIX, so a crashed writer never corrupts
the latest checkpoint; a ``.tmp`` directory is never read); it holds
``manifest.json``, ``{"step", "leaves": {key: {file, dtype, shape}}}``,
and one ``.npy`` a leaf, a bfloat16 leaf saved as its ``uint16`` bit
pattern with the dtype tag ``bfloat16``.  ``keep`` bounds how many
steps stay.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors or numpy arrays (``None`` holds no leaf).  A leaf's key is its
path rendered as ``jax.tree_util.keystr`` renders it -- ``['a']`` for a
dict key, ``[0]`` for a list or tuple index, ``.m`` for a NamedTuple
field -- so a directory either package writes for the same tree
restores in the other.  Restored leaves are tensors placed on the
device of the template's leaf (the CPU for a numpy leaf).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flattening order (dict keys
    sorted, sequences and NamedTuple fields in order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree, leaves: Any):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array to save and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------

    def save(self, step: int, tree) -> str:
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, leaf in _flatten(tree):
            arr, dtype = _host(leaf)
            fname = _sanitize(key) + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "dtype": dtype,
                             "shape": list(arr.shape)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------

    def restore(self, template, step: int | None = None):
        """Restore into the structure of ``template`` (the latest step
        unless ``step``).  Returns (tree of tensors, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        leaves = []
        for key, tmpl in _flatten(template):
            meta = manifest[key]
            raw = np.load(os.path.join(path, meta["file"]))
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(raw)
            t = t.reshape(tuple(meta["shape"]))
            if isinstance(tmpl, torch.Tensor):
                t = t.to(tmpl.device)
            leaves.append(t)
        return _unflatten(template, iter(leaves)), step
