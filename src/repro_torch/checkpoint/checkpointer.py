"""Fault-tolerant checkpointing: the port of
``repro.checkpoint.checkpointer``, on the reference's on-disk format.

- atomic: a step is written into ``step_XXXXXXXX.tmp/``, its ``DONE``
  marker fsynced, then renamed to ``step_XXXXXXXX/``; a crash mid-save
  never corrupts the latest good checkpoint;
- resumable: ``latest_step`` finds the newest step with a ``DONE`` marker;
- self-describing: ``manifest.json`` holds {"step", "leaves": {path:
  {"file", "shape", "dtype"}}}, each leaf one ``leaf_%05d.npy`` numbered in
  sorted path order, bfloat16 stored as its uint16 bits (``np.save``
  cannot write bf16);
- ``restore_pytree`` checks every leaf's shape and dtype against a
  template and raises on a mismatch;
- ``Checkpointer`` keeps the last ``keep`` steps.

Paths name leaves as the reference's do (dict keys, list indices, named
tuple fields, joined with "/"), so either side restores a tree the other
saved when the two trees have the same structure.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten

_MANIFEST = "manifest.json"
_DONE = "DONE"

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16", torch.float64: "float64",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = arr.copy()                     # owned and contiguous, 0-d kept
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(tree, directory: str, step: int) -> str:
    """Atomic save of a tree of tensors: <dir>/step_<step>/ with one .npy
    a leaf, the manifest and DONE. Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (key, leaf) in enumerate(sorted(tree_paths(tree),
                                           key=lambda kv: kv[0])):
        fname = f"leaf_{i:05d}.npy"
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest[key] = {"file": fname, "shape": list(leaf.shape),
                         "dtype": _NAMES[leaf.dtype]}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    with open(os.path.join(tmp, _DONE), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _DONE)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_pytree(template, directory: str, step: int):
    """Restore step ``step`` into ``template``'s structure: each leaf on
    the template leaf's device. Raises KeyError for a leaf the checkpoint
    lacks and ValueError for a shape or dtype that differs from the
    template's."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)["leaves"]
    restored = []
    for key, leaf in tree_paths(template):
        meta = manifest.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(meta["shape"]) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(meta['shape'])} vs template "
                             f"{tuple(leaf.shape)}")
        if meta["dtype"] != _NAMES.get(leaf.dtype):
            raise ValueError(f"dtype mismatch for {key}: ckpt "
                             f"{meta['dtype']} vs template {leaf.dtype}")
        arr = np.load(os.path.join(d, meta["file"]))
        restored.append(_from_numpy(arr, meta["dtype"]).to(leaf.device))
    return tree_unflatten(template, restored)


class Checkpointer:
    """Keep-last-k policy and save/restore of named trees."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, **trees) -> str:
        path = save_pytree(trees, self.directory, step)
        self._gc()
        return path

    def restore(self, template_trees: Dict[str, Any],
                step: Optional[int] = None):
        """(step, trees) of ``step`` (the latest by default), or (None,
        None) when there is none."""
        step = step if step is not None else latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_pytree(template_trees, self.directory, step)

    def _gc(self):
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
