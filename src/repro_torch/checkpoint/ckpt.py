"""Atomic, resumable tree checkpoints (npz-based), the counterpart of
``repro/checkpoint/ckpt.py`` with its on-disk format: a directory
``ckpt_<step:08d>`` holding ``arrays.npz`` (each leaf under its key path
joined with ``"§"``, bfloat16 stored as float32, which holds it exactly)
and ``meta.json`` (``step`` and ``extra``), published by a rename, and a
``latest`` pointer replaced atomically.  A checkpoint written by either
package restores in the other, bitwise.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch._tree import tree_flatten_with_path, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step"]

_SEP = "§"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _flatten_with_paths(tree) -> dict:
    flat = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        flat[_key(path)] = t.numpy()
    return flat


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Atomic save; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    name = f"ckpt_{step:08d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **_flatten_with_paths(tree))
    meta = {"step": int(step), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    with open(os.path.join(directory, ".latest.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, ".latest.tmp"),
               os.path.join(directory, "latest"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    try:
        with open(os.path.join(directory, "latest")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore_checkpoint(directory: str, step: int, template):
    """Restore into the structure of ``template`` (shapes must match);
    each leaf takes its template leaf's dtype and device."""
    path = os.path.join(directory, f"ckpt_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves_t, spec = tree_flatten_with_path(template)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in leaves_t:
            key = _key(p)
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the template {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype))
    return tree_unflatten(spec, leaves), meta


def restore_latest(directory: str, template):
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore_checkpoint(directory, step, template)
