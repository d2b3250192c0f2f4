"""Sharding rules, the counterpart of ``repro/launch/shardings.py``: param,
batch, cache and optimizer-state partition specs per (arch, shape), and
the placement of a tree by its specs over a :class:`~.mesh.Mesh`.

The rules (the reference's, spec for spec):
  * params, FSDP x TP: column-parallel projections (wq/wk/wv/w1/w3,
    in-projections) are ``P(..., "data", "model")``, row-parallel ones
    (wo/w2/out-projections) ``P(..., "model", "data")``; embeddings
    vocab-parallel ``P("model", "data")``, the head ``P("data", "model")``;
    a dimension an axis does not divide is left whole (``_divisible``);
  * batch: the leading batch dimension over ``"data"`` (and over
    ``("pod", "data")`` for multi-pod serving at batch >= 32);
  * decode caches: attention K/V/pos sequence-sharded over ``"model"``
    (flash-decode), batch over ``"data"``; recurrent states' width or heads
    over ``"model"``;
  * optimizer state: the params' specs for ``m`` and ``v``, the step whole.

A spec is :class:`P`, a tuple with one entry a leading dimension of the
leaf (None: whole; an axis name, or a tuple of names with the first the
major: split over those axes), trailing dimensions whole; it compares
equal, as a tuple, to the reference's ``PartitionSpec``.

:func:`shard_tree` puts each mesh slot's local slice of every leaf on that
slot's device, :func:`gather_tree` puts the slices back together.  The
steps (``launch/steps.py``) place batches and caches with them, and the
pipeline its stage stacks.  :func:`place_params` / :func:`place_opt_state`
lay params and AdamW state out by :func:`param_specs` /
:func:`opt_state_specs` (FSDP x tensor parallelism; :func:`gather_params`
and :func:`gather_opt_state` undo it), :func:`row_params` shows one data
row the params as ``layers.Sharded`` leaves over its model slots, and
:func:`owned` marks the slots that hold a distinct shard of each leaf
(the ones a global norm counts).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch._tree import (tree_flatten, tree_flatten_with_path,
                               tree_unflatten)
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.layers import Sharded

__all__ = ["P", "param_specs", "batch_specs", "cache_pspecs",
           "opt_state_specs", "logical_name", "shard_tree", "gather_tree",
           "place_params", "gather_params", "place_opt_state",
           "gather_opt_state", "row_params", "owned", "slot_index",
           "local_bytes", "spec_axes"]

_COL = ("wq", "wk", "wv", "w1", "w3", "in_x", "in_g", "in_proj")
_ROW = ("wo", "w2", "out", "out_proj")


class P(tuple):
    """A partition spec (see the module docstring)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def logical_name(path) -> str:
    """A leaf's path as ``"groups/b0/attn/wq"``."""
    return "/".join(str(p) for p in path)


def _leaf_spec(name: str, ndim: int) -> P:
    last = name.rsplit("/", 1)[-1]
    trailing: tuple[Any, ...]
    if last == "embed":
        trailing = ("model", "data")
    elif last == "lm_head":
        trailing = ("data", "model")
    elif last == "router":
        trailing = ("data", None)
    elif last in _COL:
        trailing = ("data", "model")
    elif last in _ROW:
        trailing = ("model", "data")
    elif last == "conv":
        trailing = (None, "model")       # [K, W] depthwise: width over model
    else:
        # 1-D norms / biases / scalars: replicate
        trailing = ()
    lead = ndim - len(trailing)
    if lead < 0:      # e.g. 1-D leaf caught by a 2-D rule; replicate
        return P()
    return P(*((None,) * lead + trailing))


def _axes(ax) -> tuple[str, ...]:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def spec_axes(spec: P) -> set:
    """Every axis ``spec`` splits some dimension over."""
    return {a for ax in spec for a in _axes(ax)}


def _divisible(spec: P, shape, mesh) -> P:
    """Drop axes whose dimension is not divisible by the mesh axis size
    (e.g. vocab 50280 on a 16-way axis -> replicate that dim).  Reads only
    ``mesh.axis_names`` and ``mesh.devices.shape``."""
    if mesh is None:
        return spec
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        total = math.prod(sizes.get(a, 1) for a in _axes(ax))
        out.append(ax if dim % total == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_specs(params, mesh=None) -> Any:
    """Spec tree mirroring the param tree (single-pod rules; stacked group
    axes lead as None, sharded only on the trailing weight dims)."""
    flat, treedef = tree_flatten_with_path(params)
    specs = [_divisible(_leaf_spec(logical_name(path), leaf.ndim),
                        leaf.shape, mesh)
             for path, leaf in flat]
    return tree_unflatten(treedef, specs)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                multi_pod: bool = False) -> dict:
    """Specs for the input batch dict of ``configs.input_specs``."""
    B = shape.global_batch
    if multi_pod and shape.kind != "train":
        bdim = ("pod", "data") if B >= 32 else None
    else:
        bdim = "data" if B >= 2 else None
    out: dict[str, P] = {}
    if shape.kind == "decode":
        out["tokens"] = P(bdim)
        out["positions"] = P(bdim)
        if cfg.is_encdec:
            out["enc_embeds"] = P(bdim, None, None)
        return out
    for key in ("tokens", "labels"):
        out[key] = P(bdim, None)
    out["embeds"] = P(bdim, None, None)
    out["enc_embeds"] = P(bdim, None, None)
    return out


def cache_pspecs(cfg: ArchConfig, shape: ShapeSpec, *,
                 multi_pod: bool = False) -> dict:
    """Specs for the decode cache (``models.transformer.init_cache``'s
    layout: leading group axis, then batch)."""
    B = shape.global_batch
    if multi_pod:
        bdim = ("pod", "data") if B >= 32 else None
        seq = ("pod", "model") if B < 32 else "model"
    else:
        bdim = "data" if B >= 2 else None
        seq = "model"
    entry: dict[str, Any] = {}
    for s, kind in enumerate(cfg.block_pattern):
        if kind in ("attn", "local", "global"):
            entry[f"b{s}"] = {
                "k": P(None, bdim, seq, None, None),
                "v": P(None, bdim, seq, None, None),
                "pos": P(None, bdim, seq),
            }
        elif kind == "rglru":
            entry[f"b{s}"] = {
                "conv": P(None, bdim, None, "model"),
                "h": P(None, bdim, "model"),
            }
        elif kind == "ssd":
            entry[f"b{s}"] = {
                "conv": P(None, bdim, None, "model"),
                "h": P(None, bdim, "model", None, None),
            }
    return entry


def opt_state_specs(pspecs) -> dict:
    """AdamW state mirrors param sharding (m, v) + replicated step."""
    return {"m": pspecs, "v": pspecs, "step": P()}


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
def _bounds(spec: P, shape, mesh, coords: dict) -> list[tuple[int, int]]:
    """``(start, length)`` of each of the first ``len(spec)`` dimensions in
    the slot at ``coords`` (axis -> index)."""
    out = []
    for dim, ax in zip(shape, spec):
        axes = _axes(ax)
        n, idx = 1, 0
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {mesh.axis_names}")
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dimension {dim} of a leaf of shape "
                             f"{tuple(shape)} does not split {n} ways "
                             f"({spec})")
        out.append((idx * (dim // n), dim // n))
    return out


def _slots(mesh):
    """``(flat index, device, coords)`` of every slot, row-major."""
    for i, dev in enumerate(mesh.devices.flat):
        idx = np.unravel_index(i, mesh.devices.shape)
        yield i, dev, dict(zip(mesh.axis_names, map(int, idx)))


def _leaves(tree, specs):
    """``([(path, leaf, spec), ...], treedef)`` of ``tree``, each leaf's
    spec looked up by its path in ``specs`` (which may hold keys the tree
    lacks)."""
    flat, treedef = tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        spec = specs
        for k in path:
            spec = None if isinstance(spec, P) else spec[k]
        if not (isinstance(spec, P) and isinstance(leaf, torch.Tensor)):
            raise TypeError(f"the spec at {logical_name(path)} is {spec!r} "
                            f"and its leaf a {type(leaf).__name__}")
        out.append((path, leaf, spec))
    return out, treedef


def shard_tree(tree, specs, mesh) -> list:
    """One tree a mesh slot (row-major over ``mesh.devices``): slot ``i``'s
    local slice of every leaf of ``tree``, a fresh contiguous copy on
    ``mesh.devices.flat[i]``.  A dimension split over axes of total size
    ``n`` must divide ``n`` ways; slots that differ only along axes a leaf
    is not split over hold equal copies."""
    leaves, treedef = _leaves(tree, specs)
    out = []
    for _, dev, coords in _slots(mesh):
        local = []
        for _, leaf, spec in leaves:
            piece = leaf
            for d, (start, n) in enumerate(_bounds(spec, leaf.shape, mesh,
                                                   coords)):
                piece = piece.narrow(d, start, n)
            local.append(piece.to(dev, copy=True,
                                  memory_format=torch.contiguous_format))
        out.append(tree_unflatten(treedef, local))
    return out


def gather_tree(placed: list, specs, mesh, device=None):
    """The inverse of :func:`shard_tree`: every leaf put back together from
    its slots' slices, on ``device`` (default: the mesh's first)."""
    device = mesh.devices.flat[0] if device is None else device
    per_slot = [tree_flatten(t)[0] for t in placed]
    leaves, treedef = _leaves(placed[0], specs)
    full = []
    for j, (_, leaf, spec) in enumerate(leaves):
        used = spec_axes(spec)
        shape = list(leaf.shape)
        for d, ax in enumerate(spec):
            shape[d] *= math.prod(mesh.shape[a] for a in _axes(ax))
        out = torch.empty(shape, dtype=leaf.dtype, device=device)
        for i, _, coords in _slots(mesh):
            if any(coords[a] for a in mesh.axis_names if a not in used):
                continue                       # a copy of another slot's
            view = out
            for d, (start, n) in enumerate(_bounds(spec, shape, mesh,
                                                   coords)):
                view = view.narrow(d, start, n)
            view.copy_(per_slot[i][j])
        full.append(out)
    return tree_unflatten(treedef, full)


# --------------------------------------------------------------------------
# params and optimizer state laid out by their specs
# --------------------------------------------------------------------------
def place_params(params, mesh) -> list:
    """One tree a mesh slot: every leaf's local slice by
    :func:`param_specs` (``shard_tree``)."""
    return shard_tree(params, param_specs(params, mesh), mesh)


def gather_params(placed: list, like, mesh, device=None):
    """The inverse of :func:`place_params`; ``like`` is the whole tree or
    its stand-in (``steps.abstract_params``), whose shapes give the
    specs."""
    return gather_tree(placed, param_specs(like, mesh), mesh, device)


def place_opt_state(state: dict, like, mesh) -> list:
    """AdamW state ``{"m", "v", "step"}`` laid out by
    :func:`opt_state_specs`: one ``{"m", "v", "step"}`` a slot."""
    return shard_tree(state, opt_state_specs(param_specs(like, mesh)), mesh)


def gather_opt_state(placed: list, like, mesh, device=None) -> dict:
    """The inverse of :func:`place_opt_state`."""
    return gather_tree(placed, opt_state_specs(param_specs(like, mesh)),
                       mesh, device)


def slot_index(mesh, coords: dict) -> int:
    """The row-major flat index of the slot at ``coords``."""
    return int(np.ravel_multi_index(
        tuple(coords[a] for a in mesh.axis_names), mesh.devices.shape))


def _dim_of(spec: P, axis: str):
    """The dimension of ``spec`` split over ``axis`` (None: none)."""
    for d, ax in enumerate(spec):
        if axis in _axes(ax):
            return d
    return None


def row_params(placed: list, specs, mesh, row: dict):
    """The param tree as the data row at ``row`` (the coordinates of every
    axis but ``"model"``) sees it: each leaf a ``layers.Sharded`` over the
    row's model slots, each slot holding its pieces along ``"data"`` (all
    its model column's data slots' when the leaf is split over ``"data"``,
    else its own).  Specs name ``"data"`` and ``"model"`` only."""
    leaves, treedef = _leaves(placed[0], specs)
    nm, nd = mesh.shape["model"], mesh.shape["data"]
    flat = [tree_flatten(t)[0] for t in placed]
    cols = [dict(row, model=m) for m in range(nm)]
    devs = tuple(mesh.devices.flat[slot_index(mesh, c)] for c in cols)
    out = []
    for j, (_, _, spec) in enumerate(leaves):
        ddim, mdim = _dim_of(spec, "data"), _dim_of(spec, "model")
        datas = range(nd) if ddim is not None else [row["data"]]
        parts = tuple(tuple(flat[slot_index(mesh, dict(c, data=d))][j]
                            for d in datas) for c in cols)
        out.append(Sharded(parts, devs, ddim, mdim))
    return tree_unflatten(treedef, out)


def owned(tree, specs, mesh) -> list:
    """One tree of bools a slot, over ``tree``'s structure: whether the
    slot's slice of each leaf is the first copy of its shard (every
    coordinate along an axis the leaf is not split over is 0), the slices
    :func:`gather_tree` reads."""
    leaves, treedef = _leaves(tree, specs)
    out = []
    for _, _, coords in _slots(mesh):
        out.append(tree_unflatten(treedef, [
            not any(coords[a] for a in mesh.axis_names
                    if a not in spec_axes(spec))
            for _, _, spec in leaves]))
    return out


def local_bytes(tree, specs, mesh) -> int:
    """Bytes of one slot's local slices of ``tree`` (stand-ins will do)
    laid out by ``specs``: every dimension divided by the size of the axes
    it is split over."""
    leaves, _ = _leaves(tree, specs)
    total = 0
    for _, leaf, spec in leaves:
        n = leaf.numel()
        for ax in spec:
            n //= math.prod(mesh.shape[a] for a in _axes(ax))
        total += n * leaf.element_size()
    return total
