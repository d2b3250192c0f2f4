"""The collectives GSPMD inserts in the reference, made explicit over one
mesh axis of a row of slots, driven by this one process.

Each takes the slots' tensors in slot order (``xs[i]`` on the axis's
``i``-th slot) and returns one result a target device, moving payloads
with ``Tensor.to(device, non_blocking=True)``; nothing reads the host.
They are built from differentiable ops, so autograd runs through them.

  * :func:`all_gather`: the slots' pieces concatenated along ``dim``;
  * :func:`all_reduce`: the sum, in fp32, in slot order, rounded once to
    the input dtype;
  * :func:`reduce_scatter`: that sum split along ``dim``, piece ``i`` to
    target ``i``; :class:`ScatterSum` is the same fed one slot at a time,
    in slot order (the train step's gradients);
  * :func:`all_to_all`: target ``i`` gets piece ``i`` of every slot's
    split, concatenated;
  * :func:`scatter`: one slot's tensor split along ``dim``, piece ``i``
    to target ``i``;
  * :func:`broadcast`: a replicated activation handed to each slot: free
    in the forward (every slot holds it), an all-reduce in the backward
    (its gradients are summed).

:data:`BYTES` counts each kind's payload, summed over the targets, by the
conventions of the reference's ``launch/roofline.py`` docstring: an
all-gather counts its output bytes, an all-reduce 2x its input bytes,
the others their input bytes.  A collective's backward counts too (an
all-gather's is a reduce-scatter, a broadcast's an all-reduce).  This is
the port's counterpart of ``collective_bytes_from_hlo``.
"""
from __future__ import annotations

import collections

import torch

__all__ = ["BYTES", "reset_bytes", "total_bytes", "all_gather",
           "all_reduce", "reduce_scatter", "all_to_all", "scatter",
           "broadcast", "ScatterSum"]

BYTES: collections.Counter = collections.Counter()


def reset_bytes() -> None:
    BYTES.clear()


def total_bytes() -> int:
    return sum(BYTES.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count_backward(t: torch.Tensor, kind: str, factor: int) -> None:
    """Count ``factor`` x the bytes of ``t``'s gradient as ``kind`` when the
    backward reaches it."""
    if t.requires_grad:
        t.register_hook(lambda g: BYTES.update({kind: factor * _nbytes(g)}))


def _targets(xs, devices):
    return [x.device for x in xs] if devices is None else list(devices)


def all_gather(xs, dim: int, devices=None) -> list[torch.Tensor]:
    """``cat(xs, dim)`` on each of ``devices`` (default: each slot's own).
    One slot: the input itself, and no payload."""
    devs = _targets(xs, devices)
    if len(xs) == 1:
        return [xs[0].to(d, non_blocking=True) for d in devs]
    full = torch.cat([x.to(devs[0], non_blocking=True) for x in xs], dim)
    out = [full.to(d, non_blocking=True) for d in devs]
    BYTES["all_gather"] += len(devs) * _nbytes(full)
    for t in out:
        _count_backward(t, "reduce_scatter", 1)
    return out


def _sum_f32(xs, dev) -> torch.Tensor:
    acc = xs[0].to(dev, non_blocking=True).to(torch.float32)
    for x in xs[1:]:
        acc = acc + x.to(dev, non_blocking=True).to(torch.float32)
    return acc


def all_reduce(xs, devices=None) -> list[torch.Tensor]:
    """The slots' sum, in fp32 and slot order, rounded once to the input
    dtype, on each of ``devices``.  One slot: the input itself, and no
    payload."""
    devs = _targets(xs, devices)
    if len(xs) == 1:
        return [xs[0].to(d, non_blocking=True) for d in devs]
    BYTES["all_reduce"] += 2 * sum(_nbytes(x) for x in xs)
    total = _sum_f32(xs, devs[0]).to(xs[0].dtype)
    return [total.to(d, non_blocking=True) for d in devs]


def reduce_scatter(xs, dim: int, devices=None) -> list[torch.Tensor]:
    """The slots' fp32 sum in slot order, rounded once to the input dtype,
    split along ``dim`` into ``len(devices)`` pieces, piece ``i`` on
    ``devices[i]``."""
    devs = _targets(xs, devices)
    BYTES["reduce_scatter"] += sum(_nbytes(x) for x in xs)
    total = _sum_f32(xs, devs[0]).to(xs[0].dtype)
    return [p.to(d, non_blocking=True)
            for p, d in zip(total.chunk(len(devs), dim), devs)]


def all_to_all(xs, split_dim: int, cat_dim: int, devices=None
               ) -> list[torch.Tensor]:
    """Target ``i`` gets piece ``i`` of each slot's split along
    ``split_dim``, concatenated along ``cat_dim`` in slot order."""
    devs = _targets(xs, devices)
    BYTES["all_to_all"] += sum(_nbytes(x) for x in xs)
    parts = [x.chunk(len(devs), split_dim) for x in xs]
    return [torch.cat([p[i].to(d, non_blocking=True) for p in parts],
                      cat_dim) for i, d in enumerate(devs)]


def scatter(x: torch.Tensor, dim: int, devices) -> list[torch.Tensor]:
    """``x`` (on one slot) split along ``dim`` into ``len(devices)`` pieces
    (``chunk`` views), piece ``i`` on ``devices[i]``; counts its input
    bytes."""
    if len(devices) > 1:
        BYTES["scatter"] += _nbytes(x)
    return [p.to(d, non_blocking=True)
            for p, d in zip(x.chunk(len(devices), dim), devices)]


def broadcast(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """A replicated activation on each of ``devices``: no payload in the
    forward; its gradients' sum is an all-reduce, counted when the
    backward reaches it."""
    out = [x.to(d, non_blocking=True) for d in devices]
    if len(out) > 1:
        for t in out:
            _count_backward(t, "all_reduce", 2)
    return out


class ScatterSum:
    """A reduce-scatter fed one slot at a time, in slot order: ``add(pieces)``
    adds the next slot's input, already split into its targets' pieces,
    into fp32 accumulators ``acc`` (one a target, on its device), which
    hold :func:`reduce_scatter`'s sums before the rounding.  With one target
    a piece it is an all-reduce (``kind="all_reduce"``: the inputs count
    twice); ``kind=None`` over one slot moves nothing.  The bytes are
    counted as they are added."""

    def __init__(self, shapes, devices, kind: str | None = "reduce_scatter"):
        self.acc = [torch.zeros(s, dtype=torch.float32, device=d)
                    for s, d in zip(shapes, devices)]
        self.kind, self.factor = kind, 2 if kind == "all_reduce" else 1

    def add(self, pieces) -> None:
        for a, p in zip(self.acc, pieces):
            if self.kind is not None:
                BYTES[self.kind] += self.factor * _nbytes(p)
            a.add_(p.to(a.device, non_blocking=True))
