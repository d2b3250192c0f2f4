"""Device meshes, the counterpart of ``repro/launch/mesh.py``.

A mesh is a grid of ``torch.device``s with named axes, driven by one
process: ``devices`` is an object array whose shape gives each axis's
size, and a device may repeat in it (several slots on one card).  The
evaluation engines (``core/eval_engine.DeviceScheduler``) and the launch
stack (``launch/steps.py``) enumerate devices through it, so they agree
on device order.  Built by functions, never at import, so importing this
module touches no card.

There is no fallback to the host: without a card, a mesh over the local
devices raises, and the caller passes its pool (``[cpu] * n`` in the CPU
tests).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Mesh", "indexed_device", "local_devices", "make_eval_mesh",
           "make_test_mesh", "make_production_mesh", "mesh_axes"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with named axes: ``devices`` is an object array of
    ``torch.device`` whose shape gives each axis's size, in
    ``axis_names`` order."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d grid of devices with "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def indexed_device(device) -> torch.device:
    """``torch.device(device)`` with a card's index filled in (``"cuda"`` is
    the current card), so it compares equal to a tensor's ``.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> list[torch.device]:
    """Every local card in index order (``cuda:0 .. count-1``).  Raises
    without a card: a caller that means the host passes its pool."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no card: torch.cuda.is_available() is False; pass a pool of "
            "devices (e.g. [torch.device('cpu')] * n) to run on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(shape, axes, pool, what: str) -> Mesh:
    """``shape`` grid over the first ``prod(shape)`` slots of ``pool`` (an
    ordered list of devices in which one may repeat; by default
    :func:`local_devices`), row-major."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    pool = local_devices() if pool is None else [indexed_device(d)
                                                 for d in pool]
    n = math.prod(shape)
    if n < 1 or n > len(pool):
        raise ValueError(f"{what} needs {n} devices, the pool holds "
                         f"{len(pool)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(pool[:n]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, pool=None) -> Mesh:
    """Single pod: ``(16, 16)`` over ``("data", "model")``; multi-pod:
    ``(2, 16, 16)`` over ``("pod", "data", "model")``, the leading pod axis
    carrying the AFarePart pipeline stages.  Raises, naming the count, when
    the pool holds fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, pool, f"make_production_mesh(multi_pod="
                 f"{multi_pod})")


def make_test_mesh(shape=(1, 1), axes=("data", "model"), pool=None) -> Mesh:
    """A small mesh over the local cards, or over ``pool``."""
    return _grid(shape, axes, pool, f"make_test_mesh({tuple(shape)})")


def make_eval_mesh(n_devices: int, pool=None) -> Mesh:
    """``(data=n, model=1)`` mesh over the first ``n_devices`` of ``pool``
    (by default :func:`local_devices`): the evaluation engine's pool of
    slots."""
    pool = local_devices() if pool is None else list(pool)
    if not 1 <= n_devices <= len(pool):
        raise ValueError(f"make_eval_mesh({n_devices}) over a pool of "
                         f"{len(pool)} devices")
    return _grid((n_devices, 1), ("data", "model"), pool,
                 f"make_eval_mesh({n_devices})")


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
