"""The evaluation mesh, the counterpart of ``repro/launch/mesh.py``'s
``make_eval_mesh`` and ``mesh_axes``.

The mesh is a plain ``(data=n, model=1)`` grid of ``torch.device``s: the
one agreement on device order between the evaluation engines
(``core/eval_engine.DeviceScheduler``) and the launch stack.  Built by
functions, never at import, so importing this module touches no card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["EvalMesh", "indexed_device", "local_devices", "make_eval_mesh",
           "mesh_axes"]


@dataclasses.dataclass(frozen=True, eq=False)
class EvalMesh:
    """A grid of devices with named axes: ``devices`` is an object array of
    ``torch.device`` of shape ``[n, 1]``."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def indexed_device(device) -> torch.device:
    """``torch.device(device)`` with a card's index filled in (``"cuda"`` is
    the current card), so it compares equal to a tensor's ``.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> list[torch.device]:
    """Every local card in index order (``cuda:0 .. count-1``), or the host
    where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_eval_mesh(n_devices: int, pool=None) -> EvalMesh:
    """``(data=n, model=1)`` mesh over the first ``n_devices`` of ``pool``:
    an ordered list of devices in which one may repeat (several slots on one
    device), by default :func:`local_devices`."""
    pool = local_devices() if pool is None else [indexed_device(d)
                                                 for d in pool]
    if not 1 <= n_devices <= len(pool):
        raise ValueError(f"make_eval_mesh({n_devices}) over a pool of "
                         f"{len(pool)} devices")
    grid = np.empty((n_devices, 1), dtype=object)
    for i, d in enumerate(pool[:n_devices]):
        grid[i, 0] = d
    return EvalMesh(grid)


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
