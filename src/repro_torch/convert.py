"""Carry parameters from the JAX reference into the port.

The CNN inits of the reference draw from ``jax.random``, which PyTorch
cannot redraw, so parity tests build params with the reference and
convert them (float32, bfloat16 and integer arrays, bitwise).  Nothing
here imports JAX: the input trees hold numpy
arrays (``jax.tree.map(np.asarray, params)``), or, for
:func:`quant_params_from_jax`, the reference's ``QTensor`` leaves, read by
their attributes.  Dict keys, nesting and layouts (HWIO, (K, N)) are kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.models.layers import QTensor

__all__ = ["params_from_jax", "quant_params_from_jax", "opt_state_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: carry the bits
        # across as uint16 and view them as bfloat16 again
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda"):
    """A tree of numpy arrays -> the same tree of torch tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def quant_params_from_jax(tree, device="cuda"):
    """A reference tree whose leaves are ``QTensor``s or arrays -> the
    port's tree of :class:`~repro_torch.models.layers.QTensor`s and
    tensors (bitwise the same integers and scales)."""
    dev = resolve_device(device)

    def leaf(a):
        if all(hasattr(a, f) for f in ("qw", "scale", "bits", "matmul")):
            dtype = getattr(torch, np.dtype(a.dtype).name)
            return QTensor(qw=_tensor(a.qw, dev), scale=_tensor(a.scale, dev),
                           bits=int(a.bits), dtype=dtype, matmul=bool(a.matmul))
        return _tensor(a, dev)

    return tree_map(leaf, tree)


def opt_state_from_jax(state, device="cuda"):
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves,
    bf16 moments included; ``jax.tree.map(np.asarray, state)``) -> the
    port's, bitwise, with ``step`` a 0-d int32 tensor."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"not an AdamW state: keys {sorted(state)}")
    out = params_from_jax({"m": state["m"], "v": state["v"]}, device)
    out["step"] = _tensor(np.asarray(state["step"], np.int32),
                          resolve_device(device))
    return out
