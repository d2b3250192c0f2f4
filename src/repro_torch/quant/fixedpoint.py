"""Symmetric fixed-point quantization (the paper's N_q-bit 2's-complement
model), the counterpart of ``repro/quant/fixedpoint.py``.

    q  = clip(round(x / scale), -2^(N_q-1), 2^(N_q-1) - 1)
    x' = q * scale

``torch.round`` rounds half to even, like ``jnp.round``.  The scale is
``max(amax, finfo(float32).tiny) * fl32(1 / qmax)``: the reference writes
``amax / qmax``, but every jitted reference path (``quantize``, the
``*_ref`` oracles, the Pallas wrappers) is rewritten by XLA's algebraic
simplifier into a multiply by the float32 reciprocal of the constant, and
the two differ in the last bit for ~6% of tensors.  An all-zero tensor
gets a subnormal scale, never zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["QuantSpec", "compute_scale", "quantize", "dequantize",
           "fake_quant", "quantize_tree", "dequantize_tree"]

TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Fixed-point format: signed width ``bits``; per-tensor scale, or
    per-channel along ``per_channel_axis``."""

    bits: int = 16
    per_channel_axis: int | None = None

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def inv_qmax(self) -> float:
        """fl32(1 / qmax), the factor the scale is computed with."""
        return float(np.float32(1.0) / np.float32(self.qmax))

    @property
    def storage_dtype(self) -> torch.dtype:
        # int8 for <= 8 bits; wider formats keep their value range in int32
        return torch.int8 if self.bits <= 8 else torch.int32


def compute_scale(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Symmetric float32 scale so that max|x| -> qmax.  Never zero."""
    if spec.per_channel_axis is None:
        amax = x.abs().amax()
    else:
        ax = spec.per_channel_axis % x.ndim
        dims = tuple(i for i in range(x.ndim) if i != ax)
        amax = x.abs().amax(dim=dims, keepdim=True)
    return torch.clamp_min(amax.to(torch.float32), TINY) * spec.inv_qmax


def quantize(x: torch.Tensor, spec: QuantSpec = QuantSpec()
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q, scale)`` with ``q`` in ``spec.storage_dtype``."""
    scale = compute_scale(x, spec)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    spec.qmin, spec.qmax)
    return q.to(spec.storage_dtype), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def fake_quant(x: torch.Tensor, spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """Quantize-dequantize round trip."""
    q, scale = quantize(x, spec)
    return dequantize(q, scale, dtype=x.dtype)


def quantize_tree(tree, spec: QuantSpec = QuantSpec()):
    """Quantize every float leaf of a tree: ``(q_tree, scale_tree)``; any
    other leaf passes through with scale 1.0."""
    leaves, spec_tree = tree_flatten(tree)
    qs, scales = [], []
    for leaf in leaves:
        if leaf.is_floating_point():
            q, s = quantize(leaf, spec)
        else:
            q, s = leaf, torch.tensor(1.0, dtype=torch.float32,
                                      device=leaf.device)
        qs.append(q)
        scales.append(s)
    return tree_unflatten(spec_tree, qs), tree_unflatten(spec_tree, scales)


def dequantize_tree(q_tree, scale_tree, spec: QuantSpec = QuantSpec(),
                    dtype: torch.dtype = torch.float32):
    """Every integer leaf times its scale, in ``dtype`` (a leaf that was
    an integer before :func:`quantize_tree` too); float leaves pass."""
    del spec        # the value range is in the integers already
    return tree_map(lambda q, s: q if q.is_floating_point()
                    else dequantize(q, s, dtype), q_tree, scale_tree)
