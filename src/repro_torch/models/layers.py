"""Fault plumbing of the model blocks, the counterpart of the fault part of
``repro/models/layers.py`` (norms, attention and the transformer blocks
come with the transformer slice).

Row convention: a rate is ``None`` (the float path: no quantization at
all), or a float32 tensor ``[R]`` of per-row rates, one row per candidate
of the population (rate 0 is fake-quantization).  Corrupting a float
tensor at a ``[R]`` rate needs the tensor's leading row axis; corrupting a
resident :class:`QTensor` reads the one shared integer copy and returns
``[R, ...]``.

On a CUDA tensor every corruption is one of the kernels in ``csrc/``
(``quant_bitflip`` for floats, ``bitflip`` for resident integers,
``fault_matmul`` inside the dense contraction); on a CPU tensor it is
their plain version.  The reference's ``FAULT_IMPL`` switch has no
counterpart: its two settings are bitwise equal.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.kernels import ops as kops
from repro_torch.kernels.faultmodel import FAULT_MODELS
from repro_torch.quant.fixedpoint import QuantSpec, quantize

__all__ = ["QTensor", "FaultedQ", "quantize_leaf", "quantize_params",
           "dequantize_params", "maybe_corrupt", "corrupt_params",
           "fault_dense", "set_fault_bits", "set_fault_model"]

# Fixed-point width of the transformer-path fault model (the paper's
# 16-bit / 4-LSB example); the CNNs pass their INT8-class widths
# explicitly.  Read when a block runs.
FAULT_BITS = 16
FAULT_LSBS = 4


def set_fault_bits(bits: int = 16, faulty_bits: int = 4):
    global FAULT_BITS, FAULT_LSBS
    if not 0 < faulty_bits <= bits:
        raise ValueError(f"need 0 < faulty_bits <= bits, got {faulty_bits}, {bits}")
    FAULT_BITS = bits
    FAULT_LSBS = faulty_bits


FAULT_MODEL = "flip"
MBU_WIDTH = 2


def set_fault_model(fault_model: str = "flip", mbu_width: int = 2):
    global FAULT_MODEL, MBU_WIDTH
    if fault_model not in FAULT_MODELS:
        raise ValueError(f"unknown fault_model {fault_model!r}")
    FAULT_MODEL = fault_model
    MBU_WIDTH = mbu_width


@dataclasses.dataclass(frozen=True, eq=False)
class QTensor:
    """A weight leaf kept quantized in residence (integers + scale).

    It is a leaf of the param tree at the flatten position of the float
    leaf it replaces, so per-leaf fault seeds (``seed + 977 * j``) match
    the float path's."""

    qw: torch.Tensor              # integer storage, original shape
    scale: torch.Tensor           # per-tensor float32 scale (0-d)
    bits: int
    dtype: torch.dtype            # original float dtype
    matmul: bool = False          # consumed by a dense contraction?

    @property
    def shape(self):
        return self.qw.shape

    @property
    def ndim(self):
        return self.qw.ndim

    def dequant(self) -> torch.Tensor:
        return (self.qw.to(torch.float32) * self.scale).to(self.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class FaultedQ:
    """A matmul-marked QTensor with its fault parameters, consumed by
    :func:`fault_dense` at the contraction site."""

    qw: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype
    rate: torch.Tensor            # [R] per-row rates
    seed: int
    faulty_bits: int
    fault_model: str = "flip"
    mbu_width: int = 2


def quantize_leaf(x: torch.Tensor, bits: int, *, matmul: bool = False) -> QTensor:
    """Quantize one float leaf into residence; ``(q, scale)`` are bitwise
    what ``quant_bitflip`` derives from ``x`` on the fly."""
    q, scale = quantize(x, QuantSpec(bits=bits))
    return QTensor(qw=q, scale=scale, bits=bits, dtype=x.dtype, matmul=matmul)


def quantize_params(params, bits: int, matmul_pred=None):
    """Quantize every float leaf into :class:`QTensor`; ``matmul_pred(path,
    leaf)`` (path: the tuple of keys and indices) marks the leaves that a
    dense contraction consumes through :func:`fault_dense`."""
    def rec(t, path):
        if isinstance(t, dict):
            return {k: rec(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v, path + (i,)) for i, v in enumerate(t))
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            mm = bool(matmul_pred(path, t)) if matmul_pred else False
            return quantize_leaf(t, bits, matmul=mm)
        return t
    return rec(params, ())


def dequantize_params(params):
    """Undo :func:`quantize_params` (fake-quantized floats back)."""
    return tree_map(lambda leaf: leaf.dequant() if isinstance(leaf, QTensor)
                    else leaf, params)


def maybe_corrupt(x, rate, seed, bits: int | None = None,
                  faulty_bits: int | None = None,
                  fault_model: str | None = None,
                  mbu_width: int | None = None):
    """Quantize -> corrupt -> dequantize when ``rate`` is not None.

    A float ``x`` goes through ``quant_bitflip`` (with a ``[R]`` rate it
    must carry the row axis); a :class:`QTensor` corrupts its resident
    integers with ``bitflip`` (``[R, ...]`` out), or defers to the
    contraction as a :class:`FaultedQ` when matmul-marked, or dequantizes
    when ``rate`` is None."""
    faulty_bits = FAULT_LSBS if faulty_bits is None else faulty_bits
    fault_model = FAULT_MODEL if fault_model is None else fault_model
    mbu_width = MBU_WIDTH if mbu_width is None else mbu_width
    if isinstance(x, QTensor):
        if rate is None:
            return x.dequant()
        if x.matmul:
            return FaultedQ(qw=x.qw, scale=x.scale, dtype=x.dtype, rate=rate,
                            seed=seed, faulty_bits=faulty_bits,
                            fault_model=fault_model, mbu_width=mbu_width)
        # the kernel dequantizes in the same pass: float(q') * scale
        return kops.bitflip(x.qw, seed, rate, faulty_bits,
                            fault_model=fault_model, mbu_width=mbu_width,
                            scale=x.scale).to(x.dtype)
    if rate is None:
        return x
    bits = FAULT_BITS if bits is None else bits
    return kops.quant_bitflip(x.contiguous(), seed, rate, faulty_bits,
                              QuantSpec(bits), fault_model=fault_model,
                              mbu_width=mbu_width)


def corrupt_params(params, rate, seed, bits: int | None = None,
                   faulty_bits: int | None = None,
                   fault_model: str | None = None,
                   mbu_width: int | None = None):
    """Corrupt every float or :class:`QTensor` leaf (leaf ``j`` at seed
    ``seed + 977 * j``); ``rate`` None dequantizes."""
    if rate is None:
        return dequantize_params(params)
    leaves, treedef = tree_flatten(params)
    out = [maybe_corrupt(leaf, rate, seed + 977 * i, bits=bits,
                         faulty_bits=faulty_bits, fault_model=fault_model,
                         mbu_width=mbu_width)
           if isinstance(leaf, QTensor) or leaf.is_floating_point() else leaf
           for i, leaf in enumerate(leaves)]
    return tree_unflatten(treedef, out)


def fault_dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` whose weight may be fault-wrapped: a :class:`FaultedQ`
    runs the ``fault_matmul`` kernel (rows of ``x`` at their own rates), a
    clean :class:`QTensor` dequantizes first, a tensor multiplies as is
    (``[K, N]`` shared or ``[R, K, N]`` per row)."""
    if isinstance(w, FaultedQ):
        return kops.fault_matmul(x.contiguous(), w.qw, w.scale, w.seed, w.rate,
                                 w.faulty_bits, fault_model=w.fault_model,
                                 mbu_width=w.mbu_width)
    if isinstance(w, QTensor):
        w = w.dequant()
    if w.ndim == 3:      # per-row weights: one matmul per row, like the
        # conv loop, so a row never depends on how many rows share the call
        return torch.stack([torch.matmul(x[r], w[r])
                            for r in range(w.shape[0])])
    return torch.matmul(x, w)
