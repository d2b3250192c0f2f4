"""Fault-model hash in plain PyTorch, the counterpart of
``repro/kernels/faultmodel.py`` and the oracle of ``csrc/faultmodel.cuh``.

The PRNG is the counter-based lowbias32 hash over (seed, flat element
index, bit plane); ``u < rate`` selects a bit.  Every uint32 step runs in
int64 and is masked with ``& 0xFFFFFFFF``: PyTorch has no uint32 shift
on the CPU, and the multiply is split into 16-bit halves so no product
exceeds 2^49 (no signed overflow is relied on).

Fault models: ``"flip"`` (XOR of the selected LSBs), ``"stuck0"``
(AND-NOT), ``"stuck1"`` (OR) and ``"mbu"`` (a burst of ``mbu_width``
bits inside the ``faulty_bits`` window, its event and start drawn from
planes ``MBU_EVENT_PLANE`` and ``MBU_POS_PLANE``).

``rate`` broadcasts against the hash: a scalar, or a ``[R, 1, ...]``
tensor of per-row rates against a ``[n...]`` index, giving ``[R, n...]``
masks.  The hash itself depends only on (index, seed, plane), so it is
computed once and shared by every row.

``rate_threshold`` mirrors how ``csrc/faultmodel.cuh`` reads a rate: the
draw ``float(u >> 8) * 2^-24 < rate`` is the integer compare
``(u >> 8) < rate_threshold(rate)``, so a kernel converts no draw to float.
"""
from __future__ import annotations

import torch

__all__ = ["M1", "M2", "GOLDEN", "INV24", "FAULT_MODELS",
           "MBU_EVENT_PLANE", "MBU_POS_PLANE", "seed_u32", "lowbias32",
           "uniform01", "rate_threshold", "fault_mask", "apply_fault"]

M1 = 0x7FEB352D
M2 = 0x846CA68B
GOLDEN = 0x9E3779B9
INV24 = float(2.0 ** -24)
MASK32 = 0xFFFFFFFF

FAULT_MODELS = ("flip", "stuck0", "stuck1", "mbu")
MBU_EVENT_PLANE = 101
MBU_POS_PLANE = 102


def seed_u32(seed) -> int:
    """The seed as the hash reads it: int32, then its two's-complement
    uint32 bits (``seed.astype(uint32)`` in the reference)."""
    s = int(seed) & MASK32
    if s >= 1 << 31:                     # wrap to int32 first, as jnp.int32
        s -= 1 << 32
    return s & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 mixer on int64 tensors holding uint32 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 15)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def uniform01(idx: torch.Tensor, seed, plane: int) -> torch.Tensor:
    """float32 uniform in [0, 1) at 24-bit resolution for (idx, seed,
    plane); ``idx`` is an int64 tensor of flat indices."""
    h = lowbias32(idx + ((plane * GOLDEN) & MASK32))
    u = lowbias32(h ^ seed_u32(seed))
    return (u >> 8).to(torch.float32) * INV24


def rate_threshold(rate) -> torch.Tensor:
    """int64 ``T`` with ``(u >> 8) < T`` exactly when ``float(u >> 8) *
    2^-24 < rate``: ``min(ceil(rate * 2^24), 2^24)`` for ``rate > 0``, else
    0 (NaN included).  ``rate * 2^24`` and the ceiling are exact in
    float32."""
    r = torch.as_tensor(rate, dtype=torch.float32)
    t = torch.ceil(r * float(1 << 24)).clamp_max(float(1 << 24))
    return torch.where(r > 0, t, 0.0).to(torch.int64)


def fault_mask(idx: torch.Tensor, seed, rate, faulty_bits: int, *,
               fault_model: str = "flip", mbu_width: int = 2) -> torch.Tensor:
    """int32 mask of affected bits; ``rate`` is float32 (scalar or a
    tensor broadcasting against ``idx``)."""
    if fault_model not in FAULT_MODELS:
        raise ValueError(f"unknown fault_model {fault_model!r}; "
                         f"expected one of {FAULT_MODELS}")
    rate = torch.as_tensor(rate, dtype=torch.float32, device=idx.device)
    if fault_model == "mbu":
        width = max(1, min(mbu_width, faulty_bits))
        span = faulty_bits - width + 1
        u_ev = uniform01(idx, seed, MBU_EVENT_PLANE)
        u_pos = uniform01(idx, seed, MBU_POS_PLANE)
        start = torch.clamp_max((u_pos * span).to(torch.int32), span - 1)
        burst = torch.bitwise_left_shift(
            torch.full_like(start, (1 << width) - 1), start)
        burst = burst & ((1 << faulty_bits) - 1)
        return torch.where(u_ev < rate, burst, 0).to(torch.int32)
    mask = torch.zeros((), dtype=torch.int32, device=idx.device)
    for i in range(faulty_bits):
        u = uniform01(idx, seed, i)
        mask = mask | torch.where(u < rate, 1 << i, 0).to(torch.int32)
    return torch.broadcast_to(mask, torch.broadcast_shapes(idx.shape,
                                                           rate.shape))


def apply_fault(q: torch.Tensor, idx: torch.Tensor, seed, rate,
                faulty_bits: int, *, fault_model: str = "flip",
                mbu_width: int = 2) -> torch.Tensor:
    """Corrupt integer tensor ``q`` (broadcasting against the mask)."""
    if faulty_bits <= 0:
        return q
    mask = fault_mask(idx, seed, rate, faulty_bits, fault_model=fault_model,
                      mbu_width=mbu_width).to(q.dtype)
    if fault_model == "stuck0":
        return q & ~mask
    if fault_model == "stuck1":
        return q | mask
    return q ^ mask
