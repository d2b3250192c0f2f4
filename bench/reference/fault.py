"""The fault model in plain PyTorch, written from its definition (AFarePart,
Sec. III: transient soft errors flip the ``faulty_bits`` least-significant
bits of N_q-bit fixed-point tensors, each bit at the tensor's rate).

A tensor is quantized symmetrically with one scale a row:

    scale = max(max|x|, FLT_MIN) * fl32(1 / qmax),  qmax = 2^(bits-1) - 1
    q     = clip(round_half_even(x / scale), -qmax - 1, qmax)

and bit ``b < faulty_bits`` of element ``i`` (its C-order flat index within
the row's tensor) flips when its draw falls under the rate.  The draw is
the counter-based lowbias32 hash of (index, seed, bit plane):

    h = lowbias32(i + b * 0x9E3779B9)
    u = lowbias32(h ^ seed) >> 8              (24 random bits)
    flip  <=>  u < T(rate),  T(rate) = min(ceil(rate * 2^24), 2^24)

every step in uint32 arithmetic (held in int64 here and masked, so no
signed overflow is relied on).  The draw depends on the index, seed and
plane only, never on the values or the rate, so one draw serves every
rate: :func:`flip_masks` makes it once and thresholds it once a rate.

Seeds (the configuration's contract): unit ``i`` of a model runs at
``base + 7919 i``; its input activations at that seed ``+ 1``; weight leaf
``j`` of the unit, in the sorted-key order of its parameter tree, at that
seed ``+ 977 j``.  The seed is read as an int32 and its bits as uint32.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M1, M2, GOLDEN = 0x7FEB352D, 0x846CA68B, 0x9E3779B9
FLT_MIN = float(np.finfo(np.float32).tiny)
UNIT_STRIDE, ACT_OFFSET, LEAF_STRIDE = 7919, 1, 977


def unit_seed(base: int, unit: int) -> int:
    return base + UNIT_STRIDE * unit


def _u32(seed: int) -> int:
    s = int(seed) & MASK32
    if s >= 1 << 31:                   # read as int32 first
        s -= 1 << 32
    return s & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 15)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def draw24(idx: torch.Tensor, seed: int, plane: int) -> torch.Tensor:
    """The 24 random bits of (idx, seed, plane); ``idx`` int64."""
    h = lowbias32(idx + ((plane * GOLDEN) & MASK32))
    return lowbias32(h ^ _u32(seed)) >> 8


def threshold(rate) -> int:
    """T(rate) in float32 arithmetic, exact: a draw fires when ``u < T``."""
    r = np.float32(rate)
    if not r > 0:
        return 0
    return int(min(np.ceil(r * np.float32(1 << 24)), np.float32(1 << 24)))


def flip_masks(n: int, seed: int, rates, faulty_bits: int, device,
               chunk: int = 1 << 24) -> torch.Tensor:
    """``[len(rates), n]`` int32 masks of the bits that flip at each rate
    for the ``n`` elements of one tensor at ``seed``."""
    ts = [threshold(r) for r in rates]
    out = torch.zeros((len(ts), n), dtype=torch.int32, device=device)
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        idx = torch.arange(start, stop, dtype=torch.int64, device=device)
        for b in range(faulty_bits):
            u = draw24(idx, seed, b)
            for k, t in enumerate(ts):
                out[k, start:stop] |= (u < t).to(torch.int32) << b
    return out


def quantize(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int32, scale float32 0-d)`` of the whole tensor ``x``."""
    qmax = (1 << (bits - 1)) - 1
    amax = x.abs().amax().to(torch.float32)
    scale = torch.clamp_min(amax, FLT_MIN) * float(np.float32(1) / np.float32(qmax))
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax - 1, qmax)
    return q.to(torch.int32), scale


def corrupt(x: torch.Tensor, bits: int, mask: torch.Tensor | None
            ) -> torch.Tensor:
    """Quantize ``x`` (one scale), XOR the flat ``mask`` (None: no flip),
    dequantize to ``x``'s dtype: float32 ``q' * scale``, then one cast."""
    q, scale = quantize(x, bits)
    if mask is not None:
        q = q ^ mask.view(q.shape)
    return (q.to(torch.float32) * scale).to(x.dtype)


def corrupted_weights(w: torch.Tensor, bits: int, seed: int, rates,
                      faulty_bits: int) -> list[torch.Tensor]:
    """The weight ``w`` as each of ``rates`` corrupts it (its integer copy
    flipped, then dequantized to ``w``'s dtype): one tensor a rate."""
    q, scale = quantize(w, bits)
    masks = flip_masks(w.numel(), seed, rates, faulty_bits, w.device)
    return [((q ^ m.view(q.shape)).to(torch.float32) * scale).to(w.dtype)
            for m in masks]
