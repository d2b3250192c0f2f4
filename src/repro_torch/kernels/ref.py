"""Plain PyTorch versions of the three fault kernels, the counterparts of
``repro/kernels/ref.py``.  ``kernels/ops.py`` runs them for CPU tensors,
the tests hold them bitwise against the reference, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

Row convention (the port's stand-in for the reference's ``vmap`` over the
population): ``rate`` is either a scalar, corrupting the tensor as one
unit, or a 1-D float32 tensor ``[R]`` of per-row rates.  The hash index is
always the C-order flat index within ONE row's tensor, and every row
shares the seed, exactly as under ``vmap``.

  * ``bitflip_ref(q, ...)``: ``q`` is shared by the rows; a ``[R]`` rate
    returns ``[R, *q.shape]``, dequantized to float32 by ``scale`` if given.
  * ``quant_bitflip_ref(x, ...)``: with a ``[R]`` rate ``x`` is
    ``[R, ...]`` and each row gets its own amax and scale.
  * ``fault_matmul_ref(x, qw, ...)``: with a ``[R]`` rate ``x`` is
    ``[R, ..., K]``; ``qw`` ``(K, N)`` is shared and corrupted per row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.faultmodel import apply_fault
from repro_torch.quant.fixedpoint import TINY, QuantSpec

__all__ = ["row_rates", "bitflip_ref", "quant_bitflip_ref",
           "fault_matmul_ref"]


def row_rates(rate, device) -> tuple[torch.Tensor, bool]:
    """``(rates [R] float32 contiguous on device, per_row)``; a scalar is
    one row."""
    r = torch.as_tensor(rate, dtype=torch.float32, device=device)
    if r.ndim > 1:
        raise ValueError(f"rate must be a scalar or 1-D [R], got {tuple(r.shape)}")
    return r.reshape(-1).contiguous(), r.ndim == 1


def bitflip_ref(q: torch.Tensor, seed, rate, faulty_bits: int,
                fault_model: str = "flip", mbu_width: int = 2,
                scale=None) -> torch.Tensor:
    """Corrupt the ``faulty_bits`` LSBs of integer tensor ``q``; with a
    ``scale``, return the float32 dequantization ``float(q') * scale``."""
    if q.is_floating_point() or q.is_complex():
        raise TypeError(f"bitflip needs an integer tensor, got {q.dtype}")
    rates, per_row = row_rates(rate, q.device)
    idx = torch.arange(q.numel(), dtype=torch.int64, device=q.device)
    out = apply_fault(q.reshape(1, -1), idx, seed, rates[:, None],
                      faulty_bits, fault_model=fault_model,
                      mbu_width=mbu_width)
    out = torch.broadcast_to(out, (rates.numel(), q.numel()))
    if scale is not None:
        out = out.to(torch.float32) * torch.as_tensor(
            scale, dtype=torch.float32, device=q.device)
    return out.reshape(rates.numel(), *q.shape) if per_row \
        else out.reshape(q.shape)


def quant_bitflip_ref(x: torch.Tensor, seed, rate, faulty_bits: int,
                      spec: QuantSpec = QuantSpec(), fault_model: str = "flip",
                      mbu_width: int = 2) -> torch.Tensor:
    """Quantize (per-row scale) -> corrupt -> dequantize, in x's dtype."""
    rates, per_row = row_rates(rate, x.device)
    R = rates.numel()
    if per_row and (x.ndim == 0 or x.shape[0] != R):
        raise ValueError(f"x {tuple(x.shape)} has no leading row axis of {R}")
    xr = x.reshape(R, -1)
    amax = xr.abs().amax(dim=1, keepdim=True).to(torch.float32)
    scale = torch.clamp_min(amax, TINY) * spec.inv_qmax
    q = torch.clamp(torch.round(xr.to(torch.float32) / scale),
                    spec.qmin, spec.qmax).to(torch.int32)
    idx = torch.arange(xr.shape[1], dtype=torch.int64, device=x.device)
    q = apply_fault(q, idx, seed, rates[:, None], faulty_bits,
                    fault_model=fault_model, mbu_width=mbu_width)
    return (q.to(torch.float32) * scale).to(x.dtype).reshape(x.shape)


def fault_matmul_ref(x: torch.Tensor, qw: torch.Tensor, scale, seed, rate,
                     faulty_bits: int, fault_model: str = "flip",
                     mbu_width: int = 2) -> torch.Tensor:
    """``x @ dequant(corrupt(qw))``: corrupt, dequantize in float32, cast
    the weights to ``x.dtype``, then one ``torch.matmul`` (one per row
    for a ``[R]`` rate).  In bfloat16 that product sums in fp32 and
    rounds once, the reference's CPU function
    (``repro/kernels/ops.py:74-79``)."""
    if qw.ndim != 2 or x.shape[-1] != qw.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} "
                         f"@ qw {tuple(qw.shape)}")
    rates, per_row = row_rates(rate, x.device)
    w = bitflip_ref(qw, seed, rates if per_row else rate, faulty_bits,
                    fault_model=fault_model, mbu_width=mbu_width, scale=scale)
    w = w.to(x.dtype)
    if not per_row:
        return torch.matmul(x, w)
    R, K, N = rates.numel(), qw.shape[0], qw.shape[1]
    if x.shape[0] != R:
        raise ValueError(f"x {tuple(x.shape)} has no leading row axis of {R}")
    xr = x.reshape(R, -1, K)
    # one matmul per row: a batched one may sum a row in another order
    # depending on R (threads on the CPU), and rows must not depend on R
    out = torch.stack([torch.matmul(xr[r], w[r]) for r in range(R)])
    return out.reshape(*x.shape[:-1], N)
