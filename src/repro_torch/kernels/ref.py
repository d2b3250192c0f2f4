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
    returns ``[R, *q.shape]``, dequantized by ``scale`` if given (in
    float32, then cast to ``dtype``).
  * ``quant_bitflip_ref(x, ...)``: with a ``[R]`` rate ``x`` is
    ``[R, ...]`` and each row gets its own amax and scale;
    ``quant_bitflip_group_ref`` runs it tensor by tensor, the plain
    version of the kernel's grouped launch.
  * ``fault_matmul_ref(x, qw, ...)``: with a ``[R]`` rate ``x`` is
    ``[R, ..., K]``; ``qw`` ``(K, N)`` is shared and corrupted per row.

``matmul`` is the dense product as the reference computes it on the CPU;
the model code uses it for every bf16 product the reference leaves to XLA.

The bf16 route of ``fault_matmul``, and its float32-x route on bf16
weights, run as two kernels on the card, a hash pass that writes each
row's corrupted weights as W' tiles and a product of those tiles;
``fault_weight_tiles_ref``, ``matmul_tiles_ref`` (bf16 x) and
``matmul_tiles_f32_ref`` (float32 x) are their plain versions, ``split3``
the exact three-way split of float32 x the float32 product runs on, and
``pack_tiles``/``unpack_tiles`` convert between
``[R, K, N]`` and the tile layout (``csrc/fault_matmul.cu``): 16 x 128
tiles, the tiles of one 128-column panel in k order, each tile in wgmma's
no-swizzle K-major B image (element (k, n) at (n & 7) 8 + (n >> 3) 128 +
(k >> 3) 64 + (k & 7)), zeros past K and N.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.faultmodel import apply_fault
from repro_torch.quant.fixedpoint import TINY, QuantSpec

__all__ = ["row_rates", "matmul", "bitflip_ref", "quant_bitflip_ref",
           "quant_bitflip_q_ref", "quant_bitflip_grad_ref",
           "quant_bitflip_group_ref",
           "fault_matmul_ref", "XLA_K_BLOCK", "TILE_K", "TILE_N", "tile_elems", "pack_tiles",
           "unpack_tiles", "fault_weight_tiles_ref", "matmul_tiles_ref",
           "matmul_tiles_f32_ref", "split3"]

TILE_K, TILE_N = 16, 128


def row_rates(rate, device) -> tuple[torch.Tensor, bool]:
    """``(rates [R] float32 contiguous on device, per_row)``; a scalar is
    one row."""
    r = torch.as_tensor(rate, dtype=torch.float32, device=device)
    if r.ndim > 1:
        raise ValueError(f"rate must be a scalar or 1-D [R], got {tuple(r.shape)}")
    return r.reshape(-1).contiguous(), r.ndim == 1


XLA_K_BLOCK = 512


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``.  On the CPU a bfloat16 product is XLA's
    CPU bf16 dot: the exact fp32 products summed in k order from 0 within
    blocks of ``XLA_K_BLOCK`` k, the blocks' sums added in order, rounded
    once to bf16 (measured bitwise at 11 shapes up to K = 8192).
    ``torch.matmul`` in bf16 (and in fp32, then rounded) sums in another
    order and differs in about 1 output of 10^4.  Anything else, and every
    product on the card, is ``torch.matmul``."""
    if x.dtype != torch.bfloat16 or x.device.type != "cpu":
        return torch.matmul(x, w)
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} "
                         f"@ w {tuple(w.shape)}")
    xf, wf = x.float(), w.float()
    acc = None
    for k0 in range(0, w.shape[0], XLA_K_BLOCK):
        blk = xf.new_zeros((*x.shape[:-1], w.shape[1]))
        for k in range(k0, min(k0 + XLA_K_BLOCK, w.shape[0])):
            blk += xf[..., k:k + 1] * wf[k]      # bf16 x bf16 is exact in fp32
        acc = blk if acc is None else acc + blk
    if acc is None:
        acc = xf.new_zeros((*x.shape[:-1], w.shape[1]))
    return acc.to(torch.bfloat16)


def bitflip_ref(q: torch.Tensor, seed, rate, faulty_bits: int,
                fault_model: str = "flip", mbu_width: int = 2,
                scale=None, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Corrupt the ``faulty_bits`` LSBs of integer tensor ``q``; with a
    ``scale``, return the dequantization ``float(q') * scale`` computed in
    float32 and cast to ``dtype``."""
    if q.is_floating_point() or q.is_complex():
        raise TypeError(f"bitflip needs an integer tensor, got {q.dtype}")
    rates, per_row = row_rates(rate, q.device)
    idx = torch.arange(q.numel(), dtype=torch.int64, device=q.device)
    out = apply_fault(q.reshape(1, -1), idx, seed, rates[:, None],
                      faulty_bits, fault_model=fault_model,
                      mbu_width=mbu_width)
    out = torch.broadcast_to(out, (rates.numel(), q.numel()))
    if scale is not None:
        out = (out.to(torch.float32) * torch.as_tensor(
            scale, dtype=torch.float32, device=q.device)).to(dtype)
    return out.reshape(rates.numel(), *q.shape) if per_row \
        else out.reshape(q.shape)


def quant_bitflip_ref(x: torch.Tensor, seed, rate, faulty_bits: int,
                      spec: QuantSpec = QuantSpec(), fault_model: str = "flip",
                      mbu_width: int = 2) -> torch.Tensor:
    """Quantize (per-row scale) -> corrupt -> dequantize, in x's dtype."""
    return quant_bitflip_q_ref(x, seed, rate, faulty_bits, spec,
                               fault_model=fault_model,
                               mbu_width=mbu_width)[0]


def quant_bitflip_q_ref(x: torch.Tensor, seed, rate, faulty_bits: int,
                        spec: QuantSpec = QuantSpec(),
                        fault_model: str = "flip", mbu_width: int = 2
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``quant_bitflip_ref``'s output and its corrupted integers q' as
    ``[R, n]`` int32 (R the rate's rows)."""
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
    return (q.to(torch.float32) * scale).to(x.dtype).reshape(x.shape), q


def quant_bitflip_grad_ref(x: torch.Tensor, q: torch.Tensor, g: torch.Tensor,
                           spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """The gradient ``jax.grad`` takes through the reference's
    ``quant_bitflip_ref`` (one row) or its ``vmap`` (``[R]`` rows): the
    cotangent ``g`` of the output, pulled back to ``x``, given the
    forward's q' (``[R, n]``, any integer type).

    ``round`` has a zero derivative, so the gradient reaches x only
    through the row's scale ``s = max(amax, tiny) / qmax`` (``amax =
    max|x_r|`` in x's dtype): ``d s = sum_j f32(g_j) f32(q'_j)``, ``d
    amax = d s / qmax`` (times the constant's float32 reciprocal, as XLA
    computes it; halved where ``amax == tiny``, 0 below it, as
    ``maximum``'s rule gives), cast to x's dtype, shared equally among the
    entries where ``|x_j| == amax`` (``reduce_max``'s rule, divided in x's
    dtype), with ``abs``'s sign (+ where ``x_j >= 0``); every other entry
    gets 0.  No straight-through estimator."""
    R = q.shape[0]
    xr = x.reshape(R, -1)
    ds = (g.reshape(R, -1).to(torch.float32)
          * q.to(torch.float32)).sum(dim=1, keepdim=True)
    a = xr.abs()
    amax = a.amax(dim=1, keepdim=True)
    af = amax.to(torch.float32)
    # the constants stay Python scalars: a tensor made from a host value
    # on the card would make the host wait
    share = torch.where(af > TINY, 1.0, torch.where(af == TINY, 0.5, 0.0))
    hit = a == amax
    d = (ds * spec.inv_qmax * share).to(x.dtype) / hit.sum(
        dim=1, keepdim=True).to(x.dtype)
    return torch.where(hit, torch.where(xr >= 0, d, -d), 0.0).reshape(
        x.shape)


def quant_bitflip_group_ref(xs, seeds, rates, faulty_bits: int,
                            spec: QuantSpec = QuantSpec(),
                            fault_model: str = "flip",
                            mbu_width: int = 2) -> list[torch.Tensor]:
    """``quant_bitflip_ref`` of each tensor at its own seed and rate."""
    return [quant_bitflip_ref(x, s, r, faulty_bits, spec,
                              fault_model=fault_model, mbu_width=mbu_width)
            for x, s, r in zip(xs, seeds, rates)]


def fault_matmul_ref(x: torch.Tensor, qw: torch.Tensor, scale, seed, rate,
                     faulty_bits: int, fault_model: str = "flip",
                     mbu_width: int = 2,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ dequant(corrupt(qw))``: corrupt, dequantize in float32, cast
    the weights to ``out_dtype`` (the weight dtype; ``x.dtype`` if None),
    then one ``matmul`` (one per row for a ``[R]`` rate) in the promoted
    dtype, as JAX promotes.  In bfloat16 that product sums in fp32 and
    rounds once, the reference's CPU function
    (``repro/kernels/ops.py:74-79``); on the CPU in XLA's order, on the
    card in cuBLAS's.  float32 x with bf16 weights is float32 x times the
    weights' bf16 values, float32 out."""
    if qw.ndim != 2 or x.shape[-1] != qw.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} "
                         f"@ qw {tuple(qw.shape)}")
    rates, per_row = row_rates(rate, x.device)
    w = bitflip_ref(qw, seed, rates if per_row else rate, faulty_bits,
                    fault_model=fault_model, mbu_width=mbu_width, scale=scale)
    w = w.to(out_dtype or x.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if not per_row:
        return matmul(x, w)
    R, K, N = rates.numel(), qw.shape[0], qw.shape[1]
    if x.shape[0] != R:
        raise ValueError(f"x {tuple(x.shape)} has no leading row axis of {R}")
    xr = x.reshape(R, -1, K)
    # one matmul per row: a batched one may sum a row in another order
    # depending on R (threads on the CPU), and rows must not depend on R
    out = torch.stack([matmul(xr[r], w[r]) for r in range(R)])
    return out.reshape(*x.shape[:-1], N)


def tile_elems(K: int, N: int) -> int:
    """bf16 elements of one row's W' (K and N rounded up to whole tiles)."""
    return -(-K // TILE_K) * TILE_K * -(-N // TILE_N) * TILE_N


def pack_tiles(w: torch.Tensor) -> torch.Tensor:
    """``w [R, K, N]`` -> its W' tiles ``[R, tile_elems(K, N)]``."""
    R, K, N = w.shape
    nK, nN = -(-K // TILE_K), -(-N // TILE_N)
    p = w.new_zeros((R, nK * TILE_K, nN * TILE_N))
    p[:, :K, :N] = w
    p = p.view(R, nK, 2, 8, nN, TILE_N // 8, 8)
    return p.permute(0, 4, 1, 5, 2, 6, 3).reshape(R, -1)


def unpack_tiles(tiles: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """W' tiles ``[R, tile_elems(K, N)]`` -> ``[R, K, N]``."""
    R = tiles.shape[0]
    nK, nN = -(-K // TILE_K), -(-N // TILE_N)
    t = tiles.reshape(R, nN, nK, TILE_N // 8, 2, 8, 8)
    t = t.permute(0, 2, 4, 6, 1, 3, 5).reshape(R, nK * TILE_K, nN * TILE_N)
    return t[:, :K, :N]


def fault_weight_tiles_ref(qw: torch.Tensor, scale, seed, rate,
                           faulty_bits: int, fault_model: str = "flip",
                           mbu_width: int = 2) -> torch.Tensor:
    """Each row's ``bf16(fp32(q') * scale)`` as W' tiles ``[R, ...]`` (a
    scalar rate is one row)."""
    rates, _ = row_rates(rate, qw.device)
    w = bitflip_ref(qw, seed, rates, faulty_bits, fault_model=fault_model,
                    mbu_width=mbu_width, scale=scale)
    return pack_tiles(w.to(torch.bfloat16))


def matmul_tiles_ref(x: torch.Tensor, tiles: torch.Tensor, K: int,
                     N: int) -> torch.Tensor:
    """``x [R, ..., K]`` bf16 times row r's W' ``[R, ...]``, one ``matmul``
    a row: ``[R, ..., N]`` bf16."""
    w = unpack_tiles(tiles, K, N)
    return torch.stack([matmul(x[r], w[r]) for r in range(w.shape[0])])


def matmul_tiles_f32_ref(x: torch.Tensor, tiles: torch.Tensor, K: int,
                         N: int) -> torch.Tensor:
    """``x [R, ..., K]`` float32 times row r's W' ``[R, ...]`` in fp32, one
    ``matmul`` a row as ``fault_matmul_ref`` runs it: ``[R, ..., N]``
    float32."""
    w = unpack_tiles(tiles, K, N).float().contiguous()
    R = w.shape[0]
    xr = x.reshape(R, -1, K)
    out = torch.stack([matmul(xr[r], w[r]) for r in range(R)])
    return out.reshape(*x.shape[:-1], N)


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``x`` as three bf16 tensors ``hi, mid, lo``, each the
    round-to-nearest of what the ones before leave (the card's
    ``tc::split3``).  ``hi + mid + lo == x`` exactly for finite x below
    bf16's overflow threshold (2 - 2^-8) 2^127 that is a multiple of
    2^-133, bf16's smallest subnormal (every x of magnitude >= 2^-110);
    each part has 8 significant bits, so its product by a bf16 value is
    exact in fp32 unless it falls below fp32's normal range or
    overflows."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo
