"""Entry points of the three fault kernels, the counterparts of
``repro/kernels/ops.py``.

Dispatch is by the tensor's device alone: a CUDA tensor launches the
hand-written kernel in ``csrc/`` (built at first use by ``_build.py``) or
raises; a CPU tensor runs the plain PyTorch version in ``ref.py``.  There
is no environment switch and no fallback between the two.

Rates follow ``ref.py``'s row convention: a scalar corrupts the tensor as
one unit, a 1-D float32 ``[R]`` tensor gives each row its own rate (the
port's population axis).  The seed is one per call, shared by all rows.

``launches`` counts, per wrapper, the kernels it launches: one a call of
a C entry point for ``bitflip``, ``fault_matmul`` (float32 x; where K is
split, the kernel and the sum of the slices count as one),
``fault_weight_tiles``, ``matmul_tiles`` and ``matmul_tiles_f32``; two a
launch pair for ``quant_bitflip``, whose C entry runs an amax pass and
the flip over a whole group of tensors (``quant_bitflip_group``; a
one-tensor call is a group of one).  ``fault_matmul`` on bf16 x launches
the kernels of ``fault_weight_tiles`` and ``matmul_tiles``, once each a
row group, and they count there; on float32 x with a bf16 weight dtype
(the encoder-decoder's encoder) those of ``fault_weight_tiles`` and
``matmul_tiles_f32`` the same way.

Under autograd (grad enabled and an input that requires grad)
``quant_bitflip_group`` is differentiable, with the reference's gradient
(``ref.quant_bitflip_grad_ref``); the other wrappers have no backward and
raise there rather than cut the graph.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import library
from repro_torch.kernels.faultmodel import FAULT_MODELS, seed_u32
from repro_torch.quant.fixedpoint import QuantSpec

__all__ = ["bitflip", "quant_bitflip", "quant_bitflip_group", "fault_matmul",
           "fault_weight_tiles", "matmul_tiles", "matmul_tiles_f32",
           "row_groups", "launches", "reset_launches", "MODEL_IDS",
           "WORKSPACE_BYTES"]

MODEL_IDS = {m: i for i, m in enumerate(FAULT_MODELS)}   # csrc/faultmodel.cuh
_INT_BYTES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
_P, _I64, _I32, _U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
# C entry point -> (library, argument types)
_SIGNATURES = {
    "afp_bitflip": ("bitflip", [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _U32,
                                _I32, _I32, _I32, _P]),
    "afp_quant_bitflip_group": ("quant_bitflip", [ctypes.c_char_p, _I32, _P,
                                                  _I64, _I32, _I32, _I32, _I32,
                                                  _I32, ctypes.c_char_p, _P]),
    "afp_fault_matmul": ("fault_matmul", [_P, _P, _P, _P, _P, _P, _I64, _I64,
                                          _I64, _I64, _I32, _I32, _I32, _U32,
                                          _I32, _I32, _P]),
    "afp_fault_weight_tiles": ("fault_matmul", [_P, _P, _P, _P, _I64, _I64,
                                                _I64, _I32, _I32, _U32, _I32,
                                                _I32, _P]),
    "afp_matmul_tiles": ("fault_matmul", [_P, _P, _P, _P, _I64, _I64, _I64,
                                          _I64, _I32, _P]),
    "afp_matmul_tiles_f32": ("fault_matmul", [_P, _P, _P, _P, _I64, _I64,
                                              _I64, _I64, _I32, _P]),
}

launches = {"bitflip": 0, "quant_bitflip": 0, "fault_matmul": 0,
            "fault_weight_tiles": 0, "matmul_tiles": 0,
            "matmul_tiles_f32": 0}
_MAX_GRID_Z = 65535          # fault_matmul's grid.z is rows x K slices
# The W' workspace of ``fault_matmul``'s two-kernel routes (bf16 x, and
# float32 x on bf16 weights): a call hashes its rows in groups whose W'
# fits this many bytes
WORKSPACE_BYTES = 256 << 20


def reset_launches():
    for k in launches:
        launches[k] = 0


def _entry(fn: str):
    lib, argtypes = _SIGNATURES[fn]
    f = getattr(library(lib), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")
    return False


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _no_grad(name: str, *ts):
    """Raise where autograd would need a backward of kernel ``name``,
    which has none: the reference trains through ``quant_bitflip`` alone
    (a training param is a float, never a ``QTensor``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad(), or "
            "with inputs that do not require grad")


def _model_id(fault_model: str, faulty_bits: int) -> int:
    """The kernel's id for ``fault_model``; checks the bit window fits the
    kernels' 32-bit masks."""
    if fault_model not in MODEL_IDS:
        raise ValueError(f"unknown fault_model {fault_model!r}; "
                         f"expected one of {FAULT_MODELS}")
    if not 0 <= faulty_bits <= 31:
        raise ValueError(f"faulty_bits must be in [0, 31], got {faulty_bits}")
    return MODEL_IDS[fault_model]


def _launch(fn: str, device: torch.device, *args):
    """Call C entry ``fn`` with ``args`` and ``device``'s current stream,
    with ``device`` the current card: a launch, a stream and the kernels'
    shared-memory attributes all belong to the current card.  The card is
    switched only when it differs (one card: never)."""
    f = _entry(fn)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = f(*args, stream)
    else:
        with torch.cuda.device(device):
            err = f(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _k_splits(M: int, K: int, N: int, body: str,
              device: torch.device) -> int:
    """K slices for ``fault_matmul`` (``csrc/fault_matmul.cu``), chosen for
    ONE row from its (M, K, N): the slices are summed in slice order, so a
    row's result depends on their count, and a count fixed per row gives
    every row of an R-row call what a one-row call gives (the staged
    engine's chunks against the whole-forward path's single rows).  As many
    slices as leave one row one wave of blocks, each slice at least its
    body's minimum depth:

    ``"tc"`` (float32 x with int8 weights): blocks of 512 rows x an N tile
    of 16 (N <= 16) or 64, one a SM, slices of >= 16 of K.  ResNet18's fc
    (K = 512) runs 32 blocks a row, AlexNet's fc0 128.  ``"bf16"`` (bf16 x,
    the product of W'): blocks of 128 x 256, one a SM (its ring takes
    192 KB of shared memory), slices of >= 64 of K (one stage; the kernel
    rounds a slice up to whole stages); every olmo-1b projection (M =
    2048) is one slice, starcoder2-3b's kv projection (2048 x 3072 x 256,
    16 blocks) eight.  ``"f32w"`` (float32 x on bf16 weights, the product
    of W'): blocks of 128 x 128, one a SM (192 KB of ring), slices of >= 64
    of K (one stage); seamless-m4t-medium's encoder (M = 256) runs 16
    blocks a row at N = 1024, so eight slices at 1024 x 1024 and 4096 x
    1024, and 64 at N = 4096, so two.  ``"simt"`` (float32 x with
    int16/int32 weights): 128x128 tiles, two blocks a SM, slices of >= 128
    of K."""
    sms = _sm_count(device.index or 0)
    if body == "tc":
        tiles = -(-M // 512) * -(-N // (16 if N <= 16 else 64))
        want, steps = sms // tiles, -(-K // 16)
    elif body in ("bf16", "f32w"):
        tiles = -(-M // 128) * -(-N // (256 if body == "bf16" else 128))
        want, steps = sms // tiles, -(-K // 64)
    else:
        tiles = -(-M // 128) * -(-N // 128)
        want, steps = -(-2 * sms // tiles), -(-K // 8) // 16
    return max(1, min(want, steps, _MAX_GRID_Z))


def row_groups(R: int, K: int, N: int, splits: int = 1) -> list[tuple[int, int]]:
    """``(first row, rows)`` of each group the two-kernel routes of
    ``fault_matmul`` walk ``R`` rows in: each group is one hash launch and
    one product launch, its W' (``ref.tile_elems(K, N)`` bf16 a row) within
    ``WORKSPACE_BYTES`` and its grid within ``_MAX_GRID_Z`` (rows x K
    slices); at least one row a group, the groups in row order."""
    per_row = 2 * _ref.tile_elems(K, N)
    G = max(1, min(WORKSPACE_BYTES // per_row, _MAX_GRID_Z // splits))
    return [(r0, min(G, R - r0)) for r0 in range(0, R, G)]


def bitflip(q: torch.Tensor, seed, rate, faulty_bits: int, *,
            fault_model: str = "flip", mbu_width: int = 2,
            scale=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Corrupt the ``faulty_bits`` LSBs of integer tensor ``q``; with a
    ``[R]`` rate, returns ``[R, *q.shape]`` (``q`` shared by the rows).
    With a one-element float32 ``scale`` the kernel also dequantizes in the
    same pass and returns ``dtype`` (float32 or bfloat16): ``float(q') *
    scale`` in float32, rounded once to ``dtype``, the reference's
    ``(q'.astype(f32) * scale).astype(dtype)``."""
    _no_grad("bitflip", scale)
    if not _is_cuda(q):
        return _ref.bitflip_ref(q, seed, rate, faulty_bits,
                                fault_model=fault_model, mbu_width=mbu_width,
                                scale=scale, dtype=dtype)
    _check(q.dtype in _INT_BYTES, f"bitflip takes int8/16/32, got {q.dtype}")
    _check(q.is_contiguous(), "bitflip needs a contiguous q")
    _check(dtype in (torch.float32, torch.bfloat16),
           f"bitflip dequantizes to float32 or bfloat16, got {dtype}")
    rates, per_row = _ref.row_rates(rate, q.device)
    scale_ptr = None
    if scale is not None:
        scale_t = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
        _check(scale_t.numel() == 1, "bitflip takes one per-tensor scale")
        scale_t = scale_t.contiguous()
        scale_ptr = scale_t.data_ptr()
    out = torch.empty((rates.numel(), *q.shape),
                      dtype=q.dtype if scale is None else dtype,
                      device=q.device)
    _launch("afp_bitflip", q.device, q.data_ptr(), out.data_ptr(),
            rates.data_ptr(), scale_ptr, q.numel(), rates.numel(),
            _INT_BYTES[q.dtype], _model_id(fault_model, faulty_bits),
            seed_u32(seed), faulty_bits, mbu_width,
            int(scale is not None and dtype == torch.bfloat16))
    launches["bitflip"] += 1
    return out if per_row else out[0]


def quant_bitflip(x: torch.Tensor, seed, rate, faulty_bits: int,
                  spec: QuantSpec = QuantSpec(), *, fault_model: str = "flip",
                  mbu_width: int = 2) -> torch.Tensor:
    """Fused quantize -> corrupt -> dequantize; with a ``[R]`` rate, ``x``
    is ``[R, ...]`` and each row gets its own scale.  The one-tensor case
    of ``quant_bitflip_group``."""
    return quant_bitflip_group([x], [seed], [rate], faulty_bits, spec,
                               fault_model=fault_model,
                               mbu_width=mbu_width)[0]


# csrc/quant_bitflip.cu: qbf::Entry (x, out, rate, n, row stride, first
# block, rows, chunk, chunks, seed, is_bf16, vec_ok) and kMaxEntries
_QB_ENTRY = struct.Struct("<QQQqqqiiiIii")
_QB_MAX_ENTRIES = 32


@functools.lru_cache(maxsize=None)
def _qb_chunk(n: int) -> int:
    """Elements a block of ``quant_bitflip``'s two passes takes from a row
    of ``n``: about 256 blocks a row, 2048 to 8192 elements each, and
    never more than 2048 blocks a row (``kMaxChunks``, the partials a
    block of the second pass reduces); a multiple of 256."""
    c = max(min(max(-(-n // 256), 2048), 8192), -(-n // 2048))
    return -(-c // 256) * 256


def _qb_rows(x: torch.Tensor, R: int) -> tuple[torch.Tensor, int]:
    """``x`` as ``R`` rows of ``x.numel() // R`` elements, and the rows'
    stride in elements: a view where each row is contiguous (stride 0 for
    a leaf expanded over the rows), else a contiguous copy."""
    if R == 1:
        return x.contiguous(), 0
    if not x[0].is_contiguous():
        x = x.contiguous()
    return x, x.stride(0)


def quant_bitflip_group(xs, seeds, rates, faulty_bits: int,
                        spec: QuantSpec = QuantSpec(), *,
                        fault_model: str = "flip",
                        mbu_width: int = 2) -> list[torch.Tensor]:
    """``quant_bitflip`` of each ``xs[i]`` at ``seeds[i]`` and ``rates[i]``
    (a scalar, or ``[R]`` with ``xs[i]`` ``[R, ...]``), sharing
    ``faulty_bits``, ``spec`` and the fault model; each output is
    contiguous, of its input's shape and dtype.  On the card one launch
    pair (an amax pass and the flip) corrupts up to 32 tensors, whose rows
    may be strided (a leaf ``expand``-ed over the rows is read in place);
    on the CPU, ``ref.quant_bitflip_group_ref``.

    With grad enabled and an input that requires grad, the call is one
    ``_QuantBitflipGroup`` node: the same outputs, bitwise, and in the
    backward the gradient ``jax.grad`` takes through the reference's
    ``quant_bitflip_ref`` (``ref.quant_bitflip_grad_ref``)."""
    if not xs:
        return []
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_QuantBitflipGroup.apply(
            (seeds, rates, faulty_bits, spec, fault_model, mbu_width), *xs))
    return _qb_forward(xs, seeds, rates, faulty_bits, spec, fault_model,
                       mbu_width)[0]


def _qb_forward(xs, seeds, rates, faulty_bits, spec, fault_model,
                mbu_width, keep_q: bool = False):
    """``(outputs, q's)``: the group's outputs and, where ``keep_q``, each
    tensor's q' (``[R, n]`` int32; else None)."""
    if not _is_cuda(xs[0]):
        if not keep_q:
            return _ref.quant_bitflip_group_ref(
                xs, seeds, rates, faulty_bits, spec, fault_model=fault_model,
                mbu_width=mbu_width), None
        pairs = [_ref.quant_bitflip_q_ref(x, s, r, faulty_bits, spec,
                                          fault_model=fault_model,
                                          mbu_width=mbu_width)
                 for x, s, r in zip(xs, seeds, rates)]
        return [y for y, _ in pairs], [q for _, q in pairs]
    _check(len(seeds) == len(xs) == len(rates),
           "quant_bitflip_group takes a seed and a rate per tensor")
    model_id = _model_id(fault_model, faulty_bits)
    outs, qs = [], ([] if keep_q else None)
    for g in range(0, len(xs), _QB_MAX_ENTRIES):
        o, q = _qb_launch(xs[g:g + _QB_MAX_ENTRIES],
                          seeds[g:g + _QB_MAX_ENTRIES],
                          rates[g:g + _QB_MAX_ENTRIES], faulty_bits, spec,
                          model_id, mbu_width, keep_q)
        outs += o
        if keep_q:
            qs += q
    return outs, qs


class _QuantBitflipGroup(torch.autograd.Function):
    """``quant_bitflip_group`` as one autograd node.  The forward is the
    kernel's launch pair (the plain version on the CPU) with q' kept; the
    backward is ``ref.quant_bitflip_grad_ref`` of each tensor, in plain
    PyTorch: the reference differentiates a plain function, whose gradient
    reaches x through the row scale alone (``round``'s is 0).  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass
    and gives the same bits and the same q'."""

    @staticmethod
    def forward(ctx, meta, *xs):
        seeds, rates, faulty_bits, spec, fault_model, mbu_width = meta
        ys, qs = _qb_forward(xs, seeds, rates, faulty_bits, spec,
                             fault_model, mbu_width, keep_q=True)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*xs, *qs)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        n = len(gs)
        return (None, *(
            _ref.quant_bitflip_grad_ref(x, q, g, ctx.spec)
            if need and g is not None else None
            for x, q, g, need in zip(saved[:n], saved[n:], gs,
                                     ctx.needs_input_grad[1:])))


def _qb_launch(xs, seeds, rates, faulty_bits, spec, model_id, mbu_width,
               keep_q=False):
    """One launch pair over at most ``_QB_MAX_ENTRIES`` tensors: their
    outputs and, where ``keep_q``, their q' ``[R, n]`` int32 (else
    None)."""
    dev = xs[0].device
    table, keep, outs, blocks, row_rates = [], [], [], 0, {}
    qs, q_ptrs = ([] if keep_q else None), []
    # the checks format their messages only on failure: this loop is the
    # host's cost of a decode layer's corruption
    for x, seed, rate in zip(xs, seeds, rates):
        if x.device != dev or x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"quant_bitflip takes float32/bfloat16 on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if id(rate) not in row_rates:     # a layer's leaves share one rate
            row_rates[id(rate)] = _ref.row_rates(rate, dev)
        r, per_row = row_rates[id(rate)]
        R = r.numel()
        if per_row and (x.ndim == 0 or x.shape[0] != R):
            raise ValueError(f"x {tuple(x.shape)} has no leading row axis "
                             f"of {R}")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        outs.append(out)
        n = x.numel() // R if R else 0
        if qs is not None:
            qs.append(torch.empty((R, n), dtype=torch.int32, device=dev))
        if n == 0:
            continue
        if qs is not None:
            q_ptrs.append(qs[-1].data_ptr())
        x, stride = _qb_rows(x, R)
        chunk = _qb_chunk(n)
        chunks = -(-n // chunk)
        table.append(_QB_ENTRY.pack(
            x.data_ptr(), out.data_ptr(), r.data_ptr(), n, stride, blocks, R,
            chunk, chunks, seed_u32(seed), int(x.dtype == torch.bfloat16), 0))
        keep.append((x, r))       # a copy and the rates live to the launch
        blocks += R * chunks
    if table:
        partials = torch.empty(blocks, dtype=torch.float32, device=dev)
        _launch("afp_quant_bitflip_group", dev, b"".join(table), len(table),
                partials.data_ptr(), blocks, model_id, spec.qmin, spec.qmax,
                faulty_bits, mbu_width,
                None if qs is None else struct.pack(f"<{len(q_ptrs)}Q",
                                                    *q_ptrs))
        launches["quant_bitflip"] += 2
    return outs, qs


def _hash_launch(qw, out, scale_t, rates, seed, faulty_bits, model_id,
                 mbu_width, r0=0, rows=None):
    """The hash pass over rows ``r0 .. r0 + rows`` of ``rates`` into
    ``out`` (checked by the caller)."""
    rows = rates.numel() if rows is None else rows
    K, N = qw.shape
    _launch("afp_fault_weight_tiles", qw.device, qw.data_ptr(),
            out.data_ptr(), scale_t.data_ptr(), rates.data_ptr() + 4 * r0, rows, K, N,
            _INT_BYTES[qw.dtype], model_id, seed_u32(seed), faulty_bits,
            mbu_width)
    launches["fault_weight_tiles"] += 1


def _product_launch(x_ptr, tiles, out_ptr, rows, M, K, N, splits,
                    partial_ptr):
    """The product of ``rows`` rows of bf16 x at ``x_ptr`` by their W'
    tiles into ``out_ptr`` (checked by the caller); ``partial_ptr`` is the
    split-K workspace, 0 for one slice."""
    _launch("afp_matmul_tiles", tiles.device, x_ptr, tiles.data_ptr(),
            out_ptr, partial_ptr, rows, M, K, N, splits)
    launches["matmul_tiles"] += 1


def _product_f32_launch(x_ptr, tiles, out_ptr, rows, M, K, N, splits,
                        partial_ptr):
    """``_product_launch`` for float32 x (float32 out)."""
    _launch("afp_matmul_tiles_f32", tiles.device, x_ptr, tiles.data_ptr(),
            out_ptr, partial_ptr, rows, M, K, N, splits)
    launches["matmul_tiles_f32"] += 1


def fault_weight_tiles(qw: torch.Tensor, scale, seed, rate,
                       faulty_bits: int, *, fault_model: str = "flip",
                       mbu_width: int = 2,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 route's hash pass: each row's corrupted, dequantized
    weights ``bf16(fp32(q') * scale)`` as W' tiles, ``[R, tile_elems(K,
    N)]`` bf16 (``ref.unpack_tiles`` gives ``[R, K, N]``), for every row
    of ``rate`` in one launch; each weight's draws are computed once and
    shared by the rows.  ``out`` is an optional ``[>= R, tile_elems]``
    buffer to write into."""
    _no_grad("fault_weight_tiles", scale)
    if not _is_cuda(qw):
        return _ref.fault_weight_tiles_ref(qw, scale, seed, rate, faulty_bits,
                                           fault_model=fault_model,
                                           mbu_width=mbu_width)
    _check(qw.ndim == 2 and qw.dtype in _INT_BYTES and qw.is_contiguous(),
           f"fault_weight_tiles takes a contiguous 2-D int8/16/32 qw, got "
           f"{qw.dtype} {tuple(qw.shape)}")
    rates, _ = _ref.row_rates(rate, qw.device)
    R, (K, N) = rates.numel(), qw.shape
    scale_t = torch.as_tensor(scale, dtype=torch.float32,
                              device=qw.device).contiguous()
    _check(scale_t.numel() == 1, "fault_weight_tiles takes one scale")
    n = _ref.tile_elems(K, N)
    if out is None:
        out = torch.empty((R, n), dtype=torch.bfloat16, device=qw.device)
    _check(out.dtype == torch.bfloat16 and out.is_contiguous()
           and out.ndim == 2 and out.shape[0] >= R and out.shape[1] == n
           and out.device == qw.device, "out must be [>= R, tile_elems] bf16")
    _hash_launch(qw, out, scale_t, rates, seed, faulty_bits,
                 _model_id(fault_model, faulty_bits), mbu_width)
    return out[:R]


def _tiles_product(x: torch.Tensor, tiles: torch.Tensor, K: int,
                   N: int) -> torch.Tensor:
    """``matmul_tiles`` (bf16 x) or ``matmul_tiles_f32`` (float32 x) on
    the card: one launch for all R rows."""
    R, dtype = tiles.shape[0], x.dtype
    bf16 = dtype == torch.bfloat16
    name = "matmul_tiles" if bf16 else "matmul_tiles_f32"
    _check(x.is_contiguous() and x.ndim >= 2 and x.shape[0] == R
           and x.shape[-1] == K,
           f"{name} takes contiguous {dtype} x [{R}, ..., {K}], got "
           f"{tuple(x.shape)}")
    _check(tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
           and tiles.shape[1] == _ref.tile_elems(K, N)
           and tiles.device == x.device and tiles.data_ptr() % 16 == 0,
           "tiles must be ref.tile_elems wide and 16-byte aligned")
    M = x[0].numel() // K
    out = torch.empty((*x.shape[:-1], N), dtype=dtype, device=x.device)
    splits = _k_splits(M, K, N, "bf16" if bf16 else "f32w", x.device)
    _check(R * splits <= _MAX_GRID_Z, "too many rows for one launch")
    partial = torch.empty((splits, R, M, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    (_product_launch if bf16 else _product_f32_launch)(
        x.data_ptr(), tiles, out.data_ptr(), R, M, K, N, splits,
        0 if partial is None else partial.data_ptr())
    return out


def matmul_tiles(x: torch.Tensor, tiles: torch.Tensor, K: int,
                 N: int) -> torch.Tensor:
    """The bf16 route's product: ``x [R, ..., K]`` bf16 times row r's W'
    (``tiles [R, tile_elems(K, N)]``, the hash pass's output), summed in
    fp32 and rounded once: ``[R, ..., N]`` bf16."""
    _no_grad("matmul_tiles", x, tiles)
    if not _is_cuda(x):
        return _ref.matmul_tiles_ref(x, tiles, K, N)
    _check(x.dtype == torch.bfloat16,
           f"matmul_tiles takes bf16 x, got {x.dtype}")
    return _tiles_product(x, tiles, K, N)


def matmul_tiles_f32(x: torch.Tensor, tiles: torch.Tensor, K: int,
                     N: int) -> torch.Tensor:
    """The product of the float32-x, bf16-weight route: ``x [R, ..., K]``
    float32 times row r's W' (``tiles``, the hash pass's output) in fp32,
    ``[R, ..., N]`` float32.  On the card x is split exactly into three
    bf16 parts, each multiplied exactly by W' on the tensor cores into one
    fp32 sum (``csrc/fault_matmul.cu``, ``fwp``)."""
    _no_grad("matmul_tiles_f32", x, tiles)
    if not _is_cuda(x):
        return _ref.matmul_tiles_f32_ref(x, tiles, K, N)
    _check(x.dtype == torch.float32,
           f"matmul_tiles_f32 takes float32 x, got {x.dtype}")
    return _tiles_product(x, tiles, K, N)


def fault_matmul(x: torch.Tensor, qw: torch.Tensor, scale, seed, rate,
                 faulty_bits: int, *, fault_model: str = "flip",
                 mbu_width: int = 2,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ dequant(corrupt(qw))`` with fp32 accumulation; ``qw`` is the
    shared ``(K, N)`` integer matrix, ``scale`` its float32 scale.  With a
    ``[R]`` rate ``x`` is ``[R, ..., K]`` and returns ``[R, ..., N]``.
    The dequantized weight is cast to ``out_dtype`` (the original weight
    dtype, the reference's ``out_dtype``; ``x.dtype`` if None) before the
    product, which runs in the promoted dtype: float32 x with float32
    weights; bfloat16 x with bfloat16 weights (the result bfloat16,
    rounded once from the fp32 sum); or float32 x with bfloat16 weights
    (x times the weights' bf16 values, float32 out).

    On the card, bfloat16 x, and float32 x on bfloat16 weights, run two
    kernels for each group of ``row_groups``: the hash pass
    (``fault_weight_tiles``'s kernel) into a W' workspace of at most
    ``WORKSPACE_BYTES``, then the product (``matmul_tiles``'s, or
    ``matmul_tiles_f32``'s on float32 x), each counted under its own name;
    float32 x on float32 weights runs one kernel a launch, counted under
    ``"fault_matmul"``."""
    _no_grad("fault_matmul", x, scale)
    if not _is_cuda(x):
        return _ref.fault_matmul_ref(x, qw, scale, seed, rate, faulty_bits,
                                     fault_model=fault_model,
                                     mbu_width=mbu_width, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    _check((x.dtype, out_dtype) in ((torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)),
           f"fault_matmul takes float32 x on float32 or bfloat16 weights, "
           f"or bfloat16 x on bfloat16 weights; got {x.dtype} x, "
           f"{out_dtype} weights")
    _check(qw.ndim == 2 and x.ndim >= 1 and x.shape[-1] == qw.shape[0],
           f"contraction mismatch: x {tuple(x.shape)} @ qw {tuple(qw.shape)}")
    _check(qw.dtype in _INT_BYTES, f"fault_matmul takes int8/16/32 qw, got {qw.dtype}")
    _check(x.is_contiguous() and qw.is_contiguous(),
           "fault_matmul needs contiguous x and qw")
    _check(qw.device == x.device, "x and qw must be on one device")
    rates, per_row = _ref.row_rates(rate, x.device)
    R = rates.numel()
    _check(not per_row or (x.ndim > 1 and x.shape[0] == R),
           f"x {tuple(x.shape)} has no leading row axis of {R}")
    scale_t = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    _check(scale_t.numel() == 1, "fault_matmul takes one per-tensor scale")
    scale_t = scale_t.contiguous()
    model_id = _model_id(fault_model, faulty_bits)
    K, N = qw.shape
    M = x.shape[:-1].numel() // R
    out = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    if out_dtype == torch.bfloat16:
        # the weights are W' = bf16(fp32(q') scale), the hash pass's tiles
        bf16 = x.dtype == torch.bfloat16
        esize = x.element_size()
        splits = _k_splits(M, K, N, "bf16" if bf16 else "f32w", x.device)
        groups = row_groups(R, K, N, splits)
        G = groups[0][1]
        ws = torch.empty((G, _ref.tile_elems(K, N)), dtype=torch.bfloat16,
                         device=x.device)
        partial = torch.empty((splits, G, M, N), dtype=torch.float32,
                              device=x.device) if splits > 1 else None
        p_ptr = 0 if partial is None else partial.data_ptr()
        product = _product_launch if bf16 else _product_f32_launch
        for r0, rows in groups:
            _hash_launch(qw, ws, scale_t, rates, seed, faulty_bits, model_id,
                         mbu_width, r0, rows)
            product(x.data_ptr() + esize * r0 * M * K, ws,
                    out.data_ptr() + esize * r0 * M * N, rows, M, K, N,
                    splits, p_ptr)
        return out
    body = "tc" if qw.dtype == torch.int8 else "simt"
    splits = _k_splits(M, K, N, body, x.device)
    step = _MAX_GRID_Z // splits       # rows a launch, within the grid
    partial = torch.empty((splits, min(R, step), M, N) if splits > 1
                          else (0,), dtype=torch.float32, device=x.device)
    for r0 in range(0, R, step):
        rows = min(step, R - r0)
        _launch("afp_fault_matmul", x.device, x.data_ptr() + r0 * M * K * 4,
                qw.data_ptr(), out.data_ptr() + r0 * M * N * 4,
                partial.data_ptr(), scale_t.data_ptr(),
                rates.data_ptr() + r0 * 4, rows, M, K, N, splits,
                _INT_BYTES[qw.dtype], model_id, seed_u32(seed), faulty_bits,
                mbu_width)
        launches["fault_matmul"] += 1
    return out
