"""Building blocks of the model zoo, the counterpart of
``repro/models/layers.py``: the fault plumbing, the dense decoder's
blocks (initialisers, the three norms, RoPE, chunked flash attention,
causal or to an encoder's memory, the gated and plain MLPs), MoE with the
sort-based capacity dispatch, the RG-LRU block (causal conv, associative
scan) and the Mamba2 SSD block (chunked scan), and decode attention: the
prefill that also returns K/V, one token against the cache, and the
combine of its partials.

Tensor parallelism (the reference's GSPMD layout of ``param_specs``, made
explicit): a weight laid out over one data row's model slots is a
:class:`Sharded` leaf.  The attention's ``wq``/``wk``/``wv`` are
column-parallel and ``wo`` row-parallel, the dense MLP's ``w1``/``w3``
column-parallel and ``w2`` row-parallel: each model slot computes its
slice and one ``all_reduce`` (fp32, slot order) follows each row-parallel
product.  Where every slot holds whole heads (both head counts divide the
slots) a slot attends over its own heads; where a shard boundary falls
inside a head, or with ``seq_axis`` (each slot attends for its share of
the queries), q/k/v are all-gathered over the slots first.  The MoE,
RG-LRU and SSD blocks and the norms gather their weights whole on the
row's first slot and compute there (:func:`tp_block`).  Activations
between the blocks are replicated: the driver keeps one copy, on the
row's first slot.

Row convention: a rate is ``None`` (the float path: no quantization at
all), or a float32 tensor ``[R]`` of per-row rates, one row per candidate
of the population (rate 0 is fake-quantization).  Corrupting a float
tensor at a ``[R]`` rate needs the tensor's leading row axis; corrupting a
resident :class:`QTensor` reads the one shared integer copy and returns
``[R, ...]``.  The transformer's activations are ``[R, B, S, D]``; a
weight is shared (``[K, N]``, ``[d]``) or per row (``[R, K, N]``,
``[R, d]``).

On a CUDA tensor every corruption is one of the kernels in ``csrc/``
(``quant_bitflip`` for floats, ``bitflip`` for resident integers,
``fault_matmul`` inside the dense contraction); on a CPU tensor it is
their plain version.  The reference's ``FAULT_IMPL`` switch has no
counterpart: its two settings are bitwise equal.

Dtypes follow the reference cast by cast: a weak-typed jnp scalar keeps
bf16, so such a scalar is made a tensor of the operand's dtype here
(PyTorch would compute ``bf16_tensor * python_float`` in fp32 and round
once, without rounding the scalar); tensor-tensor products promote in
both frameworks.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.faultmodel import FAULT_MODELS
from repro_torch.launch import collectives as C
from repro_torch.quant.fixedpoint import QuantSpec, quantize
from repro_torch.trace import span

__all__ = ["QTensor", "FaultedQ", "quantize_leaf", "quantize_params",
           "dequantize_params", "maybe_corrupt", "corrupt_leaves",
           "corrupt_params",
           "fault_dense", "set_fault_bits", "set_fault_model", "dense_init",
           "init_norm", "norm_fwd", "rope", "init_attention",
           "flash_attention", "attention_fwd", "attention_prefill",
           "decode_attention", "lse_combine", "init_mlp", "mlp_fwd",
           "init_moe", "moe_fwd", "causal_conv1d", "init_rglru",
           "rglru_core", "rglru_fwd", "init_ssd", "ssd_fwd", "Sharded",
           "whole_tree", "first_leaf", "tp_block", "split_like", "project",
           "row_product"]

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


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A weight leaf laid out over one data row's model slots: slot ``m``
    (on ``devices[m]``) holds ``parts[m]``, its pieces along ``"data"`` in
    data order (one piece when the leaf is not split over ``"data"``);
    ``data_dim`` / ``model_dim`` are the dimensions split over each axis
    (None: whole).  A leaf not split over ``"model"`` is used from slot 0,
    the row's first.  :meth:`local` all-gathers a slot's pieces over
    ``"data"`` before use (ZeRO-3), :meth:`whole` also over ``"model"``."""

    parts: tuple
    devices: tuple
    data_dim: int | None = None
    model_dim: int | None = None

    @property
    def nm(self) -> int:
        return len(self.devices)

    @property
    def split(self) -> bool:
        """Split over more than one model slot?"""
        return self.model_dim is not None and self.nm > 1

    def _drop(self, d):
        return None if d is None else d - 1

    def __getitem__(self, g: int) -> "Sharded":
        """Index ``g`` of the leading (never split) axis."""
        return Sharded(tuple(tuple(t[g] for t in ps) for ps in self.parts),
                       self.devices, self._drop(self.data_dim),
                       self._drop(self.model_dim))

    def unbind(self, dim: int = 0) -> list:
        """The leading axis cut once a piece (``_unstack``'s ``unbind``)."""
        cols = [[t.unbind(0) for t in ps] for ps in self.parts]
        return [Sharded(tuple(tuple(c[g] for c in ps) for ps in cols),
                        self.devices, self._drop(self.data_dim),
                        self._drop(self.model_dim))
                for g in range(len(cols[0][0]))]

    def local(self, m: int) -> torch.Tensor:
        """Model slot ``m``'s slice, whole along ``"data"``, on its
        device."""
        ps, dev = self.parts[m], self.devices[m]
        if self.data_dim is None:
            return ps[0].to(dev, non_blocking=True)
        return C.all_gather(list(ps), self.data_dim, [dev])[0]

    def whole(self) -> torch.Tensor:
        """The whole leaf on the row's first slot."""
        if not self.split:
            return self.local(0)
        return C.all_gather([self.local(m) for m in range(self.nm)],
                            self.model_dim, [self.devices[0]])[0]


def whole_tree(tree):
    """Every :class:`Sharded` leaf of ``tree`` made whole on its row's first
    slot; other leaves stay."""
    return tree_map(lambda t: t.whole() if isinstance(t, Sharded) else t,
                    tree)


_TP_KEYS = ("attn", "xattn", "mlp", "dense_mlp")


def first_leaf(tree):
    """The first leaf of ``tree`` in depth-first order (None: no leaf); a
    param tree's leaves are all :class:`Sharded` or none are."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            leaf = first_leaf(t)
            if leaf is not None:
                return leaf
        return None
    return tree


def tp_block(p: dict) -> dict:
    """A block's params for its forward: as they are without a
    :class:`Sharded` leaf; whole (gathered over ``"data"``) on one model
    slot; else the attention and dense MLP sub-trees stay sharded (their
    forwards split over the slots) and the rest (norms, MoE, RG-LRU, SSD)
    is gathered whole on the row's first slot."""
    leaf = first_leaf(p)
    if not isinstance(leaf, Sharded):
        return p
    if leaf.nm == 1:
        return whole_tree(p)
    return {k: v if k in _TP_KEYS else whole_tree(v) for k, v in p.items()}


def split_like(t: torch.Tensor, like: Sharded) -> Sharded:
    """A whole leaf on the row's first slot split over the model slots as
    ``like`` is (already whole along ``"data"``): the pieces are
    ``t.chunk`` slices, bitwise ``t``'s."""
    if not like.split:
        return Sharded(((t,),) * like.nm, like.devices, None, None)
    pieces = C.scatter(t, like.model_dim, list(like.devices))
    return Sharded(tuple((p,) for p in pieces), like.devices, None,
                   like.model_dim)


def project(x: torch.Tensor, w, devices=None, mm=None) -> torch.Tensor:
    """``x @ w`` of a replicated ``x`` (on the row's first slot) whole, on
    each of ``devices`` (default: the first slot only; a list of one
    tensor a device): a column-parallel ``w`` computes each slot's columns
    and all-gathers them; a plain or unsplit ``w`` multiplies whole.
    ``mm`` is the product (default ``ref.matmul``)."""
    mm = kref.matmul if mm is None else mm
    if not isinstance(w, Sharded):
        return mm(x, w)
    devs = [w.devices[0]] if devices is None else devices
    if not w.split:
        y = mm(x, w.whole())
        out = [y.to(d, non_blocking=True) for d in devs]
    else:
        xs = C.broadcast(x, w.devices)
        out = C.all_gather([mm(xs[m], w.local(m)) for m in range(w.nm)],
                           -1, devs)
    return out[0] if devices is None else out


def row_product(o: torch.Tensor, w, mm=None) -> torch.Tensor:
    """``o @ w`` of a replicated ``o`` whose rows ``w`` splits over the
    model slots (row-parallel): each slot multiplies its columns of ``o``
    by its rows of ``w``, and an ``all_reduce`` sums them on the row's
    first slot.  A plain or unsplit ``w`` multiplies whole."""
    mm = kref.matmul if mm is None else mm
    if not isinstance(w, Sharded):
        return mm(o, w)
    if not w.split:
        return mm(o, w.whole())
    os_ = C.broadcast(o, w.devices)
    width = o.shape[-1] // w.nm
    return C.all_reduce([mm(os_[m][..., m * width:(m + 1) * width],
                            w.local(m)) for m in range(w.nm)],
                        [w.devices[0]])[0]


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
        # the kernel dequantizes in the same pass, straight to the leaf's
        # dtype: (float(q') * scale).to(dtype), one rounding
        return kops.bitflip(x.qw, seed, rate, faulty_bits,
                            fault_model=fault_model, mbu_width=mbu_width,
                            scale=x.scale, dtype=x.dtype)
    if rate is None:
        return x
    bits = FAULT_BITS if bits is None else bits
    return kops.quant_bitflip(x, seed, rate, faulty_bits, QuantSpec(bits),
                              fault_model=fault_model, mbu_width=mbu_width)


def corrupt_leaves(leaves, rates, seeds, bits: int | None = None,
                   faulty_bits: int | None = None,
                   fault_model: str | None = None,
                   mbu_width: int | None = None) -> list:
    """``maybe_corrupt`` of each float or :class:`QTensor` leaf at its own
    rate (not None) and seed; other leaves stay.  The float leaves go
    through ONE grouped ``quant_bitflip`` call (a launch pair on the card
    for up to 32 of them), read in place: a leaf ``expand``-ed over the
    rows of a ``[R]`` rate is not copied."""
    out = [maybe_corrupt(leaf, r, s, bits=bits, faulty_bits=faulty_bits,
                         fault_model=fault_model, mbu_width=mbu_width)
           if isinstance(leaf, QTensor) else leaf
           for leaf, r, s in zip(leaves, rates, seeds)]
    floats = [i for i, leaf in enumerate(leaves)
              if not isinstance(leaf, QTensor) and leaf.is_floating_point()]
    ys = kops.quant_bitflip_group(
        [leaves[i] for i in floats], [seeds[i] for i in floats],
        [rates[i] for i in floats],
        FAULT_LSBS if faulty_bits is None else faulty_bits,
        QuantSpec(FAULT_BITS if bits is None else bits),
        fault_model=FAULT_MODEL if fault_model is None else fault_model,
        mbu_width=MBU_WIDTH if mbu_width is None else mbu_width)
    for i, y in zip(floats, ys):
        out[i] = y
    return out


def corrupt_params(params, rate, seed, bits: int | None = None,
                   faulty_bits: int | None = None,
                   fault_model: str | None = None,
                   mbu_width: int | None = None):
    """Corrupt every float or :class:`QTensor` leaf (leaf ``j`` at seed
    ``seed + 977 * j``, the float leaves in one grouped call); ``rate``
    None dequantizes."""
    if rate is None:
        return dequantize_params(params)
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, corrupt_leaves(
        leaves, [rate] * len(leaves),
        [seed + 977 * i for i in range(len(leaves))], bits=bits,
        faulty_bits=faulty_bits, fault_model=fault_model,
        mbu_width=mbu_width))


def fault_dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` whose weight may be fault-wrapped: a :class:`FaultedQ`
    runs the ``fault_matmul`` kernel (rows of ``x`` at their own rates,
    the weights dequantized to their own dtype, the reference's
    ``out_dtype``), a clean :class:`QTensor` dequantizes first, a tensor
    multiplies as is (``[K, N]`` shared or ``[R, K, N]`` per row), through
    ``ref.matmul``: in XLA's order on the CPU.

    The weight's dtype is the model's, and x's is too except in the
    encoder-decoder, whose float32 encoder input meets bf16 weights: the
    encoder's projections and the decoder's cross-attention K/V.  There the
    result follows JAX's promotion, float32, computed on the weight's bf16
    values (``w.float()``)."""
    if isinstance(w, FaultedQ):
        return kops.fault_matmul(x.contiguous(), w.qw, w.scale, w.seed, w.rate,
                                 w.faulty_bits, fault_model=w.fault_model,
                                 mbu_width=w.mbu_width, out_dtype=w.dtype)
    if isinstance(w, QTensor):
        w = w.dequant()
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if w.ndim == 3:      # per-row weights: one matmul per row, like the
        # conv loop, so a row never depends on how many rows share the call
        return torch.stack([kref.matmul(x[r], w[r])
                            for r in range(w.shape[0])])
    return kref.matmul(x, w)


# --------------------------------------------------------------------------
# Initialisers: drawn in float32 on the generator's device, then cast
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * scale).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def init_norm(kind: str, d: int, dtype: torch.dtype, device=None) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"w": torch.ones(d, dtype=dtype, device=device),
                "b": torch.zeros(d, dtype=dtype, device=device)}
    if kind == "np_layernorm":            # olmo: non-parametric LN
        return {}
    raise ValueError(kind)


def _rows_last(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A last-axis parameter, shared ``[d]`` or per row ``[R, d]``, shaped
    to broadcast against ``x [R, ..., d]``."""
    if w.ndim == 1:
        return w
    return w.reshape(w.shape[0], *([1] * (x.ndim - 2)), w.shape[-1])


def norm_fwd(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6
             ) -> torch.Tensor:
    """In float32 over the last axis, back to ``x``'s dtype.  A last-axis
    reduction keeps each output's summation order whatever the number of
    rows (one warp an output on the card, at these widths)."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (y * _rows_last(p["w"], x).to(torch.float32)).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, -1, keepdim=True)       # jnp.var's formula
    y = c * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * _rows_last(p["w"], x).to(torch.float32) \
            + _rows_last(p["b"], x).to(torch.float32)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, half: int, theta: float):
    """RoPE's float32 ``(cos, sin)``, ``[..., S, half]``, of ``positions
    [..., S]``: built once for the q and the k of an attention."""
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions: ``[S]`` (or decode's ``[B,
    1]``).  bf16 x times the fp32 cos/sin promotes to fp32 and is cast
    back, as in the reference (``kernels.ops.rope``: one pass on the
    card)."""
    return kops.rope(x, *rope_tables(positions, x.shape[-1] // 2, theta))


# --------------------------------------------------------------------------
# Attention (GQA; chunked flash; causal / sliding-window; logit softcap)
# --------------------------------------------------------------------------
def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype: torch.dtype) -> dict:
    return {
        "wq": dense_init(gen, d, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d, dtype),
    }


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_q: torch.Tensor, pos_k: torch.Tensor, *,
                    window: int | None = None, softcap: float = 0.0,
                    kv_chunk: int = 1024, causal: bool = True
                    ) -> torch.Tensor:
    """Online-softmax attention over KV chunks, in float32, for ONE row.

    q: ``[B, Sq, Hq, Dh]``; k, v: ``[B, Skv, Hkv, Dh]``; pos_*: ``[Sq]`` /
    ``[Skv]``.  Never materialises ``[Sq, Skv]``; the extra memory is
    ``[B, Sq, Hq, chunk]``.  The reference's ``CAUSAL_SKIP``,
    ``ATTN_BF16_COMPUTE`` and ``seq_axis`` toggles are off there or TPU
    sharding, and have no counterpart."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    qs = (q * torch.tensor(Dh ** -0.5, dtype=q.dtype)).to(torch.float32)
    qs = qs.reshape(B, Sq, Hkv, g, Dh)
    kv_chunk = min(kv_chunk, Skv)
    n_chunks = -(-Skv // kv_chunk)
    pad = n_chunks * kv_chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(pos_k, (0, pad), value=-(2 ** 30))
    m = torch.full((B, Sq, Hkv, g), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, g, Dh), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kb, vb, pb = k[:, sl], v[:, sl], pos_k[sl]
        s = torch.einsum("bqhgd,bchd->bqhgc", qs, kb.to(torch.float32))
        s = _softcap(s, softcap)
        valid = pb[None, :] >= 0
        if causal:
            valid = valid & (pb[None, :] <= pos_q[:, None])
        if window is not None:
            valid = valid & (pos_q[:, None] - pb[None, :] < window)
        # a Python scalar, not a tensor made on the card: that would be a
        # host-to-device copy the host waits on, once a call
        s = torch.where(valid[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgc,bchd->bqhgd", p, vb.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def attention_fwd(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, n_kv: int, head_dim: int, rope_theta: float,
                  window: int | None = None, softcap: float = 0.0,
                  kv_chunk: int = 1024, memory: torch.Tensor | None = None,
                  memory_pos: torch.Tensor | None = None,
                  seq_axis: str | None = None) -> torch.Tensor:
    """Causal self-attention of ``x [R, B, S, D]``, or, with ``memory [R,
    B, Sk, D]`` given, attention to the memory: K and V projected from it,
    no rope on either side, not causal (the encoder's bidirectional
    self-attention is ``memory = x``).  The projections go through
    :func:`fault_dense`; the attention itself runs one row at a time, so
    its einsums see the same shapes whatever the row count (a batched
    einsum may pick another algorithm, and so another summation order, for
    another R).  ``seq_axis`` splits the queries over the model slots of
    :class:`Sharded` weights (the reference's layout hint; no effect on
    plain ones)."""
    return _attend(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                   head_dim=head_dim, rope_theta=rope_theta, window=window,
                   softcap=softcap, kv_chunk=kv_chunk, memory=memory,
                   memory_pos=memory_pos, seq_axis=seq_axis,
                   need_kv=False)[0]


def attention_prefill(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                      n_heads: int, n_kv: int, head_dim: int,
                      rope_theta: float, window: int | None = None,
                      softcap: float = 0.0, kv_chunk: int = 1024,
                      seq_axis: str | None = None):
    """Causal self-attention as :func:`attention_fwd`, also returning the
    roped K and V, ``[R, B, S, Hkv, Dh]`` each (whole, on the row's first
    slot under tensor parallelism), that the cache is built from: ``(out,
    k, v)``."""
    return _attend(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                   head_dim=head_dim, rope_theta=rope_theta, window=window,
                   softcap=softcap, kv_chunk=kv_chunk, seq_axis=seq_axis)


def _attend(p, x, positions, *, n_heads, n_kv, head_dim, rope_theta, window,
            softcap, kv_chunk, memory=None, memory_pos=None, seq_axis=None,
            need_kv=True):
    if isinstance(p["wo"], Sharded):
        return _attend_tp(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                          head_dim=head_dim, rope_theta=rope_theta,
                          window=window, softcap=softcap, kv_chunk=kv_chunk,
                          memory=memory, memory_pos=memory_pos,
                          seq_axis=seq_axis, need_kv=need_kv)
    R, B, S, _ = x.shape
    src = x if memory is None else memory
    Sk = src.shape[2]
    q = fault_dense(x, p["wq"]).reshape(R, B, S, n_heads, head_dim)
    k = fault_dense(src, p["wk"]).reshape(R, B, Sk, n_kv, head_dim)
    v = fault_dense(src, p["wv"]).reshape(R, B, Sk, n_kv, head_dim)
    if memory is None:
        tables = rope_tables(positions, head_dim // 2, rope_theta)
        q, k = kops.rope(q, *tables), kops.rope(k, *tables)
        pos_k, causal = positions, True
    else:
        pos_k = memory_pos if memory_pos is not None else torch.arange(
            Sk, dtype=torch.int32, device=x.device)
        causal = False
    o = torch.stack([flash_attention(q[r], k[r], v[r], positions, pos_k,
                                     window=window, softcap=softcap,
                                     kv_chunk=kv_chunk, causal=causal)
                     for r in range(R)])
    return fault_dense(o.reshape(R, B, S, n_heads * head_dim), p["wo"]), k, v


def _attend_tp(p, x, positions, *, n_heads, n_kv, head_dim, rope_theta,
               window, softcap, kv_chunk, memory, memory_pos, seq_axis,
               need_kv):
    """:func:`_attend` with :class:`Sharded` projections (see the module
    docstring): ``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel.
    With whole heads on every slot each slot attends over its own heads;
    else q, k and v are all-gathered (a shard boundary may fall inside a
    head) and the heads attend on the row's first slot, or, with
    ``seq_axis``, each slot attends for its share of the queries over the
    gathered K/V.  K and V come back whole on the first slot."""
    wq, wk, wv, wo = (p[k] for k in ("wq", "wk", "wv", "wo"))
    if not wo.split:                 # the head columns do not split
        return _attend(whole_tree(p), x, positions, n_heads=n_heads,
                       n_kv=n_kv, head_dim=head_dim, rope_theta=rope_theta,
                       window=window, softcap=softcap, kv_chunk=kv_chunk,
                       memory=memory, memory_pos=memory_pos)
    devs, nm = list(wo.devices), wo.nm
    home = devs[0]
    R, B, S, _ = x.shape
    src = x if memory is None else memory
    Sk = src.shape[2]
    if memory is None:
        pos_k, causal = positions, True
    else:
        pos_k = memory_pos if memory_pos is not None else torch.arange(
            Sk, dtype=torch.int32, device=x.device)
        causal = False
    kw = dict(window=window, softcap=softcap, kv_chunk=kv_chunk,
              causal=causal)
    split_q = seq_axis is not None and S % nm == 0
    if (not split_q and n_heads % nm == 0 and n_kv % nm == 0
            and wq.split and wk.split and wv.split):
        xs = C.broadcast(x, devs)
        ss = xs if memory is None else C.broadcast(memory, devs)
        outs, ks, vs = [], [], []
        for m, dev in enumerate(devs):
            q = fault_dense(xs[m], wq.local(m)).reshape(
                R, B, S, n_heads // nm, head_dim)
            k = fault_dense(ss[m], wk.local(m)).reshape(
                R, B, Sk, n_kv // nm, head_dim)
            v = fault_dense(ss[m], wv.local(m)).reshape(
                R, B, Sk, n_kv // nm, head_dim)
            pq, pk = positions.to(dev), pos_k.to(dev)
            if memory is None:
                tables = rope_tables(pq, head_dim // 2, rope_theta)
                q, k = kops.rope(q, *tables), kops.rope(k, *tables)
            o = torch.stack([flash_attention(q[r], k[r], v[r], pq, pk, **kw)
                             for r in range(R)])
            outs.append(fault_dense(o.reshape(R, B, S, -1), wo.local(m)))
            ks.append(k)
            vs.append(v)
        out = C.all_reduce(outs, [home])[0]
        if not need_kv:
            return out, None, None
        return (out, C.all_gather(ks, 3, [home])[0],
                C.all_gather(vs, 3, [home])[0])
    kv_devs = devs if split_q else None
    q = project(x, wq, mm=fault_dense).reshape(R, B, S, n_heads, head_dim)
    k = project(src, wk, kv_devs, mm=fault_dense)
    v = project(src, wv, kv_devs, mm=fault_dense)
    if not split_q:
        k, v = [k], [v]
    k = [t.reshape(R, B, Sk, n_kv, head_dim) for t in k]
    v = [t.reshape(R, B, Sk, n_kv, head_dim) for t in v]
    if memory is None:
        q = rope(q, positions, rope_theta)
        k = [rope(t, positions.to(t.device), rope_theta) for t in k]
    if split_q:                      # each slot its share of the queries
        rows = S // nm
        qs = C.broadcast(q, devs)
        parts = []
        for m, dev in enumerate(devs):
            sl = slice(m * rows, (m + 1) * rows)
            pq = positions[sl].to(dev)
            parts.append(torch.stack([flash_attention(
                qs[m][r][:, sl], k[m][r], v[m][r], pq, pos_k.to(dev), **kw)
                for r in range(R)]))
        o = C.all_gather(parts, 2, [home])[0]
    else:
        o = torch.stack([flash_attention(q[r], k[0][r], v[0][r], positions,
                                         pos_k, **kw) for r in range(R)])
    out = row_product(o.reshape(R, B, S, n_heads * head_dim), wo,
                      mm=fault_dense)
    return out, k[0].to(home), v[0].to(home)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: int | None = None,
                     softcap: float = 0.0):
    """One token against a cache, in float32.

    q: ``[B, Hq, Dh]``; k_cache, v_cache: ``[B, Skv, Hkv, Dh]``;
    cache_pos: ``[B, Skv]`` absolute positions (-1 an empty slot); pos:
    ``[B]``.  Returns the partials ``(num [B, Hq, Dh], max [B, Hq], den
    [B, Hq])`` that :func:`lse_combine` folds."""
    B, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    g = Hq // Hkv
    qs = (q * torch.tensor(Dh ** -0.5, dtype=q.dtype)).to(torch.float32)
    qs = qs.reshape(B, Hkv, g, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qs, k_cache.to(torch.float32))
    s = _softcap(s, softcap)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window is not None:
        valid = valid & (pos[:, None] - cache_pos < window)
    # a Python scalar: a tensor made on the card would make the host wait
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    num = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    return num.reshape(B, Hq, Dh), m.reshape(B, Hq), den.reshape(B, Hq)


def lse_combine(num, m, den) -> torch.Tensor:
    """Fold the partials of :func:`decode_attention`: ``num``, ``m`` and
    ``den`` are one shard's tensors, or sequences of several shards'
    (a cache sequence-sharded over a mesh axis), all on one device.
    Several shards combine as the reference's ``pmax``/``psum`` do: the
    max over the shards, each shard's ``num`` and ``den`` rescaled by
    ``exp(m_i - max)`` and summed in shard order."""
    if isinstance(num, torch.Tensor):
        return num / torch.clamp_min(den[..., None], 1e-30)
    m_g = m[0]
    for m_i in m[1:]:
        m_g = torch.maximum(m_g, m_i)
    num_g = den_g = None
    for n_i, m_i, d_i in zip(num, m, den, strict=True):
        w = torch.exp(m_i - m_g)
        a, b = n_i * w[..., None], d_i * w
        num_g = a if num_g is None else num_g + a
        den_g = b if den_g is None else den_g + b
    return num_g / torch.clamp_min(den_g[..., None], 1e-30)


# --------------------------------------------------------------------------
# MLP (gated / plain)
# --------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype: torch.dtype) -> dict:
    p = {"w1": dense_init(gen, d, d_ff, dtype),
         "w2": dense_init(gen, d_ff, d, dtype)}
    if act.endswith("_glu"):
        p["w3"] = dense_init(gen, d, d_ff, dtype)
    return p


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    """The reference's activations written out op by op, each op rounded
    to ``x``'s dtype as XLA rounds it: ``jax.nn.silu`` is ``x *
    logistic(x)`` with ``logistic = 1 / (1 + exp(-x))``, and
    ``jax.nn.gelu`` (its default, the tanh form) rounds its constants to
    ``x``'s dtype.  In bf16 this is bitwise the reference on the CPU;
    ``F.silu`` and ``F.gelu`` round once, and differ in about 40% of
    elements."""
    base = act.removesuffix("_glu")
    if base == "silu":
        return x * (1 / (1 + torch.exp(-x)))
    if base == "gelu":
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        k = torch.tensor(0.044715, dtype=x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))
    if base == "relu":
        return F.relu(x)
    raise ValueError(act)


def _gate(h1: torch.Tensor, act: str, h3) -> torch.Tensor:
    """The MLP's hidden activation of the first product ``h1``: ``act``
    of it, times the second product ``h3()`` for a gated ``act``.  The
    SwiGLU gate is ``kernels.ops.swiglu`` (one pass on the card)."""
    if act == "silu_glu":
        return kops.swiglu(h1, h3())
    h = _act(h1, act)
    return h * h3() if act.endswith("_glu") else h


def mlp_fwd(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The gated or plain MLP; with :class:`Sharded` weights ``w1``/``w3``
    are column-parallel and ``w2`` row-parallel, each model slot computing
    its slice of ``d_ff`` and one ``all_reduce`` summing the slots'
    outputs."""
    if isinstance(p["w1"], Sharded):
        return _mlp_tp(p, x, act)
    return fault_dense(_gate(fault_dense(x, p["w1"]), act,
                             lambda: fault_dense(x, p["w3"])), p["w2"])


def _mlp_tp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    w = [p[k] for k in ("w1", "w2", "w3") if k in p]
    if not all(t.split for t in w):
        return mlp_fwd(whole_tree(p), x, act)
    devs = list(p["w1"].devices)
    xs = C.broadcast(x, devs)
    outs = []
    for m in range(len(devs)):
        h = _gate(fault_dense(xs[m], p["w1"].local(m)), act,
                  lambda: fault_dense(xs[m], p["w3"].local(m)))
        outs.append(fault_dense(h, p["w2"].local(m)))
    return C.all_reduce(outs, [devs[0]])[0]


# --------------------------------------------------------------------------
# The MoE, RG-LRU and SSD blocks.  Each runs ONE row: x ``[B, S, D]`` and
# that row's weights (the block loops over rows), so a row's sums never
# depend on how many rows share the step.  Float32 transcendentals (exp,
# sqrt, logistic, softplus) are PyTorch's, 1-3 ulp from XLA's CPU ones,
# so these blocks agree with the reference within a stated tolerance in
# float32; integer and bitwise-defined steps (routing, the scan's order,
# the conv's roundings) follow it exactly.
# --------------------------------------------------------------------------
def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (which
    ``F.softplus`` applies above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_moe(gen: torch.Generator, d: int, n_experts: int, d_ff: int,
             act: str, dtype: torch.dtype) -> dict:
    def einit(din, dout):
        return (torch.randn(n_experts, din, dout, generator=gen,
                            device=gen.device) / math.sqrt(din)).to(dtype)
    p = {"router": dense_init(gen, d, n_experts, torch.float32),
         "w1": einit(d, d_ff), "w2": einit(d_ff, d)}
    if act.endswith("_glu"):
        p["w3"] = einit(d, d_ff)
    return p


def moe_capacity(T: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert for ``T`` tokens of ONE row (the reference's rule:
    ``cf >= E / top_k`` or ``cf <= 0`` is dropless, ``C = T``)."""
    if capacity_factor <= 0 or capacity_factor >= n_experts / top_k:
        return T
    return min(T, max(1, int(capacity_factor * top_k * T / n_experts)))


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf")``: on the CPU one ``ref.matmul`` an expert
    (XLA's order for bf16), on the card one batched product (one row's
    experts, so its shapes never depend on the row count)."""
    if x.device.type == "cpu":
        return torch.stack([kref.matmul(x[e], w[e])
                            for e in range(w.shape[0])])
    return torch.matmul(x, w)


def moe_route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """``(gate_vals, gate_idx)`` of tokens ``xt [T, D]``: the float32
    softmax of the router logits, its ``top_k`` by a stable descending
    sort (ties toward the lower expert, as ``jax.lax.top_k``, which
    ``torch.topk`` does not promise), the gates renormalised."""
    logits = kref.matmul(xt.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return vals, idx


def moe_dispatch(gate_idx: torch.Tensor, C: int, n_experts: int):
    """The reference's sort-based dispatch of the ``(token, k)`` pairs:
    ``(order, slot, keep)``, with ``order`` the stable argsort of the
    pairs by expert, ``slot`` each sorted pair's row of the ``[E C + 1]``
    buffer (``E C``, the overflow slot, for a pair past its expert's
    capacity) and ``keep`` whether it fits.  No host sync: no ``.item()``,
    no boolean indexing."""
    Tk = gate_idx.numel()
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos_in_e = torch.arange(Tk, device=se.device) \
        - torch.searchsorted(se, se, side="left")
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e,
                       torch.full_like(se, n_experts * C))
    return order, slot, keep


def moe_fwd(p: dict, x: torch.Tensor, *, top_k: int, act: str,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """One row's tokens ``x [B, S, D]`` through the experts: routed by
    :func:`moe_route`, dispatched by :func:`moe_dispatch` into ``[E, C,
    D]`` slots (``C`` from ``T = B S`` of this row), the expert products,
    then each pair's output times its gate, summed back per token.

    The reference sums the pairs with a scatter-add from 0 in sorted
    order; here each token's ``top_k`` contributions are added from 0 in
    k order.  For ``top_k <= 2`` the two agree exactly (``0 + a + b ==
    0 + b + a`` in IEEE arithmetic) and no atomic is needed; a larger
    ``top_k`` would make the sum order-dependent, and raises.  Under
    tensor parallelism the experts and router are gathered whole on the
    row's first slot (``tp_block``) and the block computes there."""
    if top_k > 2:
        raise NotImplementedError(
            f"moe_fwd sums a token's experts in a fixed order, exact only "
            f"for top_k <= 2 (got {top_k})")
    B, S, D = x.shape
    E = p["router"].shape[-1]
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, gate_idx = moe_route(p["router"], xt, top_k)
    C = moe_capacity(T, E, top_k, capacity_factor)
    order, slot, keep = moe_dispatch(gate_idx, C, E)
    st = order // top_k                   # the sorted pairs' tokens
    sw = gate_vals.reshape(-1)[order]
    buf = x.new_zeros((E * C + 1, D))
    buf[slot] = torch.where(keep[:, None], xt[st], 0.0)
    eb = buf[:E * C].reshape(E, C, D)
    h = _gate(_expert_matmul(eb, p["w1"]), act,
              lambda: _expert_matmul(eb, p["w3"]))
    eo = _expert_matmul(h, p["w2"])                            # [E, C, D]
    flat_out = torch.cat([eo.reshape(E * C, D), eo.new_zeros((1, D))])
    contrib = flat_out[slot] * sw[:, None] * keep[:, None]      # float32
    # back to (token, k) order, then each token's pairs summed from 0
    pairs = torch.empty_like(contrib)
    pairs[order] = contrib
    pairs = pairs.reshape(T, top_k, D)
    out = torch.zeros((T, D), dtype=contrib.dtype, device=x.device)
    for j in range(top_k):
        out = out + pairs[:, j]
    return out.reshape(B, S, D).to(x.dtype)


# --------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------
_RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, d: int, lru_width: int,
               conv_kernel: int, dtype: torch.dtype) -> dict:
    w, dev = lru_width, gen.device
    lin = np.linspace(0.9, 0.999, w)
    return {
        "in_x": dense_init(gen, d, w, dtype),
        "in_g": dense_init(gen, d, w, dtype),
        "conv": (torch.randn(conv_kernel, w, generator=gen, device=dev)
                 * (1.0 / math.sqrt(conv_kernel))).to(dtype),
        "wa": dense_init(gen, w, w, dtype),
        "wx": dense_init(gen, w, w, dtype),
        # float32 whatever the model's dtype, as in the reference
        "lam": torch.as_tensor(np.log(np.expm1(lin) / (1 - lin)),
                               dtype=torch.float32, device=dev),
        "out": dense_init(gen, w, d, dtype),
    }


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` at the even and ``b`` at the odd places of axis 1.  JAX pads
    each with zeros and adds, so every element is ``v + 0`` (a -0.0 comes
    out +0.0); the ``+ 0`` keeps that."""
    n = a.shape[1] + b.shape[1]
    out = a.new_zeros((a.shape[0], n, *a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out + 0.0


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """The linear recurrence ``h_t = a_t h_{t-1} + b_t`` along axis 1 by
    ``jax.lax.associative_scan``'s odd/even recursion, op for op, so it is
    bitwise the reference's eager scan: combine the pairs ``[0:-1:2]``
    with ``[1::2]``, scan that, combine the result with ``[2::2]``,
    prepend the first element, interleave.  log2(S) levels of strided
    elementwise ops instead of S steps.  Returns ``(a_scan, h)``."""
    def combine(x, y):
        (a1, b1), (a2, b2) = x, y
        return a1 * a2, a2 * b1 + b2

    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _assoc_scan(a, b)[1]


def rglru_core(p: dict, u: torch.Tensor, h0=None):
    """``u [B, S, W]`` (the conv's output) -> ``(y, h_last)``, in float32."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(kref.matmul(uf, p["wa"].to(torch.float32)))
    i = torch.sigmoid(kref.matmul(uf, p["wx"].to(torch.float32)))
    log_a = -_RGLRU_C * r * _softplus(p["lam"])
    a = torch.exp(log_a)
    gated = i * uf
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated
    with span("forward.rglru_scan"):
        h = _rglru_scan(a, b, h0)
    return h.to(u.dtype), h[:, -1]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv of ``x [B, S, W]`` by ``w [K, W]``: ``(y,
    tail)``, ``tail`` the last ``K - 1`` inputs (the decode state).  The
    reference's ``sum(xp[:, i:i+S] * w[i] for i in range(K))``, each
    product and partial sum rounded to x's dtype, as written."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)) if state is None \
        else torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return y.to(x.dtype), (xp[:, -(K - 1):] if K > 1 else None)


def rglru_fwd(p: dict, x: torch.Tensor, state: dict | None = None):
    """The Griffin recurrent block of one row: in-projections, causal conv,
    RG-LRU, gated out-projection.  Returns ``(out, {"conv", "h"})``.  Under
    tensor parallelism its weights are gathered whole on the row's first
    slot (``tp_block``) and it computes there."""
    u = kref.matmul(x, p["in_x"])
    g = kref.matmul(x, p["in_g"])
    u, new_conv = causal_conv1d(u, p["conv"],
                                state["conv"] if state else None)
    y, h_last = rglru_core(p, u, state["h"] if state else None)
    out = kref.matmul(y * _act(g, "gelu"), p["out"])
    return out, {"conv": new_conv, "h": h_last}


# --------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked scan)
# --------------------------------------------------------------------------
def init_ssd(gen: torch.Generator, d: int, *, expand: int, head_dim: int,
             state: int, conv_kernel: int, dtype: torch.dtype) -> dict:
    d_in = expand * d
    nh = d_in // head_dim
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * state + nh, dtype),
        "conv": (torch.randn(conv_kernel, d_in + 2 * state, generator=gen,
                             device=dev) * 0.5).to(dtype),
        "A_log": torch.as_tensor(np.log(np.linspace(1.0, 16.0, nh)),
                                 dtype=torch.float32, device=dev),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, d, dtype),
        "norm_w": torch.ones(d_in, dtype=dtype, device=dev),
    }


def _ssd_chunk_scan(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD in float32.  x ``[B, S, H, P]``; dt ``[B, S, H]``; A
    ``[H]`` (positive decay rates, used as -A); Bm, Cm ``[B, S, N]``.
    The last chunk is zero-padded.  The three-operand einsums contract
    pairwise in ``jnp.einsum``'s order (its ``einsum_path``).  Returns
    ``(y [B, S, H, P], h_last [B, H, P, N])``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)
    negA = -A.to(f32)
    li = torch.arange(chunk, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    ys = []
    for c in range(nc):
        xb, dtb, bb, cb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dtb * negA[None, None, :], dim=1)    # [B,l,H]
        # the incoming state: y_state[i] = exp(cum_i) C_i . h
        y_state = torch.einsum("bln,bhpn->blhp", cb, h) \
            * torch.exp(cum)[..., None]
        # within the chunk: (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i;
        # rel clamped before exp, as the reference does
        rel = cum[:, :, None, :] - cum[:, None, :, :]            # [B,l,l,H]
        w = torch.where(causal, torch.exp(torch.clamp_max(rel, 0.0)), 0.0) \
            * dtb[:, None, :, :]
        cb_dot = torch.einsum("bln,bmn->blm", cb, bb)
        # "blm,blmh,bmhp->blhp" as (blm,blmh->blmh), then (.,bmhp->blhp)
        y_intra = torch.einsum("blmh,bmhp->blhp", cb_dot[..., None] * w, xb)
        # h' = exp(cum_L) h + sum_i exp(cum_L - cum_i) dt_i B_i x_i;
        # "bln,blh,blhp->bhpn" as (blh,blhp->blhp), then (bln,.->bhpn)
        dec = torch.exp(cum[:, -1:, :] - cum) * dtb
        contrib = torch.einsum("bln,blhp->bhpn", bb, dec[..., None] * xb)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + contrib
        ys.append(y_state + y_intra)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y, h


def ssd_fwd(p: dict, x: torch.Tensor, *, expand: int, head_dim: int,
            state: int, chunk: int = 128, cache: dict | None = None):
    """The Mamba2 block of one row, ``x [B, S, D]``: in-projection, the
    causal conv over (x, B, C), the chunked scan, the skip ``D``, the gated
    RMSNorm and the out-projection.  Returns ``(out, {"conv", "h"})``.
    Under tensor parallelism its weights are gathered whole on the row's
    first slot (``tp_block``) and it computes there: the fused
    ``in_proj``'s columns (z, x, B, C, dt) do not align with its heads."""
    B, S, D = x.shape
    d_in = expand * D
    nh = d_in // head_dim
    proj = kref.matmul(x, p["in_proj"])
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * state, nh], dim=-1)
    xbc, new_conv = causal_conv1d(xbc, p["conv"],
                                  cache["conv"] if cache else None)
    xbc = _act(xbc, "silu")
    xs, Bm, Cm = torch.split(xbc, [d_in, state, state], dim=-1)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None, :])
    xh = xs.reshape(B, S, nh, head_dim)
    A = torch.exp(p["A_log"])
    with span("forward.ssd_chunk_scan"):
        y, h_last = _ssd_chunk_scan(xh, dt, A, Bm, Cm, chunk,
                                    cache["h"] if cache else None)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = norm_fwd({"w": p["norm_w"]}, y * _act(z, "silu"), "rmsnorm")
    return kref.matmul(y, p["out_proj"]), {"conv": new_conv, "h": h_last}
