"""Building blocks of the model zoo, the counterpart of
``repro/models/layers.py``: the fault plumbing, and the dense decoder's
blocks (initialisers, the three norms, RoPE, chunked flash attention, the
gated and plain MLPs).  MoE, the RG-LRU scan, the SSD chunk scan and decode
attention are not ported yet (ROADMAP.md Queue A item 11).

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

import torch
import torch.nn.functional as F

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.faultmodel import FAULT_MODELS
from repro_torch.quant.fixedpoint import QuantSpec, quantize

__all__ = ["QTensor", "FaultedQ", "quantize_leaf", "quantize_params",
           "dequantize_params", "maybe_corrupt", "corrupt_params",
           "fault_dense", "set_fault_bits", "set_fault_model", "dense_init",
           "init_norm", "norm_fwd", "rope", "init_attention",
           "flash_attention", "attention_fwd", "init_mlp", "mlp_fwd"]

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
    runs the ``fault_matmul`` kernel (rows of ``x`` at their own rates,
    the weights cast to ``x.dtype``, which is the original weight dtype
    on every path of the port), a clean :class:`QTensor` dequantizes
    first, a tensor multiplies as is (``[K, N]`` shared or ``[R, K, N]``
    per row), through ``ref.matmul``: in XLA's order on the CPU."""
    if isinstance(w, FaultedQ):
        return kops.fault_matmul(x.contiguous(), w.qw, w.scale, w.seed, w.rate,
                                 w.faulty_bits, fault_model=w.fault_model,
                                 mbu_width=w.mbu_width)
    if isinstance(w, QTensor):
        w = w.dequant()
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
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions: ``[S]``.  bf16 x times the fp32
    cos/sin promotes to fp32 and is cast back, as in the reference."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
        s = torch.where(valid[None, :, None, None, :], s,
                        torch.tensor(-1e30, dtype=s.dtype, device=s.device))
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
                  kv_chunk: int = 1024) -> torch.Tensor:
    """Causal self-attention of ``x [R, B, S, D]``.  The projections go
    through :func:`fault_dense`; the attention itself runs one row at a
    time, so its einsums see the same shapes whatever the row count (a
    batched einsum may pick another algorithm, and so another summation
    order, for another R)."""
    R, B, S, _ = x.shape
    q = fault_dense(x, p["wq"]).reshape(R, B, S, n_heads, head_dim)
    k = fault_dense(x, p["wk"]).reshape(R, B, S, n_kv, head_dim)
    v = fault_dense(x, p["wv"]).reshape(R, B, S, n_kv, head_dim)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    o = torch.stack([flash_attention(q[r], k[r], v[r], positions, positions,
                                     window=window, softcap=softcap,
                                     kv_chunk=kv_chunk) for r in range(R)])
    return fault_dense(o.reshape(R, B, S, n_heads * head_dim), p["wo"])


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


def mlp_fwd(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = _act(fault_dense(x, p["w1"]), act)
    if act.endswith("_glu"):
        h = h * fault_dense(x, p["w3"])
    return fault_dense(h, p["w2"])
