"""The LM stack, the counterpart of ``repro/models/transformer.py`` for
the block kinds ``attn``/``local``/``global`` (with MoE and arctic's dense
residual), ``rglru`` and ``ssd`` and the encoder-decoder: olmo-1b,
starcoder2-3b, gemma2-27b, deepseek-coder-33b, phi-3-vision-4.2b,
mixtral-8x7b, arctic-480b, recurrentgemma-2b, mamba2-2.7b and
seamless-m4t-medium.

Params keep the reference's tree: ``embed [V, D]``, ``groups`` (one entry
``b{s}`` per slot of ``block_pattern``, every leaf stacked over the groups;
for the encoder-decoder the decoder's cross blocks, stacked over its
layers), ``final_norm``, untied ``lm_head [D, V]``, and for the
encoder-decoder ``enc_groups`` (its ``attn`` blocks, stacked) and
``enc_norm``, so a reference tree carries across leaf for leaf
(``repro_torch.convert``).  The reference scans the groups; here they are
a Python loop.

Row axis: the reference adds the population axis with ``vmap``; here the
hidden state is ``[R, B, S, D]`` and rates are ``[R]`` tensors (or None).
Every computation whose algorithm could depend on the row count runs one
row at a time (the attention einsums, the head matmul, the per-row weights
of the generic and tables backends, the MoE, RG-LRU and SSD blocks), and
the norms reduce over the last axis only, so a row's logits are bitwise
those of that row run alone.

Fault injection (the paper's technique) enters through a ``(w_rates,
a_rates, seed)`` triple: layer ``i`` (encoder layers first for the
encoder-decoder) corrupts its block at ``seed + 7919 i`` (leaf ``j`` of
the block at ``+ 977 j``) and its input at ``+ 1``; the embedding, the
encoder's and the final norm and the head are never corrupted.

The encoder-decoder keeps the reference's dtypes: its encoder input
``enc_embeds`` is float32 and is never cast, so in a bf16 model the
encoder's hidden state and its memory are float32 (every encoder
projection and the decoder's cross-attention K/V are float32 x on bf16
weights, ``layers.fault_dense``) while the decoder's hidden state is bf16.

Serving: :func:`prefill` runs the prompt (one row) and returns its cache,
:func:`decode_step` runs one token per sequence against it.  A cache is
the reference's tree, every leaf stacked over the groups and the batch
its second axis:

  attn global      k/v [G, B, max_len, Hkv, Dh] + pos [G, B, max_len]
  local / swa      the same, a ring of ``window`` slots (slot = pos % Sc)
  rglru            conv [G, B, K-1, W] + h [G, B, W] (float32)
  ssd              conv [G, B, K-1, C] + h [G, B, H, P, N] (float32)

``pos`` is -1 in an empty slot.  A decode step writes into the cache in
place and returns it.  Prefill and decode run their float32 sums in IEEE
fp32 (``fp32_exact``), as the evaluators do.  A decode step also takes a
cache sequence-sharded over several devices (flash-decode): a list of
shards in ``serve.kvcache.cache_specs(seq_shards=n)``'s layout, each on
its own device, shard ``i`` holding global slots ``[i Sc_loc, (i + 1)
Sc_loc)`` of every attention cache; each shard's partials are computed on
its device and folded by ``layers.lse_combine``.

Tensor parallelism: params whose leaves are ``layers.Sharded`` (one data
row's view of a tree laid out by ``launch.shardings.param_specs``) run
the same functions over the row's model slots.  The embedding is
vocab-parallel (each slot looks up its vocab range, an ``all_reduce``
joins them), the head gives one logits slice a slot (a list: the cross
entropy combines the slots' logsumexps), the blocks split as
``layers.tp_block`` says, and the activations stay on the row's first
slot.  A vocab the slots do not divide stays whole.  A tensor-parallel
forward or prefill takes no faults (the reference's launch steps take
none); a decode step corrupts each layer's leaves whole on the row's
first slot, in the one grouped call a layer, then splits them.
:func:`prefill` and :func:`decode_step` return whole logits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch._device import fp32_exact, resolve_device
from repro_torch._tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.launch import collectives as C
from repro_torch.models import layers as L

__all__ = ["init_lm", "forward", "embed_tokens", "unembed", "LMStepModel",
           "init_cache", "prefill", "decode_step", "encode", "whole_logits",
           "corrupt_block"]

_ATTN_KINDS = ("attn", "local", "global")


# ==========================================================================
# Parameter construction
# ==========================================================================
def _init_block(cfg: ArchConfig, kind: str, gen: torch.Generator,
                dtype) -> dict:
    """One block of ``kind``, in the reference's tree layout (the keys
    decide the sorted flatten order, and so each leaf's fault seed)."""
    d, dev = cfg.d_model, gen.device
    p = {"ln1": L.init_norm(cfg.norm_kind, d, dtype, dev)}
    if kind in _ATTN_KINDS:
        p["attn"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim_, dtype)
        p["ln2"] = L.init_norm(cfg.norm_kind, d, dtype, dev)
        if cfg.is_moe:
            p["moe"] = L.init_moe(gen, d, cfg.n_experts,
                                  cfg.expert_d_ff or cfg.d_ff, cfg.act_fn,
                                  dtype)
            if cfg.moe_dense_residual:
                p["dense_mlp"] = L.init_mlp(gen, d, cfg.dense_d_ff or cfg.d_ff,
                                            cfg.act_fn, dtype)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act_fn, dtype)
    elif kind == "rglru":
        p["rec"] = L.init_rglru(gen, d, cfg.lru_width or d, cfg.conv_kernel,
                                dtype)
        p["ln2"] = L.init_norm(cfg.norm_kind, d, dtype, dev)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act_fn, dtype)
    elif kind == "ssd":
        p["ssd"] = L.init_ssd(gen, d, expand=cfg.ssm_expand,
                              head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                              conv_kernel=cfg.conv_kernel, dtype=dtype)
    else:
        raise ValueError(kind)
    return p


def _init_cross_block(cfg: ArchConfig, gen: torch.Generator,
                      dtype) -> dict:
    """A decoder block of the encoder-decoder: causal self-attention,
    cross-attention to the encoder's memory, MLP."""
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": L.init_norm(cfg.norm_kind, d, dtype, dev),
        "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_, dtype),
        "ln_x": L.init_norm(cfg.norm_kind, d, dtype, dev),
        "xattn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim_, dtype),
        "ln2": L.init_norm(cfg.norm_kind, d, dtype, dev),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.act_fn, dtype),
    }


def _stacked(make, n: int) -> dict:
    """``n`` blocks from ``make()``, every leaf stacked on a leading axis."""
    blocks = [make() for _ in range(n)]
    return tree_map(lambda *ls: torch.stack(ls), *blocks)


def init_lm(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random params from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (drawn in float32 there, cast to the config's dtype): the
    reference's scales, not its values (``jax.random`` draws differently;
    parity tests carry the reference's params across instead).  Every slot
    of every group is built, as in the reference, also a slot past
    ``n_layers`` (recurrentgemma-2b's 27th), which no unit runs.  The
    encoder-decoder's ``groups`` are its decoder's cross blocks."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {"embed": (torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                                    device=dev) * 0.02).to(dtype)}
    if cfg.is_encdec:
        params["groups"] = _stacked(
            lambda: _init_cross_block(cfg, gen, dtype), cfg.n_layers)
    else:
        params["groups"] = {
            f"b{s}": _stacked(lambda: _init_block(cfg, kind, gen, dtype),
                              cfg.n_groups)
            for s, kind in enumerate(cfg.block_pattern)}
    params["final_norm"] = L.init_norm(cfg.norm_kind, cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    if cfg.is_encdec:
        params["enc_groups"] = _stacked(
            lambda: _init_block(cfg, "attn", gen, dtype), cfg.n_enc_layers)
        params["enc_norm"] = L.init_norm(cfg.norm_kind, cfg.d_model, dtype,
                                         dev)
    return params


# ==========================================================================
# Fault helpers
# ==========================================================================
def _row_expand(p: dict, rate: torch.Tensor) -> dict:
    """Shared float leaves expanded to the rows of the ``[R]`` rate (the
    row axis ``quant_bitflip`` corrupts per row); resident QTensors stay."""
    R = rate.shape[0]
    return tree_map(lambda w: w if isinstance(w, L.QTensor)
                    else w.expand(R, *w.shape), p)


# ==========================================================================
# Block forward
# ==========================================================================
def _per_row(fn, p: dict, x: torch.Tensor, per_row: bool):
    """``fn(p_r, x[r])`` for each row ``r`` of ``x [R, B, S, D]``, with
    ``p_r`` row r of the ``[R, ...]`` leaves (``per_row``) or ``p`` as
    shared: a row's arithmetic then never depends on how many rows share
    the step.  ``fn`` returns a tensor or a tree of them (a block's output
    and its state); the rows' outputs are stacked leaf by leaf."""
    out = None
    for r in range(x.shape[0]):
        pr = tree_map(lambda t, r=r: t[r], p) if per_row else p
        y = fn(pr, x[r])
        if out is None:
            out = tree_map(lambda t: t.new_empty((x.shape[0], *t.shape)), y)
        for o, t in zip(tree_leaves(out), tree_leaves(y)):
            o[r] = t
    return out


def _with_state(fn, build_cache: bool):
    """``fn`` (returning ``(y, state)``) as it is when the state is kept,
    else ``y`` alone: a row's state is stacked only to build a cache."""
    return fn if build_cache else (lambda pr, hr: fn(pr, hr)[0])


def _inject(p: dict, x: torch.Tensor, fault_rates, fault_bits,
            fault_model) -> tuple[dict, torch.Tensor]:
    """A block's fault injection: its params corrupted at the unit's
    weight rates (leaf ``j`` at ``seed + 977 j``; dequantized without), its
    input at the activation rates (``seed + 1``)."""
    wr, ar, seed = fault_rates if fault_rates is not None else (None,) * 3
    if (wr is not None or ar is not None) and isinstance(
            L.first_leaf(p), L.Sharded):
        raise ValueError("a tensor-parallel forward takes no faults (the "
                         "reference's launch steps take none); decode_step "
                         "corrupts whole leaves")
    bits, lsbs = fault_bits if fault_bits is not None else (None, None)
    fm, mw = fault_model if fault_model is not None else (None, None)
    if wr is not None:
        p = L.corrupt_params(_row_expand(p, wr), wr, seed, bits=bits,
                             faulty_bits=lsbs, fault_model=fm, mbu_width=mw)
    else:
        p = L.dequantize_params(p)      # no-op for plain float trees
    if ar is not None:
        x = L.maybe_corrupt(x, ar, seed + 1, bits=bits, faulty_bits=lsbs,
                            fault_model=fm, mbu_width=mw)
    return p, x


def _window(cfg: ArchConfig, kind: str) -> int | None:
    """The attention window of a block of ``kind`` (None: global)."""
    if kind == "local" or (kind == "attn" and cfg.attn_kind == "swa"):
        return cfg.window
    return None


def _block_fwd(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, fault_rates=None, fault_bits=None,
               fault_model=None, build_cache: bool = False,
               kv_chunk: int = 1024, ssd_chunk: int = 256,
               seq_axis: str | None = None):
    """One block of ``kind`` on ``x [R, B, S, D]``.  ``fault_bits`` is an
    optional (bits, faulty_bits) override of the corruption width,
    ``fault_model`` an optional (model, mbu_width) override; None takes the
    ``layers`` module defaults.  The MoE, RG-LRU and SSD sub-blocks run a
    row at a time; whether their leaves carry the row axis (weight faults,
    or a tables gather) is read from one leaf's rank.  With
    ``build_cache`` returns ``(x, cache)``: the attention's roped K and V
    (``{"k", "v"}``, ``[R, B, S, Hkv, Dh]`` each) or the RG-LRU's or SSD's
    final state (``{"conv", "h"}``, with the row axis)."""
    p, x = _inject(p, x, fault_rates, fault_bits, fault_model)
    p = L.tp_block(p)
    cache = None
    if kind in _ATTN_KINDS:
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                  head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
                  window=_window(cfg, kind), softcap=cfg.logit_softcap or 0.0,
                  kv_chunk=kv_chunk, seq_axis=seq_axis)
        if build_cache:
            a, k, v = L.attention_prefill(p["attn"], h, positions, **kw)
            cache = {"k": k, "v": v}
        else:
            a = L.attention_fwd(p["attn"], h, positions, **kw)
        x = x + a
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        if cfg.is_moe:
            f = _per_row(lambda pr, hr: L.moe_fwd(
                pr, hr, top_k=cfg.top_k, act=cfg.act_fn,
                capacity_factor=cfg.moe_capacity_factor),
                p["moe"], h, p["moe"]["router"].ndim == 3)
            if cfg.moe_dense_residual:
                f = f + L.mlp_fwd(p["dense_mlp"], h, cfg.act_fn)
        else:
            f = L.mlp_fwd(p["mlp"], h, cfg.act_fn)
        x = x + f
    elif kind == "rglru":
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        r = _per_row(_with_state(L.rglru_fwd, build_cache), p["rec"], h,
                     p["rec"]["lam"].ndim == 2)
        r, cache = r if build_cache else (r, None)
        x = x + r
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        x = x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
    elif kind == "ssd":
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        s = _per_row(_with_state(lambda pr, hr: L.ssd_fwd(
            pr, hr, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            state=cfg.ssm_state, chunk=ssd_chunk), build_cache),
            p["ssd"], h, p["ssd"]["A_log"].ndim == 2)
        s, cache = s if build_cache else (s, None)
        x = x + s
    else:
        raise ValueError(kind)
    return (x, cache) if build_cache else x


def _enc_block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, *, fault_rates=None,
                   fault_bits=None, fault_model=None,
                   seq_axis: str | None = None) -> torch.Tensor:
    """One encoder block of ``x [R, B, Se, D]``: bidirectional
    self-attention (attention to the memory ``h`` itself, no rope, not
    causal) and the MLP."""
    p, x = _inject(p, x, fault_rates, fault_bits, fault_model)
    p = L.tp_block(p)
    h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
    x = x + L.attention_fwd(p["attn"], h, positions, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                            rope_theta=cfg.rope_theta, memory=h,
                            memory_pos=positions, seq_axis=seq_axis)
    h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
    return x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)


def _dec_block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, memory: torch.Tensor,
                   mem_pos: torch.Tensor, *, fault_rates=None,
                   fault_bits=None, fault_model=None, build_cache=False,
                   kv_chunk: int = 1024, seq_axis: str | None = None):
    """One decoder block of the encoder-decoder on ``x [R, B, S, D]``:
    causal self-attention, cross-attention to ``memory [R, B, Se, D]``,
    the MLP.  Only ``x`` is corrupted at the activation rate.  With
    ``build_cache`` returns ``(x, {"k", "v"})``, the self-attention's roped
    K and V."""
    p, x = _inject(p, x, fault_rates, fault_bits, fault_model)
    p = L.tp_block(p)
    h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
              seq_axis=seq_axis)
    if build_cache:
        a, k, v = L.attention_prefill(p["attn"], h, positions,
                                      kv_chunk=kv_chunk, **kw)
    else:
        a = L.attention_fwd(p["attn"], h, positions, kv_chunk=kv_chunk, **kw)
    x = x + a
    h = L.norm_fwd(p["ln_x"], x, cfg.norm_kind)
    x = x + L.attention_fwd(p["xattn"], h, positions, memory=memory,
                            memory_pos=mem_pos, **kw)
    h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
    x = x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
    return (x, {"k": k, "v": v}) if build_cache else x


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


# ==========================================================================
# Embedding and head
# ==========================================================================
def _embed(cfg: ArchConfig, embed: torch.Tensor, tokens: torch.Tensor):
    """``tokens [R, B, S]`` through the table ``[V, D]`` (or one table a
    row, ``[R, V, D]``), times sqrt(d) in the table's dtype.  A
    vocab-parallel ``layers.Sharded`` table: each model slot looks up the
    tokens of its vocab range (zeros elsewhere), and an ``all_reduce``
    adds the slots' rows (one of them nonzero: exact)."""
    if isinstance(embed, L.Sharded):
        e = _embed_tp(embed, tokens)
    elif embed.ndim == 3:
        e = torch.stack([embed[r][tokens[r]] for r in range(tokens.shape[0])])
    else:
        e = embed[tokens]
    return e * torch.tensor(np.sqrt(cfg.d_model), dtype=e.dtype)


def _embed_tp(embed, tokens: torch.Tensor) -> torch.Tensor:
    if not embed.split:
        return embed.whole()[tokens]
    parts = []
    for m, dev in enumerate(embed.devices):
        t = embed.local(m)
        n = t.shape[0]
        idx = tokens.to(dev, non_blocking=True) - m * n
        inr = (idx >= 0) & (idx < n)
        parts.append(torch.where(inr[..., None], t[idx.clamp(0, n - 1)],
                                 0.0))
    return C.all_reduce(parts, [embed.devices[0]])[0]


def _embed_batch(cfg: ArchConfig, embed: torch.Tensor, batch: dict):
    """The input batch with its row axis (``{"tokens": [R, B, S]}``, or the
    stub frontend's ``{"embeds": [R, B, S, D]}`` as is), embedded.  The
    embedding itself is never corrupted."""
    if "tokens" in batch:
        return _embed(cfg, embed, batch["tokens"])
    return batch["embeds"].to(cfg.torch_dtype)


def _unembed_unit(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + head of ``x [R, B, S, D]`` -> logits ``[R, B, S, V]``;
    ``p["head"]`` is the embedding table when embeddings are tied.  The
    head matmul runs one row at a time (its shapes then never depend on
    R), through ``ref.matmul`` (XLA's order on the CPU).  A vocab-split
    ``layers.Sharded`` head gives a list, one slot's logits slice a model
    slot."""
    x = L.norm_fwd(L.whole_tree(p["final_norm"]), x, cfg.norm_kind)
    head = p["head"]
    if isinstance(head, L.Sharded):
        if not head.split:
            head = head.whole()
        else:
            xs = C.broadcast(x, head.devices)
            return [_unembed_rows(cfg, head.local(m), xs[m])
                    for m in range(head.nm)]
    return _unembed_rows(cfg, head, x)


def _unembed_rows(cfg: ArchConfig, head: torch.Tensor, x: torch.Tensor):
    per_row = head.ndim == 3
    out = None
    for r in range(x.shape[0]):
        h = head[r] if per_row else head
        y = kref.matmul(x[r], h.transpose(-1, -2) if cfg.tie_embeddings
                        else h)
        if out is None:
            out = y.new_empty((x.shape[0], *y.shape))
        out[r] = y
    if cfg.final_softcap:
        out = torch.tanh(out / cfg.final_softcap) * cfg.final_softcap
    return out


def embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor):
    """``tokens [B, S]`` -> ``[B, S, D]``."""
    return _embed(cfg, params["embed"], tokens[None])[0]


def _row0(logits):
    """Row 0 of logits, or of each vocab slice of a list."""
    return [t[0] for t in logits] if isinstance(logits, list) else logits[0]


def whole_logits(logits) -> torch.Tensor:
    """Vocab-sliced logits (a list, one a model slot) all-gathered on the
    first slot; a tensor as it is."""
    if not isinstance(logits, list):
        return logits
    return C.all_gather(logits, -1, [logits[0].device])[0]


def unembed(cfg: ArchConfig, params: dict, x: torch.Tensor):
    """``x [B, S, D]`` -> logits ``[B, S, V]`` (under tensor parallelism a
    list of vocab slices, one a model slot)."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _row0(_unembed_unit(cfg, {"final_norm": params["final_norm"],
                                     "head": head}, x[None]))


def _rows(batch: dict, R: int) -> dict:
    return {k: v.expand(R, *v.shape) for k, v in batch.items()}


def _single_or_rows(rates):
    """``[L]`` -> ``([1, L], True)``; ``[R, L]`` -> ``(rates, False)``."""
    if rates is None:
        return None, True
    return (rates[None], True) if rates.ndim == 1 else (rates, False)


def _fault_rows(fault):
    """``(rates, single, R)`` of a ``(w_rates, a_rates, seed)`` triple (or
    None): ``rates(i)`` is unit ``i``'s ``(wr [R], ar [R], seed)`` or None;
    rates ``[L]`` are one row (``single``), ``[R, L]`` are R rows."""
    if fault is None:
        return (lambda i: None), True, 1
    wr, single = _single_or_rows(fault[0])
    ar, _ = _single_or_rows(fault[1])
    return (lambda i: _unit_rates(wr, ar, fault[2], i)), single, wr.shape[0]


def _encode(cfg: ArchConfig, params: dict, mem: torch.Tensor, rates,
            seq_axis: str | None = None) -> torch.Tensor:
    """The encoder stack on ``mem [R, B, Se, D]`` (unit ``i`` at
    ``rates(i)``) and its final norm: the memory."""
    enc_pos = _arange(mem.shape[2], mem)
    for i, p in enumerate(_unstack(params["enc_groups"])[:cfg.n_enc_layers]):
        mem = _enc_block_fwd(cfg, p, mem, enc_pos, fault_rates=rates(i),
                             seq_axis=seq_axis)
    return L.norm_fwd(L.whole_tree(params["enc_norm"]), mem, cfg.norm_kind)


def _unstack(tree: dict) -> list[dict]:
    """A tree whose leaves are stacked on a leading axis -> one tree a
    slot, every leaf cut once with ``unbind``: its backward stacks the
    slots' gradients in one pass, where a ``t[g]`` a slot would add a
    zero-filled copy of the whole stack each."""
    leaves, spec = tree_flatten(tree)
    cols = [leaf.unbind(0) for leaf in leaves]
    n = len(cols[0]) if cols else 0
    return [tree_unflatten(spec, [c[g] for c in cols]) for g in range(n)]


def _maybe_remat(body, remat: bool, tp: bool = False):
    """``body`` as is, or recomputed in the backward pass from its inputs
    (``remat``: the reference's ``jax.checkpoint`` of a scanned group);
    the values are the same either way.  Tensor-parallel params (``tp``)
    recompute in one autograd node (:class:`_Remat`): a group's saved
    tensors then lie on several cards, and the autograd engine's per-card
    threads could start the non-reentrant checkpoint's recomputation of one
    group twice at once (it takes no lock), interleaving the tensors it
    records."""
    if not remat:
        return body
    if tp:
        return lambda *args: _Remat.run(body, args)
    return lambda *args: torch.utils.checkpoint.checkpoint(
        body, *args, use_reentrant=False)


def _gather_tensors(obj, out: list):
    """Append every tensor of ``obj`` (tensors, ``layers.Sharded``, dicts,
    lists, tuples; anything else kept) to ``out``; returns the function
    rebuilding ``obj`` from such a list."""
    if isinstance(obj, torch.Tensor):
        i = len(out)
        out.append(obj)
        return lambda ts: ts[i]
    if isinstance(obj, L.Sharded):
        sub = [[_gather_tensors(t, out) for t in ps] for ps in obj.parts]
        return lambda ts: L.Sharded(tuple(tuple(f(ts) for f in ps)
                                          for ps in sub), obj.devices,
                                    obj.data_dim, obj.model_dim)
    if isinstance(obj, dict):
        sub = {k: _gather_tensors(v, out) for k, v in obj.items()}
        return lambda ts: {k: f(ts) for k, f in sub.items()}
    if isinstance(obj, (list, tuple)):
        sub = [_gather_tensors(v, out) for v in obj]
        return lambda ts: type(obj)(f(ts) for f in sub)
    return lambda ts: obj


class _Remat(torch.autograd.Function):
    """``body(*args)`` run without a graph, recomputed in the backward
    (with a graph) and differentiated there with respect to every tensor of
    ``args`` that requires grad: one node, one thread, whatever devices
    the tensors lie on."""

    @staticmethod
    def run(body, args):
        ts = []
        rebuild = _gather_tensors(args, ts)
        return _Remat.apply(body, rebuild, *ts)

    @staticmethod
    def forward(ctx, body, rebuild, *ts):
        ctx.body, ctx.rebuild = body, rebuild
        ctx.save_for_backward(*ts)
        return body(*rebuild(ts))

    @staticmethod
    def backward(ctx, grad):
        ts = [t.detach().requires_grad_(t.requires_grad)
              for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.body(*ctx.rebuild(ts))
        need = [i for i, t in enumerate(ts) if t.requires_grad]
        grads = torch.autograd.grad(out, [ts[i] for i in need], grad,
                                    allow_unused=True)
        full = [None] * len(ts)
        for i, g in zip(need, grads):
            full[i] = g
        return (None, None, *full)


def forward(params: dict, cfg: ArchConfig, batch: dict, *, fault=None,
            kv_chunk: int = 1024, ssd_chunk: int = 256,
            remat: bool = False, seq_axis: str | None = None):
    """Full-sequence logits, the groups as a loop.

    batch: ``{"tokens": [B, S]}`` or ``{"embeds": [B, S, D]}``, and for
    the encoder-decoder ``{"enc_embeds": [B, Se, D]}`` too.
    fault: optional ``(w_rates, a_rates, seed)``, rates indexed by layer
    (encoder layers first); rates ``[L]`` give ``[B, S, V]``, rates
    ``[R, L]`` run R candidates and give ``[R, B, S, V]``.
    remat: recompute each group (each decoder layer of the
    encoder-decoder) in the backward pass instead of keeping its
    activations, as the reference's ``jax.checkpoint`` of its scan body.
    seq_axis: the reference's sequence-parallel attention hint; it splits
    each attention's queries over the model slots of tensor-parallel
    params (``layers.Sharded`` leaves) and changes no value.  Tensor-
    parallel params give a list of vocab slices (see the module
    docstring).
    """
    rates, single, R = _fault_rows(fault)
    rows = _rows(batch, R)
    x = _embed_batch(cfg, params["embed"], rows)
    positions = _arange(x.shape[2], x)
    tp = isinstance(L.first_leaf(params["groups"]), L.Sharded)
    if cfg.is_encdec:
        ne = cfg.n_enc_layers
        mem = _encode(cfg, params, rows["enc_embeds"], rates, seq_axis)
        enc_pos = _arange(mem.shape[2], mem)
        for g, p in enumerate(_unstack(params["groups"])[:cfg.n_layers]):
            body = _maybe_remat(
                lambda x, mem, p, g=g: _dec_block_fwd(
                    cfg, p, x, positions, mem, enc_pos,
                    fault_rates=rates(ne + g), kv_chunk=kv_chunk,
                    seq_axis=seq_axis), remat, tp)
            x = body(x, mem, p)
    else:
        P = len(cfg.block_pattern)
        slots = [_unstack(params["groups"][f"b{s}"]) for s in range(P)]

        def group(x, ps, g):
            for s, kind in enumerate(cfg.block_pattern):
                lidx = g * P + s
                if lidx < cfg.n_layers:
                    x = _block_fwd(cfg, kind, ps[s], x, positions,
                                   fault_rates=rates(lidx), kv_chunk=kv_chunk,
                                   ssd_chunk=ssd_chunk, seq_axis=seq_axis)
            return x

        for g in range(cfg.n_groups):
            body = _maybe_remat(lambda x, ps, g=g: group(x, ps, g), remat,
                                tp)
            x = body(x, [slot[g] for slot in slots])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = _unembed_unit(cfg, {"final_norm": params["final_norm"],
                                 "head": head}, x)
    return _row0(logits) if single else logits


# ==========================================================================
# Per-unit step API (staged prefix-reuse evaluation)
# ==========================================================================
def _unit_rates(w_rates, a_rates, seed, i: int):
    """Unit ``i``'s ``(wr [R], ar [R], seed + 7919 i)`` of ``[R, L]`` rate
    rows (either may be None), the derivation ``forward`` and ``segment``
    share, so both corrupt identically."""
    if w_rates is None and a_rates is None:
        return None, None, None
    return (None if w_rates is None else w_rates[:, i],
            None if a_rates is None else a_rates[:, i],
            seed + 7919 * i)


class LMStepModel:
    """Addressable per-unit view of the LM stack, the counterpart of the
    reference's ``LMStepModel`` (``transformer.py:420-717``).

    Unit *i* is layer *i* (``block_pattern`` cyclic; for the
    encoder-decoder the encoder layers first, then the decoder's), in the
    order of the fault-rate vectors and ``models.graph.lm_layer_infos``.
    Unit 0 also owns the never-corrupted embedding, the final unit the
    final norm and the head; in the encoder-decoder the last encoder unit
    owns the encoder's norm and the first decoder unit the embedding.
    ``step(i, p, x, wr, ar, seed)`` takes ``x`` with its row axis: at unit
    0 the batch dict (``{"tokens": [R, B, S]}``, plus ``{"enc_embeds":
    [R, B, Se, D]}``), then ``[R, B, S, D]``; the final unit returns
    logits ``[R, B, S, V]``.  ``segment`` composes a run of units and
    ``apply`` is the whole model, so staged and whole-forward evaluation
    run the same code.

    The encoder-decoder's carries are lean, as in the reference: the
    encoder units carry the encoder's hidden state, the last one returns
    the memory, the decoder units carry ``{"x", "mem"}``.  The decoder's
    input is never carried: the model is built with ``batch=`` (the fixed
    calibration batch of a search), which the first decoder unit reads,
    and the staged engine stores the memory once per encoder prefix
    (``shared_carry_fields={"mem": n_enc_layers - 1}``).

    ``bits``/``faulty_bits`` pin the fixed-point fault width (e.g. from
    ``FaultSpec``); None takes the ``layers`` module defaults.
    """

    def __init__(self, cfg: ArchConfig, bits: int | None = None,
                 faulty_bits: int | None = None, batch: dict | None = None,
                 fault_model: str | None = None,
                 mbu_width: int | None = None):
        self.cfg = cfg
        self.fault_bits = None if bits is None and faulty_bits is None \
            else (bits, faulty_bits)
        self.fault_model = None \
            if fault_model is None and mbu_width is None \
            else (fault_model, mbu_width)
        self.n_units = cfg.n_enc_layers + cfg.n_layers if cfg.is_encdec \
            else cfg.n_layers
        if cfg.is_encdec and batch is None:
            raise ValueError(
                "the encoder-decoder's LMStepModel needs the calibration "
                "batch bound at construction, LMStepModel(cfg, batch=batch): "
                "the first decoder unit reads its decoder input, which the "
                "encoder's carries do not hold")
        self._batch = batch

    # -- structure ----------------------------------------------------------
    def unit_kind(self, i: int) -> str:
        cfg = self.cfg
        if cfg.is_encdec:
            return "enc" if i < cfg.n_enc_layers else "dec"
        return cfg.block_pattern[i % len(cfg.block_pattern)]

    def unit_params(self, params: dict) -> list[dict]:
        """Slice the stacked tree into per-unit trees: the block under
        ``"block"`` (what fault injection corrupts), boundary params under
        ``embed`` / ``enc_norm`` / ``final_norm`` + ``head`` (never
        corrupted)."""
        cfg = self.cfg
        if cfg.is_encdec:
            ne = cfg.n_enc_layers
            blocks = [tree_map(lambda t, i=i: t[i], params["enc_groups"])
                      for i in range(ne)]
            blocks += [tree_map(lambda t, j=j: t[j], params["groups"])
                       for j in range(cfg.n_layers)]
            first, last_enc = ne, ne - 1
        else:
            P = len(cfg.block_pattern)
            blocks = [tree_map(lambda t, g=i // P: t[g],
                               params["groups"][f"b{i % P}"])
                      for i in range(self.n_units)]
            first, last_enc = 0, None
        units = []
        for i, block in enumerate(blocks):
            u = {"block": block}
            if i == first:
                u["embed"] = params["embed"]
            if i == last_enc:
                u["enc_norm"] = params["enc_norm"]
            if i == self.n_units - 1:
                u["final_norm"] = params["final_norm"]
                u["head"] = params["embed"] if cfg.tie_embeddings \
                    else params["lm_head"]
            units.append(u)
        return units

    def quant_unit_params(self, params: dict) -> list[dict]:
        """Per-unit params with every ``block`` float leaf quantized into
        residence (``layers.QTensor``) for the kernel backend.  The
        attention projections and the 2-D ``mlp``/``dense_mlp`` matrices
        (the ``fault_dense`` sites) are matmul-marked, so their flips
        happen inside ``fault_matmul``; every other leaf (norm gains and
        biases, the MoE experts and router, the RG-LRU and SSD weights)
        corrupts at the leaf through ``bitflip``, the reference's rule
        (``transformer.py:547-556``).  Boundary leaves stay floats."""
        bits = L.FAULT_BITS if self.fault_bits is None \
            or self.fault_bits[0] is None else self.fault_bits[0]

        def matmul_pred(path, leaf):
            if leaf.ndim != 2 or len(path) < 2:
                return False
            parent, key = path[-2], path[-1]
            if parent in ("attn", "xattn"):
                return key in ("wq", "wk", "wv", "wo")
            if parent in ("mlp", "dense_mlp"):
                return key in ("w1", "w2", "w3")
            return False

        return [{k: (L.quantize_params(v, bits, matmul_pred=matmul_pred)
                     if k == "block" else v) for k, v in u.items()}
                for u in self.unit_params(params)]

    def build_weight_fault_tables(self, units: list[dict],
                                  w_rates_by_device, base_seed: int = 0):
        """Every unit's ``block`` corrupted once per device (the tables
        backend): leaves stacked ``[D, ...]``, row d the block as corrupted
        at ``w_rates_by_device[d]``, by the corruption :meth:`step` applies
        inline (unit seed ``base_seed + 7919 i``), so tables == generic
        bitwise.  Boundary leaves are replicated as views."""
        bits, lsbs = self.fault_bits if self.fault_bits is not None \
            else (None, None)
        fm, mw = self.fault_model if self.fault_model is not None \
            else (None, None)
        tables = []
        for i, u in enumerate(units):
            leaf = tree_leaves(u["block"])[0]       # any leaf: its device
            rates = torch.as_tensor(np.asarray(w_rates_by_device, np.float32),
                                    device=leaf.device)
            D = rates.shape[0]
            t = {k: tree_map(lambda w: w.expand(D, *w.shape), v)
                 for k, v in u.items() if k != "block"}
            t["block"] = L.corrupt_params(_row_expand(u["block"], rates),
                                          rates, base_seed + 7919 * i,
                                          bits=bits, faulty_bits=lsbs,
                                          fault_model=fm, mbu_width=mw)
            tables.append(t)
        return tables

    # -- per-unit forward ---------------------------------------------------
    def step(self, i: int, p: dict, x, wr=None, ar=None, seed=0):
        """Unit *i*'s fault injection + compute + boundary glue, on rows."""
        cfg = self.cfg
        fr = None if (wr is None and ar is None) else (wr, ar, seed)
        if cfg.is_encdec:
            return self._step_encdec(i, p, x, fr)
        if i == 0:
            x = _embed_batch(cfg, p["embed"], x)
        positions = _arange(x.shape[2], x)
        x = _block_fwd(cfg, self.unit_kind(i), p["block"], x, positions,
                       fault_rates=fr, fault_bits=self.fault_bits,
                       fault_model=self.fault_model)
        if i == self.n_units - 1:
            x = _unembed_unit(cfg, p, x)
        return x

    @staticmethod
    def _dec_input(batch: dict) -> dict:
        """The decoder-side entries of an encoder-decoder batch:
        ``{"tokens"}`` or the stub frontend's ``{"embeds"}``."""
        return {k: batch[k] for k in ("tokens", "embeds") if k in batch}

    def _check_dec_input(self, x: dict):
        """The decoder reads the batch bound at construction, so a unit-0
        input whose decoder entries differ from it would mix two batches:
        refuse it.  A row-expanded view of the bound tensor (the
        evaluator's path) is accepted without reading the card; anything
        else is compared by value."""
        for k in ("tokens", "embeds"):
            a, b = x.get(k), self._batch.get(k)
            if a is b:
                continue
            if a is not None and b is not None:
                b = torch.as_tensor(b, device=a.device)
                if (a.dtype == b.dtype and a.ndim == b.ndim + 1
                        and a.shape[1:] == b.shape
                        and (a.stride(0) == 0 and a.stride()[1:] == b.stride()
                             and a.data_ptr() == b.data_ptr()
                             or bool(torch.equal(a, b.expand_as(a))))):
                    continue
            raise ValueError(
                f"the encoder-decoder's step/apply received a decoder input "
                f"{k!r} that differs from the batch bound at construction; "
                f"the decoder reads the bound batch, so this call would mix "
                f"two batches: build the LMStepModel with batch=<this batch>")

    def _step_encdec(self, i: int, p: dict, x, fr):
        """The lean carries: the encoder's hidden state ``[R, B, Se, D]``
        through the encoder units (unit 0 takes the batch dict, the last
        returns the memory), ``{"x", "mem"}`` through the decoder units.
        The first decoder unit embeds the bound batch's decoder input."""
        cfg = self.cfg
        ne = cfg.n_enc_layers
        kw = dict(fault_rates=fr, fault_bits=self.fault_bits,
                  fault_model=self.fault_model)
        if i < ne:
            if i == 0:
                self._check_dec_input(x)
                x = x["enc_embeds"]
            x = _enc_block_fwd(cfg, p["block"], x, _arange(x.shape[2], x),
                               **kw)
            if i == ne - 1:
                return L.norm_fwd(p["enc_norm"], x, cfg.norm_kind)
            return x
        if i == ne:
            dec = {k: torch.as_tensor(v, device=x.device) for k, v in
                   self._dec_input(self._batch).items()}
            x = {"x": _embed_batch(cfg, p["embed"], _rows(dec, x.shape[0])),
                 "mem": x}
        h, mem = x["x"], x["mem"]
        h = _dec_block_fwd(cfg, p["block"], h, _arange(h.shape[2], h), mem,
                           _arange(mem.shape[2], mem), **kw)
        if i == self.n_units - 1:
            return _unembed_unit(cfg, p, h)
        return {"x": h, "mem": mem}

    def segment(self, start: int, params: list[dict], x, w_rates=None,
                a_rates=None, seed=0):
        """Compose units ``start..start+len(params)-1``: rates ``[R, len]``
        (local columns), seeds from the ABSOLUTE unit index."""
        for k in range(len(params)):
            x = self.step(start + k, params[k], x,
                          *_unit_rates(w_rates, a_rates,
                                       seed + 7919 * start, k))
        return x

    def apply(self, params: list[dict], batch: dict, w_rates=None,
              a_rates=None, seed=0):
        """Logits for ``batch`` (no row axis).  Rates ``[L]`` (or None)
        give ``[B, S, V]``; rates ``[R, L]`` run R candidates and give
        ``[R, B, S, V]``."""
        wr, single = _single_or_rows(w_rates)
        ar, single_a = _single_or_rows(a_rates)
        single = single and single_a
        rates = wr if wr is not None else ar
        R = 1 if rates is None else rates.shape[0]
        out = self.segment(0, params, _rows(batch, R), wr, ar, seed)
        return out[0] if single else out


# ==========================================================================
# KV cache: allocation, prefill, decode
# ==========================================================================
def _cache_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    """Slots of an attention cache: ``max_len``, or the window's ring."""
    window = _window(cfg, kind)
    return max_len if window is None else min(window, max_len)


def cache_layout(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """``{b{s}: {name: (shape, dtype, fill)}}`` of :func:`init_cache`'s
    tree."""
    dtype, G = cfg.torch_dtype, cfg.n_groups
    out = {}
    for s, kind in enumerate(cfg.block_pattern):
        if kind in _ATTN_KINDS:
            Sc = _cache_len(cfg, kind, max_len)
            kv = (G, batch, Sc, cfg.n_kv_heads, cfg.head_dim_)
            out[f"b{s}"] = {"k": (kv, dtype, 0), "v": (kv, dtype, 0),
                            "pos": ((G, batch, Sc), torch.int32, -1)}
        elif kind == "rglru":
            W = cfg.lru_width or cfg.d_model
            out[f"b{s}"] = {
                "conv": ((G, batch, cfg.conv_kernel - 1, W), dtype, 0),
                "h": ((G, batch, W), torch.float32, 0)}
        elif kind == "ssd":
            d_in = cfg.ssm_expand * cfg.d_model
            nh = d_in // cfg.ssm_head_dim
            out[f"b{s}"] = {
                "conv": ((G, batch, cfg.conv_kernel - 1,
                          d_in + 2 * cfg.ssm_state), dtype, 0),
                "h": ((G, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                      torch.float32, 0)}
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """An empty cache on ``device``: zeros, and ``pos`` -1."""
    dev = resolve_device(device)
    return {slot: {name: torch.full(shape, fill, dtype=dt, device=dev)
                   for name, (shape, dt, fill) in entry.items()}
            for slot, entry in cache_layout(cfg, batch, max_len).items()}


def _ring_pack(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
               cache_len: int) -> dict:
    """Prefill's K/V (``[B, S, Hkv, Dh]``) into a cache of ``cache_len``
    slots at slot = pos % cache_len: the trailing window of a local
    layer, the identity layout where ``cache_len >= S``."""
    B, S = k.shape[:2]
    keep = min(S, cache_len)
    src = positions[S - keep:]
    slots = (src % cache_len).long()
    kc = k.new_zeros((B, cache_len, *k.shape[2:]))
    vc = v.new_zeros((B, cache_len, *v.shape[2:]))
    kc[:, slots] = k[:, S - keep:]
    vc[:, slots] = v[:, S - keep:]
    pc = torch.full((cache_len,), -1, dtype=torch.int32, device=k.device)
    pc[slots] = src
    return {"k": kc, "v": vc, "pos": pc.expand(B, cache_len).contiguous()}


def _stack_groups(entries: list[dict]) -> dict:
    return tree_map(lambda *ls: torch.stack(ls), *entries)


@fp32_exact()
def prefill(params: dict, cfg: ArchConfig, batch: dict, max_len: int, *,
            kv_chunk: int = 1024, ssd_chunk: int = 256, fault=None,
            seq_axis: str | None = None):
    """Full-sequence prefill: ``(logits [B, S, V], cache)``.

    ``max_len`` is the capacity of the global attention caches (the
    prompt and the tokens to come); local and SWA layers keep their
    window.  ``fault``: optional ``(w_rates [L], a_rates [L], seed)``; the
    encoder-decoder corrupts only its encoder here, as the reference
    does.  A slot past ``n_layers`` runs on the last layer's output at its
    rates and its cache is kept, as in the reference; the hidden state
    skips it.  ``seq_axis`` as :func:`forward`'s."""
    rates, single, _ = _fault_rows(fault)
    if not single:
        raise ValueError("prefill takes one row of rates, [L]")
    rows = _rows(batch, 1)
    x = _embed_batch(cfg, params["embed"], rows)
    S = x.shape[2]
    positions = _arange(S, x)

    def first_row(tree):
        return tree_map(lambda t: t[0], tree)

    entries = []
    if cfg.is_encdec:
        mem = _encode(cfg, params, rows["enc_embeds"], rates, seq_axis)
        mem_pos = _arange(mem.shape[2], mem)
        for g in range(cfg.n_layers):
            p = tree_map(lambda t: t[g], params["groups"])
            x, kv = _dec_block_fwd(cfg, p, x, positions, mem, mem_pos,
                                   build_cache=True, kv_chunk=kv_chunk,
                                   seq_axis=seq_axis)
            kv = first_row(kv)
            entries.append({"b0": _ring_pack(kv["k"], kv["v"], positions,
                                             max_len)})
    else:
        P = len(cfg.block_pattern)
        for g in range(cfg.n_groups):
            entry = {}
            for s, kind in enumerate(cfg.block_pattern):
                lidx = g * P + s
                p = tree_map(lambda t: t[g], params["groups"][f"b{s}"])
                x_new, c = _block_fwd(
                    cfg, kind, p, x, positions,
                    fault_rates=rates(min(lidx, cfg.n_layers - 1)),
                    build_cache=True, kv_chunk=kv_chunk, ssd_chunk=ssd_chunk,
                    seq_axis=seq_axis)
                c = first_row(c)
                if kind in _ATTN_KINDS:
                    c = _ring_pack(c["k"], c["v"], positions,
                                   _cache_len(cfg, kind, max_len))
                if lidx < cfg.n_layers:
                    x = x_new
                entry[f"b{s}"] = c
            entries.append(entry)
    return whole_logits(unembed(cfg, params, x[0])), _stack_groups(entries)


@fp32_exact()
def encode(cfg: ArchConfig, params: dict, enc_embeds: torch.Tensor,
           fault=None) -> torch.Tensor:
    """The encoder-decoder's memory ``[B, Se, D]`` of ``enc_embeds``
    (float32, never cast); ``fault`` as :func:`prefill`'s."""
    rates, single, _ = _fault_rows(fault)
    if not single:
        raise ValueError("encode takes one row of rates, [L]")
    return _encode(cfg, params, enc_embeds[None], rates)[0]


def _layer_fault(fault, lidx: int):
    """Layer ``lidx``'s ``(wr, ar, seed)`` of a decode step's ``(w_rates
    [L], a_rates [L], seed)``: 0-d views of the rates (no copy, no wait),
    the seed a host int."""
    if fault is None:
        return None
    w_rates, a_rates, seed = fault
    return w_rates[lidx], a_rates[lidx], seed + 7919 * lidx


def _group_entry(cache, key: str, g: int):
    """Group ``g`` of the cache's ``key`` entry (views): a dict, or for a
    sequence-sharded cache (a list of shards) a list of one a shard."""
    if isinstance(cache, list):
        return [tree_map(lambda t: t[g], shard[key]) for shard in cache]
    return tree_map(lambda t: t[g], cache[key])


@fp32_exact()
def decode_step(params: dict, cfg: ArchConfig, cache,
                tokens: torch.Tensor, pos: torch.Tensor, *,
                enc_memory: torch.Tensor | None = None, fault=None):
    """One decode step: ``tokens [B]`` at absolute positions ``pos [B]``
    (integer tensors on the params' device) -> ``(logits [B, V], cache)``,
    the cache updated in place.  ``cache`` is :func:`init_cache`'s tree, or
    a list of sequence shards (see the module docstring): the block runs on
    the params' device, each shard's attention on the shard's, and a
    recurrent state is read from shard 0 and written to every shard.
    ``fault``: optional ``(w_rates [L], a_rates [L], seed)``, the rates
    float32 tensors on the device and the seed a host int; a layer is
    corrupted once, before its attention splits over the shards.  Nothing
    in a step waits on the card.  The encoder-decoder takes its memory as
    ``enc_memory [B, Se, D]`` and injects no faults, as in the
    reference."""
    x = embed_tokens(cfg, params, tokens[:, None])            # [B, 1, D]
    if cfg.is_encdec:
        return _decode_step_encdec(params, cfg, cache, x, pos, enc_memory)
    P = len(cfg.block_pattern)
    for g in range(cfg.n_groups):
        for s, kind in enumerate(cfg.block_pattern):
            lidx = g * P + s
            if lidx >= cfg.n_layers:    # the reference's where keeps both
                continue
            p = tree_map(lambda t: t[g], params["groups"][f"b{s}"])
            c = _group_entry(cache, f"b{s}", g)
            x = _decode_block(cfg, kind, p, c, x, pos,
                              _layer_fault(fault, lidx))
    return whole_logits(unembed(cfg, params, x))[:, 0], cache


def _decode_attention(cfg: ArchConfig, p: dict, c: dict, h: torch.Tensor,
                      pos: torch.Tensor, window: int | None = None,
                      softcap: float = 0.0) -> torch.Tensor:
    """Self-attention of the token ``h [B, 1, D]``: its q, k and v by plain
    products (``ref.matmul``: XLA's order on the CPU), its K, V and
    position written into slot ``pos % Sc`` of ``c`` in place, attention
    against the cache, the output projection.  A list ``c`` is one entry a
    sequence shard: global slot ``pos % (n Sc_loc)`` is written in its
    owner shard only, and the shards' partials are combined."""
    B, Dh = h.shape[0], cfg.head_dim_
    q = L.project(h, p["wq"]).reshape(B, 1, cfg.n_heads, Dh)
    k = L.project(h, p["wk"]).reshape(B, 1, cfg.n_kv_heads, Dh)
    v = L.project(h, p["wv"]).reshape(B, 1, cfg.n_kv_heads, Dh)
    q = L.rope(q, pos[:, None], cfg.rope_theta)[:, 0]       # [B, Hq, Dh]
    k = L.rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    if isinstance(c, list):
        o = _sharded_attention(c, q, k, v[:, 0], pos, window, softcap)
        return L.row_product(o.reshape(B, 1, -1).to(h.dtype), p["wo"])
    slot = (pos % c["k"].shape[1]).long()
    bidx = torch.arange(B, device=pos.device)
    c["k"][bidx, slot] = k.to(c["k"].dtype)
    c["v"][bidx, slot] = v[:, 0].to(c["v"].dtype)
    c["pos"][bidx, slot] = pos.to(c["pos"].dtype)
    num, m, den = L.decode_attention(q, c["k"], c["v"], c["pos"], pos,
                                     window=window, softcap=softcap)
    o = L.lse_combine(num, m, den)                            # [B, Hq, Dh]
    return L.row_product(o.reshape(B, 1, -1).to(h.dtype), p["wo"])


def _sharded_attention(shards: list, q, k, v, pos, window, softcap):
    """One token's attention against a sequence-sharded cache entry: the
    new K/V and position written into their owner shard (``slot_g = pos %
    Sc_total``, ``owner = slot_g // Sc_loc``; the other shards' slots are
    rewritten unchanged, so no index depends on the data and nothing
    waits), each shard's partials on its own device, the combine on
    ``q``'s."""
    n, sc_loc = len(shards), shards[0]["k"].shape[1]
    slot_g = pos % (sc_loc * n)
    owner, slot_l = slot_g // sc_loc, (slot_g % sc_loc).long()
    parts = []
    for i, c in enumerate(shards):
        dev = c["k"].device
        bidx = torch.arange(q.shape[0], device=dev)
        sl, mine, pos_i = slot_l.to(dev), (owner == i).to(dev), pos.to(dev)
        for name, new in (("k", k), ("v", v), ("pos", pos)):
            t = c[name]
            m = mine.reshape(-1, *[1] * (new.dim() - 1))
            t[bidx, sl] = torch.where(m, new.to(dev, t.dtype), t[bidx, sl])
        parts.append(L.decode_attention(q.to(dev), c["k"], c["v"], c["pos"],
                                        pos_i, window=window,
                                        softcap=softcap))
    num, m, den = ([t.to(q.device) for t in ts] for ts in zip(*parts))
    return L.lse_combine(num, m, den)


def _decode_block(cfg: ArchConfig, kind: str, p: dict, c,
                  x: torch.Tensor, pos: torch.Tensor, fault_rates=None
                  ) -> torch.Tensor:
    """One block of ``x [B, 1, D]`` against its cache entry ``c`` (views
    into the cache, written in place).  Faults as the reference's decode:
    every float leaf at the layer's 0-d weight rate (leaf ``j`` at ``seed
    + 977 j``) and the input at its activation rate (``seed + 1``), each
    corrupted as one whole tensor, all of them in one grouped
    ``quant_bitflip`` call.  There is no row axis here, so not through
    ``_inject``."""
    if fault_rates is not None:
        p, x = corrupt_block(p, x, fault_rates)
    p = L.tp_block(p)
    if kind in _ATTN_KINDS:
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        x = x + _decode_attention(cfg, p["attn"], c, h, pos,
                                  window=_window(cfg, kind),
                                  softcap=cfg.logit_softcap or 0.0)
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        if not cfg.is_moe:
            return x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
        # decode batches are small: dropless routing (cf 0 -> C = T)
        f = L.moe_fwd(p["moe"], h, top_k=cfg.top_k, act=cfg.act_fn,
                      capacity_factor=0.0)
        if cfg.moe_dense_residual:
            f = f + L.mlp_fwd(p["dense_mlp"], h, cfg.act_fn)
        return x + f
    shards = c if isinstance(c, list) else [c]
    c = {name: t.to(x.device) for name, t in shards[0].items()}
    h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
    if kind == "rglru":
        r, st = L.rglru_fwd(p["rec"], h, state=c)
        x = x + r
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        x = x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
    elif kind == "ssd":
        s, st = L.ssd_fwd(p["ssd"], h, expand=cfg.ssm_expand,
                          head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                          cache=c)
        x = x + s
    else:
        raise ValueError(kind)
    for shard in shards:
        for name, t in st.items():
            shard[name].copy_(t)
    return x


def corrupt_block(p: dict, x: torch.Tensor, fault_rates):
    """A decode block's fault injection: its leaves at the 0-d weight rate
    (leaf ``j`` at ``seed + 977 j``) and ``x`` at the activation rate
    (``seed + 1``), in one grouped ``quant_bitflip`` call.  A
    ``layers.Sharded`` leaf is made whole on its row's first slot first and
    split again after (``layers.split_like``), so its corrupted pieces are
    bitwise the corrupted whole leaf's slices."""
    wr, ar, seed = fault_rates
    leaves, treedef = tree_flatten(p)
    n = len(leaves)
    whole = [t.whole() if isinstance(t, L.Sharded) else t for t in leaves]
    out = L.corrupt_leaves(whole + [x], [wr] * n + [ar],
                           [seed + 977 * j for j in range(n)] + [seed + 1])
    out[:n] = [L.split_like(o, t) if isinstance(t, L.Sharded) else o
               for o, t in zip(out[:n], leaves)]
    return tree_unflatten(treedef, out[:n]), out[n]


def _decode_step_encdec(params: dict, cfg: ArchConfig, cache: dict,
                        x: torch.Tensor, pos: torch.Tensor,
                        enc_memory: torch.Tensor):
    """The encoder-decoder's decode step: per decoder layer, the cached
    self-attention, cross-attention to the memory (float32 on bf16
    weights, promoted as JAX does) and the MLP.  No faults."""
    mem = enc_memory[None]
    mem_pos = _arange(mem.shape[2], mem)
    q_pos = torch.zeros(1, dtype=torch.int32, device=x.device)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)
    for g in range(cfg.n_layers):
        p = L.tp_block(tree_map(lambda t: t[g], params["groups"]))
        c = _group_entry(cache, "b0", g)
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        x = x + _decode_attention(cfg, p["attn"], c, h, pos)
        h = L.norm_fwd(p["ln_x"], x, cfg.norm_kind)
        x = x + L.attention_fwd(p["xattn"], h[None], q_pos, memory=mem,
                                memory_pos=mem_pos, **kw)[0]
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        x = x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
    return whole_logits(unembed(cfg, params, x))[:, 0], cache
