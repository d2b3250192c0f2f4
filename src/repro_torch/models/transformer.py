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
Prefill/decode and the caches are not ported yet (ROADMAP.md Queue A item
11c).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L

__all__ = ["init_lm", "forward", "embed_tokens", "unembed", "LMStepModel"]

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
def _per_row(fn, p: dict, x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """``fn(p_r, x[r])`` for each row ``r`` of ``x [R, B, S, D]``, with
    ``p_r`` row r of the ``[R, ...]`` leaves (``per_row``) or ``p`` as
    shared: a row's arithmetic then never depends on how many rows share
    the step."""
    out = None
    for r in range(x.shape[0]):
        pr = tree_map(lambda t, r=r: t[r], p) if per_row else p
        y = fn(pr, x[r])
        if out is None:
            out = y.new_empty((x.shape[0], *y.shape))
        out[r] = y
    return out


def _inject(p: dict, x: torch.Tensor, fault_rates, fault_bits,
            fault_model) -> tuple[dict, torch.Tensor]:
    """A block's fault injection: its params corrupted at the unit's
    weight rates (leaf ``j`` at ``seed + 977 j``; dequantized without), its
    input at the activation rates (``seed + 1``)."""
    wr, ar, seed = fault_rates if fault_rates is not None else (None,) * 3
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


def _block_fwd(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, fault_rates=None, fault_bits=None,
               fault_model=None, kv_chunk: int = 1024,
               ssd_chunk: int = 256) -> torch.Tensor:
    """One block of ``kind`` on ``x [R, B, S, D]``.  ``fault_bits`` is an
    optional (bits, faulty_bits) override of the corruption width,
    ``fault_model`` an optional (model, mbu_width) override; None takes the
    ``layers`` module defaults.  The MoE, RG-LRU and SSD sub-blocks run a
    row at a time; whether their leaves carry the row axis (weight faults,
    or a tables gather) is read from one leaf's rank."""
    p, x = _inject(p, x, fault_rates, fault_bits, fault_model)
    if kind in _ATTN_KINDS:
        window = None
        if kind == "local" or (kind == "attn" and cfg.attn_kind == "swa"):
            window = cfg.window
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        x = x + L.attention_fwd(p["attn"], h, positions, n_heads=cfg.n_heads,
                                n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                                rope_theta=cfg.rope_theta, window=window,
                                softcap=cfg.logit_softcap or 0.0,
                                kv_chunk=kv_chunk)
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        if not cfg.is_moe:
            return x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
        f = _per_row(lambda pr, hr: L.moe_fwd(
            pr, hr, top_k=cfg.top_k, act=cfg.act_fn,
            capacity_factor=cfg.moe_capacity_factor),
            p["moe"], h, p["moe"]["router"].ndim == 3)
        if cfg.moe_dense_residual:
            f = f + L.mlp_fwd(p["dense_mlp"], h, cfg.act_fn)
        return x + f
    if kind == "rglru":
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        x = x + _per_row(lambda pr, hr: L.rglru_fwd(pr, hr)[0], p["rec"], h,
                         p["rec"]["lam"].ndim == 2)
        h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
        return x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)
    if kind == "ssd":
        h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
        return x + _per_row(lambda pr, hr: L.ssd_fwd(
            pr, hr, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            state=cfg.ssm_state, chunk=ssd_chunk)[0],
            p["ssd"], h, p["ssd"]["A_log"].ndim == 2)
    raise ValueError(kind)


def _enc_block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, *, fault_rates=None,
                   fault_bits=None, fault_model=None) -> torch.Tensor:
    """One encoder block of ``x [R, B, Se, D]``: bidirectional
    self-attention (attention to the memory ``h`` itself, no rope, not
    causal) and the MLP."""
    p, x = _inject(p, x, fault_rates, fault_bits, fault_model)
    h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
    x = x + L.attention_fwd(p["attn"], h, positions, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                            rope_theta=cfg.rope_theta, memory=h,
                            memory_pos=positions)
    h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
    return x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)


def _dec_block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, memory: torch.Tensor,
                   mem_pos: torch.Tensor, *, fault_rates=None,
                   fault_bits=None, fault_model=None,
                   kv_chunk: int = 1024) -> torch.Tensor:
    """One decoder block of the encoder-decoder on ``x [R, B, S, D]``:
    causal self-attention, cross-attention to ``memory [R, B, Se, D]``,
    the MLP.  Only ``x`` is corrupted at the activation rate."""
    p, x = _inject(p, x, fault_rates, fault_bits, fault_model)
    h = L.norm_fwd(p["ln1"], x, cfg.norm_kind)
    x = x + L.attention_fwd(p["attn"], h, positions, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                            rope_theta=cfg.rope_theta, kv_chunk=kv_chunk)
    h = L.norm_fwd(p["ln_x"], x, cfg.norm_kind)
    x = x + L.attention_fwd(p["xattn"], h, positions, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                            rope_theta=cfg.rope_theta, memory=memory,
                            memory_pos=mem_pos)
    h = L.norm_fwd(p["ln2"], x, cfg.norm_kind)
    return x + L.mlp_fwd(p["mlp"], h, cfg.act_fn)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


# ==========================================================================
# Embedding and head
# ==========================================================================
def _embed(cfg: ArchConfig, embed: torch.Tensor, tokens: torch.Tensor):
    """``tokens [R, B, S]`` through the table ``[V, D]`` (or one table a
    row, ``[R, V, D]``), times sqrt(d) in the table's dtype."""
    if embed.ndim == 3:
        e = torch.stack([embed[r][tokens[r]] for r in range(tokens.shape[0])])
    else:
        e = embed[tokens]
    return e * torch.tensor(np.sqrt(cfg.d_model), dtype=e.dtype)


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
    R), through ``ref.matmul`` (XLA's order on the CPU)."""
    x = L.norm_fwd(p["final_norm"], x, cfg.norm_kind)
    head = p["head"]
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


def unembed(cfg: ArchConfig, params: dict, x: torch.Tensor):
    """``x [B, S, D]`` -> logits ``[B, S, V]``."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _unembed_unit(cfg, {"final_norm": params["final_norm"],
                               "head": head}, x[None])[0]


def _rows(batch: dict, R: int) -> dict:
    return {k: v.expand(R, *v.shape) for k, v in batch.items()}


def _single_or_rows(rates):
    """``[L]`` -> ``([1, L], True)``; ``[R, L]`` -> ``(rates, False)``."""
    if rates is None:
        return None, True
    return (rates[None], True) if rates.ndim == 1 else (rates, False)


def forward(params: dict, cfg: ArchConfig, batch: dict, *, fault=None,
            kv_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence logits, the groups as a loop.

    batch: ``{"tokens": [B, S]}`` or ``{"embeds": [B, S, D]}``, and for
    the encoder-decoder ``{"enc_embeds": [B, Se, D]}`` too.
    fault: optional ``(w_rates, a_rates, seed)``, rates indexed by layer
    (encoder layers first); rates ``[L]`` give ``[B, S, V]``, rates
    ``[R, L]`` run R candidates and give ``[R, B, S, V]``.
    """
    if fault is not None:
        wr, single = _single_or_rows(fault[0])
        ar, _ = _single_or_rows(fault[1])
        fault = (wr, ar, fault[2])
        R = wr.shape[0]
    else:
        single, R = True, 1

    def rates(i):
        return None if fault is None else _unit_rates(*fault, i)

    rows = _rows(batch, R)
    x = _embed_batch(cfg, params["embed"], rows)
    positions = _arange(x.shape[2], x)
    if cfg.is_encdec:
        ne = cfg.n_enc_layers
        mem = rows["enc_embeds"]
        enc_pos = _arange(mem.shape[2], mem)
        for i in range(ne):
            p = tree_map(lambda t: t[i], params["enc_groups"])
            mem = _enc_block_fwd(cfg, p, mem, enc_pos, fault_rates=rates(i))
        mem = L.norm_fwd(params["enc_norm"], mem, cfg.norm_kind)
        for g in range(cfg.n_layers):
            p = tree_map(lambda t: t[g], params["groups"])
            x = _dec_block_fwd(cfg, p, x, positions, mem, enc_pos,
                               fault_rates=rates(ne + g), kv_chunk=kv_chunk)
    else:
        P = len(cfg.block_pattern)
        for g in range(cfg.n_groups):
            for s, kind in enumerate(cfg.block_pattern):
                lidx = g * P + s
                if lidx >= cfg.n_layers:
                    continue
                p = tree_map(lambda t: t[g], params["groups"][f"b{s}"])
                x = _block_fwd(cfg, kind, p, x, positions,
                               fault_rates=rates(lidx), kv_chunk=kv_chunk)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = _unembed_unit(cfg, {"final_norm": params["final_norm"],
                                 "head": head}, x)
    return logits[0] if single else logits


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
