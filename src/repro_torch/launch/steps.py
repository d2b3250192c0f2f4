"""Sharded step factories, the counterpart of ``repro/launch/steps.py``.

Each ``abstract_*`` builder returns ``(fn, args)``: ``args`` are ``meta``
stand-ins (shapes and dtypes, no memory) of the step's inputs, the
counterpart of the reference's ``jax.ShapeDtypeStruct``s, and ``fn`` runs
on real tensors over the mesh (``launch/mesh.py``), driven by this one
process, one data row after the other:

  * :func:`abstract_train_step` on a ``(data, model)`` mesh: FSDP x tensor
    parallelism.  Params and AdamW state lie on the slots as
    ``param_specs`` / ``opt_state_specs`` say (``shardings.place_params``);
    each data row takes its batch shard, all-gathers each layer's weights
    over ``"data"`` as it uses them (ZeRO-3) and splits the attention and
    MLP over its ``"model"`` slots (``models/layers.py``); the gradients
    are reduce-scattered over ``"data"`` in fp32, in slot order and chunk
    order, and divided once, and AdamW updates each shard.  ``seq_axis=
    "model"`` splits each attention's queries over the model slots.
  * :func:`abstract_pp_train_step`: the GPipe pipeline over ``"pod"``
    (``launch/pipeline.py``) cut by an AFarePart partition, each stage on
    its ``(data, model)`` sub-mesh, then AdamW;
  * :func:`abstract_serve_prefill`: each batch row's prefill, the cache
    returned laid out by ``cache_pspecs``;
  * :func:`abstract_serve_decode`: one token against that cache, every
    attention cache's sequence axis over ``"model"`` (flash-decode: each
    sequence shard computes its partials, ``layers.lse_combine`` folds
    them).

The serve steps take ``("data", "model")`` or ``("pod", "data", "model")``
meshes with the reference's batch and cache specs (``multi_pod``: the
batch over ``("pod", "data")`` at 32 sequences or more, else the cache's
sequence over ``("pod", "model")``), and either the whole params (every
computing row runs them whole on its first slot) or
``shardings.place_params``'s list (laid out by ``param_specs``, run
tensor-parallel).  Under tensor parallelism the decode's column-parallel
q/k/v are all-gathered over the row's model slots (one token: a few KB),
each sequence shard attends with the whole heads over its slots, the
partials are all-gathered to the row's first slot and folded there, and
``wo`` is row-parallel (an all-reduce).  The reference's ``ns`` (a
``NamedSharding`` tree) has no counterpart: ``fn`` places its inputs
itself.  Multi-host launch has no counterpart: the reference has none.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import fp32_exact
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.registry import input_specs
from repro_torch.core.partitioner import contiguous_stages
from repro_torch.launch import collectives as C
from repro_torch.launch import pipeline as pp
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import (batch_specs, cache_pspecs,
                                          gather_tree, opt_state_specs,
                                          param_specs, shard_tree,
                                          slot_index)
from repro_torch.models.transformer import decode_step, init_lm, prefill
from repro_torch.serve.kvcache import cache_specs
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.train_step import (_value_and_grad, init_train_state,
                                          make_loss_fn)

__all__ = ["abstract_params", "abstract_train_step", "abstract_serve_prefill",
           "abstract_serve_decode", "abstract_pp_train_step"]


def abstract_params(cfg: ArchConfig) -> dict:
    """``init_lm``'s tree as ``meta`` tensors: its Python runs under a fake
    tensor mode, so a config of any size costs no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = init_lm(cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)


def _microbatches_for(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Power-of-two microbatch count (divides the global batch) keeping
    per-microbatch activation footprint bounded."""
    tokens = shape.seq_len * shape.global_batch
    need = max(1, tokens * cfg.d_model // (2 ** 31))
    mb = 1
    while mb < need and mb < 8 and shape.global_batch % (mb * 2) == 0:
        mb *= 2
    return mb


def _default_opt(cfg: ArchConfig, opt_cfg: AdamWConfig | None) -> AdamWConfig:
    # >100B params: bf16 Adam moments, as the reference sizes them
    return opt_cfg or AdamWConfig(
        moments_dtype="bfloat16" if cfg.param_count() > 1e11 else "float32")


def _chunks(shape: ShapeSpec) -> tuple[int, int]:
    """The reference's KV and SSD chunk sizes for a cell."""
    return (max(1024, shape.seq_len // 8),
            min(1024, max(256, shape.seq_len // 8)))


def abstract_train_step(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec,
                        opt_cfg: AdamWConfig | None = None, *,
                        microbatches: int | None = None, remat: bool = True,
                        seq_axis: str | None = None):
    """The ``(data, model)`` train step, FSDP x tensor parallelism (see the
    module docstring): ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with params and state as ``place_params`` /
    ``place_opt_state`` lay them out (one tree a slot), updated as laid
    out; whole trees are placed, stepped and gathered back.  Each data row
    splits its shard into ``microbatches`` chunks.  ``fn.value_and_grad(
    placed, batch)`` is the step's ``(loss, grads)``, the grads float32 and
    laid out as the params, and ``fn.update(placed, grads, opt_state)`` the
    AdamW half (``value_and_grad``'s ``rows=`` computes only those data
    rows: the dry run's per-row probe).  With ``model=1`` the grads are
    bitwise the
    data-parallel ones (``make_train_step(microbatches=data x chunks)``'s
    sums); the update differs only through the global norm, summed shard
    by shard (``train/optimizer.py``)."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"a train step runs on a ('data', 'model') mesh, "
                         f"not {mesh.axis_names}: a 'pod' axis is the "
                         "pipeline's (abstract_pp_train_step)")
    opt_cfg = _default_opt(cfg, opt_cfg)
    params_s = abstract_params(cfg)
    opt_s = init_train_state(cfg, params_s, opt_cfg)
    batch_s = input_specs(cfg, shape)
    bspec = {k: batch_specs(cfg, shape)[k] for k in batch_s}
    pspec = param_specs(params_s, mesh)
    ospec = opt_state_specs(pspec)
    counted = SH.owned(params_s, pspec, mesh)
    mb = microbatches if microbatches is not None \
        else _microbatches_for(cfg, shape)
    kvc, ssdc = _chunks(shape)
    loss_fn = make_loss_fn(cfg, remat=remat, kv_chunk=kvc, ssd_chunk=ssdc,
                           seq_axis=seq_axis)

    @fp32_exact()
    def value_and_grad(placed, batch, rows=None):
        return _fsdp_value_and_grad(loss_fn, placed, pspec, mesh,
                                    shard_tree(batch, bspec, mesh), mb, rows)

    @fp32_exact()
    def update(placed, grads, opt_state):
        state = {k: [t[k] for t in opt_state] for k in ("m", "v")}
        state["step"] = opt_state[0]["step"]
        placed, state, m = adamw_update(opt_cfg, placed, grads, state,
                                        counted)
        return placed, [{"m": a, "v": b, "step": state["step"].to(
            dev, non_blocking=True)} for a, b, dev in zip(
                state["m"], state["v"], mesh.devices.flat)], m

    def step(params, opt_state, batch):
        whole = isinstance(params, dict)
        if whole:
            params = shard_tree(params, pspec, mesh)
            opt_state = shard_tree(opt_state, ospec, mesh)
        loss, grads = value_and_grad(params, batch)
        params, opt_state, m = update(params, grads, opt_state)
        if whole:
            params = gather_tree(params, pspec, mesh)
            opt_state = gather_tree(opt_state, ospec, mesh)
        return params, opt_state, {"loss": loss, **m}

    step.value_and_grad, step.update = value_and_grad, update
    return step, (params_s, opt_s, batch_s)


def _fsdp_value_and_grad(loss_fn, placed, pspec, mesh, shards, mb,
                         rows=None):
    """``(loss, grads)`` of the FSDP x TP step over ``placed`` (one tree a
    slot) and the batch ``shards`` (``shard_tree``'s).  Each data row reads
    fresh leaves (``detach``ed views of every slot's slices) through
    ``shardings.row_params``; its chunks' gradients land on the slices it
    read and are added, row after row and chunk after chunk, into fp32
    accumulators: a reduce-scatter over ``"data"`` for a leaf split over
    it, else an all-reduce (``collectives.ScatterSum``).  A leaf not split
    over ``"model"`` is read from model slot 0 and its gradient copied to
    the row's other slots."""
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    devs = list(mesh.devices.flat)
    leaves, treedef = SH._leaves(placed[0], pspec)
    flat = [tree_flatten(t)[0] for t in placed]
    dims = [(SH._dim_of(sp, "data"), SH._dim_of(sp, "model"))
            for _, _, sp in leaves]
    acc = {}
    for j, (dd, md) in enumerate(dims):
        kind = None if nd == 1 else \
            "reduce_scatter" if dd is not None else "all_reduce"
        for m in (range(nm) if md is not None else [0]):
            tgt = [slot_index(mesh, {"data": d, "model": m})
                   for d in (range(nd) if dd is not None else [0])]
            acc[j, m] = C.ScatterSum([flat[i][j].shape for i in tgt],
                                     [devs[i] for i in tgt], kind)
    n = nd * mb
    home = devs[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=home)
    for d in range(nd) if rows is None else rows:
        proxies = [[t.detach().requires_grad_(True) for t in f] for f in flat]
        row = SH.row_params([tree_unflatten(treedef, p) for p in proxies],
                            pspec, mesh, {"data": d})
        reads = [(j, m, [slot_index(mesh, {"data": e, "model": m})
                         for e in (range(nd) if dd is not None else [d])])
                 for j, (dd, md) in enumerate(dims)
                 for m in (range(nm) if md is not None else [0])]
        wanted = [proxies[i][j] for j, _, slots in reads for i in slots]
        local = shards[slot_index(mesh, {"data": d, "model": 0})]
        b = next(iter(local.values())).shape[0]
        if b % mb:
            raise ValueError(f"a data shard of {b} rows does not split "
                             f"into {mb} microbatches")
        for c in range(mb):
            chunk = {k: v.reshape(mb, b // mb, *v.shape[1:])[c]
                     for k, v in local.items()}
            loss = loss_fn(row, chunk)
            grads = iter(torch.autograd.grad(loss, wanted,
                                             materialize_grads=True))
            for j, m, slots in reads:
                acc[j, m].add([next(grads) for _ in slots])
            loss_sum = loss_sum + loss.detach().to(home)
    out = [[None] * len(dims) for _ in devs]
    for (j, m), ss in acc.items():
        dd, md = dims[j]
        sums = [a.div_(n) if n > 1 else a.to(leaves[j][1].dtype)
                for a in ss.acc]
        for d in range(nd):
            g = sums[d if dd is not None else 0]
            for mm in (range(nm) if md is None else [m]):
                i = slot_index(mesh, {"data": d, "model": mm})
                out[i][j] = g.to(devs[i], non_blocking=True)
    return loss_sum / n, [tree_unflatten(treedef, g) for g in out]


def abstract_pp_train_step(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec,
                           opt_cfg: AdamWConfig | None = None, *,
                           n_micro: int = 4, partition=None):
    """The pipelined train step over ``mesh``'s ``"pod"`` axis, each stage
    on its ``(data, model)`` sub-mesh.  ``partition`` is an AFarePart layer
    -> tier mapping (default: all on tier 0, an equal split);
    ``contiguous_stages`` -> ``group_cuts`` give the stages, ``fn.cuts``
    the group cuts.  ``fn(placed, opt_state, batch) -> (placed, opt_state,
    metrics)`` takes the params as ``pipeline.place_pp_params(
    pipeline.to_pp(params, fn.cuts), mesh)`` and the optimizer state as
    ``init_train_state`` of those; the copies of a shard get the sum of
    their gradients (``pipeline.sync_grads``) and the global norm counts
    each shard once (``fn.counted``).  ``fn.value_and_grad(placed, batch,
    rows=None)`` and ``fn.update(placed, grads, opt_state, counted)`` are
    its two halves (``rows``: those data rows of every stage alone, the
    dry run's probe).  ``args`` are the reference layout's stand-ins."""
    opt_cfg = _default_opt(cfg, opt_cfg)
    n_stages = mesh.shape["pod"]
    if partition is None:
        partition = np.zeros(cfg.n_layers, np.int64)
    cuts_g = pp.group_cuts(contiguous_stages(np.asarray(partition),
                                             n_stages), cfg)
    pp_params_s = pp.to_pp(abstract_params(cfg), cuts_g)
    opt_s = init_train_state(cfg, pp_params_s, opt_cfg)
    batch_s = input_specs(cfg, shape)
    loss_fn = pp.make_pp_loss(cfg, mesh, cuts_g, n_micro)
    counted = pp.pp_counted(mesh, pp_params_s)

    @fp32_exact()
    def value_and_grad(placed, batch, rows=None):
        loss, grads = _value_and_grad(
            lambda p, b: loss_fn(p, b, rows), placed, batch)
        return loss, pp.sync_grads(grads, mesh, pp_params_s)

    @fp32_exact()
    def update(placed, grads, opt_state, counted=counted):
        return adamw_update(opt_cfg, placed, grads, opt_state, counted)

    def step(placed, opt_state, batch):
        loss, grads = value_and_grad(placed, batch)
        placed, opt_state, m = update(placed, grads, opt_state)
        return placed, opt_state, {"loss": loss, **m}

    step.cuts, step.counted = cuts_g, counted
    step.value_and_grad, step.update = value_and_grad, update
    return step, (pp_params_s, opt_s, batch_s)


def _serve_layout(cfg, mesh, shape):
    """``(batch stand-ins, batch specs, cache specs, computing rows)`` of a
    serve step; a row is the coordinates of every axis but ``"model"``:
    all of them when the batch is split, else the first (the others
    hold copies)."""
    axes = tuple(mesh.axis_names)
    if axes not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"a serve step runs on a ('data', 'model') or "
                         f"('pod', 'data', 'model') mesh, not {axes}")
    multi_pod = "pod" in axes
    batch_s = input_specs(cfg, shape)
    bspec = {k: batch_specs(cfg, shape, multi_pod=multi_pod)[k]
             for k in batch_s}
    rows_axes = axes[:-1]
    split = any(bspec[k][0] is not None for k in bspec)
    rows = [dict(zip(rows_axes, map(int, idx))) for idx in np.ndindex(
        *[mesh.shape[a] if split else 1 for a in rows_axes])]
    return batch_s, bspec, cache_pspecs(cfg, shape, multi_pod=multi_pod), \
        rows


def _row_params(params, pspec, mesh, row, dev):
    """A computing row's params: ``row_params`` of a placed list, or the
    whole tree on the row's first slot."""
    if isinstance(params, list):
        return SH.row_params(params, pspec, mesh, row)
    return tree_map(lambda t: t.to(dev), params)


def abstract_serve_prefill(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec, *,
                           seq_axis: str | None = None):
    """Prefill: ``fn(params, batch) -> (last-position logits [B, V],
    cache)``, each computing row prefilling its rows, the cache laid out by
    ``cache_pspecs`` (one tree a mesh slot, ``shard_tree``'s) with
    ``shape.seq_len`` slots.  ``params`` whole or placed (see the module
    docstring); ``seq_axis`` as ``forward``'s.  ``fn(..., rows=[i])``
    computes only computing row ``i`` and returns its ``(logits, cache)``
    unassembled (the dry run's per-row probe)."""
    batch_s, bspec, cspec, rows_all = _serve_layout(cfg, mesh, shape)
    params_s = abstract_params(cfg)
    pspec = param_specs(params_s, mesh)
    kvc, ssdc = _chunks(shape)

    def fn(params, batch, rows=None):
        shards = shard_tree(batch, bspec, mesh)
        lasts, caches, home = [], [], None
        for row in rows_all if rows is None else [rows_all[i] for i in rows]:
            first = slot_index(mesh, dict(row, model=0))
            dev = mesh.devices.flat[first]
            home = dev if home is None else home
            logits, cache = prefill(
                _row_params(params, pspec, mesh, row, dev), cfg,
                shards[first], shape.seq_len, kv_chunk=kvc, ssd_chunk=ssdc,
                seq_axis=seq_axis)
            lasts.append(logits[:, -1].to(home))
            caches.append(cache)
        if rows is not None:
            return lasts, caches
        full = caches[0] if len(caches) == 1 else tree_map(
            lambda *ts: torch.cat([t.to(home) for t in ts], 1), *caches)
        return torch.cat(lasts), shard_tree(full, cspec, mesh)

    fn.n_rows = len(rows_all)
    return fn, (params_s, batch_s)


def _refresh_copies(cache: list, cspec: dict, mesh) -> None:
    """Every slot's cache leaves that copy another slot's shard (its
    coordinate along an axis the leaf is not split over is not 0) set from
    that first copy."""
    for i, _, coords in SH._slots(mesh):
        for key, entry in cspec.items():
            for name, spec in entry.items():
                used = SH.spec_axes(spec)
                src = slot_index(mesh, {a: (c if a in used else 0)
                                        for a, c in coords.items()})
                if src != i:
                    cache[i][key][name].copy_(cache[src][key][name])


def abstract_serve_decode(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec):
    """One-token decode against a ``shape.seq_len`` cache laid out by
    ``cache_pspecs``: ``fn(params, cache, batch, fault=None) -> (logits [B,
    V], cache)``, the cache (one tree a mesh slot) updated in place.  Each
    computing row's step runs on its first model slot (tensor-parallel over
    its model slots for placed params), its attention over that row's
    sequence shards (the slots along the cache's sequence axes), one
    shard each; its recurrent states are put together on its first slot
    for the step and split again after.  ``fault`` is ``decode_step``'s
    (the reference's step takes none): each layer is corrupted once, whole,
    before it splits.  ``fn(..., rows=[i])`` computes only computing row
    ``i`` and returns its logits (the dry run's per-row probe)."""
    batch_s, bspec, cspec, rows_all = _serve_layout(cfg, mesh, shape)
    params_s = abstract_params(cfg)
    pspec = param_specs(params_s, mesh)
    cache_s = cache_specs(cfg, shape.global_batch, shape.seq_len)
    nm = mesh.shape["model"]
    rec = {k: v for k, v in cspec.items() if "k" not in v}   # rglru / ssd
    attn = [v["k"] for v in cspec.values() if "k" in v]
    seq_axes = [a for a in mesh.axis_names
                if attn and a in SH.spec_axes(attn[0][2:3])]

    def fn(params, cache, batch, fault=None, rows=None):
        shards = shard_tree(batch, bspec, mesh)
        out, home = [], None
        for row in rows_all if rows is None else [rows_all[i] for i in rows]:
            first = slot_index(mesh, dict(row, model=0))
            dev = mesh.devices.flat[first]
            home = dev if home is None else home
            cols = [slot_index(mesh, dict(row, model=m)) for m in range(nm)]
            sub = Mesh(np.array([mesh.devices.flat[i] for i in cols],
                                dtype=object).reshape(
                (1,) * (len(mesh.axis_names) - 1) + (nm,)), mesh.axis_names)
            seq_slots = [slot_index(mesh, {**row, "model": 0,
                                           **dict(zip(seq_axes, idx))})
                         for idx in np.ndindex(*[mesh.shape[a]
                                                 for a in seq_axes])]
            states = gather_tree([{k: cache[i][k] for k in rec}
                                  for i in cols], rec, sub) if rec else {}
            seq = [{**{k: v for k, v in cache[i].items() if k not in rec},
                    **states} for i in seq_slots]
            b = shards[first]
            f = None if fault is None else (fault[0].to(dev),
                                            fault[1].to(dev), fault[2])
            logits, _ = decode_step(
                _row_params(params, pspec, mesh, row, dev), cfg,
                seq if len(seq) > 1 else seq[0], b["tokens"],
                b["positions"], enc_memory=b.get("enc_embeds"), fault=f)
            if rec:
                for i, new in zip(cols, shard_tree(states, rec, sub)):
                    for k in rec:
                        for name in rec[k]:
                            cache[i][k][name].copy_(new[k][name])
            out.append(logits.to(home))
        if rows is not None:
            return out
        _refresh_copies(cache, cspec, mesh)
        return torch.cat(out), cache

    fn.n_rows = len(rows_all)
    return fn, (params_s, cache_s, batch_s)
