"""Sharded step factories, the counterpart of ``repro/launch/steps.py``.

Each ``abstract_*`` builder returns ``(fn, args)``: ``args`` are ``meta``
stand-ins (shapes and dtypes, no memory) of the step's inputs, the
counterpart of the reference's ``jax.ShapeDtypeStruct``s, and ``fn`` runs
on real tensors over the mesh (``launch/mesh.py``), driven by this one
process:

  * :func:`abstract_train_step`: data-parallel over ``"data"``; the batch
    split by ``batch_specs``, the params whole on every data device, a
    value-and-grad on each, the gradients averaged in device order, one
    AdamW update;
  * :func:`abstract_pp_train_step`: the GPipe pipeline over ``"pod"``
    (``launch/pipeline.py``) cut by an AFarePart partition, then AdamW;
  * :func:`abstract_serve_prefill`: the batch split over ``"data"``, the
    cache returned laid out by ``cache_pspecs``;
  * :func:`abstract_serve_decode`: the batch over ``"data"`` and every
    attention cache's sequence axis over ``"model"`` (flash-decode: each
    model device computes its shard's partials, ``layers.lse_combine``
    folds them).

What the reference also lays out but this module keeps whole is ROADMAP
item 14b: params over ``"data"``/``"model"`` (FSDP, tensor parallelism),
``seq_axis`` (a GSPMD hint for sequence-sharded activations) and
multi-pod serving (multi-host).  The reference's ``ns`` (a
``NamedSharding`` tree) has no counterpart: ``fn`` places its inputs
itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import fp32_exact
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.registry import input_specs
from repro_torch.core.partitioner import contiguous_stages
from repro_torch.launch import pipeline as pp
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import (batch_specs, cache_pspecs,
                                          gather_tree, shard_tree)
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


def _home(tree) -> torch.device:
    return tree_flatten(tree)[0][0].device


def abstract_train_step(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec,
                        opt_cfg: AdamWConfig | None = None, *,
                        microbatches: int | None = None, remat: bool = True,
                        seq_axis: str | None = None):
    """Data-parallel train step over ``mesh``'s ``"data"`` devices:
    ``fn(params, opt_state, batch) -> (params, opt_state, metrics)`` with
    params and optimizer state on one device (the update is made there and
    copied to each data device at the next step) and the batch anywhere.
    Each data device splits its shard into ``microbatches`` chunks; the
    gradients are summed in fp32 in device order and chunk order and
    divided once, as ``make_train_step`` sums its microbatches, so
    ``data=n`` with one chunk each equals ``make_train_step(microbatches=
    n)``.  A ``"model"`` axis above 1 (tensor parallelism) and
    ``seq_axis`` (``make_loss_fn`` refuses it) are ROADMAP item 14b."""
    sizes = mesh.shape
    if any(n > 1 for a, n in sizes.items() if a != "data"):
        raise NotImplementedError(
            f"a train step over {sizes}: only 'data' may exceed 1; tensor "
            "parallelism over 'model' is ROADMAP item 14b")
    opt_cfg = _default_opt(cfg, opt_cfg)
    params_s = abstract_params(cfg)
    opt_s = init_train_state(cfg, params_s, opt_cfg)
    batch_s = input_specs(cfg, shape)
    bspec = {k: batch_specs(cfg, shape)[k] for k in batch_s}
    mb = microbatches if microbatches is not None \
        else _microbatches_for(cfg, shape)
    kvc, ssdc = _chunks(shape)
    loss_fn = make_loss_fn(cfg, remat=remat, kv_chunk=kvc, ssd_chunk=ssdc,
                           seq_axis=seq_axis)
    devs = list(mesh.devices.flat)

    @fp32_exact()
    def step(params, opt_state, batch):
        home = _home(params)
        shards = shard_tree(batch, bspec, mesh)
        n = len(devs) * mb
        flat, spec = tree_flatten(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=home)
                for p in flat] if n > 1 else None
        loss_sum = torch.zeros((), dtype=torch.float32, device=home)
        for dev, local in zip(devs, shards):
            p_d = tree_map(lambda t: t.to(dev), params)
            b = next(iter(local.values())).shape[0]
            if b % mb:
                raise ValueError(f"a data shard of {b} rows does not split "
                                 f"into {mb} microbatches")
            for j in range(mb):
                chunk = {k: v.reshape(mb, b // mb, *v.shape[1:])[j]
                         for k, v in local.items()}
                loss, g = _value_and_grad(loss_fn, p_d, chunk)
                if n == 1:                 # make_train_step's one chunk
                    grads, loss_sum = g, loss
                    continue
                loss_sum = loss_sum + loss.to(home)
                for a, gi in zip(gsum, tree_flatten(g)[0]):
                    a.add_(gi.to(home))
        if n > 1:
            grads = tree_unflatten(spec, [a.div_(n) for a in gsum])
            loss_sum = loss_sum / n
        params, opt_state, m = adamw_update(opt_cfg, params, grads,
                                            opt_state)
        return params, opt_state, {"loss": loss_sum, **m}

    return step, (params_s, opt_s, batch_s)


def abstract_pp_train_step(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec,
                           opt_cfg: AdamWConfig | None = None, *,
                           n_micro: int = 4, partition=None):
    """The pipelined train step over ``mesh``'s ``"pod"`` axis.
    ``partition`` is an AFarePart layer -> tier mapping (default: all on
    tier 0, an equal split); ``contiguous_stages`` -> ``group_cuts`` give
    the stages, ``fn.cuts`` the group cuts.  ``fn(placed, opt_state,
    batch) -> (placed, opt_state, metrics)`` takes the params as
    ``pipeline.place_pp_params(pipeline.to_pp(params, fn.cuts), mesh)``
    and the optimizer state as ``init_train_state`` of those; ``args``
    are the reference layout's stand-ins."""
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

    @fp32_exact()
    def step(placed, opt_state, batch):
        loss, grads = _value_and_grad(loss_fn, placed, batch)
        placed, opt_state, m = adamw_update(opt_cfg, placed, grads,
                                            opt_state)
        return placed, opt_state, {"loss": loss, **m}

    step.cuts = cuts_g
    return step, (pp_params_s, opt_s, batch_s)


def _serve_layout(cfg, mesh, shape):
    """``(batch specs, cache specs, batch split over "data")`` of a serve
    step."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"a serve step runs on a ('data', 'model') mesh, "
                         f"not {mesh.axis_names} (multi-pod serving is "
                         "ROADMAP item 14b)")
    batch_s = input_specs(cfg, shape)
    bspec = {k: batch_specs(cfg, shape)[k] for k in batch_s}
    return batch_s, bspec, cache_pspecs(cfg, shape), \
        shape.global_batch >= 2


def _rows(mesh, split: bool) -> range:
    """The data rows that compute (all of them when the batch is split
    over ``"data"``, else row 0, the others holding copies)."""
    return range(mesh.devices.shape[0] if split else 1)


def abstract_serve_prefill(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec):
    """Prefill: ``fn(params, batch) -> (last-position logits [B, V],
    cache)``, each data device prefilling its rows, the cache laid out by
    ``cache_pspecs`` (one tree a mesh slot, ``shard_tree``'s) with
    ``shape.seq_len`` slots."""
    batch_s, bspec, cspec, split = _serve_layout(cfg, mesh, shape)
    params_s = abstract_params(cfg)
    kvc, ssdc = _chunks(shape)
    nm = mesh.devices.shape[1]

    def fn(params, batch):
        home = _home(params)
        shards = shard_tree(batch, bspec, mesh)
        lasts, caches = [], []
        for d in _rows(mesh, split):
            dev = mesh.devices[d, 0]
            logits, cache = prefill(tree_map(lambda t: t.to(dev), params),
                                    cfg, shards[d * nm], shape.seq_len,
                                    kv_chunk=kvc, ssd_chunk=ssdc)
            lasts.append(logits[:, -1].to(home))
            caches.append(cache)
        full = caches[0] if len(caches) == 1 else tree_map(
            lambda *ts: torch.cat([t.to(home) for t in ts], 1), *caches)
        return torch.cat(lasts), shard_tree(full, cspec, mesh)

    return fn, (params_s, batch_s)


def abstract_serve_decode(cfg: ArchConfig, mesh: Mesh, shape: ShapeSpec):
    """One-token decode against a ``shape.seq_len`` cache laid out by
    ``cache_pspecs``: ``fn(params, cache, batch, fault=None) -> (logits [B,
    V], cache)``, the cache (one tree a mesh slot) updated in place.  Each
    data row's step runs on its first model device, its attention over
    that row's model devices, one sequence shard each; its recurrent
    states are put together there for the step and split again after.
    ``fault`` is ``decode_step``'s (the reference's step takes none):
    each layer is corrupted once, before its attention splits."""
    batch_s, bspec, cspec, split = _serve_layout(cfg, mesh, shape)
    params_s = abstract_params(cfg)
    cache_s = cache_specs(cfg, shape.global_batch, shape.seq_len)
    nd, nm = mesh.devices.shape
    rec = {k: v for k, v in cspec.items() if "k" not in v}   # rglru / ssd

    def fn(params, cache, batch, fault=None):
        home = _home(params)
        shards = shard_tree(batch, bspec, mesh)
        out = []
        for d in _rows(mesh, split):
            sub = Mesh(mesh.devices[d:d + 1], mesh.axis_names)
            local = cache[d * nm:(d + 1) * nm]
            states = gather_tree([{k: t[k] for k in rec} for t in local],
                                 rec, sub) if rec else {}
            seq = [{**{k: v for k, v in t.items() if k not in rec}, **states}
                   for t in local]
            dev = mesh.devices[d, 0]
            b = shards[d * nm]
            f = None if fault is None else (fault[0].to(dev),
                                            fault[1].to(dev), fault[2])
            logits, _ = decode_step(
                tree_map(lambda t: t.to(dev), params), cfg,
                seq if nm > 1 else seq[0], b["tokens"], b["positions"],
                enc_memory=b.get("enc_embeds"), fault=f)
            if rec:
                for t, new in zip(local, shard_tree(states, rec, sub)):
                    for k in rec:
                        for name in rec[k]:
                            t[k][name].copy_(new[k][name])
            out.append(logits.to(home))
        if not split:                      # refresh the other rows' copies
            for d in range(1, nd):
                for t, src in zip(cache[d * nm:(d + 1) * nm], cache[:nm]):
                    tree_map(lambda a, b: a.copy_(b), t, src)
        return torch.cat(out), cache

    return fn, (params_s, cache_s, batch_s)
