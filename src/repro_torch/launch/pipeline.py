"""Pipeline parallelism over the ``pod`` mesh axis, driven by AFarePart: the
counterpart of ``repro/launch/pipeline.py``.

The paper's layer -> device mapping becomes the pipeline-stage assignment:
``contiguous_stages`` converts the NSGA-II partition into contiguous
layer cuts, :func:`group_cuts` into group cuts, and :func:`stage_stack`
restacks the ``[G, ...]`` group leaves into zero-padded ``[n_stages,
Lmax, ...]`` stage stacks, the reference's layout.

GPipe in one process (the reference: GSPMD's shifting buffer).  Stage
``s`` lives on the ``s``-th pod's ``(data, model)`` sub-mesh
(:func:`stage_meshes`): its ``[1, Lmax, ...]`` stack slice laid out by
:func:`stage_param_specs` (the single-pod rules on the trailing dims), the
embedding and the encoder by ``param_specs`` on the first stage's
sub-mesh, the final norm and head on the last's (:func:`place_pp_params`).
Each stage's data rows split the microbatch and run the FSDP x
tensor-parallel blocks of ``models/layers.py`` over their model slots.  A
tick of the ``n_micro + n_stages - 1``:

    1. microbatch ``t``'s embeddings enter stage 0;
    2. every stage holding a microbatch runs its groups, row by row (the
       reference computes and masks the empty slots; here they are
       skipped);
    3. the last stage's output is unembedded and its cross entropy taken
       there (the rows' token-weighted mean), accumulated in tick order;
    4. each row's output moves to the next stage's same row.

Autograd through the ticks gives GPipe's backward; the gradient of a
slice several rows read (over ``"data"``: ZeRO-3's reduce-scatter) is
summed by autograd there, in the leaf's dtype, and :func:`sync_grads`
sums the copies of a shard (a leaf not split over ``"data"`` or
``"model"``) in fp32, slot order.  A stage skips its padded group slots,
whose gradients come out as zeros; tied embeddings feed stage 0 and the
head on the last stage, and their gradient sums the two sub-meshes'
contributions.

The swap bookkeeping (:func:`swap_migration`) counts which parameter
groups a hot swap moves between stages.
"""
from __future__ import annotations

import numpy as np
import torch

import dataclasses

from repro_torch._tree import (tree_flatten, tree_flatten_with_path,
                               tree_map, tree_unflatten)
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import (P, _divisible, _leaf_spec,
                                          _leaves, _slots, gather_tree,
                                          logical_name, owned, param_specs,
                                          row_params, shard_tree, spec_axes)
from repro_torch.models.transformer import (_block_fwd, _dec_block_fwd,
                                            _encode, _unstack, embed_tokens,
                                            unembed)
from repro_torch.train.train_step import cross_entropy_loss

__all__ = ["stage_stack", "stage_param_specs", "make_pp_loss", "to_pp",
           "place_pp_params", "gather_pp_params", "stage_meshes",
           "sync_grads", "pp_counted", "group_cuts", "swap_migration"]


def group_cuts(layer_cuts: list[int], cfg: ArchConfig) -> list[int]:
    """Layer-granular AFarePart cuts -> group-granular pipeline cuts."""
    Pn = len(cfg.block_pattern)
    G = cfg.n_groups
    cuts = [0]
    for c in layer_cuts[1:-1]:
        g = min(max(round(c / Pn), cuts[-1] + 1), G - 1)
        cuts.append(g)
    cuts.append(G)
    return cuts


def swap_migration(old_partition, new_partition, cfg: ArchConfig,
                   n_stages: int) -> dict:
    """Which parameter groups change pipeline stage when the partition
    changes from ``old_partition`` to ``new_partition``:
    ``{"migrated_groups", "n_groups", "old_cuts", "new_cuts"}``."""
    from repro_torch.core.partitioner import contiguous_stages
    old_cuts = group_cuts(contiguous_stages(
        np.asarray(old_partition), n_stages), cfg)
    new_cuts = group_cuts(contiguous_stages(
        np.asarray(new_partition), n_stages), cfg)

    def stage_of(cuts):
        s = np.zeros(cuts[-1], dtype=np.int64)
        for i in range(len(cuts) - 1):
            s[cuts[i]:cuts[i + 1]] = i
        return s

    migrated = int((stage_of(old_cuts) != stage_of(new_cuts)).sum())
    return {"migrated_groups": migrated, "n_groups": old_cuts[-1],
            "old_cuts": old_cuts, "new_cuts": new_cuts}


def stage_stack(group_params, cuts: list[int]):
    """``[G, ...]`` leaves -> ``([n_stages, Lmax, ...]`` zero-padded stage
    stacks, the stages' lengths)."""
    n_stages = len(cuts) - 1
    lens = [cuts[i + 1] - cuts[i] for i in range(n_stages)]
    lmax = max(lens)

    def restack(x):
        pieces = []
        for i in range(n_stages):
            piece = x[cuts[i]:cuts[i + 1]]
            pad = lmax - piece.shape[0]
            if pad:
                piece = torch.cat([piece, piece.new_zeros(
                    (pad, *piece.shape[1:]))])
            pieces.append(piece)
        return torch.stack(pieces)

    return tree_map(restack, group_params), lens


def stage_param_specs(stage_params, mesh=None):
    """``P("pod", None, <single-pod trailing rules>)`` for stage stacks."""
    flat, treedef = tree_flatten_with_path(stage_params)
    specs = [P("pod", None, *_divisible(
        _leaf_spec(logical_name(path), leaf.ndim - 2), leaf.shape[2:], mesh))
        for path, leaf in flat]
    return tree_unflatten(treedef, specs)


def to_pp(params: dict, cuts_g: list[int]) -> dict:
    """The param tree with ``groups`` restacked into ``stages``."""
    out = {k: v for k, v in params.items() if k != "groups"}
    out["stages"], _ = stage_stack(params["groups"], cuts_g)
    return out


def stage_meshes(mesh) -> list[Mesh]:
    """The stages' ``("data", "model")`` sub-meshes, in pod order."""
    if tuple(mesh.axis_names) != ("pod", "data", "model"):
        raise ValueError(f"a pipeline runs on a ('pod', 'data', 'model') "
                         f"mesh, not {mesh.axis_names}")
    return [Mesh(mesh.devices[s], ("data", "model"))
            for s in range(mesh.shape["pod"])]


_FIRST = ("embed", "enc_groups", "enc_norm")     # on the first stage


def _specs(like: dict, mesh) -> dict:
    """The pp tree's specs: ``{"stages": stage_param_specs over mesh, key:
    param_specs over key's stage's sub-mesh}``."""
    subs = stage_meshes(mesh)
    out = {k: param_specs({k: v}, subs[0] if k in _FIRST else subs[-1])[k]
           for k, v in like.items() if k != "stages"}
    out["stages"] = stage_param_specs(like["stages"], mesh)
    return out


def _sub(k, subs):
    return subs[0] if k in _FIRST else subs[-1]


def place_pp_params(pp_params: dict, mesh) -> dict:
    """A pp tree (:func:`to_pp`) placed for :func:`make_pp_loss`: ``stages``
    becomes one tree a mesh slot (``shard_tree`` by
    :func:`stage_param_specs`: stage ``s``'s ``[1, Lmax, ...]`` slice on
    pod ``s``'s sub-mesh), every other entry one tree a slot of its
    stage's sub-mesh (``param_specs``: the embedding and the encoder on
    the first stage's, the final norm and head on the last's)."""
    subs, specs = stage_meshes(mesh), _specs(pp_params, mesh)
    out = {k: shard_tree(v, specs[k], _sub(k, subs))
           for k, v in pp_params.items() if k != "stages"}
    out["stages"] = shard_tree(pp_params["stages"], specs["stages"], mesh)
    return out


def gather_pp_params(placed: dict, mesh, device=None, like=None) -> dict:
    """The inverse of :func:`place_pp_params`: the reference's pp tree on
    ``device`` (default: the first slot's).  ``like``: the pp tree or its
    stand-in, whose shapes give the specs; by default they come from the
    placed slices, which is right when every sub-mesh is one slot."""
    subs = stage_meshes(mesh)
    device = mesh.devices.flat[0] if device is None else device
    if like is None:
        like = {k: v[0] for k, v in placed.items() if k != "stages"}
        like["stages"] = placed["stages"][0]
    specs = _specs(like, mesh)
    out = {k: gather_tree(v, specs[k], _sub(k, subs), device)
           for k, v in placed.items() if k != "stages"}
    out["stages"] = gather_tree(placed["stages"], specs["stages"], mesh,
                                device)
    return out


def _sum_copies(tree: list, specs, mesh) -> list:
    """``tree`` (one tree a slot) with the slices that copy one shard (the
    slots that differ only along axes the leaf is not split over) each set
    to their fp32 sum in slot order, rounded once (an all-reduce)."""
    leaves, treedef = _leaves(tree[0], specs)
    flat = [tree_flatten(t)[0] for t in tree]
    out = [list(f) for f in flat]
    slots = list(_slots(mesh))
    for j, (_, _, spec) in enumerate(leaves):
        used = spec_axes(spec)
        groups: dict = {}
        for i, _, coords in slots:
            key = tuple(coords[a] for a in mesh.axis_names if a in used)
            groups.setdefault(key, []).append(i)
        for idx in groups.values():
            if len(idx) > 1:
                sums = C.all_reduce([flat[i][j] for i in idx],
                                    [mesh.devices.flat[i] for i in idx])
                for i, t in zip(idx, sums):
                    out[i][j] = t
    return [tree_unflatten(treedef, f) for f in out]


def sync_grads(grads: dict, mesh, like: dict) -> dict:
    """A pipelined step's gradients (laid out as :func:`place_pp_params`)
    with the copies of each shard summed: a slice several rows of a stage
    share (not split over ``"data"``) or that one model slot reads for
    all (not split over ``"model"``) gets their sum."""
    subs, specs = stage_meshes(mesh), _specs(like, mesh)
    out = {k: _sum_copies(v, specs[k], _sub(k, subs))
           for k, v in grads.items() if k != "stages"}
    out["stages"] = _sum_copies(grads["stages"], specs["stages"], mesh)
    return out


def pp_counted(mesh, like: dict) -> dict:
    """``owned`` over a placed pp tree: which slices a global norm
    counts."""
    subs, specs = stage_meshes(mesh), _specs(like, mesh)
    out = {k: [t[k] for t in owned({k: v}, {k: specs[k]}, _sub(k, subs))]
           for k, v in like.items() if k != "stages"}
    out["stages"] = owned(like["stages"], specs["stages"], mesh)
    return out


def _stage_forward(cfg: ArchConfig, stage_groups, my_len: int,
                   my_offset: int, x: torch.Tensor, positions: torch.Tensor,
                   memory=None, mem_pos=None, kv_chunk: int = 1024,
                   ssd_chunk: int = 256):
    """One stage's layer groups on ``x [B, S, D]``: ``stage_groups`` leaves
    ``[Lmax, ...]``, its first ``my_len`` slots the stage's groups (global
    group ``my_offset + idx``); the padded slots are skipped, and so is a
    slot past ``n_layers`` in a partial last group.  The encoder-decoder's
    decoder blocks attend to ``memory [B, Se, D]``."""
    slots = _unstack(stage_groups)[:my_len]
    x = x[None]
    if cfg.is_encdec:
        mem = memory[None]
        for gp in slots:
            x = _dec_block_fwd(cfg, gp, x, positions, mem, mem_pos,
                               kv_chunk=kv_chunk)
        return x[0]
    Pn = len(cfg.block_pattern)
    for idx, gp in enumerate(slots):
        for s, kind in enumerate(cfg.block_pattern):
            if (my_offset + idx) * Pn + s < cfg.n_layers:
                x = _block_fwd(cfg, kind, gp[f"b{s}"], x, positions,
                               kv_chunk=kv_chunk, ssd_chunk=ssd_chunk)
    return x[0]


def make_pp_loss(cfg: ArchConfig, mesh, cuts_g: list[int], n_micro: int,
                 *, kv_chunk: int = 1024, ssd_chunk: int = 256):
    """``loss_fn(placed, batch)``: the GPipe schedule of the module
    docstring over ``placed`` (:func:`place_pp_params`); the batch may lie
    anywhere.  The loss, a 0-d float32 tensor on the last stage's first
    slot, is the mean of the microbatches' cross entropies, summed in tick
    order as the reference's.  ``loss_fn(..., rows=[d])`` computes only
    those data rows of every stage (the dry run's per-row probe)."""
    from repro_torch.launch.steps import abstract_params

    subs = stage_meshes(mesh)
    n_stages = len(cuts_g) - 1
    if len(subs) != n_stages:
        raise ValueError(f"{n_stages} stages on {len(subs)} pods")
    nd, nm = subs[0].shape["data"], subs[0].shape["model"]
    k = nd * nm
    lens = [cuts_g[i + 1] - cuts_g[i] for i in range(n_stages)]
    offs = cuts_g[:-1]
    specs = _specs(to_pp(abstract_params(cfg), cuts_g), mesh)
    local = _drop_pod(specs["stages"])
    homes = [[sub.devices[d, 0] for d in range(nd)] for sub in subs]
    last = homes[-1][0]

    def views(placed):
        """Per stage, per data row: the row's params."""
        out = []
        for s, sub in enumerate(subs):
            trees = [tree_map(lambda t: t[0], st)
                     for st in placed["stages"][s * k:(s + 1) * k]]
            out.append([row_params(trees, local, sub, {"data": d})
                        for d in range(nd)])
        return out

    def side(placed, keys, sub):
        keys = [x for x in keys if x in placed]
        trees = [{x: placed[x][i] for x in keys} for i in range(k)]
        sp = {x: specs[x] for x in keys}
        return [row_params(trees, sp, sub, {"data": d}) for d in range(nd)]

    def loss_fn(placed, batch, rows=None):
        ds = range(nd) if rows is None else rows
        stages = views(placed)
        first = side(placed, _FIRST, subs[0])
        heads = side(placed, ("final_norm", "lm_head"), subs[-1])
        if cfg.tie_embeddings:        # the embedding read on the last stage
            for d in range(nd):
                heads[d]["embed"] = dataclasses.replace(
                    first[d]["embed"], devices=tuple(
                        subs[-1].devices[d, m] for m in range(nm)))
        src = batch.get("tokens", batch.get("embeds"))
        B, S = src.shape[0], src.shape[1]
        if B % (n_micro * nd):
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches of {nd} data rows")
        br = B // (n_micro * nd)

        def mb(key, i, d, dev):
            x = batch.get(key)
            return None if x is None else x.reshape(
                n_micro, nd, br, *x.shape[1:])[i, d].to(dev)

        positions = [[torch.arange(S, dtype=torch.int32, device=h)
                      for h in hs] for hs in homes]
        memory = mem_pos = None
        if cfg.is_encdec:
            memory = [{d: _encode(cfg, first[d], mb("enc_embeds", i, d,
                                                    homes[0][d])[None],
                                  lambda _: None)[0] for d in ds}
                      for i in range(n_micro)]
            mem_pos = [[torch.arange(memory[0][ds[0]].shape[1],
                                     dtype=torch.int32, device=h)
                        for h in hs] for hs in homes]

        def embed_mb(i, d):
            if "embeds" in batch:
                return mb("embeds", i, d, homes[0][d]).to(cfg.torch_dtype)
            return embed_tokens(cfg, first[d], mb("tokens", i, d,
                                                  homes[0][d]))

        def mb_loss(i, outs):
            parts = []
            for d in ds:
                lab = mb("labels", i, d, homes[-1][d])
                ce = cross_entropy_loss(unembed(cfg, heads[d], outs[d]), lab)
                if nd == 1:
                    return ce.to(last)
                n = (lab >= 0).sum().to(torch.float32)
                parts.append((ce * n, n))
            tot = sum(C.all_gather([a[None] for a, _ in parts], 0,
                                   [last])[0].unbind(0))
            cnt = sum(C.all_gather([b[None] for _, b in parts], 0,
                                   [last])[0].unbind(0))
            return tot / torch.clamp_min(cnt, 1.0)

        loss_acc = torch.zeros((), dtype=torch.float32, device=last)
        state = [None] * n_stages
        for t in range(n_micro + n_stages - 1):
            out = [None] * n_stages
            for s in range(n_stages):
                i = t - s                     # the microbatch stage s holds
                if not 0 <= i < n_micro:
                    continue
                out[s] = {}
                for d in ds:
                    dev = homes[s][d]
                    x = embed_mb(i, d) if s == 0 else state[s - 1][d].to(dev)
                    out[s][d] = _stage_forward(
                        cfg, stages[s][d], lens[s], offs[s], x,
                        positions[s][d],
                        memory[i][d].to(dev) if cfg.is_encdec else None,
                        mem_pos[s][d] if cfg.is_encdec else None, kv_chunk,
                        ssd_chunk)
            i = t - (n_stages - 1)            # the microbatch leaving
            if i >= 0:
                loss_acc = loss_acc + mb_loss(i, out[-1])
            state = out
        return loss_acc / n_micro

    return loss_fn


def _drop_pod(stage_specs):
    """``P("pod", None, *trailing)`` -> ``P(None, *trailing)``: the specs of
    one stage's ``[Lmax, ...]`` slice over its sub-mesh."""
    if isinstance(stage_specs, P):
        return P(*stage_specs[1:])
    if isinstance(stage_specs, dict):
        return {k: _drop_pod(v) for k, v in stage_specs.items()}
    return type(stage_specs)(_drop_pod(v) for v in stage_specs)
