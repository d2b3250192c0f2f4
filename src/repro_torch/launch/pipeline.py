"""Pipeline parallelism over the ``pod`` mesh axis, driven by AFarePart: the
counterpart of ``repro/launch/pipeline.py``.

The paper's layer -> device mapping becomes the pipeline-stage assignment:
``contiguous_stages`` converts the NSGA-II partition into contiguous
layer cuts, :func:`group_cuts` into group cuts, and :func:`stage_stack`
restacks the ``[G, ...]`` group leaves into zero-padded ``[n_stages,
Lmax, ...]`` stage stacks, the reference's layout.

GPipe in one process (the reference: GSPMD's shifting buffer).  Stage
``s``'s stack lives on the ``s``-th ``pod`` device (:func:`place_pp_params`,
a ``[1, Lmax, ...]`` slice of every stage leaf; the embedding and the
encoder on the first stage's device, the final norm and head on the
last's).  A tick of the ``n_micro + n_stages - 1``:

    1. microbatch ``t``'s embeddings enter stage 0;
    2. every stage holding a microbatch runs its groups on its own device
       (the reference computes and masks the empty slots; here they are
       skipped);
    3. the last stage's output is unembedded and its cross entropy taken
       there, accumulated in tick order;
    4. each output moves to the next stage's device.

Autograd through the ticks gives GPipe's backward.  A stage skips its
padded group slots, whose gradients come out as zeros; tied embeddings
feed stage 0 and the head on the last stage, and their gradient sums the
two devices' contributions.  The pipeline keeps the ``data`` and ``model``
axes at 1: laying a stage out over them is ROADMAP item 14b.

The swap bookkeeping (:func:`swap_migration`) counts which parameter
groups a hot swap moves between stages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import tree_flatten_with_path, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.shardings import (P, _divisible, _leaf_spec,
                                          gather_tree, logical_name,
                                          shard_tree)
from repro_torch.models.transformer import (_block_fwd, _dec_block_fwd,
                                            _encode, _unstack, embed_tokens,
                                            unembed)
from repro_torch.train.train_step import cross_entropy_loss

__all__ = ["stage_stack", "stage_param_specs", "make_pp_loss", "to_pp",
           "place_pp_params", "gather_pp_params", "pod_devices",
           "group_cuts", "swap_migration"]


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


def pod_devices(mesh) -> list[torch.device]:
    """The stages' devices, in pod order.  Raises unless every other axis
    of the mesh is 1 (a stage over several devices is item 14b)."""
    sizes = mesh.shape
    if "pod" not in sizes:
        raise ValueError(f"a pipeline needs a 'pod' axis, the mesh has "
                         f"{mesh.axis_names}")
    if any(n > 1 for a, n in sizes.items() if a != "pod"):
        raise NotImplementedError(
            f"pipeline stages laid out over {sizes}: a stage over several "
            "data or model devices is ROADMAP item 14b")
    return list(mesh.devices.flat)


_FIRST = ("embed", "enc_groups", "enc_norm")     # on the first stage's card


def place_pp_params(pp_params: dict, mesh) -> dict:
    """A pp tree (:func:`to_pp`) placed for :func:`make_pp_loss`: ``stages``
    becomes one tree a stage (``shard_tree`` by :func:`stage_param_specs`:
    stage ``s``'s ``[1, Lmax, ...]`` slice on pod device ``s``), the
    embedding and the encoder go to the first stage's device, the rest
    (final norm, head) to the last's."""
    devs = pod_devices(mesh)
    out = {k: tree_map(lambda t, k=k: t.to(devs[0] if k in _FIRST
                                           else devs[-1]), v)
           for k, v in pp_params.items() if k != "stages"}
    out["stages"] = shard_tree(pp_params["stages"], stage_param_specs(
        pp_params["stages"], mesh), mesh)
    return out


def gather_pp_params(placed: dict, mesh, device=None) -> dict:
    """The inverse of :func:`place_pp_params`: the reference's pp tree on
    ``device`` (default: the first stage's)."""
    devs = pod_devices(mesh)
    device = devs[0] if device is None else device
    out = {k: tree_map(lambda t: t.to(device), v)
           for k, v in placed.items() if k != "stages"}
    # a stage's slice has the stack's rank and trailing shape, which is
    # all the specs read
    out["stages"] = gather_tree(placed["stages"], stage_param_specs(
        placed["stages"][0], mesh), mesh, device)
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
    anywhere.  The loss, a 0-d float32 tensor on the last stage's device,
    is the mean of the microbatches' cross entropies, summed in tick
    order as the reference's."""
    devs = pod_devices(mesh)
    n_stages = len(cuts_g) - 1
    if len(devs) != n_stages:
        raise ValueError(f"{n_stages} stages on {len(devs)} pod devices")
    lens = [cuts_g[i + 1] - cuts_g[i] for i in range(n_stages)]
    offs = cuts_g[:-1]
    first, last = devs[0], devs[-1]

    def loss_fn(placed, batch):
        stages = [tree_map(lambda t: t[0], st) for st in placed["stages"]]
        src = batch.get("tokens", batch.get("embeds"))
        B, S = src.shape[0], src.shape[1]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches")
        Bm = B // n_micro

        def mb(key, dev):
            x = batch.get(key)
            return None if x is None else x.to(dev).reshape(
                n_micro, Bm, *x.shape[1:])

        toks, embeds, labels = mb("tokens", first), mb("embeds", first), \
            mb("labels", last)
        positions = [torch.arange(S, dtype=torch.int32, device=d)
                     for d in devs]
        memory = mem_pos = None
        if cfg.is_encdec:
            enc = mb("enc_embeds", first)
            memory = [_encode(cfg, placed, enc[i][None], lambda _: None)[0]
                      for i in range(n_micro)]
            mem_pos = [torch.arange(memory[0].shape[1], dtype=torch.int32,
                                    device=d) for d in devs]
        head = {"final_norm": placed["final_norm"]}
        if cfg.tie_embeddings:
            head["embed"] = placed["embed"].to(last)
        else:
            head["lm_head"] = placed["lm_head"]

        def embed_mb(i):
            if embeds is not None:
                return embeds[i].to(cfg.torch_dtype)
            return embed_tokens(cfg, placed, toks[i])

        loss_acc = torch.zeros((), dtype=torch.float32, device=last)
        state = [None] * n_stages
        for t in range(n_micro + n_stages - 1):
            out = [None] * n_stages
            for s in range(n_stages):
                i = t - s                     # the microbatch stage s holds
                if not 0 <= i < n_micro:
                    continue
                x = embed_mb(i) if s == 0 else state[s - 1].to(devs[s])
                mem = memory[i].to(devs[s]) if cfg.is_encdec else None
                out[s] = _stage_forward(
                    cfg, stages[s], lens[s], offs[s], x, positions[s], mem,
                    mem_pos[s] if cfg.is_encdec else None, kv_chunk,
                    ssd_chunk)
            i = t - (n_stages - 1)            # the microbatch leaving
            if i >= 0:
                loss_acc = loss_acc + cross_entropy_loss(
                    unembed(cfg, head, out[-1]), labels[i])
            state = out
        return loss_acc / n_micro

    return loss_fn
