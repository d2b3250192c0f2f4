"""KV-cache utilities of the serving engine, the counterpart of
``repro/serve/kvcache.py``.

The layout is ``models.transformer.init_cache``'s: every leaf carries the
batch as its second axis (``[G, B, ...]``), so admitting a request writes
one row of each leaf and every other in-flight request is untouched.  A
partition hot swap changes no cache bytes either: the fault rates are
arguments of the decode step, not part of the cache.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import cache_layout

__all__ = ["cache_specs", "cache_bytes", "merge_slot", "slot_bytes"]


def merge_slot(cache: dict, slot_cache: dict, i: int) -> dict:
    """Write a one-request cache (batch 1, the same ``max_len`` layout)
    into slot ``i`` of a batched cache, in place, and return it.  Every
    other slot's rows stay bitwise unchanged: admission needs no global
    barrier."""
    for full, one in zip(tree_leaves(cache), tree_leaves(slot_cache)):
        full[:, i] = one[:, 0]
    return cache


def slot_bytes(cfg: ArchConfig, max_len: int) -> int:
    """Cache bytes one admission slot occupies (batch share of a row)."""
    return cache_bytes(cfg, batch=1, max_len=max_len)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                seq_shards: int = 1) -> dict:
    """:func:`init_cache`'s tree as meta tensors (shapes and dtypes, no
    memory), with the sequence dimension of the attention caches divided
    by ``seq_shards``: one shard's local shape under flash-decode sequence
    sharding (``launch/shardings.cache_pspecs``).  Recurrent states are
    whole in every shard."""
    out = {}
    for slot, entry in cache_layout(cfg, batch, max_len).items():
        out[slot] = {}
        for name, (shape, dt, _) in entry.items():
            if name in ("k", "v", "pos"):
                if shape[2] % seq_shards:
                    raise ValueError(f"{slot}/{name}: {shape[2]} cache slots "
                                     f"do not split into {seq_shards} shards")
                shape = (*shape[:2], shape[2] // seq_shards, *shape[3:])
            out[slot][name] = torch.empty(shape, dtype=dt, device="meta")
    return out


def cache_bytes(cfg: ArchConfig, batch: int, max_len: int) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(cache_specs(cfg, batch, max_len)))
