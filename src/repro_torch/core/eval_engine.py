"""Population-level evaluation engine, the counterpart of
``repro/core/eval_engine.py`` (the multi-device ``DeviceScheduler`` comes
with a later slice; both engines here run on one device).

Two layers, one contract:

1. **Population engine** (:class:`PopulationEvalEngine`) — the
   whole-forward path.  Deduplicates rows inside a population, caches rows
   across generations (evaluation is deterministic given the seed, so
   caching is exact), and pushes the unique uncached rows through chunks
   of at most ``eval_batch_size`` rows, each padded by repeating its last
   row to a power-of-two bucket.

2. **Prefix engine** (:class:`PrefixEvalEngine`) — the staged path.  A
   chromosome's corrupted activation after unit *i* depends only on genes
   ``P[0..i]``, so the engine evaluates each unique gene *prefix* once,
   with an LRU-bounded :class:`ActivationStore` (eviction falls back to
   recompute, never to wrong results).  With a ``segment_fn`` the walk is
   *chain-fused*: maximal non-branching runs of the prefix trie dispatch
   as one segment call each, and dispatch outputs stay stacked in the
   store as :class:`StackedView` entries.

Per-row results must be independent of the other rows in the batch, so
chunk boundaries never change values.  The staged walk does NOT pad its
chunks: the reference pads to power-of-two buckets so that XLA compiles
few shapes, but in eager PyTorch a padding row costs a full per-row
convolution and serves no compile cache.  Chunk boundaries, and so every
counter, are the reference's (``chunked_rows``).

Device discipline of the staged walk: activations and final-depth results
stay on the device until :meth:`PrefixEvalEngine._gather_final` copies
each chunk's results to the host once; gene indices go to the card from
pinned memory without blocking, so no dispatch waits for the device.
"""
from __future__ import annotations

import gc
import os
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map

__all__ = ["PopulationEvalEngine", "PrefixEvalEngine", "ActivationStore",
           "PrefixRef", "StackedView", "chunked_rows", "bucket_size",
           "pad_rows", "parse_eval_batch_size", "auto_eval_batch_size",
           "device_memory_budget", "peak_memory_bytes"]


def parse_eval_batch_size(value) -> int | str | None:
    """The CLI/config grammar for ``eval_batch_size``: ``None`` and
    ``"auto"`` pass through, anything else must be a positive int."""
    if value in (None, "auto"):
        return value
    n = int(value)
    if n < 1:
        raise ValueError(f"eval_batch_size must be >= 1, got {n}")
    return n


def bucket_size(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


def chunked_rows(n_rows: int, eval_batch_size: int | None
                 ) -> list[tuple[int, int, int]]:
    """Chunk plan: ``(start, stop, padded_size)`` per dispatch.  Full
    chunks hold ``eval_batch_size`` rows, a trailing partial chunk pads to
    its own power-of-two bucket; without a cap the whole batch is one
    chunk padded to the next power of two."""
    if n_rows <= 0:
        return []
    if eval_batch_size is None:
        return [(0, n_rows, bucket_size(n_rows))]
    bs = max(1, int(eval_batch_size))
    return [(s, min(s + bs, n_rows),
             min(bs, bucket_size(min(s + bs, n_rows) - s)))
            for s in range(0, n_rows, bs)]


def pad_rows(rows: np.ndarray, padded: int) -> np.ndarray:
    """Pad a chunk to ``padded`` rows by repeating the last row."""
    if padded <= len(rows):
        return rows
    pad = np.repeat(rows[-1:], padded - len(rows), axis=0)
    return np.concatenate([rows, pad], axis=0)


def to_device_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int64 index tensor on ``device``.  On a card the host copy is
    pinned and sent without blocking (a pageable copy would wait for the
    stream); PyTorch's pinned-memory cache keeps the buffer until the copy
    has run."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PrefixRef:
    """Marker leaf inside a stored activation: "this carry field equals
    the activation stored at ``prefix``".  Fields listed in the engine's
    ``shared_fields`` are replaced by a ref before storing and resolved
    (recomputing after eviction) when read, so the store holds the shared
    payload once per keying prefix.  A ref owns no buffer."""

    __slots__ = ("prefix",)

    def __init__(self, prefix: tuple):
        self.prefix = prefix

    def __repr__(self):
        return f"PrefixRef({self.prefix!r})"


def _row_nbytes(a) -> int:
    """Bytes of one row of a stacked leaf (a 0/1-d leaf counts one item)."""
    return (int(np.prod(a.shape[1:])) * a.element_size() if a.ndim > 1
            else a.element_size())


class _StackedBatch:
    """One dispatch's stacked ``[U, ...]`` output tree, kept whole: the
    store holds per-row :class:`StackedView` entries into it, and a chunk
    whose parents are all views of one batch gathers them with one
    ``index_select``."""

    __slots__ = ("tree", "n", "row_nbytes")

    def __init__(self, tree, n: int):
        self.tree = tree
        self.n = n
        self.row_nbytes = sum(_row_nbytes(a) for a in tree_leaves(tree)
                              if isinstance(a, torch.Tensor))

    @property
    def total_nbytes(self) -> int:
        return self.row_nbytes * self.n


class StackedView:
    """Store entry: row ``index`` of a :class:`_StackedBatch`.

    Owns no buffer; the store charges the WHOLE batch when its first view
    enters and releases it when its last view leaves, which is the real
    residency (the batch tensor lives while any view does).  The first
    materialisation memoises its slice."""

    __slots__ = ("batch", "index", "_sliced")

    def __init__(self, batch: _StackedBatch, index: int):
        self.batch = batch
        self.index = index
        self._sliced = None

    def materialize(self):
        if self._sliced is None:
            self._sliced = tree_map(lambda a: a[self.index], self.batch.tree)
        return self._sliced

    def __repr__(self):
        return f"StackedView(row {self.index} of [{self.batch.n}, ...])"


def _nbytes(act) -> int:
    """Buffer bytes of an activation (tensor or tree; :class:`PrefixRef`
    markers own none).  :class:`StackedView` entries are accounted at the
    batch level by the store, not here."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(act)
               if isinstance(a, torch.Tensor))


class ActivationStore:
    """LRU-bounded ``prefix key -> activation`` store.

    The staged evaluator keys an activation by the gene prefix that
    produced it (calibration batch, fault seed and per-device rates are
    fixed for a search, so the prefix IS the activation's provenance).
    ``max_bytes`` caps resident bytes; eviction is least-recently-used,
    skipping keys pinned for the current depth.  Eviction is a
    performance event, never a correctness one: the engine recomputes
    evicted prefixes on demand.
    """

    def __init__(self, max_bytes: int | None = None):
        self.max_bytes = max_bytes
        self._store: OrderedDict[tuple, object] = OrderedDict()
        self.nbytes = 0
        self.peak_nbytes = 0
        self.evictions = 0
        # id(batch) -> [live view count, bytes]; a counted batch is kept
        # alive by its remaining views, so its id stays valid
        self._batch_views: dict[int, list] = {}

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: tuple) -> bool:
        return key in self._store

    def get(self, key: tuple):
        act = self._store.get(key)
        if act is not None:
            self._store.move_to_end(key)
        return act

    def put(self, key: tuple, act, pinned: frozenset | set = frozenset()):
        if key in self._store:
            self._store.move_to_end(key)
            return
        self._store[key] = act
        self.nbytes += self._entry_bytes_add(act)
        if self.max_bytes is not None:
            self._evict(pinned)
        self.peak_nbytes = max(self.peak_nbytes, self.nbytes)

    def _entry_bytes_add(self, act) -> int:
        """Bytes newly resident because of this entry: a view charges its
        whole batch iff it is the batch's first stored view."""
        if isinstance(act, StackedView):
            rec = self._batch_views.get(id(act.batch))
            if rec is None:
                self._batch_views[id(act.batch)] = [1, act.batch.total_nbytes]
                return act.batch.total_nbytes
            rec[0] += 1
            return 0
        return _nbytes(act)

    def _entry_bytes_drop(self, act) -> int:
        """Bytes freed by dropping this entry (a batch goes with its LAST
        stored view)."""
        if isinstance(act, StackedView):
            rec = self._batch_views.get(id(act.batch))
            if rec is None:
                return 0
            rec[0] -= 1
            if rec[0] <= 0:
                del self._batch_views[id(act.batch)]
                return rec[1]
            return 0
        return _nbytes(act)

    def _evict(self, pinned):
        for key in list(self._store):
            if self.nbytes <= self.max_bytes:
                return
            if key in pinned:
                continue
            self.nbytes -= self._entry_bytes_drop(self._store.pop(key))
            self.evictions += 1
        # everything left is pinned: allow a transient overshoot rather
        # than evict activations the current depth is about to read

    def clear(self):
        self._store.clear()
        self._batch_views.clear()
        self.nbytes = 0


class PrefixEvalEngine:
    """Layer-wise population evaluation with gene-prefix deduplication
    (the reference's ``PrefixEvalEngine``; see its docstring for the full
    picture).  The engine walks depth ``i = 0..L-1`` and at each depth
    collects the unique prefixes ``P[:, :i+1]`` of the uncached rows,
    skips those already stored, runs unit *i* over the fresh ones in
    chunks of ``eval_batch_size`` rows, and stores the outputs.

    Callable contracts (``device_ids`` / ``genes`` are int64 tensors on
    ``device``):

        unit_fns[i](parent_acts, device_ids [U]) -> child_acts | accs
        segment_fn(start, length)(parent_acts, genes [U, length]) -> ...

    ``parent_acts`` is the stacked depth ``i-1`` activation (None at depth
    0: the callable closes over the calibration batch).  The final depth
    returns the ``[U]`` per-row metric, cached like the full engine's
    rows.  Per-row results must not depend on the batch-mates.

    Chain fusion (``segment_fn``): chains never cross a branch node, never
    cross a ``shared_fields`` keying depth, the final unit is always its
    own segment, and chains are cut on the buddy-aligned power-of-two span
    ladder (``start % length == 0``), so segment keys number at most
    ``~2·L``.  Fused and unfused walks are bitwise identical.

    Cost accounting: ``unit_runs`` counts unit executions (recompute
    fallbacks included); ``rows_evaluated * n_units`` is what the
    full-forward path would run, so ``unit_runs_avoided`` is the win.
    """

    def __init__(self, unit_fns: Sequence[Callable], n_units: int,
                 eval_batch_size: int | None = None,
                 max_store_bytes: int | None = None,
                 shared_fields: dict[str, int] | None = None,
                 segment_fn: Callable[[int, int], Callable] | None = None,
                 device: torch.device | str = "cpu"):
        assert len(unit_fns) == n_units, (len(unit_fns), n_units)
        self.unit_fns = unit_fns
        self.n_units = n_units
        self.eval_batch_size = eval_batch_size
        self.store = ActivationStore(max_store_bytes)
        self.shared_fields = dict(shared_fields or {})
        self.segment_fn = segment_fn       # None => unfused depth walk
        self.device = torch.device(device)
        self._cache: dict[tuple, float] = {}   # full row -> final metric
        self.dispatches = 0        # unit / segment calls
        self.rows_evaluated = 0    # unique uncached rows walked
        self.unit_runs = 0         # unit executions actually performed
        self.prefix_hits = 0       # needed prefixes found in the store
        self.recomputes = 0        # unit runs redone after LRU eviction
        self.views_stored = 0      # activations stored as StackedViews
        self.slices_materialized = 0  # views actually sliced out later
        self.chains = 0            # fused chains planned (incl. finals)
        self.fused_segments = 0    # ladder segments dispatched
        self.branch_nodes = 0      # trie nodes with >= 2 children seen
        self.max_chain = 0         # longest chain planned (pre-ladder)

    # -- derived stats -------------------------------------------------------
    @property
    def full_unit_runs(self) -> int:
        """Unit runs the full-forward batched path would have performed."""
        return self.rows_evaluated * self.n_units

    @property
    def unit_runs_avoided(self) -> int:
        return self.full_unit_runs - self.unit_runs

    def stats(self) -> dict:
        """The reference's counters; ``device_dispatches`` stays empty
        until the multi-device scheduler is ported."""
        needed = self.unit_runs - self.recomputes + self.prefix_hits
        return {
            "rows_evaluated": self.rows_evaluated,
            "unit_runs": self.unit_runs,
            "full_unit_runs": self.full_unit_runs,
            "unit_runs_avoided": self.unit_runs_avoided,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hits / max(needed, 1),
            "recomputes": self.recomputes,
            "evictions": self.store.evictions,
            "dispatches": self.dispatches,
            "device_dispatches": {},
            "store_entries": len(self.store),
            "store_bytes": self.store.nbytes,
            "chains": self.chains,
            "fused_segments": self.fused_segments,
            "branch_nodes": self.branch_nodes,
            "max_chain": self.max_chain,
            "views_stored": self.views_stored,
            "slices_materialized": self.slices_materialized,
            "unstack_slices_saved":
                self.views_stored - self.slices_materialized,
        }

    def clear(self):
        """Drop cached accuracies and activations (fault env changed)."""
        self._cache.clear()
        self.store.clear()

    # -- evaluation ----------------------------------------------------------
    @staticmethod
    def key(row: Sequence) -> tuple:
        return tuple(int(v) for v in row)

    def evaluate(self, P: np.ndarray) -> np.ndarray:
        """P: [N, L] int device rows -> [N] cached final-depth values."""
        P = np.asarray(P)
        assert P.ndim == 2 and P.shape[1] == self.n_units, P.shape
        keys = [self.key(row) for row in P]
        fresh: dict[tuple, None] = {}
        for k in keys:
            if k not in self._cache and k not in fresh:
                fresh[k] = None
        if fresh:
            self._run_rows(np.array(list(fresh), dtype=P.dtype))
        return np.array([self._cache[k] for k in keys])

    def _run_rows(self, R: np.ndarray):
        """Evaluate unique uncached rows: the chain-fused walk when a
        ``segment_fn`` is attached, the depth-by-depth walk otherwise.
        Final-depth results are gathered after every dispatch has gone out."""
        self.rows_evaluated += len(R)
        if self.segment_fn is not None:
            self._run_rows_fused(R)
        else:
            self._run_rows_staged(R)

    def _run_rows_staged(self, R: np.ndarray):
        """The depth walk: one dispatch group per depth."""
        L = self.n_units
        pending: list[tuple[list, list]] = []   # (prefixes, result chunks)
        for i in range(L):
            last = i == L - 1
            todo: dict[tuple, None] = {}
            seen: set[tuple] = set()
            for row in R:
                p = self.key(row[:i + 1])
                if p in seen:               # in-round sharing: counted via
                    continue                # unit_runs_avoided, not as a hit
                seen.add(p)
                if not last and p in self.store:
                    self.prefix_hits += 1   # one hit per unique prefix
                else:
                    todo[p] = None
            if not todo:
                continue
            group = list(todo)
            parents = None if i == 0 else \
                [self._parent_for(p[:-1]) for p in group]
            devs = np.array([[p[-1]] for p in group], np.int64)
            outs = self._dispatch_group(self.unit_fns[i], parents, devs,
                                        final=last, unit_axis=False)
            if last:
                pending.append((group, outs))
            else:
                self._store_group(group, outs, set(group))
            self.unit_runs += len(group)
        self._gather_final(pending)

    # -- chain-fused walk ---------------------------------------------------
    def _run_rows_fused(self, R: np.ndarray):
        """Plan non-branching chains over the fresh rows' prefix trie and
        dispatch each ``(start, length)`` segment group as one call."""
        L = self.n_units
        segments = self._plan_segments([self.key(row) for row in R])
        groups: dict[tuple, list] = {}
        for seg in segments:
            groups.setdefault((seg[0], seg[1]), []).append(seg)
        pending: list[tuple[list, list]] = []
        # ascending start: every parent-producing segment (ending at
        # start-1) has start' < start, so dependencies are satisfied
        for key in sorted(groups):
            start, length = key
            segs = groups[key]
            final = start + length == L
            fn = self.segment_fn(start, length)
            parents = None if start == 0 else \
                [self._parent_for(s[2]) for s in segs]
            genes = np.array([s[3] for s in segs], np.int64)  # [U, length]
            outs = self._dispatch_group(fn, parents, genes, final=final,
                                        unit_axis=True)
            keys = [s[2] + s[3] for s in segs]     # segment end prefixes
            if final:
                pending.append((keys, outs))
            else:
                # pin only the keys being stored: an evicted parent
                # re-enters through the recompute fallback
                self._store_group(keys, outs, set(keys))
            self.unit_runs += len(segs) * length
            self.fused_segments += len(segs)
        self._gather_final(pending)

    def _plan_segments(self, rows: list) -> list:
        """Plan the fused walk: ``[(start, length, parent_prefix, genes)]``
        covering every unit run the fresh ``rows`` need.

        1. Build the rows' prefix trie (insertion order = population
           order).
        2. Per row, resume from the DEEPEST stored prefix (one
           ``prefix_hits`` count per unique resume point); everything
           below it down to depth L-2 is *needed*.
        3. Extract maximal chains: a chain extends through nodes with
           exactly one needed child and stops at branch nodes, at
           ``shared_fields`` keying depths, and before the final unit.
        4. Split each chain on the buddy-aligned power-of-two ladder: each
           piece takes the largest power-of-two length that divides its
           start (any length at start 0) and fits the remainder.
        """
        L = self.n_units
        kids: dict[tuple, dict] = {(): {}}
        for r in rows:
            p = ()
            for g in r:
                kids.setdefault(p, {}).setdefault(g, None)
                p += (g,)
            kids.setdefault(p, {})
        self.branch_nodes += sum(1 for c in kids.values() if len(c) >= 2)

        need: dict[tuple, None] = {}       # ordered set, parents first
        hits: set = set()
        for r in rows:
            d = L - 1                      # deepest proper prefix to probe
            while d > 0 and r[:d] not in self.store:
                d -= 1
            if d > 0 and r[:d] not in hits:
                hits.add(r[:d])
                self.prefix_hits += 1
            for dd in range(d + 1, L):
                need.setdefault(r[:dd])
        need_children: dict[tuple, list] = {}
        for p in need:
            need_children.setdefault(p[:-1], []).append(p[-1])

        cut = set(self.shared_fields.values())
        chains: list[tuple[tuple, list]] = []   # (parent_prefix, genes)
        for p in need:                     # parents precede children
            par = p[:-1]
            if (par in need and len(need_children.get(par, ())) == 1
                    and (len(par) - 1) not in cut):
                continue                   # p extends its parent's chain
            genes = [p[-1]]
            cur = p
            while True:
                nc = need_children.get(cur, ())
                if len(nc) != 1 or (len(cur) - 1) in cut:
                    break
                cur += (nc[0],)
                genes.append(nc[0])
            chains.append((par, genes))
            self.max_chain = max(self.max_chain, len(genes))
        # every row's final unit: its own length-1 chain/segment
        finals = [(r[:L - 1], [r[L - 1]]) for r in rows]
        self.chains += len(chains) + len(finals)

        segments: list[tuple[int, int, tuple, tuple]] = []
        for par, genes in chains + finals:
            s, m, off = len(par), len(genes), 0
            while m:
                ln = 1 << (m.bit_length() - 1)
                at = s + off
                if at:
                    ln = min(ln, at & -at)     # buddy alignment
                segments.append((at, ln, par + tuple(genes[:off]),
                                 tuple(genes[off:off + ln])))
                off += ln
                m -= ln
        return segments

    # -- storage / materialisation -------------------------------------------
    def _use_views(self) -> bool:
        """Views cannot rewrite one row's shared carry field, so engines
        with ``shared_fields`` keep eager per-row entries."""
        return not self.shared_fields

    def _store_group(self, keys: list, chunks: list, pin: set):
        """Store one dispatch group's outputs: per-row
        :class:`StackedView` entries into the intact batch, or eager
        per-row slices when shared-field interning must rewrite fields."""
        j = 0
        for batch, n in chunks:
            rows = keys[j:j + n]
            if self._use_views():
                for r, key in enumerate(rows):
                    self.store.put(key, StackedView(batch, r), pinned=pin)
                self.views_stored += n
            else:
                for r, key in enumerate(rows):
                    act = tree_map(lambda a, r=r: a[r], batch.tree)
                    self.store.put(key, self._intern(key, act), pinned=pin)
            j += n

    def _gather_final(self, pending: list):
        """The once-per-call gather: one host copy per chunk."""
        for keys, chunks in pending:
            j = 0
            for out, n in chunks:
                vals = np.asarray(out.detach().cpu()
                                  if isinstance(out, torch.Tensor) else out)
                for p, v in zip(keys[j:j + n], vals[:n]):
                    self._cache[p] = float(v)
                j += n

    def _intern(self, prefix: tuple, act):
        """Replace shared carry fields (deeper than their keying depth)
        with :class:`PrefixRef` markers before storing."""
        if not self.shared_fields or not isinstance(act, dict):
            return act
        out = act
        for field, depth in self.shared_fields.items():
            if (len(prefix) > depth + 1 and field in out
                    and not isinstance(out[field], PrefixRef)):
                if out is act:
                    out = dict(act)
                out[field] = PrefixRef(prefix[:depth + 1])
        return out

    def _resolve(self, act):
        """Materialise :class:`PrefixRef` fields of a stored activation
        (recomputing the referenced prefix if it was evicted)."""
        if not self.shared_fields or not isinstance(act, dict) \
                or not any(isinstance(v, PrefixRef) for v in act.values()):
            return act
        return {k: self._ensure_act(v.prefix) if isinstance(v, PrefixRef)
                else v for k, v in act.items()}

    def _materialize(self, entry):
        """A stored entry as a standalone activation: slice a view out of
        its batch (counted, memoised) or resolve shared-field refs."""
        if isinstance(entry, StackedView):
            if entry._sliced is None:
                self.slices_materialized += 1
            return entry.materialize()
        return self._resolve(entry)

    def _parent_for(self, prefix: tuple):
        """Stored entry for a parent prefix (a :class:`StackedView` is
        returned as is, so chunk assembly can gather), or the recompute
        fallback when LRU eviction dropped it."""
        act = self.store.get(prefix)
        if act is not None:
            return act
        return self._recompute(prefix)

    def _ensure_act(self, prefix: tuple):
        """Resolved standalone activation for ``prefix``."""
        return self._materialize(self._parent_for(prefix))

    def _recompute(self, prefix: tuple):
        """The eviction fallback: re-run unit ``len(prefix)-1`` for one
        prefix (recursing up the chain as needed) and re-store it."""
        i = len(prefix) - 1
        parents = None if i == 0 else [self._parent_for(prefix[:-1])]
        devs = np.array([[prefix[-1]]], np.int64)
        outs = self._dispatch_group(self.unit_fns[i], parents, devs,
                                    final=False, unit_axis=False)
        batch, _ = outs[0]
        act = tree_map(lambda a: a[0], batch.tree)
        self.unit_runs += 1
        self.recomputes += 1
        self.store.put(prefix, self._intern(prefix, act), pinned={prefix})
        return act

    def _stack_chunk(self, parents: list):
        """One chunk's stacked parent activations: a single
        ``index_select`` when every parent is a view into ONE batch, else
        the materialised rows stacked."""
        first = parents[0]
        if (len(parents) > 1 and isinstance(first, StackedView)
                and all(isinstance(p, StackedView) and p.batch is first.batch
                        for p in parents)):
            idx = None
            out = []
            for a in tree_leaves(first.batch.tree):
                if idx is None:
                    idx = to_device_index(
                        np.array([p.index for p in parents]), a.device)
                out.append(a.index_select(0, idx))
            it = iter(out)
            return tree_map(lambda _: next(it), first.batch.tree)
        mats = [self._materialize(p) for p in parents]
        return tree_map(lambda *xs: torch.stack(xs), *mats)

    def _dispatch_group(self, fn: Callable, parents: list | None,
                        genes: np.ndarray, final: bool,
                        unit_axis: bool = True) -> list:
        """Chunked calls of one unit or fused segment over its
        ``[U, length]`` gene rows.  Non-final chunks come back as
        ``(_StackedBatch, n)``; the final depth returns the un-synced
        ``(result, n)`` pairs gathered after every dispatch has gone out.
        ``unit_axis=False`` strips the gene axis for the single-unit
        contract (``devs: [U]``)."""
        outs: list = []
        for start, stop, _ in chunked_rows(len(genes), self.eval_batch_size):
            g = genes[start:stop]
            g_t = to_device_index(g if unit_axis else g[:, 0], self.device)
            acts = None if parents is None else \
                self._stack_chunk(parents[start:stop])
            out = fn(acts, g_t)
            self.dispatches += 1
            n = stop - start
            outs.append((out, n) if final else (_StackedBatch(out, n), n))
        return outs


class PopulationEvalEngine:
    """Dedup + cache + chunked evaluation of integer rows.

    ``batch_fn(rows [U, L]) -> [U]`` evaluates one chunk and may return a
    device tensor: results are brought to the host once, after every
    chunk has been issued.
    """

    def __init__(self, batch_fn: Callable[[np.ndarray], object],
                 eval_batch_size: int | None = None):
        self.batch_fn = batch_fn
        self.eval_batch_size = eval_batch_size
        self._cache: dict[tuple, float] = {}
        self.dispatches = 0          # batch_fn calls
        self.rows_evaluated = 0      # unique rows actually computed

    @staticmethod
    def key(row: Sequence) -> tuple:
        return tuple(int(v) for v in row)

    def evaluate(self, P: np.ndarray) -> np.ndarray:
        """``P [N, L]`` integer rows -> ``[N]`` cached ``batch_fn`` values."""
        P = np.asarray(P)
        keys = [self.key(row) for row in P]
        fresh: dict[tuple, int] = {}
        for i, k in enumerate(keys):
            if k not in self._cache and k not in fresh:
                fresh[k] = i
        if fresh:
            rows = P[list(fresh.values())]
            fresh_keys = list(fresh)
            pending = []
            for start, stop, padded in chunked_rows(len(rows),
                                                    self.eval_batch_size):
                val = self.batch_fn(pad_rows(rows[start:stop], padded))
                self.dispatches += 1
                self.rows_evaluated += stop - start
                pending.append((fresh_keys[start:stop], val, stop - start))
            for chunk_keys, val, n in pending:
                vals = np.asarray(val.cpu() if hasattr(val, "cpu") else val)
                for k, v in zip(chunk_keys, vals[:n]):
                    self._cache[k] = float(v)
        return np.array([self._cache[k] for k in keys])


# --------------------------------------------------------------------------
# eval_batch_size="auto": the reference probes XLA's compiled memory
# analysis; here a probe runs the dispatch and reads the allocator's peak
# --------------------------------------------------------------------------
def peak_memory_bytes(fn: Callable[[], object], device: torch.device) -> int:
    """Device bytes ``fn()`` allocates at its peak above what was already
    allocated (``torch.cuda`` allocator statistics); 0 off the card, where
    there is no such statistic.  Garbage is collected first: tensors held
    only by reference cycles (a dropped evaluator's) would count in the
    baseline, and a collection the interpreter starts inside ``fn`` would
    free them there and lower the reading by their bytes."""
    if device.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    del out
    return max(int(peak), 0)


def device_memory_budget(default: int = 2 << 30,
                         device: torch.device | None = None) -> int:
    """Bytes of device memory the evaluator may plan against.

    Order: ``REPRO_EVAL_MEM_BUDGET`` (bytes; an explicit operator cap) ->
    the card's memory -> a quarter of host RAM -> ``default``.  On the
    card the figure is ``torch.cuda.mem_get_info``'s FREE bytes plus what
    PyTorch's allocator has reserved but not handed out: the probe
    (:func:`peak_memory_bytes`) measures bytes above the current
    allocation, so the budget is what is left beyond it.  The TOTAL would
    count the resident params, tables and store twice, and the free bytes
    alone would miss the allocator's cached blocks, which it reuses first.
    """
    env = os.environ.get("REPRO_EVAL_MEM_BUDGET")
    if env:
        return int(env)
    if device is not None and device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(free + cached)
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page > 0:
            return pages * page // 4
    except (ValueError, OSError, AttributeError):
        pass
    return default


def auto_eval_batch_size(probe: Callable[[int], int],
                         budget: int | None = None,
                         reserved: int = 0,
                         max_rows: int = 1024,
                         device: torch.device | None = None) -> int | None:
    """The largest power-of-two chunk whose footprint fits the budget.

    ``probe(n_rows)`` returns the peak device bytes of an ``n_rows``
    dispatch.  Two probes (1 and 2 rows) give the per-row slope and the
    fixed intercept; ``reserved`` carves out bytes the caller keeps
    resident across dispatches (the staged store's cap).  Returns None
    when the probe reports nothing or no per-row slope (no sizing
    information, so no cap); the floor is 1 row.
    """
    p1, p2 = probe(1), probe(2)
    if p1 <= 0 or p2 <= 0 or p2 <= p1:
        return None
    per_row = p2 - p1
    fixed = max(p1 - per_row, 0)
    avail = budget if budget is not None else device_memory_budget(
        device=device)
    avail -= reserved + fixed
    n = 1
    while n * 2 <= max_rows and (n * 2) * per_row <= avail:
        n *= 2
    return n
