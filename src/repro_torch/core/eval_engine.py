"""Population-level evaluation engine, the counterpart of
``repro/core/eval_engine.py``.

Three layers, one contract:

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

3. **Device scheduler** (:class:`DeviceScheduler`) — the sharded path.
   Both engines accept a scheduler over a pool of device slots
   (``launch/mesh.make_eval_mesh``).  The full engine round-robins its
   chunks over the slots; the prefix engine places by *prefix group*:
   every prefix under one depth-0 gene lands on one slot, so parent
   activations, their children and any shared carry (:class:`PrefixRef`)
   stay on one device.  The pool is an ordered list of devices in which a
   device may repeat (``[cpu] * 4``, ``[cuda:0] * 4``: several slots on
   one device, as the reference's fake host devices are); by default it
   is the local cards.  With one slot (or no scheduler) both engines run
   the single-device path.

Per-row results must be independent of the other rows in the batch, so
chunk boundaries and placement never change values.  The staged walk does
NOT pad its chunks: the reference pads to power-of-two buckets so that XLA
compiles few shapes, but in eager PyTorch a padding row costs a full
per-row convolution and serves no compile cache.  Chunk boundaries, and so
every counter, are the reference's (``chunked_rows``).

Device discipline: activations and final-depth results stay on their
device until the once-per-call gather (:func:`gather_host`) brings every
chunk's results to the host in one copy; gene indices go to the card from
pinned memory without blocking (:meth:`DeviceScheduler.put`), so no
dispatch waits for the device.  The ``batch_fn`` contract of the
population engine is ``batch_fn(rows [U, L]) -> [U]``, and with a
multi-slot scheduler ``batch_fn(rows, device=...)``, which must run the
chunk on that device and may return the un-synced tensor.
"""
from __future__ import annotations

import gc
import os
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.launch.mesh import local_devices, make_eval_mesh
from repro_torch.trace import span, spanned

__all__ = ["PopulationEvalEngine", "PrefixEvalEngine", "ActivationStore",
           "DeviceScheduler", "PrefixRef", "StackedView", "chunked_rows",
           "bucket_size", "pad_rows", "gather_host", "parse_eval_batch_size",
           "parse_devices", "auto_eval_batch_size", "device_memory_budget",
           "peak_memory_bytes"]


def parse_eval_batch_size(value) -> int | str | None:
    """The CLI/config grammar for ``eval_batch_size``: ``None`` and
    ``"auto"`` pass through, anything else must be a positive int."""
    if value in (None, "auto"):
        return value
    n = int(value)
    if n < 1:
        raise ValueError(f"eval_batch_size must be >= 1, got {n}")
    return n


def parse_devices(value) -> int | str | None:
    """The CLI/config grammar for the ``devices`` knob: ``None`` (leave the
    evaluator's setting alone) and ``"auto"`` (every device of the pool)
    pass through, anything else must be a positive device count."""
    if value is None or value == "auto":
        return value
    n = int(value)
    if n < 1:
        raise ValueError(f"devices must be >= 1, got {n}")
    return n


class DeviceScheduler:
    """Placement of evaluation dispatches over a pool of device slots.

    ``devices="auto"`` takes every slot of ``pool``, an int the first ``n``
    (raising when the pool has fewer), and a list of devices is the pool
    itself.  ``pool`` defaults to the local cards (``cuda:0 .. count-1``;
    without a card that raises, and the caller passes its pool); a device
    may repeat in it, which gives one
    device several slots.  The slots are enumerated through
    ``launch/mesh.make_eval_mesh``, so the engines and the launch stack
    agree on device order.

    Placement is committed-input scheduling: a chunk's inputs are put on
    ``device_for(i)`` (or a slot the engine picked) and the chunk runs
    there; per-row results do not depend on the device, so placement never
    changes values.
    """

    def __init__(self, devices="auto", pool=None):
        if isinstance(devices, (list, tuple)):
            pool, n = list(devices), len(devices)
        else:
            pool = local_devices() if pool is None else list(pool)
            spec = parse_devices(devices)
            n = len(pool) if spec in (None, "auto") else spec
            if n > len(pool):
                raise ValueError(
                    f"devices={n} requested but the pool holds "
                    f"{len(pool)} devices; pass a pool with a device "
                    f"repeated (devices=[dev] * {n}) for several slots on "
                    f"one device")
        self.mesh = make_eval_mesh(n, pool)
        self.devices = list(self.mesh.devices.flat)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device_for(self, i: int) -> torch.device:
        """Round-robin slot for the ``i``-th chunk of a batch."""
        return self.devices[i % len(self.devices)]

    @staticmethod
    def put(array, device: torch.device | None) -> torch.Tensor:
        """THE placement idiom: a host array as a tensor on ``device`` (the
        host when None).  On a card the copy is pinned and sent without
        blocking (a pageable copy would wait for the stream); PyTorch's
        pinned-memory cache keeps the buffer until the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device is not None and device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t if device is None else t.to(device)


def gather_host(values: list) -> list[np.ndarray]:
    """Host arrays of a call's chunk results with ONE wait for them all:
    the results left on cards are brought to the first of those cards (a
    peer copy in the stream's order, no wait) and copied to the host once;
    results already on the host are read as they are."""
    out: list = [None] * len(values)
    on_card = [i for i, v in enumerate(values)
               if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
    if on_card:
        dev = values[on_card[0]].device
        parts = [values[i].detach().reshape(-1).to(dev, non_blocking=True)
                 for i in on_card]
        flat = torch.cat(parts).cpu().numpy()
        j = 0
        for i, p in zip(on_card, parts):
            out[i] = flat[j:j + p.numel()].reshape(values[i].shape)
            j += p.numel()
    for i, v in enumerate(values):
        if out[i] is None:
            out[i] = np.asarray(v.detach() if isinstance(v, torch.Tensor)
                                else v)
    return out


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
    """An int64 index tensor on ``device`` (:meth:`DeviceScheduler.put`)."""
    return DeviceScheduler.put(np.asarray(a, np.int64), device)


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
    evicted prefixes on demand.  Each entry records the scheduler slot it
    lives on (None without a multi-slot scheduler).
    """

    def __init__(self, max_bytes: int | None = None):
        self.max_bytes = max_bytes
        self._store: OrderedDict[tuple, object] = OrderedDict()
        self._slot: dict[tuple, int | None] = {}
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

    def slot_of(self, key: tuple) -> int | None:
        return self._slot.get(key)

    def put(self, key: tuple, act, pinned: frozenset | set = frozenset(),
            slot: int | None = None):
        if key in self._store:
            self._store.move_to_end(key)
            return
        self._store[key] = act
        self._slot[key] = slot
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
            del self._slot[key]
            self.evictions += 1
        # everything left is pinned: allow a transient overshoot rather
        # than evict activations the current depth is about to read

    def clear(self):
        self._store.clear()
        self._slot.clear()
        self._batch_views.clear()
        self.nbytes = 0


class PrefixEvalEngine:
    """Layer-wise population evaluation with gene-prefix deduplication
    (the reference's ``PrefixEvalEngine``; see its docstring for the full
    picture).  The engine walks depth ``i = 0..L-1`` and at each depth
    collects the unique prefixes ``P[:, :i+1]`` of the uncached rows,
    skips those already stored, runs unit *i* over the fresh ones in
    chunks of ``eval_batch_size`` rows, and stores the outputs.

    Callable contracts (``device_ids`` / ``genes`` are int64 tensors on the
    device the call runs on, which the callable reads from them):

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

    Placement: with a multi-slot ``scheduler`` each depth-0 gene takes a
    slot round-robin in first-seen order and every prefix under it stays
    there (``_device_index``), so a dispatch group is ``(depth, slot)`` in
    the depth walk and ``(start, length, slot)`` in the fused walk; gene
    indices go to the slot's device, parents are already there.  Each store
    entry records its slot and every read checks it, so an activation never
    feeds a dispatch on another slot (on one device nothing else would
    catch that).  ``max_store_bytes`` caps the ONE store all slots share.

    Cost accounting: ``unit_runs`` counts unit executions (recompute
    fallbacks included); ``rows_evaluated * n_units`` is what the
    full-forward path would run, so ``unit_runs_avoided`` is the win.
    ``rows_requested`` and ``rows_cached`` count the rows handed to
    ``evaluate`` and those the row cache answered; ``stats()`` leaves them
    out and stays the reference's.
    """

    def __init__(self, unit_fns: Sequence[Callable], n_units: int,
                 eval_batch_size: int | None = None,
                 max_store_bytes: int | None = None,
                 scheduler: DeviceScheduler | None = None,
                 shared_fields: dict[str, int] | None = None,
                 segment_fn: Callable[[int, int], Callable] | None = None,
                 device: torch.device | str = "cpu"):
        assert len(unit_fns) == n_units, (len(unit_fns), n_units)
        self.unit_fns = unit_fns
        self.n_units = n_units
        self.eval_batch_size = eval_batch_size
        self.store = ActivationStore(max_store_bytes)
        self.scheduler = scheduler
        self.shared_fields = dict(shared_fields or {})
        self.segment_fn = segment_fn       # None => unfused depth walk
        self.device = torch.device(device)   # the single-slot device
        self._root_device: dict[int, int] = {}  # depth-0 gene -> slot
        self._cache: dict[tuple, float] = {}   # full row -> final metric
        self.dispatches = 0        # unit / segment calls
        self.device_dispatches: dict[int, int] = {}  # slot -> calls
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
        self.rows_requested = 0    # rows handed to evaluate
        self.rows_cached = 0       # of those, rows the row cache answered

    # -- derived stats -------------------------------------------------------
    @property
    def full_unit_runs(self) -> int:
        """Unit runs the full-forward batched path would have performed."""
        return self.rows_evaluated * self.n_units

    @property
    def unit_runs_avoided(self) -> int:
        return self.full_unit_runs - self.unit_runs

    def stats(self) -> dict:
        """The reference's counters."""
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
            "device_dispatches": dict(self.device_dispatches),
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

    def reset_placement(self):
        """Forget the prefix-group slots, the per-slot dispatch counts AND
        the stored activations (they live on the old pool's devices)."""
        self._root_device.clear()
        self.device_dispatches.clear()
        self.store.clear()

    # -- evaluation ----------------------------------------------------------
    @staticmethod
    def key(row: Sequence) -> tuple:
        return tuple(int(v) for v in row)

    def evaluate(self, P: np.ndarray) -> np.ndarray:
        """P: [N, L] int device rows -> [N] cached final-depth values."""
        P = np.asarray(P)
        assert P.ndim == 2 and P.shape[1] == self.n_units, P.shape
        with span("engine.plan"):
            keys = [self.key(row) for row in P]
            fresh: dict[tuple, None] = {}
            cached = 0
            for k in keys:
                if k in self._cache:
                    cached += 1
                elif k not in fresh:
                    fresh[k] = None
        self.rows_requested += len(keys)
        self.rows_cached += cached
        if fresh:
            self._run_rows(np.array(list(fresh), dtype=P.dtype))
        return np.array([self._cache[k] for k in keys])

    def _multi(self) -> DeviceScheduler | None:
        """The scheduler iff it actually places (> 1 slot)."""
        s = self.scheduler
        return s if s is not None and s.n_devices > 1 else None

    def _device_index(self, prefix: tuple) -> int:
        """Slot of a prefix: its depth-0 gene's slot (depth-0 genes take the
        slots round-robin in first-seen order, deterministic because
        prefixes are walked in population order).  Children inherit it, so
        a whole prefix subtree lives on one slot."""
        root = int(prefix[0])
        if root not in self._root_device:
            self._root_device[root] = \
                len(self._root_device) % self.scheduler.n_devices
        return self._root_device[root]

    def _run_rows(self, R: np.ndarray):
        """Evaluate unique uncached rows: the chain-fused walk when a
        ``segment_fn`` is attached, the depth-by-depth walk otherwise.
        Final-depth results are gathered after every dispatch has gone
        out, so the slots' devices run their chunks concurrently."""
        self.rows_evaluated += len(R)
        if self.segment_fn is not None:
            self._run_rows_fused(R)
        else:
            self._run_rows_staged(R)

    def _run_rows_staged(self, R: np.ndarray):
        """The depth walk: one dispatch group per (depth, slot)."""
        L = self.n_units
        sched = self._multi()
        pending: list[tuple[list, list]] = []   # (prefixes, result chunks)
        for i in range(L):
            last = i == L - 1
            with span("engine.plan"):
                todo: dict[tuple, None] = {}
                seen: set[tuple] = set()
                for row in R:
                    p = self.key(row[:i + 1])
                    if p in seen:           # in-round sharing: counted via
                        continue            # unit_runs_avoided, not a hit
                    seen.add(p)
                    if not last and p in self.store:
                        self.prefix_hits += 1   # one hit per unique prefix
                    else:
                        todo[p] = None
                prefixes = list(todo)
                if sched is None:
                    groups = [(None, prefixes)]
                else:
                    by_dev: dict[int, list] = {}
                    for p in prefixes:
                        by_dev.setdefault(self._device_index(p),
                                          []).append(p)
                    groups = [(d, by_dev[d]) for d in sorted(by_dev)]
            if not todo:
                continue
            pin = set(prefixes)
            for dev_idx, group in groups:
                parents = None if i == 0 else \
                    [self._parent_for(p[:-1], dev_idx) for p in group]
                devs = np.array([[p[-1]] for p in group], np.int64)
                outs = self._dispatch_group(self.unit_fns[i], parents, devs,
                                            final=last, dev_idx=dev_idx,
                                            unit_axis=False)
                if last:
                    pending.append((group, outs))
                else:
                    self._store_group(group, outs, pin, dev_idx)
                self.unit_runs += len(group)
        self._gather_final(pending)

    # -- chain-fused walk ---------------------------------------------------
    def _run_rows_fused(self, R: np.ndarray):
        """Plan non-branching chains over the fresh rows' prefix trie and
        dispatch each ``(start, length, slot)`` segment group as one
        call."""
        L = self.n_units
        sched = self._multi()
        segments = self._plan_segments([self.key(row) for row in R])
        groups: dict[tuple, list] = {}
        for seg in segments:
            start, length, parent, genes = seg
            dev_idx = None if sched is None \
                else self._device_index(parent + genes)
            groups.setdefault((start, length, dev_idx), []).append(seg)
        pending: list[tuple[list, list]] = []
        # ascending start: every parent-producing segment (ending at
        # start-1) has start' < start, so dependencies are satisfied
        order = sorted(groups, key=lambda t: (
            t[0], t[1], -1 if t[2] is None else t[2]))
        for key in order:
            start, length, dev_idx = key
            segs = groups[key]
            final = start + length == L
            fn = self.segment_fn(start, length)
            parents = None if start == 0 else \
                [self._parent_for(s[2], dev_idx) for s in segs]
            genes = np.array([s[3] for s in segs], np.int64)  # [U, length]
            outs = self._dispatch_group(fn, parents, genes, final=final,
                                        dev_idx=dev_idx, unit_axis=True)
            keys = [s[2] + s[3] for s in segs]     # segment end prefixes
            if final:
                pending.append((keys, outs))
            else:
                # pin only the keys being stored: an evicted parent
                # re-enters through the recompute fallback
                self._store_group(keys, outs, set(keys), dev_idx)
            self.unit_runs += len(segs) * length
            self.fused_segments += len(segs)
        self._gather_final(pending)

    @spanned("engine.plan")
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

    @spanned("engine.store")
    def _store_group(self, keys: list, chunks: list, pin: set,
                     slot: int | None):
        """Store one dispatch group's outputs on its slot: per-row
        :class:`StackedView` entries into the intact batch, or eager
        per-row slices when shared-field interning must rewrite fields."""
        j = 0
        for batch, n in chunks:
            rows = keys[j:j + n]
            if self._use_views():
                for r, key in enumerate(rows):
                    self.store.put(key, StackedView(batch, r), pinned=pin,
                                   slot=slot)
                self.views_stored += n
            else:
                for r, key in enumerate(rows):
                    act = tree_map(lambda a, r=r: a[r], batch.tree)
                    self.store.put(key, self._intern(key, act), pinned=pin,
                                   slot=slot)
            j += n

    @spanned("engine.gather")
    def _gather_final(self, pending: list):
        """The once-per-call gather: every chunk's results in one host
        copy (:func:`gather_host`)."""
        chunks = []
        for keys, outs in pending:
            j = 0
            for out, n in outs:
                chunks.append((keys[j:j + n], out, n))
                j += n
        vals = gather_host([out for _, out, _ in chunks])
        for (keys, _, n), v in zip(chunks, vals):
            for p, x in zip(keys, v[:n]):
                self._cache[p] = float(x)

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

    def _resolve(self, act, slot: int | None):
        """Materialise :class:`PrefixRef` fields of a stored activation
        from the same slot (recomputing the referenced prefix if it was
        evicted)."""
        if not self.shared_fields or not isinstance(act, dict) \
                or not any(isinstance(v, PrefixRef) for v in act.values()):
            return act
        return {k: self._ensure_act(v.prefix, slot)
                if isinstance(v, PrefixRef) else v for k, v in act.items()}

    def _materialize(self, entry, slot: int | None):
        """A stored entry as a standalone activation: slice a view out of
        its batch (counted, memoised) or resolve shared-field refs."""
        if isinstance(entry, StackedView):
            if entry._sliced is None:
                self.slices_materialized += 1
            return entry.materialize()
        return self._resolve(entry, slot)

    def _parent_for(self, prefix: tuple, slot: int | None):
        """Stored entry for a parent prefix on ``slot`` (a
        :class:`StackedView` is returned as is, so chunk assembly can
        gather), or the recompute fallback when LRU eviction dropped it."""
        act = self.store.get(prefix)
        if act is None:
            return self._recompute(prefix)
        if self.store.slot_of(prefix) != slot:
            raise RuntimeError(
                f"prefix {prefix} is stored on slot "
                f"{self.store.slot_of(prefix)} but read for slot {slot}")
        return act

    def _ensure_act(self, prefix: tuple, slot: int | None):
        """Resolved standalone activation for ``prefix`` on ``slot``."""
        return self._materialize(self._parent_for(prefix, slot), slot)

    @spanned("engine.recompute")
    def _recompute(self, prefix: tuple):
        """The eviction fallback: re-run unit ``len(prefix)-1`` for one
        prefix on its slot (recursing up the chain as needed) and re-store
        it."""
        i = len(prefix) - 1
        dev_idx = None if self._multi() is None else \
            self._device_index(prefix)
        parents = None if i == 0 else [self._parent_for(prefix[:-1], dev_idx)]
        devs = np.array([[prefix[-1]]], np.int64)
        outs = self._dispatch_group(self.unit_fns[i], parents, devs,
                                    final=False, dev_idx=dev_idx,
                                    unit_axis=False)
        batch, _ = outs[0]
        act = tree_map(lambda a: a[0], batch.tree)
        self.unit_runs += 1
        self.recomputes += 1
        self.store.put(prefix, self._intern(prefix, act), pinned={prefix},
                       slot=dev_idx)
        return act

    @spanned("engine.stack")
    def _stack_chunk(self, parents: list, slot: int | None):
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
        mats = [self._materialize(p, slot) for p in parents]
        return tree_map(lambda *xs: torch.stack(xs), *mats)

    def _dispatch_group(self, fn: Callable, parents: list | None,
                        genes: np.ndarray, final: bool,
                        dev_idx: int | None = None,
                        unit_axis: bool = True) -> list:
        """Chunked calls of one unit or fused segment over its
        ``[U, length]`` gene rows, on slot ``dev_idx``'s device (the
        engine's own without a slot; the parents are there already).
        Non-final chunks come back as ``(_StackedBatch, n)``; the final
        depth returns the un-synced ``(result, n)`` pairs gathered after
        every dispatch has gone out.  ``unit_axis=False`` strips the gene
        axis for the single-unit contract (``devs: [U]``)."""
        device = self.device if dev_idx is None \
            else self.scheduler.devices[dev_idx]
        outs: list = []
        for start, stop, _ in chunked_rows(len(genes), self.eval_batch_size):
            with span("engine.dispatch"):
                g = genes[start:stop]
                g_t = to_device_index(g if unit_axis else g[:, 0], device)
                acts = None if parents is None else \
                    self._stack_chunk(parents[start:stop], dev_idx)
                out = fn(acts, g_t)
            self.dispatches += 1
            if dev_idx is not None:
                self.device_dispatches[dev_idx] = \
                    self.device_dispatches.get(dev_idx, 0) + 1
            n = stop - start
            outs.append((out, n) if final else (_StackedBatch(out, n), n))
        return outs


class PopulationEvalEngine:
    """Dedup + cache + chunked evaluation of integer rows.

    ``batch_fn(rows [U, L]) -> [U]`` evaluates one chunk and may return a
    device tensor.  With a multi-slot :class:`DeviceScheduler` the chunks
    go round-robin over the slots (``batch_fn(rows, device=...)``), and
    without an ``eval_batch_size`` the unique rows split evenly over them
    (``ceil(U / n)`` a chunk).  Results come to the host once, after every
    chunk has been issued (:func:`gather_host`), so the devices run their
    chunks concurrently.  One slot (or no scheduler) is the single-device
    path.
    """

    def __init__(self, batch_fn: Callable[[np.ndarray], object],
                 eval_batch_size: int | None = None,
                 scheduler: DeviceScheduler | None = None):
        self.batch_fn = batch_fn
        self.eval_batch_size = eval_batch_size
        self.scheduler = scheduler
        self._cache: dict[tuple, float] = {}
        self.dispatches = 0          # batch_fn calls
        self.rows_evaluated = 0      # unique rows actually computed
        self.rows_requested = 0      # rows handed to evaluate
        self.rows_cached = 0         # of those, rows the row cache answered

    @staticmethod
    def key(row: Sequence) -> tuple:
        return tuple(int(v) for v in row)

    def evaluate(self, P: np.ndarray) -> np.ndarray:
        """``P [N, L]`` integer rows -> ``[N]`` cached ``batch_fn`` values."""
        P = np.asarray(P)
        with span("engine.plan"):
            keys = [self.key(row) for row in P]
            fresh: dict[tuple, int] = {}
            cached = 0
            for i, k in enumerate(keys):
                if k in self._cache:
                    cached += 1
                elif k not in fresh:
                    fresh[k] = i
        self.rows_requested += len(keys)
        self.rows_cached += cached
        if fresh:
            rows = P[list(fresh.values())]
            fresh_keys = list(fresh)
            sched = self.scheduler
            if sched is not None and sched.n_devices <= 1:
                sched = None
            ebs = self.eval_batch_size
            if ebs is None and sched is not None:
                ebs = -(-len(rows) // sched.n_devices)
            pending = []
            for ci, (start, stop, padded) in enumerate(
                    chunked_rows(len(rows), ebs)):
                with span("engine.dispatch"):
                    chunk = pad_rows(rows[start:stop], padded)
                    if sched is not None:
                        val = self.batch_fn(chunk,
                                            device=sched.device_for(ci))
                    else:
                        val = self.batch_fn(chunk)
                self.dispatches += 1
                self.rows_evaluated += stop - start
                pending.append((fresh_keys[start:stop], val, stop - start))
            with span("engine.gather"):
                vals = gather_host([val for _, val, _ in pending])
                for (chunk_keys, _, n), v in zip(pending, vals):
                    for k, x in zip(chunk_keys, v[:n]):
                        self._cache[k] = float(x)
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


def device_memory_budget(default: int = 2 << 30, n_devices: int = 1,
                         device: torch.device | None = None) -> int:
    """Bytes of memory the evaluator may plan against on ONE device,
    shared by ``n_devices`` slots.

    Order: ``REPRO_EVAL_MEM_BUDGET`` (bytes per device; an explicit
    operator cap is never rescaled) -> the card's memory over the slots on
    it -> a quarter of host RAM over ``n_devices`` (host slots share the
    one RAM, as the reference's fake host devices do) -> ``default /
    n_devices``.  On a card the figure is ``torch.cuda.mem_get_info``'s
    FREE bytes plus what PyTorch's allocator has reserved but not handed
    out: the probe (:func:`peak_memory_bytes`) measures bytes above the
    current allocation, so the budget is what is left beyond it.  The TOTAL
    would count the resident params, tables and store twice, and the free
    bytes alone would miss the allocator's cached blocks, which it reuses
    first.  With ``n_devices=1`` this is the single-device budget.
    """
    n_devices = max(1, int(n_devices))
    env = os.environ.get("REPRO_EVAL_MEM_BUDGET")
    if env:
        return int(env)
    if device is not None and device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(free + cached) // n_devices
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page > 0:
            return pages * page // 4 // n_devices
    except (ValueError, OSError, AttributeError):
        pass
    return default // n_devices


def auto_eval_batch_size(probe: Callable[[int], int],
                         budget: int | None = None,
                         reserved: int = 0,
                         max_rows: int = 1024,
                         n_devices: int = 1,
                         device: torch.device | None = None) -> int | None:
    """The largest power-of-two chunk whose footprint fits ONE device.

    ``probe(n_rows)`` returns the peak device bytes of an ``n_rows``
    dispatch.  Two probes (1 and 2 rows) give the per-row slope and the
    fixed intercept; ``reserved`` carves out bytes the caller keeps
    resident across dispatches (the staged store's cap).  A chunk is a
    one-device dispatch even when a scheduler spreads chunks over a pool,
    so an explicit ``budget`` is the caller's per-device number, and
    otherwise :func:`device_memory_budget` resolves it for ``device``
    shared by ``n_devices`` slots.  Returns None when the probe reports
    nothing or no per-row slope (no sizing information, so no cap); the
    floor is 1 row.
    """
    p1, p2 = probe(1), probe(2)
    if p1 <= 0 or p2 <= 0 or p2 <= p1:
        return None
    per_row = p2 - p1
    fixed = max(p1 - per_row, 0)
    avail = budget if budget is not None else device_memory_budget(
        n_devices=n_devices, device=device)
    avail -= reserved + fixed
    n = 1
    while n * 2 <= max_rows and (n * 2) * per_row <= avail:
        n *= 2
    return n
