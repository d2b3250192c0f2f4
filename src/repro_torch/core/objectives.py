"""Objective evaluation for partition chromosomes, the counterpart of
``repro/core/objectives.py``.

Three objectives (paper Eq. 2), all minimised: ``[Latency(P), Energy(P),
ΔAcc(P)]``.  Latency and energy come from the analytic ``CostModel``;
ΔAcc from :class:`InferenceAccuracyEvaluator`, which runs the quantized
model on a calibration batch with faults injected on the units mapped to
fault-prone devices and measures the Top-1 drop, or from the calibrated
:class:`SurrogateAccuracyEvaluator`.

Population batching: ``delta_acc`` deduplicates the ``[N, L]`` population
and evaluates the unique uncached rows in chunks; the reference's
``jit(vmap)`` becomes the explicit row axis of the models and kernels.

Strategies (bitwise identical; cost only):
  * ``"staged"`` (the default when ``step_fn`` is given): the
    ``PrefixEvalEngine`` walks the model unit by unit and evaluates each
    unique gene prefix once, reusing stored activations across rows and
    generations; with ``fuse_chains`` non-branching runs of the prefix
    tree go out as one segment call each.  A segment is a plain
    composition of the unit steps (seed ``base_seed + 7919·i``, depth 0 on
    the calibration batch, accuracy folded in at the last unit).
  * ``"full"``: every unique row runs the whole forward.

Fault backends (all value-identical; bitwise on the CPU):
  * ``"generic"``: quantize -> corrupt -> dequantize every weight and
    activation inline at the row's per-unit rates (``quant_bitflip``);
  * ``"tables"``: gather weights pre-corrupted once per (unit, device)
    (``models.cnn.build_weight_fault_tables``); activations inline;
  * ``"kernel"``: the counterpart of the reference's ``"pallas"``: one
    resident integer copy of the weights (``quant_params``), conv weights
    corrupted by ``bitflip`` and fc weights inside ``fault_matmul``.
    The per-device rate tensors and the seed are read at call time
    through a weakref, so a ``device_fault_scale`` change rebuilds
    nothing.

Placement (``devices``): the dispatches spread over a pool of device
slots (``eval_engine.DeviceScheduler``).  Everything the evaluation reads
lives once per distinct device of the pool (:class:`_Replica`): the
evaluator's own device holds what it was given, another device a copy made
at its first dispatch, and the slots on one device share it.  Placement
never changes a value.

Every ΔAcc and accuracy computation runs in IEEE fp32 (``fp32_exact``:
TF32 off for cuDNN and matmuls whatever the caller's globals say).  Clean
accuracy runs the generic float path at zero rates.
"""
from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch._device import fp32_exact, resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.costmodel import CostModel
from repro_torch.core.eval_engine import (DeviceScheduler,
                                          PopulationEvalEngine,
                                          PrefixEvalEngine,
                                          auto_eval_batch_size, chunked_rows,
                                          device_memory_budget,
                                          peak_memory_bytes)
from repro_torch.core.fault import FaultSpec
from repro_torch.launch.mesh import indexed_device, local_devices
from repro_torch.trace import span, spanned

__all__ = ["InferenceAccuracyEvaluator", "SurrogateAccuracyEvaluator",
           "ObjectiveFn", "profile_layer_sensitivity",
           "make_lm_accuracy_evaluator", "FAULT_BACKENDS"]

FAULT_BACKENDS = ("generic", "tables", "kernel")

# Segment functions per evaluator, keyed ``(device, start, length)`` and
# weakly by the evaluator: dropping the evaluator drops its entry, and
# ObjectiveFn/partitioner rebuilds that reuse one evaluator keep its
# segments.  A cached function must not hold the evaluator (it would keep
# its own key, and the CUDA tensors, alive).
_SEGMENT_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _kernel_env(ref, device: torch.device):
    """The evaluator's CURRENT fault environment on ``device``,
    ``(w_rates_by_device, a_rates_by_device, base_seed)`` as device tensors
    and an int, read at call time through the weakref ``ref`` (the kernel
    backend's counterpart of the reference's ``_pallas_env_args``)."""
    ev = ref()
    rep = ev._replicas[device]
    return rep.w_dev, rep.a_dev, int(ev.base_seed)


class _Replica:
    """What the evaluation reads on one device of the pool: the
    calibration input and labels, the backend's weights (float params,
    the kernel backend's integer copy or the tables) and the per-device
    rate tensors.  It holds no reference to the evaluator."""

    __slots__ = ("device", "x", "labels", "params", "qparams", "tables",
                 "w_dev", "a_dev")

    def __init__(self, device, x, labels, params, qparams, tables):
        self.device = device
        self.x, self.labels = x, labels
        self.params, self.qparams, self.tables = params, qparams, tables
        self.w_dev = self.a_dev = None


def _to_device(tree, device: torch.device):
    """A copy of ``tree`` (tensors, ``QTensor``s) on ``device``, sent to a
    card without blocking.  A tensor that appears twice (a tied embedding
    and head) is copied once, and one expanded over its leading axis (a
    table's boundary leaf) is copied as one row and expanded again."""
    from repro_torch.models.layers import QTensor
    non_blocking = device.type == "cuda"
    done: dict = {}

    def move(a):
        if isinstance(a, QTensor):
            return dataclasses.replace(a, qw=move(a.qw), scale=move(a.scale))
        if not isinstance(a, torch.Tensor):
            return a
        key = (a.data_ptr(), a.dtype, tuple(a.shape), a.stride())
        if key not in done:
            if a.ndim and a.shape[0] > 1 and a.stride(0) == 0:
                done[key] = move(a[0]).expand_as(a)
            else:
                done[key] = a.to(device, non_blocking=non_blocking)
        return done[key]

    return tree_map(move, tree)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row Top-1 of ``logits [R, *labels.shape, classes]`` -> ``[R]``:
    images (``labels [B]``) or tokens (``labels [B, S]``), the mean over
    every label of a row."""
    pred = torch.argmax(logits, dim=-1)
    hits = (pred == labels).to(torch.float32)
    return hits.reshape(hits.shape[0], -1).mean(dim=-1)


def _as_input(x, device):
    """The calibration input on ``device``: a tensor (images) or a batch
    dict of tensors (an LM's ``{"tokens"}``)."""
    return tree_map(lambda a: torch.as_tensor(a, device=device), x)


def _row_input(x0, rows: int):
    """The calibration input with a leading axis of ``rows`` (a view)."""
    return tree_map(lambda t: t.expand(rows, *t.shape), x0)


def _compose(step, start: int, length: int, params, tables, x0, labels,
             env: Callable[[], tuple]) -> Callable:
    """``fn(acts, genes [U, length])`` running units
    ``start..start+length-1`` exactly as the whole forward runs them: unit
    ``i`` at seed ``base + 7919·i`` and its row's device rates, weights
    gathered from ``tables`` (rate None) when given, depth 0 on the
    calibration batch ``x0``, the Top-1 accuracy folded in after the last
    unit of the model.  ``env()`` gives ``(w_dev, a_dev, base)``."""
    final = start + length == len(params if tables is None else tables)

    @torch.no_grad()
    @fp32_exact()
    def fn(acts, genes):
        with span("forward.segment"):
            w_dev, a_dev, base = env()
            x = _row_input(x0, genes.shape[0]) if acts is None else acts
            for k in range(length):
                with span("forward.unit"):
                    i, d = start + k, genes[:, k]
                    if tables is not None:
                        p = tree_map(lambda t: t.index_select(0, d),
                                     tables[i])
                        wr = None
                    else:
                        p, wr = params[i], w_dev[d]
                    x = step(i, p, x, wr, a_dev[d], base + 7919 * i)
            return _accuracy(x, labels) if final else x

    return fn


class InferenceAccuracyEvaluator:
    """ΔAcc via true fault-injected inference (paper Alg. 1 lines 5-7).

    ``apply_fn(params, x, weight_rates, act_rates, seed)`` runs the model
    on the calibration input ``x`` for rows of per-unit rates ``[R, L]``
    and returns logits ``[R, *labels.shape, classes]`` (``models.cnn``
    models' ``apply``, ``LMStepModel.apply``).

    Args:
      params: per-unit float params on ``device``.
      x, labels: calibration images (NHWC) and labels ``[B]``, or an LM's
        batch dict (``{"tokens": [B, S]}``) and labels ``[B, S]``; numpy or
        tensors.  Accuracy is the Top-1 over every label of a row.
      eval_batch_size: max rows per dispatch (None = one dispatch;
        ``"auto"`` = probe the memory of a 1- and a 2-row dispatch and
        take the largest power-of-two chunk that fits one slot's share of
        its card, see ``eval_engine.auto_eval_batch_size``; None off the
        card).
      weight_tables / quant_params: the ``tables`` / ``kernel`` backends'
        fault state.
      fault_backend: ``"generic"``, ``"tables"``, ``"kernel"`` or
        ``"auto"`` (``tables`` iff tables are given, else ``generic``).
      step_fn: per-unit forward ``step(i, params_i, x, wr, ar, seed)``
        (the CNN models' ``step``); enables the staged engine.
      eval_strategy: ``"staged"`` (needs ``step_fn``), ``"full"``, or
        ``"auto"`` (staged iff ``step_fn`` is given).
      max_store_bytes: LRU cap of the staged activation store (None =
        unbounded), one store for every slot; eviction recomputes, it
        never changes a value.
      shared_carry_fields: staged-engine interning spec (carry-dict field
        -> keying depth), as in the reference.
      fuse_chains: staged-path chain fusion (default on).
      devices: the slots the dispatches spread over (see
        ``eval_engine.DeviceScheduler``): ``"auto"`` (every slot of the
        pool), a count (the first n), or a list of devices, which becomes
        the pool (a device may repeat: ``[cpu] * 4``).  The default pool is
        ``device`` followed by the other local cards, or ``[device]`` on
        the host.  Chunks go round-robin (full path) or by prefix group
        (staged path); placement never changes a value.
      device: the evaluator's own device, where its inputs live, ``"cuda"``
        by default.
    """

    def __init__(self, apply_fn, params, x, labels, spec: FaultSpec,
                 device_fault_scale, base_seed: int = 0,
                 eval_batch_size: int | str | None = None,
                 weight_tables: list | None = None,
                 quant_params: list | None = None,
                 fault_backend: str | None = "auto",
                 step_fn: Callable | None = None,
                 eval_strategy: str = "auto",
                 n_units: int | None = None,
                 max_store_bytes: int | None = 256 << 20,
                 devices: int | str | list | None = "auto",
                 shared_carry_fields: dict | None = None,
                 fuse_chains: bool = True, device="cuda"):
        self.device = indexed_device(resolve_device(device))
        if quant_params is not None and weight_tables is not None:
            raise ValueError("pass quant_params (kernel backend) or "
                             "weight_tables (tables backend), not both")
        self.spec = spec
        self.base_seed = base_seed
        self._home = _Replica(self.device, _as_input(x, self.device),
                              torch.as_tensor(labels, device=self.device),
                              params, quant_params, weight_tables)
        self._replicas = {self.device: self._home}
        self._apply_fn = apply_fn
        self._step_fn = step_fn
        if n_units is None and isinstance(params, (list, tuple)):
            n_units = len(params)
        self._n_units = n_units
        self.max_store_bytes = max_store_bytes
        self.shared_carry_fields = dict(shared_carry_fields or {})
        self._fuse_chains = bool(fuse_chains)
        self._built_unit_fns = None        # device -> unit functions
        self._prefix_engine = None
        self._fault_env_rebuilds = 0
        self.auto_probe_bytes: dict[int, int] = {}
        self._engine = PopulationEvalEngine(self._dispatch)
        self._cache = self._engine._cache
        self._clean: float | None = None
        self._pool = None                  # a pool given as devices=[...]
        self._scheduler = None
        self.devices = devices
        self._fault_backend = None
        self.fault_backend = fault_backend
        self.eval_strategy = eval_strategy
        self.device_fault_scale = device_fault_scale
        self.eval_batch_size = eval_batch_size  # "auto" probes the card

    # -- what lives on the evaluator's own device ----------------------------
    @property
    def _x(self):
        return self._home.x

    @property
    def labels(self) -> torch.Tensor:
        return self._home.labels

    @property
    def _params(self):
        return self._home.params

    @property
    def _qparams(self):
        return self._home.qparams

    @property
    def _w_dev(self) -> torch.Tensor:
        return self._home.w_dev

    @property
    def _a_dev(self) -> torch.Tensor:
        return self._home.a_dev

    @property
    def weight_tables(self):
        return self._home.tables

    @weight_tables.setter
    def weight_tables(self, value):
        self._home.tables = value
        self._drop_replicas()

    def _replica(self, device: torch.device) -> _Replica:
        """The evaluation's tensors on ``device``: the evaluator's own there,
        else a copy made now, of what the current backend reads (its
        first dispatch on that device; the slots on it share it)."""
        rep = self._replicas.get(device)
        if rep is None:
            h, backend = self._home, self._fault_backend
            rep = _Replica(
                device, _to_device(h.x, device), _to_device(h.labels, device),
                _to_device(h.params, device) if backend == "generic" else None,
                _to_device(h.qparams, device) if backend == "kernel" else None,
                _to_device(h.tables, device) if backend == "tables" else None)
            self._send_rates(rep)
            self._replicas[device] = rep
        return rep

    def _send_rates(self, rep: _Replica):
        rep.w_dev = DeviceScheduler.put(self.w_rates_by_device, rep.device)
        rep.a_dev = DeviceScheduler.put(self.a_rates_by_device, rep.device)

    def _drop_replicas(self):
        """Forget the copies on other devices and every built function (the
        functions close over a replica's tensors)."""
        self._replicas = {self.device: self._home}
        self._built_unit_fns = None
        _SEGMENT_CACHE.pop(self, None)

    # -- knobs ---------------------------------------------------------------
    @property
    def eval_strategy(self) -> str:
        return self._strategy

    @eval_strategy.setter
    def eval_strategy(self, value: str):
        if value == "auto":
            value = "staged" if self._step_fn is not None else "full"
        if value not in ("staged", "full"):
            raise ValueError(f"unknown eval_strategy {value!r}")
        if value == "staged" and (self._step_fn is None
                                  or not self._n_units):
            raise ValueError("eval_strategy='staged' needs step_fn and "
                             "per-unit params (n_units)")
        self._strategy = value
        if value == "staged":
            self._ensure_prefix_engine()

    @property
    def devices(self) -> int:
        """Slots the evaluation spreads over (see the constructor)."""
        return self._scheduler.n_devices

    @devices.setter
    def devices(self, value):
        if isinstance(value, (list, tuple)):
            self._pool = [indexed_device(d) for d in value]
            sched = DeviceScheduler(self._pool)
        else:
            sched = DeviceScheduler("auto" if value is None else value,
                                    pool=self._pool or self._local_pool())
        old = self._scheduler
        if old is not None and sched.devices == old.devices:
            return                              # same pool, keep state
        self._scheduler = sched
        self._engine.scheduler = sched
        if self._prefix_engine is not None:
            # stored activations live on the old pool's devices
            self._prefix_engine.scheduler = sched
            self._prefix_engine.reset_placement()
        self._drop_replicas()
        if getattr(self, "_ebs_auto", False):
            # the probed chunk was fitted to the old pool's budget
            self.eval_batch_size = "auto"

    def _local_pool(self) -> list[torch.device]:
        """The default pool: the evaluator's device, then the host's other
        cards in index order."""
        if self.device.type != "cuda":
            return [self.device]
        return [self.device] + [d for d in local_devices() if d != self.device]

    @property
    def fuse_chains(self) -> bool:
        """Whether the staged path fuses non-branching prefix chains into
        single segment calls."""
        return self._fuse_chains

    @fuse_chains.setter
    def fuse_chains(self, value: bool):
        self._fuse_chains = bool(value)
        if self._prefix_engine is not None:
            self._prefix_engine.segment_fn = \
                self._segment_dispatch if self._fuse_chains else None

    @property
    def eval_batch_size(self) -> int | None:
        return self._engine.eval_batch_size

    @eval_batch_size.setter
    def eval_batch_size(self, value: int | str | None):
        self._ebs_auto = value == "auto"
        if value == "auto":
            value = self._auto_eval_batch_size()
        self._engine.eval_batch_size = value
        if self._prefix_engine is not None:
            self._prefix_engine.eval_batch_size = value

    @property
    def fault_backend(self) -> str:
        return self._fault_backend

    @fault_backend.setter
    def fault_backend(self, value: str | None):
        """Switch the injection path (a cost decision: the backends are
        value-identical); the path's unit and segment functions, its copies
        on other devices, cached rows and stored activations are
        dropped."""
        if value in (None, "auto"):
            value = "tables" if self.weight_tables is not None else "generic"
        if value not in FAULT_BACKENDS:
            raise ValueError(f"unknown fault_backend {value!r}")
        if value == self._fault_backend:
            return
        if value == "kernel" and self._qparams is None:
            raise ValueError("fault_backend='kernel' needs quant_params")
        if value == "tables" and self.weight_tables is None:
            raise ValueError("fault_backend='tables' needs weight_tables")
        self._fault_backend = value
        self._drop_replicas()
        self._engine._cache.clear()
        if self._prefix_engine is not None:
            self._prefix_engine.store.clear()
        if getattr(self, "_ebs_auto", False):
            # the probed chunk was fitted to the old backend's footprint
            self.eval_batch_size = "auto"

    @property
    def device_fault_scale(self) -> np.ndarray:
        return self._device_fault_scale

    @device_fault_scale.setter
    def device_fault_scale(self, value):
        """Refresh the fault environment: every replica's rate tensors.
        Cached rows and stored activations encode the old rates and are
        dropped.  The kernel backend rebuilds nothing (its functions read
        the rate tensors at call time); under generic and tables the unit
        and segment functions, which hold the rates, are dropped, the
        tables too (the backend degrades to generic), and
        ``_fault_env_rebuilds`` counts it."""
        value = np.asarray(value, np.float32)
        changed = (getattr(self, "_device_fault_scale", None) is not None
                   and not np.array_equal(self._device_fault_scale, value))
        self._device_fault_scale = value
        self.w_rates_by_device = np.asarray(
            self.spec.weight_fault_rate * value, np.float32)
        self.a_rates_by_device = np.asarray(
            self.spec.act_fault_rate * value, np.float32)
        for rep in self._replicas.values():
            self._send_rates(rep)
        if not changed:
            return
        self._engine._cache.clear()
        if self._prefix_engine is not None:
            self._prefix_engine.store.clear()
        if self._fault_backend == "kernel":
            return
        self._fault_env_rebuilds += 1
        self.weight_tables = None
        if self._fault_backend == "tables":
            self._fault_backend = "generic"

    # -- staged (prefix-reuse) machinery --------------------------------------
    def _ensure_prefix_engine(self) -> PrefixEvalEngine:
        """Build the staged engine once; it shares the full path's row
        cache so the strategies interoperate."""
        if self._prefix_engine is None:
            L = self._n_units
            self._prefix_engine = PrefixEvalEngine(
                [lambda acts, devs, i=i: self._unit_dispatch(i, acts, devs)
                 for i in range(L)],
                L, eval_batch_size=self._engine.eval_batch_size,
                max_store_bytes=self.max_store_bytes,
                scheduler=self._scheduler,
                shared_fields=self.shared_carry_fields,
                segment_fn=self._segment_dispatch if self._fuse_chains
                else None, device=self.device)
            self._prefix_engine._cache = self._engine._cache
        return self._prefix_engine

    def _unit_dispatch(self, i: int, acts, devs):
        """Engine unit callable: unit ``i`` over the fresh prefixes'
        (parent activation, device) rows, on the device ``devs`` is on."""
        return self._unit_fns(devs.device)[i](acts, devs)

    def _unit_fns(self, device: torch.device) -> list:
        """The unit functions on ``device``, built at first use."""
        if self._built_unit_fns is None:
            self._built_unit_fns = {}
        fns = self._built_unit_fns.get(device)
        if fns is None:
            fns = self._built_unit_fns[device] = \
                self._build_unit_fns(self._replica(device))
        return fns

    def _segment_dispatch(self, start: int, length: int) -> Callable:
        """Engine ``segment_fn``: the composed function of units
        ``start..start+length-1`` on the device its genes are on."""
        return lambda acts, genes: self._segment_fn(
            genes.device, start, length)(acts, genes)

    def _segment_fn(self, device: torch.device, start: int,
                    length: int) -> Callable:
        """Built once per (device, start, length), kept in
        ``_SEGMENT_CACHE``."""
        cache = _SEGMENT_CACHE.get(self)
        if cache is None:
            cache = _SEGMENT_CACHE[self] = {}
        key = (device, start, length)
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = self._build_segment_fn(self._replica(device),
                                                     start, length)
        return fn

    def _generic_env(self, rep: _Replica) -> Callable[[], tuple]:
        """The generic/tables environment: the replica's rate tensors of
        today, held by the functions (a rate change drops them)."""
        w, a, base = rep.w_dev, rep.a_dev, int(self.base_seed)
        return lambda: (w, a, base)

    def _kernel_env_fn(self, rep: _Replica) -> Callable[[], tuple]:
        """The kernel environment, read at call time through a weakref."""
        return lambda r=weakref.ref(self), d=rep.device: _kernel_env(r, d)

    def _build_unit_fns(self, rep: _Replica) -> list:
        """One function per unit depth on ``rep``'s device, ``fn(acts, devs
        [U])``: the generic path, the tables gather, or the kernel
        backend's resident integer params."""
        if self._fault_backend == "kernel":
            env, params, tables = self._kernel_env_fn(rep), rep.qparams, None
        else:
            env, params = self._generic_env(rep), rep.params
            tables = rep.tables if self._fault_backend == "tables" else None
        return [self._unit_fn(i, params, tables, rep, env)
                for i in range(self._n_units)]

    def _unit_fn(self, i, params, tables, rep, env) -> Callable:
        fn = _compose(self._step_fn, i, 1, params, tables, rep.x, rep.labels,
                      env)
        return lambda acts, devs, f=fn: f(acts, devs[:, None])

    def _build_segment_fn(self, rep: _Replica, start: int,
                          length: int) -> Callable:
        """Units ``start..start+length-1`` composed (see ``_compose``) on
        ``rep``'s device.  Length-1 segments reuse the unit functions.  The
        result holds no reference to ``self``: it lives in the weak-keyed
        cache."""
        if length == 1:
            unit = self._unit_fns(rep.device)[start]
            return lambda acts, genes, f=unit: f(acts, genes[:, 0])
        if self._fault_backend == "kernel":
            return _compose(self._step_fn, start, length, rep.qparams, None,
                            rep.x, rep.labels, self._kernel_env_fn(rep))
        tables = rep.tables if self._fault_backend == "tables" else None
        return _compose(self._step_fn, start, length, rep.params, tables,
                        rep.x, rep.labels, self._generic_env(rep))

    def staged_stats(self) -> dict:
        """Prefix-reuse accounting (unit runs, hits, evictions, ...), the
        staged engine's ``stats()``, and the row cache's: ``rows_requested``
        (rows handed to either engine) and ``rows_cached`` (of those, rows
        already in the cache when their call began)."""
        if self._prefix_engine is None:
            return {}
        engines = (self._engine, self._prefix_engine)
        return {**self._prefix_engine.stats(),
                **{k: sum(getattr(e, k) for e in engines)
                   for k in ("rows_requested", "rows_cached")}}

    # -- memory probe ---------------------------------------------------------
    def _auto_eval_batch_size(self) -> int | None:
        """Resolve ``eval_batch_size="auto"``: run a 1-row and a 2-row
        whole-forward dispatch of the current backend, read the
        allocator's peak above what was allocated before each, and fit the
        largest power-of-two chunk into ONE slot's budget (the least over
        the pool's devices of a device's budget over its slots) with the
        staged store cap reserved in full.  The staged unit and segment
        calls touch less than a whole forward per row, so the probe bounds
        them.  The row cache, the store and the evaluator's counters are
        left as they were.  Off the card the probe reads 0 and the result
        is None."""
        L = self._n_units
        if not L:
            return None

        readings = self.auto_probe_bytes = {}      # rows -> bytes, kept

        def probe(n: int) -> int:
            if n not in readings:
                rows = np.zeros((n, L), np.int64)
                readings[n] = peak_memory_bytes(
                    lambda: self._dispatch(rows), self.device)
            return readings[n]

        probe(1), probe(2)      # the budget below is read after the probes
        slots = self._scheduler.devices
        budget = min(device_memory_budget(n_devices=slots.count(d), device=d)
                     for d in dict.fromkeys(slots))
        reserved = (self.max_store_bytes or 0) \
            if self._strategy == "staged" else 0
        return auto_eval_batch_size(probe, budget=budget, reserved=reserved)

    # -- fault state ----------------------------------------------------------
    def fault_table_bytes(self) -> int:
        """Resident bytes of pre-corrupted weight tables over every replica
        (0 without)."""
        return sum(t.numel() * t.element_size()
                   for rep in self._replicas.values() if rep.tables is not None
                   for unit in rep.tables for t in tree_leaves(unit))

    def fault_state_bytes(self) -> int:
        """Resident bytes of the backend's fault state over every replica:
        the integer copy (``kernel``), the tables (``tables``) or 0
        (``generic``)."""
        if self._fault_backend == "kernel":
            from repro_torch.models.layers import QTensor
            return sum(q.qw.numel() * q.qw.element_size() + 4
                       for rep in self._replicas.values()
                       if rep.qparams is not None
                       for unit in rep.qparams for q in tree_leaves(unit)
                       if isinstance(q, QTensor))
        return self.fault_table_bytes()

    # -- evaluation -----------------------------------------------------------
    @property
    def dispatches(self) -> int:
        """Dispatches sent so far by both engines (cache hits cost 0)."""
        n = self._engine.dispatches
        if self._prefix_engine is not None:
            n += self._prefix_engine.dispatches
        return n

    @torch.no_grad()
    @fp32_exact()
    def _dispatch(self, rows: np.ndarray,
                  device: torch.device | None = None) -> torch.Tensor:
        """``[U, L]`` device ids -> ``[U]`` faulty accuracies over the
        whole forward, run on ``device`` (the evaluator's own when None);
        a device tensor: the engine gathers once per call."""
        rows = np.asarray(rows, np.int64)
        dev = self.device if device is None else device
        rep = self._replica(dev)
        put = DeviceScheduler.put
        AR = put(self.a_rates_by_device[rows], dev)
        seed = int(self.base_seed)
        if self._fault_backend == "tables":
            idx = put(rows, dev)
            gathered = [tree_map(lambda t, i=i: t[idx[:, i]], table)
                        for i, table in enumerate(rep.tables)]
            with span("forward.apply"):
                logits = self._apply_fn(gathered, rep.x, None, AR, seed)
        else:
            WR = put(self.w_rates_by_device[rows], dev)
            params = rep.qparams if self._fault_backend == "kernel" \
                else rep.params
            with span("forward.apply"):
                logits = self._apply_fn(params, rep.x, WR, AR, seed)
        return _accuracy(logits, rep.labels)

    @torch.no_grad()
    @fp32_exact()
    def _clean_for(self, n: int) -> float:
        if self._clean is None:
            z = torch.zeros((1, n), dtype=torch.float32, device=self.device)
            with span("forward.apply"):
                logits = self._apply_fn(self._params, self._x, z, z,
                                        int(self.base_seed))
            self._clean = float(_accuracy(logits, self.labels)[0])
        return self._clean

    def clean_accuracy(self, n_layers: int | None = None) -> float:
        """Accuracy of the quantized-but-unflipped model (zero rates, the
        generic float params).

        The layer count is the model's own unit count.  ``n_layers`` is
        DEPRECATED: passing it warns, and a value that disagrees with
        ``n_units`` raises."""
        if n_layers is not None:
            warnings.warn(
                "clean_accuracy(n_layers) is deprecated; the layer count "
                "is derived from the model's n_units", DeprecationWarning,
                stacklevel=2)
            if self._n_units is not None and n_layers != self._n_units:
                raise ValueError(
                    f"n_layers={n_layers} does not match the model's "
                    f"n_units={self._n_units}")
        n = self._n_units or n_layers
        if not n:
            raise ValueError(
                "unit count unknown: construct the evaluator with "
                "n_units= (or per-unit list params)")
        return self._clean_for(n)

    @spanned("engine.delta_acc")
    def delta_acc(self, P: np.ndarray) -> np.ndarray:
        """``P [N, L]`` device ids -> ΔAcc per candidate (bitwise the same
        under either strategy)."""
        P = np.asarray(P)
        if self._n_units is not None and P.shape[1] != self._n_units:
            raise ValueError(f"population rows have {P.shape[1]} genes "
                             f"but the model has {self._n_units} units")
        clean = self._clean_for(self._n_units or P.shape[1])
        if self._strategy == "staged":
            faulty = self._ensure_prefix_engine().evaluate(P)
        else:
            faulty = self._engine.evaluate(P)
        return np.maximum(0.0, clean - faulty)


def make_lm_accuracy_evaluator(cfg, params, batch, labels, spec: FaultSpec,
                               device_fault_scale, *, base_seed: int = 0,
                               eval_batch_size: int | str | None = None,
                               eval_strategy: str = "auto",
                               max_store_bytes: int | None = 256 << 20,
                               devices: int | str | list | None = "auto",
                               fuse_chains: bool = True,
                               fault_backend: str | None = "auto",
                               device="cuda") -> InferenceAccuracyEvaluator:
    """Staged-capable ΔAcc evaluator for a ``configs.ArchConfig`` LM
    (the counterpart of the reference's, ``objectives.py:891-972``).

    The model is wrapped in ``models.transformer.LMStepModel`` (one unit
    per layer, in ``models.graph.lm_layer_infos`` order), its stacked
    params are sliced into the per-unit list the staged engine walks, and
    ``apply`` (the step composition) serves the whole-forward path and
    the clean-accuracy row.

    Args:
      cfg: the architecture (``cfg.reduced()`` for a small scale;
        ``models.graph.lm_eval_strategy`` says whether a full config fits).
      params: ``transformer.init_lm`` output for ``cfg`` on ``device``.
      batch: calibration batch, ``{"tokens": [B, S]}`` (or the stub
        frontend's ``{"embeds": [B, S, D]}``), plus ``{"enc_embeds": [B,
        Se, D]}`` for the encoder-decoder.
      labels: ``[B, S]`` target tokens; ΔAcc is the token-level Top-1
        drop.  The clean model's own argmax makes clean accuracy ~1.
      eval_strategy: ``"auto"`` resolves to ``"staged"``; ``"full"`` runs
        the whole forward (bitwise the same, cost only).
      fault_backend: ``"generic"`` (what ``"auto"`` resolves to),
        ``"kernel"`` (the reference's ``"pallas"``: builds
        ``LMStepModel.quant_unit_params``, one resident integer copy, flips
        inside ``fault_matmul``) or ``"tables"`` (builds
        ``LMStepModel.build_weight_fault_tables``).  Value-identical.

    ``spec.bits``/``spec.faulty_bits`` (and the fault model) pin the
    fixed-point fault width of the corruption.

    The encoder-decoder gets the lean staged carries: the decoder's input
    is bound into the step model (read by the first decoder unit, never
    carried through the encoder's units) and the encoder's memory is
    interned by encoder prefix (``shared_carry_fields={"mem":
    n_enc_layers - 1}``), so the store holds it once per encoder prefix.
    """
    from repro_torch.models.transformer import LMStepModel
    # one copy of the batch on the card, shared by the step model and the
    # evaluator (the step model then knows its rows without reading them)
    batch = _as_input(batch, resolve_device(device))
    sm = LMStepModel(cfg, bits=spec.bits, faulty_bits=spec.faulty_bits,
                     batch=batch if cfg.is_encdec else None,
                     fault_model=spec.fault_model, mbu_width=spec.mbu_width)
    shared = {"mem": cfg.n_enc_layers - 1} if cfg.is_encdec else None
    units = sm.unit_params(params)
    if fault_backend in (None, "auto"):
        fault_backend = "generic"    # no LM tables unless asked for
    quant_params = tables = None
    if fault_backend == "kernel":
        quant_params = sm.quant_unit_params(params)
    elif fault_backend == "tables":
        tables = sm.build_weight_fault_tables(
            units, spec.weight_fault_rate * np.asarray(device_fault_scale,
                                                       np.float32),
            base_seed=base_seed)
    return InferenceAccuracyEvaluator(
        sm.apply, units, batch, labels, spec, device_fault_scale,
        base_seed=base_seed, eval_batch_size=eval_batch_size,
        weight_tables=tables, quant_params=quant_params,
        fault_backend=fault_backend, step_fn=sm.step,
        eval_strategy=eval_strategy, n_units=sm.n_units,
        max_store_bytes=max_store_bytes, devices=devices,
        shared_carry_fields=shared, fuse_chains=fuse_chains, device=device)


class SurrogateAccuracyEvaluator:
    """ΔAcc ≈ Σ_l sensitivity_l · fault_scale[P_l], calibrated.

    ``calibrate(true_fn, samples)`` fits a single multiplicative factor
    against true fault-injected evaluations so the surrogate is in ΔAcc
    units rather than arbitrary sensitivity units.
    """

    def __init__(self, cost_model: CostModel):
        self.cm = cost_model
        self.calibration = 1.0

    def calibrate(self, true_delta_acc_fn: Callable[[np.ndarray], np.ndarray],
                  n_samples: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        L, D = len(self.cm.layers), len(self.cm.devices)
        P = rng.integers(0, D, size=(n_samples, L))
        true = np.asarray(true_delta_acc_fn(P))
        sur = self.cm.sensitivity_surrogate(P)
        denom = float((sur * sur).sum())
        if denom > 0:
            self.calibration = float((true * sur).sum()) / denom
        return self.calibration

    def delta_acc(self, P: np.ndarray) -> np.ndarray:
        return self.cm.sensitivity_surrogate(P) * self.calibration


@dataclasses.dataclass
class ObjectiveFn:
    """The ``[N, 3]`` (or ``[N, 2]`` without an accuracy evaluator)
    objective matrix handed to ``nsga2``.  A non-None ``devices``,
    ``eval_strategy``, ``fuse_chains``, ``fault_backend`` or
    ``eval_batch_size`` overrides the evaluator's own setting at
    construction, in that order (``"auto"`` chunks are sized for the
    strategy and backend set before them); None leaves it alone."""

    cost_model: CostModel
    acc_evaluator: object | None
    latency_weight: float = 1.0
    energy_weight: float = 1.0
    eval_batch_size: int | str | None = None
    eval_strategy: str | None = None
    devices: int | str | None = None
    fuse_chains: bool | None = None
    fault_backend: str | None = None

    def __post_init__(self):
        ev = self.acc_evaluator
        for name in ("devices", "eval_strategy", "fuse_chains",
                     "fault_backend", "eval_batch_size"):
            value = getattr(self, name)
            if value is not None and hasattr(ev, name):
                setattr(ev, name, value)

    @property
    def n_objectives(self) -> int:
        return 2 if self.acc_evaluator is None else 3

    def __call__(self, P: np.ndarray) -> np.ndarray:
        with span("search.objective"):
            with span("search.cost_model"):
                lat = self.cost_model.latency(P) * self.latency_weight
                en = self.cost_model.energy_of(P) * self.energy_weight
            if self.acc_evaluator is None:
                return np.stack([lat, en], axis=1)
            dacc = self.acc_evaluator.delta_acc(P)
            return np.stack([lat, en, dacc], axis=1)

    def violation(self, P: np.ndarray) -> np.ndarray:
        return self.cost_model.violation(P)


@torch.no_grad()
@fp32_exact()
def profile_layer_sensitivity(apply_fn, params, x, labels, n_layers: int,
                              spec: FaultSpec, base_seed: int = 0,
                              eval_batch_size: int | None = None,
                              device="cuda") -> np.ndarray:
    """Paper Sec. V-C strategy 1: layer-wise fault sweeping.

    Injects faults into ONE layer at a time (weights and activations at
    the spec's base rates) and records the Top-1 drop.  The clean row and
    the L one-hot rows form one ``[L+1, L]`` batch of rate rows, run in
    chunks of ``eval_batch_size`` rows (one chunk when None)."""
    dev = resolve_device(device)
    x = _as_input(x, dev)
    labels = torch.as_tensor(labels, device=dev)
    # row 0 = clean; row 1+l = faults on layer l only
    WR = np.zeros((n_layers + 1, n_layers), np.float32)
    AR = np.zeros((n_layers + 1, n_layers), np.float32)
    WR[1:][np.diag_indices(n_layers)] = np.float32(spec.weight_fault_rate)
    AR[1:][np.diag_indices(n_layers)] = np.float32(spec.act_fault_rate)
    chunks = []
    for start, stop, _ in chunked_rows(n_layers + 1, eval_batch_size):
        logits = apply_fn(params, x,
                          torch.as_tensor(WR[start:stop], device=dev),
                          torch.as_tensor(AR[start:stop], device=dev),
                          int(base_seed))
        chunks.append(_accuracy(logits, labels))
    accs = torch.cat(chunks).cpu().numpy().astype(np.float64)
    return np.maximum(0.0, accs[0] - accs[1:])
