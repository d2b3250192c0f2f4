"""Objective evaluation for partition chromosomes, the counterpart of the
whole-forward part of ``repro/core/objectives.py``.

Three objectives (paper Eq. 2), all minimised: ``[Latency(P), Energy(P),
ΔAcc(P)]``.  Latency and energy come from the analytic ``CostModel``;
ΔAcc from :class:`InferenceAccuracyEvaluator`, which runs the quantized
model on a calibration batch with faults injected on the units mapped to
fault-prone devices and measures the Top-1 drop.

Population batching: ``delta_acc`` deduplicates the ``[N, L]`` population
and runs the unique uncached rows through ``PopulationEvalEngine``; one
chunk is one ``apply_fn`` call over ``R`` rows (the reference's
``jit(vmap)`` becomes the explicit row axis of the models and kernels).

Fault backends (all value-identical; bitwise on the CPU):
  * ``"generic"``: quantize -> corrupt -> dequantize every weight and
    activation inline at the row's per-unit rates (``quant_bitflip``);
  * ``"tables"``: gather weights pre-corrupted once per (unit, device)
    (``models.cnn.build_weight_fault_tables``); activations inline;
  * ``"kernel"``: the counterpart of the reference's ``"pallas"``: one
    resident integer copy of the weights (``quant_params``), conv weights
    corrupted by ``bitflip`` and fc weights inside ``fault_matmul``.
    The per-device rate arrays and the seed are read at call time, so a
    ``device_fault_scale`` change rebuilds nothing.

Clean accuracy always runs the generic float path at zero rates.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.costmodel import CostModel
from repro_torch.core.eval_engine import PopulationEvalEngine
from repro_torch.core.fault import FaultSpec

__all__ = ["InferenceAccuracyEvaluator", "ObjectiveFn", "FAULT_BACKENDS"]

FAULT_BACKENDS = ("generic", "tables", "kernel")
_STAGED_TODO = ("eval_strategy='staged' is not ported yet (ROADMAP.md "
                "Queue A item 8, the staged chain-fused engine); "
                "use eval_strategy='full'")
_DEVICES_TODO = ("devices > 1 is not ported yet (ROADMAP.md Queue A item 9, "
                 "multi-GPU scheduling)")


class InferenceAccuracyEvaluator:
    """ΔAcc via true fault-injected inference (paper Alg. 1 lines 5-7).

    ``apply_fn(params, x, weight_rates, act_rates, seed)`` runs the model
    on images ``x`` for rows of per-unit rates ``[R, L]`` and returns
    logits ``[R, B, classes]`` (``models.cnn`` models' ``apply``).

    Args:
      params: per-unit float params on ``device``.
      x, labels: calibration images (NHWC) and labels, numpy or tensors.
      eval_batch_size: max rows per dispatch (None = one dispatch).
      weight_tables / quant_params: the ``tables`` / ``kernel`` backends'
        fault state.
      fault_backend: ``"generic"``, ``"tables"``, ``"kernel"`` or
        ``"auto"`` (``tables`` iff tables are given, else ``generic``).
      eval_strategy: ``"full"`` (``"auto"`` resolves to it); ``"staged"``
        raises NotImplementedError until the staged engine is ported.
      devices: 1 (``"auto"`` resolves to 1); more raises.
      device: where evaluation runs, ``"cuda"`` by default.
    """

    def __init__(self, apply_fn, params, x, labels, spec: FaultSpec,
                 device_fault_scale, base_seed: int = 0,
                 eval_batch_size: int | None = None,
                 weight_tables: list | None = None,
                 quant_params: list | None = None,
                 fault_backend: str | None = "auto",
                 eval_strategy: str = "full",
                 n_units: int | None = None,
                 devices: int | str | None = 1, device="cuda"):
        self.device = resolve_device(device)
        if quant_params is not None and weight_tables is not None:
            raise ValueError("pass quant_params (kernel backend) or "
                             "weight_tables (tables backend), not both")
        self.eval_strategy = eval_strategy
        self.devices = devices
        self.spec = spec
        self.base_seed = base_seed
        self.weight_tables = weight_tables
        self._qparams = quant_params
        self._apply_fn = apply_fn
        self._params = params
        self._x = torch.as_tensor(x, device=self.device)
        self.labels = torch.as_tensor(labels, device=self.device)
        if n_units is None and isinstance(params, (list, tuple)):
            n_units = len(params)
        self._n_units = n_units
        self._fault_env_rebuilds = 0
        self._engine = PopulationEvalEngine(self._dispatch)
        self._cache = self._engine._cache
        self._clean: float | None = None
        self._fault_backend = None
        self.fault_backend = fault_backend
        self.eval_batch_size = eval_batch_size
        self.device_fault_scale = device_fault_scale

    @property
    def eval_strategy(self) -> str:
        return "full"

    @eval_strategy.setter
    def eval_strategy(self, value: str):
        if value == "staged":
            raise NotImplementedError(_STAGED_TODO)
        if value not in ("full", "auto"):
            raise ValueError(f"unknown eval_strategy {value!r}")

    @property
    def devices(self) -> int:
        return 1

    @devices.setter
    def devices(self, value):
        if value not in (None, "auto", 1):
            raise NotImplementedError(_DEVICES_TODO)

    @property
    def eval_batch_size(self) -> int | None:
        return self._engine.eval_batch_size

    @eval_batch_size.setter
    def eval_batch_size(self, value: int | None):
        if value == "auto":
            raise NotImplementedError(
                "eval_batch_size='auto' is not ported yet (ROADMAP.md "
                "Queue A item 8, with the memory probe)")
        self._engine.eval_batch_size = value

    @property
    def fault_backend(self) -> str:
        return self._fault_backend

    @fault_backend.setter
    def fault_backend(self, value: str | None):
        """Switch the injection path (a cost decision: the backends are
        value-identical); cached rows are dropped."""
        if value in (None, "auto"):
            value = "tables" if self.weight_tables is not None else "generic"
        if value not in FAULT_BACKENDS:
            raise ValueError(f"unknown fault_backend {value!r}")
        if value == "kernel" and self._qparams is None:
            raise ValueError("fault_backend='kernel' needs quant_params")
        if value == "tables" and self.weight_tables is None:
            raise ValueError("fault_backend='tables' needs weight_tables")
        if value != self._fault_backend:
            self._fault_backend = value
            self._engine._cache.clear()

    @property
    def device_fault_scale(self) -> np.ndarray:
        return self._device_fault_scale

    @device_fault_scale.setter
    def device_fault_scale(self, value):
        """Refresh the fault environment.  The row cache is dropped; under
        ``tables`` the tables (which encode the old rates) are dropped too
        and the backend degrades to ``generic``; the kernel backend reads
        the new rates on its next call and rebuilds nothing."""
        value = np.asarray(value, np.float32)
        changed = (getattr(self, "_device_fault_scale", None) is not None
                   and not np.array_equal(self._device_fault_scale, value))
        self._device_fault_scale = value
        self.w_rates_by_device = np.asarray(
            self.spec.weight_fault_rate * value, np.float32)
        self.a_rates_by_device = np.asarray(
            self.spec.act_fault_rate * value, np.float32)
        if changed:
            self._engine._cache.clear()
            if self._fault_backend == "kernel":
                return
            self._fault_env_rebuilds += 1
            self.weight_tables = None
            if self._fault_backend == "tables":
                self._fault_backend = "generic"

    def fault_table_bytes(self) -> int:
        """Resident bytes of pre-corrupted weight tables (0 without)."""
        if self.weight_tables is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for unit in self.weight_tables
                   for t in tree_leaves(unit))

    def fault_state_bytes(self) -> int:
        """Resident bytes of the backend's fault state: the integer copy
        (``kernel``), the tables (``tables``) or 0 (``generic``)."""
        if self._fault_backend == "kernel":
            from repro_torch.models.layers import QTensor
            return sum(q.qw.numel() * q.qw.element_size() + 4
                       for unit in self._qparams for q in tree_leaves(unit)
                       if isinstance(q, QTensor))
        return self.fault_table_bytes()

    @property
    def dispatches(self) -> int:
        return self._engine.dispatches

    def _accuracy(self, logits: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(logits, dim=-1)
        return (pred == self.labels).to(torch.float32).mean(dim=-1)

    @torch.no_grad()
    def _dispatch(self, rows: np.ndarray) -> torch.Tensor:
        """``[U, L]`` device ids -> ``[U]`` faulty accuracies (a device
        tensor; the engine syncs once per call)."""
        rows = np.asarray(rows, np.int64)
        dev = self.device
        AR = torch.as_tensor(self.a_rates_by_device[rows], device=dev)
        seed = int(self.base_seed)
        if self._fault_backend == "tables":
            idx = torch.as_tensor(rows, device=dev)
            gathered = [tree_map(lambda t, i=i: t[idx[:, i]], table)
                        for i, table in enumerate(self.weight_tables)]
            logits = self._apply_fn(gathered, self._x, None, AR, seed)
        else:
            WR = torch.as_tensor(self.w_rates_by_device[rows], device=dev)
            params = self._qparams if self._fault_backend == "kernel" \
                else self._params
            logits = self._apply_fn(params, self._x, WR, AR, seed)
        return self._accuracy(logits)

    @torch.no_grad()
    def clean_accuracy(self) -> float:
        """Accuracy of the quantized-but-unflipped model: the generic
        float params at zero rates."""
        if self._clean is None:
            z = torch.zeros((1, self._n_units), dtype=torch.float32,
                            device=self.device)
            logits = self._apply_fn(self._params, self._x, z, z,
                                    int(self.base_seed))
            self._clean = float(self._accuracy(logits)[0])
        return self._clean

    def delta_acc(self, P: np.ndarray) -> np.ndarray:
        """``P [N, L]`` device ids -> ΔAcc per candidate."""
        P = np.asarray(P)
        if self._n_units is not None and P.shape[1] != self._n_units:
            raise ValueError(f"population rows have {P.shape[1]} genes "
                             f"but the model has {self._n_units} units")
        if self._n_units is None:
            self._n_units = P.shape[1]
        clean = self.clean_accuracy()
        faulty = self._engine.evaluate(P)
        return np.maximum(0.0, clean - faulty)


@dataclasses.dataclass
class ObjectiveFn:
    """The ``[N, 3]`` (or ``[N, 2]`` without an accuracy evaluator)
    objective matrix handed to ``nsga2``; a non-None ``eval_batch_size``,
    ``eval_strategy``, ``devices`` or ``fault_backend`` overrides the
    evaluator's own setting at construction."""

    cost_model: CostModel
    acc_evaluator: object | None
    latency_weight: float = 1.0
    energy_weight: float = 1.0
    eval_batch_size: int | None = None
    eval_strategy: str | None = None
    devices: int | str | None = None
    fault_backend: str | None = None

    def __post_init__(self):
        ev = self.acc_evaluator
        for name in ("devices", "eval_strategy", "fault_backend",
                     "eval_batch_size"):
            value = getattr(self, name)
            if value is not None and hasattr(ev, name):
                setattr(ev, name, value)

    @property
    def n_objectives(self) -> int:
        return 2 if self.acc_evaluator is None else 3

    def __call__(self, P: np.ndarray) -> np.ndarray:
        lat = self.cost_model.latency(P) * self.latency_weight
        en = self.cost_model.energy_of(P) * self.energy_weight
        if self.acc_evaluator is None:
            return np.stack([lat, en], axis=1)
        dacc = self.acc_evaluator.delta_acc(P)
        return np.stack([lat, en, dacc], axis=1)

    def violation(self, P: np.ndarray) -> np.ndarray:
        return self.cost_model.violation(P)
