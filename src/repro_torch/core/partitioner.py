"""AFarePart offline phase (paper Alg. 1, lines 1-12) and the two
fault-agnostic baselines, the counterpart of ``repro/core/partitioner.py``.

  * ``AFarePart``            — 3 objectives (latency, energy, ΔAcc),
                               most-robust deployment point.
  * ``FaultUnawareBaseline`` — the paper's 2-objective NSGA-II baseline.
  * ``CNNPartedLike``        — 2 objectives with link costs and a
                               latency-leaning selection.

``lm_partitioner`` builds ``AFarePart`` over an LM config's layer graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costmodel import (POD_TIERS_4, CostModel,
                                        DeviceProfile, LayerInfo)
from repro_torch.core.fault import FaultSpec
from repro_torch.core.nsga2 import NSGA2Config, NSGA2Result, nsga2, nsga2_steps
from repro_torch.core.objectives import ObjectiveFn, SurrogateAccuracyEvaluator

__all__ = ["PartitionPlan", "AFarePart", "FaultUnawareBaseline",
           "CNNPartedLike", "contiguous_stages", "lm_partitioner"]


@dataclasses.dataclass
class PartitionPlan:
    """Deployment artifact: the chosen mapping plus its predicted scores."""

    partition: np.ndarray       # [L] device ids
    latency: float
    energy: float
    delta_acc: float
    front: np.ndarray           # [F, L] the whole Pareto front
    front_objs: np.ndarray      # [F, M]
    evaluations: int

    def stage_boundaries(self, n_stages: int) -> list[int]:
        return contiguous_stages(self.partition, n_stages)


def contiguous_stages(partition: np.ndarray, n_stages: int) -> list[int]:
    """Contiguous cut points from a layer->device map: the most even cuts
    among actual device changes, else an equal split."""
    L = len(partition)
    changes = [i + 1 for i in range(L - 1) if partition[i] != partition[i + 1]]
    if len(changes) >= n_stages - 1:
        ideal = [round(L * s / n_stages) for s in range(1, n_stages)]
        cuts = []
        for tgt in ideal:
            best = min((c for c in changes if c not in cuts),
                       key=lambda c: abs(c - tgt), default=None)
            if best is not None:
                cuts.append(best)
        cuts = sorted(set(cuts))
    else:
        cuts = [round(L * s / n_stages) for s in range(1, n_stages)]
    return [0] + cuts + [L]


class _BasePartitioner:
    include_link_costs = False
    latency_weight = 1.0
    energy_weight = 1.0
    select_policy = "knee"
    uses_accuracy = False

    def __init__(self, layers: list[LayerInfo],
                 devices: tuple[DeviceProfile, ...],
                 fault_spec: FaultSpec = FaultSpec(),
                 acc_evaluator=None,
                 nsga2_config: NSGA2Config = NSGA2Config(),
                 batch: int = 1,
                 eval_batch_size: int | str | None = None,
                 eval_strategy: str | None = None,
                 eval_devices: int | str | None = None,
                 fuse_chains: bool | None = None,
                 fault_backend: str | None = None):
        self.layers = layers
        self.devices = devices
        self.fault_spec = fault_spec
        self.config = nsga2_config
        self.cost_model = CostModel(layers, devices,
                                    include_link_costs=self.include_link_costs,
                                    batch=batch)
        # `devices` is the partitioning target ladder; `eval_devices` is how
        # many cards the ΔAcc evaluation may use; `fuse_chains` toggles the
        # staged path's chain fusion.  None leaves the evaluator's own
        # setting; none of these changes results.
        self.objective = ObjectiveFn(
            self.cost_model,
            acc_evaluator if self.uses_accuracy else None,
            latency_weight=self.latency_weight,
            energy_weight=self.energy_weight,
            eval_batch_size=eval_batch_size,
            eval_strategy=eval_strategy,
            devices=eval_devices,
            fuse_chains=fuse_chains,
            fault_backend=fault_backend)

    def optimize(self, initial_pop: np.ndarray | None = None,
                 callback=None, config: NSGA2Config | None = None,
                 ) -> PartitionPlan:
        res: NSGA2Result = nsga2(
            self.objective, n_genes=len(self.layers),
            n_devices=len(self.devices), config=config or self.config,
            violation_fn=self.objective.violation,
            initial_pop=initial_pop, callback=callback)
        return self._plan_from_result(res)

    def optimize_steps(self, initial_pop: np.ndarray | None = None,
                       config: NSGA2Config | None = None):
        """Generator form of :meth:`optimize`: yields ``(gen, pop, objs)``
        after each NSGA-II generation and returns the
        :class:`PartitionPlan` (``StopIteration.value``), so an online
        re-optimization can advance a generation at a time
        (``core.runtime.ReoptJob``).  Draining it gives the plan
        :meth:`optimize` gives with the same arguments."""
        res: NSGA2Result = yield from nsga2_steps(
            self.objective, n_genes=len(self.layers),
            n_devices=len(self.devices), config=config or self.config,
            violation_fn=self.objective.violation, initial_pop=initial_pop)
        return self._plan_from_result(res)

    def _plan_from_result(self, res: NSGA2Result) -> PartitionPlan:
        idx = self.select(res.pareto_objs)
        objs = res.pareto_objs[idx]
        dacc = float(objs[2]) if objs.shape[0] > 2 else float("nan")
        return PartitionPlan(
            partition=res.pareto_pop[idx].copy(),
            latency=float(objs[0]) / self.latency_weight,
            energy=float(objs[1]) / self.energy_weight,
            delta_acc=dacc,
            front=res.pareto_pop, front_objs=res.pareto_objs,
            evaluations=res.evaluations)

    def select(self, objs: np.ndarray) -> int:
        """Deployment point on the front, by ``select_policy``."""
        norm = (objs - objs.min(0)) / np.maximum(np.ptp(objs, 0), 1e-12)
        if self.select_policy == "robust" and objs.shape[1] > 2:
            # most robust P* (paper Sec. V-B): among points within 15% of
            # the front's ΔAcc range of the best, the cheapest lat+energy
            near_best = norm[:, 2] <= norm[:, 2].min() + 0.15
            key = np.where(near_best, norm[:, 0] + norm[:, 1], np.inf)
            return int(np.argmin(key))
        if self.select_policy == "latency_energy":
            return int(np.argmin(1.5 * norm[:, 0] + norm[:, 1]))
        return int(np.argmin((norm ** 2).sum(axis=1)))   # knee


class AFarePart(_BasePartitioner):
    """The paper's partitioner: fault injection in the loop, ΔAcc as a
    first-class objective, most-robust deployment point."""

    uses_accuracy = True
    select_policy = "robust"


class FaultUnawareBaseline(_BasePartitioner):
    """The paper's 2-objective baseline ("Flt-unware")."""

    select_policy = "knee"


class CNNPartedLike(_BasePartitioner):
    """CNNParted-style: latency/energy only, link costs included."""

    include_link_costs = True
    select_policy = "latency_energy"


def lm_partitioner(cfg, acc_evaluator=None, *,
                   devices: tuple[DeviceProfile, ...] = POD_TIERS_4,
                   seq: int = 4096, fault_spec: FaultSpec = FaultSpec(),
                   nsga2_config: NSGA2Config = NSGA2Config(),
                   batch: int = 1,
                   eval_batch_size: int | str | None = None,
                   eval_strategy: str | None = None,
                   eval_devices: int | str | None = None,
                   fuse_chains: bool | None = None,
                   fault_backend: str | None = None) -> AFarePart:
    """:class:`AFarePart` over an LM config's layer graph
    (``models.graph.lm_layer_infos``).

    ``acc_evaluator`` is the ΔAcc source: the evaluator of
    ``core.objectives.make_lm_accuracy_evaluator`` for a config that
    ``models.graph.lm_eval_strategy`` resolves to ``"staged"`` (small
    enough to instantiate), or None for the sensitivity surrogate over the
    same layer infos (the cost-model-only path of the 27-480B configs,
    numpy only).  ``eval_strategy``, ``fuse_chains``, ``fault_backend``
    and ``eval_batch_size`` override the evaluator's settings, as in
    :class:`AFarePart`."""
    from repro_torch.models.graph import lm_layer_infos
    layers = lm_layer_infos(cfg, seq=seq)
    if acc_evaluator is None:
        acc_evaluator = SurrogateAccuracyEvaluator(
            CostModel(layers, devices, batch=batch))
    return AFarePart(layers, devices, fault_spec=fault_spec,
                     acc_evaluator=acc_evaluator, nsga2_config=nsga2_config,
                     batch=batch, eval_batch_size=eval_batch_size,
                     eval_strategy=eval_strategy, eval_devices=eval_devices,
                     fuse_chains=fuse_chains, fault_backend=fault_backend)
