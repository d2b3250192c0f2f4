"""AFarePart's online phase (paper Alg. 1, lines 13-19), the counterpart of
``repro/core/runtime.py``: accuracy-aware repartitioning while deployed.

The most robust Pareto partition P* is deployed and the accuracy drop it
shows is observed each tick; when ΔAcc(P*) > θ, NSGA-II runs again with
the current runtime statistics (the device fault scales, the population
seeded with the deployed partition and the front) and the deployment is
swapped to the new P'.

:func:`simulate_deployment` drives the loop against a
:class:`FaultEnvironment` (per-device fault-rate multipliers that step
over time) through :meth:`OnlineReconfigurator.step`, which runs the
re-optimization synchronously by draining a :class:`ReoptJob`.  A caller
that cannot wait (a server) advances the job a generation at a time
instead; both make the same decision, bitwise.

With the kernel backend a swap changes only the evaluator's rate tensors,
which its unit and segment functions read at call time: nothing is
rebuilt (``InferenceAccuracyEvaluator._fault_env_rebuilds`` stays 0).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.partitioner import PartitionPlan, _BasePartitioner

__all__ = ["ReconfigEvent", "ReoptJob", "OnlineReconfigurator",
           "FaultEnvironment", "simulate_deployment"]


@dataclasses.dataclass
class ReconfigEvent:
    step: int
    observed_delta_acc: float
    old_partition: np.ndarray
    new_partition: np.ndarray
    new_predicted_delta_acc: float


@dataclasses.dataclass
class FaultEnvironment:
    """Per-device fault-rate multipliers over time.

    ``schedule`` maps a step to the ``[D]`` multipliers from that step on;
    before the first entry ``base_scale`` holds.  The sorted steps are kept,
    and rebuilt when the schedule's size changes, so :meth:`scales_at` is a
    binary search."""

    base_scale: np.ndarray
    schedule: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._compile()

    def _compile(self):
        steps = sorted(self.schedule)
        self._steps = np.asarray(steps, dtype=np.int64)
        self._rows = [np.asarray(self.base_scale, dtype=float)] + [
            np.asarray(self.schedule[s], dtype=float) for s in steps]

    def scales_at(self, step: int) -> np.ndarray:
        if len(self._steps) != len(self.schedule):   # changed after init
            self._compile()
        i = int(np.searchsorted(self._steps, step, side="right"))
        return self._rows[i].copy()


class ReoptJob:
    """One online re-optimization in flight, a generation at a time.

    Made by :meth:`OnlineReconfigurator.start_reconfigure`.  Each
    :meth:`advance` runs NSGA-II generations from the partitioner's
    generator (``optimize_steps``); when the budget is spent the job
    commits: the reconfigurator's plan swaps and a :class:`ReconfigEvent`
    is appended.  A drained job is bitwise the synchronous
    :meth:`OnlineReconfigurator.step`.  The job keeps the device scales of
    its trigger; a later shift triggers again on the committed plan."""

    def __init__(self, reconfigurator: "OnlineReconfigurator", step_idx: int,
                 observed: float, device_scales: np.ndarray, gen):
        self.reconfigurator = reconfigurator
        self.step_idx = step_idx
        self.observed = observed
        self.device_scales = np.asarray(device_scales)
        self.old_partition = reconfigurator.plan.partition.copy()
        self.generations_run = 0
        self.done = False
        self.plan: PartitionPlan | None = None
        self._gen = gen

    def advance(self, generations: int = 1) -> bool:
        """Run up to ``generations`` more generations; True once the job
        has finished and committed the new plan."""
        if self.done:
            return True
        for _ in range(generations):
            try:
                next(self._gen)
                self.generations_run += 1
            except StopIteration as stop:
                self.plan = stop.value
                self._commit()
                return True
        return False

    def _commit(self):
        rec = self.reconfigurator
        rec.events.append(ReconfigEvent(
            step=self.step_idx, observed_delta_acc=self.observed,
            old_partition=self.old_partition,
            new_partition=self.plan.partition.copy(),
            new_predicted_delta_acc=self.plan.delta_acc))
        rec.plan = self.plan
        self.done = True


class OnlineReconfigurator:
    """The monitor, trigger and swap loop around a partitioner.

    Args:
      partitioner: the (fault-aware) partitioner to run again.
      plan: the offline plan deployed now.
      theta: the accuracy-drop threshold θ (the paper's 1%).
      observe_fn: ``(partition, device_scales) -> observed ΔAcc``: telemetry
        in a deployment, the true fault-injected evaluation under the
        current environment in a simulation.
      reopt_generations: the re-optimization's budget, smaller than the
        offline one (it must answer quickly).
    """

    def __init__(self, partitioner: _BasePartitioner, plan: PartitionPlan,
                 theta: float = 0.01,
                 observe_fn: Callable[[np.ndarray, np.ndarray], float]
                 | None = None,
                 reopt_generations: int = 15):
        self.partitioner = partitioner
        self.plan = plan
        self.theta = theta
        self.observe_fn = observe_fn
        self.reopt_generations = reopt_generations
        self.events: list[ReconfigEvent] = []

    @property
    def partition(self) -> np.ndarray:
        return self.plan.partition

    def step(self, step_idx: int, device_scales: np.ndarray) -> float:
        """One synchronous monitoring tick; returns the observed ΔAcc."""
        observed = float(self.observe_fn(self.plan.partition, device_scales))
        if observed > self.theta:
            job = self.start_reconfigure(step_idx, observed, device_scales)
            while not job.advance():
                pass
        return observed

    def start_reconfigure(self, step_idx: int, observed: float,
                          device_scales: np.ndarray) -> ReoptJob:
        """RunNSGAIIWithCurrentStats(), as a :class:`ReoptJob`: the
        evaluator, the surrogate's cost model and the partitioner's cost
        model take the current device scales (the evaluator's cached rows
        and clean accuracy are dropped), then the short re-optimization is
        seeded with the deployed partition followed by the front, at the
        partitioner's seed + ``step_idx`` + 1."""
        old = self.plan.partition.copy()
        ev = self.partitioner.objective.acc_evaluator
        if ev is not None and hasattr(ev, "device_fault_scale"):
            ev.device_fault_scale = np.asarray(device_scales, np.float32)
            if hasattr(ev, "_cache"):
                ev._cache.clear()      # the environment changed
            if hasattr(ev, "_clean"):
                ev._clean = None
        if ev is not None and hasattr(ev, "cm"):
            ev.cm.fault_scale = np.asarray(device_scales)   # the surrogate
        if hasattr(self.partitioner.cost_model, "fault_scale"):
            self.partitioner.cost_model.fault_scale = np.asarray(device_scales)

        cfg = self.partitioner.config
        reopt_cfg = NSGA2Config(
            population=cfg.population,
            generations=self.reopt_generations,
            crossover_rate=cfg.crossover_rate,
            mutation_rate=cfg.mutation_rate,
            tournament_k=cfg.tournament_k,
            seed=cfg.seed + step_idx + 1)
        seed_pop = np.concatenate([old[None, :], self.plan.front], axis=0)
        gen = self.partitioner.optimize_steps(initial_pop=seed_pop,
                                              config=reopt_cfg)
        return ReoptJob(self, step_idx, observed, device_scales, gen)


def simulate_deployment(reconfigurator: OnlineReconfigurator,
                        environment: FaultEnvironment, n_steps: int) -> dict:
    """Run the online loop for ``n_steps`` ticks of ``environment``: the
    observed ΔAcc and the deployed partition of each tick, and the
    events."""
    observed, partitions = [], []
    for t in range(n_steps):
        scales = environment.scales_at(t)
        observed.append(reconfigurator.step(t, scales))
        partitions.append(reconfigurator.partition.copy())
    return {
        "observed_delta_acc": np.asarray(observed),
        "partitions": partitions,
        "events": reconfigurator.events,
    }
