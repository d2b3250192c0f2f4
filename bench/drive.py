"""The one traffic driver: it reads a traffic mix's parameters
(``traffic/<name>.json``) and drives a system with them, one step at a
time, recording what it hands over.

Kinds of mix:
  * ``search``: back-to-back AFarePart searches (``optimize_steps``), each
    ``generations`` long at ``population``, crossover and mutation rates
    as given; every search starts under a new fault environment (the
    ladder's fault scales times a factor from ``env_factors``: ``count``
    factors log-spaced over ``[low, high]``) with its own NSGA-II seed.
    The ``count`` searches (factor k with the k-th NSGA-II seed drawn from
    ``schedule_seed``) are the same for every run; the run's seed orders
    each cycle through them, never the same factor twice in a row.  A step
    is one generation; a search's first step also scores its initial
    population.
  * ``sweep``: independent populations of ``population`` rows drawn
    uniformly, handed straight to ``delta_acc`` under one environment (the
    scales times ``env_factor``).  A step is one population.
Warm-up runs one step under ``warmup_factor``, a factor the window never
uses, so the window starts with nothing cached.

Every ``delta_acc`` call is recorded (the environment, the rows handed,
the ΔAcc returned, host seconds), and in a search every objective call's
latency and energy: the spans the per-layer metrics and the correctness
check read.
"""
from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function


class Recorder:
    """Wraps ``evaluator.delta_acc`` (an instance attribute shadows the
    method, which ``ObjectiveFn`` then calls)."""

    def __init__(self, evaluator):
        self.calls = []             # dicts: env, phase, rows, dacc, t0, t1
        self.phase = "setup"
        self.env = -1
        inner = evaluator.delta_acc

        def delta_acc(P):
            P = np.array(P, np.int64)
            t0 = time.perf_counter()
            with record_function("bench:delta_acc"):
                out = inner(P)
            t1 = time.perf_counter()
            self.calls.append({"env": self.env, "phase": self.phase,
                               "rows": P, "dacc": np.array(out, np.float64),
                               "t0": t0, "t1": t1, "objs": None})
            return out
        evaluator.delta_acc = delta_acc


class _Objective:
    """``ObjectiveFn`` as NSGA-II calls it, with its output recorded on the
    ``delta_acc`` call it made."""

    def __init__(self, inner, rec: Recorder):
        self.inner, self.rec = inner, rec

    def __call__(self, P):
        n = len(self.rec.calls)
        objs = self.inner(P)
        if len(self.rec.calls) == n + 1:
            self.rec.calls[-1]["objs"] = np.array(objs, np.float64)
        return objs

    def violation(self, P):
        return self.inner.violation(P)


def _factors(spec) -> np.ndarray:
    return np.geomspace(spec["low"], spec["high"], spec["count"])


class Driver:
    def __init__(self, system, traffic: dict, rng: np.random.Generator):
        self.system, self.traffic, self.rng = system, traffic, rng
        self.rec = Recorder(system.evaluator)
        self.envs: list[np.ndarray] = []
        self.steps: list[dict] = []       # phase, t0, t1
        self._gen = None
        self._queue: list[tuple[float, int]] = []
        self._last = None
        kind = traffic["kind"]
        if kind not in ("search", "sweep"):
            raise ValueError(f"unknown traffic kind {kind!r}")
        window = (_factors(traffic["env_factors"]) if kind == "search"
                  else [traffic["env_factor"]])
        if any(np.isclose(traffic["warmup_factor"], f) for f in window):
            raise ValueError("the warm-up factor must differ from the "
                             "window's, or the window starts warm")

    def _set_env(self, factor: float):
        scale = np.asarray(self.system.base_scale * np.float32(factor),
                           np.float32)
        self.envs.append(scale)
        self.rec.env = len(self.envs) - 1
        self.system.set_env(scale)

    def _next_search(self) -> tuple[float, int]:
        if not self._queue:
            f = list(_factors(self.traffic["env_factors"]))
            seeds = np.random.default_rng(self.traffic["schedule_seed"]) \
                .integers(0, 2 ** 31, len(f))
            while True:
                order = self.rng.permutation(len(f))
                if self._last is None or f[order[0]] != self._last:
                    break
            self._queue = [(f[k], int(seeds[k])) for k in order]
        search = self._queue.pop(0)
        self._last = search[0]
        return search

    def _new_search(self, factor: float, nsga_seed: int):
        from repro_torch.core import NSGA2Config
        t = self.traffic
        self._set_env(factor)
        nsga = NSGA2Config(population=t["population"],
                           generations=t["generations"],
                           crossover_rate=t["crossover_rate"],
                           mutation_rate=t["mutation_rate"],
                           seed=nsga_seed)
        part = self.system.partitioner(nsga)
        part.objective = _Objective(part.objective, self.rec)
        self._gen = part.optimize_steps()

    def step(self, phase: str):
        """One generation (search) or population (sweep)."""
        self.rec.phase = phase
        t0 = time.perf_counter()
        with record_function("bench:step"):
            if self.traffic["kind"] == "sweep":
                P = self.rng.integers(0, self.system.n_devices,
                                      (self.traffic["population"],
                                       self.system.n_units))
                self.system.evaluator.delta_acc(P)
            else:
                while True:
                    if self._gen is None:
                        self._new_search(*self._next_search())
                    try:
                        next(self._gen)
                        break
                    except StopIteration:
                        self._gen = None
        self.steps.append({"phase": phase, "t0": t0,
                           "t1": time.perf_counter()})

    def warmup(self):
        """One step under the warm-up factor, then the window's
        environment (a sweep's fixed one; a search sets its own)."""
        if self.traffic["kind"] == "sweep":
            self._set_env(self.traffic["warmup_factor"])
            self.step("warmup")
            self._set_env(self.traffic["env_factor"])
        else:
            self._new_search(self.traffic["warmup_factor"],
                             int(self.rng.integers(0, 2 ** 31)))
            self.step("warmup")
            self._gen = None

    def run(self, phase: str, seconds: float) -> tuple[float, float]:
        """Steps until ``seconds`` have passed at a step's end; returns the
        window's start and end."""
        t0 = time.perf_counter()
        while True:
            self.step(phase)
            if time.perf_counter() - t0 >= seconds:
                return t0, time.perf_counter()
