"""Continuous-batching serving engine with live fault-resilient
re-partitioning (the paper's online phase as a runtime property), the
counterpart of ``repro/serve/engine.py``.

Requests enter an admission queue and are prefilled into free slots of a
fixed ``max_batch`` KV cache (``kvcache.merge_slot`` writes one row; the
other in-flight requests are untouched).  Each engine step decodes every
active slot in one batched step and retires slots on EOS or max tokens;
new requests admit the moment a slot frees.

The partition assignment is a live object around that loop:

* ``serve.monitor.FaultMonitor`` turns per-device error counters into
  estimated fault scales and a ``HEALTHY -> DEGRADED -> CRITICAL`` state
  (the oracle ``FaultEnvironment.scales_at`` stays available when no
  monitor is wired);
* a periodic canary evaluates the deployed partition's ΔAcc under the
  estimated scales; above θ it starts a ``core.runtime.ReoptJob``;
* the re-optimization runs one NSGA-II generation per step, on the host
  while the decode step's kernels run on the card, and commits a hot swap
  when it finishes;
* a hot swap changes only the per-layer fault-rate arguments of the
  decode step: the KV cache and every in-flight request keep their state;
* on CRITICAL the engine falls back to the last-known-safe partition at
  once, without waiting for the re-optimization.

The reference compiles its steps with ``jax.jit``; here they are eager
calls on the params' device.  The host waits on the card only to read
the tokens: each decode step's argmax, and at admission the first
token's.  Every array the host hands a step (tokens, positions, rates)
goes over as a pinned, non-blocking copy, and the fault seed (the decode
step count) stays a host int.

SLO accounting (per-request TTFT/TPOT timestamps, queue depth, swap
stall, monitor overhead) comes out of :meth:`Engine.stats`.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.serve.kvcache import merge_slot
from repro_torch.serve.monitor import HealthState

__all__ = ["ServeConfig", "Request", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8              # in-flight decode slots
    max_len: int = 256              # KV capacity per slot (prompt + output)
    canary_every: int = 16          # decode steps between canary evals
    theta: float = 0.01
    eos_token: int | None = None    # retire on this token (None: length only)
    reopt_generations_per_step: int = 1   # re-opt budget per decode step
    retrigger_margin: float = 0.2   # re-trigger only above last re-opt's
                                    # own ΔAcc x (1 + margin) — anti-thrash
    pipeline_stages: int | None = None    # record swap migration cost if set


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # SLO timestamps (time.perf_counter seconds)
    submit_s: float | None = None
    admit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_s is None or self.submit_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def tpot_s(self) -> float | None:
        if self.finish_s is None or self.first_token_s is None:
            return None
        return ((self.finish_s - self.first_token_s)
                / max(len(self.out) - 1, 1))


def _bucket(n: int) -> int:
    """Prefill length bucket: next power of two >= n (a length-n prompt
    right-aligns into it)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without making the host wait: pinned,
    then copied non-blocking (the pinned block is not reused before the
    copy has run).  On the CPU, a copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class Engine:
    """Greedy-decode continuous-batching engine.

    Args:
      fault_env: oracle environment, used for the canary's scales only
        when no ``monitor`` is given.
      reconfigurator: ``OnlineReconfigurator`` owning plan + re-opt.
      partition_to_rates: (partition, scales) -> per-layer (w, a) fault
        rates; what the deployed mapping costs under the environment.
      monitor: ``serve.monitor.FaultMonitor``, the telemetry path.
      error_source: callable(tick) -> per-device error counts fed to the
        monitor each tick (hardware counters in a deployment, a seeded
        sampler in a benchmark).

    The engine runs on the device of ``params``.  It serves decoder-only
    configs: admission prefills ``{"tokens": ...}`` alone.
    """

    def __init__(self, cfg: ArchConfig, params, serve_cfg: ServeConfig,
                 fault_env=None, reconfigurator=None,
                 partition_to_rates=None, monitor=None, error_source=None):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.device = params["embed"].device
        self.fault_env = fault_env              # step -> device scales
        self.reconf = reconfigurator            # OnlineReconfigurator
        self.partition_to_rates = partition_to_rates
        self.monitor = monitor
        self.error_source = error_source

        B = serve_cfg.max_batch
        self._queue: collections.deque[Request] = collections.deque()
        self._slots: list[Request | None] = [None] * B
        self._cache = None                      # allocated on first admit
        self._last = np.zeros(B, np.int32)      # next input token per slot
        self._pos = np.zeros(B, np.int32)
        self._active = np.zeros(B, bool)
        self.completed: list[Request] = []

        self._partition = (None if reconfigurator is None
                           else reconfigurator.plan.partition.copy())
        self._last_safe = (None if self._partition is None
                           else self._partition.copy())
        self._rates = None
        self._rates_key = None
        self._job = None                        # in-flight ReoptJob
        self._prev_state = None
        self._reopt_floor = None                # last re-opt's own ΔAcc

        self._steps = 0                         # decode steps
        self._ticks = 0                         # all step() calls
        self._admitted = 0
        self._max_queue_depth = 0
        self._last_observed = None
        self.observed_log: list[tuple[int, float]] = []
        self.swap_events: list[dict] = []
        self._decode_s = 0.0
        self._monitor_s = 0.0
        self._canary_s = 0.0
        self._reopt_gens = 0
        self._swap_stall_s = 0.0
        self._max_swap_stall_s = 0.0

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request; it admits when a slot frees."""
        if len(req.prompt) + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+max_new_tokens "
                f"{len(req.prompt)}+{req.max_new_tokens} exceeds "
                f"max_len={self.scfg.max_len}")
        if req.submit_s is None:
            req.submit_s = time.perf_counter()
        self._queue.append(req)

    def _admit(self, req: Request, i: int):
        S = _bucket(len(req.prompt))
        toks = np.zeros((1, S), np.int32)
        toks[0, S - len(req.prompt):] = req.prompt       # right-aligned
        logits, slot_cache = prefill(
            self.params, self.cfg, {"tokens": _to_device(toks, self.device)},
            max_len=self.scfg.max_len)
        first = int(torch.argmax(logits[0, -1]))          # the host waits
        now = time.perf_counter()
        req.admit_s = now
        req.out.append(first)
        req.first_token_s = time.perf_counter()
        self._admitted += 1
        if (len(req.out) >= req.max_new_tokens
                or first == self.scfg.eos_token):
            req.done = True
            req.finish_s = req.first_token_s
            self.completed.append(req)
            return                               # never occupied the slot
        if self._cache is None:
            self._cache = init_cache(self.cfg, self.scfg.max_batch,
                                     self.scfg.max_len, device=self.device)
        merge_slot(self._cache, slot_cache, i)
        self._slots[i] = req
        self._last[i] = first
        self._pos[i] = S
        self._active[i] = True

    def _retire(self, i: int):
        req = self._slots[i]
        req.done = True
        req.finish_s = time.perf_counter()
        self.completed.append(req)
        self._slots[i] = None
        self._active[i] = False

    # -- fault plumbing ------------------------------------------------------
    @property
    def partition(self) -> np.ndarray | None:
        """The deployed layer->tier mapping (may lead the reconfigurator's
        plan after a CRITICAL revert)."""
        return self._partition

    def _scales(self):
        """Device fault scales the control plane acts on: estimated from
        telemetry when a monitor is wired, oracle otherwise."""
        if self.monitor is not None:
            return self.monitor.estimated_scales()
        if self.fault_env is not None:
            return self.fault_env.scales_at(self._steps)
        return None

    def _fault_triple(self):
        """Current per-layer rates (on the device, copied once per
        partition and scales) from the deployed partition and the
        environment, and the seed: the decode step count, a host int."""
        if self._partition is None or self.partition_to_rates is None:
            return None
        scales = self._scales()
        key = (self._partition.tobytes(),
               None if scales is None else np.asarray(scales).tobytes())
        if key != self._rates_key:
            w, a = self.partition_to_rates(self._partition, scales)
            self._rates = tuple(_to_device(np.asarray(r, np.float32),
                                           self.device) for r in (w, a))
            self._rates_key = key
        return (*self._rates, self._steps)

    def apply_partition(self, partition: np.ndarray, kind: str = "manual",
                        pre_delta: float | None = None) -> dict:
        """Hot-swap the deployed layer->tier mapping.  O(1): the next
        decode step picks up new fault-rate arguments; the KV cache and
        every in-flight request are untouched."""
        t0 = time.perf_counter()
        old = self._partition
        self._partition = np.asarray(partition).copy()
        stall = time.perf_counter() - t0
        ev = {"step": self._steps, "kind": kind, "stall_s": stall,
              "pre_delta": pre_delta, "post_delta": None,
              "old_partition": None if old is None else old.copy(),
              "new_partition": self._partition.copy(),
              "migrated_layers": (0 if old is None
                                  else int((old != self._partition).sum()))}
        if self.scfg.pipeline_stages and old is not None:
            from repro_torch.launch.pipeline import swap_migration
            ev["migration"] = swap_migration(
                old, self._partition, self.cfg, self.scfg.pipeline_stages)
        self.swap_events.append(ev)
        self._swap_stall_s += stall
        self._max_swap_stall_s = max(self._max_swap_stall_s, stall)
        return ev

    # -- control plane (runs while the decode step's kernels run) -----------
    def _control_plane(self, state: HealthState | None):
        rec = self.reconf
        if rec is None:
            return
        # CRITICAL fast path: on the transition *edge*, revert to the
        # last-known-safe partition before re-opt ends.  Edge-triggered
        # so a plan re-optimized *during* a sustained CRITICAL phase
        # (fresher information than last_safe) is not fought.
        critical_edge = (state == HealthState.CRITICAL
                         and self._prev_state != HealthState.CRITICAL)
        if (critical_edge and self._last_safe is not None
                and not np.array_equal(self._partition, self._last_safe)):
            ev = self.apply_partition(self._last_safe, kind="revert",
                                      pre_delta=self._last_observed)
            self._job = None         # telemetry it was started on is stale
            self._reopt_floor = None
            c0 = time.perf_counter()
            ev["post_delta"] = float(rec.observe_fn(
                self._partition, self._scales()))
            self._canary_s += time.perf_counter() - c0
        # canary: observe deployed ΔAcc under current scales
        if self._steps % self.scfg.canary_every == 0:
            scales = self._scales()
            c0 = time.perf_counter()
            observed = float(rec.observe_fn(self._partition, scales))
            self._canary_s += time.perf_counter() - c0
            self._last_observed = observed
            self.observed_log.append((self._steps, observed))
            if observed <= rec.theta and state in (None, HealthState.HEALTHY):
                self._last_safe = self._partition.copy()
                self._reopt_floor = None     # environment recovered
            elif self._job is None and (
                    self._reopt_floor is None
                    or observed > self._reopt_floor
                    * (1.0 + self.scfg.retrigger_margin)):
                self._job = rec.start_reconfigure(
                    self._steps, observed, scales)
        # advance the off-critical-path re-optimization
        if self._job is not None:
            g0 = self._job.generations_run
            finished = self._job.advance(self.scfg.reopt_generations_per_step)
            self._reopt_gens += self._job.generations_run - g0
            if finished:
                job, self._job = self._job, None
                ev = self.apply_partition(job.plan.partition, kind="reopt",
                                          pre_delta=job.observed)
                c0 = time.perf_counter()
                ev["post_delta"] = float(rec.observe_fn(
                    self._partition, self._scales()))
                self._canary_s += time.perf_counter() - c0
                self._reopt_floor = ev["post_delta"]

    # -- the serving loop ----------------------------------------------------
    def step(self) -> bool:
        """One engine tick: monitor fold, admissions, one batched decode
        across active slots (the control plane runs while its kernels
        do), retirement.  Returns True if any decode work was done."""
        self._ticks += 1
        m0 = time.perf_counter()
        state = None
        if self.monitor is not None:
            if self.error_source is not None:
                self.monitor.observe_errors(self.error_source(self._ticks))
            self.monitor.heartbeat()
            state = self.monitor.tick()
        self._monitor_s += time.perf_counter() - m0

        while self._queue and not self._active.all():
            i = int(np.flatnonzero(~self._active)[0])
            self._admit(self._queue.popleft(), i)
        self._max_queue_depth = max(self._max_queue_depth, len(self._queue))

        if not self._active.any():
            if self._job is not None:      # drain re-opt during idle ticks
                self._control_plane(state)
            self._prev_state = state
            return False

        d0 = time.perf_counter()
        logits, self._cache = decode_step(
            self.params, self.cfg, self._cache,
            _to_device(self._last, self.device),
            _to_device(self._pos, self.device), fault=self._fault_triple())
        nxt = torch.argmax(logits, dim=-1)

        self._steps += 1
        self._control_plane(state)          # overlaps the decode's kernels
        self._prev_state = state

        nxt_np = nxt.cpu().numpy()          # the host waits
        self._decode_s += time.perf_counter() - d0

        for i in np.flatnonzero(self._active):
            req = self._slots[i]
            tok = int(nxt_np[i])
            req.out.append(tok)
            self._last[i] = tok
            self._pos[i] += 1
            if (len(req.out) >= req.max_new_tokens
                    or tok == self.scfg.eos_token):
                self._retire(i)
        return True

    def run(self, max_steps: int | None = None):
        """Serve until queue and slots drain (the early-exit property:
        no decode steps happen after the last retirement)."""
        n = 0
        while self._queue or self._active.any():
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    def generate(self, requests: list[Request]) -> list[Request]:
        """Closed-batch compatibility wrapper: submit all, run to done."""
        for r in requests:
            self.submit(r)
        self.run()
        return requests

    # -- SLO accounting ------------------------------------------------------
    def stats(self) -> dict:
        done = [r for r in self.completed if r.ttft_s is not None]
        return {
            "ticks": self._ticks,
            "decode_steps": self._steps,
            "admitted": self._admitted,
            "completed": len(self.completed),
            "in_flight": int(self._active.sum()),
            "queue_depth": len(self._queue),
            "max_queue_depth": self._max_queue_depth,
            "dropped": (self._admitted - len(self.completed)
                        - int(self._active.sum())),
            "swaps": sum(e["kind"] == "reopt" for e in self.swap_events),
            "reverts": sum(e["kind"] == "revert" for e in self.swap_events),
            "swap_stall_s_total": self._swap_stall_s,
            "swap_stall_s_max": self._max_swap_stall_s,
            "decode_s": self._decode_s,
            "monitor_s": self._monitor_s,
            "canary_s": self._canary_s,
            "reopt_generations": self._reopt_gens,
            "ttft_s_mean": (float(np.mean([r.ttft_s for r in done]))
                            if done else None),
            "tpot_s_mean": (float(np.mean([r.tpot_s for r in done
                                           if r.tpot_s is not None]))
                            if done else None),
            "health": (None if self.monitor is None
                       else self.monitor.state.name),
        }
