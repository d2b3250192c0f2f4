"""Fault monitor: the telemetry half of the paper's online phase, the
counterpart of ``repro/serve/monitor.py``.  It is numpy only, and the
port keeps its own copy, whose outputs are the reference's bitwise.

The offline phase plans against *assumed* per-device fault scales; the
online phase (Alg. 1, lines 13-19) needs the *current* ones.  On the
paper's FPGA deployment those come from hardware error counters (ECC
syndromes, CRC failures, voltage alarms); here :class:`FaultMonitor`
consumes per-device error counts per serving tick and maintains:

* an EWMA of the per-device error rate, converted to an estimated
  fault-scale multiplier via the calibrated ``base_error_rate``
  (expected errors/tick at scale 1.0) and quantised to
  ``scale_quantum`` so jitter does not thrash the ΔAcc evaluator's
  environment-keyed caches (``device_fault_scale`` no-ops on equal
  arrays);
* watchdog heartbeats — a device that stops reporting for
  ``watchdog_timeout_ticks`` is presumed dead and forced CRITICAL;
* a per-device degraded-state machine ``HEALTHY → DEGRADED →
  CRITICAL`` keyed on the ratio of estimated to baseline scale, with
  hysteresis: escalation is immediate, recovery requires
  ``recovery_ticks`` consecutive calmer ticks.

The serving engine feeds :meth:`estimated_scales` to
``OnlineReconfigurator`` in place of oracle ``scales_at`` lookups and
keys its CRITICAL fast path (revert to last-known-safe partition) on
the overall :attr:`state`.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

__all__ = ["HealthState", "MonitorConfig", "FaultMonitor"]


class HealthState(enum.IntEnum):
    """Degradation tiers, ordered so ``max`` aggregates across devices."""
    HEALTHY = 0
    DEGRADED = 1
    CRITICAL = 2


@dataclasses.dataclass
class MonitorConfig:
    base_error_rate: float = 0.25     # expected errors/tick/device at scale 1
    ewma_alpha: float = 0.25          # EWMA weight of the newest tick
    scale_quantum: float = 0.25       # estimated scales snap to this grid
    degraded_factor: float = 4.0      # est/base ratio that enters DEGRADED
    critical_factor: float = 16.0     # est/base ratio that enters CRITICAL
    recovery_ticks: int = 8           # calm ticks required to de-escalate
    watchdog_timeout_ticks: int = 64  # silent ticks before presumed dead


class FaultMonitor:
    """Per-device error telemetry -> estimated fault scales + health."""

    def __init__(self, base_scale: np.ndarray,
                 config: MonitorConfig = MonitorConfig()):
        self.base_scale = np.asarray(base_scale, dtype=float)
        self.config = config
        D = self.base_scale.shape[0]
        # start the EWMA at the baseline expectation so a clean device
        # reads exactly its base scale before any evidence arrives
        self._ewma = self.base_scale * config.base_error_rate
        self._pending = np.zeros(D)
        self._device_state = np.zeros(D, dtype=np.int64)
        self._calm = np.zeros(D, dtype=np.int64)
        self._last_heartbeat = np.zeros(D, dtype=np.int64)
        self.ticks = 0
        self.errors_total = np.zeros(D, dtype=np.int64)
        self.transitions: list[tuple[int, int, HealthState, HealthState]] = []

    # -- telemetry ingestion -------------------------------------------------
    def observe_errors(self, counts: np.ndarray):
        """Accumulate per-device error counts for the current tick."""
        c = np.asarray(counts, dtype=float)
        self._pending += c
        self.errors_total += c.astype(np.int64)

    def heartbeat(self, device: int | None = None):
        """Mark device liveness (all devices when ``device`` is None)."""
        if device is None:
            self._last_heartbeat[:] = self.ticks
        else:
            self._last_heartbeat[device] = self.ticks

    # -- per-tick fold -------------------------------------------------------
    def tick(self) -> HealthState:
        """Fold the pending counts into the EWMA, advance the state
        machine, return the overall (worst-device) health state."""
        cfg = self.config
        a = cfg.ewma_alpha
        self._ewma = (1.0 - a) * self._ewma + a * self._pending
        self._pending[:] = 0.0
        self.ticks += 1

        dead = (self.ticks - self._last_heartbeat
                > cfg.watchdog_timeout_ticks)
        ratio = self._ewma / np.maximum(
            self.base_scale * cfg.base_error_rate, 1e-12)
        target = np.where(ratio >= cfg.critical_factor,
                          int(HealthState.CRITICAL),
                          np.where(ratio >= cfg.degraded_factor,
                                   int(HealthState.DEGRADED),
                                   int(HealthState.HEALTHY)))
        target = np.where(dead, int(HealthState.CRITICAL), target)

        escalate = target > self._device_state
        self._calm = np.where(target < self._device_state, self._calm + 1, 0)
        recover = self._calm >= cfg.recovery_ticks
        new_state = np.where(escalate, target,
                             np.where(recover, target, self._device_state))
        self._calm = np.where(recover, 0, self._calm)
        for d in np.flatnonzero(new_state != self._device_state):
            self.transitions.append(
                (self.ticks, int(d), HealthState(int(self._device_state[d])),
                 HealthState(int(new_state[d]))))
        self._device_state = new_state
        return self.state

    # -- views ---------------------------------------------------------------
    def estimated_scales(self) -> np.ndarray:
        """Current per-device fault-scale estimates, quantised."""
        q = self.config.scale_quantum
        raw = self._ewma / self.config.base_error_rate
        return np.round(raw / q) * q

    def device_states(self) -> list[HealthState]:
        return [HealthState(int(s)) for s in self._device_state]

    @property
    def state(self) -> HealthState:
        return HealthState(int(self._device_state.max(initial=0)))

    def stats(self) -> dict:
        return {
            "ticks": self.ticks,
            "errors_total": self.errors_total.tolist(),
            "estimated_scales": self.estimated_scales().tolist(),
            "device_states": [s.name for s in self.device_states()],
            "state": self.state.name,
            "transitions": len(self.transitions),
        }
