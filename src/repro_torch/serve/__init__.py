"""Serving, the counterpart of ``repro.serve``: the continuous-batching
engine with live fault-resilient re-partitioning, its KV-cache slot
operations and the fault monitor."""
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.serve.kvcache import (cache_bytes, cache_specs, merge_slot,
                                       slot_bytes)
from repro_torch.serve.monitor import FaultMonitor, HealthState, MonitorConfig

__all__ = ["Engine", "Request", "ServeConfig", "cache_bytes", "cache_specs",
           "merge_slot", "slot_bytes",
           "FaultMonitor", "HealthState", "MonitorConfig"]
