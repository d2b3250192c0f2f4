"""Fault-tolerant training loop, the counterpart of
``repro/train/trainer.py``.

  * **Checkpoint/restart**: atomic checkpoints every N steps; on start the
    trainer restores the latest checkpoint AND fast-forwards the
    deterministic data pipeline, so a killed-and-relaunched run trains
    bit-identically to an uninterrupted one.
  * **Straggler mitigation**: a per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are logged and counted; after
    ``straggler_patience`` consecutive slow steps the ``on_straggler``
    callback fires (on a cluster: evict and re-mesh).
  * **Elastic re-meshing**: ``reshard_batch_spec`` keeps the global batch
    when the healthy-device count changes.

A step waits on the card once, where it reads its metrics to floats.  The
reference's ``jit`` argument has no counterpart, nor its ``monitor``
hook, which it stores and never calls.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint.ckpt import restore_latest, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import init_lm
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = ["TrainerConfig", "Trainer", "reshard_batch_spec"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    remat: bool = False
    straggler_factor: float = 3.0
    straggler_patience: int = 5
    seed: int = 0


class Trainer:
    """Trains ``params`` (default: ``init_lm(cfg, seed=tcfg.seed)``) on
    ``device`` from ``data_iter``, an iterator of numpy batches
    (``{"tokens", "labels"}``, optionally with ``state_dict`` /
    ``load_state_dict``)."""

    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, data_iter, *, params=None,
                 device="cuda",
                 on_straggler: Callable[[int], None] | None = None):
        self.device = resolve_device(device)
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.data = data_iter
        self.on_straggler = on_straggler
        self.params = init_lm(cfg, seed=tcfg.seed, device=self.device) \
            if params is None else tree_map(lambda t: t.to(self.device),
                                            params)
        self.opt_state = init_train_state(cfg, self.params)
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=tcfg.microbatches,
                                       remat=tcfg.remat)
        self.step = 0
        self.history: list[dict] = []
        self._ema = None
        self._slow_streak = 0
        self.straggler_events: list[int] = []

    # ------------------------------------------------------------------
    def try_restore(self) -> bool:
        tree = {"params": self.params, "opt": self.opt_state}
        restored, meta = restore_latest(self.tcfg.ckpt_dir, tree)
        if restored is None:
            return False
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(meta["step"])
        if hasattr(self.data, "load_state_dict"):
            self.data.load_state_dict(meta["extra"]["data"])
        return True

    def _checkpoint(self):
        extra = {}
        if hasattr(self.data, "state_dict"):
            extra["data"] = self.data.state_dict()
        save_checkpoint(self.tcfg.ckpt_dir, self.step,
                        {"params": self.params, "opt": self.opt_state},
                        keep=self.tcfg.ckpt_keep, extra=extra)

    def _watch_stragglers(self, dt: float):
        if self._ema is None:
            self._ema = dt
            return
        slow = dt > self.tcfg.straggler_factor * self._ema
        self._ema = 0.9 * self._ema + 0.1 * dt
        if slow:
            self._slow_streak += 1
            self.straggler_events.append(self.step)
            if (self._slow_streak >= self.tcfg.straggler_patience
                    and self.on_straggler is not None):
                self.on_straggler(self.step)
                self._slow_streak = 0
        else:
            self._slow_streak = 0

    def _to_device(self, a) -> torch.Tensor:
        """A numpy array on the card, through pinned memory without a wait
        (a plain tensor on the CPU)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    def run(self, max_steps: int | None = None) -> list[dict]:
        target = min(self.tcfg.total_steps,
                     self.step + (max_steps or self.tcfg.total_steps))
        while self.step < target:
            batch = {k: self._to_device(v) for k, v in next(self.data).items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            # the step's one wait on the card: every metric in one copy
            keys = list(metrics)
            vals = torch.stack([metrics[k].to(torch.float32)
                                for k in keys]).tolist()
            metrics = dict(zip(keys, vals))
            dt = time.perf_counter() - t0
            self._watch_stragglers(dt)
            self.step += 1
            metrics.update(step=self.step, dt=dt)
            self.history.append(metrics)
            if self.step % self.tcfg.ckpt_every == 0:
                self._checkpoint()
        return self.history


def reshard_batch_spec(global_batch: int, n_devices: int) -> int:
    """Elastic scaling helper: per-device batch preserving global batch.
    Raises if the device count cannot divide the global batch (caller
    then picks the nearest divisor and rescales lr)."""
    if global_batch % n_devices:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n_devices} devices")
    return global_batch // n_devices
