"""The LM calibration fixture, the counterpart of
``repro/testing/lm_harness.py``: model params, a calibration token batch
and self-labels (the clean model's own argmax, so clean accuracy is ~1 and
ΔAcc measures corruption alone; random labels would pin every accuracy at
chance).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import fp32_exact, resolve_device
from repro_torch.models.transformer import forward, init_lm

__all__ = ["lm_calibration_setup", "calibration_batch", "self_labels"]


def calibration_batch(cfg, B: int = 2, S: int = 16, seed: int = 7,
                      device="cuda") -> dict:
    """``{"tokens": [B, S] int32}`` from ``np.random.default_rng(seed)``,
    the reference harness's draw; the encoder-decoder's batch also holds
    ``"enc_embeds" [B, max(1, S // enc_ratio), D]`` float32, drawn from
    the same generator after the tokens."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    if cfg.is_encdec:
        enc = rng.standard_normal((B, max(1, S // cfg.enc_ratio),
                                   cfg.d_model)).astype(np.float32)
        batch["enc_embeds"] = torch.from_numpy(enc).to(dev)
    return batch


@torch.no_grad()
@fp32_exact()
def self_labels(cfg, params: dict, batch: dict) -> torch.Tensor:
    """``[B, S]`` argmax of the clean float forward."""
    return torch.argmax(forward(params, cfg, batch), dim=-1)


def lm_calibration_setup(cfg, B: int = 2, S: int = 16, seed: int = 7,
                         param_seed: int = 0, device="cuda"):
    """``(params, batch, labels)`` for ``cfg`` (already reduced by the
    caller if a small scale is wanted): params from ``init_lm`` with a
    generator seeded by ``param_seed``, tokens from a numpy seed."""
    params = init_lm(cfg, seed=param_seed, device=device)
    batch = calibration_batch(cfg, B, S, seed, device)
    return params, batch, self_labels(cfg, params, batch)
