"""int8 gradient compression with error feedback, the counterpart of
``repro/train/compression.py`` less ``compress_psum``: that one is a
collective, and goes with the process group of ROADMAP item 14.

    e      <- residual carried from the previous step
    q      <- quant8(g + e)
    e'     <- (g + e) - dequant(q)         (local, exact)
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map

__all__ = ["init_error_feedback", "quant8", "dequant8"]


def quant8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32)``: one scale for the whole tensor,
    round half to even, clipped to +-127."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequant8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
