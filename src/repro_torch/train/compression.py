"""int8 gradient compression with error feedback, the counterpart of
``repro/train/compression.py``: an all-reduce of quantized gradients over
the devices of one mesh axis (EF-SGD style).

    e      <- residual carried from the previous step
    q      <- quant8(g + e)                (one scale shared by the axis)
    e'     <- (g + e) - dequant(q)         (local, exact)
    g_hat  <- sum(dequant(q)) / n

One process drives the axis's devices (``launch/mesh.py``), so the
collective is a reduction the host orders: the shared scale is a max and
the payload sum an int32 sum, both exact in any order, so the result is
bitwise the reference's ``pmax``/``psum``.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["init_error_feedback", "compress_psum", "quant8", "dequant8"]


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


def compress_psum(grads: list, error_fb: list) -> tuple[list, list]:
    """Quantized all-reduce with error feedback over one mesh axis:
    ``grads`` and ``error_fb`` hold one tree a device of the axis (each
    tree's leaves on that device).  Returns ``(mean_grads, new_error_fb)``,
    one tree a device likewise: the mean in each leaf's dtype, equal on
    every device, and each device's own residual."""
    n = len(grads)
    flat = [tree_flatten(g) for g in grads]
    spec = flat[0][1]
    errs = [tree_flatten(e)[0] for e in error_fb]
    means = [[] for _ in range(n)]
    new_e = [[] for _ in range(n)]
    for j in range(len(flat[0][0])):
        gs = [f[0][j] for f in flat]
        gf = [g.to(torch.float32) + e[j] for g, e in zip(gs, errs)]
        home = gf[0].device
        amax = torch.stack([torch.max(torch.abs(t)).to(home)
                            for t in gf]).max()
        # divided by tensors: on the card PyTorch turns a division by a
        # Python scalar into a product with its reciprocal
        scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
        summed = None
        for i, t in enumerate(gf):
            s = scale.to(t.device)
            q = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
            new_e[i].append(t - q.to(torch.float32) * s)
            q32 = q.to(torch.int32).to(home)
            summed = q32 if summed is None else summed + q32
        g_hat = (summed.to(torch.float32) * scale
                 / torch.full_like(scale, n)).to(gs[0].dtype)
        for i, g in enumerate(gs):
            means[i].append(g_hat.to(g.device))
    return ([tree_unflatten(spec, m) for m in means],
            [tree_unflatten(spec, e) for e in new_e])
