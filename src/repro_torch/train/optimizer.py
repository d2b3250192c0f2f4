"""AdamW with a warmup-cosine schedule, the counterpart of
``repro/train/optimizer.py``.

State is the reference's plain tree ``{"m", "v", "step"}`` (``step`` a
0-d int32 tensor), so it checkpoints like the params.  The schedule and
the bias corrections are float32 tensors computed on the step's device
from ``step``, as the reference computes them in float32: a Python double
would differ in the last bits of ``lr``, ``b1c`` and ``b2c``, and reading
``step`` to the host would make every step wait on the card.  Clipping
stays on the card for the same reason.

Sharded params and state (``launch/steps.py``: one tree a mesh slot, laid
out by ``param_specs`` / ``opt_state_specs``) update shard by shard; the
global norm then counts each distinct shard once (``counted``, from
``launch.shardings.owned``), summing the shards' squared sums.  A leaf's
squared sum is then split into up to (data x model) shard sums added in
slot order, so the norm differs from the whole-leaf norm by rounding: at
most about (k + 1) fp32 ulps of each leaf's squared sum for k extra
additions, a relative difference of a few 1e-7 (the clip scale follows
it; below the clip threshold the scale is exactly 1).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.trace import spanned

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "warmup_cosine",
           "clip_by_global_norm", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    # bf16 moments halve the optimizer's memory; the update is still
    # computed in fp32
    moments_dtype: str = "float32"

    @property
    def _mdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.moments_dtype == "bfloat16" \
            else torch.float32


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree, counted=None) -> torch.Tensor:
    """The norm over every leaf, on the first leaf's device (the leaves of
    a pipeline's params lie on several); ``counted`` (a tree of bools
    like ``tree``) leaves out the copies of a sharded tree's shards."""
    flat = tree_flatten(tree)[0]
    keep = [True] * len(flat) if counted is None \
        else tree_flatten(counted)[0]
    leaves = [torch.sum(torch.square(x.to(torch.float32))).to(flat[0].device)
              for x, k in zip(flat, keep) if k]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float, counted=None):
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    each leaf scaled in float32 and cast back to its dtype."""
    norm = global_norm(grads, counted)
    # a Python scalar over a tensor is its reciprocal times the scalar in
    # PyTorch (``Tensor.__rtruediv__``): divide as the reference does
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * _on(scale, g)).to(
        g.dtype), grads), norm


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` on ``like``'s device (itself when already there)."""
    return t.to(like.device)


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    dt = cfg._mdtype if cfg is not None else torch.float32
    zeros = lambda p: tree_map(lambda x: torch.zeros(  # noqa: E731
        x.shape, dtype=dt, device=x.device), p)
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else None
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
@spanned("train.adamw_update")
def adamw_update(cfg: AdamWConfig, params, grads, state, counted=None):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds the
    0-d tensors ``grad_norm`` (before clipping) and ``lr``.  ``counted``:
    see :func:`global_norm`."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, counted)
    step = state["step"] + 1
    lr = warmup_cosine(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    mdt = cfg._mdtype

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * gf * gf
        mh = m_new / _on(b1c, p)
        vh = v_new / _on(b2c, p)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        p_new = (p.to(torch.float32) - _on(lr, p) * delta).to(p.dtype)
        return p_new, m_new.to(mdt), v_new.to(mdt)

    flat_p, spec = tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_flatten(grads)[0], tree_flatten(state["m"])[0],
        tree_flatten(state["v"])[0])]
    new_p, new_m, new_v = (tree_unflatten(spec, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
