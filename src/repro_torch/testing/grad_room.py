"""How far another summation order may move a fault-injected gradient.

Under fault injection a corrupted leaf's gradient reaches x through its
row scale alone (``kernels.ref.quant_bitflip_grad_ref``): each nonzero
entry is ``d s = sum_j g_j q'_j`` of its row, over ``qmax`` and the tied
entries.  Its terms may cancel, so a small relative change of the
cotangent ``g`` (another order of the sums that made it) moves ``d s`` by
that change times ``sum_j |g_j q'_j|``, not times ``|d s|``.
``scale_grad_room`` gives that sum, carried to the leaf's entries as the
gradient itself is, for a test to scale by the relative change it allows.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import ref
from repro_torch.models import layers

__all__ = ["scale_grad_room"]


def scale_grad_room(grad_fn, params):
    """``grad_fn(params)`` (a faulted loss's gradient tree, as
    ``train_step._value_and_grad`` returns it second) run once more with
    the backward of every corrupted weight leaf returning, in place of
    its gradient, ``sum_j |g_j q'_j| / qmax`` of each row on the entries
    where the gradient is nonzero (shared among them).  Activations keep
    their true gradient, so every cotangent upstream is the real one.
    Returns a tree like ``params``: that room on each leaf the faulted
    forward corrupted, pulled back to it as its gradient is (an
    expanded leaf sums its rows), and 0 on every other leaf."""
    grad_ref, corrupt = ref.quant_bitflip_grad_ref, layers.corrupt_leaves
    weights = set()

    def corrupt_leaves(leaves, *args, **kw):
        weights.update(t.data_ptr() for t in leaves
                       if isinstance(t, torch.Tensor))
        return corrupt(leaves, *args, **kw)

    def room(x, q, g, spec):
        d = grad_ref(x, q, g, spec)
        if x.data_ptr() not in weights:
            return d
        R = q.shape[0]
        s = (g.reshape(R, -1).float().abs() * q.float().abs()).sum(
            1, keepdim=True) * spec.inv_qmax
        hit = d.reshape(R, -1) != 0
        return torch.where(hit, s / hit.sum(1, keepdim=True).clamp_min(1),
                           0.0).to(x.dtype).reshape(x.shape)

    ref.quant_bitflip_grad_ref, layers.corrupt_leaves = room, corrupt_leaves
    try:
        grads = grad_fn(params)
    finally:
        ref.quant_bitflip_grad_ref, layers.corrupt_leaves = grad_ref, corrupt

    def within(p, r):
        lo = p.data_ptr()
        hi = lo + p.numel() * p.element_size()
        return r if any(lo <= w < hi for w in weights) else torch.zeros_like(r)

    return tree_map(within, params, grads)
