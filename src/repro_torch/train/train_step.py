"""Loss and train step factory, the counterpart of
``repro/train/train_step.py``.

``make_train_step(cfg, opt_cfg)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)`` on the params' device.  Microbatching
(gradient accumulation in fp32) and remat keep a large config's
activations within the card's memory.  The step makes the host wait on
the card nowhere: its metrics are 0-d tensors the caller reads.

With ``fault=(w_rates, a_rates, seed)`` every block's params and input are
corrupted in the forward as the reference's ``forward(fault=...)`` does,
through the ``quant_bitflip`` kernel on the card, and the backward takes
the reference's gradient through them (``kernels.ops.quant_bitflip_group``
under autograd): it reaches a corrupted tensor through its row scale
alone, at the entries of its largest magnitude.

Params whose leaves are ``layers.Sharded`` (a data row's view of params
laid out over a mesh, ``launch/steps.py``) run the tensor-parallel
forward; its vocab-sliced logits (a list) take the cross entropy with the
slots' logsumexps combined.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch._device import fp32_exact
from repro_torch._tree import tree_flatten, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import collectives as C
from repro_torch.models.transformer import forward
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["cross_entropy_loss", "make_loss_fn", "make_train_step",
           "init_train_state"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean next-token cross entropy in fp32; labels == -1 are masked.

    The gold logit is read by one index a token into the flattened
    logits: its backward writes each gradient once, where a gather's
    backward adds them with atomics on the card.  ``logits`` may be a list
    of vocab slices, one a model slot (in vocab order): each slot takes
    its logsumexp and its gold logits (zero outside its range), the
    logsumexps are all-gathered and combined by one more logsumexp, the
    gold logits all-reduced (one nonzero: exact)."""
    if isinstance(logits, list):
        return _cross_entropy_sliced(logits, labels)
    logits = logits.to(torch.float32)
    V = logits.shape[-1]
    logz = torch.logsumexp(logits, dim=-1)
    flat = (torch.arange(labels.numel(), device=labels.device) * V
            + torch.clamp_min(labels.reshape(-1), 0))
    gold = logits.reshape(-1)[flat].reshape(labels.shape)
    nll = logz - gold
    mask = (labels >= 0).to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _cross_entropy_sliced(parts: list, labels: torch.Tensor) -> torch.Tensor:
    home = parts[0].device
    lse, gold, off = [], [], 0
    for t in parts:
        t = t.to(torch.float32)
        V, dev = t.shape[-1], t.device
        lab = labels.to(dev, non_blocking=True) - off
        inr = (lab >= 0) & (lab < V)
        flat = (torch.arange(lab.numel(), device=dev) * V
                + lab.reshape(-1).clamp(0, V - 1))
        gold.append(torch.where(inr, t.reshape(-1)[flat].reshape(lab.shape),
                                0.0))
        lse.append(torch.logsumexp(t, dim=-1)[None])
        off += V
    logz = torch.logsumexp(C.all_gather(lse, 0, [home])[0], dim=0)
    nll = logz - C.all_reduce(gold, [home])[0]
    mask = (labels.to(home) >= 0).to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def make_loss_fn(cfg: ArchConfig, remat: bool = True, fault=None,
                 unroll: bool = False, kv_chunk: int = 1024,
                 ssd_chunk: int = 256, seq_axis: str | None = None
                 ) -> Callable:
    """``loss_fn(params, batch)``: the forward's cross entropy against
    ``batch["labels"]``.  ``unroll`` (a scan option in the reference) has
    no effect on a Python loop.

    ``fault``: None, or the reference's ``(w_rates, a_rates, seed)``, the
    rates ``[L]`` float32 tensors by layer (encoder layers first) on the
    batch's device, the seed a host int.

    ``seq_axis``: the reference's sequence-parallel attention hint, passed
    to ``forward``: on tensor-parallel params it splits each attention's
    queries over the model slots; on whole params (no mesh) it does
    nothing.  It changes no value."""

    def loss_fn(params, batch):
        logits = forward(params, cfg,
                         {k: v for k, v in batch.items() if k != "labels"},
                         fault=fault, kv_chunk=kv_chunk, ssd_chunk=ssd_chunk,
                         remat=remat, seq_axis=seq_axis)
        return cross_entropy_loss(logits, batch["labels"])
    return loss_fn


def init_train_state(cfg: ArchConfig, params,
                     opt_cfg: AdamWConfig | None = None):
    return adamw_init(params, opt_cfg)


def _value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn`` at ``params``; a leaf the loss does
    not reach gets a zero gradient, as in JAX."""
    flat, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = loss_fn(tree_unflatten(spec, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree_unflatten(spec, list(grads))


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    fault=None, unroll: bool = False,
                    kv_chunk: int = 1024, ssd_chunk: int = 256,
                    seq_axis: str | None = None) -> Callable:
    """Gradient-accumulated train step.

    The global batch is split into ``microbatches`` chunks along axis 0;
    grads are accumulated in fp32 and averaged, the losses summed in fp32
    and divided, then one AdamW update is applied: the reference's
    ``lax.scan`` over the chunks, as a loop, every chunk under the same
    ``fault`` triple (see ``make_loss_fn``).  Float32 sums run in IEEE
    fp32 (``fp32_exact``), as the evaluators' do."""
    loss_fn = make_loss_fn(cfg, remat=remat, fault=fault, unroll=unroll,
                           kv_chunk=kv_chunk, ssd_chunk=ssd_chunk,
                           seq_axis=seq_axis)

    @fp32_exact()
    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            flat, spec = tree_flatten(params)
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in flat]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=flat[0].device)
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, b // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, g = _value_and_grad(loss_fn, params, mb)
                loss_sum = loss_sum + loss
                for a, gi in zip(gsum, tree_flatten(g)[0]):
                    a.add_(gi)
                del g
            loss = loss_sum / microbatches
            grads = tree_unflatten(spec, [a.div_(microbatches) for a in gsum])
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step
