"""The paper loop's setup for the three CNNs, the counterpart of
``benchmarks/_cnn_setup.py``: training on the synthetic Tiny-ImageNet
stand-in with a params cache, the calibration batch, the ΔAcc evaluator
under a chosen fault backend and strategy, and accuracy under a fixed
partition.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import fp32_exact, resolve_device
from repro_torch._tree import tree_flatten, tree_unflatten
from repro_torch.core import (PAPER_DEVICES, FaultSpec,
                              InferenceAccuracyEvaluator)
from repro_torch.data import ImageClassData
from repro_torch.models.cnn import (CNN_MODELS, build_weight_fault_tables,
                                    quantize_unit_params)

__all__ = ["NUM_CLASSES", "IMG", "WIDTH", "DATA", "DEVICE_FAULT_SCALE",
           "TRAIN_STEPS", "CACHE_DIR", "train", "get_trained", "eval_batch",
           "clean_argmax_labels", "make_evaluator",
           "accuracy_under_partition", "clean_accuracy"]

NUM_CLASSES = 16
IMG = 32
WIDTH = 0.5                   # the width the reference trains at
DATA = ImageClassData(num_classes=NUM_CLASSES, img=IMG, seed=0)
TRAIN_STEPS = {"alexnet": 500, "squeezenet": 1500, "resnet18": 800}
# trained params, git-ignored, beside the reference's results/cnn_params
CACHE_DIR = Path(__file__).resolve().parents[2] / "results" / \
    "torch_cnn_params"

# Eyeriss is the fault-prone tier, SIMBA the protected one.
DEVICE_FAULT_SCALE = np.array([d.fault_scale for d in PAPER_DEVICES])


@fp32_exact()
def train(name: str, params, steps: int, batch: int = 64,
          lr: float = 2e-3):
    """``steps`` of SGD with momentum 0.9 (``m = 0.9 m + g; p -= lr m``)
    on the logsumexp cross-entropy of the float model, batch ``i`` drawn
    from ``DATA`` at seed ``1000 + i``: the reference's training loop.
    Returns new params; ``params`` is left as it was.

    oneDNN is off while it trains: its multi-threaded backward of a
    strided 1x1 convolution on a channels-last input (ResNet18's
    projections) aborts the process on the CPU (torch 2.13.0+cpu, more
    than two threads).  The setting changes nothing on the card."""
    model = CNN_MODELS[name]
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    moms = [torch.zeros_like(p) for p in leaves]
    dev = leaves[0].device
    onednn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        for i in range(steps):
            x, y = DATA.batch(batch, seed=1000 + i)
            x = torch.as_tensor(x, device=dev)
            y = torch.as_tensor(y, device=dev)
            logits = model.apply(tree_unflatten(treedef, leaves), x)
            gold = logits.gather(-1, y[:, None])[:, 0]
            loss = (torch.logsumexp(logits, -1) - gold).mean()
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for p, g, m in zip(leaves, grads, moms):
                    m.mul_(0.9).add_(g)
                    p.sub_(lr * m)
    finally:
        torch.backends.mkldnn.enabled = onednn
    return tree_unflatten(treedef, [p.detach() for p in leaves])


def get_trained(name: str, steps: int | None = None, seed: int = 0,
                device="cuda"):
    """Train-or-load params for one of the paper's CNNs at ``WIDTH``:
    init from the ``torch.Generator`` seed ``seed``, ``steps`` (default
    ``TRAIN_STEPS[name]``) of :func:`train`, cached in ``CACHE_DIR`` per
    (name, width, steps, seed)."""
    dev = resolve_device(device)
    steps = steps or TRAIN_STEPS.get(name, 500)
    model = CNN_MODELS[name]
    params = model.init(seed, NUM_CLASSES, width=WIDTH, img=IMG, device=dev)
    leaves, treedef = tree_flatten(params)
    path = Path(CACHE_DIR) / f"{name}_w{WIDTH}_s{steps}_seed{seed}.npz"
    if path.exists():
        with np.load(path) as data:
            cached = [data[f"arr_{j}"] for j in range(len(data.files))]
        if [a.shape for a in cached] == [tuple(p.shape) for p in leaves]:
            return tree_unflatten(treedef, [torch.as_tensor(a, device=dev)
                                            for a in cached])
    params = train(name, params, steps)
    os.makedirs(path.parent, exist_ok=True)
    np.savez(path, *[p.cpu().numpy() for p in tree_flatten(params)[0]])
    return params


def eval_batch(n=512, seed=99, device="cuda"):
    """The calibration batch: NHWC float32 images and int64 labels."""
    dev = resolve_device(device)
    x, y = DATA.batch(n, seed=seed)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


@torch.no_grad()
@fp32_exact()
def clean_argmax_labels(name: str, params, n_eval=512, device="cuda"):
    """Labels equal to the clean quantized model's own argmax on the
    calibration batch: clean accuracy is then 1 and ΔAcc a pure
    corruption measure (for params that were never trained)."""
    model = CNN_MODELS[name]
    x, _ = eval_batch(n_eval, device=device)
    z = torch.zeros((model.n_units,), dtype=torch.float32, device=x.device)
    return torch.argmax(model.apply(params, x, z, z, 0), dim=-1)


def make_evaluator(name: str, params, fault_spec: FaultSpec, n_eval=512,
                   eval_batch_size=None, fault_backend="kernel",
                   labels=None, eval_strategy="staged",
                   max_store_bytes: int | None = 256 << 20,
                   fuse_chains: bool = True, devices="auto",
                   device="cuda") -> InferenceAccuracyEvaluator:
    """ΔAcc evaluator for one of the paper's CNNs.

    The default path is the staged prefix-reuse engine with chain fusion
    (``step_fn=model.step``), as in the reference; ``eval_strategy="full"``
    selects the whole-forward path, bitwise the same.
    ``fault_backend`` is ``"kernel"`` (one resident integer copy of the
    weights; the CUDA fault kernels on the card), ``"tables"`` (weights
    pre-corrupted per (unit, device)) or ``"generic"``.  ``labels``
    replaces the data's labels (e.g. :func:`clean_argmax_labels`).
    ``eval_batch_size`` None gives ~512 images of activations per
    dispatch, one row per chunk at ``n_eval=512``; ``"auto"`` sizes the
    chunk to the card's memory.  ``max_store_bytes`` caps the staged
    activation store.  ``devices`` spreads the dispatches over a pool of
    device slots (``core.eval_engine.DeviceScheduler``; a list of devices
    is the pool); placement never changes a value.
    """
    model = CNN_MODELS[name]
    x, y = eval_batch(n_eval, device=device)
    if labels is not None:
        y = torch.as_tensor(labels, device=x.device)
    if eval_batch_size is None and n_eval >= 16:
        eval_batch_size = max(1, 512 // n_eval)
    tables = qparams = None
    if fault_backend == "tables":
        w_rates = np.asarray(fault_spec.weight_fault_rate
                             * np.asarray(DEVICE_FAULT_SCALE, np.float32),
                             np.float32)
        tables = build_weight_fault_tables(params, w_rates, base_seed=0)
    elif fault_backend == "kernel":
        qparams = quantize_unit_params(params)
    return InferenceAccuracyEvaluator(
        model.apply, params, x, y, fault_spec, DEVICE_FAULT_SCALE,
        eval_batch_size=eval_batch_size, weight_tables=tables,
        quant_params=qparams, fault_backend=fault_backend,
        step_fn=model.step, eval_strategy=eval_strategy,
        max_store_bytes=max_store_bytes, fuse_chains=fuse_chains,
        devices=devices, device=device)


@torch.no_grad()
@fp32_exact()
def accuracy_under_partition(name: str, params, partition: np.ndarray,
                             weight_rate: float, act_rate: float,
                             n_eval=512, seed=0, labels=None,
                             device="cuda") -> float:
    """Top-1 accuracy with each unit's rate = base rate x its device's
    fault scale (the paper's platform-targeted strategy)."""
    model = CNN_MODELS[name]
    x, y = eval_batch(n_eval, device=device)
    if labels is not None:
        y = torch.as_tensor(labels, device=x.device)
    scale = DEVICE_FAULT_SCALE[np.asarray(partition)]
    wr = torch.as_tensor(np.asarray(weight_rate * scale, np.float32),
                         device=x.device)
    ar = torch.as_tensor(np.asarray(act_rate * scale, np.float32),
                         device=x.device)
    logits = model.apply(params, x, wr, ar, seed)
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())


@torch.no_grad()
@fp32_exact()
def clean_accuracy(name: str, params, n_eval=512, labels=None,
                   device="cuda") -> float:
    """Top-1 of the float model (no quantization)."""
    model = CNN_MODELS[name]
    x, y = eval_batch(n_eval, device=device)
    if labels is not None:
        y = torch.as_tensor(labels, device=x.device)
    logits = model.apply(params, x)
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())
