"""The paper loop's setup for the three CNNs, the counterpart of
``benchmarks/_cnn_setup.py`` without training: the synthetic calibration
batch, the ΔAcc evaluator under a chosen fault backend, and accuracy
under a fixed partition.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (PAPER_DEVICES, FaultSpec,
                              InferenceAccuracyEvaluator)
from repro_torch.data import ImageClassData
from repro_torch.models.cnn import (CNN_MODELS, build_weight_fault_tables,
                                    quantize_unit_params)

__all__ = ["NUM_CLASSES", "IMG", "DATA", "DEVICE_FAULT_SCALE", "eval_batch",
           "clean_argmax_labels", "make_evaluator",
           "accuracy_under_partition", "clean_accuracy"]

NUM_CLASSES = 16
IMG = 32
DATA = ImageClassData(num_classes=NUM_CLASSES, img=IMG, seed=0)

# Eyeriss is the fault-prone tier, SIMBA the protected one.
DEVICE_FAULT_SCALE = np.array([d.fault_scale for d in PAPER_DEVICES])


def eval_batch(n=512, seed=99, device="cuda"):
    """The calibration batch: NHWC float32 images and int64 labels."""
    dev = resolve_device(device)
    x, y = DATA.batch(n, seed=seed)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


@torch.no_grad()
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
                   labels=None, device="cuda") -> InferenceAccuracyEvaluator:
    """Whole-forward ΔAcc evaluator for one of the paper's CNNs.

    ``fault_backend`` is ``"kernel"`` (one resident integer copy of the
    weights; the CUDA fault kernels on the card), ``"tables"`` (weights
    pre-corrupted per (unit, device)) or ``"generic"``.  ``labels``
    replaces the data's labels (e.g. :func:`clean_argmax_labels`).
    ``eval_batch_size`` None gives ~512 images of activations per
    dispatch, one row per chunk at ``n_eval=512``.
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
        eval_strategy="full", device=device)


@torch.no_grad()
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
def clean_accuracy(name: str, params, n_eval=512, labels=None,
                   device="cuda") -> float:
    """Top-1 of the float model (no quantization)."""
    model = CNN_MODELS[name]
    x, y = eval_batch(n_eval, device=device)
    if labels is not None:
        y = torch.as_tensor(labels, device=x.device)
    logits = model.apply(params, x)
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())
