"""The system under test for a CNN configuration: the port's ΔAcc
evaluator (kernel backend, staged, chain-fused) over the benchmark's
weights and images, and the AFarePart search over the model's layers."""
from __future__ import annotations

import numpy as np
import torch


class System:
    """What a cell drives: ``evaluator`` (``delta_acc``), ``partitioner``
    (a fresh ``AFarePart`` for an ``NSGA2Config``), ``n_units``,
    ``n_devices``, ``base_scale`` and ``set_env``.  ``devices`` is the
    cell's: its chips as a count (the first that many cards), or a list of
    slots."""

    def __init__(self, conf, made, device, devices):
        from repro_torch._device import fp32_exact
        from repro_torch.core import AFarePart, FaultSpec, \
            InferenceAccuracyEvaluator
        from repro_torch.core.costmodel import PAPER_DEVICES
        from repro_torch.models.cnn import (CNN_MODELS, FAULT_BITS,
                                            FAULTY_BITS, quantize_unit_params)

        ladders = {"paper": PAPER_DEVICES}
        f = conf["fault"]
        if (f["bits"], f["faulty_bits"]) != (FAULT_BITS, FAULTY_BITS):
            raise ValueError(
                f"the port's CNNs run {FAULT_BITS}-bit fixed point with "
                f"{FAULTY_BITS} faulty bits, not the {f['bits']} and "
                f"{f['faulty_bits']} that {conf['name']} states")
        model = CNN_MODELS[conf["model"]]
        params, x = made["params"], made["x"]
        z = torch.zeros((model.n_units,), dtype=torch.float32, device=device)
        with torch.no_grad(), fp32_exact():
            labels = torch.argmax(model.apply(params, x, z, z, 0), dim=-1)
        ladder = ladders[conf["ladder"]]
        self.base_scale = np.array([d.fault_scale for d in ladder], np.float32)
        spec = FaultSpec(**f)
        e = conf["evaluator"]
        self.evaluator = InferenceAccuracyEvaluator(
            model.apply, params, x, labels, spec, self.base_scale,
            base_seed=conf["base_seed"], eval_batch_size=e["eval_batch_size"],
            quant_params=quantize_unit_params(params, f["bits"]),
            fault_backend=e["fault_backend"], step_fn=model.step,
            eval_strategy=e["eval_strategy"],
            max_store_bytes=e["max_store_bytes"], fuse_chains=e["fuse_chains"],
            devices=devices, device=device)
        layers = model.layer_infos(conf["num_classes"], conf["width"],
                                   conf["img"])
        self.n_units, self.n_devices = model.n_units, len(ladder)

        def partitioner(nsga):
            return AFarePart(layers, ladder, fault_spec=spec,
                             acc_evaluator=self.evaluator, nsga2_config=nsga)
        self.partitioner = partitioner

    def set_env(self, scale: np.ndarray):
        self.evaluator.device_fault_scale = scale

    def stats(self) -> dict:
        return self.evaluator.staged_stats()
