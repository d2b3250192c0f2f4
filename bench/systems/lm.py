"""The system under test for a language-model configuration: the port's
ΔAcc evaluator (kernel backend, staged) over the benchmark's weights and
calibration tokens, its own self-labels, and ``lm_partitioner``'s
AFarePart search over the model's layer graph."""
from __future__ import annotations

import dataclasses

import numpy as np


def arch_config(conf):
    """The port's ``ArchConfig`` for the configuration file's sizes; a size
    the port cannot take is refused, not approximated."""
    from repro_torch.configs import get_config

    a = conf["arch"]
    cfg = dataclasses.replace(
        get_config(conf["program_arch"]), n_layers=a["num_hidden_layers"],
        d_model=a["hidden_size"], n_heads=a["num_attention_heads"],
        n_kv_heads=a["num_key_value_heads"], d_ff=a["intermediate_size"],
        vocab=a["embedding_size"], head_dim=a["head_dim"],
        rope_theta=float(a["rope_theta"]), dtype=conf["dtype"])
    if a["layer_norm_eps"] != 1e-6 or cfg.norm_kind != "np_layernorm" \
            or cfg.act_fn != "silu_glu" or not cfg.tie_embeddings:
        raise ValueError(f"the port's {conf['program_arch']} does not run "
                         f"the configuration {conf['name']} states")
    return cfg


class System:
    def __init__(self, conf, made, device, devices):
        from repro_torch.core import (POD_TIERS_4, FaultSpec, lm_partitioner,
                                      make_lm_accuracy_evaluator)
        from repro_torch.lm_setup import self_labels

        ladders = {"pod_tiers_4": POD_TIERS_4}
        cfg = arch_config(conf)
        batch = {"tokens": made["tokens"]}
        labels = self_labels(cfg, made["params"], batch)
        ladder = ladders[conf["ladder"]]
        self.base_scale = np.array([d.fault_scale for d in ladder], np.float32)
        spec = FaultSpec(**conf["fault"])
        e = conf["evaluator"]
        self.evaluator = make_lm_accuracy_evaluator(
            cfg, made["params"], batch, labels, spec, self.base_scale,
            base_seed=conf["base_seed"], eval_batch_size=e["eval_batch_size"],
            eval_strategy=e["eval_strategy"],
            max_store_bytes=e["max_store_bytes"], devices=devices,
            fuse_chains=e["fuse_chains"], fault_backend=e["fault_backend"],
            device=device)
        self.n_units, self.n_devices = cfg.n_layers, len(ladder)

        def partitioner(nsga):
            return lm_partitioner(cfg, self.evaluator, devices=ladder,
                                  fault_spec=spec,
                                  fault_backend=e["fault_backend"],
                                  nsga2_config=nsga)
        self.partitioner = partitioner

    def set_env(self, scale: np.ndarray):
        self.evaluator.device_fault_scale = scale

    def stats(self) -> dict:
        return self.evaluator.staged_stats()
