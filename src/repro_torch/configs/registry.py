"""Architecture registry, the counterpart of ``repro/configs/registry.py``.

``get_config(arch_id)`` resolves ``--arch`` flags; ``input_specs`` returns
``meta``-device stand-ins (shapes and dtypes, no memory) for every model
input of one (arch, shape) cell, the counterpart of the reference's
``jax.ShapeDtypeStruct``s; ``cells`` lists the cells.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCH_IDS", "get_config", "input_specs", "cells", "SHAPES"]

_MODULES = {
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4p2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
}
ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        # allow filename-style ids (underscores) too
        alt = {k.replace("-", "_").replace(".", "p"): k for k in _MODULES}
        arch_id = alt.get(arch_id, arch_id)
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors standing for the batch of one step.

    train/prefill: full-sequence inputs.  decode: one token per sequence
    and its position (the cache's stand-ins come from
    ``serve.kvcache.cache_specs``, their layout depending on the
    sharding).
    """
    B, S = shape.global_batch, shape.seq_len
    tok = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")  # noqa: E731
    emb = lambda *s: torch.empty(s, dtype=cfg.torch_dtype,  # noqa: E731
                                 device="meta")
    if shape.kind == "decode":
        batch = {"tokens": tok(B), "positions": tok(B)}
        if cfg.is_encdec:
            # decode against a fixed 4k-frame encoder memory (post-stub)
            batch["enc_embeds"] = emb(B, max(1, 4096 // cfg.enc_ratio),
                                      cfg.d_model)
        return batch
    if cfg.is_encdec:
        enc_len = max(1, S // cfg.enc_ratio)
        batch = {"tokens": tok(B, S), "enc_embeds": emb(B, enc_len, cfg.d_model)}
    elif cfg.frontend in ("vision", "audio"):
        # stub frontend: precomputed frame/patch embeddings
        batch = {"embeds": emb(B, S, cfg.d_model)}
    else:
        batch = {"tokens": tok(B, S)}
    if shape.kind == "train":
        batch["labels"] = tok(B, S)
    return batch


def cells(include_skips: bool = False):
    """Every (arch, shape) pair: ``(arch_id, shape_name, supported)``, the
    unsupported ``long_500k`` pairs only with ``include_skips``."""
    out = []
    for aid in ARCH_IDS:
        cfg = get_config(aid)
        for sname, sh in SHAPES.items():
            supported = cfg.supports_shape(sh)
            if supported or include_skips:
                out.append((aid, sname, supported))
    return out
