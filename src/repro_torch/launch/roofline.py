"""Roofline terms of a step, the counterpart of ``repro/launch/roofline.py``'s
``model_flops`` and ``roofline_terms``.

The hardware rates are arguments.  Their defaults are one NVIDIA H100 SXM
(NVIDIA H100 80GB HBM3 at its 700 W power limit; a card set lower runs
slower under load), from NVIDIA's H100 data sheet:
  * 989 TFLOP/s dense bf16 on the tensor cores;
  * 3.35 TB/s HBM3;
  * NVLink 4: the data sheet's 900 GB/s counts both directions of a
    card's 18 links together; a collective's payload crosses a link one
    way, so the default is the 450 GB/s of one direction.

Terms (seconds a step, aggregate over chips):
  compute    = flops / (chips x peak_flops)
  memory     = bytes_accessed / (chips x hbm_bw)
  collective = collective_bytes / (chips x link_bw)

A record's ``collective_bytes`` comes from the port's collectives'
counter (``launch/collectives.py``'s ``BYTES``, by the reference's
conventions: an all-gather its output bytes, an all-reduce 2x its input,
the others their input), the counterpart of the reference's
``collective_bytes_from_hlo``, which parses them out of XLA's HLO text;
``launch/dryrun.py`` fills the record.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "roofline_terms",
           "model_flops"]

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s, one H100 SXM at 700 W
HBM_BW = 3.35e12             # bytes/s, one H100 SXM
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction, one card


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs a step: 6·N·D for training (forward and
    backward), 2·N·D for prefill, 2·N·B for decode (one token a sequence);
    N counts active params (MoE: the routed top-k experts)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def roofline_terms(record: dict, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> dict:
    """The three terms of ``record`` (``n_chips``, ``flops``,
    ``bytes_accessed``, ``collective_bytes``), the largest as the
    bottleneck and the step-time lower bound, and each term's share of
    it."""
    chips = record["n_chips"]
    t_comp = record["flops"] / (chips * peak_flops)
    t_mem = record["bytes_accessed"] / (chips * hbm_bw)
    t_coll = record["collective_bytes"] / (chips * link_bw)
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = {k: (v / bound if bound > 0 else 0.0) for k, v in terms.items()}
    return {**terms,
            "bottleneck": bottleneck.replace("_s", ""),
            "step_time_lower_bound_s": bound,
            "balance": frac}
