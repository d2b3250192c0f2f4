"""The analytic latency and energy of a layer-to-device mapping, written
out from its definition (numpy, float64), with the device ladders the
configurations name.

Per layer ``l`` on device ``d`` (``bytes = weight + act_in + act_out``):

    latency = max(macs / peak_macs, bytes / dram_bw) + dispatch_s
    energy  = (macs * pj_per_mac + bytes * pj_per_byte) * 1e-12

and a mapping's latency and energy are the sums over its layers (no link
costs: the paper leaves them out).  A layer is ``(macs, weight_bytes,
act_in_bytes, act_out_bytes)`` per sample, batch 1.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np

# name: (peak_macs, dram_bw, pj_per_mac, pj_per_byte, dispatch_s, fault_scale)
_EYERISS = (76.8e9, 12.8e9, 0.35, 6.0, 20e-6, 1.0)
_SIMBA = (2.0e12, 64e9, 0.9, 8.0, 8e-6, 0.35)
_V5E = (98.5e12, 819e9, 0.20, 2.5, 2e-6, 0.1)
_V5E_LOWVOLT = (98.5e12, 819e9, 0.13, 1.8, 2e-6, 1.0)
_V5E_MID = (98.5e12, 819e9, 0.16, 2.1, 2e-6, 0.5)
_V5E_ECC = (88e12, 819e9, 0.24, 2.5, 2e-6, 0.02)

LADDERS = {
    # the paper's two edge accelerators: Eyeriss (fault-prone), SIMBA
    "paper": (_EYERISS, _SIMBA),
    # four TPU v5e pod tiers: low-voltage, mid DVFS, nominal, ECC-heavy
    "pod_tiers_4": (_V5E_LOWVOLT, _V5E_MID, _V5E, _V5E_ECC),
}


def fault_scales(ladder: str) -> np.ndarray:
    """The ladder's relative fault rates, float32, one a device."""
    return np.array([d[5] for d in LADDERS[ladder]], np.float32)


def tables(layers, ladder: str) -> tuple[np.ndarray, np.ndarray]:
    """``[L, D]`` latency (s) and energy (J) of each layer on each device."""
    devs = LADDERS[ladder]
    lat = np.zeros((len(layers), len(devs)))
    en = np.zeros((len(layers), len(devs)))
    for li, (macs, wb, ab_in, ab_out) in enumerate(layers):
        moved = (wb + ab_in + ab_out) * 1.0
        for di, (peak, bw, pjm, pjb, disp, _) in enumerate(devs):
            lat[li, di] = max(macs / peak, moved / bw) + disp
            en[li, di] = (macs * pjm + moved * pjb) * 1e-12
    return lat, en


def latency_energy(layers, ladder: str, P: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Latency and energy of each mapping of ``P [N, L]``."""
    lat, en = tables(layers, ladder)
    cols = np.arange(len(layers))[None, :]
    return lat[cols, P].sum(axis=1), en[cols, P].sum(axis=1)
