"""The pipeline's swap bookkeeping, the counterpart of
``repro/launch/pipeline.py``'s ``group_cuts`` and ``swap_migration``.

AFarePart's layer -> tier mapping induces a pipeline's stage split
(``contiguous_stages`` -> ``group_cuts``), so a hot swap that moves a cut
migrates that layer group's parameters between stages.  These functions
count that cost on the host; the pipeline itself is not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig

__all__ = ["group_cuts", "swap_migration"]


def group_cuts(layer_cuts: list[int], cfg: ArchConfig) -> list[int]:
    """Layer-granular AFarePart cuts -> group-granular pipeline cuts."""
    Pn = len(cfg.block_pattern)
    G = cfg.n_groups
    cuts = [0]
    for c in layer_cuts[1:-1]:
        g = min(max(round(c / Pn), cuts[-1] + 1), G - 1)
        cuts.append(g)
    cuts.append(G)
    return cuts


def swap_migration(old_partition, new_partition, cfg: ArchConfig,
                   n_stages: int) -> dict:
    """Which parameter groups change pipeline stage when the partition
    changes from ``old_partition`` to ``new_partition``:
    ``{"migrated_groups", "n_groups", "old_cuts", "new_cuts"}``."""
    from repro_torch.core.partitioner import contiguous_stages
    old_cuts = group_cuts(contiguous_stages(
        np.asarray(old_partition), n_stages), cfg)
    new_cuts = group_cuts(contiguous_stages(
        np.asarray(new_partition), n_stages), cfg)

    def stage_of(cuts):
        s = np.zeros(cuts[-1], dtype=np.int64)
        for i in range(len(cuts) - 1):
            s[cuts[i]:cuts[i + 1]] = i
        return s

    migrated = int((stage_of(old_cuts) != stage_of(new_cuts)).sum())
    return {"migrated_groups": migrated, "n_groups": old_cuts[-1],
            "old_cuts": old_cuts, "new_cuts": new_cuts}
