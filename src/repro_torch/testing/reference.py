"""The pre-engine ΔAcc path, the counterpart of
``repro/testing/reference.py``: one dispatch and one host read per
individual, no population batching.  The batched engines must stay
bitwise equal to it and measurably faster; a benchmark and the tests
consume this single copy so the baseline cannot drift between them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["loop_delta_acc"]


def loop_delta_acc(ev, P: np.ndarray) -> np.ndarray:
    """Per-individual ``delta_acc``: ``ev`` an
    ``InferenceAccuracyEvaluator``, ``P`` an ``[N, L]`` device-id matrix.
    Each row is one whole-forward dispatch of one row through the
    evaluator's fault backend, read back to the host at once."""
    P = np.asarray(P)
    clean = ev.clean_accuracy()
    out = np.empty(len(P))
    for i, row in enumerate(P):
        out[i] = max(0.0, clean - float(ev._dispatch(row[None])[0]))
    return out
