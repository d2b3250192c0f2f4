"""Population-level evaluation engine, the counterpart of the whole-forward
part of ``repro/core/eval_engine.py`` (``PopulationEvalEngine`` and its
chunking helpers).  The staged prefix engine and the multi-device
scheduler come with later slices.

The engine deduplicates rows inside a population, caches rows across
generations (evaluation is deterministic given the seed, so caching is
exact), and pushes the unique uncached rows through chunks of at most
``eval_batch_size`` rows, each padded by repeating its last row to a
power-of-two bucket.  Per-row results are independent of the other rows
of a chunk, so padding and chunk boundaries never change values.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["PopulationEvalEngine", "chunked_rows", "bucket_size",
           "pad_rows", "parse_eval_batch_size"]


def parse_eval_batch_size(value) -> int | str | None:
    """The CLI/config grammar for ``eval_batch_size``: ``None`` and
    ``"auto"`` pass through, anything else must be a positive int."""
    if value in (None, "auto"):
        return value
    n = int(value)
    if n < 1:
        raise ValueError(f"eval_batch_size must be >= 1, got {n}")
    return n


def bucket_size(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


def chunked_rows(n_rows: int, eval_batch_size: int | None
                 ) -> list[tuple[int, int, int]]:
    """Chunk plan: ``(start, stop, padded_size)`` per dispatch.  Full
    chunks hold ``eval_batch_size`` rows, a trailing partial chunk pads to
    its own power-of-two bucket; without a cap the whole batch is one
    chunk padded to the next power of two."""
    if n_rows <= 0:
        return []
    if eval_batch_size is None:
        return [(0, n_rows, bucket_size(n_rows))]
    bs = max(1, int(eval_batch_size))
    return [(s, min(s + bs, n_rows),
             min(bs, bucket_size(min(s + bs, n_rows) - s)))
            for s in range(0, n_rows, bs)]


def pad_rows(rows: np.ndarray, padded: int) -> np.ndarray:
    """Pad a chunk to ``padded`` rows by repeating the last row."""
    if padded <= len(rows):
        return rows
    pad = np.repeat(rows[-1:], padded - len(rows), axis=0)
    return np.concatenate([rows, pad], axis=0)


class PopulationEvalEngine:
    """Dedup + cache + chunked evaluation of integer rows.

    ``batch_fn(rows [U, L]) -> [U]`` evaluates one chunk and may return a
    device tensor: results are brought to the host once, after every
    chunk has been issued.
    """

    def __init__(self, batch_fn: Callable[[np.ndarray], object],
                 eval_batch_size: int | None = None):
        self.batch_fn = batch_fn
        self.eval_batch_size = eval_batch_size
        self._cache: dict[tuple, float] = {}
        self.dispatches = 0          # batch_fn calls
        self.rows_evaluated = 0      # unique rows actually computed

    @staticmethod
    def key(row: Sequence) -> tuple:
        return tuple(int(v) for v in row)

    def evaluate(self, P: np.ndarray) -> np.ndarray:
        """``P [N, L]`` integer rows -> ``[N]`` cached ``batch_fn`` values."""
        P = np.asarray(P)
        keys = [self.key(row) for row in P]
        fresh: dict[tuple, int] = {}
        for i, k in enumerate(keys):
            if k not in self._cache and k not in fresh:
                fresh[k] = i
        if fresh:
            rows = P[list(fresh.values())]
            fresh_keys = list(fresh)
            pending = []
            for start, stop, padded in chunked_rows(len(rows),
                                                    self.eval_batch_size):
                val = self.batch_fn(pad_rows(rows[start:stop], padded))
                self.dispatches += 1
                self.rows_evaluated += stop - start
                pending.append((fresh_keys[start:stop], val, stop - start))
            for chunk_keys, val, n in pending:
                vals = np.asarray(val.cpu() if hasattr(val, "cpu") else val)
                for k, v in zip(chunk_keys, vals[:n]):
                    self._cache[k] = float(v)
        return np.array([self._cache[k] for k in keys])
