"""Deterministic synthetic data pipelines, a copy of
``repro/data/synthetic.py`` (numpy only; identical outputs per seed).

Two generators:

  * ``TokenStream`` — structured token sequences for LM training
    (a noisy order-k Markov chain: learnable, so loss decreases are a
    real signal, not memorised noise).
  * ``ImageClassData`` — the Tiny-ImageNet stand-in for the paper's CNN
    experiments: class-conditional Gabor-like textures + Gaussian blob
    composites.  16-way classification at 32x32; CNNs reach >90 % clean
    accuracy in a few hundred CPU steps, giving the fault experiments a
    meaningful accuracy scale (see DESIGN.md §7).

Both are shard-aware: ``shard(host_id, n_hosts)`` partitions the stream
deterministically so multi-host training reads disjoint data, and
``state_dict()/load_state_dict()`` make the pipeline checkpointable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream", "ImageClassData"]


class TokenStream:
    """Order-1 Markov token stream with per-class transition sharpening."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._step = 0
        rng = np.random.default_rng(seed)
        # sparse-ish transition matrix => predictable structure
        logits = rng.standard_normal((vocab, vocab)) * 3.0
        self._P = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self._cum = np.cumsum(self._P, axis=-1)

    def state_dict(self) -> dict:
        return {"step": self._step}

    def load_state_dict(self, d: dict):
        self._step = int(d["step"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        # derive the batch rng from (seed, global step, host) => resumable
        rng = np.random.default_rng(
            (self.seed, self._step, self.host_id))
        self._step += 1
        b = self.batch
        toks = np.zeros((b, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        u = rng.random((b, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = np.argmax(
                self._cum[toks[:, t]] > u[:, t:t + 1], axis=-1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class ImageClassData:
    """Class-conditional synthetic images, 16 classes, NHWC float32."""

    num_classes: int = 16
    img: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n, img = self.num_classes, self.img
        yy, xx = np.mgrid[0:img, 0:img].astype(np.float32) / img
        self._protos = []
        for c in range(n):
            fx, fy = rng.uniform(2, 8, 2)
            phase = rng.uniform(0, 2 * np.pi)
            ang = rng.uniform(0, np.pi)
            g = np.sin(2 * np.pi * (fx * (xx * np.cos(ang) + yy * np.sin(ang))
                                    + fy * (yy * np.cos(ang) - xx * np.sin(ang)))
                       + phase)
            cx, cy, s = rng.uniform(0.25, 0.75, 2).tolist() + [rng.uniform(0.05, 0.2)]
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2)))
            color = rng.uniform(-1, 1, 3)
            proto = (g[..., None] * 0.6 + blob[..., None] * 0.8) * color
            self._protos.append(proto.astype(np.float32))
        self._protos = np.stack(self._protos)          # [C, H, W, 3]

    def batch(self, n: int, seed: int, noise: float = 0.35):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, self.num_classes, n)
        imgs = self._protos[labels]
        shift = rng.integers(-3, 4, (n, 2))
        out = np.empty_like(imgs)
        for i in range(n):                              # small translations
            out[i] = np.roll(imgs[i], tuple(shift[i]), axis=(0, 1))
        out = out + rng.standard_normal(out.shape).astype(np.float32) * noise
        return out.astype(np.float32), labels.astype(np.int32)
