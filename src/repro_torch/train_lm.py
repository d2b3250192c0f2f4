"""Train a small OLMo-style LM (42 M params; ``build_100m`` keeps the
reference's name) for a few hundred steps with the whole training
substrate: AdamW, microbatching, atomic checkpoints, the
straggler watch, crash-resume.  The counterpart of
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 300] [--resume]

On a machine without a card add ``--device cpu``.  The data is a
``TokenStream`` over the model's 16384-token vocabulary, whose transition
table (2 GB) is built once, at the start.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

__all__ = ["build_100m", "main"]


def build_100m():
    """8 layers x d=512 x ff=2048, 16k vocab, tied: 42.0 M params."""
    return dataclasses.replace(
        get_config("olmo-1b"), name="olmo-100m",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab=16384, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)      # before the 2 GB table

    cfg = build_100m()
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")
    data = TokenStream(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=0)
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=50,
                      ckpt_dir=args.ckpt_dir, log_every=10, microbatches=2),
        data, device=device,
        on_straggler=lambda s: print(f"[straggler watch] slow streak @ {s}"))
    if args.resume and trainer.try_restore():
        print(f"resumed from step {trainer.step}")
    hist = trainer.run()
    for h in hist:
        if h["step"] % 10 == 0 or h["step"] == len(hist):
            print(f"step {h['step']:4d} loss={h['loss']:.4f} "
                  f"lr={h['lr']:.2e} |g|={h['grad_norm']:.2f} "
                  f"dt={h['dt']*1e3:.0f}ms")
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(hist)} steps "
          f"(ckpts in {args.ckpt_dir})")
    return hist


if __name__ == "__main__":
    main()
