"""Training launcher, the counterpart of ``repro/launch/train.py``:

    python -m repro_torch.launch.train --arch olmo-1b [--steps N] [--seq S]
        [--batch B] [--lr LR] [--microbatches M] [--ckpt-dir DIR]
        [--resume] [--full-config] [--device cpu]

Trains the REDUCED config (``--full-config``: the published one) with
``train.Trainer`` on ``TokenStream`` batches: AdamW with a 10-step warmup
and a cosine, a checkpoint every 25 steps, the straggler watch.  It runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the published (multi-B param) config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    if cfg.frontend in ("vision", "audio") or cfg.is_encdec:
        raise SystemExit(f"{args.arch}: frontend-stub archs train via "
                         "train_lm.py-style drivers with embeds; use a text "
                         "arch here")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps}")
    data = TokenStream(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=0)
    trainer = Trainer(
        cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                         total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=25,
                      ckpt_dir=args.ckpt_dir,
                      microbatches=args.microbatches),
        data, device=device)
    if args.resume and trainer.try_restore():
        print(f"resumed at step {trainer.step}")
    hist = trainer.run()
    losses = [h["loss"] for h in hist]
    print(f"loss: {np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}")
    return hist


if __name__ == "__main__":
    main()
