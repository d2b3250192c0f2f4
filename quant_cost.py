#!/usr/bin/env python3
"""Device time of ``quant_bitflip`` at the main paths' shapes on one
NVIDIA card.

    python3 quant_cost.py [--src DIR] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (this
checkout's by default).  To set this tree beside another commit on one
card, unpack that commit (``git archive``) into a git-ignored directory
and run the script for each in one machine, in the order parent, change,
change, parent.

Prints the card's name and power limit, then one JSON line a shape: the
mean device time of 20 calls captured in a CUDA graph and replayed 10
times between events (no host cost; ``--reps`` readings, each its own
graph), the host's time a call (20 calls queued behind ~0.5 s of a busy
card, ``torch.cuda._sleep``, so the host never waits; 5 readings), the
wrapper time (CUDA events around 20 back-to-back calls) and
the bound (``chip_smoke.py``'s: the hash at 15 integer operations a draw
over 16.7 Tops/s, or the bytes over 3.35 TB/s).  The shapes, one row at
rate 0.2 unless named: the CNN unit input [1,512,32,32,64] float32 at 4
faulty bits of 8; olmo-1b's unit input [1,8,256,2048] bf16 and
seamless-m4t-medium's encoder and decoder inputs [1,8,32,1024] float32
and [1,8,256,1024] bf16 at 6 of 8; olmo-1b's decode leaves [2048,2048],
[2048,8192], [8192,2048] and block input [8,1,2048], bf16, 0-d rates, at
4 of 16; and one olmo-1b decode layer (4 x [2048,2048], 2 x [2048,8192],
[8192,2048] and the input): one grouped call where the tree has
``quant_bitflip_group``, else one call a tensor.

Then one olmo-1b decode step at full width and depth (8 sequences, a
cache of 64, random weights from seed 0), faulted at rate 0.2 on every
layer and clean: the wall of a step ending in its argmax's readback (5
readings alternating faulted and clean, each the mean of 5 steps).  A
step's host time cannot be read behind a busy card as a call's is: its
~1500 kernels overflow the launch queue (about 1024 pending launches),
and the host then waits for the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.kernels import ops
    from repro_torch.quant import QuantSpec
    sys.path.insert(1, HERE)
    import chip_smoke as cs       # after repro_torch: it puts src/ first

    if not torch.cuda.is_available():
        print("quant_cost: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi(), "| src", args.src, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    one, zero_d = torch.tensor([0.2], device=dev), \
        torch.tensor([0.0, 0.2], device=dev)[1]
    s8, s16 = QuantSpec(8), QuantSpec(16)
    layer = [rand(2048, 2048, dtype=bf16) * 0.02 for _ in range(4)] \
        + [rand(2048, 8192, dtype=bf16) * 0.02 for _ in range(2)] \
        + [rand(8192, 2048, dtype=bf16) * 0.02, rand(8, 1, 2048, dtype=bf16)]
    cases = [("cnn input", [torch.relu(rand(1, 512, 32, 32, 64))], one, 4, s8),
             ("olmo-1b input", [rand(1, 8, 256, 2048, dtype=bf16)], one, 6,
              s8),
             ("seamless enc input", [rand(1, 8, 32, 1024)], one, 6, s8),
             ("seamless dec input", [rand(1, 8, 256, 1024, dtype=bf16)], one,
              6, s8),
             ("decode [2048,2048]", layer[:1], zero_d, 4, s16),
             ("decode [2048,8192]", layer[4:5], zero_d, 4, s16),
             ("decode [8192,2048]", layer[6:7], zero_d, 4, s16),
             ("decode [8,1,2048]", layer[7:], zero_d, 4, s16),
             ("decode layer", layer, zero_d, 4, s16)]
    grouped = hasattr(ops, "quant_bitflip_group")
    for label, xs, rate, fb, spec in cases:
        if grouped:
            def fn(xs=xs, rate=rate, fb=fb, spec=spec):
                ops.quant_bitflip_group(xs, list(range(len(xs))),
                                        [rate] * len(xs), fb, spec)
        else:
            def fn(xs=xs, rate=rate, fb=fb, spec=spec):
                for i, x in enumerate(xs):
                    ops.quant_bitflip(x, i, rate, fb, spec)
        n = sum(x.numel() for x in xs)
        b_ms = sum(cs.bound(2 * x.element_size() * x.numel(),
                            int_ops=x.numel() * fb * cs.HASH_OPS_PER_DRAW)[0]
                   for x in xs)
        ops.reset_launches()
        fn()
        launches = ops.launches["quant_bitflip"]
        ms = [cs.device_ms(fn) for _ in range(args.reps)]
        print(json.dumps(dict(
            label=label, elements=n, faulty_bits=fb, grouped=grouped,
            launches_a_call=launches, device_ms=ms,
            host_us=sorted(host_us(fn) for _ in range(5)),
            wrapper_ms=cs.time_ms(fn), bound_ms=b_ms,
            bound_share=b_ms / min(ms))), flush=True)
    del layer, cases
    decode_cost(dev)
    return 0


def host_us(fn, calls=20) -> float:
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)            # ~0.5 s at 1.98 GHz
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def decode_cost(dev):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_lm)

    cfg = get_config("olmo-1b")
    params = init_lm(cfg, seed=0, device=dev)
    cache = init_cache(cfg, 8, 64, device=dev)
    toks = torch.zeros(8, dtype=torch.int32, device=dev)
    pos = torch.full((8,), 40, dtype=torch.int32, device=dev)
    rates = torch.full((cfg.n_layers,), 0.2, device=dev)
    faults = {"faulted": (rates, rates, 7), "clean": None}

    def steps(fault, n=5):
        for _ in range(n):
            torch.argmax(decode_step(params, cfg, cache, toks, pos,
                                     fault=fault)[0], -1).cpu()

    for f in faults.values():
        steps(f, 2)                                 # warm up
    wall = {k: [] for k in faults}
    for _ in range(5):
        for k, f in faults.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(f)
            wall[k].append((time.perf_counter() - t0) / 5 * 1e3)
    for k in faults:
        print(json.dumps(dict(label=f"olmo-1b decode step, {k}",
                              wall_ms=sorted(wall[k]))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
