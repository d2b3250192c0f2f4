#!/usr/bin/env python3
"""Host cost of the port's LM paths on one NVIDIA card.

    python3 host_cost.py [--src DIR] [--config olmo-1b|seamless-m4t-medium]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (this
checkout's by default).  To set this tree beside another commit on one
card, unpack that commit (``git archive``) into a git-ignored directory
and run the script for each in one machine, in the order parent, change,
change, parent.

Prints the card's name and power limit, then one JSON line each for:
  * ``fault_matmul`` at the config's projection shapes, one row, 6 faulty
    bits, int8 weights: for olmo-1b on bf16 x at its three shapes (M = B S
    = 2048), for seamless-m4t-medium on float32 x with bf16 weights at its
    encoder's three (M = B Se = 256); 5 readings each of the host's
    time a call (20 calls queued behind a kernel that keeps the card busy,
    so the host never waits on it), the wrapper time (CUDA events around
    20 back-to-back calls) and the device time (20 calls in a CUDA graph);
  * one candidate at full width (8 x 256 tokens, the kernel backend's
    whole forward at rate 0.2, 6 faulty bits for olmo-1b and 4 for
    seamless-m4t-medium, phase 11's regime): the host's time
    to issue its forward queued behind the busy kernel (3 readings; a
    reading above the busy kernel's ~1 s means the forward waited on the
    card somewhere), the lines where it waits (``torch.cuda``'s sync
    debug mode), its
    wall (5 readings of 3 back-to-back dispatches), and its kernels' busy
    time and launch count, and its eight costliest kernels
    (``torch.profiler``);
  * for olmo-1b, the ``eval_batch_size="auto"`` probe
    (``peak_memory_bytes``) of a 1-row dispatch: with the garbage an
    evaluator leaves when it is
    dropped freed inside the probed call (as a collection the interpreter
    starts there frees it), and with none; and the bytes of that garbage.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
# (M, K, N) of the timed fault_matmul calls, and their x dtype
SHAPES = {"olmo-1b": ((2048, 2048, 2048), (2048, 2048, 8192),
                      (2048, 8192, 2048)),
          "seamless-m4t-medium": ((256, 1024, 1024), (256, 1024, 4096),
                                  (256, 4096, 1024))}
FAULTY_BITS = {"olmo-1b": 6, "seamless-m4t-medium": 4}
SLEEP_CYCLES = 2_000_000_000      # about 1 s of a busy card at 1.98 GHz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--config", default="olmo-1b", choices=sorted(SHAPES))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("host_cost: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import (POD_TIERS_4, FaultSpec,
                                  make_lm_accuracy_evaluator)
    from repro_torch.core.eval_engine import peak_memory_bytes
    from repro_torch.kernels import ops
    from repro_torch.lm_setup import calibration_batch, self_labels
    from repro_torch.models.transformer import init_lm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"src": os.path.abspath(args.src)}), flush=True)
    dev = torch.device("cuda")

    def events_ms(fn, iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters):
        """Host time a call of ``fn`` with the card busy behind it."""
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        return t

    def graph_ms(fn, launches=20, replays=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return events_ms(graph.replay, replays) / launches

    gen = torch.Generator(device=dev).manual_seed(0)
    scale = torch.tensor(0.0123, device=dev)
    one = torch.tensor([0.2], device=dev)
    olmo = args.config == "olmo-1b"
    x_dtype = torch.bfloat16 if olmo else torch.float32
    for M, K, N in SHAPES[args.config]:
        qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x = torch.randn(1, M, K, device=dev, generator=gen).to(x_dtype)

        def call():
            ops.fault_matmul(x, qw, scale, 1, one, 6,
                             out_dtype=torch.bfloat16)
        call()
        reads = {"host_ms": [], "wrapper_ms": [], "device_ms": []}
        for _ in range(5):
            reads["host_ms"].append(host_ms(call, 20))
            reads["wrapper_ms"].append(events_ms(call, 20))
            reads["device_ms"].append(graph_ms(call))
        key = "fault_matmul_bf16" if olmo else "fault_matmul_f32x_bf16w"
        print(json.dumps({key: f"[1,{M},{K}] {str(x_dtype)[6:]} x [{K},{N}] "
                          "int8", **reads}), flush=True)
        del qw, x

    cfg = get_config(args.config)
    params = init_lm(cfg, seed=0, device=dev)
    batch = calibration_batch(cfg, 8, 256, seed=7, device=dev)
    labels = self_labels(cfg, params, batch)
    scale_t = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)

    def evaluator(faulty_bits=FAULTY_BITS[args.config]):
        spec = FaultSpec(bits=8, faulty_bits=faulty_bits,
                         weight_fault_rate=0.2, act_fault_rate=0.2)
        return make_lm_accuracy_evaluator(
            cfg, params, batch, labels, spec, scale_t, device=dev,
            fault_backend="kernel", eval_strategy="full", eval_batch_size=1)

    ev = evaluator()
    row = np.random.default_rng(3).integers(
        0, len(scale_t), size=(1, cfg.n_enc_layers + cfg.n_layers))
    ev._dispatch(row)
    torch.cuda.synchronize()
    # the dispatch minus its two small host-to-card copies of the rates,
    # which would wait for the busy kernel
    wr = torch.as_tensor(ev.w_rates_by_device[row], device=dev)
    ar = torch.as_tensor(ev.a_rates_by_device[row], device=dev)
    host = [host_ms(lambda: ev._apply_fn(ev._qparams, ev._x, wr, ar,
                                         int(ev.base_seed)), 1)
            for _ in range(3)]
    walls = [events_ms(lambda: ev._dispatch(row), 3) for _ in range(5)]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev._dispatch(row)
        torch.cuda.synchronize()
    # the port's spans show on the device timeline as "afp:" annotations
    kern = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA
            and not a.key.startswith("afp:")]
    # where the forward waits on the card: PyTorch warns at each
    # synchronizing call, from the Python line that made it
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ev._apply_fn(ev._qparams, ev._x, wr, ar, int(ev.base_seed))
    torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, args.src)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    print(json.dumps({
        ("olmo1b_candidate" if olmo else "seamless_candidate"):
            "8x256 tokens, kernel backend, full forward",
        "syncs": sum(sites.values()), "sync_sites": dict(sites),
        "sleep_ms": SLEEP_CYCLES / 1.98e6, "host_ms": host, "wall_ms": walls,
        "busy_ms": sum(a.self_device_time_total for a in kern) / 1e3,
        "kernel_launches": sum(a.count for a in kern),
        "top_kernels": {a.key[:80]: [a.self_device_time_total / 1e3, a.count]
                        for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:8]}}),
        flush=True)

    if not olmo:
        return 0
    # the 1-row probe with and without an evaluator's garbage
    probe = np.random.default_rng(5).integers(0, 4, size=(8, cfg.n_layers))
    ev4 = evaluator(faulty_bits=4)
    ev4.delta_acc(probe)
    del ev4
    gc.disable()
    rows1 = np.zeros((1, cfg.n_layers), np.int64)
    before = torch.cuda.memory_allocated(dev)
    during = peak_memory_bytes(
        lambda: (gc.collect(), ev._dispatch(rows1))[1], dev)
    gc.collect()
    garbage = before - torch.cuda.memory_allocated(dev)
    clean = peak_memory_bytes(lambda: ev._dispatch(rows1), dev)
    gc.enable()
    print(json.dumps({"probe_1row_bytes_garbage_freed_inside": during,
                      "probe_1row_bytes_no_garbage": clean,
                      "garbage_bytes": garbage}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
