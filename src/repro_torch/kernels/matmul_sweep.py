"""Device time of ``fault_matmul`` across shapes, split counts, row
counts and the hash on or off, on one NVIDIA card.

    PYTHONPATH=src python -m repro_torch.kernels.matmul_sweep [f32 bf16 f32w]

The arguments name the parts to run (all three by default).

Each line is one configuration: the mean device time of 20 calls captured
in a CUDA graph and replayed 10 times between events (no host cost).

float32 x (the CNN path): ``faulty_bits=0`` skips the hash, so the
difference to ``faulty_bits=4`` is what the hash costs; a K sweep at fixed
M and N separates the cost of one 16-deep k-step from the fixed cost of a
call; N=64 at 8 slices puts 8 blocks on the card against 128 at N=1024,
which tells time spent inside an SM from contention for L2.

bf16 x (the transformer path) at olmo-1b's three projection shapes and
starcoder2-3b's kv projection (2048x3072x256, where the product cuts K
into slices): the whole call at 6 faulty bits and at 0 (the hash pass
then writes W' without a draw), the hash pass alone and the product
alone; then R = 1 and 8 rows at 2048x2048x2048.

float32 x on bf16 weights (``f32w``, seamless-m4t-medium's encoder, M =
B Se = 256) at its three shapes: the product alone at 1 to 16 K slices
(one slice has no split-K sum; the blocks a call grow with the slices),
the whole call at 6 faulty bits and at 0, and R = 1 and 8 rows at
1024x1024.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.kernels import ops

SHAPES = ((512, 512, 16), (512, 256, 1024), (512, 1024, 1024),
          (512, 4096, 1024), (512, 4096, 64))
BF16_SHAPES = ((2048, 2048, 2048), (2048, 2048, 8192), (2048, 8192, 2048),
               (2048, 3072, 256))
F32W_SHAPES = ((256, 1024, 1024), (256, 1024, 4096), (256, 4096, 1024))


def device_ms(fn, launches: int = 20, replays: int = 10) -> float:
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("matmul_sweep needs an NVIDIA card")
    parts = sys.argv[1:] or ["f32", "bf16", "f32w"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if "f32" in parts:
        sweep_f32(dev, gen)
    if "bf16" in parts:
        sweep_bf16(dev, gen)
    if "f32w" in parts:
        sweep_f32w(dev, gen)


def sweep_f32(dev, gen) -> None:
    """float32 x: split counts and the hash on/off."""
    scale = torch.tensor(0.0123, device=dev)
    one = torch.tensor([0.2], device=dev)
    default_splits = ops._k_splits
    for M, K, N in SHAPES:
        qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x = torch.randn(1, M, K, device=dev, generator=gen)
        own = default_splits(M, K, N, "tc", dev)
        for splits in sorted({own, 8}):
            ops._k_splits = lambda *_, s=splits: s
            for bits in (4, 0):
                t = device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one,
                                                       bits))
                print(f"[1,{M},{K}] x [{K},{N}] int8 splits {splits}"
                      f"{' (default)' if splits == own else ''} faulty_bits "
                      f"{bits}: {t:.4f} ms", flush=True)
        ops._k_splits = default_splits


def sweep_bf16(dev, gen) -> None:
    """The bf16 route: hash on/off, each pass alone, and R."""
    scale = torch.tensor(0.0123, device=dev)
    one = torch.tensor([0.2], device=dev)
    for M, K, N in BF16_SHAPES:
        qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x = torch.randn(1, M, K, device=dev, generator=gen).to(torch.bfloat16)
        tiles = ops.fault_weight_tiles(qw, scale, 1, one, 6)
        t = device_ms(lambda: ops.fault_weight_tiles(qw, scale, 1, one, 6,
                                                     out=tiles))
        print(f"[{K},{N}] int8 hash pass, 1 row, faulty_bits 6: {t:.4f} ms",
              flush=True)
        tag = f"[1,{M},{K}] bf16 x [{K},{N}] int8"
        t = device_ms(lambda: ops.matmul_tiles(x, tiles, K, N))
        splits = ops._k_splits(M, K, N, "bf16", dev)
        print(f"{tag} product alone ({splits} K slices): {t:.4f} ms",
              flush=True)
        for bits in (6, 0):
            t = device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one,
                                                   bits))
            print(f"{tag} faulty_bits {bits}: {t:.4f} ms", flush=True)
    M = K = N = 2048
    qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                       generator=gen)
    for R in (1, 8):
        x = torch.randn(R, M, K, device=dev, generator=gen).to(torch.bfloat16)
        rates = torch.full((R,), 0.2, device=dev)
        t = device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, rates, 6))
        print(f"[{R},{M},{K}] bf16 x [{K},{N}] int8, {R} rows, faulty_bits 6:"
              f" {t:.4f} ms ({t / R:.4f} ms a row)", flush=True)



def sweep_f32w(dev, gen) -> None:
    """float32 x on bf16 weights: the product at several split counts, the
    call with the hash on and off, and R."""
    scale = torch.tensor(0.0123, device=dev)
    one = torch.tensor([0.2], device=dev)
    default_splits = ops._k_splits
    bf16 = torch.bfloat16
    for M, K, N in F32W_SHAPES:
        qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x = torch.randn(1, M, K, device=dev, generator=gen)
        tiles = ops.fault_weight_tiles(qw, scale, 1, one, 6)
        tag = f"[1,{M},{K}] float32 x [{K},{N}] int8, bf16 weights"
        own = default_splits(M, K, N, "f32w", dev)
        try:
            for splits in sorted({1, 2, 4, 8, 16, own}):
                ops._k_splits = lambda *_, s=splits: s
                t = device_ms(lambda: ops.matmul_tiles_f32(x, tiles, K, N))
                print(f"{tag} product alone, {splits} K slices"
                      f"{' (default)' if splits == own else ''}: {t:.4f} ms",
                      flush=True)
        finally:
            ops._k_splits = default_splits
        for bits in (6, 0):
            t = device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one, bits,
                                                   out_dtype=bf16))
            print(f"{tag} faulty_bits {bits}: {t:.4f} ms", flush=True)
    M, K, N = F32W_SHAPES[0]
    qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                       generator=gen)
    for R in (1, 8):
        x = torch.randn(R, M, K, device=dev, generator=gen)
        rates = torch.full((R,), 0.2, device=dev)
        t = device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, rates, 6,
                                               out_dtype=bf16))
        print(f"[{R},{M},{K}] float32 x [{K},{N}] int8, bf16 weights, {R} "
              f"rows, faulty_bits 6: {t:.4f} ms ({t / R:.4f} ms a row)",
              flush=True)


if __name__ == "__main__":
    main()
