#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the process exits nonzero):
  1. PyTorch's TF32 flags are left as PyTorch sets them: the port runs its
     float path with TF32 off by itself (``fp32_exact``), which phase 8
     shows.
  2. The card's name and power limit; build every CUDA kernel of
     ``src/repro_torch/csrc`` with nvcc (one process per source, in
     parallel) and print ptxas' register and spill counts.
  3. Each kernel against its plain PyTorch version on the card, at the
     main path's shapes: ``bitflip`` and ``quant_bitflip`` bitwise for all
     four fault models, every storage type, rates 0 / 1e-3 / 0.2 and an
     all-zero row, ``bitflip`` also with its fused dequantization
     (bitwise ``bitflip_ref(...).float() * scale``); ``fault_matmul`` at
     both main-path shapes (ResNet18's fc 512x512x16, AlexNet's fc0
     512x4096x1024) for int8, int16 and int32 weights, bitwise at
     x = I_K and, at random x, within 2 K 2^-24 (|x| @ |w|): both sides'
     worst-case fp32 accumulation error, whatever the order of the sums.
     Then each kernel's times: its device time (a CUDA graph of 20
     launches replayed between events, so no host cost), its wrapper time
     (events around back-to-back Python calls), its plain version's, the
     library call's where one exists, and the bound.
  4. The whole-forward path: ResNet18 at width 1.0 (channels 64-512), img
     32, 16 classes, n_eval=512, labels = the clean model's own argmax;
     ``AFarePart`` (NSGA-II pop 24, 3 generations) under the kernel backend
     and ``eval_strategy="full"``, then ``FaultUnawareBaseline``.  The
     launch counters are zeroed just before and read just after; all three
     kernels must have launched.
  5. One ΔAcc population on AlexNet at width 1.0 (fc0 is 512x4096x1024),
     its launches counted the same way.
  6. Generic against kernel ΔAcc on one ResNet18 population.
  7. Where the time of one ResNet18 candidate goes (torch.profiler): each
     kernel's total per candidate and the elementwise glue.
  8. The staged path, the default: the same ``AFarePart`` search through
     the chain-fused staged engine (kernel backend, ``eval_batch_size=
     "auto"``, a 16 GiB activation store), its launches counted as in
     phase 4; its front and every evaluated row's ΔAcc bitwise equal to
     phase 4's, its wall time beside a warm rerun of the full search, the
     engine's counters, the store's peak bytes and the allocator's peak.
     Then one population fused against unfused in turns (bitwise), the
     reference's default tables + staged against kernel + staged (within
     2/n_eval), a profile of the fused walk (its idle share), one
     candidate under PyTorch's default TF32 flags against the flags off
     (equal), the cost per row of an 8-row whole forward against a 1-row
     one, and ``python -m repro_torch.quickstart`` at 20 training steps
     and 2 generations.
The lines before the last are the ``{"kernels": [...]}`` record (its
``launches`` are the staged path's, phase 8; ``full_launches`` phase 4's)
and the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Bounds: the least time for the same work is the larger of the bytes each
input read once and each output written once over 3.35 TB/s, and the
operations over their peak.  The fault hash costs about 20 32-bit integer
operations per draw (``csrc/faultmodel.cuh``), counted at 16.7 Tops/s
(64 INT32 lanes per SM x 132 SMs x 1.98 GHz, from the H100 white paper;
the guide's table has no integer ALU rate).
  * ``bitflip``, ``quant_bitflip``: one draw per element and bit plane;
    the hash outweighs the bytes (1 + 1 B, or 4 + 4 + 4 B, an element).
  * ``fault_matmul``: the hash once per weight (K N draws per plane), and
    the product as it runs on the tensor cores: three exact bf16 products
    of the split x, 3 x 2 M K N at 989 TFLOP/s.  Whichever is larger; at
    AlexNet's fc0 the hash.  (The SIMT body of int16/int32 weights would
    be bound by fp32 FMAs at 67 TFLOP/s; the main path stores int8.)
Rates are the H100 SXM's published peaks at 700 W.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT32_OPS = 132 * 64 * 1.98e9
HASH_OPS_PER_DRAW = 20
FAULTY_BITS = 4
SPEC_RATES = dict(weight_fault_rate=0.2, act_fault_rate=0.2, faulty_bits=4,
                  bits=16)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, host cost
    included (CUDA events around the calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches=20, replays=10) -> float:
    """Mean device time of ``fn``: ``launches`` calls captured in one CUDA
    graph, replayed between events, so the wrapper's host work is not in
    it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up outside the capture
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


def bound(n_bytes: float, tc_flops: float = 0.0, int_ops: float = 0.0):
    t = {"bytes": n_bytes / HBM_BPS,
         "operations": max(tc_flops / BF16_FLOPS, int_ops / INT32_OPS)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return bool(torch.equal(a, b))


# fault_matmul at the main path's two shapes: (label, M, K, N)
MATMUL_SHAPES = (("resnet18 fc", 512, 512, 16), ("alexnet fc0", 512, 4096, 1024))


def check_kernels(dev, records):
    """Phase 3: every kernel against its plain version, then timings."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS
    from repro_torch.quant import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(0)
    rates = torch.tensor([0.0, 1e-3, 0.2], device=dev)
    spec8 = QuantSpec(bits=8)
    scale = torch.tensor(0.0123, device=dev)

    # bitflip: ResNet18's largest conv weight, 3x3x512x512, as stored (int8)
    # and in the wider storage types; integers out, and dequantized
    for dtype, hi in ((torch.int8, 127), (torch.int16, 2 ** 14),
                      (torch.int32, 2 ** 20)):
        q = torch.randint(-hi, hi, (3, 3, 512, 512), device=dev, dtype=dtype,
                          generator=gen)
        for model in FAULT_MODELS:
            for bits in (FAULTY_BITS, 8):
                k = ops.bitflip(q, 7919, rates, bits, fault_model=model)
                p = ref.bitflip_ref(q, 7919, rates, bits, fault_model=model)
                if not bits_equal(k, p):
                    raise AssertionError(f"bitflip {dtype} {model} bits={bits}"
                                         " differs from its plain version")
                k = ops.bitflip(q, 7919, rates, bits, fault_model=model,
                                scale=scale)
                if not bits_equal(k, p.float() * scale):
                    raise AssertionError(f"bitflip {dtype} {model} bits={bits}"
                                         " with scale differs from "
                                         "bitflip_ref(...).float() * scale")
    log("phase3 bitflip: bitwise equal to plain for int8/int16/int32 x "
        f"{FAULT_MODELS} x bits 4,8 x rates 0,1e-3,0.2 at [3,3,512,512], "
        "integers out and fused dequant")

    # quant_bitflip: the input of ResNet18 units 1-3 at n_eval=512,
    # [R, 512, 32, 32, 64]; row 0 all zeros
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 512, 32, 32, 64, device=dev, generator=gen)
        x = torch.relu(x).to(dtype)
        x[0] = 0
        r4 = torch.tensor([0.2, 0.0, 1e-3, 0.2], device=dev)
        for model in FAULT_MODELS:
            k = ops.quant_bitflip(x, 7920, r4, FAULTY_BITS, spec8,
                                  fault_model=model)
            p = ref.quant_bitflip_ref(x, 7920, r4, FAULTY_BITS, spec8,
                                      fault_model=model)
            if not bits_equal(k, p):
                bad = (k.float() != p.float()).sum().item()
                raise AssertionError(f"quant_bitflip {dtype} {model}: {bad} "
                                     "elements differ from the plain version")
            if k[0].abs().max().item() >= torch.finfo(torch.float32).tiny:
                raise AssertionError("all-zero row did not stay (sub)zero")
        del x, k, p
    log("phase3 quant_bitflip: bitwise equal to plain for float32/bfloat16 x "
        f"{FAULT_MODELS} x rates 0,1e-3,0.2 at [4,512,32,32,64] with an "
        "all-zero row")

    # fault_matmul at both main-path shapes, every storage type
    max_err, worst = {}, 0.0
    for label, M, K, N in MATMUL_SHAPES:
        eye = torch.eye(K, device=dev).expand(3, K, K).contiguous()
        x = torch.randn(3, M, K, device=dev, generator=gen)
        max_err[label] = 0.0
        for dtype, hi in ((torch.int8, 128), (torch.int16, 2 ** 14),
                          (torch.int32, 2 ** 20)):
            qw = torch.randint(-hi, hi, (K, N), device=dev, dtype=dtype,
                               generator=gen)
            for model in FAULT_MODELS:
                w = ref.bitflip_ref(qw, 7921, rates, FAULTY_BITS,
                                    fault_model=model, scale=scale)
                k = ops.fault_matmul(eye, qw, scale, 7921, rates, FAULTY_BITS,
                                     fault_model=model)
                if not bits_equal(k, w):
                    raise AssertionError(f"fault_matmul {label} {dtype} "
                                         f"{model}: x = I_K does not return "
                                         "the corrupted weights bitwise")
                k = ops.fault_matmul(x, qw, scale, 7921, rates, FAULTY_BITS,
                                     fault_model=model)
                p = ref.fault_matmul_ref(x, qw, scale, 7921, rates,
                                         FAULTY_BITS, fault_model=model)
                tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
                err = (k - p).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"fault_matmul {label} {dtype} "
                                         f"{model}: max err "
                                         f"{err.max().item():.3g} above the "
                                         "bound")
                if dtype == torch.int8:
                    max_err[label] = max(max_err[label], err.max().item())
                worst = max(worst, (err / tol).max().item())
        del eye
    log("phase3 fault_matmul: x=I_K bitwise; random x within "
        f"2*K*2^-24*(|x|@|w|) (worst ratio to it {worst:.3g}), at "
        f"{[s[0] for s in MATMUL_SHAPES]} x int8/int16/int32 x "
        f"{FAULT_MODELS}; int8 max |err| {max_err}")

    # timings, one row, at the main path's shapes
    one = torch.tensor([0.2], device=dev)
    q = torch.randint(-127, 128, (3, 3, 512, 512), device=dev,
                      dtype=torch.int8, generator=gen)
    n = q.numel()
    b_ms, b_by = bound(2 * n, int_ops=n * FAULTY_BITS * HASH_OPS_PER_DRAW)
    records["bitflip"].update(
        ms=device_ms(lambda: ops.bitflip(q, 1, one, FAULTY_BITS)),
        wrapper_ms=time_ms(lambda: ops.bitflip(q, 1, one, FAULTY_BITS)),
        fused_ms=device_ms(lambda: ops.bitflip(q, 1, one, FAULTY_BITS,
                                               scale=scale)),
        plain_ms=time_ms(lambda: ref.bitflip_ref(q, 1, one, FAULTY_BITS)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0,
        shape="[1] x [3,3,512,512] int8")
    x = torch.relu(torch.randn(1, 512, 32, 32, 64, device=dev, generator=gen))
    n = x.numel()
    b_ms, b_by = bound(8 * n, int_ops=n * FAULTY_BITS * HASH_OPS_PER_DRAW)
    records["quant_bitflip"].update(
        ms=device_ms(lambda: ops.quant_bitflip(x, 1, one, FAULTY_BITS, spec8)),
        wrapper_ms=time_ms(lambda: ops.quant_bitflip(x, 1, one, FAULTY_BITS,
                                                     spec8)),
        plain_ms=time_ms(lambda: ref.quant_bitflip_ref(x, 1, one, FAULTY_BITS,
                                                       spec8), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0,
        shape="[1,512,32,32,64] float32")
    del x
    shapes = []
    for label, M, K, N in MATMUL_SHAPES:
        qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x = torch.randn(1, M, K, device=dev, generator=gen)
        w = qw.float() * scale
        b_ms, b_by = bound(4 * M * K + K * N + 4 * M * N,
                           tc_flops=3 * 2 * M * K * N,
                           int_ops=K * N * FAULTY_BITS * HASH_OPS_PER_DRAW)
        shapes.append(dict(
            label=label, shape=f"[1,{M},{K}] x [{K},{N}] int8",
            ms=device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one,
                                                  FAULTY_BITS)),
            wrapper_ms=time_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one,
                                                        FAULTY_BITS)),
            plain_ms=time_ms(lambda: ref.fault_matmul_ref(
                x, qw, scale, 1, one, FAULTY_BITS)),
            library_ms=device_ms(lambda: torch.matmul(x, w)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err[label]))
    # the record's own numbers are those of ResNet18's fc, the shape the
    # main path (phase 4) launches; AlexNet's fc0 rides along in "shapes"
    records["fault_matmul"].update(shapes[0], shapes=shapes)
    for name, r in records.items():
        for sr in r.get("shapes", [r]):
            log(f"phase3 time {name} at {sr['shape']}: device {sr['ms']:.4f} "
                f"ms, wrapper {sr['wrapper_ms']:.4f} ms, plain "
                f"{sr['plain_ms']:.4f} ms, library {sr['library_ms']}, bound "
                f"{sr['bound_ms']:.4f} ms ({sr['bound_by']})")
    log(f"phase3 time bitflip fused dequant: device "
        f"{records['bitflip']['fused_ms']:.4f} ms")


RECORD_KEYS = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
               "wrapper_ms", "fused_ms", "candidate_ms", "candidate_launches",
               "full_launches", "shapes")


def kernel_group(key: str) -> str:
    """The group a profiled device kernel belongs to: one of the port's
    three kernels, or what PyTorch and cuDNN run around them."""
    if "quant_bitflip_kernel" in key or "amax_kernel" in key:
        return "quant_bitflip"
    if "bitflip_kernel" in key:
        return "bitflip"
    if "tc::kernel" in key or "simt::kernel" in key or "sum_splits" in key:
        return "fault_matmul"
    if "Memcpy" in key or "Memset" in key:
        return "copies"
    if "nhwcToNchw" in key or "nchwToNhwc" in key:
        return "layout"
    if "at::native" in key:
        return "elementwise glue"
    return "convolution"


def pick_resnet_seed(dev):
    """First seed whose random-init ResNet18 spreads the 512 calibration
    images over several classes (a collapsed head keeps its argmax under
    corruption and ΔAcc would be identically 0)."""
    from repro_torch.cnn_setup import clean_argmax_labels
    from repro_torch.models.cnn import ResNet18
    for seed in (7, 5, 11, 13, 17):
        params = ResNet18.init(seed, 16, width=1.0, img=32, device=dev)
        labels = clean_argmax_labels("resnet18", params, 512, device=dev)
        counts = torch.bincount(labels, minlength=16)
        if int((counts > 0).sum()) >= 2 and int(counts.max()) < 512 - 16:
            return seed, params, labels
    raise AssertionError("no ResNet18 init seed gave a working probe")


STORE_BYTES = 16 << 30         # phase 8's activation-store cap
N_EVAL = 512                   # calibration images, the paper's batch


def staged_phase(dev, params, labels, spec, layers, cfg, full_plan, full_rows,
                 full_ev, records):
    """Phase 8: the staged, chain-fused engine on the main path, held
    bitwise against phase 4's whole-forward search."""
    from repro_torch import quickstart
    from repro_torch.cnn_setup import eval_batch, make_evaluator
    from repro_torch.core import PAPER_DEVICES, AFarePart
    from repro_torch.core.eval_engine import device_memory_budget
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import ResNet18

    def evaluator(**kw):
        kw.setdefault("fault_backend", "kernel")
        kw.setdefault("max_store_bytes", STORE_BYTES)
        return make_evaluator("resnet18", params, spec, n_eval=N_EVAL,
                              labels=labels, device=dev, **kw)

    # the search, staged and fused, against a warm rerun of the full one
    s_ev = evaluator(eval_batch_size="auto")
    chunk = s_ev.eval_batch_size
    log(f"phase8 eval_batch_size='auto' -> {chunk} rows: peak bytes of a "
        f"1- and a 2-row dispatch {s_ev.auto_probe_bytes}, store cap "
        f"{STORE_BYTES} reserved, budget now "
        f"{device_memory_budget(device=dev)} bytes")
    if not chunk or chunk < 2:
        raise AssertionError(f"auto chunk {chunk}: expected several rows")
    f_ev = evaluator(eval_strategy="full", eval_batch_size=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=f_ev,
                       nsga2_config=cfg).optimize()
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    del f_ev
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=s_ev,
                     nsga2_config=cfg).optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = s_ev.staged_stats()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase8 AFarePart staged+fused: {wall:.3f} s wall against "
        f"{full_wall:.3f} s for the full search rerun warm (phase 4, cold: "
        f"see above); launches {launches}")
    log(f"phase8 staged stats {json.dumps(st)}; peak store bytes "
        f"{s_ev._prefix_engine.store.peak_nbytes}; max_memory_allocated "
        f"{peak}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the staged path: "
                             f"{launches}")
    if dict(s_ev._cache) != full_rows:
        bad = [k for k in full_rows if s_ev._cache.get(k) != full_rows[k]]
        raise AssertionError(f"staged rows differ from the full path: "
                             f"{len(bad)} of {len(full_rows)} "
                             f"(rows {len(s_ev._cache)}), e.g. {bad[:3]}")
    for p in (plan, f_plan):
        if not (np.array_equal(p.front, full_plan.front)
                and np.array_equal(p.front_objs, full_plan.front_objs)):
            raise AssertionError("the front differs from phase 4's")
    log(f"phase8 staged = full bitwise: {len(full_rows)} rows' accuracies "
        f"and the front ({len(plan.front)} points)")
    for name, r in records.items():
        r["launches"] = launches[name]
    records["fault_matmul"]["shapes"][0]["launches"] = launches[
        "fault_matmul"]
    s_ev._prefix_engine.store.clear()

    # one population: fused and unfused in turns, then tables against
    # kernel, then a profile of the fused walk (its idle share)
    P = np.array(list(full_rows)[:24])
    got, secs = {}, {}
    for label in ("fused", "unfused", "unfused", "fused", "tables"):
        kw = {"unfused": {"fuse_chains": False},
              "tables": {"fault_backend": "tables"}}.get(label, {})
        e = evaluator(eval_batch_size=chunk, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[label] = e.delta_acc(P)
        torch.cuda.synchronize()
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        st = e.staged_stats()
        log(f"phase8 {label:8s} {secs[label][-1]:.3f} s, "
            f"{st['dispatches']} dispatches, {st['fused_segments']} fused "
            f"segments, {st['unit_runs']} unit runs of "
            f"{st['full_unit_runs']}")
        del e
        torch.cuda.empty_cache()
    if not np.array_equal(got["fused"], got["unfused"]):
        raise AssertionError("fused and unfused staged dAcc differ")
    diff = np.abs(got["tables"] - got["fused"])
    log(f"phase8 fused = unfused bitwise on {len(P)} rows; tables vs kernel: "
        f"{int((diff > 0).sum())} rows differ, max {diff.max():.4f}")
    if diff.max() > 2.0 / N_EVAL:
        raise AssertionError("tables and kernel staged dAcc differ by more "
                             "than 2/n_eval")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    e = evaluator(eval_batch_size=chunk)
    e.clean_accuracy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e.delta_acc(P)
        torch.cuda.synchronize()
        t_walk = (time.perf_counter() - t0) * 1e3
    del e
    torch.cuda.empty_cache()
    kern = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError("the profiler recorded no device kernel")
    busy = sum(a.self_device_time_total for a in kern) / 1e3
    groups = {}
    for a in kern:
        g = groups.setdefault(kernel_group(a.key), [0.0, 0])
        g[0] += a.self_device_time_total / 1e3
        g[1] += a.count
    log(f"phase8 profiled fused walk of {len(P)} rows: kernels busy "
        f"{busy:.1f} ms of {t_walk:.1f} ms wall ({100 * (1 - busy / t_walk):.1f}"
        f"% idle); " + ", ".join(f"{k} {v[0]:.1f} ms in {v[1]}" for k, v in
                                 sorted(groups.items(), key=lambda kv:
                                        -kv[1][0])))

    # TF32: one candidate under PyTorch's default flags and with them off
    row = P[:1]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    d_default = evaluator(eval_strategy="full").delta_acc(row)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d_off = evaluator(eval_strategy="full").delta_acc(row)
    x, _ = eval_batch(N_EVAL, device=dev)
    scale = np.asarray([d.fault_scale for d in PAPER_DEVICES], np.float32)
    wr = torch.as_tensor(0.2 * scale[row], device=dev)
    with torch.no_grad():
        off = ResNet18.apply(params, x, wr, wr, 0)
        torch.backends.cudnn.allow_tf32 = True
        on = ResNet18.apply(params, x, wr, wr, 0)
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = flags
    log(f"phase8 TF32 flags by default (cudnn, matmul) {flags}: dAcc "
        f"{d_default.tolist()} = {d_off.tolist()} with both off; unguarded, "
        f"TF32 convolutions change {int((on != off).sum())} of {on.numel()} "
        f"logits")
    if not np.array_equal(d_default, d_off) or \
            d_off[0] != max(0.0, full_ev.clean_accuracy() - full_rows[
                tuple(int(g) for g in row[0])]):
        raise AssertionError("dAcc depends on the caller's TF32 flags")

    # the per-row conv loop at rows > 1: one 8-row forward against 1 row
    rows8 = np.array(list(full_rows)[:8])
    t1 = time_ms(lambda: full_ev._dispatch(rows8[:1]), iters=5, warmup=1)
    t8 = time_ms(lambda: full_ev._dispatch(rows8), iters=3, warmup=1)
    log(f"phase8 whole forward per row: {t1:.3f} ms at 1 row, "
        f"{t8 / 8:.3f} ms at 8 rows")

    # the quickstart, shortened
    t0 = time.perf_counter()
    out = quickstart.main(["--steps", "20", "--generations", "2"])
    objs = out["plan"].front_objs
    q_stats = out["evaluator"].staged_stats()
    if not (np.isfinite(objs).all() and (objs[:, 2] >= 0).all()
            and out["evaluator"].eval_strategy == "staged"
            and q_stats["unit_runs_avoided"] > 0):
        raise AssertionError(f"quickstart front out of range or no unit "
                             f"run saved: {objs}, {q_stats}")
    log(f"phase8 quickstart: {time.perf_counter() - t0:.2f} s, staged stats "
        f"{json.dumps(q_stats)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.cnn_setup import (accuracy_under_partition,
                                       clean_argmax_labels, make_evaluator)
    from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultSpec,
                                  FaultUnawareBaseline, NSGA2Config)
    from repro_torch.kernels import _build, ops
    from repro_torch.models.cnn import AlexNet, ResNet18

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # phase 1: nothing to set (see the docstring)
    # phase 2
    smi = nvidia_smi()
    log("card:", smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    info = _build.build_all()
    log(f"phase2 build: {info['seconds']:.1f} s for {info['built']} "
        f"into {info['dir']}")
    for name, text in info["ptxas"].items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs)} "
            f"registers a thread, {spill} bytes of spills")

    records = {
        "bitflip": dict(route="cuda", source="src/repro_torch/csrc/bitflip.cu",
                        replaces="src/repro/kernels/bitflip.py:57"),
        "quant_bitflip": dict(
            route="cuda", source="src/repro_torch/csrc/quant_bitflip.cu",
            replaces="src/repro/kernels/quant_bitflip.py:50"),
        "fault_matmul": dict(
            route="cuda", source="src/repro_torch/csrc/fault_matmul.cu",
            replaces="src/repro/kernels/fault_matmul.py:61"),
    }
    check_kernels(dev, records)

    # phase 4: the main path
    spec = FaultSpec(**SPEC_RATES)
    seed, params, labels = pick_resnet_seed(dev)
    log(f"phase4 resnet18 width 1.0 seed {seed}: clean-argmax labels span "
        f"{int((torch.bincount(labels, minlength=16) > 0).sum())} classes")
    layers = ResNet18.layer_infos(num_classes=16, width=1.0, img=32)
    cfg = NSGA2Config(population=24, generations=3, seed=0)
    ev = make_evaluator("resnet18", params, spec, n_eval=512,
                        fault_backend="kernel", labels=labels,
                        eval_strategy="full", device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                     nsga2_config=cfg).optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    full_rows = dict(ev._cache)
    base = FaultUnawareBaseline(layers, PAPER_DEVICES,
                                nsga2_config=cfg).optimize()
    main_launches = dict(ops.launches)
    log(f"phase4 AFarePart (full): {wall:.3f} s wall, "
        f"{ev.dispatches} dispatches, {ev._engine.rows_evaluated} rows, "
        f"launches {main_launches}")
    if min(main_launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{main_launches}")
    objs = plan.front_objs
    if not (np.isfinite(objs).all() and (objs[:, 2] >= 0).all()
            and (objs[:, 2] <= 1).all() and objs[:, 2].max() > 0):
        raise AssertionError(f"AFarePart front out of range: {objs}")
    log(f"phase4 front ({len(plan.front)} points):")
    for row, o in zip(plan.front, objs):
        log(f"  map={''.join(map(str, row))} lat={o[0] * 1e3:.3f}ms "
            f"energy={o[1] * 1e3:.3f}mJ dAcc={o[2]:.4f}")
    for tool, p in (("AFarePart", plan), ("fault-unaware", base)):
        acc = accuracy_under_partition("resnet18", params, p.partition, 0.2,
                                       0.2, n_eval=512, labels=labels,
                                       device=dev)
        log(f"phase4 {tool:13s} P={''.join(map(str, p.partition))} "
            f"top-1 under 20% faults={acc:.4f} lat={p.latency * 1e3:.3f}ms "
            f"energy={p.energy * 1e3:.3f}mJ")
    for name, r in records.items():
        r["full_launches"] = main_launches[name]

    # phase 5: AlexNet at width 1.0
    a_params = AlexNet.init(0, 16, width=1.0, img=32, device=dev)
    a_labels = clean_argmax_labels("alexnet", a_params, 512, device=dev)
    a_ev = make_evaluator("alexnet", a_params, spec, n_eval=512,
                          fault_backend="kernel", labels=a_labels, device=dev)
    P = np.random.default_rng(1).integers(0, 2, size=(8, AlexNet.n_units))
    ops.reset_launches()
    t0 = time.perf_counter()
    a_dacc = a_ev.delta_acc(P)
    torch.cuda.synchronize()
    log(f"phase5 alexnet width 1.0 dAcc {np.round(a_dacc, 4).tolist()} in "
        f"{time.perf_counter() - t0:.2f} s, launches {dict(ops.launches)}")
    if ops.launches["fault_matmul"] <= 0 or not np.isfinite(a_dacc).all():
        raise AssertionError("alexnet population did not run fault_matmul")
    records["fault_matmul"]["shapes"][1]["launches"] = ops.launches[
        "fault_matmul"]

    # phase 6: generic against kernel on one ResNet18 population
    P = np.random.default_rng(2).integers(0, 2, size=(8, ResNet18.n_units))
    g_ev = make_evaluator("resnet18", params, spec, n_eval=512,
                          fault_backend="generic", labels=labels, device=dev)
    dk, dg = ev.delta_acc(P), g_ev.delta_acc(P)
    diff = np.abs(dk - dg)
    log(f"phase6 kernel {np.round(dk, 4).tolist()} generic "
        f"{np.round(dg, 4).tolist()}: {int((diff > 0).sum())} of {len(P)} "
        f"rows differ, max {diff.max():.4f}")
    # the generic backend's fc runs cuBLAS, the kernel backend fault_matmul:
    # another fp32 summation order can move a near-tie image
    if diff.max() > 2.0 / 512:
        raise AssertionError("generic and kernel dAcc differ by more than "
                             "2/n_eval")

    # phase 7: where one candidate's device time goes, by kernel
    row = np.zeros((1, ResNet18.n_units), np.int64)
    t_row = time_ms(lambda: ev._dispatch(row), iters=5, warmup=1)
    log(f"phase7 one ResNet18 candidate (kernel backend, 512 images): "
        f"{t_row:.3f} ms device time")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev._dispatch(row)
        torch.cuda.synchronize()
    kernels_ = [a for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA]
    if not kernels_:
        raise AssertionError("the profiler recorded no device kernel")
    busy = sum(a.self_device_time_total for a in kernels_) / 1e3
    log(f"phase7 profiler: kernels busy {busy:.3f} ms of {t_row:.3f} ms "
        f"({100 * (1 - busy / t_row):.1f}% idle)")
    groups = {}
    for a in kernels_:
        g = groups.setdefault(kernel_group(a.key), [0.0, 0])
        g[0] += a.self_device_time_total / 1e3
        g[1] += a.count
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"phase7 per candidate: {name:16s} {ms:8.3f} ms {count:4d} launches")
    for name, r in records.items():
        r["candidate_ms"], r["candidate_launches"] = groups.get(name, (0.0, 0))
    for a in sorted(kernels_, key=lambda a: a.self_device_time_total,
                    reverse=True)[:12]:
        log(f"  {a.self_device_time_total / 1e3:8.3f} ms {a.count:4d}x "
            f"{a.key[:90]}")

    # phase 8: the staged path
    staged_phase(dev, params, labels, spec, layers, cfg, plan, full_rows, ev,
                 records)

    kernels = [dict(name=name, **{k: r[k] for k in RECORD_KEYS if k in r})
               for name, r in records.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
