#!/usr/bin/env python3
"""FSDP x tensor parallelism of the port across real cards.

    python3 tp_cards.py [--configs olmo-1b,gemma2-27b,deepseek-coder-33b]
        [--steps 4] [--slots N] [--cpu N]

Every local card is one slot (at least two); ``--slots N`` runs N slots
of the first card instead (the slices of all of them in one card's
memory), ``--cpu N`` rehearses on N host slots with the reduced configs.  Prints the cards' names and power
limits, then one line each for:

  * olmo-1b at its published widths and depth (bf16): the FSDP x TP train
    step (``launch.steps.abstract_train_step``) on a ``(2, n/2)`` mesh, or
    ``(1, n)`` on an odd count, 3 steps on 8 x 256 tokens against the
    unsharded ``make_train_step(microbatches=2)`` on the first card (the
    first loss within 2^-8 of it), the step walls, host waits a step (sync
    debug mode), each card's allocator peak and the collective bytes a
    step (``launch.collectives.BYTES``);
  * each config: params laid out over a ``(1, n)`` mesh by
    ``param_specs``, each card's slices drawn there from a seed
    (``placed_params``: no card ever holds the whole model; N(0, 1) /
    sqrt(fan-in) weights, a 0.02 N(0, 1) embedding, unit norm gains),
    prefill of 8 prompts of 64, then ``--steps`` decode steps with every
    layer faulted at 0.2 (4 of 16 bits): each card's allocator peak, the
    step walls, ``quant_bitflip`` kernels a step and, where the whole
    model fits the first card beside its slot with room to spare (1.6x
    its bytes free: olmo-1b), the share of argmax tokens that agree with
    the unsharded steps on that card (the slices gathered there) fed the
    same tokens, and the logits' largest difference.

The collectives move tensors between cards with ``Tensor.to``: over
NVLink where the host has it.  The script fails on a non-finite logit or
loss, or an agreement below 0.75.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B, S, PROMPT, MAX_LEN = 8, 256, 64, 128
LR = 1e-3


def _peaks(devs) -> list[int]:
    return [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
            for d in devs]


def _reset(devs) -> None:
    for d in sorted({d for d in devs if d.type == "cuda"}, key=str):
        torch.cuda.reset_peak_memory_stats(d)


def _sync(devs) -> None:
    for d in sorted({d for d in devs if d.type == "cuda"}, key=str):
        torch.cuda.synchronize(d)


def train_cell(cfg, pool, steps=3) -> dict:
    """The FSDP x TP train step against the unsharded step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.launch import collectives as C
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import abstract_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    n = len(pool)
    shape_ = (2, n // 2) if n % 2 == 0 and n >= 4 else (1, n)
    first = pool[0]
    on_card = first.type == "cuda"
    opt = AdamWConfig(lr=LR, warmup_steps=1, total_steps=steps)
    data = next(TokenStream(vocab=min(4096, cfg.vocab), seq_len=S, batch=B,
                            seed=0))
    batch = {k: torch.from_numpy(v).to(first) for k, v in data.items()}
    params = init_lm(cfg, seed=0, device=first)
    _, _, wm = make_train_step(cfg, opt, microbatches=2)(
        params, init_train_state(cfg, params, opt), batch)
    ref = float(wm["loss"])
    mesh = make_test_mesh(shape_, pool=pool)
    fn, _ = abstract_train_step(cfg, mesh, ShapeSpec(
        "t", seq_len=S, global_batch=B, kind="train"), opt, microbatches=1)
    placed = SH.place_params(params, mesh)
    state = SH.place_opt_state(init_train_state(cfg, params, opt), params,
                               mesh)
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    _reset(pool)
    losses, walls, waits, coll = [], [], [], {}
    for i in range(steps):
        C.reset_bytes()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card and i:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                placed, state, m = fn(placed, state, batch)
                losses.append(m["loss"].item())
                _sync(pool)
                walls.append(time.perf_counter() - t0)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        if i:
            waits.append(sum("called a synchronizing" in str(w.message)
                             for w in caught))
        coll = dict(C.BYTES)
    out = {"cell": f"{cfg.name} train {shape_}", "first_loss": losses[0],
           "unsharded_loss": ref, "losses": losses,
           "walls_ms": [round(1e3 * w, 3) for w in walls],
           "host_waits": waits, "peaks": _peaks(pool),
           "collective_bytes": coll}
    del placed, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ok = np.isfinite(losses).all() and abs(losses[0] - ref) <= \
        2 ** -8 * abs(ref)
    return out, ok


def placed_params(cfg, mesh, seed: int = 0) -> list:
    """One tree a slot, laid out by ``param_specs``: each slot's slice of
    leaf ``j`` drawn on the slot's device from ``seed + 1009 j`` and the
    slice's index along the axes the leaf is split over, so copies of a
    shard are equal and no device holds more than its slices."""
    import math

    from repro_torch._tree import tree_unflatten
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.steps import abstract_params

    like = abstract_params(cfg)
    specs = SH.param_specs(like, mesh)
    leaves, treedef = SH._leaves(like, specs)
    out = []
    for _, dev, coords in SH._slots(mesh):
        local = []
        for j, (path, leaf, spec) in enumerate(leaves):
            bounds = SH._bounds(spec, leaf.shape, mesh, coords)
            shape = [n for _, n in bounds] + list(leaf.shape[len(bounds):])
            idx = sum(start * 131 ** d for d, (start, _) in enumerate(bounds))
            gen = torch.Generator(device=dev).manual_seed(
                seed + 1009 * j + 7 * idx)
            name = str(path[-1])
            if leaf.ndim - (1 if name != "embed" and path[0] == "groups"
                            else 0) <= 1:
                t = torch.ones(shape, device=dev, dtype=leaf.dtype)
            else:                       # drawn in the leaf's dtype
                t = torch.randn(shape, generator=gen, device=dev,
                                dtype=leaf.dtype).mul_(
                    0.02 if name == "embed" else 1 / math.sqrt(
                        leaf.shape[-2]))
            local.append(t)
        out.append(tree_unflatten(treedef, local))
    return out


def decode_cell(cfg, pool, steps, compare) -> dict:
    """Prefill and faulted decode over a (1, n) mesh of ``pool``."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (abstract_serve_decode,
                                          abstract_serve_prefill)
    from repro_torch.models.transformer import decode_step, prefill

    n, first = len(pool), pool[0]
    on_card = first.type == "cuda"
    mesh = make_test_mesh((1, n), pool=pool)
    pfn, (params_s, _) = abstract_serve_prefill(cfg, mesh, ShapeSpec(
        "p", seq_len=MAX_LEN, global_batch=B, kind="prefill"))
    dfn, _ = abstract_serve_decode(cfg, mesh, ShapeSpec(
        "d", seq_len=MAX_LEN, global_batch=B, kind="decode"))
    t0 = time.perf_counter()
    placed = placed_params(cfg, mesh)
    _sync(pool)
    t_init = time.perf_counter() - t0
    need = sum(t.numel() * t.element_size()
               for t in tree_leaves(params_s))
    if compare and on_card:   # the whole model beside the first slot's,
        # and both faulted steps' whole-layer copies on the first card
        compare = torch.cuda.mem_get_info(first)[0] > 1.6 * need
    whole = SH.gather_params(placed, params_s, mesh, first) if compare \
        else None
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, PROMPT))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(first)}
    w = torch.full((cfg.n_layers,), 0.2, device=first)
    _reset(pool)
    with torch.no_grad():
        last, cache = pfn(placed, batch)
        if compare:
            lu, ucache = prefill(whole, cfg, batch, MAX_LEN)
            tok = lu[:, -1].argmax(-1).to(torch.int32)
            diffs = [(last.float() - lu[:, -1].float()).abs().max().item()]
        else:
            tok = last.argmax(-1).to(torch.int32)
            diffs = []
        agree, walls, kernels, finite = [], [], [], bool(
            torch.isfinite(last).all())
        for i in range(steps):
            pos = torch.full((B,), PROMPT + i, dtype=torch.int32,
                             device=first)
            fault = (w, w, 1000 + i)
            _sync(pool)
            ops.reset_launches()
            t1 = time.perf_counter()
            ls, cache = dfn(placed, cache, {"tokens": tok, "positions": pos},
                            fault=fault)
            _sync(pool)
            walls.append(time.perf_counter() - t1)
            kernels.append(ops.launches["quant_bitflip"])
            finite = finite and bool(torch.isfinite(ls).all())
            if compare:
                lu, ucache = decode_step(whole, cfg, ucache, tok, pos,
                                         fault=fault)
                diffs.append((ls.float() - lu.float()).abs().max().item())
                agree.append((ls.argmax(-1) == lu.argmax(-1)).float().mean()
                             .item())
                tok = lu.argmax(-1).to(torch.int32)
            else:
                tok = ls.argmax(-1).to(torch.int32)
    out = {"cell": f"{cfg.name} serve (1, {n})", "init_s": round(t_init, 2),
           "peaks": _peaks(pool), "walls_ms": [round(1e3 * x, 3)
                                               for x in walls],
           "quant_bitflip_a_step": kernels, "agreement": agree,
           "max_abs_diff": max(diffs) if diffs else None,
           "compared": bool(compare), "finite": finite}
    del placed, whole, cache
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ok = finite and (not agree or float(np.mean(agree)) >= 0.75)
    return out, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs",
                    default="olmo-1b,gemma2-27b,deepseek-coder-33b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="this many slots of the first card")
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on this many host slots, reduced configs")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    if args.cpu:
        pool = [torch.device("cpu")] * args.cpu
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < (1 if args.slots else 2):
            print("tp_cards: needs at least two cards, or one with --slots",
                  file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        _build.build_all()
        pool = [torch.device("cuda", 0)] * args.slots if args.slots else \
            [torch.device("cuda", i) for i in range(n)]
    ok_all = True
    for name in args.configs.split(","):
        cfg = get_config(name)
        if args.cpu:
            cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
        if name == "olmo-1b":
            out, ok = train_cell(cfg, pool)
            print(json.dumps(out), flush=True)
            ok_all &= ok
        out, ok = decode_cell(cfg, pool, args.steps,
                              compare=name in ("olmo-1b", "gemma2-27b"))
        print(json.dumps(out), flush=True)
        ok_all &= ok
    print(json.dumps({"ok": bool(ok_all)}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
