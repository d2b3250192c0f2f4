"""The dry run, the counterpart of ``repro/launch/dryrun.py``: does an
(arch x shape) cell fit the production mesh, and what are its per-device
memory, FLOPs, bytes, collective bytes and roofline terms?

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod] [--both-meshes] [--all] [--out DIR]

The reference compiles every cell for 256 or 512 fake XLA devices and
reads XLA's cost and memory analyses.  Here the step of ``launch/steps.py``
runs on ``meta`` tensors over a pool of ``meta`` devices
(``make_production_mesh``: 16x16, or 2x16x16 with ``--multi-pod``), so no
device allocates anything, and its ops are counted as they dispatch:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``;
  * ``bytes_accessed``: every aten op's input and output bytes (views
    excluded), summed op by op: unfused, so larger than XLA's count for
    the same step;
  * ``collective_bytes``: the port's collectives' counter
    (``launch/collectives.py``), the conventions of the reference's;
  * ``memory.argument_bytes``: one slot's local slices of the step's
    arguments (params, optimizer state, batch, cache) by their specs,
    exactly (a pipelined cell: the first or last stage's slot, whichever
    holds more); ``output_bytes`` those the step returns (params and state,
    or the cache); ``temp_bytes``: the peak of live storage bytes the
    step allocates, by a storage-lifetime count: one data row's work is
    shared by its model slots, the fp32 gradient accumulators counted a
    slot each (a pipelined cell: its rows' peak shared by their stages'
    model slots, plus one slot's update); ``peak_bytes`` = arguments + temporaries (the outputs
    replace the donated arguments, as the reference donates them);
  * ``probes``: as the reference, the costs are measured on the 2- and
    4-group variants of the config (``_shrink``) and extrapolated
    linearly in depth; here ``temp_bytes`` is extrapolated the same way
    (the reference reads it off the full compile);
  * ``roofline``: ``launch/roofline.py``'s terms with its H100 defaults.

A cell computes one data row (``rows=[0]``; a pipelined cell: row 0 of
every stage): every row does the same work on the same shapes, so it
counts once a row; the update runs on one slot (a pipelined cell: one a
stage), counted once a slot.  The costs are
the work this one process does: a replicated activation is computed
once a row, on its first slot, where GSPMD computes it on every slot.
``compile_s`` and ``probe_compile_s`` keep the reference's keys for the
walls of the passes (nothing compiles).  The reference's ``--hlo`` (save
XLA's HLO text) has no meaning here and is not a flag.

Overrides (``run_cell(overrides=...)``): ``microbatches``, ``remat``,
``seq_axis``, ``n_micro``, ``partition``, ``moe_capacity`` are the
port's options; ``logit_shard`` is the port's layout (logits are sliced
over ``"model"`` wherever the vocab divides); ``causal_skip``,
``attn_bf16`` and ``block_seq`` have no counterpart and are refused by
name.  Records go to ``results/torch_dryrun/`` (git-ignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._tree import tree_leaves
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import collectives as C
from repro_torch.launch import pipeline as pp
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.launch.shardings import (cache_pspecs, local_bytes,
                                          opt_state_specs, param_specs,
                                          shard_tree)
from repro_torch.serve.kvcache import cache_specs
from repro_torch.train.train_step import init_train_state

__all__ = ["run_cell", "Counter", "RESULTS_DIR", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch_dryrun")
META = torch.device("meta")
_OPTIONS = ("microbatches", "remat", "seq_axis", "n_micro", "partition",
            "moe_capacity", "logit_shard")
_REFUSED = {
    "causal_skip": "the reference's static triangular schedule of an "
                   "unrolled TPU scan",
    "attn_bf16": "the reference's bf16 score tiles",
    "block_seq": "the reference's sequence-sharded activations between "
                 "blocks",
}


class Counter(TorchDispatchMode):
    """Counts, while active: FLOPs (``FlopCounterMode``), every non-view
    aten op's input and output bytes, the collectives' bytes, and the live
    bytes of the storages allocated inside (their peak, ``peak``)."""

    def __enter__(self):
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        self.bytes = self.live = self.peak = 0
        self._coll = C.total_bytes()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._flops.__exit__(*exc)
        self.flops = self._flops.get_total_flops()
        self.coll = C.total_bytes() - self._coll

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = [t for t in tree_leaves(list(args) + list((kwargs or {})
                                                        .values()))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


def _shrink(cfg, n_groups: int):
    """The same family with exactly ``n_groups`` block-pattern groups (the
    cost probes; embeddings and head untouched: the intercept)."""
    kw = {"n_layers": n_groups * len(cfg.block_pattern)}
    if cfg.is_encdec:
        kw["n_enc_layers"] = n_groups
    return dataclasses.replace(cfg, **kw)


def _check_overrides(ov: dict) -> None:
    for k, v in ov.items():
        if k in _REFUSED:
            if v:
                raise ValueError(f"override {k!r}: {_REFUSED[k]}, which has "
                                 "no counterpart in the port")
        elif k not in _OPTIONS:
            raise ValueError(f"unknown override {k!r}")


def _cell(cfg, shape, mesh, multi_pod: bool, ov: dict):
    """``(probe, arguments bytes, outputs bytes)`` of one cell: ``probe()``
    runs the step once on meta tensors and returns its counts, whole
    step, and the temporaries of one slot."""
    n = mesh.size
    if shape.kind == "train" and multi_pod:
        fn, (pp_s, opt_s, batch_s) = S.abstract_pp_train_step(
            cfg, mesh, shape, n_micro=ov.get("n_micro", 4),
            partition=ov.get("partition"))
        placed = pp.place_pp_params(pp_s, mesh)
        state = init_train_state(cfg, placed, S._default_opt(cfg, None))
        p_bytes = _pp_bytes(pp_s, pp_s, mesh)
        o_bytes = _pp_bytes(opt_s["m"], pp_s, mesh) \
            + _pp_bytes(opt_s["v"], pp_s, mesh) + 4
        arg = p_bytes + o_bytes + _batch_bytes(cfg, shape, mesh, batch_s)

        nd, nm, n_st = (mesh.shape[a] for a in ("data", "model", "pod"))
        k = nd * nm

        def probe():
            with Counter() as c1:         # one data row of every stage
                _, grads = fn.value_and_grad(placed, batch_s, rows=[0])
            flops, nbytes, coll = c1.flops * nd, c1.bytes * nd, c1.coll * nd
            upd = 0
            for s in range(n_st):         # a stage's slots update alike
                one = [_pp_slot(t, s, k, n_st) for t in (
                    placed, grads, state["m"], state["v"], fn.counted)]
                with Counter() as c2:
                    fn.update(one[0], one[1], {"m": one[2], "v": one[3],
                                               "step": state["step"]},
                              one[4])
                flops, nbytes = flops + c2.flops * k, nbytes + c2.bytes * k
                upd = max(upd, c2.peak)
            return flops, nbytes, coll, c1.peak / (n_st * nm) + upd

        return probe, arg, p_bytes + o_bytes
    if shape.kind == "train":
        fn, (params_s, opt_s, batch_s) = S.abstract_train_step(
            cfg, mesh, shape, microbatches=ov.get("microbatches"),
            remat=ov.get("remat", True), seq_axis=ov.get("seq_axis",
                                                         "model"))
        pspec = param_specs(params_s, mesh)
        placed = shard_tree(params_s, pspec, mesh)
        state = shard_tree(opt_s, opt_state_specs(pspec), mesh)
        p_bytes = local_bytes(params_s, pspec, mesh)
        o_bytes = local_bytes(opt_s, opt_state_specs(pspec), mesh)
        arg = p_bytes + o_bytes + _batch_bytes(cfg, shape, mesh, batch_s)
        nd, nm = mesh.shape["data"], mesh.shape["model"]

        def probe():
            with Counter() as c0:         # the accumulators alone
                fn.value_and_grad(placed, batch_s, rows=[])
            with Counter() as c1:         # one data row
                _, grads = fn.value_and_grad(placed, batch_s, rows=[0])
            with Counter() as c2:         # one slot's update
                fn.update(placed[:1], grads[:1], state[:1])
            temp = max((c1.peak - c0.peak) / nm, c2.peak) + c0.peak / n
            return (c1.flops * nd + c2.flops * n, c1.bytes * nd + c2.bytes * n,
                    (c1.coll - c0.coll) * nd + c0.coll, temp)

        return probe, arg, p_bytes + o_bytes
    multi = "pod" in mesh.axis_names
    cspec = cache_pspecs(cfg, shape, multi_pod=multi)
    cache_s = cache_specs(cfg, shape.global_batch, shape.seq_len)
    c_bytes = local_bytes(cache_s, cspec, mesh)
    if shape.kind == "prefill":
        fn, (params_s, batch_s) = S.abstract_serve_prefill(
            cfg, mesh, shape, seq_axis=ov.get("seq_axis", "model"))
        call = lambda p, r: fn(p, batch_s, rows=r)  # noqa: E731
    else:
        fn, (params_s, cache_s, batch_s) = S.abstract_serve_decode(
            cfg, mesh, shape)
        cache = shard_tree(cache_s, cspec, mesh)
        call = lambda p, r: fn(p, cache, batch_s, rows=r)  # noqa: E731
    pspec = param_specs(params_s, mesh)
    placed = shard_tree(params_s, pspec, mesh)
    p_bytes = local_bytes(params_s, pspec, mesh)
    arg = p_bytes + _batch_bytes(cfg, shape, mesh, batch_s) + (
        c_bytes if shape.kind == "decode" else 0)
    nm = mesh.shape["model"]

    def probe():
        with Counter() as c, torch.no_grad():
            call(placed, [0])
        return (c.flops * fn.n_rows, c.bytes * fn.n_rows,
                c.coll * fn.n_rows, c.peak / nm)

    return probe, arg, c_bytes


def _pp_slot(tree: dict, s: int, k: int, n_st: int) -> dict:
    """Stage ``s``'s first slot's part of a placed pp tree (``stages`` one
    tree a mesh slot; the embedding and encoder a slot of the first
    stage's sub-mesh, the final norm and head of the last's)."""
    out = {"stages": [tree["stages"][s * k]]}
    for key, v in tree.items():
        if key != "stages" and (0 if key in pp._FIRST else n_st - 1) == s:
            out[key] = [v[0]]
    return out


def _pp_bytes(tree, like, mesh) -> int:
    """One slot's bytes of a pp-shaped ``tree`` laid out as
    ``pipeline.place_pp_params`` lays out ``like`` (the largest over the
    stages' sub-meshes: the first holds the embedding, the last the
    head)."""
    specs, subs = pp._specs(like, mesh), pp.stage_meshes(mesh)
    stage = local_bytes(tree["stages"], specs["stages"], mesh)
    side = [0, 0]
    for k, v in tree.items():
        if k != "stages":
            side[k not in pp._FIRST] += local_bytes(
                {k: v}, {k: specs[k]}, pp._sub(k, subs))
    return stage + max(side)


def _batch_bytes(cfg, shape, mesh, batch_s) -> int:
    from repro_torch.launch.shardings import batch_specs
    bspec = batch_specs(cfg, shape, multi_pod="pod" in mesh.axis_names
                        and shape.kind != "train")
    return local_bytes(batch_s, {k: bspec[k] for k in batch_s}, mesh)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             save: bool = True, overrides: dict | None = None,
             tag_suffix: str = "", out_dir: str | None = None) -> dict:
    """One (arch x shape x mesh) cell: the reference's record (see the
    module docstring)."""
    ov = dict(overrides or {})
    _check_overrides(ov)
    cfg = get_config(arch)
    if ov.get("moe_capacity"):
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(ov["moe_capacity"]))
    shape = SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(see DESIGN.md §5)"}
    mesh = make_production_mesh(multi_pod=multi_pod,
                                pool=[META] * (512 if multi_pod else 256))
    n_chips = mesh.size
    t0 = time.time()
    _, arg, out = _cell(cfg, shape, mesh, multi_pod, ov)
    t_full = time.time() - t0
    probes = {}
    for g in (2, 4):
        t1 = time.time()
        C.reset_bytes()
        flops, nbytes, coll, temp = _cell(_shrink(cfg, g), shape, mesh,
                                          multi_pod, ov)[0]()
        probes[g] = {"flops": flops / n_chips, "bytes": nbytes / n_chips,
                     "coll": coll / n_chips, "temp": temp,
                     "compile_s": time.time() - t1}
    G = cfg.n_groups

    def extrapolate(key):
        per_group = (probes[4][key] - probes[2][key]) / 2.0
        fixed = probes[2][key] - 2.0 * per_group
        return max(0.0, fixed + G * per_group)

    temp = int(math.ceil(extrapolate("temp")))
    record = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "n_chips": n_chips, "n_groups": G,
        "flops": extrapolate("flops") * n_chips,
        "bytes_accessed": extrapolate("bytes") * n_chips,
        "collective_bytes": extrapolate("coll") * n_chips,
        "memory": {"argument_bytes": arg, "output_bytes": out,
                   "temp_bytes": temp, "peak_bytes": arg + temp},
        "compile_s": round(t_full, 1),
        "probe_compile_s": [round(probes[2]["compile_s"], 1),
                            round(probes[4]["compile_s"], 1)],
        "probes": {str(k): v for k, v in probes.items()},
    }
    record["roofline"] = roofline_terms(record)
    record["model_flops"] = model_flops(cfg, shape)
    record["useful_flop_ratio"] = (record["model_flops"] / record["flops"]
                                   if record["flops"] else 0.0)
    record["overrides"] = {k: str(v) for k, v in ov.items()}
    if save:
        d = out_dir or RESULTS_DIR
        os.makedirs(d, exist_ok=True)
        tag = f"{arch}_{shape_name}_{'mp' if multi_pod else 'sp'}{tag_suffix}"
        with open(os.path.join(d, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the dry run on meta tensors")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"records' directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   out_dir=args.out)
                    if rec["status"] == "skipped":
                        n_skip += 1
                        print(f"SKIP {tag}: {rec['reason']}", flush=True)
                        continue
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {tag}: flops={rec['flops']:.3e} "
                          f"bytes={rec['bytes_accessed']:.3e} "
                          f"coll={rec['collective_bytes']:.3e} "
                          f"peak/dev={rec['memory']['peak_bytes']/2**30:.2f}"
                          f"GiB bottleneck={r['bottleneck']} "
                          f"(passes {rec['compile_s']}s probes "
                          f"{rec['probe_compile_s']})", flush=True)
                except Exception as e:  # one cell's failure is reported
                    n_fail += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
