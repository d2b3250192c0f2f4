"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the correctness check, and the result line.

Everything a cell is made of is found by name in ``BENCHMARK.json``:
``configs/<config>.json`` (the sizes, as run), ``reference/<config>.py``
(the plain model, and the weights and inputs made from the seed),
``work/<config>.py`` (the work each unit needs), ``systems/<system>.py``
(how the program is built for such a configuration),
``traffic/<traffic>.json`` (the mix's parameters, read by ``drive.py``)
and ``metrics/<metric>.py`` (one reader a metric, or a quantity's reader
for each cell kind it is split by).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 3.0         # whole steps are profiled until this has passed


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def reference_module(config: str):
    return load_module(BENCH / "reference" / f"{config}.py",
                       f"bench.reference.{_ident(config)}")


def work_module(config: str):
    return load_module(BENCH / "work" / f"{config}.py",
                       f"bench.work.{_ident(config)}")


def metric_reader(metric: str):
    """``metrics/<metric>.py``; a metric split by the cells it is reported
    in (``<quantity>.<split>``, such as ``mfu.lm``) is read by
    ``metrics/<quantity>.py`` unless it has a reader of its own."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, f"bench.metrics.{_ident(path.stem)}").read


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    the metrics it reports."""

    def __init__(self, bench: dict, name: str, conf: dict | None = None,
                 traffic: dict | None = None):
        w = {c["name"]: c for c in bench["workloads"]}
        if name not in w:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.spec = name, w[name]
        entry = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.conf = conf if conf is not None else load_json(ROOT / entry["file"])
        self.traffic = traffic if traffic is not None else load_json(
            BENCH / "traffic" / f"{self.spec['traffic']}.json")
        self.chips = self.spec["chips"]

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def seeds(seed: int) -> dict:
    """Independent streams of the run's seed."""
    ss = np.random.SeedSequence(seed)
    keys = ("weights", "inputs", "traffic", "check")
    return {k: np.random.default_rng(s) for k, s in zip(keys, ss.spawn(4))}


def _needed(calls, n_units):
    """Per phase: how often each unit's run was needed (a prefix node, unit
    ``i`` and the genes up to it, first seen under its environment) and
    how often a unit ran first in an environment."""
    seen: dict = {}
    out: dict = {}
    for c in calls:
        runs, first = out.setdefault(
            c["phase"], (np.zeros(n_units, np.int64), np.zeros(n_units, np.int64)))
        nodes, units = seen.setdefault(c["env"], (set(), set()))
        for row in np.unique(c["rows"], axis=0):
            for i in range(n_units):
                key = (i, row[:i + 1].tobytes())
                if key not in nodes:
                    nodes.add(key)
                    runs[i] += 1
                    if i not in units:
                        units.add(i)
                        first[i] += 1
    return out


def work_totals(work, needed) -> dict:
    runs, first = needed
    keys = ("flops", "conv_flops", "fm_flops", "fm_bytes", "act_bytes")
    tot = {k: float(sum(r * w[k] for r, w in zip(runs, work))) for k in keys}
    tot["act_draws"] = float(sum(f * w["act_draws"] for f, w in zip(first, work)))
    tot["fm_draws"] = float(sum(f * w["fm_draws"] for f, w in zip(first, work)))
    tot["unit_runs"] = int(runs.sum())
    return tot


def _stats_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b if isinstance(b[k], (int, float))}


def _phase_calls(calls, phase):
    return [c for c in calls if c["phase"] == phase]


def _sample(calls, k, rng):
    """``k`` distinct (environment, row) answers of the window, drawn from
    the check's stream: ``(env, row, dacc, objs or None)``."""
    seen = {}
    for c in calls:
        for j, row in enumerate(c["rows"]):
            key = (c["env"], row.tobytes())
            if key not in seen:
                objs = None if c["objs"] is None else c["objs"][j]
                seen[key] = (c["env"], row, float(c["dacc"][j]), objs)
    items = list(seen.values())
    pick = rng.choice(len(items), size=min(k, len(items)), replace=False)
    return [items[i] for i in sorted(pick)]


def check(conf, ref_mod, made, sample, envs, n_items, precision=None):
    """The numbers compared: the widest gap between the program's ΔAcc and
    the reference's (in calibration items: images or tokens), the share of
    rows whose ΔAcc differs at all (percent), and for a search the widest
    relative gap of latency and energy.  ``precision`` other than the configuration's runs the control
    in the program's place."""
    kw = {} if precision is None else {"precision": precision}
    ref = ref_mod.Reference(conf, made["params"], made["x"] if "x" in made
                            else made["tokens"], **kw)
    got = np.array([s[2] for s in sample])
    want = np.zeros(len(sample))
    for env in sorted({s[0] for s in sample}):
        idx = [j for j, s in enumerate(sample) if s[0] == env]
        want[idx] = ref.delta_acc(np.stack([sample[j][1] for j in idx]),
                                  envs[env])
    del ref
    gap = np.abs(got - want) * n_items
    out = {"dacc_gap_max": float(gap.max()),
           "rows_differing": 100.0 * float((gap > 0).mean())}
    objs = [s[3] for s in sample]
    if precision is None and all(o is not None for o in objs):
        lat, en = ref_mod.latency_energy(conf, np.stack([s[1] for s in sample]))
        objs = np.stack(objs)
        rel = np.maximum(np.abs(objs[:, 0] - lat) / lat,
                         np.abs(objs[:, 1] - en) / en)
        out["cost_rel_gap"] = float(rel.max())
    return out, want


def n_items(conf) -> int:
    if "calibration" in conf:
        c = conf["calibration"]
        return c["batch"] * c["seq"]
    return conf["n_eval"]


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, conf: dict | None = None,
             traffic: dict | None = None, controls: tuple = (), log=print,
             pool: list | None = None):
    """One run.  Returns the result object and the check's lines.
    ``conf`` and ``traffic`` replace the cell's files (the tests' small
    sizes); ``controls`` also reads each named precision's control.

    The program spreads its work over the cell's ``chips``: the first that
    many cards (``device`` is ``cuda:0``), or on the host the first that
    many slots of ``pool`` (the tests' host slots)."""
    cell = Cell(bench, name, conf, traffic)
    conf, traffic = cell.conf, cell.traffic
    rngs = seeds(seed)
    on_card = device.type == "cuda"
    slots = cell.chips if pool is None else list(pool[:cell.chips])
    cards = [torch.device("cuda", i) for i in range(cell.chips)] \
        if on_card else []

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def peaks() -> list[int]:
        """Each card's allocator peak; on the host one reading of 0."""
        return [torch.cuda.max_memory_allocated(d) for d in cards] or [0]

    marks = [("start", time.perf_counter())]
    ref_mod = reference_module(cell.spec["config"])
    made = ref_mod.make(conf, rngs["weights"], rngs["inputs"], device)
    sync()
    marks.append(("inputs", time.perf_counter()))
    system_mod = load_module(BENCH / "systems" / f"{conf['system']}.py",
                             f"bench.systems.{conf['system']}")
    system = system_mod.System(conf, made, device, slots)
    sync()
    marks.append(("system", time.perf_counter()))
    from bench.drive import Driver
    drv = Driver(system, traffic, rngs["traffic"])
    drv.warmup()
    sync()
    marks.append(("warmup", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(
            [("process", t_start)] + marks[:-1], marks)))
    setup_peaks = peaks()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)

    stats0 = system.stats()
    t0, t1 = drv.run("window", seconds)
    stats1 = system.stats()
    window_peaks = peaks()

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from bench.profile_reader import Trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                         else [])
        with profile(activities=acts) as prof:
            with record_function("bench:trace"):
                drv.run("trace", TRACE_SECONDS)
                sync()
        tr = Trace.read(prof, work_module(cell.spec["config"]).LIBRARY_GROUP,
                        [d.index for d in cards] or [0], on_card)
        del prof
    stats2 = system.stats()

    ctx = types.SimpleNamespace()      # what the metric readers read
    ctx.conf, ctx.traffic, ctx.chips, ctx.setup_s = conf, traffic, cell.chips, setup_s
    calls = drv.rec.calls
    win = _phase_calls(calls, "window")
    ctx.rows = sum(len(c["rows"]) for c in win)
    ctx.wall = t1 - t0
    ctx.steps = [s for s in drv.steps if s["phase"] == "window"]
    ctx.dacc_s = sum(c["t1"] - c["t0"] for c in win)
    ctx.stats = _stats_delta(stats0, stats1)
    ctx.peak_bytes = max(window_peaks)         # the fullest card's
    work = work_module(cell.spec["config"]).unit_work(conf)
    needed = _needed(calls, system.n_units)
    zero = (np.zeros(system.n_units, np.int64),) * 2
    ctx.work = work_totals(work, needed.get("window", zero))
    ctx.trace = tr
    if tr is not None:
        tcalls = _phase_calls(calls, "trace")
        ctx.trace_rows = sum(len(c["rows"]) for c in tcalls)
        ctx.trace_work = work_totals(work, needed.get("trace", zero))
        ctx.trace_stats = _stats_delta(stats1, stats2)
    attempted = ctx.rows
    failed = int(sum((~np.isfinite(c["dacc"])).sum() for c in win))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": torch.cuda.get_device_name(device) if on_card
                else "cpu",
                "count": cell.chips}
    card_peaks = [int(max(a, b)) for a, b in zip(setup_peaks, window_peaks)]
    dev_info["memory_peak_bytes"] = max(card_peaks)
    dev_info["memory_peak_bytes_per_card"] = card_peaks
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["busy_s_per_card"] = tr.busy_s_per_card
        dev_info["window_s"] = tr.window_s
    breakdown = tr.breakdown() if tr is not None else None

    # the program's state goes before the reference runs
    sample = _sample(win, conf["check"]["rows"], rngs["check"])
    envs = list(drv.envs)
    del drv, system, tr, ctx, calls, win
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, want = check(conf, ref_mod, made, sample, envs, n_items(conf))
    limits = conf["check"]["limits"]
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in numbers)
    control = {}
    rows = {"env": [s[0] for s in sample],
            "program": [s[2] * n_items(conf) for s in sample],
            "reference": list(want * n_items(conf))}
    for p in controls:
        control[p], rows[p] = check(conf, ref_mod, made, sample, envs,
                                    n_items(conf), precision=p)
        rows[p] = list(rows[p] * n_items(conf))
    sync()
    log(f"check: {len(sample)} rows over "
        f"{len({s[0] for s in sample})} environments in "
        f"{time.perf_counter() - t_check:.1f} s")
    lines = [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in numbers]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if controls:
        result["control"] = control
        result["rows"] = rows
    # the numbers compared, each beside its limit, last
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in numbers}
    return result, lines
