"""The port's tracer (``repro_torch.trace``) and the row cache's counters,
on the CPU at the sizes of the other CNN tests (ResNet18 at width 0.25,
16 x 16 images, 8 of them).

  * Without a profiler ``span()`` is the shared null context: it calls no
    ``record_function`` and records nothing.
  * Under ``torch.profiler`` every kept span lies inside the profiler's
    event of the same ``afp:`` name (the shared clock), and the ring keeps
    only its newest ``RING`` spans.
  * A small staged search nests ``search.generation`` -> ``search.objective``
    -> ``engine.delta_acc`` -> ``engine.dispatch`` -> ``forward.segment`` ->
    ``forward.unit``; ``engine.dispatch`` spans count the engine's
    dispatches and ``engine.gather`` the calls that walked fresh rows.
  * Tracing changes no value: ΔAcc and ``staged_stats()`` are bitwise the
    same with the profiler on and off.
  * ``rows_requested`` and ``rows_cached`` count the rows handed over and
    those the row cache answered.
"""
import collections
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultSpec,  # noqa: E402
                              InferenceAccuracyEvaluator, NSGA2Config)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.cnn import ResNet18, quantize_unit_params  # noqa: E402

SPEC = FaultSpec(weight_fault_rate=0.3, act_fault_rate=0.05, faulty_bits=4,
                 bits=8)
SCALE = np.array([p.fault_scale for p in PAPER_DEVICES], np.float32)
WIDTH, IMG, N_EVAL = 0.25, 16, 8
SLACK_NS = 50_000          # a span within its profiler event, either end


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _evaluator(strategy="staged", fuse=True, backend="kernel"):
    params = ResNet18.init(0, num_classes=16, width=WIDTH, img=IMG,
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((N_EVAL, IMG, IMG, 3), generator=g)
    z = torch.zeros((ResNet18.n_units,), dtype=torch.float32)
    with torch.no_grad():
        labels = torch.argmax(ResNet18.apply(params, x, z, z, 0), dim=-1)
    return InferenceAccuracyEvaluator(
        ResNet18.apply, params, x, labels, SPEC, SCALE,
        quant_params=quantize_unit_params(params)
        if backend == "kernel" else None,
        fault_backend=backend, step_fn=ResNet18.step, eval_strategy=strategy,
        fuse_chains=fuse, devices=None, device="cpu")


def _search(ev, generations=2, seed=0):
    layers = ResNet18.layer_infos(16, WIDTH, IMG)
    part = AFarePart(layers, PAPER_DEVICES, fault_spec=SPEC,
                     acc_evaluator=ev, nsga2_config=NSGA2Config(
                         population=8, generations=generations, seed=seed))
    return part.optimize()


def _recorded(run):
    """Run ``run()`` under a CPU profile; returns the spans it kept and
    the profiler's ``afp:`` events as ``(name, start_ns, end_ns)``."""
    start = max((s.index for s in trace._ring), default=-1) + 1
    with _cpu_profile() as prof:
        run()
    kept = [s for s in trace.spans(0, 2 ** 63) if s.index >= start]
    events = [(e.name()[len("afp:"):], e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("afp:")]
    return kept, events


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["span", "spanned"])
def test_no_profiler_no_range_and_no_record(monkeypatch, form):
    def refuse(*a, **k):
        raise AssertionError("record_function called without a profiler")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    before = list(trace._ring)
    assert not autograd_profiler._is_profiler_enabled
    if form == "span":
        ctx = trace.span("engine.plan")
        assert ctx is trace.span("kernel.bitflip")      # one shared object
        with ctx as got:
            assert got is None
    else:
        @trace.spanned("forward.unit")
        def f(a, b=1):
            return a + b
        assert f(1, b=2) == 3 and f.__name__ == "f"
    assert list(trace._ring) == before


@pytest.mark.parametrize("threads", [1, 3])
def test_spans_lie_inside_their_profiler_events(threads):
    """The shared clock: each kept span within its ``afp:`` event, 50 us
    either end, and its parent the span open when it opened.  Other
    threads load the host meanwhile; the profiler records on the thread
    that started it, and so do the spans."""
    def work(tag):
        with trace.span(f"search.t{tag}"):
            for _ in range(3):
                with trace.span(f"engine.t{tag}"):
                    torch.ones(64).sum()
                    ops.bitflip(torch.zeros(16, dtype=torch.int8), 1,
                                torch.tensor([0.5, 0.5]), 4)

    def run():
        ts = [threading.Thread(target=work, args=(t,))
              for t in range(1, threads)]
        for t in ts:
            t.start()
        work(0)
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)

    kept, events = _recorded(run)
    assert len(kept) == 7 and len(events) == len(kept)
    assert {s.name for s in kept} == {"search.t0", "engine.t0",
                                      "kernel.bitflip"}
    by_name = collections.defaultdict(list)
    for name, a, b in events:
        by_name[name].append((a, b))
    for s in kept:
        assert any(a - SLACK_NS <= s.t0_ns <= s.t1_ns <= b + SLACK_NS
                   for a, b in by_name[s.name]), s
    index = {s.index: s for s in kept}
    for s in kept:
        if s.name == "search.t0":
            assert s.parent not in index
        else:
            parent = index[s.parent]
            assert parent.name == ("search.t0" if s.name == "engine.t0"
                                   else "engine.t0")
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns


def test_ring_keeps_only_the_newest_spans(monkeypatch):
    class Range:
        def __init__(self, name):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(trace, "_ring",
                        collections.deque(maxlen=trace.RING))
    monkeypatch.setattr(autograd_profiler, "record_function", Range)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(trace, "_recording", lambda: True)
    assert trace.RING == 1 << 20
    first = None
    for _ in range(trace.RING + 3):
        with trace.span("engine.plan") as s:
            pass
        first = s.index if first is None else first
    kept = trace.spans(0, 2 ** 63)
    assert len(kept) == trace.RING
    assert kept[0].index == first + 3 and kept[-1].index == s.index


# --------------------------------------------------------------------------
# spans in a search
# --------------------------------------------------------------------------
def _chain(s, index):
    names = [s.name]
    while s.parent in index:
        s = index[s.parent]
        names.append(s.name)
    return names


@pytest.mark.parametrize("fuse", [True, False])
def test_search_nests_its_spans_by_layer(fuse):
    ev = _evaluator(fuse=fuse)
    kept, events = _recorded(lambda: _search(ev))
    index = {s.index: s for s in kept}
    chains = {tuple(_chain(s, index)) for s in kept
              if s.name == "forward.unit"}
    assert ("forward.unit", "forward.segment", "engine.dispatch",
            "engine.delta_acc", "search.objective",
            "search.generation") in chains
    names = collections.Counter(s.name for s in kept)
    # two generations, the first scoring the initial population too, and
    # the front's extraction
    assert names["search.generation"] == 3
    assert names["search.objective"] == names["search.cost_model"] == 3
    assert names["kernel.quant_bitflip"] > 0 and names["kernel.bitflip"] > 0
    roots = [s for s in kept if s.parent not in index]
    assert {s.name for s in roots} <= {"search.generation"}
    assert collections.Counter(n for n, _, _ in events) == names


@pytest.mark.parametrize("strategy,fuse", [("staged", True),
                                           ("staged", False),
                                           ("full", True)])
def test_dispatch_and_gather_spans_count_the_engine(strategy, fuse):
    ev = _evaluator(strategy, fuse)
    rng = np.random.default_rng(2)
    P = rng.integers(0, 2, (6, ResNet18.n_units))
    ev.delta_acc(P[:2])                     # the clean row, and warm
    calls = [P, P[:3], np.concatenate([P[3:], rng.integers(
        0, 2, (2, ResNet18.n_units))])]
    before = ev.dispatches

    def run():
        for Q in calls:
            ev.delta_acc(Q)
    kept, _ = _recorded(run)
    names = collections.Counter(s.name for s in kept)
    assert names["engine.dispatch"] == ev.dispatches - before > 0
    assert names["engine.delta_acc"] == len(calls)
    assert names["engine.gather"] == 2       # the second call walks none
    if strategy == "full":
        assert names["forward.apply"] == names["engine.dispatch"]
    else:
        assert names["forward.segment"] == names["engine.dispatch"]


@pytest.mark.parametrize("strategy", ["staged", "full"])
def test_tracing_changes_no_value(strategy):
    on, off = _evaluator(strategy), _evaluator(strategy)
    rng = np.random.default_rng(4)
    gens = [rng.integers(0, 2, (8, ResNet18.n_units)) for _ in range(3)]
    gens.append(np.concatenate([gens[0][:4], gens[2][4:]]))
    with _cpu_profile():
        got = [on.delta_acc(P) for P in gens]
    want = [off.delta_acc(P) for P in gens]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert on.staged_stats() == off.staged_stats()


@pytest.mark.parametrize("strategy", ["staged", "full"])
def test_row_cache_counters(strategy):
    ev = _evaluator(strategy)
    rng = np.random.default_rng(5)
    P = rng.integers(0, 2, (7, ResNet18.n_units))
    P[3] = P[0]                             # a repeat inside one call

    def counts():
        st = ev.staged_stats() if strategy == "staged" else {
            k: getattr(ev._engine, k)
            for k in ("rows_requested", "rows_cached")}
        return st.get("rows_requested", 0), st.get("rows_cached", 0)
    ev.delta_acc(P)
    req0, hit0 = counts()
    assert (req0, hit0) == (len(P), 0)
    ev.delta_acc(P)
    assert counts() == (req0 + len(P), hit0 + len(P))
    ev.device_fault_scale = SCALE * 2       # a new environment: cache empty
    ev.delta_acc(P[:2])
    assert counts() == (req0 + len(P) + 2, hit0 + len(P))
