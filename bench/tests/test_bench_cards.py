"""A cell over several cards: the program gets the cell's ``chips`` as its
slots, its rows do not depend on them, and the trace reader keeps each
card's busy intervals apart (synthetic traces of one and two cards, the
one-card reading against the formulas of a reader that merged every
card into one busy set)."""
import collections
import json
import time
import types

import numpy as np
import pytest
import torch

from bench import harness
from bench.drive import Recorder
from bench.metrics import card_busy_imbalance, idle_share
from bench.profile_reader import Trace
from bench.program_spans import idle_ns_by_layer, innermost, layer_of
from bench.program_spans import idle_share as idle_layer_share
from bench.tests import tiny
from repro_torch.trace import Span

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _run_recorded(monkeypatch, cell, trace=False):
    """A run of ``cell`` over four host slots, one window step long; the
    evaluator and its recorded calls."""
    seen = []
    init = Recorder.__init__

    def spy(self, evaluator):
        init(self, evaluator)
        seen.append((self, evaluator))
    monkeypatch.setattr(Recorder, "__init__", spy)
    res, _ = harness.run_cell(
        tiny.bench_json(), cell, 2 ** 31 + 21, 0.0, trace, CPU,
        time.perf_counter(), conf=tiny.conf("resnet18"),
        traffic=tiny.traffic("search"), log=lambda *a: None,
        pool=[CPU] * 4)
    rec, evaluator = seen[-1]
    return res, rec.calls, evaluator


def test_four_chip_rows_bitwise_one_chip(monkeypatch):
    res1, calls1, ev1 = _run_recorded(monkeypatch, "resnet18.search")
    res4, calls4, ev4 = _run_recorded(monkeypatch, "resnet18.search.4chip")
    assert (ev1.devices, ev4.devices) == (1, 4)
    # ResNet18's ladder has two accelerators: two depth-0 genes, two slots
    assert sorted(ev4._prefix_engine.device_dispatches) == [0, 1]
    assert res1["correct"] and res4["correct"]
    assert res4["device"]["count"] == 4
    assert len(calls1) == len(calls4) > 1
    for a, b in zip(calls1, calls4):
        assert (a["env"], a["phase"]) == (b["env"], b["phase"])
        assert np.array_equal(a["rows"], b["rows"])
        assert np.array_equal(a["dacc"], b["dacc"])     # bitwise


def test_four_chip_traced_run_reports_its_per_layer_metrics(monkeypatch):
    res, _, _ = _run_recorded(monkeypatch, "resnet18.search.4chip",
                              trace=True)
    want = {m["name"] for m in tiny.bench_json()["per_layer"]
            if "resnet18.search.4chip" in m["workloads"]}
    # as for resnet18.search on the host: no allocator peak, and the fault
    # kernels' plain versions run under no kernel's name
    assert set(res["metrics"]) == want - {"peak_mem_gb.cnn4",
                                          "quant_bitflip_roofline.cnn4"}
    d = res["device"]
    # the host stands in for one card
    assert d["busy_s_per_card"] == [d["busy_s"]]
    assert d["memory_peak_bytes_per_card"] == [0]
    assert res["metrics"]["card_busy_imbalance.cnn4"]["value"] == 0.0


def _trace(kernels, cards, cpu=(), spans=(), window=(0, 100)):
    return Trace(window, list(kernels), list(cpu), list(spans), "lib",
                 cards)


def test_two_cards_are_read_apart(monkeypatch):
    kernels = [(10, 30, "a", 0), (20, 40, "b", 0), (50, 60, "a", 1),
               (0, 5, "c", 1), (70, 90, "a", 2)]      # card 2: not the cell's
    tr = _trace(kernels, [0, 1])
    assert tr.busy_by_card == [[[10, 40]], [[0, 5], [50, 60]]]
    assert tr.busy_s_per_card == pytest.approx([30e-9, 15e-9], rel=1e-12)
    assert tr.busy_s == pytest.approx(22.5e-9, rel=1e-12)
    assert tr.by_name["a"] == pytest.approx(30e-9, rel=1e-12)
    # idle: card 0 [0, 10) [40, 100); card 1 [5, 50) [60, 100)
    assert tr.idle_gaps() == pytest.approx({"outside/python": 155e-9})
    ctx = types.SimpleNamespace(trace=tr)
    assert idle_share.read(ctx) == pytest.approx(77.5)
    assert card_busy_imbalance.read(ctx) == pytest.approx(25.0)

    spans = [Span("search.generation", 0, 45, -1, 0),
             Span("engine.delta_acc", 45, 100, -1, 1)]
    monkeypatch.setattr("bench.program_spans.program_spans",
                        lambda c: spans)
    by = idle_ns_by_layer(ctx)
    # search: card 0 [0, 10) [40, 45), card 1 [5, 45); engine: the rest
    assert by == {"search": 10 + 5 + 40, "engine": 55 + 5 + 40}
    assert idle_layer_share(ctx, "engine") == pytest.approx(50.0)


def test_two_of_four_cards_busy_read_half_imbalanced():
    tr = _trace([(0, 80, "a", 0), (10, 90, "a", 1)], [0, 1, 2, 3])
    assert tr.busy_s_per_card == pytest.approx([80e-9, 80e-9, 0, 0],
                                                rel=1e-12)
    ctx = types.SimpleNamespace(trace=tr)
    assert card_busy_imbalance.read(ctx) == pytest.approx(50.0)
    assert idle_share.read(ctx) == pytest.approx(60.0)
    # the idle cards stand apart; the working cards' gaps keep their labels
    assert tr.idle_gaps() == pytest.approx(
        {"outside/python": 40e-9, "card2/idle": 100e-9,
         "card3/idle": 100e-9}, rel=1e-12)
    assert [n for n, _ in tr.breakdown()["idle_gaps"]][:2] == \
        ["card2/idle", "card3/idle"]


def test_four_chip_mix_is_the_search_mix():
    """A configuration and traffic pair appears once in ``BENCHMARK.json``,
    so the four-card cell's mix is a file of its own: it has to stay the
    one-card search mix, parameter for parameter."""
    spec = {w["name"]: w for w in tiny.bench_json()["workloads"]}
    one, four = spec["resnet18.search"], spec["resnet18.search.4chip"]
    assert (one["chips"], four["chips"]) == (1, 4)
    assert one["config"] == four["config"]
    mixes = [json.loads((harness.BENCH / "traffic" /
                         f"{w['traffic']}.json").read_text())
             for w in (one, four)]
    for mix in mixes:
        del mix["why"]
    assert mixes[0] == mixes[1]


def _merged(kernels, cpu, spans, window, prog_spans):
    """The readings of a reader that merged every card's intervals into
    one busy set: busy seconds, idle share, idle gaps, idle ns by layer."""
    lo, hi = window
    kern = sorted((max(a, lo), min(b, hi), n) for a, b, n, _ in kernels
                  if b > lo and a < hi)
    busy = []
    for a, b, _ in kern:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    window_s = (hi - lo) * 1e-9
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    host = _trace(kernels, [0], cpu, spans, window)     # its labels only
    gaps = collections.defaultdict(float)
    for a, b in idle:
        gaps[host._host_at((a + b) // 2)] += (b - a) * 1e-9
    pieces = innermost(prog_spans, lo, hi)
    by = collections.defaultdict(int)
    i = j = 0
    while i < len(pieces) and j < len(idle):
        a, b = max(pieces[i][0], idle[j][0]), min(pieces[i][1], idle[j][1])
        if b > a:
            by[layer_of(pieces[i][2])] += b - a
        if pieces[i][1] < idle[j][1]:
            i += 1
        else:
            j += 1
    return {"busy_s": busy_s,
            "idle_share": 100.0 * (1.0 - busy_s / window_s),
            "gaps": dict(gaps), "by": dict(by),
            "layer_share": {k: 100.0 * v / (hi - lo) for k, v in by.items()}}


def test_one_card_reads_as_the_merged_reader(monkeypatch):
    rng = np.random.default_rng(5)
    window = (1_000, 2_000_000)
    starts = np.sort(rng.integers(0, 2_001_000, 400))
    kernels = [(int(a), int(a + rng.integers(1, 9_000)), f"k{int(a) % 7}",
                0) for a in starts]
    cpu = [(int(a) - 500, int(a) + 300, "aten::mm") for a in starts[::3]]
    spans = [(lo, lo + 40_000, "bench:step")
             for lo in range(0, 2_000_000, 50_000)]
    prog = [Span("search.generation", lo, lo + 30_000, -1, k)
            for k, lo in enumerate(range(0, 2_000_000, 45_000))]
    want = _merged(kernels, cpu, spans, window, prog)
    tr = _trace(kernels, [0], cpu, spans, window)
    ctx = types.SimpleNamespace(trace=tr)
    monkeypatch.setattr("bench.program_spans.program_spans",
                        lambda c: prog)
    assert tr.busy_s == want["busy_s"]
    assert tr.busy_s_per_card == [want["busy_s"]]
    assert idle_share.read(ctx) == want["idle_share"]
    assert dict(tr.idle_gaps()) == want["gaps"]
    assert idle_ns_by_layer(ctx) == want["by"]
    for layer, share in want["layer_share"].items():
        assert idle_layer_share(ctx, layer) == share
    assert card_busy_imbalance.read(ctx) == 0.0
