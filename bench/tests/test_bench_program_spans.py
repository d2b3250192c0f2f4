"""The metrics that read the program's own spans and row-cache counters
(``program_spans.py``), on the CPU rehearsal of the search cells, and the
span arithmetic on spans made by hand."""
import time
import types

import pytest
import torch

from bench import harness
from bench.program_spans import idle_ns_by_layer, innermost, layer_of
from bench.tests import tiny
from repro_torch.trace import Span

torch.set_num_threads(2)

NEW = ("search_self_ms", "idle_search_share", "idle_engine_share",
       "idle_forward_share", "idle_kernels_share", "row_cache_share")
SHARES = NEW[1:5]


@pytest.mark.parametrize("cell,kind", [("resnet18.search", "cnn"),
                                       ("olmo-1b.search", "lm")])
def test_search_cells_report_the_program_metrics(cell, kind):
    config = cell.split(".")[0]
    res, _ = harness.run_cell(
        tiny.bench_json(), cell, 2 ** 31 + 11, 0.5, True,
        torch.device("cpu"), time.perf_counter(), conf=tiny.conf(config),
        traffic=tiny.traffic("search"), log=lambda *a: None)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW:
        assert f"{name}.{kind}" in m, name
    shares = [m[f"{name}.{kind}"] for name in SHARES]
    assert all(s >= 0 for s in shares)
    assert sum(shares) <= m[f"idle_share.{kind}"] + 0.2
    assert m[f"search_self_ms.{kind}"] > 0
    assert 0 <= m[f"row_cache_share.{kind}"] <= 100


def _span(i, name, t0, t1, parent=-1):
    return Span(name, t0, t1, parent, i)


def test_innermost_span_labels_each_instant():
    spans = [_span(0, "search.generation", 10, 100),
             _span(1, "engine.delta_acc", 20, 80, 0),
             _span(2, "kernel.bitflip", 30, 40, 1),
             _span(3, "forward.unit", 50, 90, 1)]   # cut at its parent's end
    assert innermost(spans, 0, 120) == [
        (0, 10, None), (10, 20, "search.generation"),
        (20, 30, "engine.delta_acc"), (30, 40, "kernel.bitflip"),
        (40, 50, "engine.delta_acc"), (50, 80, "forward.unit"),
        (80, 100, "search.generation"), (100, 120, None)]
    assert innermost(spans, 35, 60) == [
        (35, 40, "kernel.bitflip"), (40, 50, "engine.delta_acc"),
        (50, 60, "forward.unit")]
    assert [layer_of(n) for n in (None, "kernel.bitflip", "train.adamw",
                                  "search.objective")] == \
        ["none", "kernels", "train", "search"]


def test_idle_time_is_split_exactly_by_layer(monkeypatch):
    spans = [_span(0, "search.generation", 10, 100),
             _span(1, "engine.dispatch", 20, 80, 0),
             _span(2, "kernel.fault_matmul", 30, 40, 1)]
    tr = types.SimpleNamespace(window_ns=(0, 120),
                               busy_by_card=[[[5, 25], [35, 70]]])
    ctx = types.SimpleNamespace(trace=tr)
    monkeypatch.setattr("bench.program_spans.program_spans",
                        lambda c: spans)
    by = idle_ns_by_layer(ctx)
    # idle: [0, 5) [25, 35) [70, 120)
    assert by == {"none": 5 + 20, "search": 20, "engine": 5 + 10,
                  "kernels": 5}
    assert sum(by.values()) == 120 - 20 - 35
