"""A whole run on the CPU at the tests' sizes (the look for a card
skipped), sound and with the timed path broken underneath: ``correct``
comes out true, then false for each fault these cells can have; the
four-chip cell runs over four host slots, and the answers of every slot
but the first left out is its exchange's fault."""
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests import tiny

torch.set_num_threads(2)
CELLS = [("resnet18.search", "resnet18", "search"),
         ("olmo-1b.search", "olmo-1b", "search"),
         ("olmo-1b.sweep", "olmo-1b", "sweep"),
         ("resnet18.search.4chip", "resnet18", "search.4chip")]


def _run(cell, cfg, mix, seed=2 ** 31 + 5):
    res, lines = harness.run_cell(
        tiny.bench_json(), cell, seed, 0.5, False, torch.device("cpu"),
        time.perf_counter(), conf=tiny.conf(cfg), traffic=tiny.traffic(mix),
        log=lambda *a: None, pool=[torch.device("cpu")] * 4)
    assert list(res)[-1] == "check" and len(lines) == len(res["check"])
    return res


def _answer_altered(monkeypatch, conf):
    """Every accuracy the staged engine produces one item lower."""
    from repro_torch.core import eval_engine
    inner = eval_engine.PrefixEvalEngine.evaluate
    n = harness.n_items(conf)
    monkeypatch.setattr(eval_engine.PrefixEvalEngine, "evaluate",
                        lambda self, P: np.asarray(inner(self, P)) - 1.0 / n)


def _half_batch(monkeypatch, conf):
    """Accuracy over the first half of the calibration items only."""
    from repro_torch.core import objectives

    def acc(logits, labels):
        hits = (torch.argmax(logits, -1) == labels).to(torch.float32)
        hits = hits.reshape(hits.shape[0], -1)
        return hits[:, :hits.shape[1] // 2].mean(-1)
    monkeypatch.setattr(objectives, "_accuracy", acc)


def _step_unchanged(monkeypatch, conf):
    """The activation fault step hands its input back unchanged."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "quant_bitflip", lambda x, *a, **k: x)


def _exchange_left_out(monkeypatch, conf):
    """The answers computed on every slot but the first never reach the
    host: their buffers read 0."""
    from repro_torch.core import eval_engine
    inner = eval_engine.PrefixEvalEngine._dispatch_group

    def dispatch(self, fn, parents, genes, final, dev_idx=None, **kw):
        outs = inner(self, fn, parents, genes, final, dev_idx=dev_idx, **kw)
        if final and dev_idx not in (None, 0):
            outs = [(torch.zeros_like(out), n) for out, n in outs]
        return outs
    monkeypatch.setattr(eval_engine.PrefixEvalEngine, "_dispatch_group",
                        dispatch)


@pytest.mark.parametrize("cell,cfg,mix", CELLS, ids=[c[0] for c in CELLS])
def test_sound_run_is_correct(cell, cfg, mix):
    res = _run(cell, cfg, mix)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    bench = tiny.bench_json()
    assert set(res["metrics"]) == {
        m["name"] for m in bench["end_to_end"]
        if cell in m.get("workloads", [cell])}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert all(v["value"] <= v["limit"] for v in res["check"].values())


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch,
                                   _step_unchanged],
                         ids=["answer_altered", "half_batch",
                              "step_unchanged"])
@pytest.mark.parametrize("cell,cfg,mix", CELLS, ids=[c[0] for c in CELLS])
def test_broken_run_is_not_correct(monkeypatch, cell, cfg, mix, fault):
    fault(monkeypatch, tiny.conf(cfg))
    res = _run(cell, cfg, mix)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


def test_exchange_left_out_is_not_correct(monkeypatch):
    cell, cfg, mix = CELLS[-1]
    _exchange_left_out(monkeypatch, tiny.conf(cfg))
    res = _run(cell, cfg, mix)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())
