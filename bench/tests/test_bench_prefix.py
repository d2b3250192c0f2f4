"""The needed unit runs: distinct prefix nodes (unit, genes up to it)
first seen under an environment, counted by hand on small populations."""
import numpy as np

from bench import harness


def _call(env, phase, rows):
    return {"env": env, "phase": phase, "rows": np.array(rows)}


def test_distinct_prefixes_of_one_population():
    rows = [[0, 0, 0], [0, 0, 1], [0, 1, 1], [1, 1, 1], [0, 0, 0]]
    out = harness._needed([_call(0, "window", rows)], 3)
    runs, first = out["window"]
    # unit 0: prefixes 0, 1; unit 1: 00, 01, 11; unit 2: 000, 001, 011, 111
    assert runs.tolist() == [2, 3, 4]
    assert first.tolist() == [1, 1, 1]


def test_prefixes_are_kept_within_an_environment_only():
    a = _call(0, "window", [[0, 0], [0, 1]])
    b = _call(0, "window", [[0, 1], [1, 1]])      # 01 seen, 1 and 11 new
    c = _call(1, "window", [[0, 1]])              # a new environment
    runs, first = harness._needed([a, b, c], 2)["window"]
    # unit 0: 0 | 1 | 0 again under env 1; unit 1: 00, 01 | 11 | 01
    assert runs.tolist() == [1 + 1 + 1, 2 + 1 + 1]
    assert first.tolist() == [2, 2]


def test_phases_are_counted_apart():
    out = harness._needed([_call(0, "warmup", [[0, 0]]),
                           _call(0, "window", [[0, 0], [1, 0]]),
                           _call(0, "trace", [[1, 1]])], 2)
    assert out["warmup"][0].tolist() == [1, 1]
    assert out["window"][0].tolist() == [1, 1]
    assert out["trace"][0].tolist() == [0, 1]


def test_work_totals():
    work = [{"flops": 10.0, "conv_flops": 4.0, "fm_flops": 0.0,
             "fm_bytes": 0.0, "act_bytes": 2.0, "act_draws": 100,
             "fm_draws": 0}] * 2
    tot = harness.work_totals(work, (np.array([3, 1]), np.array([1, 1])))
    assert tot["flops"] == 40.0 and tot["conv_flops"] == 16.0
    assert tot["act_bytes"] == 8.0 and tot["act_draws"] == 200.0
    assert tot["unit_runs"] == 4
