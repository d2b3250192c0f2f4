"""The numpy side of the port's loop against the reference, with
IDENTICAL outputs for identical inputs and seeds: NSGA-II (fronts,
history, generator form), the cost model and layer graphs, the
partitioners' plans without ΔAcc, the population engine's chunk plan,
dedup and cache, and the synthetic data."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import costmodel as jcost  # noqa: E402
from repro.core import eval_engine as jeng  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core.fault import layer_seed as j_layer_seed  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import eval_engine as teng  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core.fault import layer_seed as t_layer_seed  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

# the packages re-export the function ``nsga2``, which shadows the module
jnsga = importlib.import_module("repro.core.nsga2")
tnsga = importlib.import_module("repro_torch.core.nsga2")


def _stub_eval(P):
    """A deterministic 3-objective stand-in for ΔAcc-in-the-loop."""
    P = np.asarray(P, np.float64)
    w = np.linspace(1.0, 2.0, P.shape[1])
    return np.stack([(P * w).sum(1), ((1 - P) * w[::-1]).sum(1),
                     np.sin(P @ w) ** 2], axis=1)


def _stub_violation(P):
    return np.maximum(0.0, np.asarray(P).sum(1) - 0.7 * P.shape[1])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("constrained", [False, True])
def test_nsga2_fronts_identical(seed, constrained):
    kw = dict(n_genes=10, n_devices=3,
              violation_fn=_stub_violation if constrained else None)
    want = jnsga.nsga2(_stub_eval, config=jnsga.NSGA2Config(
        population=20, generations=6, seed=seed), **kw)
    got = tnsga.nsga2(_stub_eval, config=tnsga.NSGA2Config(
        population=20, generations=6, seed=seed), **kw)
    np.testing.assert_array_equal(got.pareto_pop, want.pareto_pop)
    np.testing.assert_array_equal(got.pareto_objs, want.pareto_objs)
    np.testing.assert_array_equal(np.array(got.history),
                                  np.array(want.history))
    assert got.evaluations == want.evaluations
    steps = list(tnsga.nsga2_steps(_stub_eval, config=tnsga.NSGA2Config(
        population=20, generations=6, seed=seed), **kw))
    assert len(steps) == 6
    np.testing.assert_array_equal(steps[-1][2], want_last_objs(seed, kw))


def want_last_objs(seed, kw):
    gen = jnsga.nsga2_steps(_stub_eval, config=jnsga.NSGA2Config(
        population=20, generations=6, seed=seed), **kw)
    return list(gen)[-1][2]


def test_crowding_and_sort_identical():
    rng = np.random.default_rng(0)
    F = rng.integers(0, 5, size=(40, 3)).astype(np.float64)
    ranks = jnsga.fast_non_dominated_sort(F)
    np.testing.assert_array_equal(tnsga.fast_non_dominated_sort(F), ranks)
    np.testing.assert_array_equal(tnsga.crowding_distance(F, ranks),
                                  jnsga.crowding_distance(F, ranks))


@pytest.mark.parametrize("name", ["alexnet", "squeezenet", "resnet18"])
def test_layer_graph_and_cost_model_identical(name):
    rng = np.random.default_rng(1)
    want_layers = jcnn.CNN_MODELS[name].layer_infos(16, 1.0, 32)
    got_layers = tcnn.CNN_MODELS[name].layer_infos(16, 1.0, 32)
    assert [vars(a) for a in got_layers] == [vars(b) for b in want_layers]
    for devs, links in ((jcost.PAPER_DEVICES, False),
                        (jcost.POD_TIERS_4, True)):
        tdevs = tuple(getattr(tcost, {v: k for k, v in vars(jcost).items()
                                      if isinstance(v, jcost.DeviceProfile)}
                              [d]) for d in devs)
        assert [vars(a) for a in tdevs] == [vars(b) for b in devs]
        jm = jcost.CostModel(want_layers, devs, include_link_costs=links)
        tm = tcost.CostModel(got_layers, tdevs, include_link_costs=links)
        P = rng.integers(0, len(devs), size=(12, len(want_layers)))
        for fn in ("latency", "energy_of", "violation",
                   "sensitivity_surrogate", "fault_exposure"):
            np.testing.assert_array_equal(getattr(tm, fn)(P),
                                          getattr(jm, fn)(P))


def test_baseline_plans_and_stages_identical():
    layers_j = jcnn.ResNet18.layer_infos(16, 1.0, 32)
    layers_t = tcnn.ResNet18.layer_infos(16, 1.0, 32)
    cfg = dict(population=16, generations=4, seed=2)
    for jcls, tcls in ((jpart.FaultUnawareBaseline, tpart.FaultUnawareBaseline),
                       (jpart.CNNPartedLike, tpart.CNNPartedLike)):
        want = jcls(layers_j, jcost.PAPER_DEVICES,
                    nsga2_config=jnsga.NSGA2Config(**cfg)).optimize()
        got = tcls(layers_t, tcost.PAPER_DEVICES,
                   nsga2_config=tnsga.NSGA2Config(**cfg)).optimize()
        np.testing.assert_array_equal(got.partition, want.partition)
        np.testing.assert_array_equal(got.front_objs, want.front_objs)
        for n in (2, 3, 4):
            assert got.stage_boundaries(n) == want.stage_boundaries(n)
    rng = np.random.default_rng(3)
    for _ in range(20):
        p = rng.integers(0, 3, size=10)
        for n in (2, 3):
            assert tpart.contiguous_stages(p, n) == \
                jpart.contiguous_stages(p, n)


def test_engine_chunk_plan_dedup_and_cache_identical():
    for n in (0, 1, 5, 16, 33):
        for ebs in (None, 1, 4, 7):
            assert teng.chunked_rows(n, ebs) == jeng.chunked_rows(n, ebs)
    for n in range(1, 20):
        assert teng.bucket_size(n) == jeng.bucket_size(n)
    rows = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(teng.pad_rows(rows, 8),
                                  jeng.pad_rows(rows, 8))
    for v in (None, "auto", 3, "5"):
        assert teng.parse_eval_batch_size(v) == jeng.parse_eval_batch_size(v)

    def batch_fn(rows, **_):
        return np.asarray(rows, np.float64) @ np.array([1.0, 10.0, 100.0])

    rng = np.random.default_rng(4)
    want = jeng.PopulationEvalEngine(batch_fn, eval_batch_size=3)
    got = teng.PopulationEvalEngine(batch_fn, eval_batch_size=3)
    for _ in range(3):
        P = rng.integers(0, 3, size=(10, 3))
        np.testing.assert_array_equal(got.evaluate(P), want.evaluate(P))
        assert (got.dispatches, got.rows_evaluated) == \
            (want.dispatches, want.rows_evaluated)


def test_synthetic_data_and_seeds_identical():
    jd, td = jdata.ImageClassData(seed=5), tdata.ImageClassData(seed=5)
    for a, b in zip(jd.batch(16, seed=9), td.batch(16, seed=9)):
        np.testing.assert_array_equal(a, b)
    js = jdata.TokenStream(vocab=50, seq_len=12, batch=3, seed=2)
    ts = tdata.TokenStream(vocab=50, seq_len=12, batch=3, seed=2)
    for _ in range(2):
        a, b = next(js), next(ts)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for args in ((0, 0, 0), (7, 3, 1), (2 ** 20, 11, 0)):
        assert t_layer_seed(*args) == int(j_layer_seed(*args))
