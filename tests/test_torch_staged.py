"""The port's staged, chain-fused ΔAcc engine and the evaluator modules
around it, against the reference, at small size (width 0.25, img 16, 8
images, torch on one thread).

  * Engine bookkeeping: synthetic unit functions with exact small-integer
    float values through ``repro.core.eval_engine.PrefixEvalEngine`` and
    the port's; results, ``_plan_segments`` and every ``stats()`` counter
    IDENTICAL, fused and unfused, under a store cap that evicts.
  * Within the port: staged (fused and unfused) and full BITWISE equal on
    the three CNNs under generic, tables and kernel; eviction recomputes
    bitwise.
  * Against the reference: staged ΔAcc, ``profile_layer_sensitivity``
    within 1/n_eval per row (an fp32 sum taken in another order can move
    one image across an 8-bit rounding boundary, see
    test_torch_objectives.py); the surrogate's calibration, the auto chunk
    helper and the fault-unaware plan identical; one training step within
    1e-6 absolute of the updated weights (both sides fp32; the gradients
    differ in the last bits, and the step scales them by lr = 2e-3).
"""
import gc
import importlib.util
import pathlib
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import costmodel as jcost  # noqa: E402
from repro.core import eval_engine as jeng  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.nsga2 import NSGA2Config as JNSGA2Config  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import cnn_setup, convert, quickstart  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.core import (PAPER_DEVICES, AFarePart, CostModel,  # noqa: E402
                              FaultSpec, InferenceAccuracyEvaluator,
                              NSGA2Config, ObjectiveFn,
                              SurrogateAccuracyEvaluator,
                              profile_layer_sensitivity)
from repro_torch.core import eval_engine as teng  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
RATES = dict(weight_fault_rate=0.3, act_fault_rate=0.05, faulty_bits=4, bits=8)
SEEDS = {"alexnet": 3, "squeezenet": 0, "resnet18": 6}   # probes that spread
N_EVAL = 8
BACKENDS = ("generic", "tables", "kernel")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# engine bookkeeping on synthetic units
# --------------------------------------------------------------------------
L, K = 8, 4          # units, activation width
CUT = 2              # shared-field keying depth of the dict variant


def _unit_fns(lib, shared):
    """Exact small-integer float units; ``lib`` is jnp or torch.  With
    ``shared`` the activations from depth CUT+1 on are dicts whose "mem"
    field equals the activation stored at depth CUT."""
    if lib is torch:
        f32, arange = (lambda d: d.to(torch.float32)), torch.arange
    else:
        f32, arange = (lambda d: d.astype(jnp.float32)), jnp.arange

    def depth0(acts, devs):
        return f32(devs)[:, None] + arange(K, dtype=lib.float32)

    def mid(i):
        def fn(acts, devs):
            d = f32(devs)[:, None]
            if not shared or i <= CUT:
                return acts * (i + 2) + d
            if i == CUT + 1:
                return {"h": acts * (i + 2) + d, "mem": acts}
            return {"h": acts["h"] * (i + 2) + d + acts["mem"],
                    "mem": acts["mem"]}
        return fn

    def last(acts, devs):
        h = acts["h"] if shared else acts
        return (h * (L + 1) + f32(devs)[:, None]).sum(1)

    return [depth0] + [mid(i) for i in range(1, L - 1)] + [last]


def _segment_fn(fns):
    def segment_fn(start, length):
        def run(acts, genes):
            for k in range(length):
                acts = fns[start + k](acts, genes[:, k])
            return acts
        return run
    return segment_fn


def _generations(rng, n_gens=4, pop=8, d=3):
    P = rng.integers(0, d, size=(pop, L))
    out = [P]
    for _ in range(n_gens - 1):
        P = P.copy()
        P[rng.random(P.shape) < 0.2] = rng.integers(0, d)
        out.append(np.concatenate([P, rng.integers(0, d, size=(2, L))]))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("budget", [None, 200])
def test_engine_bookkeeping_matches_reference(fused, shared, budget):
    shared_fields = {"mem": CUT} if shared else None
    engines = []
    for lib, mod in ((jnp, jeng), (torch, teng)):
        fns = _unit_fns(lib, shared)
        engines.append(mod.PrefixEvalEngine(
            fns, L, eval_batch_size=3, max_store_bytes=budget,
            shared_fields=shared_fields,
            segment_fn=_segment_fn(fns) if fused else None))
    ref, port = engines
    rng = np.random.default_rng(5)
    for P in _generations(rng):
        np.testing.assert_array_equal(port.evaluate(P), ref.evaluate(P))
        assert port.stats() == ref.stats()
    rows = [tuple(int(g) for g in r) for r in rng.integers(0, 3, (6, L))]
    assert port._plan_segments(rows) == ref._plan_segments(rows)
    assert port.stats() == ref.stats()
    if budget is not None:
        assert ref.stats()["evictions"] > 0


def test_auto_eval_batch_size_matches_reference():
    probes = [lambda n: 1000 + 100 * n, lambda n: 0, lambda n: 5000,
              lambda n: 3 * n * n + 7]
    for probe in probes:
        for budget in (0, 1000, 1000 + 100 * 63, 1000 + 100 * 64, 10 ** 12):
            for reserved in (0, 3200):
                for max_rows in (1, 256, 1024):
                    kw = dict(budget=budget, reserved=reserved,
                              max_rows=max_rows)
                    assert teng.auto_eval_batch_size(probe, **kw) == \
                        jeng.auto_eval_batch_size(probe, **kw)


# --------------------------------------------------------------------------
# the CNNs: within the port and against the reference
# --------------------------------------------------------------------------
def reference_shaped_params(jm, seed, num_classes=8, width=0.25, img=16):
    """numpy params in the reference's tree (see test_torch_cnn.py)."""
    shapes = jax.eval_shape(
        lambda k: jm.init(k, num_classes=num_classes, width=width, img=img),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) == 1:
            return (0.01 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                ).astype(np.float32)
    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N_EVAL, 16, 16, 3)).astype(np.float32)
    out = {}
    for name, seed in SEEDS.items():
        tm = tcnn.CNN_MODELS[name]
        params = reference_shaped_params(jcnn.CNN_MODELS[name], seed)
        tp = convert.params_from_jax(params, device="cpu")
        z = torch.zeros(tm.n_units)
        labels = tm.apply(tp, torch.from_numpy(x), z, z, 0).argmax(-1).numpy()
        assert len(np.unique(labels)) >= 2, f"{name}: probe collapsed"
        out[name] = (params, tp, x, labels)
    return out


def _port(name, tp, x, labels, backend, **kw):
    tm = tcnn.CNN_MODELS[name]
    extra = {}
    if backend == "kernel":
        extra["quant_params"] = tcnn.quantize_unit_params(tp)
    elif backend == "tables":
        extra["weight_tables"] = tcnn.build_weight_fault_tables(
            tp, RATES["weight_fault_rate"] * SCALE, base_seed=3)
    kw.setdefault("eval_batch_size", 3)
    return InferenceAccuracyEvaluator(
        tm.apply, tp, x, labels, FaultSpec(**RATES), SCALE, base_seed=3,
        fault_backend=backend, step_fn=tm.step, device="cpu", **extra, **kw)


def _populations(n_units, seed=11, pop=4):
    rng = np.random.default_rng(seed)
    P = rng.integers(0, len(SCALE), size=(pop, n_units))
    Q = P.copy()
    Q[rng.random(Q.shape) < 0.2] = rng.integers(0, len(SCALE))
    return [P, np.concatenate([Q, P[:2]])]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(SEEDS))
def test_staged_matches_full_bitwise(models, name, backend):
    _, tp, x, labels = models[name]
    pops = _populations(tcnn.CNN_MODELS[name].n_units)
    res = {}
    for key in (("full", True), ("staged", False), ("staged", True)):
        ev = _port(name, tp, x, labels, backend, eval_strategy=key[0],
                   fuse_chains=key[1])
        assert ev.eval_strategy == key[0] and ev.fuse_chains == key[1]
        res[key] = np.concatenate([ev.delta_acc(P) for P in pops])
        if key[0] == "staged":
            st = ev.staged_stats()
            assert st["unit_runs_avoided"] > 0
            assert (st["fused_segments"] > 0) == key[1]
    assert res[("full", True)].max() > 0, f"{name}: no corruption seen"
    for key, v in res.items():
        np.testing.assert_array_equal(v, res[("full", True)], err_msg=str(key))


@pytest.mark.parametrize("name", ["resnet18"])
def test_staged_matches_reference_staged(models, name):
    """Port staged (fused, kernel backend) against the reference's staged
    engine on the same converted params (generic backend, unfused, one row
    a chunk: the fewest executables to compile)."""
    params, tp, x, labels = models[name]
    jm = jcnn.CNN_MODELS[name]
    ref = jobj.InferenceAccuracyEvaluator(
        jm.apply, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(labels), JFaultSpec(**RATES), SCALE, base_seed=3,
        step_fn=jm.step, eval_strategy="staged", devices=1,
        eval_batch_size=1, fuse_chains=False)
    port = _port(name, tp, x, labels, "kernel")
    for P in _populations(jm.n_units):
        want, got = ref.delta_acc(P), port.delta_acc(P)
        assert np.abs(got - want).max() <= 1.0 / N_EVAL, (got, want)
    assert want.max() > 0
    assert port.clean_accuracy() == ref.clean_accuracy() == 1.0


def test_eviction_recomputes_bitwise(models):
    _, tp, x, labels = models["alexnet"]
    pops = _populations(tcnn.AlexNet.n_units, seed=3, pop=6)
    free = _port("alexnet", tp, x, labels, "kernel", max_store_bytes=None)
    tight = _port("alexnet", tp, x, labels, "kernel", max_store_bytes=1)
    for P in pops:
        np.testing.assert_array_equal(tight.delta_acc(P), free.delta_acc(P))
    assert tight.staged_stats()["recomputes"] > 0
    assert tight.staged_stats()["evictions"] > 0
    assert free.staged_stats()["recomputes"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_fault_scale_change_rebuilds_only_off_kernel(models, backend):
    _, tp, x, labels = models["alexnet"]
    P = _populations(tcnn.AlexNet.n_units)[0]
    ev = _port("alexnet", tp, x, labels, backend)
    ev.delta_acc(P)
    assert ev.staged_stats()["store_entries"] > 0
    ev.device_fault_scale = SCALE * 0.5
    assert ev.staged_stats()["store_entries"] == 0 and not ev._cache
    after = ev.delta_acc(P)
    if backend == "kernel":
        assert ev._fault_env_rebuilds == 0 and ev.fault_backend == "kernel"
        assert ev._built_unit_fns is not None
    else:
        assert ev._fault_env_rebuilds == 1 and ev.fault_backend == "generic"
    fresh = _port("alexnet", tp, x, labels, "generic")
    fresh.device_fault_scale = SCALE * 0.5
    np.testing.assert_array_equal(after, fresh.delta_acc(P))


def test_auto_chunk_is_none_on_cpu_and_threads(models):
    _, tp, x, labels = models["alexnet"]
    ev = _port("alexnet", tp, x, labels, "kernel", eval_batch_size="auto")
    assert ev.eval_batch_size is None and ev._ebs_auto
    assert ev._prefix_engine.eval_batch_size is None
    ev.eval_batch_size = 2
    assert ev._prefix_engine.eval_batch_size == 2
    with pytest.warns(DeprecationWarning):
        assert ev.clean_accuracy(tcnn.AlexNet.n_units) == 1.0
    with pytest.raises(ValueError, match="n_units"), \
            pytest.warns(DeprecationWarning):
        ev.clean_accuracy(3)


def test_segment_cache_entry_dies_with_evaluator(models):
    _, tp, x, labels = models["alexnet"]
    for backend in ("generic", "kernel"):   # rates held / read via weakref
        ev = _port("alexnet", tp, x, labels, backend)
        ev.delta_acc(_populations(tcnn.AlexNet.n_units)[0])
        assert len(tobj._SEGMENT_CACHE[ev]) > 0
        gc.collect()
        n = len(tobj._SEGMENT_CACHE)
        alive = weakref.ref(ev)
        del ev
        gc.collect()
        assert alive() is None and len(tobj._SEGMENT_CACHE) == n - 1


def test_strategy_and_fusion_thread_through_objective_and_afarepart(models):
    _, tp, x, labels = models["alexnet"]
    ev = _port("alexnet", tp, x, labels, "generic", eval_strategy="full")
    layers = tcnn.AlexNet.layer_infos(num_classes=8, width=0.25, img=16)
    cm = CostModel(layers, PAPER_DEVICES)
    ObjectiveFn(cm, ev, eval_strategy="staged", fuse_chains=False)
    assert ev.eval_strategy == "staged" and ev._prefix_engine.segment_fn is None
    ObjectiveFn(cm, ev, fuse_chains=True, eval_batch_size=5)
    assert ev._prefix_engine.segment_fn is not None
    assert ev._prefix_engine.eval_batch_size == 5
    scale = np.array([d.fault_scale for d in PAPER_DEVICES])
    ev.device_fault_scale = scale
    cfg = NSGA2Config(population=6, generations=1)
    staged = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                       nsga2_config=cfg, fuse_chains=False).optimize()
    assert ev.fuse_chains is False and ev._prefix_engine.dispatches > 0
    other = _port("alexnet", tp, x, labels, "generic")
    other.device_fault_scale = scale
    full = AFarePart(layers, PAPER_DEVICES, acc_evaluator=other,
                     nsga2_config=cfg, eval_strategy="full").optimize()
    assert other.eval_strategy == "full"
    np.testing.assert_array_equal(staged.front_objs, full.front_objs)


def test_profile_layer_sensitivity_matches_reference(models):
    params, tp, x, labels = models["alexnet"]
    jm, tm = jcnn.AlexNet, tcnn.AlexNet
    spec = dict(weight_fault_rate=0.3, act_fault_rate=0.1, faulty_bits=4)
    want = jobj.profile_layer_sensitivity(
        jm.apply, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(labels), jm.n_units, JFaultSpec(**spec), base_seed=2)
    for ebs in (None, 4):
        got = profile_layer_sensitivity(
            tm.apply, tp, x, labels, tm.n_units, FaultSpec(**spec),
            base_seed=2, eval_batch_size=ebs, device="cpu")
        assert got.shape == want.shape and want.max() > 0
        assert np.abs(got - want).max() <= 1.0 / N_EVAL, (got, want)


def test_surrogate_calibration_matches_reference():
    layers = tcnn.ResNet18.layer_infos(num_classes=8, width=0.25, img=16)
    jlayers = jcnn.ResNet18.layer_infos(num_classes=8, width=0.25, img=16)

    def true_fn(P):
        return np.sin(np.asarray(P, np.float64) @ np.arange(1, 11)) ** 2

    port = SurrogateAccuracyEvaluator(CostModel(layers, PAPER_DEVICES))
    ref = jobj.SurrogateAccuracyEvaluator(
        jcost.CostModel(jlayers, jcost.PAPER_DEVICES))
    assert port.calibrate(true_fn, 12, seed=4) == \
        ref.calibrate(true_fn, 12, seed=4) != 1.0
    P = np.random.default_rng(0).integers(0, 2, size=(5, 10))
    np.testing.assert_array_equal(port.delta_acc(P), ref.delta_acc(P))


def test_tf32_guard_restores_the_callers_flags(models, monkeypatch):
    """Every ΔAcc and accuracy path runs with TF32 off and without bf16 or
    fp16 reduced-precision reductions in matmuls, whatever the caller's
    globals say, and puts the caller's values back."""
    seen = []
    mm = torch.backends.cuda.matmul
    reduced = ("allow_bf16_reduced_precision_reduction",
               "allow_fp16_reduced_precision_reduction")

    def record():
        seen.append((torch.backends.cudnn.allow_tf32, mm.allow_tf32,
                     *(getattr(mm, f) for f in reduced)))

    def apply_fn(params, x, wr, ar, seed):
        record()
        return torch.zeros(wr.shape[0], x.shape[0], 3)

    def step_fn(i, p, x, wr, ar, seed):
        record()
        return torch.zeros(wr.shape[0], N_EVAL, 3 if i == 1 else 2)

    step = tcnn.AlexNet.step

    def recording_step(*args, **kw):
        record()
        return step(*args, **kw)

    _, _, x, labels = models["alexnet"]
    params = tcnn.AlexNet.init(0, 16, width=0.125, img=32, device="cpu")
    monkeypatch.setattr(tcnn.AlexNet, "step", staticmethod(recording_step))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for flag in reduced:
        monkeypatch.setattr(mm, flag, True)
    for strategy in ("full", "staged"):
        ev = InferenceAccuracyEvaluator(
            apply_fn, [{}, {}], x, labels, FaultSpec(), [0.0, 1.0],
            step_fn=step_fn, eval_strategy=strategy, device="cpu")
        ev.delta_acc(np.array([[0, 1], [1, 1]]))
    profile_layer_sensitivity(apply_fn, None, x, labels, 2, FaultSpec(),
                              device="cpu")
    cnn_setup.clean_accuracy("alexnet", params, 2, device="cpu")
    cnn_setup.accuracy_under_partition("alexnet", params, np.zeros(8, int),
                                       0.1, 0.1, n_eval=2, device="cpu")
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert all(getattr(mm, f) is True for f in reduced)
    assert len(seen) > 20 and set(seen) == {(False,) * 4}


# --------------------------------------------------------------------------
# training and the quickstart
# --------------------------------------------------------------------------
def _reference_cnn_setup():
    spec = importlib.util.spec_from_file_location(
        "reference_cnn_setup", ROOT / "benchmarks" / "_cnn_setup.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_step_matches_reference(monkeypatch):
    ref = _reference_cnn_setup()
    monkeypatch.setattr(ref, "WIDTH", 0.125)
    key = jax.random.PRNGKey(1)
    init = jcnn.AlexNet.init(key, num_classes=16, width=0.125, img=32)
    want = ref._train(jcnn.AlexNet, key, steps=1, batch=8)
    got = cnn_setup.train("alexnet", convert.params_from_jax(
        jax.tree.map(np.asarray, init), device="cpu"), steps=1, batch=8)
    moved = 0.0
    for w, g, p0 in zip(jax.tree.leaves(want), tree_leaves(got),
                        jax.tree.leaves(init)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
        moved = max(moved, float(np.abs(np.asarray(w) - p0).max()))
    assert moved > 1e-4          # the step changed the weights


def test_quickstart_runs_and_its_baseline_matches_reference(monkeypatch,
                                                            tmp_path, capsys):
    monkeypatch.setattr(cnn_setup, "WIDTH", 0.125)
    monkeypatch.setattr(cnn_setup, "CACHE_DIR", tmp_path)
    out = quickstart.main(["--steps", "1", "--generations", "1",
                           "--n-eval", "16", "--device", "cpu"])
    assert "deployed P*" in capsys.readouterr().out
    assert len(list(tmp_path.glob("resnet18_*.npz"))) == 1
    plan, objs = out["plan"], out["plan"].front_objs
    assert np.isfinite(objs).all() and (objs[:, 2] >= 0).all()
    assert out["evaluator"].eval_strategy == "staged"
    assert out["evaluator"].staged_stats()["rows_evaluated"] > 0
    jlayers = jcnn.ResNet18.layer_infos(num_classes=16, width=0.125, img=32)
    want = jpart.FaultUnawareBaseline(
        jlayers, jcost.PAPER_DEVICES,
        nsga2_config=JNSGA2Config(population=24, generations=1,
                                  seed=0)).optimize()
    np.testing.assert_array_equal(out["baseline"].partition, want.partition)
    np.testing.assert_array_equal(out["baseline"].front_objs, want.front_objs)
    assert 0.0 <= min(out["accuracy"].values()) <= 1.0
    assert plan.partition.shape == (tcnn.ResNet18.n_units,)
