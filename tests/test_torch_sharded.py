"""The port's multi-device evaluation (``core.eval_engine.DeviceScheduler``,
the engines' placement, the evaluator's ``devices`` knob) and the
pipeline's swap bookkeeping (``launch/``) against the reference, on the
CPU.

A pool of slots stands in for the reference's fake host devices: the port
passes ``[cpu] * n`` (a device may repeat in a pool), the reference a
duck-typed scheduler of n slots over its one CPU device, as its own
``tests/test_sharded_eval.py`` does.  Both sides see the same rows and
seeds.  What is held:
  * the grammar, the scheduler's resolution and the per-device budgets
    equal to the reference's;
  * both engines' values bitwise the reference's, with every counter
    (``dispatches``, chunk sizes, ``device_dispatches``, ``_root_device``,
    evictions, recomputes) equal, and every stored activation on its root
    gene's slot;
  * the evaluator's ΔAcc with 4 slots bitwise its ``devices=1``, for the
    CNNs and the LMs, staged and full, under every backend, and within
    the port's stated tolerance of the reference (1/n_eval for the CNNs,
    1/(B·S) for the LMs);
  * ``group_cuts`` and ``swap_migration`` equal to the reference's.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import FaultSpec as JFaultSpec  # noqa: E402
from repro.core import eval_engine as jeng  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.objectives import make_lm_accuracy_evaluator as jmake  # noqa: E402
from repro.launch import pipeline as jpipe  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.testing.lm_harness import lm_calibration_setup as jsetup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultSpec,  # noqa: E402
                              InferenceAccuracyEvaluator, NSGA2Config,
                              ObjectiveFn, PrefixRef,
                              make_lm_accuracy_evaluator)
from repro_torch.core import eval_engine as teng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import pipeline as tpipe  # noqa: E402
from repro_torch.lm_setup import calibration_batch  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubScheduler:
    """The reference's n slots over its one CPU device
    (``tests/test_sharded_eval.py:104-117``)."""

    def __init__(self, n):
        self.devices = [jax.local_devices()[0]] * n

    @property
    def n_devices(self):
        return len(self.devices)

    def device_for(self, i):
        return self.devices[i % len(self.devices)]


# --------------------------------------------------------------------------
# the grammar, the scheduler, the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, "auto", "4", 2, 1, 0, "-1", "x"])
def test_parse_devices_matches_reference(value):
    try:
        want = jeng.parse_devices(value)
    except ValueError:
        with pytest.raises(ValueError):
            teng.parse_devices(value)
        return
    assert teng.parse_devices(value) == want


def test_device_scheduler_resolution():
    # no card here and no pool: the local cards are asked for, and raise
    for devices in ("auto", 1, 2):
        with pytest.raises(RuntimeError, match="pass a pool"):
            teng.DeviceScheduler(devices)
    auto = teng.DeviceScheduler("auto", pool=[CPU])
    assert auto.devices == [CPU] and auto.n_devices == 1
    assert auto.devices == list(auto.mesh.devices.flat)
    assert teng.DeviceScheduler(1, pool=[CPU]).n_devices == 1
    with pytest.raises(ValueError, match="pool holds 1"):
        teng.DeviceScheduler(2, pool=[CPU])
    pool = [CPU] * 4
    assert teng.DeviceScheduler("auto", pool=pool).n_devices == 4
    two = teng.DeviceScheduler(2, pool=pool)
    assert two.devices == [CPU, CPU]
    with pytest.raises(ValueError):
        teng.DeviceScheduler(5, pool=pool)
    listed = teng.DeviceScheduler(["cpu", CPU, "cpu"])
    assert listed.n_devices == 3 and listed.devices == [CPU] * 3
    assert [listed.device_for(i) for i in range(7)] == [CPU] * 7
    # the mesh: (data=n, model=1) in pool order
    assert tmesh.mesh_axes(listed.mesh) == ("data", "model")
    assert listed.mesh.devices.shape == (3, 1)
    assert listed.mesh.shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError):
        tmesh.make_eval_mesh(0, pool)
    with pytest.raises(ValueError):
        teng.parse_devices(0)


def test_round_robin_and_put():
    s = teng.DeviceScheduler(4, pool=[CPU] * 4)
    s.devices = ["a", "b", "c", "d"]             # order only
    assert [s.device_for(i) for i in range(6)] == list("abcdab")
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = teng.DeviceScheduler.put(a, CPU)
    assert t.dtype == torch.int32 and t.device == CPU
    np.testing.assert_array_equal(t.numpy(), a)
    assert teng.DeviceScheduler.put(a, None).device == CPU


# --------------------------------------------------------------------------
# per-device budgets
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_device_memory_budget_matches_reference(monkeypatch, n):
    monkeypatch.delenv("REPRO_EVAL_MEM_BUDGET", raising=False)
    assert teng.device_memory_budget(n_devices=n) == \
        jeng.device_memory_budget(n_devices=n)
    assert teng.device_memory_budget(n_devices=n, device=CPU) == \
        teng.device_memory_budget() // n
    monkeypatch.setenv("REPRO_EVAL_MEM_BUDGET", "123456")
    assert teng.device_memory_budget(n_devices=n) == 123456 == \
        jeng.device_memory_budget(n_devices=n)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("budget", [None, 1000 + 100 * 64, 10 ** 12])
def test_auto_eval_batch_size_per_device(monkeypatch, n, budget):
    probe = lambda rows: 1000 + 100 * rows            # noqa: E731
    monkeypatch.setenv("REPRO_EVAL_MEM_BUDGET", str(1000 + 100 * 64))
    kw = dict(budget=budget, n_devices=n, reserved=0, max_rows=1024)
    assert teng.auto_eval_batch_size(probe, **kw) == \
        jeng.auto_eval_batch_size(probe, **kw)
    monkeypatch.delenv("REPRO_EVAL_MEM_BUDGET")
    kw = dict(n_devices=n, reserved=3200, max_rows=1 << 30)
    assert teng.auto_eval_batch_size(probe, **kw) == \
        jeng.auto_eval_batch_size(probe, **kw)


# --------------------------------------------------------------------------
# the full engine over a pool
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ebs", [None, 3])
@pytest.mark.parametrize("n", [2, 4])
def test_population_engine_over_pool_matches_reference(n, ebs):
    P = np.concatenate([np.arange(14).reshape(7, 2),
                        np.arange(6).reshape(3, 2)])   # 7 unique rows
    calls = {"ref": [], "port": []}

    def ref_fn(rows, device=None):
        calls["ref"].append((len(rows), device is not None))
        return rows.sum(axis=1).astype(np.float64) * 0.5

    def port_fn(rows, device=None):
        calls["port"].append((len(rows), device is not None))
        assert device == CPU
        return torch.from_numpy(rows).sum(1).to(torch.float64) * 0.5

    ref = jeng.PopulationEvalEngine(ref_fn, ebs, scheduler=_StubScheduler(n))
    port = teng.PopulationEvalEngine(
        port_fn, ebs, scheduler=teng.DeviceScheduler([CPU] * n))
    np.testing.assert_array_equal(port.evaluate(P), ref.evaluate(P))
    assert calls["port"] == calls["ref"]
    assert (port.dispatches, port.rows_evaluated) == \
        (ref.dispatches, ref.rows_evaluated)
    if ebs is None and n == 2:                 # ceil(7 / 2) = 4: 4 + 3 rows
        assert [c[0] for c in calls["port"]] == [4, 4]
    # a cached re-evaluation dispatches nothing
    np.testing.assert_array_equal(port.evaluate(P[::-1]),
                                  ref.evaluate(P[::-1]))
    assert port.dispatches == ref.dispatches


def test_population_engine_one_slot_is_the_plain_path():
    seen = []

    def fn(rows, **kw):
        seen.append(kw)
        return torch.from_numpy(rows).sum(1).to(torch.float32)

    eng = teng.PopulationEvalEngine(fn, None,
                                    scheduler=teng.DeviceScheduler([CPU]))
    eng.evaluate(np.arange(10).reshape(5, 2))
    assert seen == [{}] and eng.dispatches == 1


def test_gather_host_keeps_each_chunk():
    vals = [torch.arange(3, dtype=torch.float32), np.array([7.0]),
            torch.tensor([[1.0, 2.0]])]
    out = teng.gather_host(vals)
    np.testing.assert_array_equal(out[0], [0, 1, 2])
    np.testing.assert_array_equal(out[1], [7.0])
    np.testing.assert_array_equal(out[2], [[1.0, 2.0]])


# --------------------------------------------------------------------------
# the prefix engine over a pool: synthetic exact-integer units
# --------------------------------------------------------------------------
L, K = 6, 4          # units, activation width
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


def _engines(n, fused, shared, budget, ebs):
    out = []
    for lib, mod, sched in ((jnp, jeng, _StubScheduler(n)),
                            (torch, teng,
                             teng.DeviceScheduler([CPU] * n))):
        fns = _unit_fns(lib, shared)
        out.append(mod.PrefixEvalEngine(
            fns, L, eval_batch_size=ebs, max_store_bytes=budget,
            scheduler=sched, shared_fields={"mem": CUT} if shared else None,
            segment_fn=_segment_fn(fns) if fused else None))
    return out


def _check_slots(eng):
    """Every stored activation is on its root gene's slot, and so is the
    prefix a shared-carry reference points at."""
    for p, act in eng.store._store.items():
        slot = eng._root_device[p[0]]
        assert eng.store.slot_of(p) == slot == eng._device_index(p)
        if isinstance(act, dict):
            for v in act.values():
                if isinstance(v, PrefixRef):
                    assert eng._root_device[v.prefix[0]] == slot


@pytest.mark.parametrize("ebs", [None, 2])
@pytest.mark.parametrize("budget", [None, 64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_prefix_engine_over_two_slots_matches_reference(fused, shared, budget,
                                                        ebs):
    ref, port = _engines(2, fused, shared, budget, ebs)
    rng = np.random.default_rng(3)
    P = rng.integers(0, 3, size=(8, L))
    gens = [P]
    for _ in range(2):                  # generations sharing prefixes
        P = P.copy()
        P[:, -1] = (P[:, -1] + 1) % 3
        P[rng.random(P.shape) < 0.15] = rng.integers(0, 3)
        gens.append(np.concatenate([P, rng.integers(0, 3, size=(2, L))]))
    for P in gens:
        np.testing.assert_array_equal(port.evaluate(P), ref.evaluate(P))
        assert port.stats() == ref.stats()
        assert port._root_device == ref._root_device
        _check_slots(port)
    st = port.stats()
    assert sum(st["device_dispatches"].values()) == st["dispatches"]
    assert set(st["device_dispatches"]) == {0, 1}
    if budget is not None:
        assert st["evictions"] > 0


def test_prefix_engine_refuses_a_parent_from_another_slot():
    _, port = _engines(2, False, False, None, None)
    P = np.array([[0, 1, 2, 0, 1, 2], [1, 1, 2, 0, 1, 2]])
    port.evaluate(P)
    p = (0, 1, 2)
    assert port.store.slot_of(p) == 0
    with pytest.raises(RuntimeError, match="slot"):
        port._parent_for(p, 1)


def test_reset_placement_forgets_slots_and_store():
    _, port = _engines(2, True, False, None, None)
    port.evaluate(np.random.default_rng(0).integers(0, 3, size=(6, L)))
    assert port._root_device and len(port.store)
    port.reset_placement()
    assert not port._root_device and not port.device_dispatches
    assert not len(port.store)


# --------------------------------------------------------------------------
# the evaluator on the CNNs: 4 slots bitwise 1 slot, within 1/n_eval of
# the reference
# --------------------------------------------------------------------------
SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
RATES = dict(weight_fault_rate=0.3, act_fault_rate=0.05, faulty_bits=4, bits=8)
SEEDS = {"alexnet": 3, "resnet18": 6}     # probes that spread
N_EVAL = 8
POOL4 = [CPU] * 4


def reference_shaped_params(jm, seed, num_classes=8, width=0.25, img=16):
    """numpy params in the reference's tree (test_torch_objectives.py)."""
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


_CNN = {}


def cnn(name):
    """(reference ΔAcc of P, port params, x, labels, P) for one CNN."""
    if name not in _CNN:
        rng = np.random.default_rng(7)
        x = rng.normal(size=(N_EVAL, 16, 16, 3)).astype(np.float32)
        jm, tm = jcnn.CNN_MODELS[name], tcnn.CNN_MODELS[name]
        params = reference_shaped_params(jm, SEEDS[name])
        jp = jax.tree.map(jnp.asarray, params)
        tp = convert.params_from_jax(params, device="cpu")
        z = torch.zeros(jm.n_units)
        labels = tm.apply(tp, torch.from_numpy(x), z, z, 0).argmax(-1).numpy()
        assert len(np.unique(labels)) >= 2, f"{name}: probe collapsed"
        P = rng.integers(0, len(SCALE), size=(10, jm.n_units))
        P[5:, :2] = P[0, :2]                      # shared prefixes
        ref = jobj.InferenceAccuracyEvaluator(
            jm.apply, jp, jnp.asarray(x), jnp.asarray(labels),
            JFaultSpec(**RATES), SCALE, base_seed=3, eval_batch_size=1,
            quant_params=jcnn.quantize_unit_params(jp),
            fault_backend="pallas", step_fn=jm.step, eval_strategy="full",
            devices=1).delta_acc(P)
        assert ref.max() > 0, f"{name}: degenerate probe"
        _CNN[name] = (ref, tp, x, labels, P)
    return _CNN[name]


def cnn_ev(name, backend, strategy, devices, ebs=None):
    tm = tcnn.CNN_MODELS[name]
    _, tp, x, labels, _ = cnn(name)
    extra = {}
    if backend == "kernel":
        extra["quant_params"] = tcnn.quantize_unit_params(tp)
    elif backend == "tables":
        extra["weight_tables"] = tcnn.build_weight_fault_tables(
            tp, RATES["weight_fault_rate"] * SCALE, base_seed=3)
    return InferenceAccuracyEvaluator(
        tm.apply, tp, x, labels, FaultSpec(**RATES), SCALE, base_seed=3,
        eval_batch_size=ebs, fault_backend=backend, step_fn=tm.step,
        eval_strategy=strategy, devices=devices, device="cpu", **extra)


@pytest.mark.parametrize("strategy", ["full", "staged"])
@pytest.mark.parametrize("backend", ["generic", "tables", "kernel"])
@pytest.mark.parametrize("name", list(SEEDS))
def test_cnn_four_slots_bitwise_one_slot(name, backend, strategy):
    want, *_, P = cnn(name)
    one = cnn_ev(name, backend, strategy, 1)
    four = cnn_ev(name, backend, strategy, POOL4)
    assert one.devices == 1 and four.devices == 4
    got1, got4 = one.delta_acc(P), four.delta_acc(P)
    np.testing.assert_array_equal(got4, got1)
    np.testing.assert_allclose(got4, want, rtol=0, atol=1.0 / N_EVAL + 1e-9)
    if strategy == "full":
        # no chunk cap: the unique rows split evenly over the slots
        U = len({tuple(r) for r in P.tolist()})
        assert four._engine.dispatches == -(-U // -(-U // 4))
    else:
        dd = four.staged_stats()["device_dispatches"]
        assert len(dd) >= 2
        assert sum(dd.values()) == four.staged_stats()["dispatches"]
        _check_slots(four._prefix_engine)
    # one device holds one copy, however many slots share it
    assert list(four._replicas) == [CPU]
    assert four.fault_state_bytes() == one.fault_state_bytes()


def test_devices_knob_resolution_and_reset():
    ev = cnn_ev("alexnet", "kernel", "staged", POOL4)
    _, *_, P = cnn("alexnet")
    want = ev.delta_acc(P)
    assert ev._prefix_engine._root_device and len(ev._prefix_engine.store)
    ev.devices = 2                       # the first two slots of the pool
    assert ev.devices == 2 and ev._scheduler.devices == [CPU, CPU]
    eng = ev._prefix_engine
    assert not eng._root_device and not len(eng.store)   # placement reset
    assert ev._cache                     # host results stay valid
    ev.devices = "auto"
    assert ev.devices == 4
    with pytest.raises(ValueError):
        ev.devices = 5
    ev.devices = None                    # "auto"
    assert ev.devices == 4
    ev._cache.clear()
    np.testing.assert_array_equal(ev.delta_acc(P), want)
    # without a pool, an evaluator on the host has one slot
    plain = cnn_ev("alexnet", "kernel", "staged", "auto")
    assert plain.devices == 1
    with pytest.raises(ValueError, match="pool holds 1"):
        plain.devices = 2


def test_rate_change_refreshes_every_replica():
    """A pool of two devices gives two replicas; a hot swap of the fault
    scales refreshes both replicas' rate tensors and rebuilds nothing under
    the kernel backend."""
    ev = cnn_ev("alexnet", "kernel", "staged", POOL4)
    _, *_, P = cnn("alexnet")
    ev.delta_acc(P)
    other = torch.device("meta")          # a second device, never run
    ev._replicas[other] = ev._home.__class__(other, None, None, None, None,
                                             None)
    ev.device_fault_scale = SCALE * 0.5
    for rep in ev._replicas.values():
        assert rep.w_dev.device == rep.device
        np.testing.assert_array_equal(
            rep.w_dev.cpu().numpy() if rep.device == CPU
            else ev.w_rates_by_device, ev.w_rates_by_device)
    assert ev._fault_env_rebuilds == 0
    del ev._replicas[other]
    fresh = cnn_ev("alexnet", "kernel", "staged", 1)
    fresh.device_fault_scale = SCALE * 0.5
    np.testing.assert_array_equal(ev.delta_acc(P), fresh.delta_acc(P))


def test_replica_copies_share_tied_and_expanded_leaves():
    from repro_torch.core.objectives import _to_device
    w = torch.arange(6.0).reshape(2, 3)
    tree = {"a": w, "b": [w, w.expand(4, 2, 3)]}
    out = _to_device(tree, CPU)
    assert out["a"] is out["b"][0]
    assert out["b"][1].stride(0) == 0
    assert torch.equal(out["b"][1], w.expand(4, 2, 3))


# --------------------------------------------------------------------------
# the evaluator on the LMs
# --------------------------------------------------------------------------
B, S = 2, 16
LM_SPEC = dict(bits=8, faulty_bits=4, weight_fault_rate=0.2,
               act_fault_rate=0.2)
_LM = {}


def lm(arch, S=S):
    if arch not in _LM:
        jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
        jp, jb, jl = jsetup(jcfg, B=B, S=S)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        if cfg.is_encdec:
            tb = calibration_batch(cfg, B, S, device="cpu")
        else:
            tb = {"tokens": torch.from_numpy(np.array(jb["tokens"]))}
        tl = torch.from_numpy(np.array(jl))
        _LM[arch] = (jcfg, cfg, jp, jb, jl, tp, tb, tl)
    return _LM[arch]


def lm_ev(arch, backend, devices, **kw):
    _, cfg, *_, tp, tb, tl = lm(arch)
    return make_lm_accuracy_evaluator(cfg, tp, tb, tl, FaultSpec(**LM_SPEC),
                                      SCALE, base_seed=3,
                                      fault_backend=backend, devices=devices,
                                      device="cpu", **kw)


@pytest.mark.parametrize("strategy", ["full", "staged"])
@pytest.mark.parametrize("backend", ["generic", "tables", "kernel"])
def test_olmo_four_slots_bitwise_one_slot(backend, strategy):
    jcfg, cfg, jp, jb, jl, *_ = lm("olmo-1b")
    P = np.random.default_rng(0).integers(0, len(SCALE),
                                          size=(8, cfg.n_layers))
    P[4:, 0] = P[0, 0]
    want = jmake(jcfg, jp, jb, jl, JFaultSpec(**LM_SPEC), SCALE, base_seed=3,
                 fault_backend={"kernel": "pallas"}.get(backend, backend),
                 eval_strategy="full", devices=1).delta_acc(P)
    assert want.max() > 0
    got1 = lm_ev("olmo-1b", backend, 1, eval_strategy=strategy).delta_acc(P)
    four = lm_ev("olmo-1b", backend, POOL4, eval_strategy=strategy)
    np.testing.assert_array_equal(four.delta_acc(P), got1)
    np.testing.assert_allclose(got1, want, rtol=0, atol=1.0 / (B * S) + 1e-9)
    if strategy == "staged":
        assert len(four.staged_stats()["device_dispatches"]) >= 2
        _check_slots(four._prefix_engine)


def test_seamless_memory_once_per_encoder_prefix_per_slot():
    """The encoder-decoder over 4 slots: bitwise 1 slot, the memory stored
    once per encoder prefix, on that prefix's slot, and every decoder
    carry's reference resolving on its own slot."""
    _, cfg, *_ = lm("seamless-m4t-medium", S=32)
    ne = cfg.n_enc_layers
    n = ne + cfg.n_layers
    rng = np.random.default_rng(5)
    P = rng.integers(0, 2, size=(8, n))
    P[:4, :ne] = 0
    P[4:, :ne] = 1
    want = lm_ev("seamless-m4t-medium", "kernel", 1,
                 eval_strategy="staged").delta_acc(P)
    ev = lm_ev("seamless-m4t-medium", "kernel", POOL4, eval_strategy="staged",
               max_store_bytes=None)
    np.testing.assert_array_equal(ev.delta_acc(P), want)
    eng = ev._prefix_engine
    _check_slots(eng)
    payloads = [k for k in eng.store._store if len(k) == ne]
    assert len(payloads) == len({tuple(r[:ne]) for r in P}) == 2
    assert {eng.store.slot_of(k) for k in payloads} == {0, 1}
    for key, act in eng.store._store.items():
        if len(key) > ne:
            assert act["mem"].prefix == key[:ne]
            assert eng.store.slot_of(act["mem"].prefix) == \
                eng.store.slot_of(key)
    expect = sum(t.numel() * t.element_size()
                 for act in eng.store._store.values()
                 for t in tree_leaves(act) if isinstance(t, torch.Tensor))
    assert eng.store.nbytes == expect
    tiny = lm_ev("seamless-m4t-medium", "kernel", POOL4,
                 eval_strategy="staged", max_store_bytes=1)
    np.testing.assert_array_equal(tiny.delta_acc(P), want)
    assert tiny.staged_stats()["evictions"] > 0


# --------------------------------------------------------------------------
# knob threading
# --------------------------------------------------------------------------
def test_objective_fn_threads_devices():
    class FakeEvaluator:
        eval_strategy = "staged"
        eval_batch_size = None
        devices = 1

    class FakeCostModel:
        pass

    ev = FakeEvaluator()
    ObjectiveFn(FakeCostModel(), ev, devices=3)
    assert ev.devices == 3
    ev2 = FakeEvaluator()
    ObjectiveFn(FakeCostModel(), ev2)              # None = leave alone
    assert ev2.devices == 1


def test_afarepart_eval_devices_plan_bitwise():
    """``AFarePart(eval_devices=4)`` on an evaluator whose pool is
    ``[cpu] * 4`` gives the plan ``eval_devices=1`` gives."""
    layers = tcnn.AlexNet.layer_infos(num_classes=8, width=0.25, img=16)
    scale = np.array([d.fault_scale for d in PAPER_DEVICES], np.float32)
    plans = {}
    for n in (1, 4):
        ev = cnn_ev("alexnet", "kernel", "staged", POOL4)
        ev.device_fault_scale = scale
        plans[n] = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                             eval_devices=n,
                             nsga2_config=NSGA2Config(8, 2)).optimize()
        assert ev.devices == n
        if n == 4:
            assert len(ev.staged_stats()["device_dispatches"]) >= 2
    np.testing.assert_array_equal(plans[4].partition, plans[1].partition)
    np.testing.assert_array_equal(plans[4].front, plans[1].front)
    np.testing.assert_array_equal(plans[4].front_objs, plans[1].front_objs)
    assert plans[4].front_objs[:, 2].max() > 0


# --------------------------------------------------------------------------
# the kernels launch with their tensors' card current
# --------------------------------------------------------------------------
def test_launch_switches_card_only_when_it_differs(monkeypatch):
    state = {"current": 0, "switches": 0}

    @contextlib.contextmanager
    def on(device):
        prev, state["current"] = state["current"], device.index
        state["switches"] += 1
        try:
            yield
        finally:
            state["current"] = prev

    seen = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", on)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d:
                        types.SimpleNamespace(cuda_stream=40 + d.index))
    monkeypatch.setattr(ops, "_entry", lambda fn: lambda *a: seen.append(
        (state["current"], a)) or 0)
    ops._launch("afp_bitflip", torch.device("cuda", 0), 1, 2)
    assert seen[-1] == (0, (1, 2, 40)) and state["switches"] == 0
    ops._launch("afp_bitflip", torch.device("cuda", 1), 3)
    assert seen[-1] == (1, (3, 41)) and state["switches"] == 1
    assert state["current"] == 0                  # the caller's card again
    monkeypatch.setattr(ops, "_entry", lambda fn: lambda *a: 700)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        ops._launch("afp_bitflip", torch.device("cuda", 1), 3)
    assert state["current"] == 0


# --------------------------------------------------------------------------
# the pipeline's swap bookkeeping
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_stages", [2, 3, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_group_cuts_and_swap_migration_match_reference(arch, n_stages):
    jcfg, cfg = jget(arch), get_config(arch)
    L = cfg.n_enc_layers + cfg.n_layers if cfg.is_encdec else cfg.n_layers
    rng = np.random.default_rng(sum(map(ord, arch)) + n_stages)
    for _ in range(6):
        old = rng.integers(0, 4, size=L)
        new = old.copy()
        new[rng.random(L) < 0.3] = rng.integers(0, 4)
        if rng.random() < 0.3:
            new = np.sort(new)                  # few device changes
        got = tpipe.swap_migration(old, new, cfg, n_stages)
        want = jpipe.swap_migration(old, new, jcfg, n_stages)
        assert got == want
        cuts = [0, L // 3, L // 2, L]
        assert tpipe.group_cuts(cuts, cfg) == jpipe.group_cuts(cuts, jcfg)


def test_swap_migration_counts_moved_groups():
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=4)
    old, new = np.zeros(4, np.int64), np.array([0, 0, 0, 1])
    m = tpipe.swap_migration(old, new, cfg, 2)
    assert m == {"migrated_groups": 1, "n_groups": 4, "old_cuts": [0, 2, 4],
                 "new_cuts": [0, 3, 4]}
