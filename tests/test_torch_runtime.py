"""The online phase (paper Alg. 1, lines 13-19) of the port,
``repro_torch.core.runtime``, against the reference's
``repro.core.runtime``.

  * The five cases of ``tests/test_runtime_reconfig.py`` run on both
    sides with the sensitivity surrogate (numpy only): the events (step,
    observed ΔAcc, old and new partition, predicted ΔAcc) and the
    partitions of every tick are IDENTICAL.
  * One true-evaluator case: ResNet18 at width 0.25, img 16, 8 images
    (a probe that spreads, ``tests/test_torch_objectives.py``), the
    reference's evaluator under its pallas backend beside the port's under
    the kernel and generic backends.  Events and partitions equal the
    reference's and each observed ΔAcc is within 1/n_eval of it (one image
    may move when an fp32 sum runs in another order; measured: equal);
    the port's two backends give the same log bitwise; a hot swap under the
    kernel backend rebuilds nothing (``_fault_env_rebuilds == 0``); a
    drained ``ReoptJob`` equals the synchronous step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import FaultSpec, InferenceAccuracyEvaluator  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

BASE = np.array([1.0, 0.35])
SHIFTED = np.array([1.0, 25.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surrogate_setup(lib, cnn):
    layers = cnn.ResNet18.layer_infos(num_classes=16, width=0.5, img=32)
    cm = lib.CostModel(layers, lib.PAPER_DEVICES)
    ev = lib.SurrogateAccuracyEvaluator(cm)
    part = lib.AFarePart(layers, lib.PAPER_DEVICES, acc_evaluator=ev,
                         nsga2_config=lib.NSGA2Config(population=20,
                                                      generations=10, seed=0))
    return cm, part, part.optimize()


def _surrogate_observe(cm):
    def observe(partition, device_scales):
        old = cm.fault_scale.copy()
        cm.fault_scale = np.asarray(device_scales, float)
        val = float(cm.sensitivity_surrogate(partition[None, :])[0])
        cm.fault_scale = old
        return val
    return observe


def _assert_same_events(a, b, atol=0.0):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert ea.step == eb.step
        assert abs(ea.observed_delta_acc - eb.observed_delta_acc) <= atol
        np.testing.assert_array_equal(ea.old_partition, eb.old_partition)
        np.testing.assert_array_equal(ea.new_partition, eb.new_partition)
        assert abs(ea.new_predicted_delta_acc
                   - eb.new_predicted_delta_acc) <= atol


def _surrogate_case(case, lib, cnn):
    """One case of the reference's suite on ``lib`` (the reference's
    ``repro.core`` or the port's); returns what it compares."""
    cm, part, plan = _surrogate_setup(lib, cnn)
    obs = _surrogate_observe(cm)
    theta = obs(plan.partition, BASE) * 1.5 + 1e-9
    if case == "below_threshold":
        rec = lib.OnlineReconfigurator(part, plan, theta=1e9, observe_fn=obs)
        log = lib.simulate_deployment(rec, lib.FaultEnvironment(BASE), 5)
        assert len(log["events"]) == 0
    elif case == "environment_shift":
        env = lib.FaultEnvironment(base_scale=BASE, schedule={3: SHIFTED})
        rec = lib.OnlineReconfigurator(part, plan, theta=theta,
                                       observe_fn=obs, reopt_generations=8)
        log = lib.simulate_deployment(rec, env, n_steps=8)
        assert len(log["events"]) >= 1
        ev0 = log["events"][0]
        assert obs(rec.partition, env.scales_at(7)) <= ev0.observed_delta_acc
        assert (rec.partition == 1).sum() <= (ev0.old_partition == 1).sum()
    elif case == "reopt_job":
        rec = lib.OnlineReconfigurator(part, plan, theta=theta,
                                       observe_fn=obs, reopt_generations=5)
        rec.step(3, SHIFTED)
        cm2, part2, plan2 = _surrogate_setup(lib, cnn)
        obs2 = _surrogate_observe(cm2)
        rec2 = lib.OnlineReconfigurator(part2, plan2, theta=theta,
                                        observe_fn=obs2, reopt_generations=5)
        job = rec2.start_reconfigure(3, obs2(plan2.partition, SHIFTED),
                                     SHIFTED)
        n = 0
        while not job.advance(1):
            n += 1
        assert n == 5 and len(rec.events) == len(rec2.events) == 1
        _assert_same_events(rec.events, rec2.events)
        log = {"events": rec.events + rec2.events,
               "partitions": [rec.partition, rec2.partition]}
    elif case == "bookkeeping":
        rec = lib.OnlineReconfigurator(part, plan, theta=1e-6,
                                       observe_fn=obs, reopt_generations=3)
        log = lib.simulate_deployment(
            rec, lib.FaultEnvironment(base_scale=np.array([30.0, 30.0])), 3)
        for e in rec.events:
            assert e.new_partition.shape == plan.partition.shape
            assert e.observed_delta_acc > 1e-6
    return plan, log


@pytest.mark.parametrize("case", ["below_threshold", "environment_shift",
                                  "reopt_job", "bookkeeping"])
def test_surrogate_loop_matches_reference(case):
    """The reference's runtime cases on both sides: the same plan, events
    and partitions, identically (the surrogate is numpy only)."""
    jplan, jlog = _surrogate_case(case, J, jcnn)
    tplan, tlog = _surrogate_case(case, T, tcnn)
    np.testing.assert_array_equal(jplan.partition, tplan.partition)
    np.testing.assert_array_equal(jplan.front, tplan.front)
    _assert_same_events(jlog["events"], tlog["events"])
    assert len(jlog["partitions"]) == len(tlog["partitions"])
    for a, b in zip(jlog["partitions"], tlog["partitions"]):
        np.testing.assert_array_equal(a, b)
    if "observed_delta_acc" in jlog:
        np.testing.assert_array_equal(jlog["observed_delta_acc"],
                                      tlog["observed_delta_acc"])


def test_scales_at_precomputed_keys():
    """The reference's case: a binary search over the sorted steps that
    still sees a step added after construction; the same answers."""
    for lib in (J, T):
        env = lib.FaultEnvironment(
            base_scale=np.array([1.0, 0.1]),
            schedule={8: np.array([1.0, 40.0]), 3: np.array([2.0, 0.1])})
        for t, want in ((0, [1.0, 0.1]), (2, [1.0, 0.1]), (3, [2.0, 0.1]),
                        (7, [2.0, 0.1]), (8, [1.0, 40.0]),
                        (999, [1.0, 40.0])):
            assert np.array_equal(env.scales_at(t), want)
        env.schedule[50] = np.array([9.0, 9.0])
        assert np.array_equal(env.scales_at(60), [9.0, 9.0])


def test_optimize_steps_drains_to_optimize():
    """The generator form yields one entry a generation and returns the
    plan ``optimize`` gives."""
    _, part, plan = _surrogate_setup(T, tcnn)
    gen = part.optimize_steps()
    n = 0
    try:
        while True:
            next(gen)
            n += 1
    except StopIteration as stop:
        drained = stop.value
    assert n == part.config.generations
    np.testing.assert_array_equal(drained.partition, plan.partition)
    np.testing.assert_array_equal(drained.front_objs, plan.front_objs)


# --------------------------------------------------------------------------
# the true evaluator: ResNet18 at a small size
# --------------------------------------------------------------------------
RATES = dict(weight_fault_rate=0.3, act_fault_rate=0.05, faulty_bits=4, bits=8)
N_EVAL, PROBE_SEED = 8, 6          # tests/test_torch_objectives.py's probe


def reference_shaped_params(jm, seed, num_classes=8, width=0.25, img=16):
    """numpy params in the reference's tree, drawn from a numpy seed (as
    ``tests/test_torch_objectives.py`` draws them)."""
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
def cnn_setup():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N_EVAL, 16, 16, 3)).astype(np.float32)
    params = reference_shaped_params(jcnn.ResNet18, PROBE_SEED)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_jax(params, device="cpu")
    z = torch.zeros(tcnn.ResNet18.n_units)
    labels = tcnn.ResNet18.apply(tp, torch.from_numpy(x), z, z, 0)
    labels = labels.argmax(-1).numpy()
    assert len(np.unique(labels)) >= 2, "probe collapsed"
    return x, labels, jp, tp


def _true_loop(lib, make_ev, n_steps=6):
    """Plan at ``BASE``, then the loop against a step to ``SHIFTED`` at
    t = 3, θ = 1.5x the plan's observed ΔAcc at ``BASE``."""
    cnn = jcnn if lib is J else tcnn
    layers = cnn.ResNet18.layer_infos(num_classes=8, width=0.25, img=16)
    ev = make_ev()
    part = lib.AFarePart(layers, lib.PAPER_DEVICES, acc_evaluator=ev,
                         nsga2_config=lib.NSGA2Config(population=8,
                                                      generations=3, seed=0))
    plan = part.optimize()

    def observe(partition, scales):
        ev.device_fault_scale = np.asarray(scales, np.float32)
        return float(ev.delta_acc(np.asarray(partition)[None])[0])

    theta = observe(plan.partition, BASE) * 1.5 + 1e-9
    rec = lib.OnlineReconfigurator(part, plan, theta=theta,
                                   observe_fn=observe, reopt_generations=3)
    env = lib.FaultEnvironment(base_scale=BASE, schedule={3: SHIFTED})
    log = lib.simulate_deployment(rec, env, n_steps)
    return dict(ev=ev, part=part, plan=plan, rec=rec, log=log, theta=theta,
                observe=observe)


def _port_ev(tp, x, labels, backend):
    extra = {"quant_params": tcnn.quantize_unit_params(tp)} \
        if backend == "kernel" else {}
    return InferenceAccuracyEvaluator(
        tcnn.ResNet18.apply, tp, x, labels, FaultSpec(**RATES), BASE,
        base_seed=3, fault_backend=backend, step_fn=tcnn.ResNet18.step,
        device="cpu", **extra)


@pytest.fixture(scope="module")
def true_logs(cnn_setup):
    x, labels, jp, tp = cnn_setup
    ref = _true_loop(J, lambda: jobj.InferenceAccuracyEvaluator(
        jcnn.ResNet18.apply, jp, jnp.asarray(x), jnp.asarray(labels),
        JFaultSpec(**RATES), BASE, base_seed=3,
        quant_params=jcnn.quantize_unit_params(jp), fault_backend="pallas",
        step_fn=jcnn.ResNet18.step, eval_strategy="full", devices=1))
    port = {b: _true_loop(T, lambda b=b: _port_ev(tp, x, labels, b))
            for b in ("kernel", "generic")}
    return ref, port


def test_true_evaluator_loop_matches_reference(true_logs):
    """Events and partitions of the kernel backend's loop equal the
    reference's; each observed ΔAcc within 1/n_eval; the search swapped."""
    ref, port = true_logs
    k = port["kernel"]
    assert len(ref["log"]["events"]) >= 1, "the shift did not trigger"
    np.testing.assert_array_equal(k["plan"].partition, ref["plan"].partition)
    _assert_same_events(k["log"]["events"], ref["log"]["events"],
                        atol=1.0 / N_EVAL + 1e-9)
    for a, b in zip(k["log"]["partitions"], ref["log"]["partitions"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(k["log"]["observed_delta_acc"],
                               ref["log"]["observed_delta_acc"],
                               atol=1.0 / N_EVAL + 1e-9, rtol=0)


def test_true_evaluator_backends_and_hot_swap(true_logs):
    """The kernel and generic backends give the same log bitwise; the
    kernel backend's swaps rebuilt nothing, the generic backend's did."""
    _, port = true_logs
    k, g = port["kernel"], port["generic"]
    _assert_same_events(k["log"]["events"], g["log"]["events"])
    np.testing.assert_array_equal(k["log"]["observed_delta_acc"],
                                  g["log"]["observed_delta_acc"])
    assert k["ev"]._fault_env_rebuilds == 0
    assert g["ev"]._fault_env_rebuilds > 0


def test_true_evaluator_reopt_job_matches_sync_step(cnn_setup):
    """From the same state, a ReoptJob advanced one generation at a time
    commits the partition the synchronous step commits, bitwise."""
    x, labels, _, tp = cnn_setup
    runs = [_true_loop(T, lambda: _port_ev(tp, x, labels, "kernel"),
                       n_steps=0) for _ in range(2)]
    sync, inc = runs
    sync["rec"].theta = inc["rec"].theta = -1.0      # always triggers
    sync["rec"].step(3, SHIFTED)
    observed = inc["observe"](inc["plan"].partition, SHIFTED)
    job = inc["rec"].start_reconfigure(3, observed, SHIFTED)
    while not job.advance(1):
        pass
    assert job.generations_run == 3
    _assert_same_events(sync["rec"].events, inc["rec"].events)
    assert inc["ev"]._fault_env_rebuilds == 0
