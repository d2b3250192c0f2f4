"""The port's ΔAcc evaluator (``repro_torch.core.objectives``) against
the reference's ``InferenceAccuracyEvaluator(fault_backend="pallas",
eval_strategy="full")`` on the three CNNs at small size (width 0.25,
img 16, 8 images), and one tiny ``AFarePart`` run end to end.

Tolerances: per-row ΔAcc within 1/n_eval of the reference.  A row's
accuracy can move by one image when an fp32 sum, taken in another order
by oneDNN than by XLA, crosses a rounding boundary of the 8-bit
activation quantization (see test_torch_cnn.py); within the port the
generic, tables and kernel backends agree BITWISE.

Labels are the clean quantized model's own argmax, so clean accuracy is 1
and ΔAcc a pure corruption measure; each probe is asserted to be working
(at least two distinct labels, some row with ΔAcc > 0) before it is used.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core.costmodel import PAPER_DEVICES as J_DEVICES  # noqa: E402
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.nsga2 import NSGA2Config as JNSGA2Config  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultSpec,  # noqa: E402
                              FaultUnawareBaseline, InferenceAccuracyEvaluator,
                              NSGA2Config)
from repro_torch.models import cnn as tcnn  # noqa: E402

SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
RATES = dict(weight_fault_rate=0.3, act_fault_rate=0.05, faulty_bits=4, bits=8)
SEEDS = {"alexnet": 3, "squeezenet": 0, "resnet18": 6}   # probes that spread
N_EVAL = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so the test workers running in
    parallel do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _port_evaluator(tm, tp, x, labels, backend):
    extra = {}
    if backend == "kernel":
        extra["quant_params"] = tcnn.quantize_unit_params(tp)
    elif backend == "tables":
        extra["weight_tables"] = tcnn.build_weight_fault_tables(
            tp, RATES["weight_fault_rate"] * SCALE, base_seed=3)
    return InferenceAccuracyEvaluator(
        tm.apply, tp, x, labels, FaultSpec(**RATES), SCALE, base_seed=3,
        eval_batch_size=4, fault_backend=backend, device="cpu", **extra)


@pytest.fixture(scope="module")
def setups():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N_EVAL, 16, 16, 3)).astype(np.float32)
    out = {}
    for name, seed in SEEDS.items():
        jm, tm = jcnn.CNN_MODELS[name], tcnn.CNN_MODELS[name]
        params = reference_shaped_params(jm, seed)
        jp = jax.tree.map(jnp.asarray, params)
        tp = convert.params_from_jax(params, device="cpu")
        z = torch.zeros(jm.n_units)
        labels = tm.apply(tp, torch.from_numpy(x), z, z, 0).argmax(-1).numpy()
        assert len(np.unique(labels)) >= 2, f"{name}: probe collapsed"
        ref = jobj.InferenceAccuracyEvaluator(
            jm.apply, jp, jnp.asarray(x), jnp.asarray(labels),
            JFaultSpec(**RATES), SCALE, base_seed=3, eval_batch_size=1,
            quant_params=jcnn.quantize_unit_params(jp),
            fault_backend="pallas", step_fn=jm.step, eval_strategy="full",
            devices=1)
        port = {b: _port_evaluator(tm, tp, x, labels, b)
                for b in ("generic", "tables", "kernel")}
        P = rng.integers(0, len(SCALE), size=(10, jm.n_units))
        out[name] = (ref, port, P)
    return out


@pytest.mark.parametrize("name", list(SEEDS))
def test_delta_acc_matches_reference(setups, name):
    ref, port, P = setups[name]
    want = ref.delta_acc(P)
    assert want.max() > 0, f"{name}: degenerate probe, no corruption seen"
    got = port["kernel"].delta_acc(P)
    assert port["kernel"].clean_accuracy() == ref.clean_accuracy() == 1.0
    assert np.abs(got - want).max() <= 1.0 / N_EVAL, (got, want)


@pytest.mark.parametrize("name", list(SEEDS))
def test_backends_bitwise_within_port(setups, name):
    _, port, P = setups[name]
    res = {b: ev.delta_acc(P) for b, ev in port.items()}
    assert res["generic"].max() > 0
    np.testing.assert_array_equal(res["generic"], res["tables"])
    np.testing.assert_array_equal(res["generic"], res["kernel"])
    assert port["kernel"].fault_table_bytes() == 0
    assert port["kernel"].fault_state_bytes() > 0


def test_kernel_backend_hot_swap(setups):
    """A ``device_fault_scale`` change under the kernel backend rebuilds
    nothing and gives what a fresh evaluator at the new scale gives;
    under tables it drops the tables and degrades to generic."""
    _, port, P = setups["alexnet"]
    ev = _port_evaluator(tcnn.AlexNet, port["generic"]._params,
                         port["generic"]._x, port["generic"].labels, "kernel")
    before = ev.delta_acc(P)
    ev.device_fault_scale = SCALE * 0.5
    after = ev.delta_acc(P)
    assert ev._fault_env_rebuilds == 0 and ev.fault_backend == "kernel"
    assert (before != after).any()
    fresh = _port_evaluator(tcnn.AlexNet, ev._params, ev._x, ev.labels,
                            "generic")
    fresh.device_fault_scale = SCALE * 0.5
    np.testing.assert_array_equal(after, fresh.delta_acc(P))
    tab = _port_evaluator(tcnn.AlexNet, ev._params, ev._x, ev.labels, "tables")
    tab.device_fault_scale = SCALE * 0.5
    assert tab.fault_backend == "generic" and tab._fault_env_rebuilds == 1
    np.testing.assert_array_equal(tab.delta_acc(P), after)


def test_unported_paths_raise(setups):
    """The staged strategy needs the per-unit ``step_fn``; the reference's
    ``"pallas"`` backend is the port's ``"kernel"``."""
    _, port, _ = setups["alexnet"]
    ev = port["generic"]
    with pytest.raises(ValueError, match="needs step_fn"):
        ev.eval_strategy = "staged"
    with pytest.raises(ValueError):
        ev.fault_backend = "pallas"


def test_afarepart_plan_matches_reference(setups):
    """One tiny AFarePart search (pop 8, 2 generations) on AlexNet over the
    paper's two devices gives the reference's plan; so does the
    fault-unaware baseline."""
    ref, port, _ = setups["alexnet"]
    scale = np.array([d.fault_scale for d in PAPER_DEVICES], np.float32)
    ref.device_fault_scale = scale
    ev = port["kernel"]
    ev.device_fault_scale = scale
    layers = tcnn.AlexNet.layer_infos(num_classes=8, width=0.25, img=16)
    jlayers = jcnn.AlexNet.layer_infos(num_classes=8, width=0.25, img=16)
    want = jpart.AFarePart(jlayers, J_DEVICES, acc_evaluator=ref,
                           nsga2_config=JNSGA2Config(population=8,
                                                     generations=2)).optimize()
    got = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                    nsga2_config=NSGA2Config(population=8,
                                             generations=2)).optimize()
    assert want.front_objs[:, 2].max() > 0
    np.testing.assert_array_equal(got.partition, want.partition)
    np.testing.assert_array_equal(got.front, want.front)
    np.testing.assert_allclose(got.front_objs, want.front_objs, rtol=0,
                               atol=1.0 / N_EVAL)
    assert got.evaluations == want.evaluations
    wb = jpart.FaultUnawareBaseline(jlayers, J_DEVICES,
                                    nsga2_config=JNSGA2Config(8, 2)).optimize()
    gb = FaultUnawareBaseline(layers, PAPER_DEVICES,
                              nsga2_config=NSGA2Config(8, 2)).optimize()
    np.testing.assert_array_equal(gb.partition, wb.partition)
    np.testing.assert_array_equal(gb.front_objs, wb.front_objs)


def test_cnn_setup_matches_its_parts():
    """``cnn_setup``: the reference's calibration data; ΔAcc of a row is
    1 - accuracy under that partition (labels = the clean quantized
    argmax) under every backend."""
    from repro.data import ImageClassData
    from repro_torch import cnn_setup

    x, y = cnn_setup.eval_batch(16, device="cpu")
    jx, jy = ImageClassData(num_classes=16, img=32, seed=0).batch(16, seed=99)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(y.numpy(), jy)
    params = tcnn.AlexNet.init(3, 16, width=0.125, img=32, device="cpu")
    labels = cnn_setup.clean_argmax_labels("alexnet", params, 16, device="cpu")
    spec = FaultSpec(weight_fault_rate=0.2, act_fault_rate=0.2)
    P = np.random.default_rng(0).integers(0, 2, size=(4, tcnn.AlexNet.n_units))
    want = [1.0 - cnn_setup.accuracy_under_partition(
        "alexnet", params, p, 0.2, 0.2, n_eval=16, labels=labels,
        device="cpu") for p in P]
    assert max(want) > 0
    for backend in ("generic", "tables", "kernel"):
        ev = cnn_setup.make_evaluator("alexnet", params, spec, n_eval=16,
                                      fault_backend=backend, labels=labels,
                                      device="cpu")
        np.testing.assert_array_equal(ev.delta_acc(P), want)
    assert 0.0 <= cnn_setup.clean_accuracy("alexnet", params, 16,
                                           device="cpu") <= 1.0
