"""The port's CNNs (``repro_torch.models.cnn``) against the reference
(``repro.models.cnn``) at small size (width 0.25, img 16, 8 images).

Params have the tree the reference's ``init`` builds (``jax.eval_shape``)
with He-normal values drawn by numpy from a seed, and are carried into the
port by ``repro_torch.convert``; drawing them through ``jax.random`` would
only add compile time (the port cannot redraw those numbers anyway).

  * corrupted weights (inline ``quant_bitflip`` tables and the kernel
    backend's resident-integer ``bitflip``) and quantized params: BITWISE;
  * every unit's ``step``, clean and faulted (rate-0 units included), fed the
    reference's own input activation: within 1e-4 of the largest
    reference output.  The fp32 conv/matmul sums run in another order in
    oneDNN than in XLA (measured ~1e-6 relative).  Fed its own
    activations instead, a tiny difference can cross a rounding boundary
    of the next unit's 8-bit activation quantization and move that
    element by a whole step, so end to end:
  * ``apply`` logits clean (no quantization): within the same 1e-4
    (faulted end to end, ΔAcc is held in test_torch_objectives.py);
  * the row-batched path equal, BITWISE, to one row at a time.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.layers import QTensor, maybe_corrupt  # noqa: E402

SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
W_RATE, A_RATE = 0.3, 0.05
# numpy seeds of the params
INIT_KEY = {"alexnet": 3, "squeezenet": 0, "resnet18": 6}
LOGIT_RTOL = 1e-4
# units whose weight corruption is checked: every kind of unit (conv, fire
# with its three leaves, residual blocks without and with "proj", fc)
UNITS_CHECKED = {"alexnet": 8, "squeezenet": 3, "resnet18": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so the test workers running in
    parallel do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_shaped_params(jm, seed, num_classes=8, width=0.25, img=16):
    """numpy params in the reference's tree: He-normal weights (fan-in of
    HWIO / (K, N)), small random biases."""
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
def setups():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    out = {}
    for name, key in INIT_KEY.items():
        jm = jcnn.CNN_MODELS[name]
        params = reference_shaped_params(jm, key)
        jp = jax.tree.map(jnp.asarray, params)
        tp = convert.params_from_jax(params, device="cpu")
        P = rng.integers(0, len(SCALE), size=(3, jm.n_units))
        out[name] = (jm, tcnn.CNN_MODELS[name], jp, tp, x, P)
    return out


@pytest.mark.parametrize("name", list(INIT_KEY))
def test_weight_corruption_bitwise(setups, name):
    """Tables (inline quant_bitflip per device) and the kernel backend's
    bitflip of the resident integers both equal the reference tables."""
    jm, tm, jp, tp, _, _ = setups[name]
    rates = W_RATE * SCALE
    n = UNITS_CHECKED[name]
    want = jcnn.build_weight_fault_tables(jp[:n], rates, base_seed=3)
    got = tcnn.build_weight_fault_tables(tp[:n], rates, base_seed=3)
    qp = tcnn.quantize_unit_params(tp[:n])
    rates_t = torch.from_numpy(np.asarray(rates, np.float32))
    for i, (w_unit, g_unit, q_unit) in enumerate(zip(want, got, qp)):
        w_leaves = jax.tree.leaves(w_unit)
        g_leaves = tree_leaves(g_unit)
        q_leaves = tree_leaves(q_unit)
        assert len(w_leaves) == len(g_leaves) == len(q_leaves)
        for j, (w, g, q) in enumerate(zip(w_leaves, g_leaves, q_leaves)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            if isinstance(q, QTensor) and not q.matmul:
                k = maybe_corrupt(q, rates_t, 3 + 7919 * i + 977 * j,
                                  faulty_bits=tcnn.FAULTY_BITS)
                np.testing.assert_array_equal(np.asarray(w), k.numpy())


@pytest.mark.parametrize("name", list(INIT_KEY))
def test_quantized_params_bitwise(setups, name):
    _, _, jp, tp, _, _ = setups[name]
    want = jcnn.quantize_unit_params(jp)
    got = tcnn.quantize_unit_params(tp)
    carried = convert.quant_params_from_jax(want, device="cpu")
    for w_unit, g_unit, c_unit in zip(want, got, carried):
        for w, g, c in zip(jax.tree.leaves(w_unit), tree_leaves(g_unit),
                           tree_leaves(c_unit)):
            if isinstance(g, QTensor):
                assert g.matmul == w.matmul == c.matmul
                for t in (g, c):
                    np.testing.assert_array_equal(np.asarray(w.qw), t.qw.numpy())
                    np.testing.assert_array_equal(np.asarray(w.scale),
                                                  t.scale.numpy())
            else:
                np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _rates(P, L):
    return [(W_RATE * SCALE[p]).astype(np.float32) for p in P], \
        [(A_RATE * SCALE[p]).astype(np.float32) for p in P]


@pytest.mark.parametrize("name", list(INIT_KEY))
@pytest.mark.parametrize("mode", ["clean", "faulted"])
def test_step_matches_reference(setups, name, mode):
    """Each unit fed the reference's input activation (teacher forcing)."""
    jm, tm, jp, tp, x, P = setups[name]
    L = jm.n_units
    wrs, ars = _rates(P, L)
    wr, ar = wrs[0], ars[0]         # rows of P include rate-0 devices
    jstep = jax.jit(jm.step, static_argnums=0)
    act = jnp.asarray(x)
    for i in range(L):
        if mode == "clean":
            want = jstep(i, jp[i], act)
            got = tm.step(i, tp[i], torch.from_numpy(np.array(act))[None])
        else:
            want = jstep(i, jp[i], act, jnp.float32(wr[i]),
                           jnp.float32(ar[i]), 3 + 7919 * i)
            got = tm.step(i, tp[i], torch.from_numpy(np.array(act))[None],
                          torch.tensor(wr[i:i + 1]), torch.tensor(ar[i:i + 1]),
                          3 + 7919 * i)
        want, got = np.asarray(want), got[0].numpy()
        assert got.shape == want.shape, (i, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(want).max(),
                                   err_msg=f"unit {i}")
        act = jnp.asarray(want)


@pytest.mark.parametrize("name", list(INIT_KEY))
def test_apply_matches_reference(setups, name):
    jm, tm, jp, tp, x, _ = setups[name]
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", list(INIT_KEY))
def test_row_batched_equals_per_row(setups, name):
    """Rates ``[R, L]`` run R candidates at once; each row is bitwise the
    one-row run (the engine's padding and chunking rely on it)."""
    _, tm, _, tp, x, P = setups[name]
    wrs, ars = _rates(P, tm.n_units)
    xt = torch.from_numpy(x)
    qp = tcnn.quantize_unit_params(tp)
    for params in (tp, qp):
        rows = tm.apply(params, xt, torch.from_numpy(np.stack(wrs)),
                        torch.from_numpy(np.stack(ars)), 3)
        for r, (wr, ar) in enumerate(zip(wrs, ars)):
            one = tm.apply(params, xt, torch.from_numpy(wr),
                           torch.from_numpy(ar), 3)
            np.testing.assert_array_equal(rows[r].numpy(), one.numpy())


def test_same_padding_matches_xla_at_stride_2():
    """XLA "SAME" at stride 2 on an even input pads (0, 1)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    b = np.zeros(5, np.float32)
    want = np.asarray(jcnn._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x), stride=2))
    got = tcnn._conv({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     torch.from_numpy(x)[None], stride=2)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
