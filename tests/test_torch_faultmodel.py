"""The port's fault hash and plain kernels (``repro_torch.kernels``)
against the reference oracles (``repro.kernels.ref``), BITWISE, on the
CPU; and ``ops.fault_matmul`` against the reference's interpret-mode
``ops.fault_matmul`` within the fp32 accumulation bound.

Inputs come from numpy with a seed and go through both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro.quant.fixedpoint import QuantSpec as JQuantSpec  # noqa: E402
from repro_torch.kernels.faultmodel import FAULT_MODELS  # noqa: E402
from repro_torch.quant import QuantSpec  # noqa: E402

INT_DTYPES = {"int8": (np.int8, torch.int8, 100),
              "int16": (np.int16, torch.int16, 2 ** 14),
              "int32": (np.int32, torch.int32, 2 ** 20)}
RATES = (0.0, 1e-3, 1e-1)
SEEDS = (42, -7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so the test workers running in
    parallel do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flush_subnormals(a: np.ndarray) -> np.ndarray:
    """XLA's CPU backend flushes denormals (``compute_scale`` of an
    all-zero tensor is 0.0 there); the port keeps IEEE subnormals, as the
    CUDA kernel must.  Compare with subnormal outputs read as zero."""
    a = np.asarray(a, np.float32).copy()
    a[np.abs(a) < np.finfo(np.float32).tiny] = 0.0
    return a


@pytest.mark.parametrize("dtype", list(INT_DTYPES))
@pytest.mark.parametrize("model", FAULT_MODELS)
def test_bitflip_ref_bitwise(dtype, model):
    np_dt, t_dt, hi = INT_DTYPES[dtype]
    rng = np.random.default_rng(len(dtype) * 10 + FAULT_MODELS.index(model))
    for shape in ((33, 17, 3),):
        q = rng.integers(-hi, hi, size=shape).astype(np_dt)
        for bits in (1, 4, 8):
            for rate in RATES:
                for seed in SEEDS:
                    want = np.asarray(jref.bitflip_ref(
                        jnp.asarray(q), jnp.int32(seed), rate, bits, model, 3))
                    got = ops.bitflip(torch.from_numpy(q), seed, rate, bits,
                                      fault_model=model, mbu_width=3)
                    assert got.dtype == t_dt and tuple(got.shape) == shape
                    np.testing.assert_array_equal(got.numpy(), want)


def test_bitflip_rows_match_per_rate_calls():
    """A ``[R]`` rate corrupts the shared tensor once per row, each row
    bitwise the reference at that row's rate (the vmap semantics)."""
    rng = np.random.default_rng(1)
    q = rng.integers(-100, 100, size=(7, 9)).astype(np.int8)
    rates = np.array([0.0, 1e-3, 0.1, 0.5], np.float32)
    got = ops.bitflip(torch.from_numpy(q), 5, torch.from_numpy(rates), 4)
    assert tuple(got.shape) == (4, 7, 9)
    for r, rate in enumerate(rates):
        want = np.asarray(jref.bitflip_ref(jnp.asarray(q), jnp.int32(5),
                                           jnp.float32(rate), 4))
        np.testing.assert_array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", FAULT_MODELS)
def test_quant_bitflip_ref_bitwise(dtype, model):
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    for shape in ((31, 33, 7),):
        xj = jnp.asarray(rng.normal(size=shape).astype(np.float32), jdt)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
        for rate in RATES:
            for seed in SEEDS:
                want = np.asarray(jref.quant_bitflip_ref(
                    xj, jnp.int32(seed), jnp.float32(rate), 4,
                    fault_model=model).astype(jnp.float32))
                got = ops.quant_bitflip(xt, seed, rate, 4, fault_model=model)
                assert got.dtype == tdt
                np.testing.assert_array_equal(got.float().numpy(), want)
    # an all-zero tensor: zeros back, up to the reference's flushed subnormals
    z = torch.zeros((5, 7), dtype=tdt)
    want = np.asarray(jref.quant_bitflip_ref(
        jnp.zeros((5, 7), jdt), jnp.int32(9), jnp.float32(0.25), 4,
        fault_model=model).astype(jnp.float32))
    got = ops.quant_bitflip(z, 9, 0.25, 4, fault_model=model).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(_flush_subnormals(got), want)


def test_quant_bitflip_rows_have_their_own_scale():
    """Per-row amax: each row of a ``[R, ...]`` batch equals the reference
    on that row alone, although the rows' magnitudes differ 100x."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 6, 5, 4)).astype(np.float32)
    x *= np.array([1.0, 100.0, 0.01], np.float32)[:, None, None, None]
    rates = np.array([0.0, 0.05, 0.3], np.float32)
    got = ops.quant_bitflip(torch.from_numpy(x), 11, torch.from_numpy(rates), 4,
                            QuantSpec(bits=8))
    for r in range(3):
        want = np.asarray(jref.quant_bitflip_ref(
            jnp.asarray(x[r]), jnp.int32(11), jnp.float32(rates[r]), 4,
            JQuantSpec(bits=8)))
        np.testing.assert_array_equal(got[r].numpy(), want)


def _accumulation_bound(x, w):
    """|fp32 dot error| <= K * 2^-24 * (|x| @ |w|), for any summation order."""
    K = x.shape[-1]
    return K * 2.0 ** -24 * (np.abs(x).astype(np.float64)
                             @ np.abs(w).astype(np.float64))


@pytest.mark.parametrize("model", ["flip", "mbu"])
def test_fault_matmul_cpu_vs_reference(model):
    rng = np.random.default_rng(5)
    K, N = 96, 40
    x = rng.normal(size=(2, 7, K)).astype(np.float32)
    qw = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    scale = np.float32(0.0123)
    want = np.asarray(jops.fault_matmul(jnp.asarray(x), jnp.asarray(qw),
                                        scale, 13, 0.2, 4, fault_model=model))
    got = ops.fault_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                           torch.tensor(scale), 13, 0.2, 4,
                           fault_model=model).numpy()
    qf = np.asarray(jref.bitflip_ref(jnp.asarray(qw), jnp.int32(13), 0.2, 4,
                                     model))
    w = qf.astype(np.float32) * scale
    assert (np.abs(got - want) <= 2 * _accumulation_bound(x, w)).all()
    # x = I_K: every output is one exact product -> the corrupted,
    # dequantized weights, bitwise
    eye = ops.fault_matmul(torch.eye(K), torch.from_numpy(qw),
                           torch.tensor(scale), 13, 0.2, 4, fault_model=model)
    np.testing.assert_array_equal(eye.numpy(), w)


def test_fault_matmul_rows_match_per_rate_calls():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 4, 24)).astype(np.float32)
    qw = rng.integers(-127, 128, size=(24, 10)).astype(np.int8)
    rates = np.array([0.0, 0.1, 0.4], np.float32)
    got = ops.fault_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                           torch.tensor(0.5), 2, torch.from_numpy(rates), 4)
    for r in range(3):
        one = ops.fault_matmul(torch.from_numpy(x[r]), torch.from_numpy(qw),
                               torch.tensor(0.5), 2, float(rates[r]), 4)
        np.testing.assert_array_equal(got[r].numpy(), one.numpy())


def test_cpu_dispatch_counts_no_launch():
    ops.reset_launches()
    q = torch.zeros(8, dtype=torch.int8)
    ops.bitflip(q, 0, 0.5, 4)
    ops.quant_bitflip(torch.ones(8), 0, 0.5, 4)
    ops.fault_matmul(torch.ones(2, 8), q.reshape(8, 1), 1.0, 0, 0.5, 4)
    ops.fault_matmul(torch.ones(2, 8, dtype=torch.bfloat16), q.reshape(8, 1),
                     1.0, 0, 0.5, 4)
    t = ops.fault_weight_tiles(q.reshape(8, 1), 1.0, 0, 0.5, 4)
    ops.matmul_tiles(torch.ones(1, 2, 8, dtype=torch.bfloat16), t, 8, 1)
    ops.matmul_tiles_f32(torch.ones(1, 2, 8), t, 8, 1)
    ops.fault_matmul(torch.ones(2, 8), q.reshape(8, 1), 1.0, 0, 0.5, 4,
                     out_dtype=torch.bfloat16)
    ops.swiglu(torch.ones(2, 8), torch.ones(2, 8))
    ops.rope(torch.ones(4, 2, 8), torch.ones(4, 4), torch.zeros(4, 4))
    assert ops.unfused == {"swiglu": 0, "rope": 0}
    assert ops.launches == {"bitflip": 0, "quant_bitflip": 0,
                            "fault_matmul": 0, "fault_weight_tiles": 0,
                            "matmul_tiles": 0, "matmul_tiles_f32": 0,
                            "swiglu": 0, "rope": 0}


def test_fault_core_matches_reference():
    """``core/fault.py`` and the tree helpers of ``models/layers.py``: the
    same corruption as the reference, bitwise, leaf seeds included."""
    from repro.core import fault as jfault
    from repro.models import layers as jlayers
    from repro_torch.core import fault as tfault
    from repro_torch.models import layers as tlayers

    rng = np.random.default_rng(8)
    tree = {"b": rng.normal(size=(6,)).astype(np.float32),
            "a": [rng.normal(size=(4, 5)).astype(np.float32),
                  np.arange(3, dtype=np.int32)]}
    jtree = {"b": jnp.asarray(tree["b"]),
             "a": [jnp.asarray(tree["a"][0]), jnp.asarray(tree["a"][1])]}
    ttree = {"b": torch.from_numpy(tree["b"]),
             "a": [torch.from_numpy(tree["a"][0]), torch.from_numpy(tree["a"][1])]}
    for model in FAULT_MODELS:
        jspec = jfault.FaultSpec(0.3, 0.1, faulty_bits=4, bits=8,
                                 fault_model=model)
        tspec = tfault.FaultSpec(0.3, 0.1, faulty_bits=4, bits=8,
                                 fault_model=model)
        want = jax.tree.leaves(jfault.corrupt_tree(jtree, jspec, 5))
        got = tree_leaves(tfault.corrupt_tree(ttree, tspec, 5))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        jctx = jfault.FaultContext(jspec, (0, 1), (1.0, 0.35), base_seed=2)
        tctx = tfault.FaultContext(tspec, (0, 1), (1.0, 0.35), base_seed=2)
        for layer in (0, 1):
            for domain in ("weight", "act"):
                np.testing.assert_array_equal(
                    tctx.corrupt(ttree["b"], layer, domain=domain).numpy(),
                    np.asarray(jctx.corrupt(jtree["b"], layer, domain=domain)))
        want = jax.tree.leaves(jlayers.corrupt_params(jtree, jnp.float32(0.2), 7,
                                                 bits=8, faulty_bits=4,
                                                 fault_model=model))
        got = tree_leaves(tlayers.corrupt_params(ttree, torch.tensor(0.2), 7,
                                                  bits=8, faulty_bits=4,
                                                  fault_model=model))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    q = np.array([[0, 15], [-3, 7]], np.int32)
    qf = q ^ np.array([[1, 0], [3, 0]], np.int32)
    assert tfault.empirical_flip_rate(torch.from_numpy(q), torch.from_numpy(qf),
                                      4) == \
        jfault.empirical_flip_rate(jnp.asarray(q), jnp.asarray(qf), 4)
    jq = jlayers.quantize_params(jtree, 8, lambda path, leaf: leaf.ndim == 2)
    tq = tlayers.quantize_params(ttree, 8, lambda path, leaf: leaf.ndim == 2)
    for w, g in zip(jax.tree.leaves(jq), tree_leaves(tq)):
        if isinstance(g, tlayers.QTensor):
            assert g.matmul == w.matmul
            np.testing.assert_array_equal(g.qw.numpy(), np.asarray(w.qw))
            np.testing.assert_array_equal(g.dequant().numpy(),
                                          np.asarray(w.dequant()))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_tree_matches_reference(bits):
    """``quantize_tree`` / ``dequantize_tree`` on a tree of float32, bf16
    and integer leaves: integers, scales and the dequantized tree (to
    float32 and to bf16) bitwise the reference's, dtypes included.  The
    all-zero leaf's scale is the subnormal tiny/qmax, which the
    reference's XLA flushes to 0 (ROADMAP.md Queue C, fact 5): compared
    flushed."""
    from repro.quant.fixedpoint import dequantize_tree as jdeq
    from repro.quant.fixedpoint import quantize_tree as jquant
    from repro_torch import convert
    from repro_torch.quant import dequantize_tree, quantize_tree

    rng = np.random.default_rng(bits)
    tree = {"a": rng.standard_normal(7).astype(np.float32) * 3,
            "b": {"c": rng.standard_normal((3, 5)).astype(np.float32),
                  "h": jnp.asarray(rng.standard_normal(9), jnp.bfloat16),
                  "ints": np.arange(-2, 4, dtype=np.int32),
                  "zero": np.zeros(4, np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = convert.params_from_jax(jax.tree.map(np.asarray, jtree),
                                    device="cpu")
    spec, jspec = QuantSpec(bits), JQuantSpec(bits)
    jq, js = jquant(jtree, jspec)
    tq, ts = quantize_tree(ttree, spec)

    def same(got, want):
        want = jax.tree.leaves(want)
        got = tree_leaves(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert str(g.dtype) == "torch." + w.dtype.name
            if w.dtype.name == "bfloat16":
                g, w = g.view(torch.int16).numpy(), w.view(np.int16)
            np.testing.assert_array_equal(g.numpy() if torch.is_tensor(g)
                                          else g, w)

    same(tq, jq)
    tiny = torch.finfo(torch.float32).tiny
    same([torch.where(s.abs() < tiny, 0.0, s) for s in tree_leaves(ts)],
         [np.asarray(s, np.float32) for s in jax.tree.leaves(js)])
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        same(dequantize_tree(tq, ts, spec, td), jdeq(jq, js, jspec, jd))
