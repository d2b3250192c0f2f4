"""The port's dense transformer (``repro_torch.models.transformer``,
``configs``, ``models.graph``, the LM blocks of ``models.layers``) against
the reference at the ``reduced()`` configs of olmo-1b, starcoder2-3b,
gemma2-27b and phi-3-vision-4.2b (B=2, S=16), with the reference's params
carried across (``repro_torch.convert``).

Tolerances (float32, TF32 never involved on the CPU):
  * the clean forward, and every unit's step fed the REFERENCE's input
    for that unit (with faults: the input then quantizes bitwise as the
    reference's), within ``ATOL`` = 1e-5 absolute: sums in another order
    (measured worst 2.8e-6, logits up to ~4);
  * a faulted whole forward within ``ATOL`` plus 4 quantization steps,
    4 * 2^-(bits-1) * max(1, max|logits|) (the hidden states' amax is of
    order 1 and above): fed its own activations, the port can
    round an activation to the neighbouring fixed-point value where the
    reference does not, and that step carries on (measured worst 3.1e-4
    at bits=16, starcoder2; at bits=8 no boundary was crossed, 1.4e-6);
    and the argmax of at least 97% of the tokens agrees (measured: all).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import graph as jgraph  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.testing.lm_harness import lm_calibration_setup as jsetup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.lm_setup import lm_calibration_setup  # noqa: E402
from repro_torch.models import graph  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DENSE = ["olmo-1b", "starcoder2-3b", "gemma2-27b", "phi-3-vision-4.2b"]
B, S = 2, 16
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def setup(arch, dtype="float32"):
    """(reference cfg, port cfg, reference params/batch/labels, port
    params/batch/labels), cached per (arch, dtype)."""
    key = (arch, dtype)
    if key not in _SETUPS:
        jcfg = dataclasses.replace(jget(arch).reduced(), dtype=dtype)
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        jp, jb, jl = jsetup(jcfg, B=B, S=S)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        tb = {"tokens": torch.from_numpy(np.array(jb["tokens"]))}
        tl = torch.from_numpy(np.array(jl))
        _SETUPS[key] = (jcfg, cfg, jp, jb, jl, tp, tb, tl)
    return _SETUPS[key]


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _flush(t):
    """Subnormals read as zero, as the reference's XLA on the CPU
    computes them."""
    return torch.where(t.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(t), t)


def _rates(L, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.3, L).astype(np.float32),
            rng.uniform(0.05, 0.3, L).astype(np.float32))


# --------------------------------------------------------------------------
# configs and the layer graph: all ten configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_graph_and_strategy_match_reference(arch):
    jcfg, cfg = jget(arch), get_config(arch)
    assert ARCH_IDS == J_ARCH_IDS
    for a, b in ((jcfg, cfg), (jcfg.reduced(), cfg.reduced())):
        fields = [f.name for f in dataclasses.fields(a)]
        assert fields == [f.name for f in dataclasses.fields(b)]
        assert all(getattr(a, f) == getattr(b, f) for f in fields)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert (a.n_groups, a.head_dim_) == (b.n_groups, b.head_dim_)
        assert b.torch_dtype == (torch.bfloat16 if a.dtype == "bfloat16"
                                 else torch.float32)
        for seq in (4096, 256):
            assert [dataclasses.astuple(li) for li in
                    jgraph.lm_layer_infos(a, seq=seq)] == \
                [dataclasses.astuple(li) for li in
                 graph.lm_layer_infos(b, seq=seq)]
        assert jgraph.lm_eval_strategy(a, budget=16 << 30) == \
            graph.lm_eval_strategy(b, budget=16 << 30)
    assert get_config(arch.replace("-", "_").replace(".", "p")) == cfg


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "mixtral-8x7b",
                                  "seamless-m4t-medium", "recurrentgemma-2b",
                                  "arctic-480b"])
def test_unported_families_raise(arch):
    """Every family builds now (the name is kept from when some raised):
    the step model has a unit a layer (``n_enc_layers + n_layers`` for the
    encoder-decoder, seamless-m4t-medium), ``init_lm`` the reference's tree
    layout, and a reference tree carries across leaf for leaf."""
    cfg = get_config(arch).reduced()
    if cfg.is_encdec:
        assert T.LMStepModel(cfg, batch={}).n_units == \
            cfg.n_enc_layers + cfg.n_layers
    else:
        assert T.LMStepModel(cfg).n_units == cfg.n_layers
    jcfg = jget(arch).reduced()
    jp = JT.init_lm(jcfg, jax.random.PRNGKey(0))
    tp = T.init_lm(cfg, seed=3, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    cp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(cp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------------
# params, setup, conversion
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_init_lm_tree_matches_reference_layout(arch):
    """``init_lm`` builds the reference's tree: same keys, shapes and
    dtypes, so reference params carry across leaf for leaf."""
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: JT.init_lm(jcfg, k),
                            jax.random.PRNGKey(0))
    tp = T.init_lm(cfg, seed=3, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), tp) == \
        jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tp))


def test_lm_calibration_setup_matches_reference_batch():
    """Same tokens as the reference harness (one numpy draw); labels are
    the clean forward's argmax of the port's own params."""
    cfg = get_config("starcoder2-3b").reduced()
    params, batch, labels = lm_calibration_setup(cfg, B=B, S=S,
                                                 device="cpu")
    _, jb, _ = jsetup(jget("starcoder2-3b").reduced(), B=B, S=S)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    with torch.no_grad():
        logits = T.forward(params, cfg, batch)
    assert logits.shape == (B, S, cfg.vocab)
    assert torch.equal(labels, logits.argmax(-1))
    assert len(torch.unique(labels)) > 4


def test_bf16_tree_converts_bitwise():
    """A bfloat16 reference tree arrives bitwise (``torch.from_numpy``
    refuses ml_dtypes' bfloat16; convert goes through a uint16 view)."""
    jcfg = dataclasses.replace(jget("olmo-1b").reduced(), dtype="bfloat16")
    jp = JT.init_lm(jcfg, jax.random.PRNGKey(1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(torch.int16).numpy()
                                      .view(np.uint16))
    # QTensors of a bf16 tree keep their dtype
    sm = JT.LMStepModel(jcfg, bits=8)
    jq = sm.quant_unit_params(jp)[0]["block"]
    tq = convert.quant_params_from_jax(jq, device="cpu")
    assert tq["attn"]["wq"].dtype == torch.bfloat16 and tq["attn"]["wq"].matmul


# --------------------------------------------------------------------------
# forward, apply, step against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_apply_match_reference(arch, bits):
    """The whole forward, clean and with a fault triple, and ``apply``
    (the step composition) over ``[L]`` and ``[R, L]`` rates."""
    jcfg, cfg, jp, jb, jl, tp, tb, _ = setup(arch)
    L = cfg.n_layers
    with torch.no_grad():
        np.testing.assert_allclose(T.forward(tp, cfg, tb).numpy(),
                                   _np(JT.forward(jp, jcfg, jb)), atol=ATOL,
                                   rtol=0)
    wr, ar = _rates(L, bits)
    sm = T.LMStepModel(cfg, bits=bits, faulty_bits=4)
    jsm = JT.LMStepModel(jcfg, bits=bits, faulty_bits=4)
    units, junits = sm.unit_params(tp), jsm.unit_params(jp)
    want = _np(jsm.apply(junits, jb, jnp.asarray(wr), jnp.asarray(ar), 5))
    with torch.no_grad():
        got = sm.apply(units, tb, torch.from_numpy(wr), torch.from_numpy(ar),
                       5)
        rows = sm.apply(units, tb, torch.from_numpy(np.stack([wr, wr * 0])),
                        torch.from_numpy(np.stack([ar, ar * 0])), 5)
    assert torch.equal(rows[0], got)
    JL.set_fault_bits(bits, 4)
    TL.set_fault_bits(bits, 4)
    try:
        fj = _np(JT.forward(jp, jcfg, jb, fault=(jnp.asarray(wr),
                                                 jnp.asarray(ar),
                                                 jnp.int32(5))))
        with torch.no_grad():
            ft = T.forward(tp, cfg, tb, fault=(torch.from_numpy(wr),
                                               torch.from_numpy(ar), 5))
    finally:
        JL.set_fault_bits()
        TL.set_fault_bits()
    assert torch.equal(ft, got)       # forward == apply, same corruption
    tol = ATOL + 4 * 2.0 ** -(bits - 1) * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).mean() >= 0.97


@pytest.mark.parametrize("window, kv_chunk", [(4, 1024), (32, 5), (6, 5)])
def test_window_and_kv_chunks_match_reference(window, kv_chunk):
    """gemma2's local layers with a window shorter than the sequence, and
    the online softmax over several (padded) KV chunks: the reduced
    configs' window (32) and chunk (1024) exceed S = 16, so the other
    tests never mask by window nor carry a softmax across chunks."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup("gemma2-27b")
    jcfg = dataclasses.replace(jcfg, window=window)
    cfg = dataclasses.replace(cfg, window=window)
    want = _np(JT.forward(jp, jcfg, jb, kv_chunk=kv_chunk))
    with torch.no_grad():
        got = T.forward(tp, cfg, tb, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with torch.no_grad():
        full = T.forward(tp, dataclasses.replace(cfg, window=1024), tb)
    assert (window == 32) == torch.allclose(got, full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["generic", "kernel", "tables"])
@pytest.mark.parametrize("arch", DENSE)
def test_step_matches_reference_per_unit(arch, backend):
    """Every unit's step, fed the reference's input for that unit, with
    weight and activation faults (bits=8), under each backend's params:
    float (generic), resident QTensors (kernel) or one row of the tables."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup(arch)
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4)
    jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4)
    junits = jsm.unit_params(jp)
    wr, ar = _rates(cfg.n_layers, 11)
    scale = np.array([0.0, 1.0], np.float32)
    if backend == "generic":
        units = sm.unit_params(tp)
    elif backend == "kernel":
        units = sm.quant_unit_params(tp)
    else:       # row 1 of the tables: the block corrupted at rate 0.25
        units = [tree_map(lambda t: t[1:2], u)
                 for u in sm.build_weight_fault_tables(
                     sm.unit_params(tp), 0.25 * scale, base_seed=5)]
    x_ref = jb
    for i in range(cfg.n_layers):
        seed = 5 + 7919 * i
        w_rate = 0.25 if backend == "tables" else wr[i]
        want = jsm.step(i, junits[i], x_ref, jnp.float32(w_rate),
                        jnp.float32(ar[i]), seed)
        x_in = {"tokens": tb["tokens"][None]} if i == 0 else \
            torch.from_numpy(_np(x_ref).copy())[None]
        w_arg = None if backend == "tables" else torch.tensor([wr[i]])
        with torch.no_grad():
            got = sm.step(i, units[i], x_in, w_arg, torch.tensor([ar[i]]),
                          seed)[0]
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0,
                                   err_msg=f"unit {i}")
        x_ref = want


def test_quant_and_tables_bitwise_reference():
    """``quant_unit_params`` marks the reference's matmul leaves and stores
    its integers and scales; the tables' corrupted blocks are bitwise the
    reference's."""
    jcfg, cfg, jp, _, _, tp, _, _ = setup("starcoder2-3b")
    sm, jsm = T.LMStepModel(cfg, bits=8), JT.LMStepModel(jcfg, bits=8)
    for tq, jq in zip(sm.quant_unit_params(tp), jsm.quant_unit_params(jp)):
        a = tree_leaves(tq["block"])
        b = tree_leaves(convert.quant_params_from_jax(jq["block"],
                                                      device="cpu"))
        assert len(a) == len(b) and sum(x.matmul for x in a) == 6
        for x, y in zip(a, b):
            assert (x.matmul, x.bits, x.dtype) == (y.matmul, y.bits, y.dtype)
            assert torch.equal(x.qw, y.qw)
            # an all-zero leaf (a LayerNorm bias) has the subnormal scale
            # tiny/qmax, which the reference's XLA flushes to 0
            assert torch.equal(_flush(x.scale), y.scale)
    rates = np.array([0.0, 0.1, 0.3], np.float32)
    jt = jsm.build_weight_fault_tables(jsm.unit_params(jp), rates,
                                       base_seed=4)
    tt = sm.build_weight_fault_tables(sm.unit_params(tp), rates, base_seed=4)
    for a, b in zip(tt, jt):
        for x, y in zip(tree_leaves(a["block"]), jax.tree.leaves(b["block"])):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_rows_match_one_row_runs():
    """A whole forward over R rows gives, in each row, that row run alone,
    bitwise (kernel backend: resident params, per-row rates)."""
    _, cfg, _, _, _, tp, tb, _ = setup("gemma2-27b")
    sm = T.LMStepModel(cfg, bits=8)
    qp = sm.quant_unit_params(tp)
    g = torch.Generator().manual_seed(0)
    wr = torch.rand(4, cfg.n_layers, generator=g) * 0.3
    ar = torch.rand(4, cfg.n_layers, generator=g) * 0.3
    with torch.no_grad():
        many = sm.apply(qp, tb, wr, ar, 9)
        for r in range(4):
            assert torch.equal(many[r], sm.apply(qp, tb, wr[r], ar[r], 9))


# --------------------------------------------------------------------------
# bf16
# --------------------------------------------------------------------------
def test_fault_matmul_bf16_matches_reference_cpu_path():
    """``fault_matmul`` on bf16 x with bf16 weights is the reference's CPU
    function: w = bf16(fp32(q') * scale), then a bf16 product summed in
    fp32 and rounded once.  The weights are bitwise the reference's; the
    product differs from XLA's at most in the order of the fp32 sum
    (within 2K 2^-24 (|x| @ |w|) plus a bf16 rounding of each side)."""
    rng = np.random.default_rng(0)
    K, N = 96, 40
    x = rng.normal(size=(2, 3, 7, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(_np(xj).copy()).to(torch.bfloat16)
    for qdt, hi in ((np.int8, 127), (np.int32, 32767)):
        qw = rng.integers(-hi, hi, (K, N)).astype(qdt)
        rates = np.array([0.2, 0.0], np.float32)
        got = ops.fault_matmul(xt, torch.from_numpy(qw), 0.0123, 7,
                               torch.from_numpy(rates), 4)
        assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 7, N)
        for r in range(2):
            want = _np(jops.fault_matmul(xj[r], jnp.asarray(qw), 0.0123,
                                         jnp.int32(7), jnp.float32(rates[r]),
                                         4, out_dtype=jnp.bfloat16))
            w = _np(jops.bitflip(jnp.asarray(qw), jnp.int32(7),
                                 jnp.float32(rates[r]), 4).astype(jnp.float32)
                    * jnp.float32(0.0123)).astype(np.float32)
            w = _np(jnp.asarray(w).astype(jnp.bfloat16))
            mag = np.abs(_np(xj[r])) @ np.abs(w)
            g = got[r].float().numpy()
            tol = 2 * K * 2.0 ** -24 * mag + 2.0 ** -8 * (np.abs(g)
                                                        + np.abs(want))
            assert (np.abs(g - want) <= tol).all()


def test_bf16_olmo_forward_agreement():
    """The bf16 variant of reduced olmo-1b against the reference's
    ``forward``, which runs its layers in a compiled ``scan``.  The port's
    bf16 products are XLA's CPU dot bitwise (``ref.matmul``), and its
    forward is bitwise the reference's op-by-op composition of unit steps
    (next test).  Compiled, XLA computes another function: where a bf16
    residual sum ``x + attn(...)`` feeds the next norm's fp32 convert, it
    drops that sum's rounding to bf16 (the residual itself stays rounded),
    so the norm sees the fp32 sum.  Measured: the reference's own compiled
    ``forward`` and its op-by-op steps differ in 79% of the logits, and so
    does the port, by at most 0.0078 (logits up to 0.57); every token's
    argmax agrees."""
    jcfg, cfg, jp, jb, jl, tp, tb, tl = setup("olmo-1b", "bfloat16")
    with torch.no_grad():
        got = T.forward(tp, cfg, tb)
    want = _np(JT.forward(jp, jcfg, jb))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 0.0078125
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jl))
    assert torch.equal(got.argmax(-1), tl)


@pytest.mark.parametrize("faults", [False, True])
def test_bf16_olmo_matches_reference_steps(faults):
    """The bf16 variant of reduced olmo-1b, unit by unit against the
    reference's ``LMStepModel.step`` run op by op (not compiled), each unit
    fed the reference's input: bitwise, clean and at rate 0.1 (bits=8),
    and the port's whole forward bitwise the reference's composed steps.
    The products are what make this hold: in bf16 ``torch.matmul`` sums in
    another order than XLA and differed in the MLP's w2 product and the
    head (``ref.matmul`` sums as XLA does)."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup("olmo-1b", "bfloat16")
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4)
    jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4)
    junits, units = jsm.unit_params(jp), sm.unit_params(tp)
    rate = 0.1 if faults else None
    x_ref = jb
    for i in range(cfg.n_layers):
        seed = 5 + 7919 * i
        want = jsm.step(i, junits[i], x_ref,
                        None if rate is None else jnp.float32(rate),
                        None if rate is None else jnp.float32(rate), seed)
        x_in = {"tokens": tb["tokens"][None]} if i == 0 else \
            torch.from_numpy(np.asarray(x_ref).view(np.int16).copy()).view(
                torch.bfloat16)[None]
        r = None if rate is None else torch.tensor([rate])
        with torch.no_grad():
            got = sm.step(i, units[i], x_in, r, r, seed)[0]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16),
                                      err_msg=f"unit {i}")
        x_ref = want
    if not faults:
        with torch.no_grad():
            got = T.forward(tp, cfg, tb)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(x_ref).view(np.int16))


def test_bf16_olmo_compiled_step_differs_from_op_by_op():
    """Why bf16 LM ΔAcc is held at 2/(B·S) and not 1/(B·S)
    (``test_torch_lm_objectives.py::test_bf16_olmo_delta_acc_agreement``):
    the reference's first olmo-1b unit (bf16, reduced), compiled with
    ``jax.jit`` as its evaluator runs it, computes another function than
    the same unit run op by op, while the port's step is bitwise the
    op-by-op one.  Clean, so no fault draw is involved.  Measured: 57% of
    the unit's outputs differ (jax 0.9.0)."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup("olmo-1b", "bfloat16")
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4)
    jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4)
    junit, unit = jsm.unit_params(jp)[0], sm.unit_params(tp)[0]
    op_by_op = np.asarray(jsm.step(0, junit, jb, None, None, 5))
    compiled = np.asarray(jax.jit(
        lambda p, b: jsm.step(0, p, b, None, None, 5))(junit, jb))
    with torch.no_grad():
        got = sm.step(0, unit, {"tokens": tb["tokens"][None]}, None, None,
                      5)[0]
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  op_by_op.view(np.int16))
    differ = (compiled.view(np.int16) != op_by_op.view(np.int16)).mean()
    assert differ > 0.01, differ

