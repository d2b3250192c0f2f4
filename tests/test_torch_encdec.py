"""The encoder-decoder (seamless-m4t-medium) of the port against the
reference, at its ``reduced()`` config (2 encoder and 2 decoder layers,
d_model 64, B = 2, S = 32, so the encoder's memory is Se = S // 8 = 4 long;
the reference's params carried across with ``repro_torch.convert``): the
tree, the forward against the composed steps, the step dtypes of the bf16
model, each unit's step, per-row ΔAcc, the port's bitwise invariants, the
memory interned once per encoder prefix, and the plain float32-x,
bf16-weight ``fault_matmul`` that the encoder runs.

Tolerances:
  * each unit's step fed the REFERENCE's input for that unit, with weight
    and activation faults at bits=8, within ``ATOL`` = 1e-5 (measured
    1.4e-6 on hidden states of ~4).  Not bitwise: the LayerNorm's mean
    over the last axis reduces in another order than XLA's (62% of the
    means of a [2, 4, 64] float32 tensor differ in the last bit), while
    the float32 products agree bitwise;
  * per-row ΔAcc within 1/(B·S) of the reference's at bits 8 and 16 in
    float32, and 3/(B·S) in bf16 (ROADMAP C1: compiled, XLA drops bf16
    roundings that the port's op-by-op steps keep; here that moves the
    clean accuracy by 2 tokens, see ``test_bf16_delta_acc_matches_reference``);
  * within the port, BITWISE: the generic, tables and kernel backends;
    staged (fused and unfused) and full; ``forward`` and ``apply``; the
    plain float32-x, bf16-weight ``fault_matmul`` and the reference's
    interpret path.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.objectives import make_lm_accuracy_evaluator as jmake  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.testing.lm_harness import lm_calibration_setup as jsetup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (POD_TIERS_4, FaultSpec, NSGA2Config,  # noqa: E402
                              PrefixRef, lm_partitioner,
                              make_lm_accuracy_evaluator)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.lm_setup import calibration_batch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "seamless-m4t-medium"
B, S = 2, 32
ATOL = 1e-5
TOL = 1.0 / (B * S)
SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
SPECS = {8: dict(bits=8, faulty_bits=4, weight_fault_rate=0.2,
                 act_fault_rate=0.2),
         16: dict(bits=16, faulty_bits=10, weight_fault_rate=0.2,
                  act_fault_rate=0.2)}
BACKENDS = ("generic", "tables", "kernel")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def setup(dtype="float32"):
    """(reference cfg, port cfg, reference params/batch/labels, port
    params/batch/labels), the batch the port's own draw, checked equal to
    the reference harness's."""
    if dtype not in _SETUPS:
        jcfg = dataclasses.replace(jget(ARCH).reduced(), dtype=dtype)
        cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
        jp, jb, jl = jsetup(jcfg, B=B, S=S)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        tb = calibration_batch(cfg, B, S, device="cpu")
        for k in ("tokens", "enc_embeds"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        tl = torch.from_numpy(np.array(jl))
        assert len(torch.unique(tl)) >= 4, "degenerate self-labels"
        _SETUPS[dtype] = (jcfg, cfg, jp, jb, jl, tp, tb, tl)
    return _SETUPS[dtype]


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rates(L, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.3, L).astype(np.float32),
            rng.uniform(0.05, 0.3, L).astype(np.float32))


def population(L, ne, n=8, seed=0):
    """Rows in two encoder-prefix groups, and shared decoder prefixes."""
    P = np.random.default_rng(seed).integers(0, len(SCALE), size=(n, L))
    P[:n // 2, :ne] = P[0, :ne]
    P[n // 2:, :ne] = P[n - 1, :ne]
    P[n // 4:n // 2, :ne + 1] = P[0, :ne + 1]
    return P


def port_ev(cfg, tp, tb, tl, bits, backend, **kw):
    return make_lm_accuracy_evaluator(cfg, tp, tb, tl,
                                      FaultSpec(**SPECS[bits]), SCALE,
                                      base_seed=3, fault_backend=backend,
                                      device="cpu", **kw)


def _carry(x):
    """A carry's tensors: the hidden state, or ``{"x", "mem"}``."""
    return [x] if isinstance(x, torch.Tensor) else [x["x"], x["mem"]]


# --------------------------------------------------------------------------
# the tree, the forward, the dtypes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_layout_and_conversion_bitwise(dtype):
    """``init_lm`` builds the reference's tree (``enc_groups``,
    ``enc_norm``, ``groups`` of cross blocks ``ln1, attn, ln_x, xattn, ln2,
    mlp``, an untied ``lm_head``; shapes and dtypes), the unit count is
    ``n_enc_layers + n_layers``, and a reference tree converts bitwise."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    shapes = jax.eval_shape(lambda k: JT.init_lm(jcfg, k),
                            jax.random.PRNGKey(1))
    tp = T.init_lm(cfg, seed=3, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), tp) == \
        jax.tree.map(lambda a: (tuple(a.shape), "torch." + a.dtype.name),
                     shapes)
    assert set(tp["groups"]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                 "mlp"}
    tb = calibration_batch(cfg, B, S, device="cpu")
    assert T.LMStepModel(cfg, batch=tb).n_units == \
        JT.LMStepModel(jcfg, batch={}).n_units == 4
    jp = jax.tree.map(lambda a, s: np.asarray(a).astype(s.dtype),
                      setup()[2], shapes)
    cp = convert.params_from_jax(jp, device="cpu")
    jl, tl = jax.tree.leaves(jp), tree_leaves(cp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        view = np.uint16 if a.dtype.name == "bfloat16" else np.uint32
        bv = b.view(torch.int16 if b.dtype == torch.bfloat16
                    else torch.int32).numpy()
        np.testing.assert_array_equal(a.view(view), bv.view(view))


def test_forward_is_the_composition_of_the_steps():
    """The clean forward within ``ATOL`` of the reference's; under faults
    ``forward`` equals ``apply`` (the steps composed) bitwise, and an
    R-row ``apply`` gives in each row that row run alone, bitwise."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup()
    sm = T.LMStepModel(cfg, bits=8, batch=tb)
    L = sm.n_units
    with torch.no_grad():
        np.testing.assert_allclose(T.forward(tp, cfg, tb).numpy(),
                                   _np(JT.forward(jp, jcfg, jb)), atol=ATOL,
                                   rtol=0)
        g = torch.Generator().manual_seed(0)
        wr = torch.rand(3, L, generator=g) * 0.3
        ar = torch.rand(3, L, generator=g) * 0.3
        for units in (sm.quant_unit_params(tp), sm.unit_params(tp)):
            many = sm.apply(units, tb, wr, ar, 9)
            for r in range(3):
                assert torch.equal(many[r], sm.apply(units, tb, wr[r], ar[r],
                                                     9))
        TL.set_fault_bits(8, 4)
        try:
            ft = T.forward(tp, cfg, tb, fault=(wr, ar, 9))
        finally:
            TL.set_fault_bits()
        assert torch.equal(ft, sm.apply(sm.unit_params(tp), tb, wr, ar, 9))


def test_bf16_step_dtypes_match_reference():
    """In the bf16 model the encoder's carries and the memory are float32
    (its input is never cast) and the decoder's hidden state bf16, as in
    the reference, under every backend."""
    jcfg, cfg, jp, jb, *_, tp, tb, _ = setup("bfloat16")
    jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4, batch=jb)
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4, batch=tb)
    want, x = [], jb
    for i, u in enumerate(jsm.unit_params(jp)):
        x = jsm.step(i, u, x, jnp.float32(0.1), jnp.float32(0.1), 7919 * i)
        want.append([a.dtype.name for a in
                     ([x] if not isinstance(x, dict) else [x["x"], x["mem"]])])
    assert want[:3] == [["float32"], ["float32"], ["bfloat16", "float32"]]
    for units in (sm.unit_params(tp), sm.quant_unit_params(tp)):
        x = {k: v[None] for k, v in tb.items()}
        for i, u in enumerate(units):
            with torch.no_grad():
                x = sm.step(i, u, x, torch.tensor([0.1]), torch.tensor([0.1]),
                            7919 * i)
            assert [str(t.dtype).removeprefix("torch.")
                    for t in _carry(x)] == want[i], i


_REF_STEPS = {}


def _ref_steps(tables: bool) -> list:
    """The reference's unit inputs and outputs, each unit fed the previous
    one's (bits=8, 4 LSBs, rates ``_rates(L, 11)``; weight rate 0.25 for
    the tables row)."""
    if tables not in _REF_STEPS:
        jcfg, cfg, jp, jb, *_ = setup()
        jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4, batch=jb)
        wr, ar = _rates(jsm.n_units, 11)
        out, x = [], jb
        for i, u in enumerate(jsm.unit_params(jp)):
            x = jsm.step(i, u, x, jnp.float32(0.25 if tables else wr[i]),
                         jnp.float32(ar[i]), 5 + 7919 * i)
            out.append(jax.tree.map(lambda a: np.array(_np(a)), x))
        _REF_STEPS[tables] = out
    return _REF_STEPS[tables]


@pytest.mark.parametrize("backend", BACKENDS)
def test_step_matches_reference_per_unit(backend):
    """Every unit's step, fed the reference's input for that unit (the
    encoder's hidden state, the memory, ``{"x", "mem"}``), with weight and
    activation faults, under each backend's params."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup()
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4, batch=tb)
    wr, ar = _rates(sm.n_units, 11)
    if backend == "generic":
        units = sm.unit_params(tp)
    elif backend == "kernel":
        units = sm.quant_unit_params(tp)
    else:
        units = [tree_map(lambda t: t[1:2], u)
                 for u in sm.build_weight_fault_tables(
                     sm.unit_params(tp), np.array([0.0, 0.25], np.float32),
                     base_seed=5)]
    want = _ref_steps(backend == "tables")
    for i in range(sm.n_units):
        if i == 0:
            x_in = {k: v[None] for k, v in tb.items()}
        else:
            x_in = tree_map(lambda a: torch.from_numpy(a)[None], want[i - 1])
        w_arg = None if backend == "tables" else torch.tensor([wr[i]])
        with torch.no_grad():
            got = sm.step(i, units[i], x_in, w_arg, torch.tensor([ar[i]]),
                          5 + 7919 * i)
        exp = want[i]
        for g_, e_ in zip(_carry(got), [exp] if isinstance(exp, np.ndarray)
                          else [exp["x"], exp["mem"]]):
            np.testing.assert_allclose(g_[0].numpy(), e_, atol=ATOL, rtol=0,
                                       err_msg=f"unit {i}")


# --------------------------------------------------------------------------
# ΔAcc against the reference, and the port's invariants
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16])
def test_delta_acc_matches_reference(bits):
    """Each backend within 1/(B·S) per row of the reference's pallas
    backend (whose tests hold it bitwise to its generic and tables), and
    the port's three backends bitwise equal."""
    jcfg, cfg, jp, jb, jl, tp, tb, tl = setup()
    P = population(cfg.n_enc_layers + cfg.n_layers, cfg.n_enc_layers)
    want = jmake(jcfg, jp, jb, jl, JFaultSpec(**SPECS[bits]), SCALE,
                 base_seed=3, fault_backend="pallas", eval_strategy="full",
                 devices=1).delta_acc(P)
    assert want.max() > 0 and len(np.unique(want)) >= 3, want
    got = {b: port_ev(cfg, tp, tb, tl, bits, b,
                      eval_strategy="full").delta_acc(P) for b in BACKENDS}
    np.testing.assert_allclose(got["kernel"], want, atol=TOL + 1e-9, rtol=0)
    for b in BACKENDS:
        np.testing.assert_array_equal(got[b], got["kernel"], err_msg=b)


def test_bf16_delta_acc_matches_reference():
    """The bf16 model, with the cause of its tolerance checked: at rate 0
    (the clean accuracy's quantized model) the port's logits are bitwise
    the reference's steps run op by op, while the reference's evaluator
    runs them compiled, where XLA drops bf16 roundings (ROADMAP C1) and 2
    more of the 64 tokens keep their label.  That moves every row's ΔAcc
    by 2/(B·S), and a faulty row's accuracy may move one token more, so
    rows are held within 3/(B·S) (measured: 2/(B·S) on 7 rows, 3/(B·S) on
    one).  The three backends are bitwise equal."""
    jcfg, cfg, jp, jb, jl, tp, tb, tl = setup("bfloat16")
    L = cfg.n_enc_layers + cfg.n_layers
    jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4, batch=jb)
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4, batch=tb)
    z = jnp.zeros((L,), jnp.float32)
    op_by_op = jsm.apply(jsm.unit_params(jp), jb, z, z, 3)
    with torch.no_grad():
        port0 = sm.apply(sm.unit_params(tp), tb, torch.zeros(L),
                         torch.zeros(L), 3)
    np.testing.assert_array_equal(port0.float().numpy(), _np(op_by_op))
    P = population(L, cfg.n_enc_layers, seed=2)
    jev = jmake(jcfg, jp, jb, jl, JFaultSpec(**SPECS[8]), SCALE,
                base_seed=3, fault_backend="pallas", eval_strategy="full",
                devices=1)
    want = jev.delta_acc(P)
    assert want.max() > 0 and len(np.unique(want)) >= 3, want
    evs = {b: port_ev(cfg, tp, tb, tl, 8, b, eval_strategy="full")
           for b in BACKENDS}
    got = {b: ev.delta_acc(P) for b, ev in evs.items()}
    op_clean = float((np.asarray(op_by_op.argmax(-1)) == np.asarray(jl))
                     .mean())
    assert evs["kernel"].clean_accuracy() == op_clean
    assert jev.clean_accuracy() - op_clean <= 2 * TOL
    np.testing.assert_allclose(got["kernel"], want, atol=3 * TOL + 1e-9,
                               rtol=0)
    for b in BACKENDS:
        np.testing.assert_array_equal(got[b], got["kernel"], err_msg=b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_full_fused_bitwise(dtype):
    """Staged (fused and unfused, chunks of 3 rows) against the whole
    forward (one row a chunk), kernel backend: bitwise, and the staged
    walk saves unit runs."""
    *_, tp, tb, tl = setup(dtype)
    cfg = setup(dtype)[1]
    P = population(cfg.n_enc_layers + cfg.n_layers, cfg.n_enc_layers, n=10,
                   seed=1)
    res = {}
    for strategy, fuse, ebs in (("full", True, 1), ("staged", False, 3),
                                ("staged", True, 3)):
        ev = port_ev(cfg, tp, tb, tl, 8, "kernel", eval_strategy=strategy,
                     fuse_chains=fuse, eval_batch_size=ebs)
        res[(strategy, fuse)] = ev.delta_acc(P)
        if strategy == "staged":
            assert ev.staged_stats()["unit_runs_avoided"] > 0
    assert len(np.unique(res[("full", True)])) >= 3, res
    for key, v in res.items():
        np.testing.assert_array_equal(v, res[("full", True)], err_msg=str(key))


def test_memory_stored_once_per_encoder_prefix():
    """After the reference's ``tests/test_sharded_eval.py:216-262``: the
    store holds the encoder's memory once per ENCODER prefix (as the last
    encoder unit's activation), every decoder carry holds a ``PrefixRef``
    to its own prefix's memory, the decoder input is never stored, the
    store's byte count has no memory twice, and the references survive
    eviction."""
    _, cfg, *_, tp, tb, tl = setup()
    ne = cfg.n_enc_layers
    n = ne + cfg.n_layers
    rng = np.random.default_rng(5)
    P = rng.integers(0, 2, size=(6, n))
    P[:3, :ne] = 0
    P[3:, :ne] = 1
    want = port_ev(cfg, tp, tb, tl, 8, "kernel",
                   eval_strategy="full").delta_acc(P)
    ev = port_ev(cfg, tp, tb, tl, 8, "kernel", eval_strategy="staged",
                 max_store_bytes=None)
    np.testing.assert_array_equal(ev.delta_acc(P), want)
    eng = ev._prefix_engine
    assert eng.shared_fields == {"mem": ne - 1}
    store = eng.store._store
    payloads, expect = 0, 0
    for key, act in store.items():
        if len(key) < ne:
            assert isinstance(act, torch.Tensor)
        elif len(key) == ne:
            assert isinstance(act, torch.Tensor)
            payloads += 1
        else:
            assert set(act) == {"x", "mem"}
            assert isinstance(act["mem"], PrefixRef)
            assert act["mem"].prefix == key[:ne]
        expect += sum(t.numel() * t.element_size() for t in tree_leaves(act)
                      if isinstance(t, torch.Tensor))
    assert payloads == len({tuple(r[:ne]) for r in P}) == 2
    assert eng.store.nbytes == expect
    tiny = port_ev(cfg, tp, tb, tl, 8, "kernel", eval_strategy="staged",
                   max_store_bytes=1)
    np.testing.assert_array_equal(tiny.delta_acc(P), want)
    assert tiny.staged_stats()["evictions"] > 0


def test_check_dec_input_refuses_another_batch():
    """The decoder reads the batch bound at construction: a unit-0 input
    with other decoder tokens is refused; an equal copy, or the bound
    tensor's row view, is accepted."""
    _, cfg, *_, tp, tb, _ = setup()
    sm = T.LMStepModel(cfg, batch=tb)
    units = sm.unit_params(tp)
    other = dict(tb, tokens=(tb["tokens"] + 1) % cfg.vocab)
    with torch.no_grad(), pytest.raises(ValueError, match="bound"):
        sm.apply(units, other)
    with torch.no_grad():
        same = sm.apply(units, {k: v.clone() for k, v in tb.items()})
        assert torch.equal(same, sm.apply(units, tb))
    with pytest.raises(ValueError, match="batch"):
        T.LMStepModel(cfg)


def test_lm_partitioner_encdec_staged_equals_full():
    """``lm_partitioner`` on the reduced model (kernel backend): staged and
    full evaluate the same rows to the same ΔAcc and give the same front;
    on the CPU the kernels' plain versions run and count no launch."""
    _, cfg, *_, tp, tb, tl = setup()
    scale = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)
    plans, rows = {}, {}
    for strategy in ("staged", "full"):
        ev = make_lm_accuracy_evaluator(cfg, tp, tb, tl, FaultSpec(bits=8),
                                        scale, fault_backend="kernel",
                                        device="cpu")
        ops.reset_launches()
        plans[strategy] = lm_partitioner(
            cfg, ev, fault_backend="kernel", eval_strategy=strategy,
            nsga2_config=NSGA2Config(population=8, generations=2)).optimize()
        assert sum(ops.launches.values()) == 0
        rows[strategy] = dict(ev._cache)
    assert rows["staged"] == rows["full"]
    np.testing.assert_array_equal(plans["staged"].front, plans["full"].front)
    np.testing.assert_array_equal(plans["staged"].front_objs,
                                  plans["full"].front_objs)


# --------------------------------------------------------------------------
# the encoder's product: float32 x on bf16 weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("qdtype", [np.int8, np.int16])
def test_fault_matmul_f32_x_bf16_weights_matches_reference(qdtype):
    """``fault_matmul_ref`` on float32 x with ``out_dtype=bfloat16``
    bitwise the reference's interpret path (``x @ w.astype(bf16)``, which
    JAX promotes to a float32 product on the weights' bf16 values), one
    row and R rows; float32 out; and its weights are bf16-rounded."""
    rng = np.random.default_rng(0)
    K, N = 96, 40
    x = rng.standard_normal((3, 7, K)).astype(np.float32)
    hi = 127 if qdtype == np.int8 else 2 ** 14
    qw = rng.integers(-hi, hi, (K, N)).astype(qdtype)
    rates = np.array([0.0, 0.1, 0.3], np.float32)
    scale = np.float32(0.0123 if qdtype == np.int8 else 1e-4)
    tx, tq = torch.from_numpy(x), torch.from_numpy(qw)
    got = ops.fault_matmul(tx, tq, torch.tensor(scale), 5, torch.from_numpy(
        rates), 6, out_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    for r in range(3):
        want = jops.fault_matmul(jnp.asarray(x[r]), jnp.asarray(qw), scale, 5,
                                 jnp.float32(rates[r]), 6,
                                 out_dtype=jnp.bfloat16)
        assert want.dtype == jnp.float32
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
    one = ref.fault_matmul_ref(tx[1], tq, scale, 5, float(rates[1]), 6,
                               out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())
    # differs from float32 weights: the rounding is there
    f32 = ref.fault_matmul_ref(tx, tq, scale, 5, torch.from_numpy(rates), 6)
    assert not torch.equal(f32, got)


def test_fault_dense_promotes_float32_x_on_bf16_weights():
    """A bf16 weight tensor (generic and tables backends) meets float32 x:
    float32 out, computed on the weights' bf16 values, bitwise what the
    kernel backend's ``FaultedQ`` gives at rate 0."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 5, 64, generator=g)
    w = torch.randn(64, 48, generator=g).to(torch.bfloat16)
    out = TL.fault_dense(x, w)
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.matmul(x, w.float()))
    q = TL.quantize_leaf(w, 8, matmul=True)
    fq = TL.maybe_corrupt(q, torch.zeros(2), 5, faulty_bits=4)
    assert torch.equal(TL.fault_dense(x, fq), TL.fault_dense(x, q.dequant()))


def test_flash_attention_mask_scalar_is_bitwise():
    """The mask value is a Python scalar in ``torch.where`` (no tensor made
    on the device, no host wait): bitwise what the tensor constant gave,
    causal, windowed and padded, float32 and bf16 q."""
    real_where = torch.where

    def tensor_where(c, a, b):
        if isinstance(b, float):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
        return real_where(c, a, b)

    g = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 40, 4, 16, generator=g).to(dtype)
        k = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
        v = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
        pos = torch.arange(40, dtype=torch.int32)
        for kw in (dict(), dict(window=7), dict(kv_chunk=16),
                   dict(causal=False, kv_chunk=16)):
            a = TL.flash_attention(q, k, v, pos, pos, **kw)
            torch.where = tensor_where
            try:
                b = TL.flash_attention(q, k, v, pos, pos, **kw)
            finally:
                torch.where = real_where
            assert torch.equal(a, b), kw
