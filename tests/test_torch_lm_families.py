"""The MoE (mixtral-8x7b, arctic-480b with its dense residual), RG-LRU
(recurrentgemma-2b) and SSD (mamba2-2.7b) stacks of the port against the
reference, at their ``reduced()`` configs (B=2, S=16, float32, the
reference's params carried across with ``repro_torch.convert``): the
layout and conversion of each tree, the kernel backend's leaf rule, each
unit's step, the whole forward, per-row ΔAcc, and the port's own bitwise
invariants.

Tolerances:
  * each unit's step fed the REFERENCE's input for that unit, with weight
    and activation faults at bits=8, within ``ATOL`` = 1e-5 absolute
    (measured worst over the four families and three backends: 2.1e-6 on
    hidden states up to 3.7);
  * per-row ΔAcc within 1/(B·S) = 1/32 of the reference's at bits=8 (4
    LSBs) and bits=16 (10 LSBs) (measured: every row equal, ΔAcc over
    0-25 tokens of 32);
  * within the port, BITWISE: the generic, tables and kernel backends;
    staged (fused and unfused) and full; R rows and each row alone; the
    tables backend on ``rglru`` and ``ssd`` units against generic.
Every probe is asserted non-degenerate before use (labels spread over many
tokens, ΔAcc over several values).
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
from repro.models import transformer as JT  # noqa: E402
from repro.testing.lm_harness import lm_calibration_setup as jsetup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (POD_TIERS_4, FaultSpec,  # noqa: E402
                              NSGA2Config, lm_partitioner,
                              make_lm_accuracy_evaluator)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

FAMILIES = ["mixtral-8x7b", "arctic-480b", "recurrentgemma-2b",
            "mamba2-2.7b"]
B, S = 2, 16
ATOL = 1e-5
TOL = 1.0 / (B * S)
SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
SPECS = {8: dict(bits=8, faulty_bits=4, weight_fault_rate=0.2,
                 act_fault_rate=0.2),
         16: dict(bits=16, faulty_bits=10, weight_fault_rate=0.2,
                  act_fault_rate=0.2)}
BACKENDS = ("generic", "tables", "kernel")
# matmul-marked (fault_matmul) leaves of one unit, by the reference's rule:
# attention q/k/v/o and 2-D mlp / dense_mlp matrices; the MoE experts and
# router, the RG-LRU and SSD weights go through bitflip
MATMUL_LEAVES = {"mixtral-8x7b": 4, "arctic-480b": 7,
                 "recurrentgemma-2b": (3, 3, 7), "mamba2-2.7b": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def setup(arch, **cfg_kw):
    key = (arch, tuple(sorted(cfg_kw.items())))
    if key not in _SETUPS:
        jcfg = dataclasses.replace(jget(arch).reduced(), **cfg_kw)
        cfg = dataclasses.replace(get_config(arch).reduced(), **cfg_kw)
        jp, jb, jl = jsetup(jcfg, B=B, S=S)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        tb = {"tokens": torch.from_numpy(np.array(jb["tokens"]))}
        tl = torch.from_numpy(np.array(jl))
        assert len(torch.unique(tl)) >= 8, "degenerate self-labels"
        _SETUPS[key] = (jcfg, cfg, jp, jb, jl, tp, tb, tl)
    return _SETUPS[key]


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _flush(t):
    """Subnormals read as zero, as the reference's XLA on the CPU computes
    them (an all-zero leaf, such as ``dt_bias``, has the subnormal scale
    tiny/qmax)."""
    return torch.where(t.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(t), t)


def _rates(L, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.3, L).astype(np.float32),
            rng.uniform(0.05, 0.3, L).astype(np.float32))


def population(L, n=8, seed=0):
    P = np.random.default_rng(seed).integers(0, len(SCALE), size=(n, L))
    P[n // 2:, :max(1, L // 2)] = P[0, :max(1, L // 2)]   # shared prefixes
    return P


def port_ev(cfg, tp, tb, tl, bits, backend, **kw):
    return make_lm_accuracy_evaluator(cfg, tp, tb, tl,
                                      FaultSpec(**SPECS[bits]), SCALE,
                                      base_seed=3, fault_backend=backend,
                                      device="cpu", **kw)


# --------------------------------------------------------------------------
# trees: layout, dtypes, conversion, the kernel backend's leaf rule
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tree_layout_and_conversion_bitwise(arch, dtype):
    """``init_lm`` builds the reference's tree (keys, shapes, dtypes: the
    float32 router, ``lam``, ``A_log``, ``D`` and ``dt_bias`` of a bf16
    model included), and a reference tree in that layout carries across
    bitwise."""
    jcfg = dataclasses.replace(jget(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    shapes = jax.eval_shape(lambda k: JT.init_lm(jcfg, k),
                            jax.random.PRNGKey(2))
    tp = T.init_lm(cfg, seed=3, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), tp) == \
        jax.tree.map(lambda a: (tuple(a.shape), "torch." + a.dtype.name),
                     shapes)
    # the reference's float32 params, cast leaf by leaf to that layout
    jp = jax.tree.map(lambda a, s: np.asarray(a).astype(s.dtype),
                      setup(arch)[2], shapes)
    cp = convert.params_from_jax(jp, device="cpu")
    jl, tl = jax.tree.leaves(jp), tree_leaves(cp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        view = np.uint16 if a.dtype.name == "bfloat16" else np.uint32
        bv = b.view(torch.int16 if b.dtype == torch.bfloat16
                    else torch.int32).numpy()
        np.testing.assert_array_equal(a.view(view), bv.view(view))


@pytest.mark.parametrize("arch", FAMILIES)
def test_quant_and_tables_bitwise_reference(arch):
    """``quant_unit_params`` marks the reference's matmul leaves (and only
    those: the experts, the router, every RG-LRU and SSD leaf stay
    ``bitflip`` leaves), carries its integers and scales, and the tables'
    corrupted blocks are bitwise the reference's."""
    jcfg, cfg, jp, *_, tp, _, _ = setup(arch)
    sm, jsm = T.LMStepModel(cfg, bits=8), JT.LMStepModel(jcfg, bits=8)
    want = MATMUL_LEAVES[arch]
    for i, (tq, jq) in enumerate(zip(sm.quant_unit_params(tp),
                                     jsm.quant_unit_params(jp))):
        a = tree_leaves(tq["block"])
        b = tree_leaves(convert.quant_params_from_jax(jq["block"],
                                                      device="cpu"))
        n = want[i % 3] if isinstance(want, tuple) else want
        assert len(a) == len(b) and sum(x.matmul for x in a) == n
        for x, y in zip(a, b):
            assert (x.matmul, x.bits, x.dtype) == (y.matmul, y.bits, y.dtype)
            assert torch.equal(x.qw, y.qw)
            assert torch.equal(_flush(x.scale), y.scale)
    rates = np.array([0.0, 0.1, 0.3], np.float32)
    jt = jsm.build_weight_fault_tables(jsm.unit_params(jp), rates,
                                       base_seed=4)
    tt = sm.build_weight_fault_tables(sm.unit_params(tp), rates, base_seed=4)
    for a, b in zip(tt, jt):
        for x, y in zip(tree_leaves(a["block"]), jax.tree.leaves(b["block"])):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# --------------------------------------------------------------------------
# steps and the whole forward against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_matches_reference_per_unit(arch, backend):
    """Every unit's step, fed the reference's input for that unit, with
    weight and activation faults (bits=8), under each backend's params:
    float (generic), resident QTensors (kernel) or one row of the tables."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup(arch)
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4)
    wr, ar = _rates(cfg.n_layers, 11)
    if backend == "generic":
        units = sm.unit_params(tp)
    elif backend == "kernel":
        units = sm.quant_unit_params(tp)
    else:       # row 1 of the tables: the block corrupted at rate 0.25
        units = [tree_map(lambda t: t[1:2], u)
                 for u in sm.build_weight_fault_tables(
                     sm.unit_params(tp), np.array([0.0, 0.25], np.float32),
                     base_seed=5)]
    want = _ref_steps(arch, backend == "tables")
    for i in range(cfg.n_layers):
        x_in = {"tokens": tb["tokens"][None]} if i == 0 else \
            torch.from_numpy(want[i - 1].copy())[None]
        w_arg = None if backend == "tables" else torch.tensor([wr[i]])
        with torch.no_grad():
            got = sm.step(i, units[i], x_in, w_arg, torch.tensor([ar[i]]),
                          5 + 7919 * i)[0]
        np.testing.assert_allclose(got.numpy(), want[i], atol=ATOL, rtol=0,
                                   err_msg=f"unit {i}")


_REF_STEPS = {}


def _ref_steps(arch, tables: bool) -> list:
    """The reference's unit outputs, each unit fed the previous one's
    (bits=8, 4 LSBs, rates ``_rates(L, 11)``, the weight rate 0.25 for the
    tables row), computed once for the generic and kernel cases."""
    if (arch, tables) not in _REF_STEPS:
        jcfg, cfg, jp, jb, *_ = setup(arch)
        jsm = JT.LMStepModel(jcfg, bits=8, faulty_bits=4)
        junits = jsm.unit_params(jp)
        wr, ar = _rates(cfg.n_layers, 11)
        out, x = [], jb
        for i in range(cfg.n_layers):
            x = jsm.step(i, junits[i], x,
                         jnp.float32(0.25 if tables else wr[i]),
                         jnp.float32(ar[i]), 5 + 7919 * i)
            out.append(_np(x))
        _REF_STEPS[(arch, tables)] = out
    return _REF_STEPS[(arch, tables)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_rows_match(arch):
    """The clean forward within ``ATOL`` of the reference's; under faults
    ``forward`` equals ``apply``, and an R-row ``apply`` gives in each row
    that row run alone, bitwise (kernel and generic params)."""
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup(arch)
    with torch.no_grad():
        np.testing.assert_allclose(T.forward(tp, cfg, tb).numpy(),
                                   _np(JT.forward(jp, jcfg, jb)), atol=ATOL,
                                   rtol=0)
    sm = T.LMStepModel(cfg, bits=8)
    g = torch.Generator().manual_seed(0)
    wr = torch.rand(3, cfg.n_layers, generator=g) * 0.3
    ar = torch.rand(3, cfg.n_layers, generator=g) * 0.3
    with torch.no_grad():
        for units in (sm.quant_unit_params(tp), sm.unit_params(tp)):
            many = sm.apply(units, tb, wr, ar, 9)
            for r in range(3):
                assert torch.equal(many[r], sm.apply(units, tb, wr[r], ar[r],
                                                     9))
        TL.set_fault_bits(8, 4)
        try:
            ft = T.forward(tp, cfg, tb, fault=(wr[1], ar[1], 9))
        finally:
            TL.set_fault_bits()
        assert torch.equal(ft, sm.apply(sm.unit_params(tp), tb, wr[1], ar[1],
                                        9))


@pytest.mark.parametrize("kind_arch", ["recurrentgemma-2b", "mamba2-2.7b"])
def test_tables_backend_on_recurrent_units(kind_arch):
    """The tables backend on units with no attention (``rglru``, ``ssd``):
    ``build_weight_fault_tables`` finds its device from any leaf of the
    unit, and a tables row is bitwise the generic backend at that rate."""
    _, cfg, *_, tp, tb, _ = setup(kind_arch)
    sm = T.LMStepModel(cfg, bits=8, faulty_bits=4)
    units = sm.unit_params(tp)
    kinds = [sm.unit_kind(i) for i in range(cfg.n_layers)]
    assert {"rglru", "ssd"} & set(kinds)
    tables = sm.build_weight_fault_tables(
        units, np.array([0.0, 0.2], np.float32), base_seed=6)
    x = {"tokens": tb["tokens"][None]}
    xt = xg = x
    with torch.no_grad():
        for i in range(cfg.n_layers):
            row = tree_map(lambda t: t[1:2], tables[i])
            xt = sm.step(i, row, xt, None, torch.tensor([0.1]),
                         6 + 7919 * i)
            xg = sm.step(i, units[i], xg, torch.tensor([0.2]),
                         torch.tensor([0.1]), 6 + 7919 * i)
            assert torch.equal(xt, xg), (i, kinds[i])


def test_recurrentgemma_masked_slot():
    """recurrentgemma-2b's 26 layers fill 9 groups of (rglru, rglru,
    local) but one slot: the reference builds params for the 27th slot and
    no unit runs it.  At 5 layers (2 groups, 6 slots) the port does the
    same: 6 slots built, 5 units, and the masked slot's params change
    nothing."""
    full, jfull = get_config("recurrentgemma-2b"), jget("recurrentgemma-2b")
    assert (full.n_groups * len(full.block_pattern), full.n_layers) == (27, 26)
    assert T.LMStepModel(full).n_units == JT.LMStepModel(jfull).n_units == 26
    jcfg, cfg, jp, jb, _, tp, tb, _ = setup("recurrentgemma-2b", n_layers=5)
    assert cfg.n_groups == 2 and T.LMStepModel(cfg).n_units == 5
    assert tp["groups"]["b2"]["attn"]["wq"].shape[0] == 2
    with torch.no_grad():
        got = T.forward(tp, cfg, tb)
        np.testing.assert_allclose(got.numpy(), _np(JT.forward(jp, jcfg, jb)),
                                   atol=ATOL, rtol=0)
        poked = tree_map(lambda t: t.clone(), tp)
        for leaf in tree_leaves(poked["groups"]["b2"]):
            leaf[1] = 7.0
        assert torch.equal(T.forward(poked, cfg, tb), got)


# --------------------------------------------------------------------------
# ΔAcc: against the reference, and the port's invariants
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("arch", FAMILIES)
def test_delta_acc_matches_reference(arch, bits):
    """Each backend within 1/(B·S) per row of the reference's (its pallas
    backend, which its tests hold bitwise to its generic and tables), and
    the port's three backends bitwise equal."""
    jcfg, cfg, jp, jb, jl, tp, tb, tl = setup(arch)
    P = population(cfg.n_layers)
    want = jmake(jcfg, jp, jb, jl, JFaultSpec(**SPECS[bits]), SCALE,
                 base_seed=3, fault_backend="pallas", eval_strategy="full",
                 devices=1).delta_acc(P)
    assert want.max() > 0 and len(np.unique(want)) >= 3, want
    got = {b: port_ev(cfg, tp, tb, tl, bits, b,
                      eval_strategy="full").delta_acc(P) for b in BACKENDS}
    np.testing.assert_allclose(got["kernel"], want, atol=TOL + 1e-9, rtol=0)
    for b in BACKENDS:
        np.testing.assert_array_equal(got[b], got["kernel"], err_msg=b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_staged_full_fused_bitwise(arch):
    """Staged (fused and unfused, chunks of 3 rows) against the whole
    forward (one row a chunk), kernel backend, on a population with shared
    prefixes: bitwise, and the staged walk saves unit runs."""
    _, cfg, *_, tp, tb, tl = setup(arch)
    P = population(cfg.n_layers, n=10, seed=1)
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


def test_lm_partitioner_recurrentgemma_staged_equals_full():
    """``lm_partitioner`` on reduced recurrentgemma-2b (kernel backend):
    staged and full evaluate the same rows to the same ΔAcc and give the
    same front, with every kernel's plain version called (the CPU's
    ``ops`` dispatch counts no launches)."""
    _, cfg, *_, tp, tb, tl = setup("recurrentgemma-2b")
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
    assert np.isfinite(plans["full"].front_objs).all()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-2b",
                                  "mamba2-2.7b"])
def test_bf16_families_backends_bitwise(arch):
    """The bf16 variants, as the card runs them: the three backends give
    bitwise the same ΔAcc (the kernel backend's ``bitflip`` now writes the
    bf16 leaves straight, the float32 leaves as float32), and the
    probe is not degenerate."""
    _, cfg, *_, tp, tb, tl = setup(arch, dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    P = population(cfg.n_layers, seed=2)
    got = {b: port_ev(cfg, tp, tb, tl, 8, b,
                      eval_strategy="full").delta_acc(P) for b in BACKENDS}
    assert got["kernel"].max() > 0 and len(np.unique(got["kernel"])) >= 3
    for b in BACKENDS:
        np.testing.assert_array_equal(got[b], got["kernel"], err_msg=b)
