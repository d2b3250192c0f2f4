"""The port's LM ΔAcc evaluator (``core.objectives.make_lm_accuracy_evaluator``)
and ``core.partitioner.lm_partitioner`` against the reference, at the
``reduced()`` configs of olmo-1b, starcoder2-3b, gemma2-27b and
phi-3-vision-4.2b (B=2, S=16, the reference's params carried across).

Tolerance: per-row ΔAcc within 1/(B·S) = 1/32 of the reference, at bits=8
(4 LSBs, the reference replay's regime) and bits=16 (10 LSBs: at 4 LSBs a
16-bit fault moves no token at this scale, and the check would be vacuous).
A row can move by one token when an fp32 sum, taken in another order than
XLA's, crosses a rounding boundary of the fixed-point activations.  Within
the port the generic, tables and kernel backends, the staged and full
strategies, and fused and unfused staged walks agree BITWISE.  Each probe is
asserted to be working (labels spread over many tokens, ΔAcc spread over
the rows) before it is used.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.nsga2 import NSGA2Config as JNSGA2Config  # noqa: E402
from repro.core.objectives import make_lm_accuracy_evaluator as jmake  # noqa: E402
from repro.core.partitioner import lm_partitioner as jlm_partitioner  # noqa: E402
from repro.testing.lm_harness import lm_calibration_setup as jsetup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (POD_TIERS_4, FaultSpec,  # noqa: E402
                              NSGA2Config, lm_partitioner,
                              make_lm_accuracy_evaluator)
from repro_torch.kernels import ops  # noqa: E402

DENSE = ["olmo-1b", "starcoder2-3b", "gemma2-27b", "phi-3-vision-4.2b"]
B, S = 2, 16
TOL = 1.0 / (B * S)
SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
SPECS = {8: dict(bits=8, faulty_bits=4, weight_fault_rate=0.2,
                 act_fault_rate=0.2),
         16: dict(bits=16, faulty_bits=10, weight_fault_rate=0.2,
                  act_fault_rate=0.2)}
BACKENDS = ("generic", "tables", "kernel")
J_BACKEND = {"generic": "generic", "tables": "tables", "kernel": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def setup(arch, dtype="float32", **cfg_kw):
    key = (arch, dtype, tuple(sorted(cfg_kw.items())))
    if key not in _SETUPS:
        jcfg = dataclasses.replace(jget(arch).reduced(), dtype=dtype, **cfg_kw)
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                  **cfg_kw)
        jp, jb, jl = jsetup(jcfg, B=B, S=S)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        tb = {"tokens": torch.from_numpy(np.array(jb["tokens"]))}
        tl = torch.from_numpy(np.array(jl))
        assert len(torch.unique(tl)) >= 8, "degenerate self-labels"
        _SETUPS[key] = (jcfg, cfg, jp, jb, jl, tp, tb, tl)
    return _SETUPS[key]


def population(L, n=8, seed=0):
    P = np.random.default_rng(seed).integers(0, len(SCALE), size=(n, L))
    P[n // 2:, :L // 2] = P[0, :L // 2]            # shared prefixes
    return P


def port_ev(cfg, tp, tb, tl, bits, backend, **kw):
    return make_lm_accuracy_evaluator(cfg, tp, tb, tl,
                                      FaultSpec(**SPECS[bits]), SCALE,
                                      base_seed=3, fault_backend=backend,
                                      device="cpu", **kw)


def ref_delta(arch, bits, backend, P, dtype="float32"):
    jcfg, _, jp, jb, jl, *_ = setup(arch, dtype)
    ev = jmake(jcfg, jp, jb, jl, JFaultSpec(**SPECS[bits]), SCALE,
               base_seed=3, fault_backend=J_BACKEND[backend],
               eval_strategy="full", devices=1)
    return ev.delta_acc(P)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("arch", DENSE)
def test_delta_acc_matches_reference(arch, bits):
    """Each backend within 1/(B·S) per row of the reference's (the
    reference's pallas, which its own tests hold bitwise to its generic and
    tables; olmo-1b also against each reference backend by name), and the
    port's three backends bitwise equal."""
    _, cfg, *_, tp, tb, tl = setup(arch)
    P = population(cfg.n_layers)
    want = ref_delta(arch, bits, "kernel", P)
    assert want.max() > 0 and len(np.unique(want)) >= 3, want
    got = {}
    for backend in BACKENDS:
        got[backend] = port_ev(cfg, tp, tb, tl, bits, backend,
                               eval_strategy="full").delta_acc(P)
        ref = want if arch != "olmo-1b" or backend == "kernel" \
            else ref_delta(arch, bits, backend, P)
        np.testing.assert_allclose(got[backend], ref, atol=TOL + 1e-9,
                                   rtol=0, err_msg=backend)
    for backend in BACKENDS:
        np.testing.assert_array_equal(got[backend], got["kernel"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_full_fused_bitwise(backend):
    """Staged (fused and unfused, chunks of 3 rows) against the whole
    forward (one row a chunk), on a 4-layer reduced starcoder2-3b with
    shared prefixes: bitwise, and the staged walk saves unit runs."""
    _, cfg, *_, tp, tb, tl = setup("starcoder2-3b", n_layers=4)
    P = population(4, n=10, seed=1)
    res = {}
    for strategy, fuse, ebs in (("full", True, 1), ("staged", False, 3),
                                ("staged", True, 3)):
        ev = port_ev(cfg, tp, tb, tl, 8, backend, eval_strategy=strategy,
                     fuse_chains=fuse, eval_batch_size=ebs)
        ops.reset_launches()
        res[(strategy, fuse)] = ev.delta_acc(P)
        if strategy == "staged":
            assert ev.staged_stats()["unit_runs_avoided"] > 0
    assert len(np.unique(res[("full", True)])) >= 3
    for key, v in res.items():
        np.testing.assert_array_equal(v, res[("full", True)], err_msg=str(key))


def test_lm_partitioner_staged_equals_full():
    """``lm_partitioner`` with the port's evaluator (kernel backend) runs
    the search end to end; staged and full give the same rows and front."""
    _, cfg, *_, tp, tb, tl = setup("olmo-1b")
    scale = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)
    plans, rows = {}, {}
    for strategy in ("staged", "full"):
        ev = make_lm_accuracy_evaluator(cfg, tp, tb, tl, FaultSpec(bits=8),
                                        scale, fault_backend="kernel",
                                        device="cpu")
        plan = lm_partitioner(cfg, ev, fault_backend="kernel",
                              eval_strategy=strategy,
                              nsga2_config=NSGA2Config(population=8,
                                                       generations=2))
        plans[strategy] = plan.optimize()
        rows[strategy] = dict(ev._cache)
        assert ev.eval_strategy == strategy
    a, b = plans["staged"], plans["full"]
    assert rows["staged"] == rows["full"]
    np.testing.assert_array_equal(a.front, b.front)
    np.testing.assert_array_equal(a.front_objs, b.front_objs)
    assert np.isfinite(a.front_objs).all() and a.front_objs[:, 2].max() > 0


def test_surrogate_plan_matches_reference():
    """deepseek-coder-33b is too large to instantiate: ``lm_partitioner``
    without an evaluator runs the sensitivity surrogate over the layer
    graph, numpy only, and gives the reference's plan exactly."""
    cfg, jcfg = get_config("deepseek-coder-33b"), jget("deepseek-coder-33b")
    plan = lm_partitioner(cfg, nsga2_config=NSGA2Config(
        population=16, generations=4, seed=2)).optimize()
    want = jlm_partitioner(jcfg, nsga2_config=JNSGA2Config(
        population=16, generations=4, seed=2)).optimize()
    np.testing.assert_array_equal(plan.partition, want.partition)
    np.testing.assert_array_equal(plan.front, want.front)
    np.testing.assert_array_equal(plan.front_objs, want.front_objs)
    assert (plan.latency, plan.energy, plan.delta_acc, plan.evaluations) == \
        (want.latency, want.energy, want.delta_acc, want.evaluations)


def test_bf16_olmo_delta_acc_agreement():
    """The bf16 variant of reduced olmo-1b at bits=8 over 8 rows, within
    2/(B·S) a row, not the 1/(B·S) of float32.  The port's products are
    XLA's CPU dot bitwise and its steps bitwise the reference's op-by-op
    steps (test_torch_transformer.py), but the reference's evaluator runs
    compiled, and there XLA drops the bf16 rounding of a residual sum
    where it feeds the next norm, which the op-by-op steps (and the port)
    do not: 57% of a compiled unit's outputs differ from the same unit run
    op by op (checked by test_torch_transformer.py::
    test_bf16_olmo_compiled_step_differs_from_op_by_op).  So rows cross
    other fixed-point boundaries.  Measured: the
    port's three backends are bitwise equal; against the reference four of
    the eight rows differ, three by one token (1/32) and one by two (2/32
    = 2/(B·S)), which is the bound asserted."""
    _, cfg, *_, tp, tb, tl = setup("olmo-1b", "bfloat16")
    P = population(cfg.n_layers, n=8, seed=4)
    want = ref_delta("olmo-1b", 8, "kernel", P, "bfloat16")
    assert want.max() > 0
    got = {b: port_ev(cfg, tp, tb, tl, 8, b, eval_strategy="full")
           .delta_acc(P) for b in BACKENDS}
    for b in BACKENDS:
        np.testing.assert_array_equal(got[b], got["kernel"])
    np.testing.assert_allclose(got["kernel"], want, atol=2 * TOL + 1e-9,
                               rtol=0)
