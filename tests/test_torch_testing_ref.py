"""``repro_torch.testing``: the per-individual ΔAcc loop
(``reference.loop_delta_acc``, one dispatch and one host read a row) and
the ``lm_harness`` name, against the port's batched engines and the
reference's ``repro.testing``, on the CPU.

reduced olmo-1b, B=2, S=16, bits 16 with 10 faulty (where ΔAcc spreads at
this size, as in ``tests/test_torch_lm_objectives.py``), the reference's
params carried across: the loop BITWISE the port's batched ``delta_acc``
under every fault backend and both strategies, and within 1/(B·S) per row
of the reference's ``loop_delta_acc`` (an fp32 sum in another order than
XLA's can move one token).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.objectives import make_lm_accuracy_evaluator as jmake  # noqa: E402
from repro.testing.lm_harness import lm_calibration_setup as jsetup  # noqa: E402
from repro.testing.reference import loop_delta_acc as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FaultSpec, make_lm_accuracy_evaluator  # noqa: E402
from repro_torch.lm_setup import lm_calibration_setup  # noqa: E402
from repro_torch.testing import lm_harness  # noqa: E402
from repro_torch.testing.reference import loop_delta_acc  # noqa: E402

B, S = 2, 16
SCALE = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
SPEC = dict(bits=16, faulty_bits=10, weight_fault_rate=0.2,
            act_fault_rate=0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def olmo():
    jcfg = jget("olmo-1b").reduced()
    cfg = get_config("olmo-1b").reduced()
    jp, jb, jl = jsetup(jcfg, B=B, S=S)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tb = {"tokens": torch.from_numpy(np.array(jb["tokens"]))}
    tl = torch.from_numpy(np.array(jl))
    P = np.random.default_rng(0).integers(0, len(SCALE),
                                          size=(6, cfg.n_layers))
    P[3:, :cfg.n_layers // 2] = P[0, :cfg.n_layers // 2]
    ev = jmake(jcfg, jp, jb, jl, JFaultSpec(**SPEC), SCALE, base_seed=3,
               eval_strategy="full", devices=1)
    return cfg, tp, tb, tl, P, jloop(ev, P)


@pytest.mark.parametrize("strategy", ["full", "staged"])
@pytest.mark.parametrize("backend", ["generic", "tables", "kernel"])
def test_loop_delta_acc_is_the_batched_delta_acc(olmo, backend, strategy):
    cfg, tp, tb, tl, P, want = olmo
    ev = make_lm_accuracy_evaluator(
        cfg, tp, tb, tl, FaultSpec(**SPEC), SCALE, base_seed=3,
        fault_backend=backend, eval_strategy=strategy, device="cpu")
    loop = loop_delta_acc(ev, P)
    assert loop.shape == (len(P),) and loop.dtype == np.float64
    np.testing.assert_array_equal(loop, ev.delta_acc(P))
    assert want.max() > 0 and len(np.unique(want)) >= 3, want
    np.testing.assert_allclose(loop, want, atol=1.0 / (B * S) + 1e-9, rtol=0)


def test_lm_harness_is_lm_setup():
    assert lm_harness.lm_calibration_setup is lm_calibration_setup
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=2)
    params, batch, labels = lm_harness.lm_calibration_setup(
        cfg, B=B, S=S, device="cpu")
    assert batch["tokens"].shape == labels.shape == (B, S)
