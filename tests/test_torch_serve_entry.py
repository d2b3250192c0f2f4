"""``repro_torch.serve_fault_resilient`` (the online-phase entry point)
beside the reference's ``examples/serve_fault_resilient.py``, run by its
own ``main`` on the CPU: the deployed plan, θ, every reconfiguration event
(its step, old and new maps, observed and predicted ΔAcc) and the
engine's swaps (step, kind, partitions, ΔAcc before and after, layers
migrated) equal, and the printout the same line for line but for the
swap's measured stall.  The port's model gets the reference's params
(``convert.params_from_jax``), so both serve the same tokens, which are
compared too.
"""
import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch import convert, serve_fault_resilient  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "examples", "serve_fault_resilient.py")


def _reference(monkeypatch):
    """Run the example's ``main`` and keep what it built: the plan, the
    reconfigurator, the engine and the params."""
    spec = importlib.util.spec_from_file_location("_example_serve", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    made = {}

    class Part(mod.AFarePart):
        def optimize(self):
            made["plan"] = super().optimize()
            return made["plan"]

    class Rec(mod.OnlineReconfigurator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made["rec"] = self

    class Eng(mod.Engine):
        def __init__(self, cfg, params, *a, **k):
            super().__init__(cfg, params, *a, **k)
            made["eng"], made["params"] = self, params

        def generate(self, requests):
            made["requests"] = requests
            return super().generate(requests)

    monkeypatch.setattr(mod, "AFarePart", Part)
    monkeypatch.setattr(mod, "OnlineReconfigurator", Rec)
    monkeypatch.setattr(mod, "Engine", Eng)
    mod.main()
    return made


def _swap(e):
    return (e["step"], e["kind"], e["pre_delta"], e["post_delta"],
            tuple(e["old_partition"]), tuple(e["new_partition"]),
            e["migrated_layers"])


def _lines(text):
    return [re.sub(r"'stall_s': [^,]*,", "", line)
            for line in text.splitlines()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_fault_resilient_matches_example(monkeypatch, capsys):
    ref = _reference(monkeypatch)
    want_out = capsys.readouterr().out
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref["params"]),
                                     device="cpu")
    monkeypatch.setattr(serve_fault_resilient, "init_lm",
                        lambda cfg, seed, device: params)
    got = serve_fault_resilient.main(["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert np.array_equal(got["plan"].partition, ref["plan"].partition)
    assert got["theta"] == pytest.approx(ref["rec"].theta, rel=0, abs=0)
    assert len(got["events"]) == len(ref["rec"].events) >= 1
    for a, b in zip(got["events"], ref["rec"].events):
        assert a.step == b.step
        assert np.array_equal(a.old_partition, b.old_partition)
        assert np.array_equal(a.new_partition, b.new_partition)
        assert a.observed_delta_acc == b.observed_delta_acc
        assert a.new_predicted_delta_acc == b.new_predicted_delta_acc
    assert [_swap(e) for e in got["swap_events"]] == \
        [_swap(e) for e in ref["eng"].swap_events]
    assert _lines(got_out) == _lines(want_out)
    assert [list(r.out) for r in got["requests"]] == \
        [list(r.out) for r in ref["requests"]]


def test_serve_fault_resilient_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_fault_resilient.main([])
