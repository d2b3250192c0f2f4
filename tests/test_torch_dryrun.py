"""The dry run on meta tensors (``repro_torch.launch.dryrun``) against the
reference's sharding rules, on the CPU: one slot's argument bytes against
the same sum over the reference's ``param_specs`` / ``opt_state_specs``
of ``jax.eval_shape(init_lm)`` with a stand-in ``(16, 16)`` mesh (an
object with ``axis_names`` and ``devices``: all ``_divisible`` reads); the
2- and 4-group extrapolation against a direct count at a third depth
(exact: every group runs the same ops on the same shapes); the
collectives' counter against a hand count; the CLI's record keys (the
reference's ``run_cell`` record's); the overrides.  The reference's
``dryrun`` module is never imported (it sets ``XLA_FLAGS`` for 512
devices at import).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.shardings import opt_state_specs as j_ospecs  # noqa: E402
from repro.launch.shardings import param_specs as j_pspecs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import collectives as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402

META = torch.device("meta")
CPU = torch.device("cpu")
# the keys of the reference's record (src/repro/launch/dryrun.py, run_cell)
RECORD_KEYS = {"arch", "shape", "multi_pod", "status", "n_chips", "n_groups",
               "flops", "bytes_accessed", "collective_bytes", "memory",
               "compile_s", "probe_compile_s", "probes", "roofline",
               "model_flops", "useful_flop_ratio", "overrides"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StandIn:
    axis_names = ("data", "model")
    devices = np.empty((16, 16))


def _local(shape, spec, sizes) -> int:
    n = 1
    for d, dim in enumerate(shape):
        ax = tuple(spec)[d] if d < len(tuple(spec)) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n *= dim // int(np.prod([sizes[a] for a in axes]))
    return n


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-2.7b"])
def test_argument_bytes_match_reference_specs(arch):
    """olmo-1b (vocab 50304 splits 16 ways) and mamba2-2.7b (50280 does
    not: its embedding stays whole over "model") on train_4k."""
    jc = jget(arch)
    params = jax.eval_shape(lambda: JT.init_lm(jc, jax.random.PRNGKey(0)))
    pspec = j_pspecs(params, _StandIn())
    sizes = {"data": 16, "model": 16}
    flat = jax.tree.leaves(params)
    specs = jax.tree.leaves(pspec, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    counts = [_local(p.shape, s, sizes) for p, s in zip(flat, specs)]
    mdt = 2 if jc.param_count() > 1e11 else 4
    want = sum(c * p.dtype.itemsize for c, p in zip(counts, flat))
    want += 2 * mdt * sum(counts) + 4                   # m, v, step
    assert tuple(j_ospecs(pspec)["step"]) == ()
    shape = SHAPES["train_4k"]
    want += 2 * (shape.global_batch // 16) * shape.seq_len * 4  # tokens, labels
    mesh = TM.make_production_mesh(pool=[META] * 256)
    _, arg, out = D._cell(get_config(arch), shape, mesh, False, {})
    assert arg == want
    assert out == want - 2 * (shape.global_batch // 16) * shape.seq_len * 4


def _small(monkeypatch, cfg):
    """``run_cell`` on ``cfg`` over a (2, 2), or (2, 1, 2) multi-pod, mesh
    of meta devices in place of the production mesh."""
    monkeypatch.setattr(D, "get_config", lambda arch: cfg)
    monkeypatch.setattr(
        D, "make_production_mesh", lambda multi_pod=False, pool=None:
        TM.make_test_mesh((2, 1, 2) if multi_pod else (2, 2),
                          ("pod", "data", "model") if multi_pod
                          else ("data", "model"),
                          pool=[META] * 4))


def test_extrapolation_equals_direct_count(monkeypatch):
    """A 3-group olmo on a (2, 2) meta mesh: the record's FLOPs, bytes and
    collective bytes (from the 2- and 4-group probes) equal a direct count
    at 3 groups."""
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=3)
    _small(monkeypatch, cfg)
    mesh = TM.make_test_mesh((2, 2), pool=[META] * 4)
    rec = D.run_cell("olmo-1b", "train_4k", save=False)
    C.reset_bytes()
    flops, nbytes, coll, _ = D._cell(cfg, SHAPES["train_4k"], mesh, False,
                                     {})[0]()
    assert rec["n_groups"] == 3 and rec["n_chips"] == 4
    np.testing.assert_allclose(rec["flops"], flops, rtol=1e-12)
    np.testing.assert_allclose(rec["bytes_accessed"], nbytes, rtol=1e-12)
    np.testing.assert_allclose(rec["collective_bytes"], coll, rtol=1e-12)
    assert rec["flops"] > 0 and coll > 0
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]


def test_cli_writes_the_reference_record(monkeypatch, tmp_path):
    """``main`` with the reduced olmo on a (2, 2) meta mesh for the
    production one: a record with the reference's keys, the roofline's
    terms, and the multi-pod serve and pipelined train cells on a
    (2, 1, 2) mesh."""
    _small(monkeypatch, get_config("olmo-1b").reduced())
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "olmo-1b", "--shape", "train_4k", "--out",
                str(tmp_path)])
    assert e.value.code == 0
    rec = json.load(open(os.path.join(tmp_path, "olmo-1b_train_4k_sp.json")))
    assert set(rec) == RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert rec["status"] == "ok" and set(rec["probes"]) == {"2", "4"}
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    for shape in ("decode_32k", "train_4k"):
        rec = D.run_cell("olmo-1b", shape, multi_pod=True, save=False)
        assert rec["status"] == "ok" and rec["n_chips"] == 4, shape
        assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0


def test_overrides_refused_by_name():
    for name in ("causal_skip", "attn_bf16", "block_seq"):
        with pytest.raises(ValueError, match=name):
            D.run_cell("olmo-1b", "train_4k", save=False,
                       overrides={name: True})
    with pytest.raises(ValueError, match="unknown override"):
        D.run_cell("olmo-1b", "train_4k", save=False, overrides={"hlo": True})


def test_collective_bytes_hand_count():
    """One all-gather of two [3, 4] float32 pieces to both slots: 2 x 96
    output bytes; one all-reduce of two [5] bf16 inputs: 2 x (2 x 10)
    bytes, the sum in fp32, slot order, rounded once; a reduce-scatter of
    two [2, 4] float32 inputs: their 64 input bytes; one slot moves
    nothing."""
    C.reset_bytes()
    a, b = torch.ones(3, 4), torch.full((3, 4), 2.0)
    out = C.all_gather([a, b], 0, [CPU, CPU])
    assert C.BYTES["all_gather"] == 2 * 6 * 4 * 4
    assert all(torch.equal(o, torch.cat([a, b])) for o in out)
    x = torch.tensor([1.0, 2 ** -9, 3, 4, 5], dtype=torch.bfloat16)
    y = torch.tensor([1.0, 2 ** -9, 0, 0, 0], dtype=torch.bfloat16)
    (s,) = C.all_reduce([x, y], [CPU])
    assert C.BYTES["all_reduce"] == 2 * (2 * 5 * 2)
    assert torch.equal(s, (x.float() + y.float()).to(torch.bfloat16))
    assert C.total_bytes() == 192 + 40
    C.all_reduce([x], [CPU])
    C.all_gather([a], 0, [CPU])
    assert C.total_bytes() == 232
    rs = C.reduce_scatter([a[:2], b[:2]], 0, [CPU, CPU])
    assert C.BYTES["reduce_scatter"] == 2 * 2 * 4 * 4
    assert all(torch.equal(r, torch.full((1, 4), 3.0)) for r in rs)
    u, v = torch.arange(4.0).reshape(2, 2), torch.arange(4.0, 8).reshape(2, 2)
    t = C.all_to_all([u, v], 0, 1, [CPU, CPU])
    assert C.BYTES["all_to_all"] == 2 * 4 * 4
    assert torch.equal(t[0], torch.tensor([[0.0, 1, 4, 5]]))
    assert torch.equal(t[1], torch.tensor([[2.0, 3, 6, 7]]))
