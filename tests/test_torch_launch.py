"""The launch stack's host side against the reference, on the CPU:
``configs.input_specs`` / ``cells``, the spec trees of
``launch.shardings`` (every arch, ``mesh=None`` and a ``(16, 16)``
stand-in that has only the ``axis_names`` and ``devices`` the rules
read), ``shard_tree`` -> ``gather_tree``, the meshes, ``launch.roofline``,
``train.compression.compress_psum`` against the reference's under
``jax.vmap(axis_name=...)``, and ``python -m repro_torch.launch.train``
against ``repro.launch.train``.

Tolerances: every spec, shape, dtype and count equal; ``shard_tree`` ->
``gather_tree`` and ``compress_psum`` (1, 2 and 4 ranks, three calls so
the error feedback carries) bitwise; ``model_flops`` and
``roofline_terms`` equal; the training CLI's per-step losses within 1e-5
relative of the reference's (``test_torch_train.py``'s ``Trainer``
bound), from the same params.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as JRF  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.models.transformer import init_lm as jinit  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_flatten_with_path, tree_leaves  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, cells, get_config,  # noqa: E402
                                 input_specs)
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline as TRF  # noqa: E402
from repro_torch.launch import shardings as TSH  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.train import compression as TC  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Grid:
    """What the sharding rules read of a mesh: its axis names and the shape
    of its device grid (the production mesh's 16 x 16)."""

    axis_names = ("data", "model")
    devices = np.empty((16, 16), dtype=object)


def _specs(tree):
    """``{path: tuple}`` of a spec tree of either package."""
    from jax.sharding import PartitionSpec
    out = {}

    def rec(t, path):
        if isinstance(t, (TSH.P, PartitionSpec)):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k in t:
                rec(t[k], path + (str(k),))
        else:
            for i, v in enumerate(t):
                rec(v, path + (str(i),))
    rec(tree, ())
    return out


# --------------------------------------------------------------------------
# configs, specs, meshes, roofline
# --------------------------------------------------------------------------
def test_input_specs_and_cells_match_reference():
    assert cells() == JR.cells() and cells(True) == JR.cells(True)
    assert list(SHAPES) == list(JSHAPES)
    for aid in ARCH_IDS:
        for name in SHAPES:
            got = input_specs(get_config(aid), SHAPES[name])
            want = JR.input_specs(JR.get_config(aid), JSHAPES[name])
            assert got.keys() == want.keys(), (aid, name)
            for k, w in want.items():
                g = got[k]
                assert g.device.type == "meta"
                assert tuple(g.shape) == w.shape, (aid, name, k)
                assert str(g.dtype).split(".")[-1] == str(w.dtype), \
                    (aid, name, k)


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_spec_trees_match_reference(aid):
    cfg, jcfg = get_config(aid), JR.get_config(aid)
    params = abstract_params(cfg)
    jparams = jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0)))
    assert {tuple(map(str, p)): (tuple(v.shape), str(v.dtype).split(".")[-1])
            for p, v in tree_flatten_with_path(params)[0]} == \
        {tuple(str(k.key) for k in p): (v.shape, str(v.dtype))
         for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for mesh in (None, _Grid()):
        ps = TSH.param_specs(params, mesh)
        jps = JSH.param_specs(jparams, mesh)
        assert _specs(ps) == _specs(jps)
        assert _specs(TSH.opt_state_specs(ps)) == \
            _specs(JSH.opt_state_specs(jps))
    for name in SHAPES:
        for mp in (False, True):
            assert _specs(TSH.batch_specs(cfg, SHAPES[name], multi_pod=mp)) \
                == _specs(JSH.batch_specs(jcfg, JSHAPES[name], multi_pod=mp))
            assert _specs(TSH.cache_pspecs(cfg, SHAPES[name], multi_pod=mp)) \
                == _specs(JSH.cache_pspecs(jcfg, JSHAPES[name],
                                           multi_pod=mp))
    assert TSH.P(None, "data") == (None, "data") and TSH.P() == ()


def _tree(rng):
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return {"a": f(4, 6, 2), "b": [f(8), torch.from_numpy(
        rng.integers(-9, 9, (2, 4, 4)).astype(np.int32))],
        "c": {"d": f(4, 4).to(torch.bfloat16)}}


@pytest.mark.parametrize("shape,axes,specs", [
    ((2, 2), ("data", "model"),
     {"a": TSH.P("data", "model"), "b": [TSH.P("model"), TSH.P(None, "data",
                                                              "model")],
      "c": {"d": TSH.P()}}),
    ((2, 2, 2), ("pod", "data", "model"),
     {"a": TSH.P(("pod", "data"), None, "model"), "b": [TSH.P(("pod", "model",
                                                                "data")),
                                                        TSH.P("pod")],
      "c": {"d": TSH.P(None, ("data", "model"))}}),
])
def test_shard_then_gather_is_bitwise(shape, axes, specs):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    mesh = TM.make_test_mesh(shape, axes, pool=[CPU] * 8)
    placed = TSH.shard_tree(tree, specs, mesh)
    assert len(placed) == mesh.size
    # slot (0, 1) of the 2-d mesh holds a's rows 0-1, columns 3-5
    if len(shape) == 2:
        assert torch.equal(placed[1]["a"], tree["a"][:2, 3:])
    back = TSH.gather_tree(placed, specs, mesh)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="does not split"):
        TSH.shard_tree({"x": torch.zeros(3)}, {"x": TSH.P("data")}, mesh)


def test_meshes_need_a_card_or_a_pool(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (TM.local_devices, TM.make_test_mesh,
                 TM.make_production_mesh, lambda: TM.make_eval_mesh(1)):
        with pytest.raises(RuntimeError, match="pass a pool"):
            call()
    with pytest.raises(ValueError, match="needs 256 devices, the pool "
                                         "holds 4"):
        TM.make_production_mesh(pool=[CPU] * 4)
    m = TM.make_production_mesh(multi_pod=True, pool=[CPU] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    t = TM.make_test_mesh((2, 3), pool=[CPU] * 6)
    assert TM.mesh_axes(t) == ("data", "model") and t.devices.shape == (2, 3)


def test_roofline_matches_reference():
    for aid in ARCH_IDS:
        for name in SHAPES:
            assert TRF.model_flops(get_config(aid), SHAPES[name]) == \
                JRF.model_flops(JR.get_config(aid), JSHAPES[name])
    rec = {"n_chips": 256, "flops": 3e18, "bytes_accessed": 5e14,
           "collective_bytes": 2e13}
    assert TRF.roofline_terms(rec, peak_flops=JRF.PEAK_FLOPS,
                              hbm_bw=JRF.HBM_BW, link_bw=JRF.LINK_BW) \
        == JRF.roofline_terms(rec)
    # the defaults are the card's (H100 SXM), not the TPU's
    assert (TRF.PEAK_FLOPS, TRF.HBM_BW, TRF.LINK_BW) == (989e12, 3.35e12,
                                                         450e9)
    r = TRF.roofline_terms(rec)
    assert r["compute_s"] == 3e18 / (256 * 989e12)


# --------------------------------------------------------------------------
# compress_psum
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 4])
def test_compress_psum_bitwise(n):
    rng = np.random.default_rng(n)

    def grads(scale):
        return {"w": (rng.standard_normal((n, 6, 5)) * scale).astype(
            np.float32),
            "b": (rng.standard_normal((n, 7)) * scale).astype(np.float32),
            "h": jnp.asarray(rng.standard_normal((n, 3, 4)) * scale,
                             jnp.bfloat16)}

    jfn = jax.vmap(lambda g, e: JC.compress_psum(g, e, "i"), axis_name="i")
    g0 = grads(1.0)
    je = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), g0)
    te = [convert.params_from_jax(jax.tree.map(lambda a: np.asarray(a[i]), je),
                                  device="cpu") for i in range(n)]
    for call, scale in enumerate((1.0, 1e-3, 30.0)):
        g = g0 if call == 0 else grads(scale)
        jmean, je = jfn(g, je)
        tg = [convert.params_from_jax(jax.tree.map(
            lambda a: np.asarray(a[i]), g), device="cpu") for i in range(n)]
        tmean, te = TC.compress_psum(tg, te)
        for i in range(n):
            for name in ("w", "b", "h"):
                for got, want in ((tmean[i][name], jmean[name][i]),
                                  (te[i][name], je[name][i])):
                    want = np.asarray(jnp.asarray(want, jnp.float32))
                    assert np.array_equal(got.float().numpy().view(np.int32),
                                          want.view(np.int32)), (call, i, name)
            assert tmean[i]["h"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the training CLI
# --------------------------------------------------------------------------
def test_train_cli_matches_reference(monkeypatch, tmp_path, capsys):
    """``main(["--arch", "olmo-1b", "--steps", "3", "--device", "cpu"])``
    against the reference's ``main`` with the same flags, both Trainers
    starting from the reference's ``init_lm(PRNGKey(0))`` params."""
    from repro.launch import train as jtrain
    from repro.train import trainer as jtrainer
    from repro_torch.launch import train as ttrain
    from repro_torch.train import trainer as ttrainer

    jhist = []
    real_run = jtrainer.Trainer.run

    def run(self, *a, **k):
        jhist.extend(real_run(self, *a, **k))
        return jhist

    monkeypatch.setattr(jtrainer.Trainer, "run", run)
    flags = ["--arch", "olmo-1b", "--steps", "3", "--seq", "16", "--batch",
             "4"]
    monkeypatch.setattr(sys, "argv", ["train"] + flags + [
        "--ckpt-dir", str(tmp_path / "ref")])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()

    def params_of_reference(cfg, seed=0, device="cuda"):
        jcfg = JR.get_config("olmo-1b").reduced()
        return convert.params_from_jax(jax.tree.map(
            np.asarray, jinit(jcfg, jax.random.PRNGKey(seed))), device=device)

    monkeypatch.setattr(ttrainer, "init_lm", params_of_reference)
    hist = ttrain.main(flags + ["--ckpt-dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] and got[-1].startswith("loss: ")
    assert len(hist) == len(jhist) == 3
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
