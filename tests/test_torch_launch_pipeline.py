"""The launch stack's training side against the reference, on the CPU:
``stage_stack``, ``_stage_forward``, the GPipe loss and its gradients
(``make_pp_loss``) and one ``abstract_pp_train_step`` update against the
reference's on a ``(1, 1, 1)`` mesh of ``Auto`` axes (jax 0.9's default
``Explicit`` axes refuse the reference's ``with_sharding_constraint``),
the port running over pools of ``[cpu] * n``; and the data-parallel
``abstract_train_step`` against ``make_train_step``.  Params come from the
reference through ``repro_torch.convert``, inputs from a numpy seed,
``reduced()`` configs in float32 at ``tests/test_torch_train.py``'s sizes.

Tolerances:
  * ``stage_stack``: bitwise;
  * ``_stage_forward``: within ``ATOL`` = 1e-5 (``test_torch_decode.py``'s
    for a block stack: the LayerNorm's mean and the attention's sums run in
    another order than XLA's; measured at most 3.1e-6);
  * the pipeline's loss within rtol 2e-6 and its gradients within atol
    1e-6 of the reference's (``test_torch_train.py``'s for
    ``make_loss_fn``), the loss against the port's own ``make_loss_fn``
    within rtol 2e-6 too (measured: the loss bitwise at the uneven cut,
    the gradients at most 4.8e-7 off);
  * one pipelined AdamW step: the loss, grad norm and lr within 1e-5
    relative, params within 2 lr + 4 ulps (AdamW's first step moves a
    param by lr·sign(g); a grad at rounding level may take the other
    sign), moments within 2e-5 of their leaf's largest
    (``test_torch_train.py``'s step bounds);
  * ``abstract_train_step`` on ``data=2`` against ``make_train_step(
    microbatches=2)``: bitwise (the same sums in the same order); on
    ``model=2`` the loss within 1e-6 of the reference's and the update
    within 2 lr of the unsharded step's (AdamW's first step moves a param
    by about lr·sign(g)).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.partitioner import contiguous_stages as jstages  # noqa: E402
from repro.launch import pipeline as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import (tree_flatten_with_path, tree_leaves,  # noqa: E402
                               tree_map)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import pipeline as TP  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

CPU = torch.device("cpu")
B, S = 2, 16
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    if jc.is_moe:
        kw = dict(kw, moe_capacity_factor=0.0)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _params(jc, seed=1):
    jp = JT.init_lm(jc, jax.random.PRNGKey(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.is_floating_point() \
            else a.numpy()
    return np.asarray(a)


def _by_path(tree):
    """``{path strings: numpy}`` of a reference or port tree."""
    if isinstance(tree, dict) and tree and any(
            isinstance(v, torch.Tensor) for v in tree_leaves(tree)):
        return {tuple(map(str, p)): _np(v)
                for p, v in tree_flatten_with_path(tree)[0]}
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(
                tree)[0]}


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _jmesh():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)


def _pod_mesh(n):
    return TM.make_test_mesh((n, 1, 1), ("pod", "data", "model"),
                             pool=[CPU] * n)


@pytest.mark.parametrize("cuts", [[0, 1, 2], [0, 2, 6], [0, 1, 3, 4]])
def test_stage_stack_bitwise(cuts):
    jc, tc = _configs("olmo-1b", n_layers=cuts[-1])
    jp, tp = _params(jc)
    jst, jlens = JP.stage_stack(jp["groups"], cuts)
    tst, tlens = TP.stage_stack(tp["groups"], cuts)
    assert tlens == jlens
    want = _by_path(jst)
    for path, got in _by_path(tst).items():
        np.testing.assert_array_equal(got, want[path])
    mesh = _pod_mesh(len(cuts) - 1)
    specs = TP.stage_param_specs(tst, mesh)
    assert {p: tuple(s) for p, s in _specs_by_path(specs).items()} == \
        {p: tuple(s) for p, s in _specs_by_path(
            JP.stage_param_specs(jst, None)).items()}
    placed = TP.place_pp_params(TP.to_pp(tp, cuts), mesh)
    back = TP.gather_pp_params(placed, mesh)
    for path, got in _by_path(back["stages"]).items():
        np.testing.assert_array_equal(got, want[path])


def _specs_by_path(specs):
    from jax.sharding import PartitionSpec
    from repro_torch.launch.shardings import P
    out = {}

    def rec(t, path):
        if isinstance(t, (P, PartitionSpec)):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k in t:
                rec(t[k], path + (str(k),))
        else:
            for i, v in enumerate(t):
                rec(v, path + (str(i),))
    rec(specs, ())
    return out


@pytest.mark.parametrize("arch,kw,cuts,part", [
    ("olmo-1b", {"n_layers": 6}, [0, 2, 6], 1),
    ("recurrentgemma-2b", {"n_layers": 5}, [0, 1, 2], 1),
    ("seamless-m4t-medium", {}, [0, 1, 2], 1),
])
def test_stage_forward_matches_reference(arch, kw, cuts, part):
    """Stage ``part`` of the cut: recurrentgemma at 5 layers has a partial
    last group (5 % 3 != 0), seamless runs its decoder body against an
    encoder memory."""
    jc, tc = _configs(arch, **kw)
    jp, tp = _params(jc)
    jst, lens = JP.stage_stack(jp["groups"], cuts)
    tst, _ = TP.stage_stack(tp["groups"], cuts)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 4, tc.d_model)).astype(np.float32) \
        if tc.is_encdec else None
    pos = np.arange(S, dtype=np.int32)
    mpos = np.arange(4, dtype=np.int32)
    want = JP._stage_forward(
        jc, jax.tree.map(lambda a: a[part], jst), lens[part], cuts[part],
        jnp.asarray(x), jnp.asarray(pos),
        None if mem is None else jnp.asarray(mem), jnp.asarray(mpos))
    with torch.no_grad():
        got = TP._stage_forward(
            tc, tree_map(lambda t: t[part], tst), lens[part], cuts[part],
            torch.from_numpy(x), torch.from_numpy(pos),
            None if mem is None else torch.from_numpy(mem),
            torch.from_numpy(mpos))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_layers,cuts,n_micro,b,s", [
    (2, [0, 1, 2], 4, 8, 16),          # the even 2-stage cut
    (6, [0, 2, 6], 2, 4, 8),           # AFarePart's uneven 2/4 cut
])
def test_pipeline_loss_and_grads_match_reference(n_layers, cuts, n_micro,
                                                 b, s):
    jc, tc = _configs("olmo-1b", n_layers=n_layers)
    jp, tp = _params(jc)
    part = np.array([0] * cuts[1] + [1] * (n_layers - cuts[1]))
    assert JP.group_cuts(jstages(part, 2), jc) == cuts
    batch = _batch(tc, b, s)
    jppp = {k: v for k, v in jp.items() if k != "groups"}
    jppp["stages"], _ = JP.stage_stack(jp["groups"], cuts)
    mesh = _jmesh()
    with jax.set_mesh(mesh):
        jl, jg = jax.value_and_grad(JP.make_pp_loss(jc, mesh, cuts, n_micro))(
            jppp, {k: jnp.asarray(v) for k, v in batch.items()})
    tmesh = _pod_mesh(2)
    placed = TP.place_pp_params(TP.to_pp(tp, cuts), tmesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = TTS._value_and_grad(
        TP.make_pp_loss(tc, tmesh, cuts, n_micro), placed, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-6)
    own = TTS.make_loss_fn(tc, remat=False)(tp, tb)
    np.testing.assert_allclose(float(loss), float(own), rtol=2e-6)
    want = _by_path(jg)
    got = _by_path(TP.gather_pp_params(grads, tmesh))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-6,
                                   err_msg=str(path))
    # the padded slot of the short stage (uneven cut) gets a zero gradient
    if cuts == [0, 2, 6]:
        assert not got[("stages", "b0", "attn", "wq")][0, 2:].any()


def test_pp_train_step_matches_reference():
    """One ``abstract_pp_train_step`` update over the uneven cut, the
    placed params and AdamW state gathered back, against the reference's
    step body (``repro/launch/steps.py``: ``value_and_grad`` of
    ``make_pp_loss``, then ``adamw_update``) jitted: its own builder reads
    the stage count off the mesh's pod axis, and one CPU device gives a
    mesh of one pod."""
    jc, tc = _configs("olmo-1b", n_layers=6)
    jp, tp = _params(jc)
    part = np.array([0, 0, 1, 1, 1, 1])
    batch = _batch(tc, 4, 8)
    jmesh = _jmesh()
    opt = JO.AdamWConfig()
    jloss = JP.make_pp_loss(jc, jmesh, [0, 2, 6], 2)

    def jstep(ppp, state, b):
        loss, grads = jax.value_and_grad(jloss)(ppp, b)
        ppp, state, m = JO.adamw_update(opt, ppp, grads, state)
        return ppp, state, {"loss": loss, **m}

    jppp = {k: v for k, v in jp.items() if k != "groups"}
    jppp["stages"], _ = JP.stage_stack(jp["groups"], [0, 2, 6])
    with jax.set_mesh(jmesh):
        jnew, jopt, jm = jax.jit(jstep)(
            jppp, JO.adamw_init(jppp, opt),
            {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = _pod_mesh(2)
    shape = ShapeSpec("t", seq_len=8, global_batch=4, kind="train")
    fn, (pp_s, opt_s, batch_s) = TS.abstract_pp_train_step(
        tc, mesh, shape, TO.AdamWConfig(), n_micro=2, partition=part)
    assert fn.cuts == [0, 2, 6]
    assert {p: v.shape for p, v in _shapes(pp_s).items()} == \
        {p: v.shape for p, v in _by_path(jppp).items()}
    assert all(t.device.type == "meta" for t in tree_leaves((pp_s, opt_s,
                                                             batch_s)))
    placed = TP.place_pp_params(TP.to_pp(tp, fn.cuts), mesh)
    state = TTS.init_train_state(tc, placed)
    placed, state, m = fn(placed, state,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    got = _by_path(TP.gather_pp_params(placed, mesh))
    lr = float(jm["lr"])
    # test_torch_train.py's split: 2 lr where the gradient is at rounding
    # level (below 1e-4 of its leaf's largest), else 1e-3 lr + 4 ulp.  The
    # reference's first moment after one step is (1 - b1) times the
    # clipped gradient, so it ranks the elements as the gradient does.  A
    # gradient of exactly 0 (the short stage's padded slots) is held
    # tightly: the update there is the weight decay alone.
    jm1 = _by_path(jopt["m"])
    n_loose = n_tight = 0
    for path, want in _by_path(jnew).items():
        g = np.abs(jm1[path].astype(np.float32))
        loose = (g > 0) & (g < 1e-4 * g.max())
        d = np.abs(got[path].astype(np.float64) - want)
        tight = 1e-3 * lr + 4 * np.spacing(np.abs(want).astype(np.float32))
        assert (d[loose] <= 2 * lr).all(), path
        assert (d[~loose] <= tight[~loose]).all(), (path, d[~loose].max())
        n_loose += int(loose.sum())
        n_tight += int((~loose).sum())
    assert n_tight > 50 * n_loose, (n_tight, n_loose)
    for moment in ("m", "v"):
        g = _by_path(TP.gather_pp_params(state[moment], mesh))
        for path, want in _by_path(jopt[moment]).items():
            np.testing.assert_allclose(
                g[path], want, rtol=0, atol=2e-5 * max(np.abs(want).max(),
                                                       1e-30),
                err_msg=f"{moment} {path}")


def _shapes(tree):
    return {tuple(map(str, p)): v for p, v in tree_flatten_with_path(tree)[0]}


def test_data_parallel_step_equals_microbatched_step():
    """``abstract_train_step`` on ``data=2`` (one chunk a device; FSDP, the
    params laid out over data) is ``make_train_step(microbatches=2)``
    bitwise: params, state and loss."""
    jc, tc = _configs("olmo-1b")
    jp, tp = _params(jc)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc, 4, S).items()}
    opt = TO.AdamWConfig(lr=1e-3)
    mesh = TM.make_test_mesh((2, 1), pool=[CPU] * 2)
    shape = ShapeSpec("t", seq_len=S, global_batch=4, kind="train")
    fn, (params_s, opt_s, batch_s) = TS.abstract_train_step(
        tc, mesh, shape, opt, microbatches=1, remat=False)
    assert params_s["embed"].shape == tp["embed"].shape
    assert batch_s["tokens"].shape == (4, S) and "labels" in batch_s
    want = TTS.make_train_step(tc, opt, microbatches=2, remat=False)(
        tp, TTS.init_train_state(tc, tp), batch)
    got = fn(tp, TTS.init_train_state(tc, tp), batch)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    # tensor parallelism over model=2 and seq_axis run now
    # (tests/test_torch_launch_tp.py holds them against the reference in
    # full): model=2's loss within 1e-6 of the reference's and its update
    # within AdamW's 2 lr of the unsharded step's; seq_axis on model=1
    # splits nothing, bitwise
    jl = jax.jit(JTS.make_loss_fn(jc, remat=False))(
        jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    tfn, _ = TS.abstract_train_step(
        tc, TM.make_test_mesh((1, 2), pool=[CPU] * 2), shape, opt,
        microbatches=1, remat=False)
    one = TTS.make_train_step(tc, opt, microbatches=1, remat=False)(
        tp, TTS.init_train_state(tc, tp), batch)
    two = tfn(tp, TTS.init_train_state(tc, tp), batch)
    np.testing.assert_allclose(float(two[2]["loss"]), float(jl), rtol=1e-6)
    for a, b in zip(tree_leaves(two[0]), tree_leaves(one[0])):
        assert (a - b).abs().max() <= 2 * opt.lr
    sfn, _ = TS.abstract_train_step(tc, mesh, shape, opt, microbatches=1,
                                    remat=False, seq_axis="model")
    for a, b in zip(tree_leaves(sfn(tp, TTS.init_train_state(tc, tp),
                                    batch)), tree_leaves(got)):
        assert torch.equal(a, b)
