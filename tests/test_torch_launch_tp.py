"""FSDP x tensor parallelism on the ``(data, model)`` mesh against the
reference, on the CPU: ``abstract_train_step`` with params and AdamW
state laid out by ``param_specs`` / ``opt_state_specs`` over pools of
``[cpu] * n``, ``seq_axis``, the serve steps on ``(data, model)`` and
``(pod, data, model)`` meshes with placed params, the faulted
tensor-parallel decode and a pipeline stage over a ``(data, model)``
sub-mesh.  The reference runs unsharded (its functions on its one CPU
device, or its pipeline on a ``(1, 1, 1)`` mesh of ``Auto`` axes): GSPMD
layouts change no values beyond the order of the sums.  Params come from
the reference (``PRNGKey(1)``) through ``repro_torch.convert``, inputs from
a numpy seed, ``reduced()`` configs (MoE at capacity factor 0) at B=4,
S=16.  ``model=4`` splits the reduced configs' two KV heads of 16 columns
inside a head.

Tolerances (float32):
  * losses within 1e-6 relative, gradients within 1e-5 of their leaf's
    largest |g| (the row-parallel products' partial sums and the
    vocab-sliced logsumexp add in another order: measured at most 2.7e-6);
  * the updated params by ``tests/test_torch_train.py``'s split: AdamW's
    first step moves a param by about lr·sign(g), so where |g| is at
    rounding level (below 1e-4 of its leaf's largest) within 2 lr, else
    within 1e-3 lr + 4 ulps; moments within 2e-5 of their leaf's largest;
  * with ``model=1`` (FSDP alone) the gradients bitwise the data-parallel
    ones (the same sums, in fp32, in the same order);
  * bf16 (olmo-1b on ``model=2``, against the port's unsharded step): the
    loss within 2^-8 relative and gradients within 2^-4 of their leaf's
    largest: each row-parallel product is rounded to bf16 once a slot
    before the fp32 sum and once after, where the unsharded product rounds
    once, so a layer's output may move by a bf16 ulp (2^-8 relative), and
    the backward, in bf16 too, carries those moves into every gradient
    element (measured: the loss at most 1.0e-4 relative, gradients at most
    2.6e-2 of their leaf's largest, over three seeds at model=2 and 4);
  * serve steps within 1e-5 of the reference's prefill / decode; a
    faulted decode step within 1e-3 of the port's unsharded one
    (``tests/test_torch_decode.py``'s: a layer's 16-bit input grid is
    2^-15 amax), and the corrupted shards bitwise the whole corrupted
    leaves' slices.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import pipeline as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import (tree_flatten, tree_flatten_with_path,  # noqa: E402
                               tree_leaves, tree_map)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import collectives as C  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import pipeline as TP  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

CPU = torch.device("cpu")
B, S = 4, 16
LR = 1e-3


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


def _params(jc):
    jp = JT.init_lm(jc, jax.random.PRNGKey(1))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.is_floating_point() \
            else t.numpy()
    return np.asarray(t, dtype=np.float32) \
        if np.issubdtype(np.asarray(t).dtype, np.floating) else np.asarray(t)


def _by_path(tree):
    if any(isinstance(v, torch.Tensor) for v in tree_leaves(tree)):
        return {tuple(map(str, p)): _np(v)
                for p, v in tree_flatten_with_path(tree)[0]}
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            _np(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _mesh(shape, axes=("data", "model")):
    return TM.make_test_mesh(shape, axes, pool=[CPU] * int(np.prod(shape)))


def _train(tc, mesh, seq_axis=None, opt=None):
    shape = ShapeSpec("t", seq_len=S, global_batch=B, kind="train")
    return TS.abstract_train_step(tc, mesh, shape, opt or TO.AdamWConfig(
        lr=LR), microbatches=1, remat=False, seq_axis=seq_axis)


def _grad_close(got, want, bound):
    assert got.keys() == want.keys()
    worst = 0.0
    for path, w in want.items():
        err = np.abs(got[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= bound, (path, err)
        worst = max(worst, err)
    return worst


def _check_update(new, state, jnew, jstate, lr):
    """``tests/test_torch_train.py``'s split of one AdamW step's params, and
    the moments against the reference's."""
    jm = _by_path(jstate["m"])
    n_loose = n_tight = 0
    for path, want in _by_path(jnew).items():
        g = np.abs(jm[path])
        loose = g < 1e-4 * g.max()
        d = np.abs(new[path].astype(np.float64) - want)
        tight = 1e-3 * lr + 4 * np.spacing(np.abs(want).astype(np.float32))
        assert (d[loose] <= 2 * lr).all(), path
        assert (d[~loose] <= tight[~loose]).all(), (path, d[~loose].max())
        n_loose += int(loose.sum())
        n_tight += int((~loose).sum())
    assert n_tight > 10 * n_loose, (n_tight, n_loose)
    for moment in ("m", "v"):
        got = state[moment]
        for path, want in _by_path(jstate[moment]).items():
            np.testing.assert_allclose(
                got[path], want, rtol=0,
                atol=2e-5 * max(np.abs(want).max(), 1e-30),
                err_msg=f"{moment} {path}")


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
_REF = {}


def _reference(arch):
    """The reference's loss and gradients on the whole batch (jitted) and
    its AdamW update on them, once an arch."""
    if arch not in _REF:
        jc, tc = _configs(arch)
        jp, tp = _params(jc)
        batch = _batch(tc)
        if tc.is_encdec:
            batch["enc_embeds"] = np.random.default_rng(3).standard_normal(
                (B, 4, tc.d_model)).astype(np.float32)
        jl, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(
            jc, remat=False)))(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        opt = JO.AdamWConfig(lr=LR)
        jnew, jstate, _ = jax.jit(lambda p, g: JO.adamw_update(
            opt, p, g, JO.adamw_init(p, opt)))(jp, jg)
        _REF[arch] = (tc, tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                      float(jl), _by_path(jg), jnew, jstate)
    return _REF[arch]


@pytest.mark.parametrize("arch,shape,seq_axis", [
    ("olmo-1b", (1, 2), None),
    ("olmo-1b", (1, 4), None),           # KV heads split inside a head
    ("olmo-1b", (2, 2), None),
    ("olmo-1b", (1, 4), "model"),
    ("olmo-1b", (2, 2), "model"),
    ("mixtral-8x7b", (2, 2), None),
    ("recurrentgemma-2b", (1, 2), None),   # its one KV head split
    ("seamless-m4t-medium", (1, 2), None),
])
def test_train_step_matches_reference(arch, shape, seq_axis):
    """Loss and gradients of the FSDP x TP step against
    ``jax.value_and_grad`` of the reference's loss on the whole batch (the
    mean of the data rows' chunks), then one AdamW update against the
    reference's on those gradients; params and state go in and come out
    laid out by their specs."""
    tc, tp, tb, jl, jg, jnew, jstate = _reference(arch)
    mesh = _mesh(shape)
    fn, (params_s, opt_s, _) = _train(tc, mesh, seq_axis)
    placed = SH.place_params(tp, mesh)
    assert len(placed) == mesh.size
    state = SH.place_opt_state(TTS.init_train_state(tc, tp), tp, mesh)
    C.reset_bytes()
    loss, grads = fn.value_and_grad(placed, tb)
    if mesh.size > 1:
        assert C.total_bytes() > 0
    np.testing.assert_allclose(float(loss), jl, rtol=1e-6)
    _grad_close(_by_path(SH.gather_params(grads, params_s, mesh)), jg, 1e-5)
    new, state, m = fn(placed, state, tb)
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=1e-6)
    _check_update(_by_path(SH.gather_params(new, params_s, mesh)),
                  {k: _by_path(v) for k, v in SH.gather_opt_state(
                      state, params_s, mesh).items() if k != "step"},
                  jnew, jstate, LR)
    # each slot holds its own slices: a column-parallel weight split over
    # both axes where they divide it
    if not tc.is_encdec and "attn" in params_s["groups"]["b0"]:
        wq = SH.param_specs(params_s, mesh)["groups"]["b0"]["attn"]["wq"]
        assert tuple(wq) == (None, "data", "model")
        assert placed[0]["groups"]["b0"]["attn"]["wq"].shape[1:] == (
            tc.d_model // shape[0], tc.n_heads * tc.head_dim_ // shape[1])


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-2b"])
def test_fsdp_grads_bitwise_data_parallel(arch):
    """``model=1``, ``data=2``: the gradients and loss are bitwise the
    data-parallel step's (each data row's whole gradient, summed in fp32
    in row order and halved), and so is the updated state when the
    global norm's shard sums agree."""
    _, tc = _configs(arch)
    tp = T.init_lm(tc, seed=2, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    mesh = _mesh((2, 1))
    fn, (params_s, _, _) = _train(tc, mesh)
    loss, grads = fn.value_and_grad(SH.place_params(tp, mesh), tb)
    loss_fn = TTS.make_loss_fn(tc, remat=False)
    gsum, lsum = None, torch.zeros(())
    for c in range(2):
        chunk = {k: v.reshape(2, B // 2, *v.shape[1:])[c]
                 for k, v in tb.items()}
        lc, gc = TTS._value_and_grad(loss_fn, tp, chunk)
        lsum = lsum + lc
        gc = [g.float() for g in tree_leaves(gc)]
        gsum = gc if gsum is None else [a.add_(b) for a, b in zip(gsum, gc)]
    assert torch.equal(loss, lsum / 2)
    got = tree_leaves(SH.gather_params(grads, params_s, mesh))
    for a, b in zip(got, gsum):
        assert torch.equal(a, b.div_(2))


@pytest.mark.parametrize("arch,shape", [
    ("olmo-1b", (2, 2)), ("recurrentgemma-2b", (1, 2)),
    ("mixtral-8x7b", (1, 4)), ("seamless-m4t-medium", (2, 2))])
def test_tp_remat_matches_no_remat(arch, shape):
    """Remat under tensor parallelism recomputes a group in one autograd
    node (``transformer._Remat``): the loss and gradients bitwise the
    step without remat; the encoder-decoder's within 1e-6 of the leaf's
    largest (its memory's gradient sums the decoder layers' nodes in
    another order)."""
    _, tc = _configs(arch)
    tp = T.init_lm(tc, seed=1, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    if tc.is_encdec:
        tb["enc_embeds"] = torch.from_numpy(np.random.default_rng(3)
                                            .standard_normal((B, 4, tc.d_model))
                                            .astype(np.float32))
    mesh = _mesh(shape)
    placed = SH.place_params(tp, mesh)
    out = []
    for remat in (False, True):
        fn, _ = TS.abstract_train_step(tc, mesh, ShapeSpec(
            "t", seq_len=S, global_batch=B, kind="train"), microbatches=1,
            remat=remat)
        out.append(fn.value_and_grad(placed, tb))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        if tc.is_encdec:
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()
        else:
            assert torch.equal(a, b)


def test_bf16_step_within_bound():
    """olmo-1b in bf16 on ``model=2`` against the port's unsharded
    ``make_loss_fn`` (see the module docstring for the bound)."""
    _, tc = _configs("olmo-1b", dtype="bfloat16")
    tp = T.init_lm(tc, seed=3, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    mesh = _mesh((1, 2))
    fn, (params_s, _, _) = _train(tc, mesh)
    loss, grads = fn.value_and_grad(SH.place_params(tp, mesh), tb)
    want_l, want_g = TTS._value_and_grad(TTS.make_loss_fn(tc, remat=False),
                                         tp, tb)
    assert abs(float(loss) - float(want_l)) <= 2 ** -8 * abs(float(want_l))
    _grad_close(_by_path(SH.gather_params(grads, params_s, mesh)),
                _by_path(want_g), 2 ** -4)


def test_seq_axis_without_mesh_is_the_unsplit_loss():
    """``seq_axis`` on whole params (no mesh) changes nothing, bitwise."""
    _, tc = _configs("olmo-1b")
    tp = T.init_lm(tc, seed=4, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    a = TTS.make_loss_fn(tc, remat=False, seq_axis="model")(tp, tb)
    b = TTS.make_loss_fn(tc, remat=False)(tp, tb)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape,axes,b,seq_axis", [
    ("olmo-1b", (1, 4), ("data", "model"), 2, None),
    ("olmo-1b", (1, 4), ("data", "model"), 2, "model"),
    ("recurrentgemma-2b", (1, 2), ("data", "model"), 2, None),
    ("mixtral-8x7b", (2, 2, 2), ("pod", "data", "model"), 2, None),
    ("olmo-1b", (2, 2, 2), ("pod", "data", "model"), 32, None),
])
def test_serve_steps_placed_match_reference(arch, shape, axes, b, seq_axis):
    """Prefill and two decode steps with placed params against the
    reference's ``prefill`` / ``decode_step``; the multi-pod meshes take
    the reference's multi-pod specs (batch over ``(pod, data)`` at 32
    sequences, else the cache's sequence over ``(pod, model)``);
    ``seq_axis`` splits the prefill's 16 queries over the 4 slots."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    L, P0 = 32, 15 if seq_axis is None else 16
    toks = np.random.default_rng(5).integers(0, tc.vocab, (b, P0)).astype(
        np.int32)
    mesh = _mesh(shape, axes)
    pfn, _ = TS.abstract_serve_prefill(tc, mesh, ShapeSpec(
        "p", seq_len=L, global_batch=b, kind="prefill"), seq_axis=seq_axis)
    dfn, _ = TS.abstract_serve_decode(tc, mesh, ShapeSpec(
        "d", seq_len=L, global_batch=b, kind="decode"))
    placed = SH.place_params(tp, mesh)
    jlog, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                              max_len=L)
    with torch.no_grad():
        last, cache = pfn(placed, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(last), np.asarray(jlog[:, -1]), rtol=0,
                               atol=1e-5)
    tok = np.asarray(jlog[:, -1]).argmax(-1).astype(np.int32)
    for i in range(2):
        pos = np.full((b,), P0 + i, np.int32)
        jl, jcache = JT.decode_step(jp, jc, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        with torch.no_grad():
            tl, cache = dfn(placed, cache, {
                "tokens": torch.from_numpy(tok),
                "positions": torch.from_numpy(pos)})
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                   atol=1e-5)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_faulted_tp_decode_corrupts_whole_then_splits():
    """``corrupt_block`` on a row's ``Sharded`` block: one grouped call on
    the whole leaves, the pieces bitwise the unsharded corrupted leaves'
    slices; a faulted decode step over (1, 4) within 1e-3 of the
    unsharded one, the greedy tokens equal."""
    _, tc = _configs("olmo-1b")
    tp = T.init_lm(tc, seed=6, device="cpu")
    mesh = _mesh((2, 2))
    specs = SH.param_specs(tp, mesh)
    row = SH.row_params(SH.place_params(tp, mesh), specs, mesh, {"data": 1})
    block = tree_map(lambda t: t[0], row["groups"]["b0"])
    whole = tree_map(lambda t: t[0], tp["groups"]["b0"])
    x = torch.randn(2, 1, tc.d_model, generator=torch.Generator().manual_seed(
        0))
    fault = (torch.tensor(0.2), torch.tensor(0.2), 77)
    calls = []
    real = TL.corrupt_leaves
    TL.corrupt_leaves = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got, gx = T.corrupt_block(block, x, fault)
    finally:
        TL.corrupt_leaves = real
    want, wx = T.corrupt_block(whole, x, fault)
    assert len(calls) == 1 and torch.equal(gx, wx)
    for (path, w), g in zip(tree_flatten_with_path(want)[0],
                            tree_flatten(got)[0]):
        assert isinstance(g, TL.Sharded)
        if g.split:
            for m, piece in enumerate(w.chunk(g.nm, g.model_dim)):
                assert torch.equal(g.parts[m][0], piece), path
        else:
            assert torch.equal(g.parts[0][0], w), path
    # a faulted step over (1, 4) against the unsharded step
    mesh = _mesh((1, 4))
    placed = SH.place_params(tp, mesh)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tc.vocab, (2, 9)).astype(np.int32))
    pfn, _ = TS.abstract_serve_prefill(tc, mesh, ShapeSpec(
        "p", seq_len=16, global_batch=2, kind="prefill"))
    dfn, _ = TS.abstract_serve_decode(tc, mesh, ShapeSpec(
        "d", seq_len=16, global_batch=2, kind="decode"))
    w = torch.full((tc.n_layers,), 0.2)
    with torch.no_grad():
        last, cache = pfn(placed, {"tokens": toks})
        _, ucache = T.prefill(tp, tc, {"tokens": toks}, 16)
        tok = last.argmax(-1).to(torch.int32)
        pos = torch.full((2,), 9, dtype=torch.int32)
        got, _ = dfn(placed, cache, {"tokens": tok, "positions": pos},
                     fault=(w, w, 5))
        want, _ = T.decode_step(tp, tc, ucache, tok, pos, fault=(w, w, 5))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-3)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# --------------------------------------------------------------------------
# the pipeline over (data, model) sub-meshes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sub", [(1, 2), (2, 1), (2, 2)])
def test_pipeline_stage_over_submesh_matches_reference(sub):
    """Two stages at the uneven ``[0, 2, 6]`` cut, each over a ``sub``
    sub-mesh: the loss and gradients (copies summed by ``sync_grads``)
    against the reference's ``make_pp_loss`` on a ``(1, 1, 1)`` mesh, and
    one ``abstract_pp_train_step`` update running with placed params."""
    if "pp" not in _REF:
        jc, tc = _configs("olmo-1b", n_layers=6)
        jp, tp = _params(jc)
        batch = _batch(tc, 4, 8)
        jppp = {k: v for k, v in jp.items() if k != "groups"}
        jppp["stages"], _ = JP.stage_stack(jp["groups"], [0, 2, 6])
        jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                              axis_types=(AxisType.Auto,) * 3)
        with jax.set_mesh(jmesh):
            jl, jg = jax.jit(jax.value_and_grad(JP.make_pp_loss(
                jc, jmesh, [0, 2, 6], 2)))(
                    jppp, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF["pp"] = tc, tp, batch, jppp, float(jl), jg
    tc, tp, batch, jppp, jl, jg = _REF["pp"]
    cuts = [0, 2, 6]
    mesh = _mesh((2, *sub), ("pod", "data", "model"))
    like = TP.to_pp(tp, cuts)
    placed = TP.place_pp_params(like, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = TTS._value_and_grad(TP.make_pp_loss(tc, mesh, cuts, 2),
                                      placed, tb)
    grads = TP.sync_grads(grads, mesh, like)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-6)
    got = _by_path(TP.gather_pp_params(grads, mesh, like=like))
    _grad_close(got, _by_path(jg), 1e-5)
    back = _by_path(TP.gather_pp_params(placed, mesh, like=like))
    for path, want in _by_path(jppp).items():
        np.testing.assert_array_equal(back[path], want)
    part = np.array([0, 0, 1, 1, 1, 1])
    fn, _ = TS.abstract_pp_train_step(
        tc, mesh, ShapeSpec("t", seq_len=8, global_batch=4, kind="train"),
        TO.AdamWConfig(), n_micro=2, partition=part)
    state = TTS.init_train_state(tc, placed)
    _, _, m = fn(placed, state, tb)
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=1e-6)
