"""The launch stack's serving side against the reference, on the CPU: a
cache sequence-sharded over several devices (``decode_step`` with a list
of shards, ``layers.lse_combine`` over them) against the reference's
``decode_step(seq_axis=..., seq_shard_index=i, seq_shards=n)`` under
``jax.vmap(axis_name=...)``, and ``launch.steps``' prefill and decode on a
``(data=2, model=2)`` mesh of ``[cpu] * 4`` against ``forward`` and the
reference's abstract steps on a ``(1, 1)`` mesh.  Params come from the
reference (``PRNGKey(1)``) through ``repro_torch.convert``, inputs from a
numpy seed, ``reduced()`` configs in float32.

Tolerances:
  * sharded decode against the reference's: logits and float cache leaves
    within ``ATOL`` = 1e-5, ``pos`` bitwise (measured at most 1.5e-6);
    against the port's unsharded step within ``ATOL`` as well (another
    order of the softmax's sums over the slots);
  * a faulted sharded step against the unsharded one within
    ``FAULT_ATOL`` = 1e-3 (``tests/test_torch_decode.py``'s: a layer's
    16-bit input grid is 2^-15 amax), the greedy tokens equal and one
    grouped corruption a layer on both;
  * the serve steps within 3e-3 of ``forward`` (the reference test's,
    ``tests/test_distribution.py``) and within ``ATOL`` of the reference's
    abstract steps (measured at most 2.7e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_flatten_with_path, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.shardings import P, gather_tree, shard_tree  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.kvcache import cache_specs  # noqa: E402

CPU = torch.device("cpu")
B, S, MAX_LEN, STEPS, SE = 2, 8, 32, 2, 4
ATOL, FAULT_ATOL, SERVE_TOL = 1e-5, 1e-3, 3e-3


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
    return np.asarray(t.float() if t.is_floating_point() else t)


def _seq_specs(cfg):
    """Attention caches split over "model" by sequence, recurrent states
    whole in every shard: ``cache_specs(seq_shards=n)``'s layout."""
    return {f"b{s}": ({"k": P(None, None, "model"), "v": P(None, None, "model"),
                       "pos": P(None, None, "model")}
                      if kind in ("attn", "local", "global")
                      else {"conv": P(), "h": P()})
            for s, kind in enumerate(cfg.block_pattern)}


def _split_ref(cache, n):
    """The reference's full cache -> ``n`` shards stacked on a new leading
    axis (attention leaves split by sequence, the rest repeated)."""
    def split(path, a):
        if path[-1].key in ("k", "v", "pos"):
            parts = jnp.split(a, n, axis=2)
            return jnp.stack(parts)
        return jnp.broadcast_to(a, (n, *a.shape))
    return jax.tree_util.tree_map_with_path(split, cache)


def _prefilled(arch, **kw):
    jc, tc = _configs(arch, **kw)
    jp, tp = _params(jc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(toks)}
    jmem = tmem = None
    if tc.is_encdec:
        enc = rng.standard_normal((B, SE, tc.d_model)).astype(np.float32)
        tb["enc_embeds"] = torch.from_numpy(enc)
        jmem = JT.encode(jc, jp, jnp.asarray(enc))
        with torch.no_grad():
            tmem = T.encode(tc, tp, tb["enc_embeds"])
    with torch.no_grad():
        tl, tcache = T.prefill(tp, tc, tb, max_len=MAX_LEN)
    return jc, tc, jp, tp, tcache, tl, jmem, tmem


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b",
                                  "seamless-m4t-medium"])
def test_sequence_sharded_decode_matches_reference(arch, n):
    """``STEPS`` greedy steps from position S = 8 with the caches split in
    ``n``: at S = 8 of 32 slots the last shard (2 shards: slots 16-31; 4:
    24-31) holds no valid slot.  gemma2's local ring of 8 wraps."""
    jc, tc, jp, tp, full, tl, jmem, tmem = _prefilled(arch, window=8)
    mesh = TM.make_test_mesh((n,), ("model",), pool=[CPU] * n)
    specs = _seq_specs(tc)
    shards = shard_tree(full, specs, mesh)
    for got, want in zip(tree_flatten_with_path(shards[0])[0],
                         tree_flatten_with_path(cache_specs(
                             tc, B, MAX_LEN, seq_shards=n))[0]):
        assert got[1].shape == want[1].shape and got[1].dtype == want[1].dtype
    jcache = _split_ref(jax.tree.map(jnp.asarray, tree_map(_np, full)), n)
    plain = tree_map(lambda t: t.clone(), full)
    jstep = jax.jit(jax.vmap(
        lambda c, i, t, pos: JT.decode_step(
            jp, jc, c, t, pos, enc_memory=jmem, seq_axis="s",
            seq_shard_index=i, seq_shards=n),
        in_axes=(0, 0, None, None), axis_name="s"))
    tok = torch.argmax(tl[:, -1], -1).to(torch.int32)
    for step in range(STEPS):
        pos = torch.full((B,), S + step, dtype=torch.int32)
        jl, jcache = jstep(jcache, jnp.arange(n), jnp.asarray(_np(tok)),
                           jnp.asarray(_np(pos)))
        with torch.no_grad():
            got, shards = T.decode_step(tp, tc, shards, tok, pos,
                                        enc_memory=tmem)
            want, plain = T.decode_step(tp, tc, plain, tok, pos,
                                        enc_memory=tmem)
        for i in range(n):
            np.testing.assert_allclose(np.asarray(jl[i]), _np(got),
                                       rtol=0, atol=ATOL)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
        for i, shard in enumerate(shards):
            jshard = jax.tree.map(lambda a: np.asarray(a[i]), jcache)
            for path, leaf in tree_flatten_with_path(shard)[0]:
                ref = jshard[path[0]][path[1]]
                if path[1] == "pos":
                    np.testing.assert_array_equal(_np(leaf), ref)
                else:
                    np.testing.assert_allclose(_np(leaf), ref, rtol=0,
                                               atol=ATOL)
        np.testing.assert_array_equal(
            _np(gather_tree(shards, specs, mesh)["b0"]["pos"]),
            _np(plain["b0"]["pos"]))
        tok = torch.argmax(got, -1).to(torch.int32)
    if n == 4:                     # the global cache's slots 24-31
        key = "b1" if arch == "gemma2-27b" else "b0"
        assert (_np(shards[3][key]["pos"]) == -1).all()


def test_lse_combine_folds_shards_as_the_reference():
    """Several shards' partials, one of them empty (max -1e30, as a shard
    with no valid slot gives), against the reference's pmax/psum under
    vmap."""
    from repro.models import layers as JL
    rng = np.random.default_rng(3)
    n = 3
    num = rng.standard_normal((n, 2, 4, 8)).astype(np.float32)
    den = (rng.random((n, 2, 4)) + 0.5).astype(np.float32)
    m = rng.standard_normal((n, 2, 4)).astype(np.float32)
    m[2] = -1e30
    want = jax.vmap(lambda a, b, c: JL.lse_combine(a, b, c, "s"),
                    axis_name="s")(num, m, den)[0]
    got = TL.lse_combine([torch.from_numpy(a) for a in num],
                         [torch.from_numpy(a) for a in m],
                         [torch.from_numpy(a) for a in den])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_faulted_sharded_step_matches_unsharded(monkeypatch):
    """A faulted step (per-layer rates, seed 3) on 4 shards against the
    unsharded one: one grouped corruption a layer on each, before the
    attention splits."""
    jc, tc, jp, tp, full, tl, _, _ = _prefilled("olmo-1b")
    mesh = TM.make_test_mesh((4,), ("model",), pool=[CPU] * 4)
    shards = shard_tree(full, _seq_specs(tc), mesh)
    rng = np.random.default_rng(11)
    fault = (torch.from_numpy(rng.uniform(0.05, 0.3, tc.n_layers)
                              .astype(np.float32)),
             torch.from_numpy(rng.uniform(0.05, 0.3, tc.n_layers)
                              .astype(np.float32)), 3)
    calls = []
    real = TL.corrupt_leaves
    monkeypatch.setattr(TL, "corrupt_leaves",
                        lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    tok = torch.argmax(tl[:, -1], -1).to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    with torch.no_grad():
        got, _ = T.decode_step(tp, tc, shards, tok, pos, fault=fault)
        n_sharded = len(calls)
        want, _ = T.decode_step(tp, tc, full, tok, pos, fault=fault)
    assert n_sharded == len(calls) - n_sharded == tc.n_layers
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=FAULT_ATOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2.7b",
                                  "gemma2-27b"])
def test_serve_steps_match_forward(arch):
    """``abstract_serve_prefill`` on 31 tokens of 4 sequences, then
    ``abstract_serve_decode`` at position 31, on (data=2, model=2): the
    batch over data, the 32-slot caches (and mamba2's SSD state) over
    model, against ``forward`` on the 32 tokens and the reference's steps
    on a (1, 1) mesh."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    toks = np.random.default_rng(1).integers(0, tc.vocab, (4, 32)).astype(
        np.int32)
    mesh = TM.make_test_mesh((2, 2), ("data", "model"), pool=[CPU] * 4)
    pshape = ShapeSpec("p", seq_len=32, global_batch=4, kind="prefill")
    dshape = ShapeSpec("d", seq_len=32, global_batch=4, kind="decode")
    pfn, (params_s, batch_s) = TS.abstract_serve_prefill(tc, mesh, pshape)
    dfn, (_, cache_s, dbatch_s) = TS.abstract_serve_decode(tc, mesh, dshape)
    assert all(t.device.type == "meta" for t in [*batch_s.values(),
                                                 *dbatch_s.values()])
    with torch.no_grad():
        last, cache = pfn(tp, {"tokens": torch.from_numpy(toks[:, :31])})
        assert len(cache) == 4
        assert cache[0]["b0"]["h" if arch == "mamba2-2.7b" else "k"].shape[2] \
            == cache_s["b0"]["h" if arch == "mamba2-2.7b" else "k"].shape[2] // 2
        dl, cache = dfn(tp, cache, {
            "tokens": torch.from_numpy(toks[:, 31]),
            "positions": torch.full((4,), 31, dtype=torch.int32)})
        full = T.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert np.abs(_np(dl) - _np(full[:, 31])).max() < SERVE_TOL, arch
    assert np.abs(_np(last) - _np(full[:, 30])).max() < SERVE_TOL, arch

    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jp_shape = JShape("p", seq_len=32, global_batch=4, kind="prefill")
    jd_shape = JShape("d", seq_len=32, global_batch=4, kind="decode")
    with jax.set_mesh(jmesh):
        jpfn, _ = JS.abstract_serve_prefill(jc, jmesh, jp_shape)
        jlast, jcache = jpfn(jp, {"tokens": jnp.asarray(toks[:, :31])})
        jdfn, _ = JS.abstract_serve_decode(jc, jmesh, jd_shape)
        jdl, _ = jdfn(jp, jcache, {"tokens": jnp.asarray(toks[:, 31]),
                                   "positions": jnp.full((4,), 31, jnp.int32)})
    np.testing.assert_allclose(_np(last), np.asarray(jlast), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(dl), np.asarray(jdl), rtol=0, atol=ATOL)
