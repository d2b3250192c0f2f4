"""The port's training substrate (``repro_torch.train``, ``checkpoint``,
``train_lm``) against the reference's ``repro.train``, ``repro.checkpoint``
and ``tests/test_trainer_ft.py``, on the CPU, with inputs from a numpy seed
and params and optimizer state carried across by ``repro_torch.convert``.

Tolerances (float32 unless named; TF32 is never involved on the CPU):
  * ``warmup_cosine`` over steps 0-200: within 2^-20 of the peak lr (XLA's
    and PyTorch's ``cos`` differ by an ulp; measured at most 3 ulps);
  * ``adamw_update`` (the reference op by op): ``lr`` bitwise, the grad
    norm within 2^-22 relative (another summation order), ``m`` and ``v``
    within 4 ulps of their larger summand and params within 4 ulps of the
    larger of themselves and lr, in the leaf's dtype (bf16 ulps for the
    moments of a bf16 grad, which clipping rounds back to bf16) (measured:
    with clipping inactive bitwise but for one param of 25344 at 1 ulp;
    active, where the clipped grads follow the norm's last bit, at most 2
    and 1 ulps);
  * the masked cross entropy: loss within 2e-6 relative, its grads within
    1e-6 absolute (measured 0 and 1.9e-8);
  * value and grads of ``make_loss_fn`` on the ten reduced configs (MoE at
    capacity factor 0): loss within 1e-5 absolute, each leaf's grads
    within 2e-5 of the leaf's largest (measured at most 4.8e-7 and 6.0e-6,
    mamba2-2.7b);
  * one ``make_train_step`` step, two microbatches, against the
    reference's jitted step: loss, grad norm and lr within 1e-5 relative;
    ``m`` and ``v`` within 2e-5 of the leaf's largest; a param whose grad
    is at rounding level (below 1e-4 of its leaf's largest) within
    2 lr, where the two sides may take opposite signs, and every other
    within 1e-3 lr + 4 ulps (there AdamW's first step is lr sign(g), the
    sign agrees and only eps / |g| carries the grads' error).  Measured: 83
    of 81920 params at rounding level, off by at most 0.032 lr; the rest
    within 0.048 of their bound; moments 1.3e-6; metrics 9.2e-8;
  * ``remat=True`` bitwise ``remat=False``; checkpoints bitwise both ways;
    ``quant8`` / ``dequant8`` / ``init_error_feedback`` bitwise;
  * ``Trainer.run`` beside the reference's ``Trainer`` from the same params
    over 6 steps: each step's loss within 1e-5 relative, lr within 1e-6
    (measured 9.8e-8 and 7.8e-8: the reference's lr is computed jitted).
"""
import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.models.transformer import init_lm as jinit  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert, train_lm  # noqa: E402
from repro_torch._tree import (tree_flatten_with_path, tree_leaves,  # noqa: E402
                               tree_map)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.train import compression as TC  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    """Any leaf (JAX, numpy with ml_dtypes, torch) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _same_bits(a, b) -> bool:
    x, y = _f32(a), _f32(b)
    return x.shape == y.shape and np.array_equal(x.view(np.int32),
                                                 y.view(np.int32))


def _ulp(mag: np.ndarray, bf16: bool) -> np.ndarray:
    u = np.spacing(np.abs(mag).astype(np.float32)).astype(np.float64)
    return u * 65536 if bf16 else u


def _cfgs(arch):
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    if jc.is_moe:
        jc = dataclasses.replace(jc, moe_capacity_factor=0.0)
        tc = dataclasses.replace(tc, moe_capacity_factor=0.0)
    return jc, tc


def _batch(cfg, seed=0, b=B, s=S, masked=0):
    """numpy inputs of one batch (``tokens`` or the stub frontend's
    ``embeds``, the encoder-decoder's ``enc_embeds``) with ``labels``, the
    first ``masked`` of row 0 set to -1."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend in ("vision", "audio") and not cfg.is_encdec:
        batch["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (b, max(1, s // cfg.enc_ratio), cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :masked] = -1
    batch["labels"] = labels
    return batch


def _both(arch, seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params, reference
    batch, port batch)."""
    jc, tc = _cfgs(arch)
    jp = jinit(jc, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    nb = _batch(jc, seed, **kw)
    return (jc, tc, jp, tp, {k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(20, 150), (0, 200), (100, 120)])
def test_warmup_cosine_matches_reference(warmup, total):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    steps = np.arange(0, 201)
    want = np.array([np.asarray(JO.warmup_cosine(jc, jnp.int32(s)))
                     for s in steps])
    got = TO.warmup_cosine(tc, torch.from_numpy(steps.astype(np.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 ** -20 * 1e-3)


def _opt_inputs(rng, mdt):
    md = jnp.bfloat16 if mdt == "bfloat16" else np.float32
    p = {"a": rng.standard_normal((256, 33)).astype(np.float32),
         "b": {"c": rng.standard_normal((7, 5)).astype(jnp.bfloat16)}}
    g = {"a": (rng.standard_normal((256, 33)) * 0.05).astype(np.float32),
         "b": {"c": (rng.standard_normal((7, 5)) * 0.05).astype(jnp.bfloat16)}}
    st = {"m": jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.01)
                            .astype(md), p),
          "v": jax.tree.map(lambda x: (rng.random(x.shape) * 1e-3)
                            .astype(md), p),
          "step": np.int32(4)}
    return p, g, st


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e9, 0.5], ids=["clip_off", "clip_on"])
def test_adamw_update_matches_reference(mdt, clip):
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=50, grad_clip=clip,
              moments_dtype=mdt)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    rng = np.random.default_rng(1)
    for _ in range(3):
        p, g, st = _opt_inputs(rng, mdt)
        jp, js, jm = JO.adamw_update(jc, jax.tree.map(jnp.asarray, p),
                                     jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, st))
        tp, ts, tm = TO.adamw_update(tc, convert.params_from_jax(p, "cpu"),
                                     convert.params_from_jax(g, "cpu"),
                                     convert.opt_state_from_jax(st, "cpu"))
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5
        assert ts["m"]["a"].dtype == tc._mdtype
        assert _same_bits(jm["lr"], tm["lr"])
        np.testing.assert_allclose(_f32(tm["grad_norm"]), _f32(jm["grad_norm"]),
                                   rtol=2 ** -22)
        bf = mdt == "bfloat16"
        for k, leaf_bf in (("a", False), ("b", True)):
            get = (lambda t: t[k]) if k == "a" else (lambda t: t["b"]["c"])
            gf, mo, vo = _f32(get(g)), _f32(get(st["m"])), _f32(get(st["v"]))
            # a bf16 grad leaf is clipped and rounded back to bf16, where
            # the norm's last bit can move it by a bf16 ulp; a param moves
            # by lr |delta| (about lr)
            for ref, port, mag, is_bf in (
                    (get(js["m"]), get(ts["m"]),
                     np.maximum(0.9 * np.abs(mo), 0.1 * np.abs(gf)),
                     bf or leaf_bf),
                    (get(js["v"]), get(ts["v"]),
                     np.maximum(0.95 * vo, 0.05 * gf * gf), bf or leaf_bf),
                    (get(jp), get(tp), np.maximum(np.abs(_f32(get(p))),
                                                  kw["lr"]), leaf_bf)):
                d = np.abs(_f32(ref).astype(np.float64) - _f32(port))
                assert (d <= 4 * _ulp(mag, is_bf)).all(), (k, d.max())


# --------------------------------------------------------------------------
# the loss, its grads, the step
# --------------------------------------------------------------------------
def test_cross_entropy_loss_masks_labels():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    jl, jg = jax.value_and_grad(JS.cross_entropy_loss)(jnp.asarray(logits),
                                                       jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = TS.cross_entropy_loss(x, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    assert (tg.numpy()[0, :4] == 0).all()
    # bf16 logits are summed in fp32; every label masked gives 0
    xb = torch.from_numpy(logits).to(torch.bfloat16)
    jb = JS.cross_entropy_loss(jnp.asarray(logits, jnp.bfloat16),
                               jnp.asarray(labels))
    np.testing.assert_allclose(float(TS.cross_entropy_loss(
        xb, torch.from_numpy(labels))), float(jb), rtol=2e-6)
    none = torch.full((3, 7), -1, dtype=torch.int32)
    assert float(TS.cross_entropy_loss(x.detach(), none)) == 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    jc, tc, jp, tp, jb, tb = _both(arch, masked=3)
    jl, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jc, remat=False)))(
        jp, jb)
    tl, tg = TS._value_and_grad(TS.make_loss_fn(tc, remat=False), tp, tb)
    assert abs(float(jl) - float(tl)) <= 1e-5
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_is_bitwise_no_remat(arch):
    _, tc, _, tp, _, tb = _both(arch)
    l0, g0 = TS._value_and_grad(TS.make_loss_fn(tc, remat=False), tp, tb)
    l1, g1 = TS._value_and_grad(TS.make_loss_fn(tc, remat=True), tp, tb)
    assert _same_bits(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert _same_bits(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """The port's counterpart of ``tests/test_arch_smoke.py::
    test_train_step_smoke``: one jitted-equivalent step, two microbatches."""
    _, tc, _, tp, _, tb = _both(arch)
    step = TS.make_train_step(tc, TO.AdamWConfig(lr=1e-3, warmup_steps=2),
                              microbatches=2)
    p2, st2, m = step(tp, TS.init_train_state(tc, tp), tb)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert int(st2["step"]) == 1
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(tree_leaves(tp), tree_leaves(p2)))


def test_train_step_matches_reference():
    jc, tc, jp, tp, jb, tb = _both("olmo-1b", b=4)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jstep = jax.jit(JS.make_train_step(jc, JO.AdamWConfig(**kw),
                                       microbatches=2))
    jp2, js2, jm = jstep(jp, JS.init_train_state(jc, jp), jb)
    tstep = TS.make_train_step(tc, TO.AdamWConfig(**kw), microbatches=2)
    tst = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, JS.init_train_state(jc, jp)), "cpu")
    tp2, ts2, tm = tstep(tp, tst, tb)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    lr = float(jm["lr"])
    _, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jc, remat=False)))(
        jp, jb)
    n_loose = n_tight = 0
    for p, a, b, g, ma, mb, va, vb in zip(
            jax.tree.leaves(jp), jax.tree.leaves(jp2), tree_leaves(tp2),
            jax.tree.leaves(jg), jax.tree.leaves(js2["m"]),
            tree_leaves(ts2["m"]), jax.tree.leaves(js2["v"]),
            tree_leaves(ts2["v"])):
        for x, y in ((ma, mb), (va, vb)):
            x, y = _f32(x), _f32(y)
            assert np.abs(x - y).max() <= 2e-5 * max(np.abs(x).max(), 1e-30)
        g = np.abs(_f32(g))
        loose = g < 1e-4 * g.max()
        d = np.abs(_f32(a).astype(np.float64) - _f32(b))
        assert (d[loose] <= 2 * lr).all()
        tight = 1e-3 * lr + 4 * _ulp(_f32(a), False)
        assert (d[~loose] <= tight[~loose]).all()
        n_loose += int(loose.sum())
        n_tight += int((~loose).sum())
    assert n_tight > 50 * n_loose        # the loose class stays a sliver


def test_fault_and_seq_axis_are_refused():
    """Only ``seq_axis`` is refused now (ROADMAP item 14b); ``fault`` is
    accepted (``tests/test_torch_train_fault.py`` holds it against the
    reference), with or beside ``unroll``."""
    cfg = get_config("olmo-1b").reduced()
    L = cfg.n_layers
    with pytest.raises(NotImplementedError, match="item 14b"):
        TS.make_loss_fn(cfg, seq_axis="seq")
    with pytest.raises(NotImplementedError, match="item 14b"):
        TS.make_train_step(cfg, TO.AdamWConfig(), seq_axis="seq",
                           fault=(torch.zeros(L), torch.zeros(L), 0))
    TS.make_train_step(cfg, TO.AdamWConfig(),
                       fault=(np.zeros(L, np.float32), None, 0))
    TS.make_loss_fn(cfg, unroll=True)         # accepted, and no effect


# --------------------------------------------------------------------------
# checkpoints and the fault-tolerant trainer (tests/test_trainer_ft.py)
# --------------------------------------------------------------------------
def _mk_trainer(d, data=None, total=12, ckpt_every=4, params=None):
    cfg = get_config("olmo-1b").reduced()
    data = data or TokenStream(vocab=cfg.vocab, seq_len=16, batch=4, seed=0)
    return TTR.Trainer(cfg, TO.AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=100),
                       TTR.TrainerConfig(total_steps=total,
                                         ckpt_every=ckpt_every, ckpt_dir=d),
                       data, params=params, device="cpu"), data


def test_checkpoint_atomic_roundtrip(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.randn(2, 3).to(torch.bfloat16)}}
    tckpt.save_checkpoint(str(tmp_path), 7, tree, extra={"data": {"step": 7}})
    assert tckpt.latest_step(str(tmp_path)) == 7
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000007", "latest"]
    restored, meta = tckpt.restore_latest(str(tmp_path), tree)
    assert meta["step"] == 7 and meta["extra"]["data"]["step"] == 7
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tckpt.restore_latest(str(tmp_path / "none"), tree) == (None, None)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_latest(str(tmp_path), {"a": torch.zeros(4),
                                             "b": {"c": torch.zeros(2, 3)}})


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert names == ["ckpt_00000004", "ckpt_00000005"]


def _mixed_tree():
    rng = np.random.default_rng(3)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "h": rng.standard_normal((5,)).astype(jnp.bfloat16),
                       "stack": [rng.standard_normal(2).astype(np.float32),
                                 np.arange(3, dtype=np.int32)]},
            "opt": {"step": np.int32(9)}}


def test_flatten_with_path_names_leaves_as_jax():
    tree = _mixed_tree()
    mine = [(tuple(p), np.asarray(jnp.asarray(leaf).astype(jnp.float32)))
            for p, leaf in tree_flatten_with_path(tree)[0]]
    theirs = [(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p),
               np.asarray(jnp.asarray(leaf).astype(jnp.float32)))
              for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        assert np.array_equal(a, b)


def test_checkpoints_cross_packages_bitwise(tmp_path):
    """A checkpoint the port writes restores bitwise in the reference, and
    the reverse, for float32, bf16 and int32 leaves in dicts and a list."""
    jtree = jax.tree.map(jnp.asarray, _mixed_tree())
    ttree = convert.params_from_jax(_mixed_tree(), "cpu")
    tckpt.save_checkpoint(str(tmp_path / "t"), 3, ttree, extra={"k": 1})
    got, meta = jckpt.restore_latest(str(tmp_path / "t"), jtree)
    assert meta == {"step": 3, "extra": {"k": 1}}
    for a, b in zip(jax.tree.leaves(got), tree_leaves(ttree)):
        assert a.dtype == jnp.dtype(str(b.dtype).removeprefix("torch."))
        assert _same_bits(a, b)
    jckpt.save_checkpoint(str(tmp_path / "j"), 4, jtree)
    templ = tree_map(torch.zeros_like, ttree)
    got, meta = tckpt.restore_latest(str(tmp_path / "j"), templ)
    assert meta["step"] == 4
    for a, b, t in zip(jax.tree.leaves(jtree), tree_leaves(got),
                       tree_leaves(templ)):
        assert b.dtype == t.dtype and _same_bits(a, b)


def test_opt_state_from_jax_bitwise():
    for mdt in ("float32", "bfloat16"):
        jst = JO.adamw_init({"a": jnp.ones((3, 2)), "b": [jnp.ones(4)]},
                            JO.AdamWConfig(moments_dtype=mdt))
        jst = jax.tree.map(lambda x: x + jnp.asarray(0.3, x.dtype), jst)
        tst = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
        assert tst["step"].dtype == torch.int32 and tst["step"].ndim == 0
        assert tst["m"]["a"].dtype == TO.AdamWConfig(moments_dtype=mdt)._mdtype
        for a, b in zip(jax.tree.leaves(jst), tree_leaves(tst)):
            assert _same_bits(a, b)
    with pytest.raises(ValueError, match="AdamW"):
        convert.opt_state_from_jax({"m": {}}, "cpu")


def test_crash_restart_is_bit_identical(tmp_path):
    """Kill-and-relaunch == uninterrupted run (checkpoint + data state)."""
    t_full, _ = _mk_trainer(str(tmp_path / "a"), total=12, ckpt_every=4)
    t_full.run()
    d2 = str(tmp_path / "b")
    t1, _ = _mk_trainer(d2, total=12, ckpt_every=4)
    t1.run(max_steps=8)           # "crash" after step 8 (ckpt at 8)
    t2, _ = _mk_trainer(d2, total=12, ckpt_every=4)
    assert t2.try_restore() and t2.step == 8 and t2.data.state_dict() == \
        {"step": 8}
    t2.run()
    for a, b in zip(tree_leaves((t_full.params, t_full.opt_state)),
                    tree_leaves((t2.params, t2.opt_state))):
        assert torch.equal(a, b)
    assert [h["loss"] for h in t_full.history[8:]] == \
        [h["loss"] for h in t2.history]


def test_straggler_detection(tmp_path):
    t, _ = _mk_trainer(str(tmp_path), total=10, ckpt_every=100)
    fired = []
    t.on_straggler = lambda step: fired.append(step)
    t.tcfg.straggler_factor = 1e-9       # every step counts as slow
    t.tcfg.straggler_patience = 3
    t.run()
    assert len(t.straggler_events) >= 3
    assert fired, "straggler callback should fire after patience exceeded"
    # and the port's watch is the reference's on the same step times
    ref = JTR.Trainer.__new__(JTR.Trainer)
    ref.tcfg, ref.on_straggler = t.tcfg, None
    ref._ema, ref._slow_streak, ref.straggler_events, ref.step = None, 0, [], 0
    mine, _ = _mk_trainer(str(tmp_path), total=10, ckpt_every=100)
    mine.tcfg = t.tcfg
    for i, dt in enumerate([1.0, 1.2, 9.0, 8.0, 0.5, 40.0, 1.0]):
        ref.step = mine.step = i
        ref._watch_stragglers(dt)
        mine._watch_stragglers(dt)
        assert (ref._ema, ref._slow_streak, ref.straggler_events) == \
            (mine._ema, mine._slow_streak, mine.straggler_events)


def test_elastic_reshard_helper():
    for n in (16, 8, 1):
        assert TTR.reshard_batch_spec(256, n) == JTR.reshard_batch_spec(256, n)
    with pytest.raises(ValueError):
        TTR.reshard_batch_spec(256, 7)


def test_trainer_runs_beside_reference(tmp_path):
    """A few steps of both trainers from the same params and stream."""
    jc = jget("olmo-1b").reduced()
    jp = jinit(jc, jax.random.PRNGKey(0))
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=100)
    ref = JTR.Trainer(jc, JO.AdamWConfig(**ocfg),
                      JTR.TrainerConfig(total_steps=6, ckpt_every=100,
                                        ckpt_dir=str(tmp_path / "j")),
                      JTokenStream(vocab=jc.vocab, seq_len=16, batch=4,
                                   seed=0), params=jp)
    mine, _ = _mk_trainer(str(tmp_path / "t"), total=6, ckpt_every=100,
                          params=convert.params_from_jax(
                              jax.tree.map(np.asarray, jp), "cpu"))
    hr, hm = ref.run(), mine.run()
    assert [h["step"] for h in hm] == [h["step"] for h in hr] == \
        list(range(1, 7))
    for a, b in zip(hr, hm):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)
        assert b["dt"] > 0


def test_compression_helpers_bitwise():
    rng = np.random.default_rng(4)
    for scale in (1e-6, 1e-3, 1.0, 300.0, 0.0):
        x = (rng.standard_normal((64, 33)) * scale).astype(np.float32)
        jq, js = JC.quant8(jnp.asarray(x))
        tq, ts = TC.quant8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and np.array_equal(np.asarray(jq),
                                                         tq.numpy())
        assert _same_bits(js, ts)
        assert _same_bits(JC.dequant8(jq, js), TC.dequant8(tq, ts))
    g = {"w": np.zeros((3, 4), np.float32),
         "b": [np.zeros(2, jnp.bfloat16)]}
    je = JC.init_error_feedback(jax.tree.map(jnp.asarray, g))
    te = TC.init_error_feedback(convert.params_from_jax(g, "cpu"))
    for a, b in zip(jax.tree.leaves(je), tree_leaves(te)):
        assert b.dtype == torch.float32 and _same_bits(a, b)


# --------------------------------------------------------------------------
# the example, at a shrunk config
# --------------------------------------------------------------------------
def test_train_lm_main_shrunk(monkeypatch, tmp_path, capsys):
    def tiny():
        return dataclasses.replace(
            get_config("olmo-1b"), name="olmo-tiny", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
            dtype="float32")
    monkeypatch.setattr(train_lm, "build_100m", tiny)
    t0 = time.perf_counter()
    hist = train_lm.main(["--steps", "12", "--seq", "8", "--batch", "4",
                          "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("model: olmo-tiny  params=")
    assert "step   10 loss=" in out and "step   12 loss=" in out
    assert f"over 12 steps (ckpts in {tmp_path})" in out
    assert len(hist) == 12 and all(np.isfinite(h["loss"]) for h in hist)
    assert time.perf_counter() - t0 < 60
    # --resume with no checkpoint (every 50 steps) starts from step 0
    hist2 = train_lm.main(["--steps", "3", "--seq", "8", "--batch", "4",
                           "--ckpt-dir", str(tmp_path), "--device", "cpu",
                           "--resume"])
    assert "resumed" not in capsys.readouterr().out and len(hist2) == 3
