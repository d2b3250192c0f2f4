"""Training with fault injection (``make_loss_fn`` / ``make_train_step``
with ``fault=``) against the reference's, on the CPU, and the gradient of
``ops.quant_bitflip_group`` under autograd against ``jax.grad`` of the
reference's ``quant_bitflip_ref``.

The reference's fault-injected gradient is no straight-through estimator:
``round`` has a zero derivative, so a corrupted tensor's gradient flows
through its row scale ``max(amax, tiny) / qmax`` alone and lands on the
entries of largest magnitude (``ref.quant_bitflip_grad_ref``).  Each
leaf's set of nonzero gradient entries is therefore compared for
EQUALITY; the values carry other summation orders, so they are held to
bounds.  A corrupted leaf's nonzero entry is ``d scale = sum_j g_j q'_j``
of its row over ``qmax``, whose terms may cancel: a relative change of
the cotangent ``g`` moves it by that change times ``sum_j |g_j q'_j| /
qmax`` (its room, ``repro_torch.testing.grad_room``), however small the
entry.  So:

  * ``make_loss_fn(fault=...)`` on the ten reduced configs (MoE at
    capacity factor 0), rates from a numpy seed per layer, against
    ``jax.jit(jax.value_and_grad(...))`` of the reference's: loss within
    1e-4 absolute (measured at most 2.7e-5, seamless-m4t-medium); each
    gradient entry within 1e-3 of its leaf's largest plus 1e-3 of its
    room (0 on a leaf no fault touches).  Measured: the leaves without a
    fault (embedding, head, final norm) within 6.0e-4 of their largest
    (recurrentgemma-2b), every corrupted leaf's entries within 2.5e-3 of
    their room and 4.0e-4 of their leaf's largest (mamba2-2.7b's
    ``A_log``), but for mixtral-8x7b's ``wk``: its one nonzero entry a
    layer is a sum that cancels, 7.1e-3 of the largest and 4.2e-6 of its
    room;
  * one two-microbatch ``make_train_step(fault=...)`` step against the
    reference's jitted step: loss, grad norm and lr within 1e-5 relative,
    ``m`` and ``v`` within 1e-3 of the leaf's largest (measured at most
    1.1e-4), params within 2 lr
    where the grad is below 1e-4 of the leaf's largest (opposite signs
    possible), else within 1e-3 lr + 4 ulps (AdamW's first step is lr
    sign(g));
  * ``remat=True`` bitwise ``remat=False`` under faults;
  * the autograd node's backward (its plain forward on the CPU) against
    ``jax.grad`` of ``quant_bitflip_ref`` (``jax.vmap``-ed over ``[R]``
    rows): float32 and bf16, one row and three, a row with two tied
    maxima, an all-zero tensor, a tensor whose largest entry is exactly
    the float32 ``tiny`` (``maximum``'s tie: half); 16 bits with 0, 4
    and 16 faulty bits, and 8 bits with 16 (a fault window wider than
    the format takes q' beyond it):
    the nonzero entries equal and each within 2^-20 sum|g q'| / qmax of
    its row plus half an ulp of the dtype (measured: bf16 bitwise,
    float32 within 1.9e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.kernels.ref import quant_bitflip_ref as jqb  # noqa: E402
from repro.models.transformer import init_lm as jinit  # noqa: E402
from repro.quant.fixedpoint import QuantSpec as JQuantSpec  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import QuantSpec  # noqa: E402
from repro_torch.testing.grad_room import scale_grad_room  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

B, S = 2, 16
LOSS_ATOL, GRAD_RTOL = 1e-4, 1e-3
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _same_bits(a, b) -> bool:
    x, y = _f32(a), _f32(b)
    return x.shape == y.shape and np.array_equal(x.view(np.int32),
                                                 y.view(np.int32))


def _both(arch, b=B, seed=0):
    """(reference cfg, port cfg, reference params, port params, reference
    batch, port batch, numpy fault rates (w, a) by layer)."""
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    if jc.is_moe:
        jc = dataclasses.replace(jc, moe_capacity_factor=0.0)
        tc = dataclasses.replace(tc, moe_capacity_factor=0.0)
    jp = jinit(jc, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    nb = {}
    if jc.frontend in ("vision", "audio") and not jc.is_encdec:
        nb["embeds"] = rng.standard_normal((b, S, jc.d_model)).astype(
            np.float32)
    else:
        nb["tokens"] = rng.integers(0, jc.vocab, (b, S)).astype(np.int32)
    if jc.is_encdec:
        nb["enc_embeds"] = rng.standard_normal(
            (b, max(1, S // jc.enc_ratio), jc.d_model)).astype(np.float32)
    nb["labels"] = rng.integers(0, jc.vocab, (b, S)).astype(np.int32)
    L = jc.n_layers + (jc.n_enc_layers if jc.is_encdec else 0)
    rates = tuple(rng.uniform(0.05, 0.3, L).astype(np.float32)
                  for _ in range(2))
    return (jc, tc, jp, tp, {k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()}, rates)


def _faults(rates, seed=5):
    """The same fault triple for the reference and the port."""
    return ((jnp.asarray(rates[0]), jnp.asarray(rates[1]), seed),
            (torch.from_numpy(rates[0]), torch.from_numpy(rates[1]), seed))


# --------------------------------------------------------------------------
# the loss and its gradient through the faulted forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_faulted_loss_and_grads_match_reference(arch):
    jc, tc, jp, tp, jb, tb, rates = _both(arch)
    jf, tf = _faults(rates)
    jl, jg = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(jc, remat=False, fault=jf)))(jp, jb)
    loss_fn = TS.make_loss_fn(tc, remat=False, fault=tf)
    tl, tg = TS._value_and_grad(loss_fn, tp, tb)
    assert abs(float(jl) - float(tl)) <= LOSS_ATOL
    room = scale_grad_room(lambda p: TS._value_and_grad(loss_fn, p, tb)[1],
                           tp)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    sparse = 0
    for a, b, r in zip(jleaves, tleaves, tree_leaves(room)):
        a, b, r = _f32(a), _f32(b), _f32(r)
        assert a.shape == b.shape
        assert np.array_equal(a != 0, b != 0)
        assert (np.abs(a - b) <= GRAD_RTOL * (np.abs(a).max() + r)).all()
        sparse += int(0 < (a != 0).sum() <= 4 < a.size)
    assert sparse > 0          # corrupted leaves: a few entries, no STE


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_faulted_remat_is_bitwise_no_remat(arch):
    _, tc, _, tp, _, tb, rates = _both(arch)
    _, tf = _faults(rates)
    l0, g0 = TS._value_and_grad(TS.make_loss_fn(tc, remat=False, fault=tf),
                                tp, tb)
    l1, g1 = TS._value_and_grad(TS.make_loss_fn(tc, remat=True, fault=tf),
                                tp, tb)
    assert _same_bits(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert _same_bits(a, b)


def test_faulted_train_step_matches_reference():
    jc, tc, jp, tp, jb, tb, rates = _both("olmo-1b", b=4)
    jf, tf = _faults(rates)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jstep = jax.jit(JS.make_train_step(jc, JO.AdamWConfig(**kw),
                                       microbatches=2, fault=jf))
    jp2, js2, jm = jstep(jp, JS.init_train_state(jc, jp), jb)
    tstep = TS.make_train_step(tc, TO.AdamWConfig(**kw), microbatches=2,
                               fault=tf)
    tst = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, JS.init_train_state(jc, jp)), "cpu")
    tp2, ts2, tm = tstep(tp, tst, tb)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    lr = float(jm["lr"])
    _, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(
        jc, remat=False, fault=jf)))(jp, jb)
    n_loose = n_tight = 0
    for a, b, g, ma, mb, va, vb in zip(
            jax.tree.leaves(jp2), tree_leaves(tp2), jax.tree.leaves(jg),
            jax.tree.leaves(js2["m"]), tree_leaves(ts2["m"]),
            jax.tree.leaves(js2["v"]), tree_leaves(ts2["v"])):
        for x, y in ((ma, mb), (va, vb)):
            x, y = _f32(x), _f32(y)
            assert np.abs(x - y).max() <= GRAD_RTOL * max(np.abs(x).max(),
                                                          1e-30)
        g = np.abs(_f32(g))
        loose = g < 1e-4 * g.max()
        d = np.abs(_f32(a).astype(np.float64) - _f32(b))
        assert (d[loose] <= 2 * lr).all()
        a32 = _f32(a)
        tight = 1e-3 * lr + 4 * np.spacing(np.abs(a32)).astype(np.float64)
        assert (d[~loose] <= tight[~loose]).all()
        n_loose += int(loose.sum())
        n_tight += int((~loose).sum())
    assert n_tight > 0 and n_loose > 0


# --------------------------------------------------------------------------
# the autograd node against jax.grad of the reference's quant_bitflip_ref
# --------------------------------------------------------------------------
def _case_x(rng, case, shape, R):
    x = rng.standard_normal(shape).astype(np.float32)
    rows = x.reshape(R, -1)
    if case == "tie":
        rows[:, 3], rows[:, 7] = 4.0, -4.0
    elif case == "zero":
        x[:] = 0
    elif case == "tiny":
        x[:] = 0
        rows[:, 2] = TINY
    return x


def _jax_grad(x, g, rates, fb, spec, seed):
    js = JQuantSpec(spec.bits)
    if rates.ndim == 0:
        def f(x):
            return jnp.sum(jqb(x, jnp.int32(seed), rates, fb, js)
                           .astype(jnp.float32) * g.astype(jnp.float32))
    else:
        def f(x):
            y = jax.vmap(lambda xr, r: jqb(xr, jnp.int32(seed), r, fb, js))(
                x, rates)
            return jnp.sum(y.astype(jnp.float32) * g.astype(jnp.float32))
    return _f32(jax.jit(jax.grad(f))(x))


def _bound(x, q, g, spec, dtype):
    """2^-20 sum_j |g_j q'_j| / qmax of each row, plus half an ulp."""
    R = q.shape[0]
    s = (g.reshape(R, -1).float().abs() * q.float().abs()).sum(1) \
        * spec.inv_qmax
    return (2.0 ** -20 * s)[:, None].expand(R, x.numel() // R).reshape(
        x.shape).numpy(), 2.0 ** -(8 if dtype == torch.bfloat16 else 24)


@pytest.mark.parametrize("bits,fb", [(16, 0), (16, 4), (16, 16), (8, 16)])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_backward_matches_jax_grad(dtype, rows, bits, fb):
    rng = np.random.default_rng(10 * rows + fb)
    spec = QuantSpec(bits)
    shape = (37, 5) if rows == 1 else (3, 11, 7)
    rates = np.float32(0.2) if rows == 1 else np.array([0.2, 0.0, 0.5],
                                                       np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for case in ("rand", "tie", "zero", "tiny"):
        x = torch.from_numpy(_case_x(rng, case, shape, rows)).to(dtype)
        g = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
        want = _jax_grad(jnp.asarray(_f32(x)).astype(jdt),
                         jnp.asarray(_f32(g)).astype(jdt),
                         jnp.asarray(rates), fb, spec, 3)
        xt = x.clone().requires_grad_(True)
        r = torch.from_numpy(np.asarray(rates))
        (y,) = ops.quant_bitflip_group([xt], [3], [r], fb, spec)
        assert y.grad_fn is not None
        with torch.no_grad():
            assert _same_bits(y, ref.quant_bitflip_ref(x, 3, r, fb, spec))
        y.backward(g)
        got = _f32(xt.grad)
        assert np.array_equal(got != 0, want != 0), case
        _, q = ref.quant_bitflip_q_ref(x, 3, r, fb, spec)
        tol, half_ulp = _bound(x, q, g, spec, dtype)
        assert (np.abs(got - want) <= tol + half_ulp * np.abs(want)).all(), \
            case
        if case == "tie":
            assert ((got != 0).reshape(rows, -1).sum(1) == 2).all()
        if case == "zero":
            assert not got.any()
        if case == "tiny":         # maximum's tie with tiny: half of d amax
            plain = x.clone().requires_grad_(True)
            ref.quant_bitflip_ref(plain, 3, r, fb, spec).backward(g)
            ratio = got[got != 0] / _f32(plain.grad)[got != 0]
            assert np.allclose(ratio, 0.5)   # clamp_min gives it whole


def test_group_under_grad_keeps_rows_leaves_and_none_grads():
    """One autograd node for a mixed group: outputs bitwise the call
    without grad; a leaf expanded over ``[R]`` rows gets the sum of its
    rows' gradients; a tensor that needs no grad gets none; an unused
    output contributes nothing; 33 tensors go through as one node."""
    rng = np.random.default_rng(3)
    spec = QuantSpec(16)
    w = torch.from_numpy(rng.standard_normal((6, 4)).astype(
        np.float32)).requires_grad_(True)
    act = torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    frozen = torch.from_numpy(rng.standard_normal(9).astype(np.float32))
    rows = torch.tensor([0.2, 0.0, 0.5])
    extra = [torch.from_numpy(rng.standard_normal(7).astype(np.float32))
             .requires_grad_(True) for _ in range(30)]
    xs = [w.expand(3, 6, 4), act, frozen] + extra
    rates = [rows, rows, 0.3] + [0.1] * 30
    seeds = list(range(33))
    ys = ops.quant_bitflip_group(xs, seeds, rates, 4, spec)
    with torch.no_grad():
        want = ops.quant_bitflip_group([x.detach() for x in xs], seeds,
                                       rates, 4, spec)
    assert all(_same_bits(a, b) for a, b in zip(ys, want))
    assert len({id(y.grad_fn) for y in ys}) == 1
    gw = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
    ga = torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).to(torch.bfloat16)
    torch.autograd.backward([ys[0], ys[1]], [gw, ga])
    per_row = ref.quant_bitflip_grad_ref(
        xs[0].detach(), ref.quant_bitflip_q_ref(xs[0].detach(), 0, rows, 4,
                                                spec)[1], gw, spec)
    assert _same_bits(w.grad, per_row.sum(0))
    assert act.grad.dtype == torch.bfloat16 and act.grad.shape == (3, 5)
    assert all(t.grad is None for t in extra)


def test_launch_passes_q_buffers(monkeypatch):
    """The launch the autograd node's forward hands the kernel (captured,
    nothing launched): one int32 q' buffer a tensor with elements, in the
    entries' order, at 16 bits with 4 faulty and with 16 faulty (q'
    beyond the format); none without a gradient; 33 tensors take two
    launch pairs."""
    calls = []

    def fake_launch(fn, device, table, count, partials, total, model, qmin,
                    qmax, fb, mbu, q_ptrs):
        calls.append((count, q_ptrs))

    monkeypatch.setattr(ops, "_launch", fake_launch)
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    xs = [torch.randn(3, 4), torch.zeros(0)] + [torch.randn(5)
                                                for _ in range(31)]
    rates = [torch.tensor([0.1, 0.2, 0.3])] + [0.2] * 32
    _, qs = ops._qb_forward(xs, list(range(33)), rates, 4, QuantSpec(16),
                            "flip", 2, keep_q=True)
    assert [c[0] for c in calls] == [31, 1]          # the empty: no entry
    assert [q.shape for q in qs[:2]] == [(3, 4), (1, 0)]
    assert all(q.dtype == torch.int32 for q in qs)
    ptrs = [q.data_ptr() for i, q in enumerate(qs) if i != 1]
    got = [int.from_bytes(c[1][8 * i:8 * i + 8], "little")
           for c in calls for i in range(c[0])]
    assert got == ptrs
    calls.clear()
    _, qs = ops._qb_forward(xs[:1], [0], rates[:1], 16, QuantSpec(16),
                            "flip", 2, keep_q=True)
    assert qs[0].dtype == torch.int32 and calls[0][1] is not None
    calls.clear()
    ops.quant_bitflip_group(xs[:1], [0], rates[:1], 4)
    assert calls == [(1, None)]


def test_kernels_without_backward_refuse_grad():
    """``bitflip``, ``fault_matmul`` and the bf16 route's kernels raise
    under grad with an input that requires grad (on any device: the
    reference never trains through them); under ``no_grad`` they run."""
    qw = torch.randint(-100, 100, (16, 8), dtype=torch.int8)
    scale = torch.tensor(0.01, requires_grad=True)
    x = torch.randn(4, 16, requires_grad=True)
    tiles = ref.fault_weight_tiles_ref(qw, 0.01, 1, 0.2, 4)
    calls = [lambda: ops.bitflip(qw, 1, 0.2, 4, scale=scale),
             lambda: ops.fault_matmul(x, qw, 0.01, 1, 0.2, 4),
             lambda: ops.fault_weight_tiles(qw, scale, 1, 0.2, 4),
             lambda: ops.matmul_tiles(x.to(torch.bfloat16)[None], tiles,
                                      16, 8),
             lambda: ops.matmul_tiles_f32(x[None], tiles, 16, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
