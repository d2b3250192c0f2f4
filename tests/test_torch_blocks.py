"""The port's MoE, RG-LRU and SSD blocks (``repro_torch.models.layers``)
against the reference's, layer by layer, on inputs made from a numpy seed.

What is bitwise and what is held to a tolerance:
  * ``_assoc_scan`` replays ``jax.lax.associative_scan``'s odd/even
    recursion op for op: bitwise against the reference's eager scan at
    every length tried, odd and even.
  * ``causal_conv1d`` rounds each product and partial sum to x's dtype as
    the reference writes it: bitwise in float32 and bfloat16, the tail
    state too.
  * MoE routing (``gate_idx``) and the capacity mask (``keep``) are
    integers: identical, with pairs dropped at capacity factors 1.0 and
    0.5.
  * Everything else runs float32 transcendentals (exp, sqrt, logistic,
    softplus) that differ from XLA's CPU ones by 1-3 ulp, products summed
    in another order, and (SSD) ``torch.cumsum`` against ``jnp.cumsum``'s
    ``reduce_window``: within ``ATOL`` = 1e-5 absolute on outputs of order
    1 (measured worst: the SSD chunk scan 2.0e-6, the SSD block 9.5e-7,
    the RG-LRU block 1.2e-7, the MoE block 3.6e-7 on outputs up to 1.7,
    with 0, 10 and 32 of 64 pairs dropped at cf 2.0, 1.0, 0.5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """A numpy or jax array as a CPU tensor, bitwise (bf16 included)."""
    return convert.params_from_jax(np.asarray(a), device="cpu")


def _bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.int32)


# --------------------------------------------------------------------------
# the associative scan and the causal conv: bitwise
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S", [16, 37, 255, 256])
def test_assoc_scan_bitwise_reference(S):
    """The RG-LRU recurrence h_t = a_t h_{t-1} + b_t by the odd/even
    recursion, bitwise the reference's eager ``_rglru_scan``; a
    sequential loop is not (it sums in another order)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 24)).astype(np.float32)
    b = rng.normal(size=(2, S, 24)).astype(np.float32)
    want = np.asarray(JL._rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    got = TL._rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    # and with an incoming state, the decode path's form
    h0 = rng.normal(size=(2, 24)).astype(np.float32)
    want = np.asarray(JL._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0)))
    got = TL._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    seq, h = np.empty_like(b), np.zeros((2, 24), np.float32)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq[:, t] = h
    assert S < 4 or not np.array_equal(seq, np.asarray(JL._rglru_scan(
        jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_bitwise(dtype):
    """y and the K-1 tail, from zero padding and from a carried state."""
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(2, 13, 40)), jdt)
    w = jnp.asarray(rng.normal(size=(4, 40)) * 0.5, jdt)
    st = jnp.asarray(rng.normal(size=(2, 3, 40)), jdt)
    for state in (None, st):
        y, tail = JL.causal_conv1d(x, w, state)
        gy, gtail = TL.causal_conv1d(_t(x), _t(w),
                                     None if state is None else _t(state))
        assert gy.dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
        np.testing.assert_array_equal(_bits(gy), _jbits(y))
        np.testing.assert_array_equal(_bits(gtail), _jbits(tail))


# --------------------------------------------------------------------------
# the SSD chunk scan: several chunks, a padded last one
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S, chunk", [(16, 256), (16, 4), (37, 8), (37, 16)])
def test_ssd_chunk_scan_matches_reference(S, chunk):
    """``_ssd_chunk_scan`` called directly with ``chunk < S`` and ``S %
    chunk != 0`` (the blocks run one chunk of 256 at S = 16), from a zero
    and from a carried state: y and the last state within ``ATOL``."""
    rng = np.random.default_rng(S * 100 + chunk)
    Bsz, H, P, N = 2, 3, 4, 5
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (Bsz, S, H)).astype(np.float32)
    A = np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, N)).astype(np.float32)
    h0 = rng.normal(size=(Bsz, H, P, N)).astype(np.float32)
    for h in (None, h0):
        wy, wh = JL._ssd_chunk_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                    chunk, None if h is None
                                    else jnp.asarray(h))
        gy, gh = TL._ssd_chunk_scan(*map(torch.from_numpy, (x, dt, A, Bm,
                                                            Cm)),
                                    chunk, None if h is None
                                    else torch.from_numpy(h))
        assert gy.shape == (Bsz, S, H, P) and gh.shape == (Bsz, H, P, N)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=ATOL,
                                   rtol=0)


def test_ssd_and_rglru_blocks_match_reference():
    """One row of each block (reference params, float32): the output and
    the decode state it returns."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 16, 32)), jnp.float32)
    jp = JL.init_ssd(jax.random.PRNGKey(0), 32, expand=2, head_dim=16,
                     state=8, conv_kernel=4, dtype=jnp.float32)
    want, wst = JL.ssd_fwd(jp, x, expand=2, head_dim=16, state=8, chunk=256)
    got, gst = TL.ssd_fwd(_t_tree(jp), _t(x), expand=2, head_dim=16,
                          state=8, chunk=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(_bits(gst["conv"]), _jbits(wst["conv"]))
    np.testing.assert_allclose(gst["h"].numpy(), np.asarray(wst["h"]),
                               atol=ATOL, rtol=0)
    jp = JL.init_rglru(jax.random.PRNGKey(1), 32, 24, 4, jnp.float32)
    want, wst = JL.rglru_fwd(jp, x)
    got, gst = TL.rglru_fwd(_t_tree(jp), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(gst["h"].numpy(), np.asarray(wst["h"]),
                               atol=ATOL, rtol=0)


def _t_tree(jp):
    return convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns x
    itself above 20, one ulp off: the port takes the reference's form."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 25.0], np.float32)
    got = TL._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2.0 ** -22, atol=0)
    np.testing.assert_array_equal(got[-2:], np.logaddexp(x[-2:], 0.0)
                                  .astype(np.float32))


# --------------------------------------------------------------------------
# MoE: routing, dispatch, the block
# --------------------------------------------------------------------------
def _ref_routing(jp, x, top_k, cf):
    """The reference ``moe_fwd``'s routing and dispatch, step for step
    (``repro/models/layers.py:598-619``): ``(gate_idx, keep, C)``."""
    B, S, D = x.shape
    E = jp["router"].shape[-1]
    T = B * S
    probs = jax.nn.softmax(x.reshape(T, D).astype(jnp.float32)
                           @ jp["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    if cf <= 0 or cf >= E / top_k:
        C = T
    else:
        C = min(T, max(1, int(cf * top_k * T / E)))
    se = gate_idx.reshape(-1)[jnp.argsort(gate_idx.reshape(-1), stable=True)]
    pos = jnp.arange(T * top_k) - jnp.searchsorted(se, se, side="left")
    return np.asarray(gate_idx), np.asarray(pos < C), C


@pytest.mark.parametrize("cf", [2.0, 1.0, 0.5])
def test_moe_matches_reference(cf):
    """8 experts, top-2, 32 tokens: at cf 2.0 the reduced configs' regime
    (C = T/2, nothing dropped here), at 1.0 and 0.5 with pairs dropped
    through the overflow slot.  ``gate_idx`` and ``keep`` identical, the
    block's output within ``ATOL``."""
    rng = np.random.default_rng(3)
    D, E, F, k = 32, 8, 24, 2
    jp = JL.init_moe(jax.random.PRNGKey(4), D, E, F, "silu_glu", jnp.float32)
    x = jnp.asarray(rng.normal(size=(2, 16, D)), jnp.float32)
    tp = _t_tree(jp)
    gi, keep, C = _ref_routing(jp, x, k, cf)
    xt = _t(x).reshape(32, D)
    _, tgi = TL.moe_route(tp["router"], xt, k)
    assert TL.moe_capacity(32, E, k, cf) == C
    order, slot, tkeep = TL.moe_dispatch(tgi, C, E)
    np.testing.assert_array_equal(tgi.numpy(), gi)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert (slot[~tkeep] == E * C).all() and len(set(slot[tkeep].tolist())) \
        == int(tkeep.sum())
    assert keep.all() == (cf == 2.0), (cf, keep.sum())
    want = JL.moe_fwd(jp, x, top_k=k, act="silu_glu", capacity_factor=cf)
    got = TL.moe_fwd(tp, _t(x), top_k=k, act="silu_glu", capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # a dropped pair contributes nothing: tokens with both pairs dropped
    # come out exactly zero in both
    both = ~keep.reshape(-1)[np.argsort(np.argsort(gi.reshape(-1),
                                                   kind="stable"))] \
        .reshape(32, k).any(-1)
    assert not np.asarray(want).reshape(32, D)[both].any()
    assert not got.reshape(32, D)[torch.from_numpy(both)].any()


def test_moe_ties_break_toward_lower_expert():
    """A zero router makes every expert tie: ``jax.lax.top_k`` takes the
    lowest indices, and so does the port's stable sort."""
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(0))
    vals, idx = TL.moe_route(torch.zeros(16, 8), x, 2)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.zeros((40, 8)), -1), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == [0, 1]).all() and torch.equal(
        vals, torch.full((40, 2), 0.5))


def test_moe_refuses_top_k_above_two():
    p = TL.init_moe(torch.Generator().manual_seed(0), 16, 4, 8, "silu_glu",
                    torch.float32)
    with pytest.raises(NotImplementedError, match="top_k <= 2"):
        TL.moe_fwd(p, torch.zeros(1, 4, 16), top_k=3, act="silu_glu")


# --------------------------------------------------------------------------
# bitflip dequantizes straight to the leaf's dtype
# --------------------------------------------------------------------------
@pytest.mark.parametrize("leaf_dtype", ["float32", "bfloat16"])
def test_bitflip_dequant_to_leaf_dtype_bitwise(leaf_dtype):
    """A resident leaf corrupted by ``bitflip`` with the fused dequant in
    the leaf's dtype is the reference's ``(q'.astype(f32) * scale)
    .astype(dtype)`` bitwise (``layers.py:197-201``), one row a rate."""
    rng = np.random.default_rng(5)
    w = jnp.asarray(rng.normal(size=(6, 50)), jnp.dtype(leaf_dtype))
    jq = JL.quantize_leaf(w, 8)
    tq = convert.quant_params_from_jax({"w": jq}, device="cpu")["w"]
    rates = np.array([0.0, 0.05, 0.3], np.float32)
    got = TL.maybe_corrupt(tq, torch.from_numpy(rates), 77, faulty_bits=6)
    assert got.dtype == tq.dtype and got.shape == (3, 6, 50)
    for r, rate in enumerate(rates):
        want = JL.maybe_corrupt(jq, jnp.float32(rate), 77, faulty_bits=6)
        np.testing.assert_array_equal(_bits(got[r]), _jbits(want))
    via32 = ops.bitflip(tq.qw, 77, torch.from_numpy(rates), 6,
                        scale=tq.scale)
    assert via32.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(via32.to(tq.dtype)))
