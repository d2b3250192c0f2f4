"""The grouped ``quant_bitflip`` (``ops.quant_bitflip_group``: one launch
pair on the card for up to 32 tensors) against the reference, BITWISE,
on the CPU, where the wrapper runs its plain version:

  * a group of mixed float32 / bfloat16 tensors at ``[R]`` and 0-d rates
    (rows at rate 0, a one-element tensor, a row length that is no
    multiple of the 16-byte vector, a leaf expanded over the rows with
    stride 0), all four fault models, 8 and 16 bits with 4 and 6 faulty:
    each output equals ``ref.quant_bitflip_ref`` on that tensor alone and
    the reference's ``quant_bitflip_ref`` row by row;
  * the launch table the wrapper hands the kernel (captured, nothing
    launched): prefix sums, strides, chunking, seeds, no copy of an
    expanded leaf, two launches a group of up to 32;
  * ``layers.corrupt_params`` on a reduced olmo-1b layer against the
    reference's ``corrupt_params``, at a 0-d rate and at ``[R]`` rates on
    the leaves expanded over the rows, in one grouped call;
  * one faulted decode step of reduced olmo-1b against the reference's,
    its corruption one grouped call a layer (7 leaves and the input).

Inputs come from numpy with a seed and go through both packages.  The
reference computes on XLA's CPU, which flushes subnormals: an all-zero
row's outputs are compared after flushing the port's (its scale is the
subnormal FLT_MIN / qmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant.fixedpoint import QuantSpec as JQuantSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.faultmodel import FAULT_MODELS, seed_u32  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.quant import QuantSpec  # noqa: E402

FAULT_ATOL = 1e-3          # tests/test_torch_decode.py's faulted-step bound


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flush(a: np.ndarray) -> np.ndarray:
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0, a) \
        .astype(np.float32)


def _group(rng):
    """(tensor, seed, rate) triples: the group every case corrupts."""
    f32 = rng.normal(size=(3, 31, 33)).astype(np.float32)
    f32[1] *= 100.0
    zero_row = rng.normal(size=(3, 40)).astype(np.float32)
    zero_row[2] = 0.0
    w = rng.normal(size=(5, 7)).astype(np.float32)
    bf = torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32)) \
        .to(torch.bfloat16)
    odd = torch.from_numpy(rng.normal(size=(2, 13)).astype(np.float32)) \
        .to(torch.bfloat16)
    return [
        (torch.from_numpy(f32), 5, torch.tensor([0.0, 0.3, 0.05])),
        (bf, -7, torch.tensor([0.0, 0.25])[1]),                  # 0-d rate
        (torch.tensor([1.5]), 11, 0.4),                          # one element
        (odd, 977, torch.tensor([0.2, 0.0])),                    # n = 13
        (torch.from_numpy(w).expand(3, 5, 7), 2 ** 31 + 3,       # stride 0
         torch.tensor([0.1, 0.0, 0.3])),
        (torch.from_numpy(zero_row), 1954, torch.tensor([0.2, 0.1, 0.3])),
    ]


def _jax_rows(x, seed, rate, fb, bits, model):
    """The reference's ``quant_bitflip_ref``, row by row for a ``[R]``
    rate (each row its own tensor, as under its vmap), float32 numpy."""
    xn = x.float().numpy()
    jdt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    r = torch.as_tensor(rate, dtype=torch.float32)

    s32 = seed_u32(seed) - (1 << 32 if seed_u32(seed) >= 1 << 31 else 0)

    def one(a, rt):
        return np.asarray(jref.quant_bitflip_ref(
            jnp.asarray(a, jdt), jnp.int32(s32), jnp.float32(rt), fb,
            JQuantSpec(bits=bits), fault_model=model).astype(jnp.float32))
    if r.ndim == 0:
        return one(xn, float(r))
    return np.stack([one(xn[i], float(r[i])) for i in range(r.shape[0])])


@pytest.mark.parametrize("bits,fb", [(8, 4), (8, 6), (16, 4), (16, 6)])
@pytest.mark.parametrize("model", FAULT_MODELS)
def test_group_matches_per_tensor_reference(model, bits, fb):
    """Each output of one grouped call is bitwise ``quant_bitflip_ref`` on
    its tensor alone (the port's plain version) and the reference's,
    row by row; a row at rate 0 is fake quantization only."""
    group = _group(np.random.default_rng(bits * 10 + fb))
    xs, seeds, rates = (list(c) for c in zip(*group))
    spec = QuantSpec(bits=bits)
    got = ops.quant_bitflip_group(xs, seeds, rates, fb, spec,
                                  fault_model=model)
    assert len(got) == len(xs)
    for y, x, s, r in zip(got, xs, seeds, rates):
        assert y.shape == x.shape and y.dtype == x.dtype
        assert y.is_contiguous()
        want = ref.quant_bitflip_ref(x, s, r, fb, spec, fault_model=model)
        assert torch.equal(y.view(torch.int16 if y.dtype == torch.bfloat16
                                  else torch.int32),
                           want.view(torch.int16 if y.dtype == torch.bfloat16
                                     else torch.int32))
        np.testing.assert_array_equal(
            _flush(y.float().numpy()),
            _jax_rows(x, s, r, fb, bits, model))
    # a row at rate 0 is its fake quantization alone; one at 0.3 is not
    fake = [ref.quant_bitflip_ref(xs[0][r], 5, 0.0, fb, spec,
                                  fault_model=model) for r in (0, 1)]
    assert torch.equal(got[0][0], fake[0])
    assert not torch.equal(got[0][1], fake[1])


@pytest.mark.parametrize("n", [1, 13, 2048, 2049, 16384, 262144, 2 ** 22,
                               2 ** 24, 2 ** 25, 3 * 2 ** 24 + 5])
def test_chunking_bounds(n):
    """A row of ``n`` elements splits into blocks of a multiple of 256
    elements, at least 2048, at most 2048 blocks (the partials a block of
    the second pass reduces), and about 256 blocks where n allows."""
    chunk = ops._qb_chunk(n)
    chunks = -(-n // chunk)
    assert chunk % 256 == 0 and chunk >= 2048
    assert chunks <= 2048 and (chunks - 1) * chunk < n <= chunks * chunk
    if 2048 * 256 <= n <= 8192 * 256:
        assert 128 <= chunks <= 256


def _captured(monkeypatch):
    """Launches recorded instead of run: (entries, partials numel, args)."""
    calls = []

    def fake_launch(fn, device, table, count, partials_ptr, total, *args):
        assert fn == "afp_quant_bitflip_group"
        assert device.type == "cpu"          # the group's tensors' device
        entries = [ops._QB_ENTRY.unpack_from(table, i * ops._QB_ENTRY.size)
                   for i in range(count)]
        calls.append((entries, total, args))

    monkeypatch.setattr(ops, "_launch", fake_launch)
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    return calls


def test_launch_table(monkeypatch):
    """The table of one launch pair: each entry's rows, row length, row
    stride (0 for a leaf expanded over the rows, read in place; a copy
    only for a row that is not contiguous), its first block the running
    sum of the rows' blocks, the seed's uint32 bits, the dtype; two
    launches counted, none for an empty tensor."""
    calls = _captured(monkeypatch)
    w = torch.randn(5, 7)
    wide = torch.randn(3, 9, 4)
    xs = [torch.randn(3, 31, 33), w.expand(3, 5, 7),
          torch.randn(2, 13, dtype=torch.bfloat16), torch.zeros(0),
          wide.transpose(1, 2), wide[:, :5], torch.randn(8, 1, 2048)]
    rates = [torch.tensor([0.1, 0.2, 0.3])] * 2 + [torch.tensor([0.2, 0.0]),
                                                    0.5] \
        + [torch.tensor([0.1, 0.2, 0.3])] * 2 + [torch.tensor(0.2)]
    seeds = [1, -1, 2 ** 33 + 5, 4, 5, 6, 7]
    ops.reset_launches()
    outs = ops.quant_bitflip_group(xs, seeds, rates, 4, QuantSpec(16))
    assert ops.launches["quant_bitflip"] == 2 and len(calls) == 1
    assert [o.shape for o in outs] == [x.shape for x in xs]
    entries, total, args = calls[0]
    assert len(entries) == 6                      # the empty tensor: none
    first = 0
    want = [(3, 31 * 33, 31 * 33, 0), (3, 35, 0, 0), (2, 13, 13, 1),
            (3, 36, 36, 0), (3, 20, 36, 0), (1, 2048 * 8, 0, 0)]
    for e, (rows, n, stride, bf16) in zip(entries, want):
        x_ptr, out_ptr, rate_ptr, en, es, fblk, er, chunk, chunks, seed, \
            ebf, vec = e
        assert (er, en, es, ebf, vec) == (rows, n, stride, bf16, 0)
        assert fblk == first and chunk == ops._qb_chunk(n)
        assert chunks == -(-n // chunk)
        first += rows * chunks
    assert total == first
    assert entries[1][0] == w.data_ptr()          # expanded: no copy
    assert entries[3][0] != wide.data_ptr()       # transposed rows: a copy
    assert entries[4][0] == wide.data_ptr()       # strided rows: in place
    assert [e[9] for e in entries] == [seed_u32(s) for s in
                                       (1, -1, 2 ** 33 + 5, 5, 6, 7)]
    assert args[1:3] == (QuantSpec(16).qmin, QuantSpec(16).qmax)


def test_groups_of_more_than_32(monkeypatch):
    """33 tensors: two launch pairs (32 + 1), four launches; no tensor,
    no launch."""
    calls = _captured(monkeypatch)
    ops.reset_launches()
    xs = [torch.randn(4) for _ in range(33)]
    ops.quant_bitflip_group(xs, list(range(33)), [0.1] * 33, 4)
    assert [len(c[0]) for c in calls] == [32, 1]
    assert ops.launches["quant_bitflip"] == 4
    assert ops.quant_bitflip_group([], [], [], 4) == []
    assert len(calls) == 2


def _olmo():
    jcfg = jget("olmo-1b").reduced()
    cfg = get_config("olmo-1b").reduced()
    jp = JT.init_lm(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


class _CountGroups:
    """``ops.quant_bitflip_group`` with its calls' sizes recorded."""

    def __init__(self, monkeypatch):
        self.sizes = []
        inner = ops.quant_bitflip_group

        def counted(xs, *a, **k):
            self.sizes.append(len(xs))
            return inner(xs, *a, **k)

        monkeypatch.setattr(ops, "quant_bitflip_group", counted)


@pytest.mark.parametrize("model", FAULT_MODELS)
def test_corrupt_params_olmo_layer_matches_reference(model, monkeypatch):
    """``layers.corrupt_params`` on a reduced olmo-1b layer (7 float
    leaves) at a 0-d rate, and on its leaves expanded over 3 rows at
    ``[3]`` rates (stride 0, as the ΔAcc path passes them): each leaf
    bitwise the reference's ``corrupt_params`` (leaf j at seed + 977 j),
    each call one grouped ``quant_bitflip``."""
    jcfg, cfg, jp, tp = _olmo()
    jblock = jax.tree.map(lambda t: t[0], jp["groups"]["b0"])
    tblock = tree_map(lambda t: t[0], tp["groups"]["b0"])
    groups = _CountGroups(monkeypatch)
    kw = dict(bits=8, faulty_bits=6, fault_model=model)
    got = TL.corrupt_params(tblock, torch.tensor(0.2), 41, **kw)
    want = JL.corrupt_params(jblock, jnp.float32(0.2), 41, **kw)
    leaves = tree_leaves(got)
    assert len(leaves) == 7
    for u, v in zip(jax.tree.leaves(want), leaves):
        np.testing.assert_array_equal(_flush(v.numpy()), np.asarray(u))
    rates = np.array([0.05, 0.0, 0.3], np.float32)
    got = TL.corrupt_params(T._row_expand(tblock, torch.from_numpy(rates)),
                            torch.from_numpy(rates), 41, **kw)
    for r in range(3):
        want = JL.corrupt_params(jblock, jnp.float32(rates[r]), 41, **kw)
        for u, v in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_array_equal(_flush(v[r].numpy()),
                                          np.asarray(u))
    assert groups.sizes == [7, 7]


def test_faulted_decode_step_matches_reference(monkeypatch):
    """Prefill of two 16-token prompts, then one decode step faulted at
    per-layer rates: logits within FAULT_ATOL of the reference's, the
    greedy tokens and the cache ``pos`` equal, and the step's corruption
    one grouped call a layer of its 7 weight leaves and its input."""
    jcfg, cfg, jp, tp = _olmo()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    w = rng.uniform(0.05, 0.3, cfg.n_layers).astype(np.float32)
    a = rng.uniform(0.05, 0.3, cfg.n_layers).astype(np.float32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=32)
    with torch.no_grad():
        tl, tc = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                           max_len=32)
    last = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    pos = np.full(2, 16, np.int32)
    jdec = jax.jit(lambda p, c, t, ps, f: JT.decode_step(
        p, jcfg, c, t, ps, fault=f))
    want, wc = jdec(jp, jc, jnp.asarray(last), jnp.asarray(pos),
                    (jnp.asarray(w), jnp.asarray(a), jnp.int32(3)))
    groups = _CountGroups(monkeypatch)
    with torch.no_grad():
        got, gc = T.decode_step(tp, cfg, tc, torch.from_numpy(last),
                                torch.from_numpy(pos),
                                fault=(torch.from_numpy(w),
                                       torch.from_numpy(a), 3))
    assert groups.sizes == [8] * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FAULT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(want, -1)))
    np.testing.assert_array_equal(gc["b0"]["pos"].numpy(),
                                  np.asarray(wc["b0"]["pos"]))
    # the clean step differs: the faults reached the logits
    with torch.no_grad():
        _, tc2 = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                           max_len=32)
        clean, _ = T.decode_step(tp, cfg, tc2, torch.from_numpy(last),
                                 torch.from_numpy(pos))
    assert not torch.equal(clean, got)

