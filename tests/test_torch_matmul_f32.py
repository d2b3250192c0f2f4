"""The float32-x, bf16-weight route of ``fault_matmul`` on the CPU
(``kernels/ops.py``, ``kernels/ref.py``): the hash pass's W' times float32
x, as the card runs it in two kernels a row group (``fault_weight_tiles``
and ``matmul_tiles_f32``); the exact three-way bf16 split of float32 x its
tensor-core product rests on; the K-slice plan and the launch plan.  The
kernels themselves run in ``tests/test_torch_cuda.py``.

Tolerances: the plain product over the plain hash pass is bitwise
``fault_matmul_ref`` (one fp32 ``matmul`` a row on the same operands), and
bitwise the reference's at the shape where
``test_torch_encdec.py::test_fault_matmul_f32_x_bf16_weights_matches_reference``
holds it bitwise (K = 96).  At K = 300 and 1024 XLA's CPU float32 dot and
PyTorch's sum in other orders, so there it is held within 2 K 2^-24 (|x| @
|w|), each side's worst-case fp32 accumulation error.
"""
import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.faultmodel import FAULT_MODELS  # noqa: E402

# float32 x the split is exact for: below bf16's overflow threshold
# (2 - 2^-8) 2^127 (a tie, which rounds to even: inf), and a multiple of
# 2^-133 (bf16's smallest subnormal)
X_MAX = float(np.nextafter(np.float32((2 - 2.0 ** -8) * 2.0 ** 127),
                           np.float32(0)))
QUANTUM = 2.0 ** -133


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype,hi", [(np.int8, 127), (np.int16, 2 ** 14),
                                      (np.int32, 2 ** 20)])
@pytest.mark.parametrize("M,K,N", [(7, 96, 40), (135, 300, 77)])
def test_matmul_tiles_f32_ref_is_fault_matmul_ref(M, K, N, dtype, hi, model):
    """``matmul_tiles_f32_ref`` over ``fault_weight_tiles_ref`` is
    ``fault_matmul_ref`` on float32 x with bf16 weights bitwise, three rows
    at rates 0 / 0.1 / 0.3, 6 faulty bits; against the reference's
    ``fault_matmul`` (interpret mode) row by row, bitwise at K = 96 and
    within the fp32 accumulation bound at the ragged (135, 300, 77)."""
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((3, M, K)).astype(np.float32)
    qw = rng.integers(-hi, hi, (K, N)).astype(dtype)
    rates = np.array([0.0, 0.1, 0.3], np.float32)
    scale = np.float32(0.0123 if dtype == np.int8 else 1e-4)
    tx, tq, tr = (torch.from_numpy(x), torch.from_numpy(qw),
                  torch.from_numpy(rates))
    tiles = ref.fault_weight_tiles_ref(tq, scale, 5, tr, 6, fault_model=model)
    got = ref.matmul_tiles_f32_ref(tx, tiles, K, N)
    want = ref.fault_matmul_ref(tx, tq, scale, 5, tr, 6, fault_model=model,
                                out_dtype=torch.bfloat16)
    assert got.dtype == want.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the wrappers on CPU tensors run the same plain versions
    np.testing.assert_array_equal(
        _bits(ops.matmul_tiles_f32(tx, ops.fault_weight_tiles(
            tq, scale, 5, tr, 6, fault_model=model), K, N)), _bits(got))
    w = ref.unpack_tiles(tiles, K, N).float()
    for r in range(3):
        j = np.array(jops.fault_matmul(
            jnp.asarray(x[r]), jnp.asarray(qw), scale, 5,
            jnp.float32(rates[r]), 6, fault_model=model,
            out_dtype=jnp.bfloat16))
        assert j.dtype == np.float32
        if K == 96:
            np.testing.assert_array_equal(got[r].numpy(), j, err_msg=str(r))
        else:
            tol = 2 * K * 2.0 ** -24 * torch.matmul(tx[r].abs(), w[r].abs())
            assert bool(((got[r] - torch.from_numpy(j)).abs() <= tol).all())


def test_matmul_tiles_f32_ref_keeps_the_batch_shape():
    """x ``[R, B, S, K]`` gives ``[R, B, S, N]``, each row the product of
    its flattened ``[B S, K]``."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 5, 48, generator=g)
    qw = torch.randint(-100, 100, (48, 20), generator=g, dtype=torch.int8)
    tiles = ref.fault_weight_tiles_ref(qw, 0.0123, 2, torch.tensor([0.0, 0.2]),
                                       6)
    got = ref.matmul_tiles_f32_ref(x, tiles, 48, 20)
    assert got.shape == (2, 3, 5, 20)
    for r in range(2):
        flat = ref.matmul_tiles_f32_ref(x[r:r + 1].reshape(1, 15, 48),
                                        tiles[r:r + 1], 48, 20)
        np.testing.assert_array_equal(_bits(got[r]), _bits(flat[0].reshape(
            3, 5, 20)))


def _split_is_exact(v: float):
    x = torch.tensor([v], dtype=torch.float32)
    hi, mid, lo = ref.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert total.item() == x.double().item()
    # the parts' fp32 sum in the order the accumulator adds them
    assert ((hi.float() + mid.float()) + lo.float()).item() == x.item()


_finite_f32 = st.floats(width=32, allow_nan=False, allow_infinity=False,
                        min_value=-X_MAX, max_value=X_MAX)


@given(_finite_f32.filter(lambda v: v == 0 or abs(v) >= 2.0 ** -110))
@settings(max_examples=400, deadline=None, derandomize=True)
@example(0.0)
@example(-0.0)
@example(X_MAX)
@example(-X_MAX)
@example(float(np.float32(2.0 ** -110)))
@example(float(np.float32(1 + 2.0 ** -23)))
@example(float(np.float32(-(1 - 2.0 ** -24))))
def test_split3_is_exact(v):
    """hi + mid + lo == x exactly over random, huge and tiny float32
    values and +-0."""
    _split_is_exact(v)


@given(st.integers(-(2 ** 23), 2 ** 23))
@settings(max_examples=200, deadline=None, derandomize=True)
@example(1)
@example(-1)
@example(2 ** 23 - 1)
def test_split3_is_exact_on_subnormal_range_multiples(m):
    """float32 values below 2^-110, down into the subnormals, that are
    multiples of 2^-133 (m 2^-133 with |m| < 2^24) split exactly too."""
    _split_is_exact(float(np.float32(m * QUANTUM)))


def test_split3_outside_its_domain():
    """Where the split is not exact, and why the kernel's note names its
    domain: a float32 x above (2 - 2^-8) 2^127 rounds hi to inf, and bits
    below 2^-133 (fp32's deeper subnormals) have no bf16 to go to."""
    for v in ((2 - 2.0 ** -8) * 2.0 ** 127, np.finfo(np.float32).max):
        hi, mid, lo = ref.split3(torch.tensor([v], dtype=torch.float32))
        assert torch.isinf(hi).all()
    tiny = float(np.float32(2.0 ** -149))
    hi, mid, lo = ref.split3(torch.tensor([tiny]))
    assert hi.float().item() + mid.float().item() + lo.float().item() == 0.0


_bf16_finite = st.integers(0, 0xFFFF).filter(
    lambda b: (b >> 7) & 0xFF != 0xFF)            # no inf, no NaN


def _bf16(bits: int) -> torch.Tensor:
    return torch.tensor([bits], dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)


@given(_finite_f32.filter(lambda v: v == 0 or abs(v) >= 2.0 ** -110),
       _bf16_finite)
@settings(max_examples=400, deadline=None, derandomize=True)
@example(-0.0, 0x8000)
@example(1.0, 0x0001)                 # bf16's smallest subnormal
@example(X_MAX, 0x3F80)               # x 1.0
@example(float(np.float32(2.0 ** -110)), 0x7F7F)
def test_split3_parts_times_bf16_are_exact_in_fp32(v, wbits):
    """Each part times any finite bf16 w is exact in fp32 wherever the
    exact product is 0 or lies in fp32's normal range: a part has 8
    significant bits, w 8, the product at most 16 of fp32's 24."""
    w = _bf16(wbits)
    for part in ref.split3(torch.tensor([v], dtype=torch.float32)):
        exact = part.double() * w.double()
        mag = abs(exact.item())
        if mag == 0 or 2.0 ** -126 <= mag <= float(np.finfo(np.float32).max):
            assert (part.float() * w.float()).double().item() == exact.item()


def test_f32w_k_splits_on_a_132_sm_card(monkeypatch):
    """The float32 product's K-slice count on an H100's 132 SMs at
    seamless-m4t-medium's encoder shapes (M = B Se = 256; blocks of 128 x
    128): eight at 1024 x 1024 (16 blocks a row, slices of two stages) and
    4096 x 1024, two at 1024 x 4096 (64 blocks a row); one where one row
    fills the card; never more than K has 64-deep stages."""
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    dev = torch.device("cuda")
    assert ops._k_splits(256, 1024, 1024, "f32w", dev) == 8
    assert ops._k_splits(256, 1024, 4096, "f32w", dev) == 2
    assert ops._k_splits(256, 4096, 1024, "f32w", dev) == 8
    assert ops._k_splits(2048, 2048, 2048, "f32w", dev) == 1
    assert ops._k_splits(135, 300, 77, "f32w", dev) == 5
    assert ops._k_splits(256, 64, 1024, "f32w", dev) == 1


@pytest.mark.parametrize("M,K,N", [(256, 1024, 1024), (256, 4096, 1024),
                                   (135, 300, 77)])
def test_f32w_plan_does_not_depend_on_rows(monkeypatch, M, K, N):
    """``matmul_tiles_f32`` and ``fault_matmul`` on float32 x with bf16
    weights plan an R-row call's K slices from one row's (M, K, N): R = 1
    and R = 3 ask the product for the same count (the launches stubbed, so
    this runs without a card)."""
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(ops, "_hash_launch", lambda *a: None)
    seen = []
    monkeypatch.setattr(
        ops, "_product_f32_launch",
        lambda x_ptr, tiles, out_ptr, rows, m, k, n, splits, partial_ptr:
        seen.append((rows, m, splits, partial_ptr != 0)))
    qw = torch.zeros((K, N), dtype=torch.int8)
    for R in (1, 3):
        x = torch.zeros((R, M, K))
        tiles = torch.zeros((R, ref.tile_elems(K, N)), dtype=torch.bfloat16)
        ops.matmul_tiles_f32(x, tiles, K, N)
        ops.fault_matmul(x, qw, 0.0123, 1, torch.full((R,), 0.2), 6,
                         out_dtype=torch.bfloat16)
    splits = ops._k_splits(M, K, N, "f32w", torch.device("cuda"))
    assert seen == [(R, M, splits, splits > 1) for R in (1, 1, 3, 3)]


def test_f32w_route_walks_row_groups(monkeypatch):
    """``fault_matmul`` on float32 x with bf16 weights launches the hash
    pass and the float32 product once each a row group, in row order,
    the product's x and out at the group's first row (4 bytes an
    element), and nothing else: no bf16 product, no SIMT or float32-weight
    kernel."""
    M, K, N, R = 5, 48, 20, 5
    per_row = 2 * ref.tile_elems(K, N)
    monkeypatch.setattr(ops, "WORKSPACE_BYTES", 2 * per_row)   # G = 2
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    calls = []
    monkeypatch.setattr(
        ops, "_hash_launch",
        lambda qw, out, scale_t, rates, seed, fb, model, mbu, r0=0, rows=None:
        calls.append(("hash", r0, rows)))
    monkeypatch.setattr(
        ops, "_product_f32_launch",
        lambda x_ptr, tiles, out_ptr, rows, m, k, n, splits, partial_ptr:
        calls.append(("product", x_ptr, out_ptr, rows)))
    monkeypatch.setattr(ops, "_launch", lambda *a: calls.append(a[0]))
    monkeypatch.setattr(ops, "_product_launch",
                        lambda *a: calls.append("bf16 product"))
    x = torch.zeros((R, M, K))
    qw = torch.zeros((K, N), dtype=torch.int16)
    out = ops.fault_matmul(x, qw, 0.0123, 1, torch.full((R,), 0.2), 6,
                           out_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == (R, M, N)
    groups = ops.row_groups(R, K, N)
    assert groups == [(0, 2), (2, 2), (4, 1)]
    want = []
    for r0, rows in groups:
        want += [("hash", r0, rows),
                 ("product", x.data_ptr() + 4 * r0 * M * K,
                  out.data_ptr() + 4 * r0 * M * N, rows)]
    assert calls == want
