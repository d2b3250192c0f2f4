"""The bf16 route of ``fault_matmul`` on the CPU (``kernels/ops.py``,
``kernels/ref.py``): the W' tile layout its two kernels share, the plain
versions of the hash pass and the product against the reference, the
row-group plan that bounds the workspace, and the CPU bf16 product
``ref.matmul`` against XLA's bf16 dot.  The kernels themselves run in
``tests/test_torch_cuda.py``.

Tolerances: none.  The hash pass's weights ``bf16(fp32(q') * scale)`` are
bitwise the reference's (its flips are integer, its dequantization one
IEEE product and one rounding), and XLA's CPU bf16 dot is the exact fp32
products summed in k order and rounded once, which ``ref.matmul`` computes
bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.faultmodel import FAULT_MODELS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("K,N", [(16, 128), (300, 77), (64, 256), (5, 3)])
def test_tile_layout_round_trip(K, N):
    """``pack_tiles`` puts element (k, n) where the product's descriptors
    read it: tile (k // 16, n // 128) at (n // 128 * ceil(K / 16) + k //
    16) * 2048, then (n & 7) 8 + (n >> 3 & 15) 128 + (k >> 3 & 1) 64 +
    (k & 7); padding is zero, and ``unpack_tiles`` inverts it."""
    w = torch.arange(1, K * N + 1, dtype=torch.float32).reshape(1, K, N)
    t = ref.pack_tiles(w)
    assert t.shape == (1, ref.tile_elems(K, N))
    assert torch.equal(ref.unpack_tiles(t, K, N), w)
    nK = -(-K // 16)
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    off = ((n // 128 * nK + k // 16) * 2048 + (n & 7) * 8
           + (n % 128 >> 3) * 128 + (k % 16 >> 3) * 64 + (k & 7))
    flat = t[0].numpy()
    np.testing.assert_array_equal(flat[off], w[0].numpy())
    assert (flat != 0).sum() == K * N


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("R,K,N", [(1, 2048, 2048), (70, 2048, 2048),
                                   (9, 2048, 8192), (3, 8192, 2048),
                                   (5, 7, 5), (2, 65536, 8192),
                                   (100000, 16, 128)])
def test_row_groups_plan(R, K, N, splits):
    """Each group holds at least one row; its W' fits the workspace cap
    (unless one row alone exceeds it) and its grid the launch limit (rows
    x K slices); the groups cover rows 0..R-1 in order, all of one size
    but the last.  At olmo-1b's shapes G is 32 (2048x2048) and 8 (the
    8192-wide ones)."""
    groups = ops.row_groups(R, K, N, splits)
    per_row = 2 * ref.tile_elems(K, N)
    G = groups[0][1]
    assert G >= 1 and G * splits <= 65535
    assert G * per_row <= ops.WORKSPACE_BYTES or G == 1
    assert [r0 for r0, _ in groups] == list(range(0, R, G))
    assert all(rows == G for _, rows in groups[:-1])
    assert sum(rows for _, rows in groups) == R
    if (K, N, splits) == (2048, 2048, 1):
        assert G == min(R, 32) or len(groups) > 1 and G == 32
    if (K, N, splits) in ((2048, 8192, 1), (8192, 2048, 1)):
        assert G == min(R, 8)


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype,hi", [(np.int8, 127), (np.int16, 2 ** 14),
                                      (np.int32, 2 ** 20)])
def test_fault_weight_tiles_ref_matches_reference(model, dtype, hi):
    """The hash pass's plain version, unpacked, is the reference's
    ``bitflip`` dequantized in fp32 and rounded to bf16, row by row and
    bitwise, for every fault model and storage type at 6 faulty bits."""
    rng = np.random.default_rng(3)
    K, N = 40, 150
    qw = rng.integers(-hi, hi, (K, N)).astype(dtype)
    rates = np.array([0.2, 0.0, 0.05], np.float32)
    scale = np.float32(0.0123)
    t = ops.fault_weight_tiles(torch.from_numpy(qw), scale, 17,
                               torch.from_numpy(rates), 6, fault_model=model)
    got = ref.unpack_tiles(t, K, N)
    for r, rate in enumerate(rates):
        q = jops.bitflip(jnp.asarray(qw), jnp.int32(17), jnp.float32(rate), 6,
                         fault_model=model)
        want = (q.astype(jnp.float32) * scale).astype(jnp.bfloat16)
        np.testing.assert_array_equal(
            _bits(got[r]), np.asarray(want).view(np.int16), err_msg=str(r))


def test_matmul_tiles_is_fault_matmul_cpu():
    """The product's plain version over the hash pass's plain tiles gives
    ``fault_matmul`` on the CPU bitwise, rows and all."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 5, 96, generator=g).to(torch.bfloat16)
    qw = torch.randint(-100, 100, (96, 40), generator=g, dtype=torch.int8)
    rates = torch.tensor([0.2, 0.0, 0.1])
    tiles = ops.fault_weight_tiles(qw, 0.0123, 4, rates, 6)
    got = ops.matmul_tiles(x, tiles, 96, 40)
    want = ops.fault_matmul(x, qw, 0.0123, 4, rates, 6)
    assert got.shape == want.shape == (3, 2, 5, 40)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("M,K,N", [(32, 64, 128), (32, 128, 64),
                                   (256, 512, 256), (7, 96, 40),
                                   (32, 2048, 64), (512, 1536, 128),
                                   (16, 3000, 70)])
def test_cpu_bf16_matmul_is_xla_dot(M, K, N):
    """``ref.matmul`` on bf16 CPU tensors is XLA's CPU bf16 dot bitwise:
    exact fp32 products summed in k order within blocks of 512, the
    blocks' sums in order, rounded once to bf16.  ``torch.matmul`` in bf16
    sums in another order (measured: 1 output of 8192 differs at
    32x64x128, 6 of 65536 at 256x512x256), and so does one sum over all
    of K (2 of 2048 at 32x2048x64)."""
    rng = np.random.default_rng(M + K + N)
    a = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(K, N)) * K ** -0.5, jnp.bfloat16)
    want = np.asarray(a @ b).view(np.int16)
    at = torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)
    bt = torch.from_numpy(np.asarray(b).view(np.int16).copy()).view(
        torch.bfloat16)
    np.testing.assert_array_equal(_bits(ref.matmul(at, bt)), want)
    np.testing.assert_array_equal(_bits(ref.matmul(at[None, None], bt)[0, 0]),
                                  want)


@pytest.mark.parametrize("M,K,N,want", [
    (2048, 2048, 2048, 1), (2048, 2048, 8192, 1), (2048, 8192, 2048, 1),
    (2048, 3072, 256, 8)])
def test_bf16_k_splits_on_a_132_sm_card(monkeypatch, M, K, N, want):
    """The bf16 product's K-slice count on an H100's 132 SMs: one slice at
    olmo-1b's three projections (M = B S = 2048), eight at starcoder2-3b's
    kv projection (16 blocks of 128 x 256, one a SM, slices of 6 stages)."""
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    assert ops._k_splits(M, K, N, "bf16", torch.device("cuda")) == want


@pytest.mark.parametrize("M,K,N", [(2048, 3072, 256), (64, 1024, 256),
                                   (256, 512, 384)])
def test_bf16_k_splits_do_not_depend_on_rows(monkeypatch, M, K, N):
    """``matmul_tiles`` and ``fault_matmul`` plan an R-row call's K slices
    from one row's (M, K, N): R = 1 and R = 3 ask the product for the same
    count (the launches stubbed, so this runs without a card), and one
    slice passes the kernel no workspace."""
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(ops, "_hash_launch", lambda *a: None)
    seen = []
    monkeypatch.setattr(
        ops, "_product_launch",
        lambda x_ptr, tiles, out_ptr, rows, m, k, n, splits, partial_ptr:
        seen.append((rows, m, splits, partial_ptr != 0)))
    qw = torch.zeros((K, N), dtype=torch.int8)
    for R in (1, 3):
        x = torch.zeros((R, M, K), dtype=torch.bfloat16)
        tiles = torch.zeros((R, ref.tile_elems(K, N)), dtype=torch.bfloat16)
        ops.matmul_tiles(x, tiles, K, N)
        ops.fault_matmul(x, qw, 0.0123, 1, torch.full((R,), 0.2), 6)
    splits = ops._k_splits(M, K, N, "bf16", torch.device("cuda"))
    assert seen == [(R, M, splits, splits > 1)
                    for R in (1, 1, 3, 3)]
