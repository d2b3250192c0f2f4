"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside its fixture, never at import)
when no NVIDIA card is present.  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.faultmodel import FAULT_MODELS  # noqa: E402
from repro_torch.quant import QuantSpec  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same_bits(a, b):
    if a.is_floating_point():
        a, b = a.float().view(torch.int32), b.float().view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_bitflip_kernel_bitwise(dev, model, dtype):
    rates = torch.tensor([0.0, 1e-3, 0.3], device=dev)
    for shape in ((1,), (129,), (33, 17, 3)):
        q = torch.randint(-100, 100, shape, dtype=dtype, device=dev)
        for seed in (42, -7):
            k = ops.bitflip(q, seed, rates, 4, fault_model=model)
            assert _same_bits(k, ref.bitflip_ref(q, seed, rates, 4,
                                                 fault_model=model))
    assert ops.launches["bitflip"] > 0


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_bitflip_kernel_bitwise(dev, model, dtype):
    x = torch.randn(3, 31, 33, 7, device=dev).to(dtype)
    x[0] = 0
    rates = torch.tensor([0.25, 0.0, 0.1], device=dev)
    for spec in (QuantSpec(8), QuantSpec(16)):
        k = ops.quant_bitflip(x, 9, rates, 4, spec, fault_model=model)
        assert _same_bits(k, ref.quant_bitflip_ref(x, 9, rates, 4, spec,
                                                   fault_model=model))


@pytest.mark.parametrize("model", FAULT_MODELS)
def test_fault_matmul_kernel(dev, model):
    K, N = 300, 77
    qw = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev)
    rates = torch.tensor([0.0, 0.2], device=dev)
    scale = torch.tensor(0.01, device=dev)
    w = ref.bitflip_ref(qw, 5, rates, 4, fault_model=model).float() * scale
    eye = torch.eye(K, device=dev).expand(2, K, K).contiguous()
    assert _same_bits(ops.fault_matmul(eye, qw, scale, 5, rates, 4,
                                       fault_model=model), w)
    x = torch.randn(2, 3, 45, K, device=dev)
    got = ops.fault_matmul(x, qw, scale, 5, rates, 4, fault_model=model)
    want = ref.fault_matmul_ref(x, qw, scale, 5, rates, 4, fault_model=model)
    tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w[:, None].abs())
    assert bool(((got - want).abs() <= tol).all())
    assert np.isfinite(got.cpu().numpy()).all()


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_bitflip_kernel_fused_dequant(dev, model, dtype):
    """With a scale the kernel writes float(q') * scale in the same pass,
    bitwise the cast and multiply of the integer output."""
    rates = torch.tensor([0.0, 1e-3, 0.3], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    for shape in ((1,), (130,), (3, 3, 64, 32)):
        q = torch.randint(-100, 100, shape, dtype=dtype, device=dev)
        k = ops.bitflip(q, 11, rates, 4, fault_model=model, scale=scale)
        want = ref.bitflip_ref(q, 11, rates, 4, fault_model=model).float() * scale
        assert k.dtype == torch.float32 and _same_bits(k, want)
        assert _same_bits(k, ref.bitflip_ref(q, 11, rates, 4, fault_model=model,
                                             scale=scale))


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_bitflip_kernel_dequant_bf16(dev, model, dtype):
    """Dequantized straight to bf16: bf16(float(q') * scale), one rounding,
    bitwise the float32 output cast, at lengths that take the vector and
    the scalar loop."""
    rates = torch.tensor([0.0, 1e-3, 0.3], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    for shape in ((1,), (130,), (3, 3, 64, 32), (4, 2561)):
        q = torch.randint(-100, 100, shape, dtype=dtype, device=dev)
        k = ops.bitflip(q, 11, rates, 6, fault_model=model, scale=scale,
                        dtype=torch.bfloat16)
        f = ops.bitflip(q, 11, rates, 6, fault_model=model, scale=scale)
        assert k.dtype == torch.bfloat16 and k.shape == (3, *shape)
        assert torch.equal(k.view(torch.int16),
                           f.to(torch.bfloat16).view(torch.int16))
        want = ref.bitflip_ref(q, 11, rates, 6, fault_model=model,
                               scale=scale, dtype=torch.bfloat16)
        assert torch.equal(k.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shape", [(512, 512, 16), (135, 300, 77),
                                   (45, 301, 5), (600, 64, 130)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_fault_matmul_kernel_shapes(dev, shape, dtype):
    """ResNet18's fc (M=512, K=512, N=16), ragged K and N (K % 4 != 0
    takes the 4-byte x loads), and M past one 512-row block; int8 runs the
    tensor-core body, int16/int32 the SIMT one."""
    M, K, N = shape
    hi = {torch.int8: 127, torch.int16: 2 ** 14, torch.int32: 2 ** 20}[dtype]
    qw = torch.randint(-hi, hi, (K, N), dtype=dtype, device=dev)
    rates = torch.tensor([0.2, 1e-3], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    w = ref.bitflip_ref(qw, 3, rates, 4).float() * scale
    eye = torch.eye(K, device=dev).expand(2, K, K).contiguous()
    assert _same_bits(ops.fault_matmul(eye, qw, scale, 3, rates, 4), w)
    x = torch.randn(2, M, K, device=dev)
    got = ops.fault_matmul(x, qw, scale, 3, rates, 4)
    want = ref.fault_matmul_ref(x, qw, scale, 3, rates, 4)
    tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_fault_matmul_rows_match_one_row_calls(dev, dtype):
    """Each row of an R-row call sums in the order a one-row call does (the
    K-slice count is chosen per row): bitwise, at ResNet18's fc and at a
    shape whose slice count would have changed with R."""
    for M, K, N in ((512, 512, 16), (512, 4096, 1024)):
        qw = torch.randint(-100, 100, (K, N), dtype=dtype, device=dev)
        rates = torch.tensor([0.2, 0.0, 1e-3, 0.2, 0.1], device=dev)
        scale = torch.tensor(0.0123, device=dev)
        x = torch.randn(5, M, K, device=dev)
        many = ops.fault_matmul(x, qw, scale, 9, rates, 4)
        for r in range(5):
            one = ops.fault_matmul(x[r:r + 1].contiguous(), qw, scale, 9,
                                   rates[r:r + 1], 4)
            assert _same_bits(many[r:r + 1], one)


@pytest.mark.parametrize("name", ["alexnet", "squeezenet", "resnet18"])
def test_model_rows_match_one_row_calls(dev, name):
    """A whole forward over R rows gives, in each row, the logits of that
    row run alone (kernel backend: per-row conv weights from ``bitflip``,
    ``quant_bitflip`` per row, ``fault_matmul``), bitwise."""
    from repro_torch import cnn_setup
    from repro_torch.models import cnn as tcnn

    m = tcnn.CNN_MODELS[name]
    params = m.init(1, 16, width=0.25, img=32, device=dev)
    qp = tcnn.quantize_unit_params(params)
    x, _ = cnn_setup.eval_batch(64, device=dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    wr = (torch.rand(6, m.n_units, generator=g) * 0.3).to(dev)
    ar = (torch.rand(6, m.n_units, generator=g) * 0.1).to(dev)
    with torch.no_grad():
        many = m.apply(qp, x, wr, ar, 5)
        for r in range(6):
            assert _same_bits(many[r:r + 1],
                              m.apply(qp, x, wr[r:r + 1], ar[r:r + 1], 5))


@pytest.mark.parametrize("name", ["alexnet", "squeezenet", "resnet18"])
def test_staged_matches_full_bitwise_on_card(dev, name):
    """Staged (fused and unfused, chunks of up to 4 rows) against the whole
    forward (one row a chunk), kernel backend, bitwise ΔAcc; the model's
    kernels launch on the staged path (SqueezeNet has no dense layer, so
    no ``fault_matmul``)."""
    from repro_torch import cnn_setup
    from repro_torch.core import FaultSpec
    from repro_torch.models import cnn as tcnn

    m = tcnn.CNN_MODELS[name]
    params = m.init(2, 16, width=0.25, img=32, device=dev)
    labels = cnn_setup.clean_argmax_labels(name, params, 64, device=dev)
    spec = FaultSpec(weight_fault_rate=0.2, act_fault_rate=0.2)
    rng = np.random.default_rng(3)
    P = rng.integers(0, 2, size=(10, m.n_units))
    P[5:, :4] = P[0, :4]                  # shared prefixes
    res = {}
    for strategy, fuse, ebs in (("full", True, 1), ("staged", False, 4),
                                ("staged", True, 4)):
        ev = cnn_setup.make_evaluator(name, params, spec, n_eval=64,
                                      eval_batch_size=ebs, labels=labels,
                                      eval_strategy=strategy,
                                      fuse_chains=fuse, device=dev)
        ops.reset_launches()
        res[(strategy, fuse)] = ev.delta_acc(P)
        if strategy == "staged":
            used = [k for k in ("bitflip", "quant_bitflip", "fault_matmul")
                    if k != "fault_matmul" or name != "squeezenet"]
            assert min(ops.launches[k] for k in used) > 0, ops.launches
            assert ev.staged_stats()["unit_runs_avoided"] > 0
    for key, v in res.items():
        np.testing.assert_array_equal(v, res[("full", True)], err_msg=str(key))


def _bf16_weights(qw, seed, rates, scale):
    """bf16(fp32(q') * scale): the weights a bf16 x multiplies."""
    return ref.bitflip_ref(qw, seed, rates, 4, scale=scale).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2048, 256, 128), (135, 300, 77),
                                   (45, 64, 5)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_fault_matmul_bf16_x(dev, shape, dtype):
    """bf16 x on the tensor cores with int8 and int32 weights: bf16 out,
    bitwise bf16(q' scale) at x = I_K, and at random x within both sides'
    fp32 accumulation error plus one bf16 rounding each (2^-8 of the
    magnitude); ragged K and N take the plain x loads and narrow tiles."""
    M, K, N = shape
    hi = {torch.int8: 127, torch.int32: 2 ** 15 - 1}[dtype]
    qw = torch.randint(-hi, hi, (K, N), dtype=dtype, device=dev)
    rates = torch.tensor([0.2, 1e-3], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    w = _bf16_weights(qw, 3, rates, scale)
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16).expand(2, K, K)
    got = ops.fault_matmul(eye.contiguous(), qw, scale, 3, rates, 4)
    assert got.dtype == torch.bfloat16 and _same_bits(got, w)
    x = torch.randn(2, M, K, device=dev).to(torch.bfloat16)
    got = ops.fault_matmul(x, qw, scale, 3, rates, 4).float()
    with torch.no_grad():
        from repro_torch._device import fp32_exact
        with fp32_exact():
            want = ref.fault_matmul_ref(x, qw, scale, 3, rates, 4).float()
    mag = torch.matmul(x.float().abs(), w.float().abs())
    tol = 2 * K * 2.0 ** -24 * mag + 2.0 ** -8 * (got.abs() + want.abs()) * 1.01
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_fault_matmul_bf16_rows_match_one_row_calls(dev, dtype):
    """An R-row bf16 call equals R one-row calls bitwise, at olmo-1b's
    2048x2048 projection (one K slice a row) and at a shape that splits
    K (M = 64)."""
    for M, K, N in ((2048, 2048, 2048), (64, 1024, 256)):
        qw = torch.randint(-100, 100, (K, N), dtype=dtype, device=dev)
        rates = torch.tensor([0.2, 0.0, 1e-3], device=dev)
        scale = torch.tensor(0.0123, device=dev)
        x = torch.randn(3, M, K, device=dev).to(torch.bfloat16)
        many = ops.fault_matmul(x, qw, scale, 9, rates, 4)
        for r in range(3):
            one = ops.fault_matmul(x[r:r + 1].contiguous(), qw, scale, 9,
                                   rates[r:r + 1], 4)
            assert _same_bits(many[r:r + 1], one)


def _shrink_workspace(monkeypatch, K, N, rows):
    """Make the bf16 route's row groups ``rows`` rows at (K, N)."""
    monkeypatch.setattr(ops, "WORKSPACE_BYTES",
                        rows * 2 * ref.tile_elems(K, N))
    G = ops.row_groups(10 ** 6, K, N)[0][1]
    assert G == rows
    return G


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_fault_weight_tiles_bitwise(dev, monkeypatch, model, dtype):
    """The bf16 route's hash pass, group by group into one workspace as
    ``fault_matmul`` runs it, equals ``bitflip_ref(...).to(bf16)`` bitwise
    for every row, at R = 1, G and 2G + 1 (G = 3 here), with ragged K and
    N (padding tiles hold zeros)."""
    K, N = 300, 200
    hi = {torch.int8: 127, torch.int16: 2 ** 14, torch.int32: 2 ** 20}[dtype]
    qw = torch.randint(-hi, hi, (K, N), dtype=dtype, device=dev)
    scale = torch.tensor(0.0123, device=dev)
    G = _shrink_workspace(monkeypatch, K, N, 3)
    for R in (1, G, 2 * G + 1):
        rates = torch.linspace(0.0, 0.4, R, device=dev)
        want = ref.bitflip_ref(qw, 11, rates, 6, fault_model=model,
                               scale=scale).to(torch.bfloat16)
        groups = ops.row_groups(R, K, N)
        assert len(groups) == -(-R // G)
        ws = torch.empty((groups[0][1], ref.tile_elems(K, N)),
                         dtype=torch.bfloat16, device=dev)
        for r0, rows in groups:
            t = ops.fault_weight_tiles(qw, scale, 11, rates[r0:r0 + rows], 6,
                                       fault_model=model, out=ws)
            assert _same_bits(ref.unpack_tiles(t, K, N), want[r0:r0 + rows])
            assert _same_bits(t, ref.pack_tiles(want[r0:r0 + rows]))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_fault_matmul_bf16_rows_across_groups(dev, monkeypatch, dtype):
    """An R-row bf16 call whose rows span several row groups (R = 5 rows,
    G = 2) equals R one-row calls bitwise, and launches one hash pass and
    one product a group (3 each), counted under their own names."""
    M, K, N = 256, 512, 384
    qw = torch.randint(-100, 100, (K, N), dtype=dtype, device=dev)
    scale = torch.tensor(0.0123, device=dev)
    _shrink_workspace(monkeypatch, K, N, 2)
    rates = torch.tensor([0.2, 0.0, 1e-3, 0.3, 0.05], device=dev)
    x = torch.randn(5, M, K, device=dev).to(torch.bfloat16)
    ops.reset_launches()
    many = ops.fault_matmul(x, qw, scale, 9, rates, 6)
    assert ops.launches == {"bitflip": 0, "quant_bitflip": 0,
                            "fault_matmul": 0, "fault_weight_tiles": 3,
                            "matmul_tiles": 3, "matmul_tiles_f32": 0,
                            "swiglu": 0, "rope": 0}
    for r in range(5):
        one = ops.fault_matmul(x[r:r + 1].contiguous(), qw, scale, 9,
                               rates[r:r + 1], 6)
        assert _same_bits(many[r:r + 1], one)


def test_matmul_tiles_alone(dev):
    """The bf16 product alone, one launch counted a call: bf16(q' scale)
    bitwise at x = I_K, and at random x (ragged M, K in slices) the same
    bits as ``fault_matmul``, which runs it after the hash pass."""
    M, K, N = 300, 256, 384
    qw = torch.randint(-127, 127, (K, N), dtype=torch.int8, device=dev)
    scale = torch.tensor(0.0123, device=dev)
    rates = torch.tensor([0.2], device=dev)
    tiles = ops.fault_weight_tiles(qw, scale, 5, rates, 6)
    x = torch.randn(1, M, K, device=dev).to(torch.bfloat16)
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16)[None].contiguous()
    ops.reset_launches()
    assert _same_bits(ops.matmul_tiles(eye, tiles, K, N),
                      ref.unpack_tiles(tiles, K, N))
    assert _same_bits(ops.matmul_tiles(x, tiles, K, N),
                      ops.fault_matmul(x, qw, scale, 5, rates, 6))
    assert ops.launches["matmul_tiles"] == 3
    assert ops.launches["fault_weight_tiles"] == 1


def _product_tiles(dev, K, N, R, seed):
    qw = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev)
    rates = torch.linspace(0.0, 0.3, R, device=dev)
    return ops.fault_weight_tiles(qw, torch.tensor(0.0123, device=dev), seed,
                                  rates, 6)


@pytest.mark.parametrize("shape", [(2048, 2048, 2048), (200, 272, 384),
                                   (200, 300, 384), (45, 64, 5),
                                   (2048, 3072, 256)])
def test_matmul_tiles_product(dev, shape):
    """The product alone, two rows: bitwise ``unpack_tiles(W')`` at x = I_K,
    and at random x within 2K2^-24(|x|@|w|) + 2^-8(|k|+|p|)(1+2^-7) of
    ``ref.matmul_tiles_ref``; at olmo-1b's 2048^3, at the edges of the
    128 x 256 block (M = 200, N = 384; K = 272 is whole W' tiles but not
    whole 64-deep stages; K = 300, K % 8 != 0, takes the producer's plain
    loads of x), a narrow N, and starcoder2-3b's kv projection, whose K is
    cut into slices."""
    from repro_torch._device import fp32_exact

    M, K, N = shape
    tiles = _product_tiles(dev, K, N, 2, 5)
    w = ref.unpack_tiles(tiles, K, N)
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16).expand(2, K, K)
    assert _same_bits(ops.matmul_tiles(eye.contiguous(), tiles, K, N), w)
    x = torch.randn(2, M, K, device=dev).to(torch.bfloat16)
    got = ops.matmul_tiles(x, tiles, K, N).float()
    with torch.no_grad(), fp32_exact():
        want = ref.matmul_tiles_ref(x, tiles, K, N).float()
    mag = torch.matmul(x.float().abs(), w.float().abs())
    tol = 2 * K * 2.0 ** -24 * mag + 2.0 ** -8 * (got.abs() + want.abs()) * 1.01
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("shape", [(2048, 3072, 256), (2048, 2048, 2048)])
def test_matmul_tiles_rows_match_one_row_calls(dev, shape):
    """The product of R = 3 rows equals three one-row calls bitwise, at
    starcoder2-3b's kv projection (K in slices) and at 2048^3."""
    M, K, N = shape
    tiles = _product_tiles(dev, K, N, 3, 9)
    x = torch.randn(3, M, K, device=dev).to(torch.bfloat16)
    many = ops.matmul_tiles(x, tiles, K, N)
    for r in range(3):
        one = ops.matmul_tiles(x[r:r + 1].contiguous(), tiles[r:r + 1], K, N)
        assert _same_bits(many[r:r + 1], one)


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("shape", [(256, 1024, 1024), (135, 300, 77),
                                   (256, 4096, 1024)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_fault_matmul_f32_x_bf16_weights(dev, model, shape, dtype):
    """float32 x on a bf16 weight dtype (the encoder-decoder's encoder):
    float(bf16(q' scale)) bitwise at x = I_K, within the fp32 accumulation
    bound of the plain version at random x, float32 out, the hash pass and
    the float32 product launched once each (one row group), nothing else;
    each row of an R-row call bitwise its one-row call."""
    M, K, N = shape
    hi = 127 if dtype == torch.int8 else 2 ** 14
    qw = torch.randint(-hi, hi, (K, N), dtype=dtype, device=dev)
    rates = torch.tensor([0.0, 1e-3, 0.2], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    bf = torch.bfloat16
    w = ref.bitflip_ref(qw, 7, rates, 6, fault_model=model,
                        scale=scale).to(bf).float()
    eye = torch.eye(K, device=dev).expand(3, K, K).contiguous()
    ops.reset_launches()
    got = ops.fault_matmul(eye, qw, scale, 7, rates, 6, fault_model=model,
                           out_dtype=bf)
    assert got.dtype == torch.float32 and _same_bits(got, w)
    assert ops.launches == {"bitflip": 0, "quant_bitflip": 0,
                            "fault_matmul": 0, "fault_weight_tiles": 1,
                            "matmul_tiles": 0, "matmul_tiles_f32": 1,
                            "swiglu": 0, "rope": 0}
    x = torch.randn(3, M, K, device=dev)
    got = ops.fault_matmul(x, qw, scale, 7, rates, 6, fault_model=model,
                           out_dtype=bf)
    want = ref.fault_matmul_ref(x, qw, scale, 7, rates, 6,
                                fault_model=model, out_dtype=bf)
    tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
    assert bool(((got - want).abs() <= tol).all())
    for r in range(3):
        one = ops.fault_matmul(x[r:r + 1].contiguous(), qw, scale, 7,
                               rates[r:r + 1], 6, fault_model=model,
                               out_dtype=bf)
        assert _same_bits(got[r:r + 1], one)


@pytest.mark.parametrize("shape", [(256, 1024, 1024), (135, 300, 77),
                                   (135, 302, 77), (45, 64, 5),
                                   (256, 4096, 1024)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_matmul_tiles_f32_product(dev, shape, dtype):
    """The float32 product alone, three rows, one launch a call: bitwise
    ``unpack_tiles(W')`` at x = I_K, within 2K2^-24(|x|@|w|) of
    ``ref.matmul_tiles_f32_ref`` at random x, each row bitwise its one-row
    call; for every storage type's W', at seamless-m4t-medium's encoder
    shapes (K in slices), a ragged edge with K % 4 == 0 (x by TMA) and
    with K % 4 != 0 (the producer's plain loads), and a narrow N."""
    from repro_torch._device import fp32_exact

    M, K, N = shape
    hi = {torch.int8: 127, torch.int16: 2 ** 14, torch.int32: 2 ** 20}[dtype]
    qw = torch.randint(-hi, hi, (K, N), dtype=dtype, device=dev)
    rates = torch.tensor([0.0, 1e-3, 0.2], device=dev)
    scale = torch.tensor(0.0123 if dtype == torch.int8 else 1e-4, device=dev)
    tiles = ops.fault_weight_tiles(qw, scale, 7, rates, 6)
    w = ref.unpack_tiles(tiles, K, N).float()
    eye = torch.eye(K, device=dev).expand(3, K, K).contiguous()
    ops.reset_launches()
    assert _same_bits(ops.matmul_tiles_f32(eye, tiles, K, N), w)
    assert ops.launches["matmul_tiles_f32"] == 1
    x = torch.randn(3, M, K, device=dev)
    got = ops.matmul_tiles_f32(x, tiles, K, N)
    with torch.no_grad(), fp32_exact():
        want = ref.matmul_tiles_f32_ref(x, tiles, K, N)
    tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= tol).all())
    for r in range(3):
        one = ops.matmul_tiles_f32(x[r:r + 1].contiguous(), tiles[r:r + 1],
                                   K, N)
        assert _same_bits(got[r:r + 1], one)


@pytest.mark.parametrize("K", [300, 302])
def test_matmul_tiles_f32_row_offsets(dev, K):
    """x and W' that start inside a larger call's buffers, as a row group
    after the first does: rows 1.. of x and of W' give the same bits as
    the whole call's rows 1..; at K = 302 (M K = 13590) x's start is not
    16-byte aligned and the producer loads it by plain loads."""
    M, N = 45, 77
    qw = torch.randint(-127, 127, (K, N), dtype=torch.int8, device=dev)
    rates = torch.tensor([0.1, 0.0, 0.2], device=dev)
    tiles = ops.fault_weight_tiles(qw, torch.tensor(0.0123, device=dev), 3,
                                   rates, 6)
    x = torch.randn(3, M, K, device=dev)
    whole = ops.matmul_tiles_f32(x, tiles, K, N)
    tail = ops.matmul_tiles_f32(x[1:], tiles[1:], K, N)
    assert (x[1:].data_ptr() % 16 == 0) == (K % 4 == 0 and (M * K) % 4 == 0)
    assert _same_bits(whole[1:], tail)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_fault_matmul_f32_x_bf16_weights_rows_across_groups(dev, monkeypatch,
                                                           dtype):
    """float32 x on bf16 weights, R = 5 rows in groups of 2: R one-row
    calls bitwise, one hash pass and one float32 product a group (3
    each); at K = 302 (K % 4 != 0) the producer loads x by plain loads."""
    for M, K, N in ((256, 512, 384), (45, 302, 77)):
        qw = torch.randint(-100, 100, (K, N), dtype=dtype, device=dev)
        scale = torch.tensor(0.0123, device=dev)
        _shrink_workspace(monkeypatch, K, N, 2)
        rates = torch.tensor([0.2, 0.0, 1e-3, 0.3, 0.05], device=dev)
        x = torch.randn(5, M, K, device=dev)
        ops.reset_launches()
        many = ops.fault_matmul(x, qw, scale, 9, rates, 6,
                                out_dtype=torch.bfloat16)
        assert ops.launches == {"bitflip": 0, "quant_bitflip": 0,
                                "fault_matmul": 0, "fault_weight_tiles": 3,
                                "matmul_tiles": 0, "matmul_tiles_f32": 3,
                                "swiglu": 0, "rope": 0}
        for r in range(5):
            one = ops.fault_matmul(x[r:r + 1].contiguous(), qw, scale, 9,
                                   rates[r:r + 1], 6,
                                   out_dtype=torch.bfloat16)
            assert _same_bits(many[r:r + 1], one)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_split_sums_of_misaligned_row_groups(dev, monkeypatch, x_dtype):
    """Row groups whose out starts off a 16-byte boundary, with K in
    slices: M N = 3465 (odd), groups of 5 rows, so the second group (4
    rows, 4 M N elements: a multiple of 4) starts 5 M N elements in; its
    split-K sum stores element by element there.  R = 9 rows, each
    bitwise its one-row call, on bf16 x and on float32 x with bf16
    weights."""
    M, K, N = 45, 302, 77
    qw = torch.randint(-100, 100, (K, N), dtype=torch.int8, device=dev)
    scale = torch.tensor(0.0123, device=dev)
    _shrink_workspace(monkeypatch, K, N, 5)
    rates = torch.linspace(0.0, 0.3, 9, device=dev)
    x = torch.randn(9, M, K, device=dev).to(x_dtype)
    body = "bf16" if x_dtype == torch.bfloat16 else "f32w"
    assert ops._k_splits(M, K, N, body, dev) > 1
    many = ops.fault_matmul(x, qw, scale, 4, rates, 6,
                            out_dtype=torch.bfloat16)
    for r in range(9):
        one = ops.fault_matmul(x[r:r + 1].contiguous(), qw, scale, 4,
                               rates[r:r + 1], 6, out_dtype=torch.bfloat16)
        assert _same_bits(many[r:r + 1], one)


def test_matmul_tiles_f32_tiny_and_subnormal_x(dev):
    """x scaled into bf16's and fp32's subnormal range.  At x = 2^-130 I_K
    each output is float(W') 2^-130, an exact product that is a float32
    subnormal, from hi parts that are bf16 subnormals: bitwise where the
    tensor cores keep subnormal inputs and sums.  At random x of magnitude
    ~2^-115 the lo parts are bf16 subnormals; the result is within
    2K2^-24(|x|@|w|) of the plain version."""
    from repro_torch._device import fp32_exact

    M, K, N = 256, 1024, 1024
    qw = torch.randint(-127, 127, (K, N), dtype=torch.int8, device=dev)
    tiles = ops.fault_weight_tiles(qw, torch.tensor(0.0123, device=dev), 5,
                                   torch.tensor([0.2], device=dev), 6)
    w = ref.unpack_tiles(tiles, K, N).float()
    eye = (torch.eye(K, device=dev) * 2.0 ** -130)[None].contiguous()
    got = ops.matmul_tiles_f32(eye, tiles, K, N)
    assert _same_bits(got, w * 2.0 ** -130)
    x = torch.randn(1, M, K, device=dev) * 2.0 ** -115
    got = ops.matmul_tiles_f32(x, tiles, K, N)
    with torch.no_grad(), fp32_exact():
        want = ref.matmul_tiles_f32_ref(x, tiles, K, N)
    tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
    assert bool(((got - want).abs() <= tol).all())


def test_flash_attention_waits_on_nothing(dev):
    """The attention's mask value is a Python scalar: a causal, a windowed
    and a memory attention run with the host never waiting on the card,
    bitwise what the tensor constant gave."""
    from repro_torch.models import layers as TL
    q = torch.randn(2, 64, 4, 16, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 64, 2, 16, device=dev).to(torch.bfloat16)
    mem = torch.randn(2, 9, 2, 16, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)
    mpos = torch.arange(9, dtype=torch.int32, device=dev)
    cases = ((k, k, pos, {}), (k, k, pos, dict(window=8, kv_chunk=16)),
             (mem, mem, mpos, dict(causal=False, kv_chunk=4)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [TL.flash_attention(q, kk, vv, pos, pk, **kw)
                for kk, vv, pk, kw in cases]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    real_where = torch.where

    def tensor_where(c, a, b):
        if isinstance(b, float):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
        return real_where(c, a, b)

    torch.where = tensor_where
    try:
        for out, (kk, vv, pk, kw) in zip(outs, cases):
            assert torch.equal(out, TL.flash_attention(q, kk, vv, pos, pk,
                                                       **kw))
    finally:
        torch.where = real_where


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_staged_matches_full_on_card(dev, dtype):
    """The reduced encoder-decoder under the kernel backend on the card:
    staged (fused, chunks of 3) bitwise the whole forward, the memory once
    per encoder prefix, and the float32-x route launched (its encoder)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import FaultSpec, make_lm_accuracy_evaluator
    from repro_torch.core.eval_engine import PrefixRef
    from repro_torch.lm_setup import lm_calibration_setup
    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              dtype=dtype)
    params, batch, labels = lm_calibration_setup(cfg, B=2, S=32, device=dev)
    ne, L = cfg.n_enc_layers, cfg.n_enc_layers + cfg.n_layers
    P = np.random.default_rng(0).integers(0, 4, size=(10, L))
    P[:5, :ne] = P[0, :ne]
    scale = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    res = {}
    for strategy, ebs in (("full", 1), ("staged", 3)):
        ev = make_lm_accuracy_evaluator(
            cfg, params, batch, labels, FaultSpec(bits=8, faulty_bits=4),
            scale, fault_backend="kernel", eval_strategy=strategy,
            eval_batch_size=ebs, device=dev)
        ops.reset_launches()
        res[strategy] = ev.delta_acc(P)
        assert ops.launches["matmul_tiles_f32" if dtype == "bfloat16"
                            else "fault_matmul"] > 0
    np.testing.assert_array_equal(res["staged"], res["full"])
    store = ev._prefix_engine.store._store
    assert sum(len(k) == ne for k in store) == len({tuple(r[:ne]) for r in P})
    assert all(isinstance(a["mem"], PrefixRef)
               for k, a in store.items() if len(k) > ne)


def test_online_loop_kernel_backend_on_card(dev):
    """The online loop on a small ResNet18 under the kernel backend on the
    card: a swap at the step, no rebuild, and a drained ReoptJob equal to
    the synchronous step."""
    from repro_torch.cnn_setup import clean_argmax_labels, make_evaluator
    from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultEnvironment,
                                  FaultSpec, NSGA2Config,
                                  OnlineReconfigurator, simulate_deployment)
    from repro_torch.models.cnn import ResNet18
    params = ResNet18.init(11, 16, width=0.5, img=32, device=dev)
    labels = clean_argmax_labels("resnet18", params, 64, device=dev)
    assert len(torch.unique(labels)) >= 2, "probe collapsed"
    spec = FaultSpec(weight_fault_rate=0.2, act_fault_rate=0.2,
                     faulty_bits=4, bits=8)
    layers = ResNet18.layer_infos(num_classes=16, width=0.5, img=32)
    base = np.array([d.fault_scale for d in PAPER_DEVICES])
    shifted = base * np.array([1.0, 25.0])

    def loop():
        ev = make_evaluator("resnet18", params, spec, n_eval=64,
                            labels=labels, device=dev)
        part = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                         nsga2_config=NSGA2Config(8, 2, seed=0))
        plan = part.optimize()

        def observe(p, scales):
            ev.device_fault_scale = np.asarray(scales, np.float32)
            return float(ev.delta_acc(np.asarray(p)[None])[0])

        rec = OnlineReconfigurator(part, plan, theta=-1.0, observe_fn=observe,
                                   reopt_generations=2)
        return ev, rec, observe, plan

    ev, rec, *_ = loop()
    log = simulate_deployment(rec, FaultEnvironment(base, {1: shifted}), 2)
    assert len(log["events"]) == 2 and ev._fault_env_rebuilds == 0
    ev1, rec1, _, _ = loop()
    rec1.step(1, shifted)
    ev2, rec2, obs2, plan2 = loop()
    job = rec2.start_reconfigure(1, obs2(plan2.partition, shifted), shifted)
    while not job.advance(1):
        pass
    a, b = rec1.events[0], rec2.events[0]
    np.testing.assert_array_equal(a.new_partition, b.new_partition)
    assert a.new_predicted_delta_acc == b.new_predicted_delta_acc
    assert ev2._fault_env_rebuilds == 0


# the leaves a faulted olmo-1b decode step corrupts, each one whole tensor
# (one row): the attention projections and the MLP, and the block input
DECODE_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), (8, 1, 2048)]


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_quant_bitflip_decode_shapes_bitwise(dev, model, shape):
    """``quant_bitflip`` at olmo-1b's decode shapes, bf16, a 0-d rate (the
    whole tensor one unit), 16 bits with 4 faulty: bitwise its plain
    version, and one launch pair a call (an amax pass and the flip)."""
    x = (torch.randn(shape, device=dev) * 0.02).to(torch.bfloat16)
    rate = torch.tensor([0.0, 0.2, 0.05], device=dev)[1]
    ops.reset_launches()
    k = ops.quant_bitflip(x, 7919 * 3 + 977 * 2, rate, 4, QuantSpec(16),
                          fault_model=model)
    assert ops.launches["quant_bitflip"] == 2
    p = ref.quant_bitflip_ref(x, 7919 * 3 + 977 * 2, rate, 4, QuantSpec(16),
                              fault_model=model)
    assert k.shape == x.shape and _same_bits(k, p)
    assert not torch.equal(k, x)


def _group_bitwise(xs, seeds, rates, fb, spec, model):
    """One grouped call, each output bitwise its plain version; two
    launches."""
    ops.reset_launches()
    got = ops.quant_bitflip_group(xs, seeds, rates, fb, spec,
                                  fault_model=model)
    assert ops.launches["quant_bitflip"] == 2
    for k, x, s, r in zip(got, xs, seeds, rates):
        p = ref.quant_bitflip_ref(x, s, r, fb, spec, fault_model=model)
        assert k.shape == x.shape and k.is_contiguous() and _same_bits(k, p)
    return got


@pytest.mark.parametrize("model", FAULT_MODELS)
def test_quant_bitflip_group_decode_layer_bitwise(dev, model):
    """One olmo-1b decode layer as one group, as ``_decode_block`` passes
    it: the 7 weight leaves at the weight rate (seeds + 977 j) and the
    block input at the activation rate, bf16, 0-d rates, 16 bits with 4
    faulty: each tensor bitwise its plain version, two launches."""
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = [(torch.randn(s, device=dev, generator=gen) * 0.02)
          .to(torch.bfloat16) for s in [DECODE_SHAPES[0]] * 4
          + [DECODE_SHAPES[1]] * 2 + DECODE_SHAPES[2:]]
    w, a = torch.tensor([0.2, 0.05], device=dev)
    seeds = [7919 + 977 * j for j in range(7)] + [7920]
    got = _group_bitwise(xs, seeds, [w] * 7 + [a], 4, QuantSpec(16), model)
    assert not any(torch.equal(k, x) for k, x in zip(got, xs))


@pytest.mark.parametrize("model", FAULT_MODELS)
def test_quant_bitflip_group_unit_inputs_bitwise(dev, model):
    """A group of the unit inputs (ResNet18's float32 [2,512,32,32,64] at
    rows 0.2 / 0 with one all-zero row, olmo-1b's bf16 [1,8,256,2048],
    seamless's float32 encoder input [1,8,32,1024]) beside unaligned views
    (bf16 and float32 rows starting off a 16-byte boundary, a row length
    of 333), a leaf expanded over 3 rows with stride 0, a one-element
    tensor and a row of 13: 8 bits with 6 faulty, bitwise."""
    gen = torch.Generator(device=dev).manual_seed(4)
    cnn = torch.relu(torch.randn(2, 512, 32, 32, 64, device=dev,
                                 generator=gen))
    cnn[1, :7] = 0
    base16 = torch.randn(1 + 4 * 1000, device=dev, generator=gen)         .to(torch.bfloat16)
    base32 = torch.randn(3 + 5 * 333, device=dev, generator=gen)
    w = torch.randn(64, 96, device=dev, generator=gen)
    xs = [cnn,
          torch.randn(1, 8, 256, 2048, device=dev, generator=gen)
          .to(torch.bfloat16),
          torch.randn(1, 8, 32, 1024, device=dev, generator=gen),
          base16[1:].view(4, 1000), base32[3:].view(5, 333),
          w.expand(3, 64, 96), torch.randn(1, device=dev, generator=gen),
          torch.randn(2, 13, device=dev, generator=gen)]
    rates = [torch.tensor([0.2, 0.0], device=dev),
             torch.tensor([0.2], device=dev), torch.tensor(0.2, device=dev),
             torch.tensor([0.3, 0.0, 0.1, 1.0], device=dev),
             torch.tensor([0.2] * 5, device=dev),
             torch.tensor([0.1, 0.0, 0.3], device=dev), 0.5,
             torch.tensor([0.25, 0.5], device=dev)]
    _group_bitwise(xs, list(range(11, 19)), rates, 6, QuantSpec(8), model)
    _group_bitwise(xs[3:], list(range(3, 8)), rates[3:], 5, QuantSpec(16),
                   model)                    # the generic faulty-bit path


def test_quant_bitflip_group_makes_no_fill(dev):
    """The profiler sees the group's two kernels, an amax pass and the
    flip, and no fill or memset: the amax workspace is never cleared."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xs = [torch.randn(2048, 2048, device=dev).to(torch.bfloat16),
          torch.randn(8, 1, 2048, device=dev)]
    rates = [torch.tensor(0.2, device=dev)] * 2
    out = ops.quant_bitflip_group(xs, [1, 2], rates, 4, QuantSpec(16))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = ops.quant_bitflip_group(xs, [1, 2], rates, 4, QuantSpec(16))
        torch.cuda.synchronize()
    keys = [a.key for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]
    assert sum("amax_kernel" in k for k in keys) == 1, keys
    assert sum("quant_bitflip_kernel" in k for k in keys) == 1, keys
    assert not [k for k in keys if "fill" in k.lower()
                or "memset" in k.lower()], keys
    assert len(out) == 2


def _reduced_olmo_decode(device, params, cfg, fault):
    """Prefill of two 8-token prompts, then one decode step at ``fault``."""
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)).to(device)
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, {"tokens": toks}, max_len=16)
        last = logits[:, -1].argmax(-1).int()
        pos = torch.full((2,), 8, dtype=torch.int32, device=device)
        return T.decode_step(params, cfg, cache, last, pos, fault=fault)


def test_faulted_decode_step_matches_cpu(dev):
    """One faulted decode step of reduced olmo-1b (float32) on the card
    against the same step on the CPU: logits within 1e-3 (the decode
    tests' faulted-step tolerance, one 16-bit activation grid step), the
    same greedy tokens, the cache ``pos`` equal, ``quant_bitflip``
    launched twice a layer (one launch pair corrupts the 7 weight leaves
    and the input), and no host wait inside the step."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("olmo-1b").reduced()
    cpu_params = T.init_lm(cfg, seed=2, device="cpu")
    params = tree_map(lambda t: t.to(dev), cpu_params)
    rng = np.random.default_rng(1)
    w = rng.uniform(0.05, 0.3, cfg.n_layers).astype(np.float32)
    a = rng.uniform(0.05, 0.3, cfg.n_layers).astype(np.float32)
    want, want_cache = _reduced_olmo_decode(
        torch.device("cpu"), cpu_params, cfg,
        (torch.from_numpy(w), torch.from_numpy(a), 5))
    fault = (torch.from_numpy(w).to(dev), torch.from_numpy(a).to(dev), 5)
    _reduced_olmo_decode(dev, params, cfg, fault)      # warm up
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = torch.zeros(2, dtype=torch.int32, device=dev)
        pos = torch.full((2,), 3, dtype=torch.int32, device=dev)
        cache = T.init_cache(cfg, 2, 16, device=dev)
        with torch.no_grad():
            T.decode_step(params, cfg, cache, toks, pos, fault=fault)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launches["quant_bitflip"] == 2 * cfg.n_layers
    got, got_cache = _reduced_olmo_decode(dev, params, cfg, fault)
    assert torch.allclose(got.cpu(), want, rtol=0, atol=1e-3)
    assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
    assert torch.equal(got_cache["b0"]["pos"].cpu(), want_cache["b0"]["pos"])


# --------------------------------------------------------------------------
# training (repro_torch.train) on the card
# --------------------------------------------------------------------------
def _train_fixture(dev, seed=0):
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("olmo-1b").reduced()              # float32
    cpu_params = T.init_lm(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    return (cfg, cpu_params, batch, tree_map(lambda t: t.to(dev), cpu_params),
            {k: v.to(dev) for k, v in batch.items()})


def test_train_step_on_card_matches_cpu(dev):
    """One step (two microbatches) on the card against the CPU: the loss
    and every grad within 2e-5 of the leaf's largest (cuBLAS sums in
    another order than the CPU), lr bitwise, params within 2 lr."""
    from repro_torch._tree import tree_leaves
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import _value_and_grad, make_loss_fn
    from repro_torch.train.optimizer import adamw_init
    cfg, cp, cb, gp, gb = _train_fixture(dev)
    loss_fn = make_loss_fn(cfg, remat=False)
    lc, gc_ = _value_and_grad(loss_fn, cp, cb)
    lg, gg = _value_and_grad(loss_fn, gp, gb)
    assert abs(float(lc) - float(lg)) <= 1e-5
    for a, b in zip(tree_leaves(gc_), tree_leaves(gg)):
        assert float((a - b.cpu()).abs().max()) <= 2e-5 * float(a.abs().max())
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(cfg, ocfg, microbatches=2)
    pc, sc, mc = step(cp, adamw_init(cp), cb)
    pg, sg, mg = step(gp, adamw_init(gp), gb)
    assert _same_bits(mc["lr"], mg["lr"].cpu())
    assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-5
    assert int(sg["step"]) == 1 and sg["step"].is_cuda
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        assert b.is_cuda and float((a - b.cpu()).abs().max()) <= \
            2 * float(mc["lr"])


def test_train_step_is_deterministic_on_card(dev):
    """The same step twice from the same state is bitwise equal, and waits
    on the card nowhere (sync debug mode raises at a wait)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import adamw_init
    cfg, _, _, gp, gb = _train_fixture(dev, seed=1)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                           microbatches=2)
    st = adamw_init(gp)
    step(gp, st, gb)                                   # warm up
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            outs.append(step(gp, st, gb))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert _same_bits(a, b)


def test_trainer_restart_is_bit_identical_on_card(dev, tmp_path):
    """Kill-and-relaunch == uninterrupted run, on the card."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    cfg = get_config("olmo-1b").reduced()

    def trainer(d):
        return Trainer(cfg, AdamWConfig(lr=3e-3, warmup_steps=2,
                                        total_steps=100),
                       TrainerConfig(total_steps=8, ckpt_every=4,
                                     ckpt_dir=str(d), microbatches=2),
                       TokenStream(vocab=cfg.vocab, seq_len=16, batch=4,
                                   seed=0))
    full = trainer(tmp_path / "a")
    full.run()
    t1 = trainer(tmp_path / "b")
    t1.run(max_steps=4)
    t2 = trainer(tmp_path / "b")
    assert t2.try_restore() and t2.step == 4
    t2.run()
    for a, b in zip(tree_leaves((full.params, full.opt_state)),
                    tree_leaves((t2.params, t2.opt_state))):
        assert a.is_cuda and _same_bits(a, b)


# --------------------------------------------------------------------------
# training through quant_bitflip: its q' store and its backward
# --------------------------------------------------------------------------
def _q_group(dev, gen):
    """33 tensors (two launch pairs): bf16 [3] rows, a float32 leaf
    expanded over 3 rows (stride 0), bf16 rows off a 16-byte boundary,
    olmo-1b's [2048, 2048] bf16, 7 elements (the scalar tail) and 28
    float32 tensors of 129; their rates and seeds."""
    w = torch.randn(64, 96, device=dev, generator=gen)
    base = torch.randn(1 + 3 * 1000, device=dev, generator=gen).to(
        torch.bfloat16)
    xs = [torch.randn(3, 31, 33, device=dev, generator=gen).to(
              torch.bfloat16), w.expand(3, 64, 96), base[1:].view(3, 1000),
          (torch.randn(2048, 2048, device=dev, generator=gen) * 0.02).to(
              torch.bfloat16), torch.randn(7, device=dev, generator=gen)] \
        + [torch.randn(129, device=dev, generator=gen) for _ in range(28)]
    rates = [torch.tensor([0.2, 0.0, 0.5], device=dev)] * 3 \
        + [torch.tensor(0.2, device=dev)] * 30
    return xs, list(range(33)), rates


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("bits,fb", [(16, 4), (8, 6), (20, 4), (24, 5),
                                     (16, 16), (8, 16)])
def test_quant_bitflip_q_store_bitwise(dev, model, bits, fb):
    """The flip pass's q' store (the forward of a gradient): the outputs
    bitwise the call without it, each q' (int32) equal to the plain
    version's integers, where a 16-bit fault window takes q' beyond the
    16-bit format (24 bits: the path without kMagic); two launch pairs
    for the 33 tensors either way."""
    xs, seeds, rates = _q_group(dev, torch.Generator(device=dev)
                                .manual_seed(5))
    spec = QuantSpec(bits)
    ops.reset_launches()
    plain = ops.quant_bitflip_group(xs, seeds, rates, fb, spec,
                                    fault_model=model)
    got, qs = ops._qb_forward(xs, seeds, rates, fb, spec, model, 2,
                              keep_q=True)
    assert ops.launches["quant_bitflip"] == 8
    for k, p, q, x, s, r in zip(got, plain, qs, xs, seeds, rates):
        assert _same_bits(k, p)
        want_y, want_q = ref.quant_bitflip_q_ref(x, s, r, fb, spec,
                                                 fault_model=model)
        assert _same_bits(k, want_y)
        assert q.dtype == torch.int32 and torch.equal(q, want_q)


def _grad_bound(x, q, g, spec):
    """Per row of ``x``: 2^-20 sum_j |g_j q'_j| / qmax, the room another
    summation order of d scale takes, in x's rows' shape."""
    R = q.shape[0]
    s = (g.reshape(R, -1).float().abs() * q.float().abs()).sum(1) \
        * spec.inv_qmax
    return (2.0 ** -20 * s)[:, None].expand(R, x.numel() // R).reshape(
        x.shape)


@pytest.mark.parametrize("bits,fb", [(16, 4), (8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_bitflip_backward_on_card(dev, dtype, bits, fb):
    """The gradient through the kernel (``quant_bitflip_group`` under
    autograd) against autograd through the plain version on the card and
    against the same call on the CPU: the same nonzero entries (each row's
    largest |x|, two tied in one row), each within ``_grad_bound`` plus
    half an ulp of x's dtype; the forward bitwise the plain version's,
    one launch pair for the group, none in the backward.  At 8 bits with
    16 faulty, q' leaves the format's range."""
    gen = torch.Generator(device=dev).manual_seed(6)
    w = torch.randn(64, 96, device=dev, generator=gen).to(dtype)
    tied = torch.randn(2, 1000, device=dev, generator=gen).to(dtype)
    tied[0, 10], tied[0, 500] = 9.0, -9.0
    big = (torch.randn(1, 2048, 8192, device=dev, generator=gen)
           * 0.02).to(dtype)
    leaves = [w, tied, big]
    rates = [torch.tensor([0.2, 0.0, 0.5], device=dev),
             torch.tensor([0.3, 0.2], device=dev),
             torch.tensor([0.2], device=dev)]
    spec, seeds = QuantSpec(bits), [3, 4, 5]
    gs = [torch.randn((3, 64, 96), device=dev, generator=gen).to(dtype),
          torch.randn(tied.shape, device=dev, generator=gen).to(dtype),
          torch.randn(big.shape, device=dev, generator=gen).to(dtype)]

    def grads(fn, device):
        ps = [t.detach().to(device).requires_grad_(True) for t in leaves]
        xs = [ps[0].expand(3, 64, 96), ps[1], ps[2]]
        ys = fn(xs, seeds, [r.to(device) for r in rates])
        torch.autograd.backward(ys, [g.to(device) for g in gs])
        return ys, [p.grad for p in ps]

    ops.reset_launches()
    ys, got = grads(lambda xs, s, r: ops.quant_bitflip_group(
        xs, s, r, fb, spec), dev)
    torch.cuda.synchronize()
    assert ops.launches["quant_bitflip"] == 2
    yp, plain = grads(lambda xs, s, r: ref.quant_bitflip_group_ref(
        xs, s, r, fb, spec), dev)
    _, cpu = grads(lambda xs, s, r: ops.quant_bitflip_group(
        xs, s, r, fb, spec), torch.device("cpu"))
    for a, b in zip(ys, yp):
        assert _same_bits(a.detach(), b.detach())
    xs = [w.expand(3, 64, 96), tied, big]
    for i, (x, g) in enumerate(zip(xs, gs)):
        _, q = ref.quant_bitflip_q_ref(x, seeds[i], rates[i], fb, spec)
        tol = _grad_bound(x, q, g, spec)
        if i == 0:
            tol = tol.sum(0)             # the expanded leaf sums its rows
        tol = tol + got[i].float().abs() * 2.0 ** -(
            8 if dtype == torch.bfloat16 else 24)
        for other in (plain[i], cpu[i].to(dev)):
            assert torch.equal(got[i] != 0, other != 0)
            assert bool(((got[i].float() - other.float()).abs()
                         <= tol).all())
    assert int((got[1][0] != 0).sum()) == 2     # the tied row
    assert int((got[2] != 0).sum()) == 1


def test_kernels_without_backward_refuse_grad_on_card(dev):
    """``bitflip`` and ``fault_matmul`` with grad enabled and an input
    that requires grad raise; under ``no_grad`` they run."""
    qw = torch.randint(-100, 100, (64, 32), dtype=torch.int8, device=dev)
    scale = torch.tensor(0.01, device=dev, requires_grad=True)
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.bitflip(qw, 1, 0.2, 4, scale=scale)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fault_matmul(x, qw, 0.01, 1, 0.2, 4)
    with torch.no_grad():
        ops.bitflip(qw, 1, 0.2, 4, scale=scale)
        ops.fault_matmul(x, qw, 0.01, 1, 0.2, 4)


def test_faulted_train_step_on_card(dev):
    """``make_loss_fn(fault=...)`` on reduced olmo-1b (float32, 0.2 on
    every layer, 16 bits with 4 faulty) on the card: ``remat=True``
    bitwise ``remat=False`` (the recomputed launch gives the same bits
    and q'), four ``quant_bitflip`` launches a layer in the forward (a
    pair for the leaves, one for the input) and four more with remat, no
    ``bitflip`` or ``fault_matmul``; the loss and every gradient bitwise
    the same call through the plain version on the card; against the CPU
    the loss within 1e-4 and each leaf's nonzero entries equal, values
    within 1e-3 of the leaf's largest plus 1e-3 of their room
    (``testing.grad_room``: the CPU tests' bounds against the reference,
    another summation order); a two-microbatch faulted step waits on the
    card nowhere."""
    from repro_torch._tree import tree_leaves
    from repro_torch.testing.grad_room import scale_grad_room
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import _value_and_grad, make_loss_fn
    cfg, cp, cb, gp, gb = _train_fixture(dev, seed=2)
    L = cfg.n_layers
    fault_c = (torch.full((L,), 0.2), torch.full((L,), 0.2), 5)
    fault_g = tuple(t.to(dev) for t in fault_c[:2]) + (5,)
    ops.reset_launches()
    lg, gg = _value_and_grad(make_loss_fn(cfg, remat=False, fault=fault_g),
                             gp, gb)
    torch.cuda.synchronize()
    assert ops.launches["quant_bitflip"] == 4 * L
    assert ops.launches["bitflip"] == ops.launches["fault_matmul"] == 0
    ops.reset_launches()
    lr_, gr = _value_and_grad(make_loss_fn(cfg, remat=True, fault=fault_g),
                              gp, gb)
    torch.cuda.synchronize()
    assert ops.launches["quant_bitflip"] == 8 * L
    assert _same_bits(lg, lr_)
    for a, b in zip(tree_leaves(gg), tree_leaves(gr)):
        assert _same_bits(a, b)
    kernel_group = ops.quant_bitflip_group
    ops.quant_bitflip_group = lambda xs, s, r, fb, spec, **kw: \
        ref.quant_bitflip_group_ref(xs, s, r, fb, spec, **kw)
    try:
        lp, gp_ = _value_and_grad(make_loss_fn(cfg, remat=False,
                                               fault=fault_g), gp, gb)
    finally:
        ops.quant_bitflip_group = kernel_group
    assert _same_bits(lg, lp)
    for a, b in zip(tree_leaves(gg), tree_leaves(gp_)):
        assert _same_bits(a, b)
    loss_c = make_loss_fn(cfg, remat=False, fault=fault_c)
    lc, gc_ = _value_and_grad(loss_c, cp, cb)
    room = scale_grad_room(lambda p: _value_and_grad(loss_c, p, cb)[1], cp)
    assert abs(float(lc) - float(lg)) <= 1e-4
    for a, b, r in zip(tree_leaves(gc_), tree_leaves(gg), tree_leaves(room)):
        b = b.cpu()
        assert torch.equal(a != 0, b != 0)
        assert bool(((a - b).abs() <= 1e-3 * (a.abs().max() + r)).all())
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                           microbatches=2, fault=fault_g)
    st = adamw_init(gp)
    step(gp, st, gb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, m = step(gp, st, gb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(m["loss"]))


# --------------------------------------------------------------------------
# the kernels on any card, and a pool of slots on one card
# --------------------------------------------------------------------------
def test_kernels_on_a_second_card_while_the_first_is_current(dev):
    """Each kernel launched on cuda:1 while cuda:0 is the current card
    equals its plain version, and leaves cuda:0 current.  The shared-memory
    attribute of fault_matmul's three tensor-core kernels is set once per
    card, so their first launch there is the one this checks."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a launch on a card that is not the "
                    "current one cannot be staged on a one-card host")
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    g = torch.Generator(device=d1).manual_seed(5)
    rates = torch.tensor([0.0, 0.2], device=d1)
    q = torch.randint(-100, 100, (33, 17, 3), dtype=torch.int8, device=d1)
    assert _same_bits(ops.bitflip(q, 3, rates, 4),
                      ref.bitflip_ref(q, 3, rates, 4))
    x = torch.randn(2, 5, 31, 33, device=d1, generator=g).to(torch.bfloat16)
    assert _same_bits(ops.quant_bitflip(x, 9, rates, 4, QuantSpec(8)),
                      ref.quant_bitflip_ref(x, 9, rates, 4, QuantSpec(8)))
    # fault_matmul's three tensor-core routes at x = I_K: float32 x on int8
    # (wgmma), bf16 x (the hash pass and the bf16 product), float32 x on a
    # bf16 weight dtype (the hash pass and the float32 product)
    K, N = 256, 320
    qw = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=d1)
    scale = torch.tensor(0.0123, device=d1)
    bf = torch.bfloat16
    w = ref.bitflip_ref(qw, 5, rates, 6, scale=scale)
    eye = torch.eye(K, device=d1).expand(2, K, K).contiguous()
    assert _same_bits(ops.fault_matmul(eye, qw, scale, 5, rates, 6), w)
    assert _same_bits(ops.fault_matmul(eye.to(bf), qw, scale, 5, rates, 6),
                      w.to(bf))
    assert _same_bits(ops.fault_matmul(eye, qw, scale, 5, rates, 6,
                                       out_dtype=bf), w.to(bf).float())
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0


def test_pool_of_two_slots_on_one_card_bitwise(dev):
    """A ``[cuda:0, cuda:0]`` pool gives every row's ΔAcc bitwise what one
    slot gives, staged and full, on a small ResNet18 under the kernel
    backend; both slots run and one copy of the weights serves them."""
    from repro_torch.cnn_setup import clean_argmax_labels, make_evaluator
    from repro_torch.core import FaultSpec
    from repro_torch.models.cnn import ResNet18
    params = ResNet18.init(11, 16, width=0.5, img=32, device=dev)
    labels = clean_argmax_labels("resnet18", params, 64, device=dev)
    spec = FaultSpec(weight_fault_rate=0.2, act_fault_rate=0.2,
                     faulty_bits=4, bits=8)
    P = np.random.default_rng(3).integers(0, 2, size=(12, ResNet18.n_units))
    card = torch.device("cuda", torch.cuda.current_device())
    for strategy in ("staged", "full"):
        kw = dict(n_eval=64, labels=labels, eval_strategy=strategy,
                  eval_batch_size=None, device=dev)
        one = make_evaluator("resnet18", params, spec, devices=1, **kw)
        two = make_evaluator("resnet18", params, spec,
                             devices=[card, card], **kw)
        assert two.devices == 2
        np.testing.assert_array_equal(two.delta_acc(P), one.delta_acc(P))
        assert list(two._replicas) == [card]
        if strategy == "staged":
            dd = two.staged_stats()["device_dispatches"]
            assert set(dd) == {0, 1}


def test_pipeline_and_sharded_decode_on_two_slots(dev):
    """The launch stack on ``[cuda:0] * 2``: the 2-stage pipeline's loss
    and grads against the same loss on the CPU (within 1e-5 and 2e-5 of
    each leaf's largest, as the train step above), and a 2-shard decode
    step's logits against the unsharded step on the card (within 1e-5,
    the greedy tokens equal), waiting on the card nowhere."""
    import dataclasses

    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch import pipeline as pp
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shardings import P, shard_tree
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    from repro_torch.train.train_step import _value_and_grad

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=4)
    cpu = torch.device("cpu")
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    cuts = [0, 1, 4]
    out = []
    for d in (cpu, dev):
        mesh = make_test_mesh((2, 1, 1), ("pod", "data", "model"),
                              pool=[d] * 2)
        placed = pp.place_pp_params(pp.to_pp(params, cuts), mesh)
        loss, grads = _value_and_grad(pp.make_pp_loss(cfg, mesh, cuts, 2),
                                      placed, {k: v.to(d) for k, v in
                                               batch.items()})
        out.append((float(loss), pp.gather_pp_params(grads, mesh, cpu)))
    assert abs(out[0][0] - out[1][0]) <= 1e-5
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 2e-5 * float(a.abs().max())

    gp = tree_map(lambda t: t.to(dev), params)
    toks = batch["tokens"].to(dev)
    with torch.no_grad():
        logits, cache = prefill(gp, cfg, {"tokens": toks}, 32)
    specs = {"b0": {"k": P(None, None, "model"), "v": P(None, None, "model"),
                    "pos": P(None, None, "model")}}
    shards = shard_tree(cache, specs, make_test_mesh((2,), ("model",),
                                                     pool=[dev] * 2))
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    pos = torch.full((4,), 16, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got, _ = decode_step(gp, cfg, shards, tok, pos)
            want, _ = decode_step(gp, cfg, cache, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_tensor_parallel_train_and_faulted_decode_on_slots(dev):
    """FSDP x tensor parallelism on ``[cuda:0] * 4``: the (2, 2) train
    step's loss and gradients against the same step on the CPU (within
    1e-5 and 2e-5 of each leaf's largest), waiting on the card nowhere;
    a faulted decode step with params laid out over (1, 2): one grouped
    ``quant_bitflip`` pair a layer, the logits within 1e-3 of the
    unsharded faulted step on the card and the greedy tokens equal."""
    import dataclasses

    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (abstract_serve_decode,
                                          abstract_serve_prefill,
                                          abstract_train_step)
    from repro_torch.models.transformer import decode_step, init_lm, prefill

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=4)
    cpu = torch.device("cpu")
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    shape = ShapeSpec("t", seq_len=16, global_batch=4, kind="train")
    out = []
    for d in (cpu, dev):
        mesh = make_test_mesh((2, 2), pool=[d] * 4)
        fn, (params_s, _, _) = abstract_train_step(cfg, mesh, shape,
                                                   microbatches=1)
        placed = SH.place_params(tree_map(lambda t: t.to(d), params), mesh)
        b = {k: v.to(d) for k, v in batch.items()}
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss, grads = fn.value_and_grad(placed, b)
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out.append((float(loss), SH.gather_params(grads, params_s, mesh,
                                                  cpu)))
    assert abs(out[0][0] - out[1][0]) <= 1e-5
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 2e-5 * float(a.abs().max())

    gp = tree_map(lambda t: t.to(dev), params)
    mesh = make_test_mesh((1, 2), pool=[dev] * 2)
    pfn, _ = abstract_serve_prefill(cfg, mesh, ShapeSpec(
        "p", seq_len=32, global_batch=4, kind="prefill"))
    dfn, _ = abstract_serve_decode(cfg, mesh, ShapeSpec(
        "d", seq_len=32, global_batch=4, kind="decode"))
    placed = SH.place_params(gp, mesh)
    toks = batch["tokens"].to(dev)
    w = torch.full((cfg.n_layers,), 0.2, device=dev)
    with torch.no_grad():
        _, shards = pfn(placed, {"tokens": toks})
        logits, cache = prefill(gp, cfg, {"tokens": toks}, 32)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((4,), 16, dtype=torch.int32, device=dev)
        ops.reset_launches()
        got, _ = dfn(placed, shards, {"tokens": tok, "positions": pos},
                     fault=(w, w, 3))
        assert ops.launches["quant_bitflip"] == 2 * cfg.n_layers
        want, _ = decode_step(gp, cfg, cache, tok, pos, fault=(w, w, 3))
    assert float((got - want).abs().max()) <= 1e-3
    assert torch.equal(got.argmax(-1), want.argmax(-1))
