"""The arithmetic the port's CUDA kernels rely on, checked on the CPU.

* ``csrc/faultmodel.cuh`` selects a bit plane by the integer compare
  ``(u >> 8) < rate_threshold(rate)`` in place of the oracle's
  ``float(u >> 8) * 2^-24 < rate``: equal for every 24-bit draw.
* ``csrc/fault_matmul.cu`` runs int8 weights on bf16 tensor cores: a
  float32 ``x`` splits exactly into three bf16 values, every int8 value is
  exact in bf16, and ``sum_i (b_i @ q') * scale`` stays within the fp32
  bound of ``ref.fault_matmul_ref`` (bitwise at ``x = I_K``).
* ``bitflip`` with a ``scale`` dequantizes in the same pass, bitwise the
  reference's ``bitflip_ref`` followed by ``astype(float32) * scale``.

Inputs come from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.faultmodel import (FAULT_MODELS, INV24,  # noqa: E402
                                            rate_threshold)

EDGE_RATES = (0.0, -0.1, float("nan"), 1e-45, 1e-38, 2.0 ** -24, 1e-3, 0.1,
              0.2, 0.25, 1 - 2.0 ** -24, 1.0, 1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rate", EDGE_RATES)
def test_rate_threshold_equals_float_compare(rate):
    """All 2^24 values of ``u >> 8``: the integer compare selects exactly
    the draws the float compare selects."""
    u24 = torch.arange(1 << 24, dtype=torch.int32)
    r = torch.tensor(rate, dtype=torch.float32)
    by_float = u24.to(torch.float32) * INV24 < r
    by_int = u24 < rate_threshold(r)
    assert torch.equal(by_float, by_int)


def _split3(x: torch.Tensor):
    b0 = x.to(torch.bfloat16)
    r1 = x - b0.float()
    b1 = r1.to(torch.bfloat16)
    b2 = (r1 - b1.float()).to(torch.bfloat16)
    return b0, b1, b2


def test_bf16_split_is_exact():
    """x == b0 + b1 + b2 bitwise over a wide exponent range, with each
    residual itself exact in bf16; every int8 value is exact in bf16."""
    rng = np.random.default_rng(12)
    mant = rng.uniform(-2, 2, size=1 << 18).astype(np.float32)
    expo = rng.integers(-100, 100, size=mant.size)
    x = torch.from_numpy(np.ldexp(mant, expo).astype(np.float32))
    b0, b1, b2 = _split3(x)
    r1 = x - b0.float()
    assert torch.equal(b2.float(), r1 - b1.float())
    total = b0.float() + b1.float() + b2.float()
    assert torch.equal(total.view(torch.int32), x.view(torch.int32))
    q = torch.arange(-128, 128, dtype=torch.int32)
    assert torch.equal(q.to(torch.bfloat16).float(), q.float())


@pytest.mark.parametrize("model", FAULT_MODELS)
def test_split_product_matches_fault_matmul_ref(model):
    """The tensor-core body's arithmetic: three bf16 products of the split
    x against the corrupted int8 weights (exact in fp32), summed in fp32,
    times the scale.  Within 2 K 2^-24 (|x| @ |w|) of the plain version at
    random x, bitwise at x = I_K."""
    rng = np.random.default_rng(FAULT_MODELS.index(model))
    K, N, M = 200, 24, 33
    qw = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    scale = torch.tensor(0.0123, dtype=torch.float32)
    rates = torch.tensor([0.2, 1e-3], dtype=torch.float32)
    qf = ref.bitflip_ref(qw, 9, rates, 4, fault_model=model)
    w = qf.float() * scale

    def split_product(x):
        q = qf.to(torch.bfloat16).float()
        acc = sum(torch.matmul(b.float(), q) for b in _split3(x))
        return acc * scale

    eye = torch.eye(K).expand(2, K, K).contiguous()
    assert torch.equal(split_product(eye).view(torch.int32),
                       w.view(torch.int32))
    x = torch.from_numpy(rng.standard_normal((2, M, K)).astype(np.float32))
    want = ref.fault_matmul_ref(x, qw, scale, 9, rates, 4, fault_model=model)
    tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
    assert bool(((split_product(x) - want).abs() <= tol).all())


@pytest.mark.parametrize("model", FAULT_MODELS)
@pytest.mark.parametrize("np_dt", [np.int8, np.int16, np.int32])
def test_bitflip_fused_dequant_matches_reference(model, np_dt):
    """``bitflip_ref(..., scale=s)`` (and ``ops.bitflip`` on a CPU tensor)
    is bitwise the JAX reference's ``bitflip_ref`` then ``* s``."""
    rng = np.random.default_rng(FAULT_MODELS.index(model) + 7)
    q = rng.integers(-100, 100, size=(3, 3, 8, 5)).astype(np_dt)
    s = np.float32(0.0123)
    for rate in (0.0, 1e-3, 0.2):
        want = (np.asarray(jref.bitflip_ref(jnp.asarray(q), jnp.int32(5), rate,
                                            4, model, 2)).astype(np.float32)
                * s)
        for fn in (ref.bitflip_ref, ops.bitflip):
            got = fn(torch.from_numpy(q), 5, rate, 4, fault_model=model,
                     scale=torch.tensor(s))
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
