"""The glue kernels (``csrc/glue.cu``: the SwiGLU gate and RoPE, each one
pass) against the op-by-op chains they replace.

On the CPU: the wrappers and the model's call sites give the chains' bits,
and the card's dispatch (run on CPU tensors with the launch recorded, not
made) takes the chain where autograd needs a backward, counting it in
``ops.unfused``, launches for a prefill's and decode's positions alike,
and refuses what the kernel cannot read.  Marked ``cuda``: the kernels
bitwise the chains on the card (the gate over every 16-bit h1), and a
reduced olmo-1b with faults, staged and decoding, the same with and
without them.  Run those on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_glue.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _old_gate(h1, h3):
    """The gate as ``mlp_fwd`` ran it: ``_act(h1, "silu_glu") * h3``."""
    h = h1 * (1 / (1 + torch.exp(-h1)))
    return h * h3


def _old_rope(x, positions, theta):
    """RoPE as ``layers.rope`` ran it, tables and all."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {torch.float64: torch.int64, torch.float32: torch.int32,
                torch.bfloat16: torch.int16, torch.float16: torch.int16}
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return torch.equal(a, b)


def _draw(shape, dtype, seed, device="cpu", scale=3.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(device)


@pytest.fixture
def card(monkeypatch):
    """The wrappers' card path on CPU tensors: ``_launch`` records the C
    entry it would call, and its arguments, and launches nothing."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda fn, dev, *a: calls.append((fn, a)))
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    ops.reset_launches()
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_equal_the_op_by_op_chains_on_cpu(dtype):
    """On the CPU ``ops.swiglu``, ``layers.rope`` (``[S]`` and decode's
    ``[B, 1]`` positions), ``_attend``'s shared tables and ``mlp_fwd``
    give the old code's bits, and launch nothing."""
    ops.reset_launches()
    h1, h3 = _draw((2, 3, 37), dtype, 0), _draw((2, 3, 37), dtype, 1)
    assert _same_bits(ops.swiglu(h1, h3), _old_gate(h1, h3))
    x = _draw((2, 3, 7, 4, 16), dtype, 2)
    pos = torch.arange(7, dtype=torch.int32)
    assert _same_bits(L.rope(x, pos, 10000.0), _old_rope(x, pos, 10000.0))
    tables = L.rope_tables(pos, 8, 10000.0)
    assert _same_bits(ops.rope(x, *tables), _old_rope(x, pos, 10000.0))
    xd = _draw((3, 1, 4, 16), dtype, 3)
    pd = torch.tensor([5, 0, 11], dtype=torch.int32)[:, None]
    assert _same_bits(L.rope(xd, pd, 500.0), _old_rope(xd, pd, 500.0))
    gen = torch.Generator().manual_seed(4)
    p = L.init_mlp(gen, 16, 24, "silu_glu", dtype)
    xm = _draw((2, 5, 16), dtype, 5, scale=1.0)
    want = torch.matmul(_old_gate(torch.matmul(xm, p["w1"]),
                                  torch.matmul(xm, p["w3"])), p["w2"])
    assert _same_bits(L.mlp_fwd(p, xm, "silu_glu"), want)
    assert ops.launches["swiglu"] == ops.launches["rope"] == 0
    assert ops.unfused == {"swiglu": 0, "rope": 0}


@pytest.mark.parametrize("op", ["swiglu", "rope"])
def test_card_path_under_autograd_runs_the_chain(card, op):
    """Where autograd needs a backward the card path runs the op-by-op
    chain (no launch, no error), counts it in ``ops.unfused``, and gives
    the old code's values and gradients, bitwise."""
    if op == "swiglu":
        args = [_draw((4, 33), torch.float32, 6), _draw((4, 33),
                                                        torch.float32, 7)]
        new_fn, old_fn = ops.swiglu, _old_gate
    else:
        args = [_draw((2, 5, 3, 8), torch.float32, 8)]
        pos = torch.arange(5, dtype=torch.int32)
        new_fn = lambda x: ops.rope(x, *L.rope_tables(pos, 4, 100.0))  # noqa: E731
        old_fn = lambda x: _old_rope(x, pos, 100.0)  # noqa: E731
    grads = []
    for fn in (new_fn, old_fn):
        leaves = [a.clone().requires_grad_(True) for a in args]
        y = fn(*leaves)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        grads.append((y.detach(), [t.grad for t in leaves]))
    assert card == [] and ops.launches[op] == 0
    assert ops.unfused == {"swiglu": 0, "rope": 0, op: 1}
    assert _same_bits(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert _same_bits(a, b)


def test_card_path_launches_only_where_the_kernel_applies(card):
    """The card path launches the kernel for contiguous, same-shaped
    float32/bf16/fp16 inputs, and ``rope`` for a prefill's ``[S]`` and
    decode's ``[B, 1]`` positions alike: a table row a position of x's
    rows, ``n_pos`` of them."""
    with torch.no_grad():
        h1, h3 = _draw((3, 40), torch.bfloat16, 9), _draw((3, 40),
                                                          torch.bfloat16, 10)
        ops.swiglu(h1, h3)
        x = _draw((2, 3, 6, 4, 16), torch.bfloat16, 11)
        L.rope(x, torch.arange(6, dtype=torch.int32), 10000.0)
        xd = _draw((5, 1, 4, 16), torch.float16, 12)
        L.rope(xd, torch.tensor([3, 1, 0, 7, 2], dtype=torch.int32)[:, None],
               10000.0)
    (f0, a0), (f1, a1), (f2, a2) = card
    assert (f0, f1, f2) == ("afp_swiglu", "afp_rope", "afp_rope")
    assert a0[3:] == (120, 1, 132)               # n, bf16, the SMs
    # rows, n_pos, H, half, dtype, SMs
    assert a1[4:] == (2 * 3 * 6 * 4, 6, 4, 8, 1, 132)
    assert a2[4:] == (5 * 4, 5, 4, 8, 2, 132)
    assert ops.launches["swiglu"] == 1 and ops.launches["rope"] == 2
    assert ops.unfused == {"swiglu": 0, "rope": 0}


def _refusals():
    h1, h3 = _draw((3, 40), torch.bfloat16, 9), _draw((3, 40),
                                                      torch.bfloat16, 10)
    x = _draw((2, 6, 4, 16), torch.bfloat16, 11)
    cos, sin = L.rope_tables(torch.arange(6, dtype=torch.int32), 8, 1e4)
    return {
        "swiglu strided": lambda: ops.swiglu(h1.t(), h3.t()),
        "swiglu shapes": lambda: ops.swiglu(h1, h3[:1]),
        "swiglu dtypes": lambda: ops.swiglu(h1, h3.float()),
        "swiglu float64": lambda: ops.swiglu(h1.double(), h3.double()),
        "rope strided": lambda: ops.rope(
            x.transpose(1, 2).contiguous().transpose(1, 2), cos, sin),
        "rope float64": lambda: ops.rope(x.double(), cos, sin),
        "rope other positions": lambda: ops.rope(x, cos[:5], sin[:5]),
        "rope bf16 tables": lambda: ops.rope(x, cos.bfloat16(),
                                             sin.bfloat16()),
        "rope transposed tables": lambda: ops.rope(
            x[:, :1], cos[:1].t().contiguous().t(), sin[:1]),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_card_path_refuses_what_the_kernel_cannot_read(card, case):
    """On the card an input no caller sends (strided, of two shapes or
    dtypes, float64, tables that are not float32 or not of x's positions)
    raises, as for the fault kernels: no launch and no chain."""
    with torch.no_grad(), pytest.raises(ValueError):
        _refusals()[case]()
    assert card == [] and ops.unfused == {"swiglu": 0, "rope": 0}


@pytest.mark.parametrize("act", ["gelu_glu", "silu", "relu"])
def test_gate_keeps_other_activations_op_by_op(card, act):
    """Only ``silu_glu`` takes ``ops.swiglu``; every other activation runs
    ``_act`` (times the second product where gated), as before."""
    h1, h3 = _draw((3, 8), torch.bfloat16, 13), _draw((3, 8),
                                                      torch.bfloat16, 14)
    want = L._act(h1, act) * h3 if act.endswith("_glu") else L._act(h1, act)
    assert _same_bits(L._gate(h1, act, lambda: h3), want)
    assert card == [] and ops.unfused == {"swiglu": 0, "rope": 0}


def test_meta_dry_run_takes_the_chain():
    """On the meta device (the dry run) the wrappers run the chains, which
    give their shapes and dtypes, and launch and count nothing."""
    ops.reset_launches()
    h1 = torch.empty(2, 4, 8, dtype=torch.bfloat16, device="meta")
    assert ops.swiglu(h1, h1).shape == (2, 4, 8)
    x = torch.empty(2, 1, 5, 3, 16, dtype=torch.bfloat16, device="meta")
    y = L.rope(x, torch.empty(5, dtype=torch.int32, device="meta"), 1e4)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert ops.launches["swiglu"] == ops.launches["rope"] == 0
    assert ops.unfused == {"swiglu": 0, "rope": 0}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_swiglu_every_h1_bitwise_on_card(dev, dtype):
    """Every one of the 65 536 16-bit values of h1 (exp sees no others),
    against a spread of h3 (signs, zero, subnormal, huge, inf, NaN)."""
    h1 = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    h1 = h1.view(dtype).to(dev)
    tiny = torch.finfo(dtype).tiny / 4
    h3 = torch.tensor([1.0, -1.0, 0.0, -0.0, 0.5, 3.140625, -7.0, 1e-3, tiny,
                       torch.finfo(dtype).max, float("inf"), float("nan")],
                      dtype=dtype, device=dev)
    h1 = h1.expand(h3.numel(), -1).contiguous()
    h3 = h3[:, None].expand_as(h1).contiguous()
    ops.reset_launches()
    got = ops.swiglu(h1, h3)
    assert ops.launches["swiglu"] == 1 and ops.unfused["swiglu"] == 0
    want = ref.swiglu_ref(h1, h3)
    bad = (got.view(torch.int16) != want.view(torch.int16)).nonzero()
    assert bad.numel() == 0, (bad[:8].tolist(), h1[tuple(bad[0])].item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["olmo-1b", "odd", "unaligned"])
def test_swiglu_bitwise_on_card(dev, dtype, case):
    """Random h1, h3 at olmo-1b's ``[1, 8, 256, 8192]``, at 3 x 1001
    elements (a tail past the 16-byte vectors) and one element off 16-byte
    alignment (the one-element path)."""
    shape = (1, 8, 256, 8192) if case == "olmo-1b" else (3, 1001)
    h1, h3 = _draw(shape, dtype, 20, dev), _draw(shape, dtype, 21, dev)
    if case == "unaligned":
        h1 = _draw((3 * 1001 + 1,), dtype, 22, dev)[1:].reshape(shape)
    got = ops.swiglu(h1, h3)
    assert _same_bits(got, ref.swiglu_ref(h1, h3))
    assert _same_bits(got, _old_gate(h1, h3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 8, 256, 16, 128), (1, 2, 7, 3, 128),
                                   (1, 1, 5, 2, 6)])
def test_rope_bitwise_on_card(dev, dtype, shape):
    """``[R, B, S, H, Dh]`` at olmo-1b's q/k of two rows, a small odd S,
    and Dh = 6 (halves of 3: the one-element path), against the old code
    (tables and all) and ``ref.rope_ref``."""
    x = _draw(shape, dtype, 30, dev)
    S, dh = shape[2], shape[-1]
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    ops.reset_launches()
    got = L.rope(x, pos, 10000.0)
    assert ops.launches["rope"] == 1 and ops.unfused["rope"] == 0
    assert _same_bits(got, _old_rope(x, pos, 10000.0))
    assert _same_bits(got, ref.rope_ref(x, *L.rope_tables(pos, dh // 2,
                                                          10000.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_decode_positions_bitwise_on_card(dev, dtype):
    """Decode's ``[B, 1]`` positions, each sequence at its own: x ``[B, 1,
    H, Dh]`` against the old code and ``ref.rope_ref``, one launch."""
    x = _draw((6, 1, 16, 128), dtype, 31, dev)
    pos = torch.tensor([0, 1, 255, 256, 4095, 70000], dtype=torch.int32,
                       device=dev)[:, None]
    ops.reset_launches()
    got = L.rope(x, pos, 10000.0)
    assert ops.launches["rope"] == 1 and ops.unfused["rope"] == 0
    assert _same_bits(got, _old_rope(x, pos, 10000.0))
    assert _same_bits(got, ref.rope_ref(x, *L.rope_tables(pos, 64, 10000.0)))


@pytest.mark.cuda
def test_decode_with_faults_same_without_the_kernels_on_card(dev,
                                                             monkeypatch):
    """A reduced bf16 olmo-1b prefill and three decode steps (the last
    faulted) of 3 sequences: logits bitwise what the op-by-op chains give;
    a decode step launches one ``swiglu`` and two ``rope`` a layer and
    takes no chain."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="bfloat16")
    params = T.init_lm(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab, (3, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    w = torch.full((cfg.n_layers,), 0.05, device=dev)
    res = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(ops, "swiglu", ref.swiglu_ref)
            monkeypatch.setattr(ops, "rope", ref.rope_ref)
        out = []
        with torch.no_grad():
            logits, cache = T.prefill(params, cfg, {"tokens": toks},
                                      max_len=16)
            out.append(logits)
            last = logits[:, -1].argmax(-1).int()
            pos = torch.full((3,), 8, dtype=torch.int32, device=dev)
            for i in range(3):
                ops.reset_launches()
                logits, cache = T.decode_step(
                    params, cfg, cache, last, pos,
                    fault=(w, w, 7) if i == 2 else None)
                if fused:
                    assert ops.launches["rope"] == 2 * cfg.n_layers
                    assert ops.launches["swiglu"] == cfg.n_layers
                    assert ops.unfused == {"swiglu": 0, "rope": 0}
                out.append(logits)
                last, pos = logits.argmax(-1).int(), pos + 1
        res[fused] = out
    for a, b in zip(res[True], res[False]):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_staged_olmo_with_faults_same_without_the_kernels_on_card(dev,
                                                                  monkeypatch):
    """A reduced bf16 olmo-1b (B = 2, S = 16) with faults: the whole
    forward's logits over 3 rows and the staged kernel-backend ΔAcc are
    bitwise what the op-by-op chains give; the staged search launches one
    ``swiglu`` and two ``rope`` a unit step (a unit over a chunk of rows)
    and takes no chain."""
    from repro_torch.configs import get_config
    from repro_torch.core import FaultSpec, make_lm_accuracy_evaluator
    from repro_torch.lm_setup import lm_calibration_setup
    from repro_torch.models.transformer import forward

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="bfloat16")
    params, batch, labels = lm_calibration_setup(cfg, B=2, S=16, device=dev)
    L_ = cfg.n_layers
    rates = torch.tensor([[0.0] * L_, [0.2] * L_, [0.05] * L_], device=dev)
    P = np.random.default_rng(0).integers(0, 4, size=(6, L_))
    scale = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    res = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(ops, "swiglu", ref.swiglu_ref)
            monkeypatch.setattr(ops, "rope", ref.rope_ref)
        with torch.no_grad():
            logits = forward(params, cfg, batch, fault=(rates, rates, 5))
        ev = make_lm_accuracy_evaluator(
            cfg, params, batch, labels, FaultSpec(bits=8, faulty_bits=6),
            scale, fault_backend="kernel", eval_strategy="staged",
            eval_batch_size=3, device=dev)
        ops.reset_launches()
        res[fused] = (logits, ev.delta_acc(P))
        if fused:
            assert ops.launches["rope"] == 2 * ops.launches["swiglu"] > 0, \
                ops.launches
            assert ops.unfused == {"swiglu": 0, "rope": 0}
    assert _same_bits(res[True][0], res[False][0])
    np.testing.assert_array_equal(res[True][1], res[False][1])
