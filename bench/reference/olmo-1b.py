"""OLMo-1B (Groeneveld et al. 2024, arXiv:2402.00838) in plain PyTorch,
bfloat16 with float32 norms, softmax and accumulation, under the
configuration's fault model; and the benchmark's weights and calibration
tokens made from the seed.

The decoder as the configuration states it: 16 pre-norm blocks of causal
multi-head self-attention (16 heads of 128, rotary embeddings on the
first and second half of each head, base 10000) and a SwiGLU MLP
(``w2(silu(x w1) * (x w3))``, width 8192), non-parametric LayerNorm (no
gain, no bias), no biases anywhere, the embedding tied to the output
head.  Departures from the published model, stated in the configuration
file: the embedding is scaled by sqrt(d_model), and LayerNorm's epsilon is
1e-6.

Each block is a partitionable unit.  A unit mapped to device ``d`` runs
with its input activations and its seven weight matrices corrupted at
that device's rates (``fault.py``) in the configuration's fixed-point
format, the weights dequantized to bfloat16.  The embedding, the final
norm and the head are never corrupted.

ΔAcc of a mapping is ``max(0, clean - faulty)`` over the B x S tokens:
labels are the unquantized model's own argmax, ``clean`` the accuracy of
the rate-0 pass (weights and activations quantized, nothing flipped).

``precision="fp8"`` is the control: every weight product (projections,
MLP, head) in float8 e4m3, each operand scaled per tensor into its range
(largest magnitude to 448), the products accumulated in float32.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from bench.reference import cost, fault

# the block's leaves in sorted-key order (attn.{wk,wo,wq,wv}, mlp.{w1,w2,w3});
# the norms hold none.  Leaf j's fault seed is the unit's + 977 j
LEAVES = ("attn.wk", "attn.wo", "attn.wq", "attn.wv", "mlp.w1", "mlp.w2",
          "mlp.w3")


def _dims(conf):
    a = conf["arch"]
    return (a["num_hidden_layers"], a["hidden_size"], a["num_attention_heads"],
            a["head_dim"], a["intermediate_size"], a["embedding_size"])


def leaf_shape(conf, name):
    _, D, H, Dh, Fd, _ = _dims(conf)
    return {"attn.wq": (D, H * Dh), "attn.wk": (D, H * Dh),
            "attn.wv": (D, H * Dh), "attn.wo": (H * Dh, D),
            "mlp.w1": (D, Fd), "mlp.w3": (D, Fd), "mlp.w2": (Fd, D)}[name]


def layers(conf, seq: int = 4096) -> list[tuple]:
    """Per-token ``(macs, weight_bytes, act_in_bytes, act_out_bytes)`` of
    each block at the cost model's ``seq`` (2 bytes a bf16 value, else 4);
    attention scores count half the context (causal)."""
    n, D, H, Dh, Fd, _ = _dims(conf)
    bpp = 2 if conf["dtype"] == "bfloat16" else 4
    act = seq * D * bpp
    wp = D * Dh * (H + 2 * H) + H * Dh * D
    proj = seq * D * Dh * (H + 2 * H) + seq * H * Dh * D
    macs = proj + seq * H * Dh * (seq / 2) * 2
    wp += D * Fd * 3
    macs += seq * (D * Fd * 3)
    return [(macs / seq, wp * bpp, act, act)] * n


# ------------------------------------------------------ weights and inputs
def make_weights(conf, seed: int, device) -> dict:
    """Normal weights drawn in float32 on the device, one draw a kind of
    leaf for all layers, cast to the configuration's dtype: the embedding at std 0.02, each
    matrix at std 1/sqrt(fan_in).  The program's tree layout: stacked
    blocks under ``groups.b0``, norms without parameters."""
    n, D, H, Dh, Fd, V = _dims(conf)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, conf["dtype"])

    def draw(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    block = {"ln1": {}, "ln2": {}, "attn": {}, "mlp": {}}
    for name in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w1",
                 "mlp.w2", "mlp.w3"):
        k_in, k_out = leaf_shape(conf, name)
        part, leaf = name.split(".")
        block[part][leaf] = draw((n, k_in, k_out), 1.0 / math.sqrt(k_in))
    embed = draw((V, D), 0.02)
    return {"embed": embed, "groups": {"b0": block}, "final_norm": {}}


def make_tokens(conf, seed: int, device) -> torch.Tensor:
    """``[B, S]`` int32 tokens, uniform over the real vocabulary."""
    c = conf["calibration"]
    rng = np.random.default_rng(seed)
    t = rng.integers(0, conf["arch"]["vocab_size"], (c["batch"], c["seq"]))
    return torch.as_tensor(t.astype(np.int32), device=device)


def make(conf, rng_weights, rng_inputs, device) -> dict:
    return {"params": make_weights(conf, int(rng_weights.integers(0, 2 ** 62)),
                                   device),
            "tokens": make_tokens(conf, int(rng_inputs.integers(0, 2 ** 62)),
                                  device)}


# ----------------------------------------------------------------- forward
def _ln(x, eps):
    xf = x.float()
    c = xf - xf.mean(-1, keepdim=True)
    return (c * torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)).to(x.dtype)


def _rope(x, theta):
    """``x [B, S, H, Dh]``: rotate the first and second halves of a head."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


def _attention(q, k, v, causal):
    """Softmax attention in float32, ``[B, S, H, Dh]`` each: scores of the
    scaled queries (the scale rounded to q's dtype), masked to the past,
    the maximum subtracted, the exponentials' weighted sum of v divided by
    their sum."""
    Dh = q.shape[-1]
    qs = (q * torch.tensor(Dh ** -0.5, dtype=q.dtype)).float().unsqueeze(3)
    s = torch.einsum("bqhgd,bchd->bqhgc", qs, k.float())
    s = torch.where(causal[None, :, None, None, :], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bqhgc,bchd->bqhgd", p, v.float())
    return (o / p.sum(-1, keepdim=True)).squeeze(3)


def _silu(x):
    return x * (1 / (1 + torch.exp(-x)))


@contextlib.contextmanager
def _fp32_sums():
    """Every product summed in float32: no TF32, no reduced-precision
    reduction of bf16 products; the caller's settings restored on exit."""
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def _fp8(t):
    """``t`` rounded to float8 e4m3 after scaling its largest magnitude to
    448; returns the float32 values and the scale."""
    s = t.abs().amax().float().clamp_min(1e-30) / 448.0
    return (t.float() / s).to(torch.float8_e4m3fn).float(), s


class Reference:
    def __init__(self, conf, params, tokens, precision: str = "bf16"):
        self.conf, self.params, self.tokens = conf, params, tokens
        self.fp8 = {"bf16": False, "fp8": True}[precision]
        fp = conf["fault"]
        self.bits, self.faulty = fp["bits"], fp["faulty_bits"]
        self.base = conf["base_seed"]
        self.n_units = conf["arch"]["num_hidden_layers"]
        self.eps = conf["arch"]["layer_norm_eps"]
        self.theta = conf["arch"]["rope_theta"]
        with torch.no_grad(), _fp32_sums():
            raw = [{k: self._leaf(i, k) for k in LEAVES}
                   for i in range(self.n_units)]
            self.labels = self._forward(raw, [None] * self.n_units,
                                        quantize=False).argmax(-1)
            clean = [{k: fault.corrupt(w, self.bits, None) for k, w in u.items()}
                     for u in raw]
            self.clean = self._acc(self._forward(clean, [None] * self.n_units))

    def _leaf(self, i, name):
        part, leaf = name.split(".")
        return self.params["groups"]["b0"][part][leaf][i]

    def _mm(self, a, w):
        if not self.fp8:
            return a @ w
        a8, sa = _fp8(a)
        w8, sw = _fp8(w)
        return ((a8 @ w8) * (sa * sw)).to(a.dtype)

    def _acc(self, logits) -> float:
        return float((logits.argmax(-1) == self.labels).float().mean())

    def _forward(self, weights, act_masks, quantize=True):
        """Logits ``[B, S, V]`` with unit ``i``'s leaves ``weights[i]`` and
        its input flipped by ``act_masks[i]`` (None: quantized alone;
        ``quantize=False``: the unquantized model)."""
        _, D, H, Dh, _, _ = _dims(self.conf)
        embed = self.params["embed"]
        x = embed[self.tokens.long()]
        x = x * torch.tensor(math.sqrt(D), dtype=x.dtype)
        B, S, _ = x.shape
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        for i in range(self.n_units):
            w = weights[i]
            if quantize:
                x = fault.corrupt(x, self.bits, act_masks[i])
            h = _ln(x, self.eps)
            q = self._mm(h, w["attn.wq"]).view(B, S, H, Dh)
            k = self._mm(h, w["attn.wk"]).view(B, S, H, Dh)
            v = self._mm(h, w["attn.wv"]).view(B, S, H, Dh)
            q, k = _rope(q, self.theta), _rope(k, self.theta)
            o = _attention(q, k, v, causal)
            x = x + self._mm(o.to(x.dtype).reshape(B, S, H * Dh), w["attn.wo"])
            h = _ln(x, self.eps)
            f = _silu(self._mm(h, w["mlp.w1"])) * self._mm(h, w["mlp.w3"])
            x = x + self._mm(f, w["mlp.w2"])
        return self._mm(_ln(x, self.eps), embed.t())

    def _act_masks(self, a_rates):
        _, D, _, _, _, _ = _dims(self.conf)
        n = self.tokens.numel() * D
        return [fault.flip_masks(n, fault.unit_seed(self.base, i)
                                 + fault.ACT_OFFSET, a_rates, self.faulty,
                                 self.tokens.device)
                for i in range(self.n_units)]

    def _tables(self, w_rates):
        """``[unit][device] -> {leaf: bf16 weights}`` at ``w_rates``."""
        out = []
        for i in range(self.n_units):
            seed = fault.unit_seed(self.base, i)
            per_dev = [dict() for _ in w_rates]
            for j, name in enumerate(LEAVES):
                ws = fault.corrupted_weights(
                    self._leaf(i, name), self.bits,
                    seed + fault.LEAF_STRIDE * j, w_rates, self.faulty)
                for d, wd in enumerate(ws):
                    per_dev[d][name] = wd
            out.append(per_dev)
        return out

    @torch.no_grad()
    @_fp32_sums()
    def delta_acc(self, rows: np.ndarray, device_scale: np.ndarray
                  ) -> np.ndarray:
        rates = fault_rates(self.conf, device_scale)
        tables = self._tables(rates["weight"])
        masks = self._act_masks(rates["act"])
        out = []
        for row in np.asarray(rows):
            logits = self._forward([tables[i][d] for i, d in enumerate(row)],
                                   [masks[i][d] for i, d in enumerate(row)])
            out.append(max(0.0, self.clean - self._acc(logits)))
        del tables, masks
        return np.asarray(out)


def fault_rates(conf, device_scale) -> dict:
    scale = np.asarray(device_scale, np.float32)
    f = conf["fault"]
    return {"weight": np.asarray(f["weight_fault_rate"] * scale, np.float32),
            "act": np.asarray(f["act_fault_rate"] * scale, np.float32)}


def latency_energy(conf, rows):
    return cost.latency_energy(layers(conf), conf["ladder"], np.asarray(rows))
