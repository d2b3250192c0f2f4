"""The work one calibration pass of each OLMo-1B block needs, from the
configuration's shapes: B x S = M tokens through the block.

  * ``fm_flops``: the seven weight products (q, k, v, o, w1, w3, w2),
    2 M K N each, on the tensor cores in bf16 (the ``fault_matmul``
    route: its hash pass and its product);
  * ``fm_bytes``: what those products need from memory: x (bf16) and the
    int8 weights read once, the bf16 result written once;
  * ``fm_draws``: the weights' hash draws, one a faulty bit a weight, once
    an environment (a draw does not depend on the row);
  * ``flops``: the products, causal attention (q k^T and p v over the
    S (S + 1) / 2 pairs each needs) and, at the last block, the tied head
    (2 M D V);
  * ``act_elems`` / ``act_bytes`` / ``act_draws``: the block's bf16 input,
    which ``quant_bitflip`` reads once and writes once, and its draws.
"""
from __future__ import annotations

# the group the profile files the kernels it does not know under
LIBRARY_GROUP = "cublas"


def unit_work(conf) -> list[dict]:
    a, c = conf["arch"], conf["calibration"]
    L, D, H, Dh, F, V = (a["num_hidden_layers"], a["hidden_size"],
                         a["num_attention_heads"], a["head_dim"],
                         a["intermediate_size"], a["embedding_size"])
    B, S = c["batch"], c["seq"]
    M = B * S
    fb = conf["fault"]["faulty_bits"]
    shapes = [(D, H * Dh)] * 3 + [(H * Dh, D), (D, F), (D, F), (F, D)]
    fm_flops = sum(2.0 * M * k * n for k, n in shapes)
    fm_bytes = sum(2.0 * M * k + 1.0 * k * n + 2.0 * M * n for k, n in shapes)
    weights = sum(k * n for k, n in shapes)
    attn = 2 * 2.0 * B * H * Dh * S * (S + 1) / 2
    out = []
    for i in range(L):
        head = 2.0 * M * D * V if i == L - 1 else 0.0
        out.append({"flops": fm_flops + attn + head, "conv_flops": 0.0,
                    "fm_flops": fm_flops, "fm_bytes": fm_bytes,
                    "fm_draws": weights * fb, "act_elems": M * D,
                    "act_bytes": 2 * 2.0 * M * D, "act_draws": M * D * fb})
    return out
