"""Architecture + workload-shape schema, the counterpart of
``repro/configs/base.py`` with the dtype mapped to torch.

Every assigned architecture is a frozen ``ArchConfig``; every workload
cell is an ``ArchConfig`` x ``ShapeSpec`` pair.  ``reduced()`` gives the
small same-family configuration the CPU parity tests run (small widths,
few layers, tiny vocab, float32).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The LM-family shape set (assignment block).  decode_*/long_* lower
# serve_step (one new token against a seq_len KV cache), not train_step.
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A model architecture, parameterised enough to express all ten
    assigned families (dense/GQA, MoE, SSM, hybrid, enc-dec, VLM/audio
    stub frontends) plus the paper's CNNs live in models/cnn.py."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                 # 0 => d_model // n_heads
    # --- attention variant ---
    attn_kind: str = "global"         # global | swa | local_global
    window: int = 4096                # SWA / local window
    logit_softcap: float = 0.0        # gemma2 attention softcap
    final_softcap: float = 0.0        # gemma2 final-logit softcap
    rope_theta: float = 10000.0
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm | np_layernorm
    act_fn: str = "silu"              # silu | gelu | relu_sq
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0              # per-expert hidden (arctic: 4864)
    moe_dense_residual: bool = False  # arctic: dense FFN residual beside MoE
    dense_d_ff: int = 0               # width of arctic's parallel dense FFN
    moe_capacity_factor: float = 2.0  # capacity = cf*topk*T/E (decode: dropless)
    # --- recurrent / SSM ---
    block_pattern: tuple[str, ...] = ("attn",)
    #   e.g. ("attn",)                         plain decoder
    #        ("local", "global")               gemma2 alternation
    #        ("rglru", "rglru", "local")       recurrentgemma (1 attn : 2 rec)
    #        ("ssd",)                          mamba2
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    lru_width: int = 0                # 0 => d_model
    # --- encoder-decoder ---
    n_enc_layers: int = 0             # >0 => enc-dec (seamless)
    enc_ratio: int = 1                # encoder memory len = seq/enc_ratio
    # --- modality frontend stub ---
    frontend: str = "none"            # none | vision | audio
    frontend_tokens: int = 0          # prepended embedding tokens (vision)
    # --- numerics / misc ---
    dtype: str = "bfloat16"
    source: str = ""                  # provenance tag [hf/arXiv]
    notes: str = ""

    # ---------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(k == "ssd" for k in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if decode KV state is bounded (skip-rule for long_500k)."""
        return all(k in ("ssd", "rglru", "local") for k in self.block_pattern) \
            or (self.attn_kind == "swa" and self.block_pattern == ("attn",)) \
            or self.name.startswith("gemma2")  # hybrid local/global: see DESIGN.md

    @property
    def n_groups(self) -> int:
        """Number of scanned block groups (pattern repetitions)."""
        return -(-self.n_layers // len(self.block_pattern))

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.subquadratic
        return True

    def param_count(self) -> float:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd, hq, hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        per: dict[str, float] = {}
        per["attn"] = d * hd * (hq + 2 * hkv) + hq * hd * d + 2 * d
        per["local"] = per["global"] = per["attn"]
        per["mlp"] = 3 * d * dff + d
        if self.is_moe:
            eff = self.expert_d_ff or dff
            per["moe"] = self.n_experts * 3 * d * eff + d * self.n_experts + d
            if self.moe_dense_residual:
                per["moe"] += 3 * d * (self.dense_d_ff or dff)
        # SSD: in_proj d->(2*d_in + 2*state + n_heads), conv, out_proj d_in->d
        d_in = self.ssm_expand * d
        nh = d_in // self.ssm_head_dim
        per["ssd"] = d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d \
            + self.conv_kernel * (d_in + 2 * self.ssm_state) + nh
        lru = self.lru_width or d
        per["rglru"] = d * (2 * lru) + lru * d + 3 * lru + self.conv_kernel * lru
        total = 0.0
        for li in range(self.n_layers):
            kind = self.block_pattern[li % len(self.block_pattern)]
            if kind in ("attn", "local", "global"):
                total += per["attn"] + (per["moe"] if self.is_moe else per["mlp"])
            elif kind == "ssd":
                total += per["ssd"]
            elif kind == "rglru":
                total += per["rglru"] + per["mlp"]
        total += v * d                       # embeddings
        if not self.tie_embeddings:
            total += v * d                   # lm head
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            total += self.n_enc_layers * (per["attn"] + per["mlp"])
            total += self.n_layers * per["attn"]   # cross-attention blocks
        return total

    def active_param_count(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        eff = self.expert_d_ff or self.d_ff
        dense_all = self.n_experts * 3 * d * eff
        dense_active = self.top_k * 3 * d * eff
        return self.param_count() - self.n_layers * (dense_all - dense_active)

    # ---------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        pat = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(pat, 2 if pat == 1 else pat),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab=128,
            head_dim=16,
            window=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            expert_d_ff=64 if self.n_experts else 0,
            dense_d_ff=64 if self.moe_dense_residual else 0,
            ssm_state=16,
            ssm_head_dim=16,
            lru_width=64 if self.lru_width else 0,
            n_enc_layers=2 if self.is_encdec else 0,
            frontend_tokens=4 if self.frontend == "vision" else 0,
            dtype="float32",
        )
