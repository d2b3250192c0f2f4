"""LayerGraph extraction: ArchConfig -> list[LayerInfo] for the partitioner,
the counterpart of ``repro/models/graph.py`` (pure arithmetic, every config).

This is the bridge between the model zoo and the paper's technique: every
architecture (including the 3-480B LMs) is reduced to a sequence of
partitionable layer nodes with per-sample MACs, weight bytes and
activation payloads, so AFarePart's NSGA-II can map layers to device
tiers / pods.  Sensitivities start at an analytic prior (relative weight
volume x depth position) and are replaced by profiled values when a
layer-wise sweep is run (``core.objectives.profile_layer_sensitivity``).
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import LayerInfo

__all__ = ["lm_layer_infos", "bytes_per_param", "lm_eval_strategy"]


def bytes_per_param(cfg: ArchConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _attn_macs(cfg: ArchConfig, seq: int, window: int | None) -> float:
    dh, hq, hkv, d = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    proj = seq * d * dh * (hq + 2 * hkv) + seq * hq * dh * d
    ctx = min(seq, window) if window else seq
    # causal average context ~ ctx/2 for full attention
    eff = ctx / 2 if not window else min(ctx, seq)
    score = seq * hq * dh * eff * 2
    return proj + score


def lm_layer_infos(cfg: ArchConfig, seq: int = 4096) -> list[LayerInfo]:
    bpp = bytes_per_param(cfg)
    d = cfg.d_model
    act_bytes = seq * d * bpp
    infos: list[LayerInfo] = []

    def attn_weight_params():
        return d * cfg.head_dim_ * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * cfg.head_dim_ * d

    def mlp_params(dff, gated):
        return d * dff * (3 if gated else 2)

    gated = cfg.act_fn.endswith("_glu")

    if cfg.is_encdec:
        enc_seq = max(1, seq // cfg.enc_ratio)
        for i in range(cfg.n_enc_layers):
            wp = attn_weight_params() + mlp_params(cfg.d_ff, gated)
            macs = _attn_macs(cfg, enc_seq, None) \
                + enc_seq * mlp_params(cfg.d_ff, gated)
            infos.append(LayerInfo(
                f"enc{i}", "attn", macs / seq, wp * bpp,
                enc_seq * d * bpp / seq * seq, enc_seq * d * bpp,
                params=wp, sensitivity=_prior(i, cfg.n_enc_layers + cfg.n_layers)))
        for i in range(cfg.n_layers):
            wp = 2 * attn_weight_params() + mlp_params(cfg.d_ff, gated)
            macs = _attn_macs(cfg, seq, None) * 2 \
                + seq * mlp_params(cfg.d_ff, gated)
            infos.append(LayerInfo(
                f"dec{i}", "attn", macs / seq, wp * bpp, act_bytes, act_bytes,
                params=wp,
                sensitivity=_prior(cfg.n_enc_layers + i,
                                   cfg.n_enc_layers + cfg.n_layers)))
        return infos

    for i in range(cfg.n_layers):
        kind = cfg.block_pattern[i % len(cfg.block_pattern)]
        if kind in ("attn", "local", "global"):
            window = cfg.window if (
                kind == "local" or cfg.attn_kind == "swa") else None
            wp = attn_weight_params()
            macs = _attn_macs(cfg, seq, window)
            if cfg.is_moe:
                eff = cfg.expert_d_ff or cfg.d_ff
                wp += cfg.n_experts * 3 * d * eff + d * cfg.n_experts
                macs += seq * cfg.top_k * 3 * d * eff + seq * d * cfg.n_experts
                if cfg.moe_dense_residual:
                    dd = cfg.dense_d_ff or cfg.d_ff
                    wp += 3 * d * dd
                    macs += seq * 3 * d * dd
            else:
                wp += mlp_params(cfg.d_ff, gated)
                macs += seq * mlp_params(cfg.d_ff, gated)
        elif kind == "rglru":
            w = cfg.lru_width or d
            wp = 2 * d * w + w * d + 2 * w * w \
                + mlp_params(cfg.d_ff, gated)
            macs = seq * wp
        elif kind == "ssd":
            d_in = cfg.ssm_expand * d
            nh = d_in // cfg.ssm_head_dim
            wp = d * (2 * d_in + 2 * cfg.ssm_state + nh) + d_in * d
            macs = seq * wp + seq * cfg.ssm_state * d_in * 2
        else:
            raise ValueError(kind)
        infos.append(LayerInfo(
            f"L{i}:{kind}", kind, macs / seq, wp * bpp,
            act_bytes, act_bytes, params=wp,
            sensitivity=_prior(i, cfg.n_layers)))
    return infos


def lm_eval_strategy(cfg: ArchConfig, budget: int | None = None,
                     headroom: float = 1.5, device="cuda") -> str:
    """Resolve the ΔAcc evaluation path for an LM config.

    ``"staged"``: the arch is small enough to instantiate on this host,
    so the true fault-injected staged (prefix-reuse) evaluator runs in
    the NSGA-II loop (``core.objectives.make_lm_accuracy_evaluator``).
    ``"surrogate"``: cost-model scale — the params would not fit, so
    ΔAcc comes from the calibrated sensitivity surrogate over these
    layer infos instead.

    The bar is memory, not an arch list: resident weights
    (``param_count() x bytes/param``) times ``headroom`` (the staged
    fault path materialises one unit's corrupted copy at a time, plus
    activations) must fit the evaluation budget
    (``core.eval_engine.device_memory_budget`` of ``device``; env
    ``REPRO_EVAL_MEM_BUDGET`` overrides).  At a 16 GiB budget the 1-4B
    zoo (olmo-1b, starcoder2-3b, recurrentgemma-2b, mamba2-2.7b,
    seamless) resolves staged and the 27-480B configs resolve surrogate.
    """
    from repro_torch.core.eval_engine import device_memory_budget
    if budget is None:
        budget = device_memory_budget(device=resolve_device(device))
    need = cfg.param_count() * bytes_per_param(cfg) * headroom
    return "staged" if need <= budget else "surrogate"


def _prior(i: int, n: int) -> float:
    """Analytic sensitivity prior: earlier layers propagate corruption
    through more downstream compute (the paper evaluates faults in the
    early conv layers for exactly this reason); slight uptick at the end
    because the head amplifies logit noise."""
    x = i / max(n - 1, 1)
    return float(0.002 * (1.35 - x + 0.25 * x ** 4))
