"""arctic-480b [moe]: 128 experts top-2 + dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA
kv=8) expert d_ff=4864 vocab=32000, MoE 128e top-2 with a parallel
dense FFN residual (dense-MoE hybrid).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, attn_kind="global", norm_kind="rmsnorm",
    act_fn="silu_glu", n_experts=128, top_k=2, expert_d_ff=4864,
    moe_dense_residual=True, dense_d_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base")
