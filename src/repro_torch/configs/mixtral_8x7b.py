"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) expert
d_ff=14336 vocab=32000, SWA window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, attn_kind="swa", window=4096,
    norm_kind="rmsnorm", act_fn="silu_glu", n_experts=8, top_k=2,
    expert_d_ff=14336, rope_theta=1000000.0,
    source="arXiv:2401.04088")
