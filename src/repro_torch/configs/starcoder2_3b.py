"""starcoder2-3b [dense]: GQA kv=2, RoPE.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.  Non-gated GELU MLP (4x widening), layernorm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab=49152, head_dim=128, attn_kind="global", rope_theta=999999.0,
    norm_kind="layernorm", act_fn="gelu",
    source="arXiv:2402.19173")
