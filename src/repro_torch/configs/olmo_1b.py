"""olmo-1b [dense]: non-parametric LayerNorm.

[arXiv:2402.00838; hf]  16L d_model=2048 16H (kv=16) d_ff=8192
vocab=50304.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, head_dim=128, attn_kind="global",
    norm_kind="np_layernorm", act_fn="silu_glu", tie_embeddings=True,
    source="arXiv:2402.00838")
