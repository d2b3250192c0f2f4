"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 d_ff=0 vocab=50280,
ssm_state=128, head_dim=64, expand=2.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, attn_kind="global", block_pattern=("ssd",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    norm_kind="rmsnorm", act_fn="silu_glu", tie_embeddings=True,
    source="arXiv:2405.21060")
