"""gemma2-27b [dense]: local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  Alternation is expressed as block_pattern=("local",
"global") scanned over 23 groups; attn softcap 50, final softcap 30,
local window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, head_dim=128, attn_kind="local_global",
    block_pattern=("local", "global"), window=4096,
    logit_softcap=50.0, final_softcap=30.0, rope_theta=10000.0,
    norm_kind="rmsnorm", act_fn="gelu_glu", tie_embeddings=True,
    source="arXiv:2408.00118")
