"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, lru_width=2560, local window 2048.  Pattern
(rglru, rglru, local) x 9 groups covers 27 slots; slot 27 is masked
(26 real layers).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, attn_kind="global",
    block_pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=2560, conv_kernel=4, norm_kind="rmsnorm", act_fn="gelu_glu",
    tie_embeddings=True, source="arXiv:2402.19427")
