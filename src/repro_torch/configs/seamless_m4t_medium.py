"""seamless-m4t-medium [audio]: encoder-decoder, multimodal frontend stub.

[arXiv:2308.11596; hf]  12L (x2: enc+dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  Speech frames are pre-downsampled by the stub
frontend (enc memory length = seq/8).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, head_dim=64, attn_kind="global", norm_kind="layernorm",
    act_fn="relu", n_enc_layers=12, enc_ratio=8, frontend="audio",
    source="arXiv:2308.11596", notes="enc-dec; audio frontend stubbed")
