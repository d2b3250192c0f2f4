"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(GQA kv=32) d_ff=8192 vocab=32064.  The vision frontend is a STUB per
the assignment: input_specs provide precomputed patch embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, head_dim=96, attn_kind="global", rope_theta=10000.0,
    norm_kind="rmsnorm", act_fn="silu_glu",
    frontend="vision", frontend_tokens=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    notes="phi3-mini backbone + CLIP ViT-L/14 stub (576 patch tokens)")
