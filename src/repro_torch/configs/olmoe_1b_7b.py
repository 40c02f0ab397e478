"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE.

16L d_model=2048 16H (MHA kv=16) d_ff=1024 (per expert) vocab=50304.
1B active / 7B total.  Experts sharded over the model axis (EP == TP
axis); token dispatch is the all-to-all that dominates its roofline.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    capacity_factor=1.25,
    mlp_act="silu",
    tie_embeddings=False,
)
