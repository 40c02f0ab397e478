"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained 16-expert top-4 MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352.
36B active / 132B total — FSDP + TP + EP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    capacity_factor=1.25,
    mlp_act="silu",
    tie_embeddings=False,
    fsdp=True,
)
