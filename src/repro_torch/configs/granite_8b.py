"""Granite-8B-Code [arXiv:2405.04324]: llama-arch, code model.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=49152,
    mlp_act="silu",
    tie_embeddings=False,
    fsdp=True,
)
