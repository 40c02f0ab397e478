"""PaliGemma-3B backbone [arXiv:2407.07726]: SigLIP prefix + Gemma LM.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.  The SigLIP
vision tower is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (B, 256, d_model) prepended to the token
sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=257216,
    prefix_len=256,
    mlp_act="gelu",
    tie_embeddings=True,
)
