"""Hymba-1.5B [arXiv:2411.13676]: hybrid-head parallel attention + Mamba.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Backbone: every layer runs attention heads and SSM heads in parallel on
the same input and fuses (mean) the outputs.  Sliding-window attention
everywhere except three full-attention layers (first / middle / last),
which is what makes the arch sub-quadratic and long_500k-eligible.
(Meta-tokens and cross-layer KV sharing are Hymba extras outside the
assigned backbone spec.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    window=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    mlp_act="silu",
    tie_embeddings=True,
    sub_quadratic=True,
)
