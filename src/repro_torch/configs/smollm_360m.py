"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: llama-arch small model.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
Also the end-to-end training-example arch (reduced) in examples/.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_head=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_act="silu",
    tie_embeddings=True,
)
