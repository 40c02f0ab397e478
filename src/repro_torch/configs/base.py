"""Config system of the port: architectures and input shapes.

A copy of the reference's ``configs/base.py`` (the port imports nothing of
the JAX package).  ``ModelConfig`` is a frozen dataclass; one file per
architecture lives next to this module, field for field the reference's,
and ``get_config(name)`` resolves them (all ten architectures, six
families).  ``reduced_config`` shrinks an architecture to a CPU-testable
size while keeping its structure (family, GQA ratio, local/global
pattern, ...).  The execution fields are the reference's: ``fsdp`` adds
the FSDP axes to ``param_spec``, ``"ring"`` attention runs on a device
mesh (the model's ``ring_mesh``), ``remat`` is read by the training path
only, and ``scan_layers`` by nothing (the port's layers always run in a
Python loop).
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    # --- attention variants -------------------------------------------
    rope_theta: float = 10000.0
    window: int = 0            # sliding-window size for local layers
    local_global_period: int = 0   # gemma2: every Nth layer is global
    global_layers: tuple = ()      # hymba: explicit global layer ids
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norms: bool = False       # gemma2 post-attn/post-mlp norms
    mlp_act: str = "silu"          # silu | gelu
    tie_embeddings: bool = True
    # --- MoE -----------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_wire_int8: bool = False    # quantize token->expert dispatch wire
    # --- SSM / hybrid ----------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- enc-dec (whisper) ----------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0       # precomputed frame embeddings (stub frontend)
    # --- vlm (paligemma) --------------------------------------------------
    prefix_len: int = 0        # precomputed patch embeddings (stub frontend)
    # --- execution -------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "chunked"   # ref | chunked | flash
    attn_chunk: int = 1024
    # --- parallelism ------------------------------------------------------
    fsdp: bool = False           # shard params+opt over data axis
    sub_quadratic: bool = False  # eligible for long_500k

    @property
    def padded_vocab(self) -> int:
        """Embedding/lm_head table rows padded to 256 (Megatron-style)
        so the vocab dim shards evenly on any production mesh; padded
        logits are masked to -inf at unembed."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def param_count(self) -> int:
        """Analytic parameter count (drives 6ND roofline numbers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe":
            mlp = 3 * d * f * self.n_experts + d * self.n_experts  # + router
        elif self.family == "ssm":
            mlp = 0
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            # one mLSTM + one sLSTM block per pair (see models/xlstm.py)
            di = self.ssm_expand * d
            mlstm = 2 * d * di + 3 * di * di + di * 2 * self.n_heads \
                + di * d
            slstm = 4 * d * di + 4 * di + di * d
            per_layer = (mlstm + slstm + 2 * d) / 2
        if self.family == "hybrid":
            di = self.ssm_expand * d
            ssm = 2 * d * di + di * d + di * self.ssm_state * 2
            per_layer = attn + 3 * d * f + ssm + 2 * d
        total = per_layer * self.n_layers + v * d
        if not self.tie_embeddings:
            total += v * d
        if self.family == "encdec":
            enc_layer = 4 * d * d + 3 * d * f + 2 * d
            cross = 4 * d * d + d
            total += enc_layer * self.n_encoder_layers + cross * self.n_layers
        return int(total)

    def active_param_count(self) -> int:
        """Routed-active params (MoE): replaces E experts by top_k."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        return int(full - 3 * d * f * (self.n_experts - self.top_k)
                   * self.n_layers)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCHS = [
    "hymba_1p5b", "mistral_large_123b", "gemma2_2b", "smollm_360m",
    "granite_8b", "olmoe_1b_7b", "dbrx_132b", "xlstm_125m",
    "whisper_large_v3", "paligemma_3b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "hymba-1.5b": "hymba_1p5b", "mistral-large-123b": "mistral_large_123b",
    "gemma2-2b": "gemma2_2b", "smollm-360m": "smollm_360m",
    "granite-8b": "granite_8b", "olmoe-1b-7b": "olmoe_1b_7b",
    "dbrx-132b": "dbrx_132b", "xlstm-125m": "xlstm_125m",
    "whisper-large-v3": "whisper_large_v3", "paligemma-3b": "paligemma_3b",
})


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    """The config of ``name`` (an alias such as ``gemma2-2b`` or the module
    name)."""
    mod_name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, n_layers: int = 2, d_model: int = 64,
                   n_heads: int = 4, vocab: int = 128) -> ModelConfig:
    """Shrink to smoke-test size, preserving structure."""
    kv = max(1, n_heads * cfg.n_kv_heads // max(cfg.n_heads, 1))
    updates = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=kv, d_head=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 4,
        vocab_size=vocab,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16),
        prefix_len=min(cfg.prefix_len, 8),
        global_layers=tuple(g for g in cfg.global_layers if g < n_layers),
        dtype="float32", remat=False, attn_chunk=16,
    )
    return dataclasses.replace(cfg, **updates)
