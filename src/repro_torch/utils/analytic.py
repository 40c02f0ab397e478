"""Closed-form per-chip cost model of one (arch x shape x mesh) cell, the
reference's ``utils/analytic.py``.

The formulas count matmul FLOPs exactly and bytes to first order.  All
returns are PER CHIP PER STEP:

* ``flops_hlo_equiv`` counts what the program executes (every S^2
  attention pair, masked but computed, as ``attn_chunked`` does);
  ``flops_ideal`` counts the skippable-block minimum (causal 1/2,
  windows) of a block-sparse kernel.
* Train multiplies matmul FLOPs by 3 (fwd + dgrad + wgrad) and adds a
  remat recompute factor on activation bytes.

The reference's ``CellCost.terms`` defaults to a TPU chip's peak rates;
the port's takes the chip's rates from the caller, with no default.
``cost_cell`` is the reference's for every family, term for term: MoE
expert, router and one-hot dispatch FLOPs (the reference's einsum form,
not the port's gather) and its all-to-all bytes, the xLSTM and Mamba
recurrences, the encoder and cross-attention terms, SSM decode state.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec

BF16 = 2
F32 = 4


def ring(n: int) -> float:
    return (n - 1) / n if n > 1 else 0.0


@dataclasses.dataclass
class CellCost:
    flops_hlo_equiv: float      # per chip
    flops_ideal: float          # per chip (block-sparse attention)
    hbm_bytes: float            # per chip
    coll_link_bytes: float      # per chip (ring-weighted)
    breakdown: dict

    def terms(self, peak_flops: float, hbm_bw: float, link_bw: float):
        """Seconds per step of each term at the caller's chip rates
        (FLOP/s, device memory bytes/s, link bytes/s)."""
        return {
            "compute_s": self.flops_hlo_equiv / peak_flops,
            "compute_ideal_s": self.flops_ideal / peak_flops,
            "memory_s": self.hbm_bytes / hbm_bw,
            "collective_s": self.coll_link_bytes / link_bw,
        }


def _attn_seq_eff(cfg: ModelConfig, S: int) -> tuple[float, float]:
    """(mean kv-length full-compute, mean kv-length ideal) per query,
    averaged over layers (local/global mixes)."""
    L = cfg.n_layers
    if cfg.window and cfg.local_global_period:
        n_local = (L + cfg.local_global_period - 1) // cfg.local_global_period
        n_global = L - n_local
    elif cfg.window:
        n_global = len(cfg.global_layers)
        n_local = L - n_global
    else:
        n_local, n_global = 0, L
    w = min(cfg.window, S) if cfg.window else S
    # full-compute: the chunked impl computes every pair then masks
    full = S
    ideal_local = min(w, S / 2)       # causal+window block-skipped
    ideal_global = S / 2
    ideal = (n_local * ideal_local + n_global * ideal_global) / max(L, 1)
    return full, ideal


def cost_cell(cfg: ModelConfig, shape: ShapeSpec, mesh_sizes: dict,
              dp_used: tuple = ("data",), microbatches: int = 1,
              attn_chunk: int = 1024) -> CellCost:
    M = mesh_sizes.get("model", 1)
    Ddp = 1
    for ax in dp_used:
        Ddp *= mesh_sizes.get(ax, 1)
    n_chips = 1
    for v in mesh_sizes.values():
        n_chips *= v

    train = shape.kind == "train"
    mm = 3.0 if train else 1.0          # matmul fwd+dgrad+wgrad
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    S_q = 1 if decode else S            # query positions this step
    T = B * S_q                          # tokens computed this step
    T_loc = T / Ddp
    B_loc = B / Ddp
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cache_len = S if decode else 0

    fl = {}     # global flops by component (hlo-equivalent)
    fl_i = {}   # ideal
    by = {}     # per-chip bytes
    co = {}     # per-chip ring-weighted collective bytes

    # ---------------- projections / mlp / vocab (all matmuls) ----------
    proj = mm * 2 * T * D * Dh * (2 * Hq + 2 * Hkv) * L
    fl["proj"] = fl_i["proj"] = proj

    if decode:
        kv_len_full = kv_len_ideal = cache_len
    else:
        kv_len_full, kv_len_ideal = _attn_seq_eff(cfg, S)
    attn = mm * 4 * T * Hq * Dh * kv_len_full * L
    attn_i = mm * 4 * T * Hq * Dh * kv_len_ideal * L
    if cfg.family in ("ssm",):
        attn = attn_i = 0.0
    fl["attn"], fl_i["attn"] = attn, attn_i

    if cfg.family == "moe":
        slots = cfg.top_k * cfg.capacity_factor
        experts = mm * 6 * T * slots * D * F * L
        # blocked one-hot dispatch: per token 4*(E*C_b)*D with
        # E*C_b = slots * gb  (see models/moe.py)
        gb = min(1024, T)
        dispatch = mm * 4 * T * slots * gb * D * L
        router = mm * 2 * T * D * cfg.n_experts * L
        fl["mlp"] = fl_i["mlp"] = experts + router
        fl["moe_dispatch"] = fl_i["moe_dispatch"] = dispatch
    elif cfg.family == "ssm":
        di = cfg.ssm_expand * D
        dh_i = di // max(Hq, 1)
        mlstm = mm * (2 * T * D * 2 * di + 3 * 2 * T * di * di
                      + 2 * T * di * D) * (L / 2)
        mlstm_rec = 10 * T * di * dh_i * (L / 2) * (3 if train else 1)
        slstm = mm * (2 * T * D * 4 * di + 2 * T * di * D) * (L / 2)
        slstm_rec = 30 * T * di * (L / 2) * (3 if train else 1)
        fl["mlp"] = fl_i["mlp"] = mlstm + slstm
        fl["ssm"] = fl_i["ssm"] = mlstm_rec + slstm_rec
    else:
        mlp = mm * 6 * T * D * F * L
        fl["mlp"] = fl_i["mlp"] = mlp
        if cfg.family == "hybrid":
            di = cfg.ssm_expand * D
            n = cfg.ssm_state
            r = max(1, D // 16)
            ssm_proj = mm * (2 * T * D * 2 * di + 2 * T * di * D
                             + 2 * T * di * (2 * n + r) + 2 * T * r * di) * L
            ssm_scan = 10 * T * di * n * L * (3 if train else 1)
            fl["ssm"] = fl_i["ssm"] = ssm_proj + ssm_scan

    if cfg.family == "encdec" and not decode:
        Te = B * cfg.encoder_seq
        enc = mm * (2 * Te * D * Dh * (2 * Hq + 2 * Hkv)
                    + 4 * Te * Hq * Dh * cfg.encoder_seq
                    + 6 * Te * D * F) * cfg.n_encoder_layers
        cross = mm * (2 * T * D * D + 4 * T * D * cfg.encoder_seq
                      + 2 * Te * D * D * 2) * L
        fl["encoder"] = fl_i["encoder"] = enc
        fl["cross"] = fl_i["cross"] = cross
    elif cfg.family == "encdec" and decode:
        cross = mm * (2 * T * D * D + 4 * T * D * cfg.encoder_seq) * L
        fl["cross"] = fl_i["cross"] = cross

    fl["vocab"] = fl_i["vocab"] = mm * 2 * T * D * V

    flops_per_chip = sum(fl.values()) / n_chips
    flops_ideal_per_chip = sum(fl_i.values()) / n_chips

    # ---------------- HBM bytes per chip --------------------------------
    n_params = cfg.param_count()
    shards_opt = M * (Ddp if cfg.fsdp else 1)
    if train:
        # fwd read + bwd-recompute read + wgrad stream, per microbatch,
        # against the f32 master copy; optimizer does p/m/v read+write
        by["weights"] = 3 * F32 * (n_params / M) * microbatches
        by["optimizer"] = 28 * n_params / shards_opt
    else:
        by["weights"] = BF16 * n_params / M
    c_act = 16 * (1.7 if (train and cfg.remat) else 1.0)
    by["activations"] = c_act * T_loc * D * BF16 * L
    if not decode and cfg.family != "ssm":
        # flash/chunked kv streaming: each q block re-reads K,V
        nq = max(1, S // max(attn_chunk, 1))
        by["attn_kv"] = 2 * B_loc * nq * S * Hkv * Dh * BF16 * L \
            * (3 if train else 1)
    if decode and cfg.family != "ssm":
        # decode reads the whole (Dh-sharded) cache every step
        by["kv_cache"] = 2 * L * B_loc * cache_len * Hkv * Dh * BF16 / M
    if decode and cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm_expand * D
        n = cfg.ssm_state if cfg.family == "hybrid" else di // 4
        by["ssm_state"] = 2 * L * B_loc * di * max(n, 1) * F32 / M
    fl_bytes = sum(by.values())

    # ---------------- collective link-bytes per chip --------------------
    act_bytes = B_loc * S_q * D * BF16
    n_ar = (4 if train else 2)
    co["tp_layer"] = n_ar * act_bytes * 2 * ring(M) * L
    co["tp_vocab"] = (2 if train else 1) * act_bytes * 2 * ring(M)
    if train:
        if cfg.fsdp:
            co["fsdp"] = 3 * ring(Ddp) * F32 * n_params / M * microbatches
        else:
            co["dp_grads"] = 2 * ring(Ddp) * F32 * n_params / M
        if "pod" in mesh_sizes and "pod" not in dp_used:
            co["pod_grads"] = 2 * ring(mesh_sizes["pod"]) * F32 \
                * n_params / (M * Ddp)
    if cfg.family == "moe":
        # the reference's assumption, kept for parity of the model: the
        # all-to-all drives 4 links of its torus at once (ring
        # collectives are charged at 1 link); no figure for NVLink yet
        A2A_LINKS = 4.0
        slots = cfg.top_k * cfg.capacity_factor
        co["moe_a2a"] = (4 if train else 2) * slots * T_loc * D * BF16 \
            * ring(M) * L / A2A_LINKS

    return CellCost(
        flops_hlo_equiv=flops_per_chip,
        flops_ideal=flops_ideal_per_chip,
        hbm_bytes=fl_bytes,
        coll_link_bytes=sum(co.values()),
        breakdown={"flops": fl, "bytes": by, "coll": co},
    )
