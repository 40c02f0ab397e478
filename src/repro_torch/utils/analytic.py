"""Closed-form per-chip cost model of one (arch x shape x mesh) cell, the
reference's ``utils/analytic.py`` for the dense family.

The formulas count matmul FLOPs exactly and bytes to first order.  All
returns are PER CHIP PER STEP:

* ``flops_hlo_equiv`` counts what the program executes (every S^2
  attention pair, masked but computed, as ``attn_chunked`` does);
  ``flops_ideal`` counts the skippable-block minimum (causal 1/2,
  windows) of a block-sparse kernel.
* Train multiplies matmul FLOPs by 3 (fwd + dgrad + wgrad) and adds a
  remat recompute factor on activation bytes.

The reference's ``CellCost.terms`` defaults to a TPU chip's peak rates;
the port's takes the chip's rates from the caller, with no default.  The
other families' terms wait for their models (``configs/base.py``
``get_config`` raises for them): ``cost_cell`` raises for any family but
``dense``.
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
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the cost model of the {cfg.family!r} family is "
            "not ported yet (ROADMAP.md §1, the other LM families)")
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
    fl["attn"] = mm * 4 * T * Hq * Dh * kv_len_full * L
    fl_i["attn"] = mm * 4 * T * Hq * Dh * kv_len_ideal * L
    fl["mlp"] = fl_i["mlp"] = mm * 6 * T * D * F * L
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
    if not decode:
        # flash/chunked kv streaming: each q block re-reads K,V
        nq = max(1, S // max(attn_chunk, 1))
        by["attn_kv"] = 2 * B_loc * nq * S * Hkv * Dh * BF16 * L \
            * (3 if train else 1)
    else:
        # decode reads the whole (Dh-sharded) cache every step
        by["kv_cache"] = 2 * L * B_loc * cache_len * Hkv * Dh * BF16 / M
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

    return CellCost(
        flops_hlo_equiv=flops_per_chip,
        flops_ideal=flops_ideal_per_chip,
        hbm_bytes=fl_bytes,
        coll_link_bytes=sum(co.values()),
        breakdown={"flops": fl, "bytes": by, "coll": co},
    )
