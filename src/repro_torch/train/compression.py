"""Gradient compression for the slow (on-prem <-> cloud) link, the
reference's ``train/compression.py``.

The paper's hybrid-cloud story has a slow pipe between the on-prem
cluster and the cloud; what crosses it in training is the data-parallel
gradient reduction.  Two standard compressors, both with error feedback
(the residual is re-added next step, preserving convergence):

* int8 per-tensor quantization (8x over f32, 2x over bf16 wire format)
* top-k magnitude sparsification (k as a fraction)

On one device, compress -> decompress is numerically what the wire would
carry.  Top-k keeps every element at least as large as the k-th largest
magnitude, so ties at the threshold are all kept, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"        # int8 | topk | none
    topk_fraction: float = 0.05
    error_feedback: bool = True


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_int8(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale):
    return q.float() * scale


def _topk_mask(g, frac: float):
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (g.abs() >= thresh).float()


@torch.no_grad()
def compress_grads(grads, err_state, cfg: CompressionConfig):
    """Returns ``(wire_grads, new_err_state, stats)``.

    ``wire_grads`` are the values that would cross the slow link, already
    decompressed (the compression error is thereby applied), in the
    gradients' dtype; ``new_err_state`` holds what was lost, for the next
    step's feedback."""
    if cfg.kind == "none":
        return grads, err_state, {"compression_ratio": 1.0}

    def one(g, e):
        gf = g.float()
        if cfg.error_feedback:
            gf = gf + e
        if cfg.kind == "int8":
            wire = _dequantize_int8(*_quantize_int8(gf))
        elif cfg.kind == "topk":
            wire = gf * _topk_mask(gf, cfg.topk_fraction)
        else:
            raise ValueError(cfg.kind)
        new_e = (gf - wire) if cfg.error_feedback else e
        return wire.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(err_state))]
    wire = tree_unflatten(grads, [o[0] for o in out])
    new_err = tree_unflatten(grads, [o[1] for o in out])
    ratio = 4.0 if cfg.kind == "int8" else 1.0 / max(cfg.topk_fraction, 1e-9)
    return wire, new_err, {"compression_ratio": ratio}
