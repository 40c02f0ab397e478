"""Gradient compression for the slow (on-prem <-> cloud) link, the
reference's ``train/compression.py``.

The paper's hybrid-cloud story has a slow pipe between the on-prem
cluster and the cloud; what crosses it in training is the data-parallel
gradient reduction.  Two standard compressors, both with error feedback
(the residual is re-added next step, preserving convergence):

* int8 per-tensor quantization (8x over f32, 2x over bf16 wire format)
* top-k magnitude sparsification (k as a fraction)

On one device, compress -> decompress is numerically what the wire would
carry.  On a mesh each rank compresses its blocks of the gradients, with
the scale and the threshold of each whole leaf.  Top-k keeps every element at least as large as the k-th largest
magnitude, so ties at the threshold are all kept, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import sharding as SH
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"        # int8 | topk | none
    topk_fraction: float = 0.05
    error_feedback: bool = True


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_int8(g, gmax=None):
    """``gmax``: the largest magnitude (default ``g``'s own)."""
    scale = torch.clamp(g.abs().max() if gmax is None else gmax,
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale):
    return q.float() * scale


def _topk_mask(g, frac: float, thresh=None):
    """``thresh``: the k-th largest magnitude (default ``g``'s own)."""
    if thresh is None:
        flat = g.reshape(-1).abs()
        k = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(flat, k).values[-1]
    return (g.abs() >= thresh).float()


def _sharded_maxes(gfs, mesh):
    """Each block's largest magnitude, as of its whole leaf (one MAX
    over the mesh for every leaf at once)."""
    local = torch.stack([g.abs().max() for g in gfs])
    return SH.all_reduce_mesh(local, mesh, "max").unbind(0)


def _sharded_threshold(gf, spec, mesh, frac: float):
    """The k-th largest magnitude of the whole leaf of the block ``gf``:
    each block's own top k holds every element of the leaf's top k, so
    the k-th largest of the blocks' candidates (gathered over the axes
    the leaf is split over) is the leaf's."""
    flat = gf.reshape(-1).abs()
    axes = SH.live_axes(spec, mesh)
    sizes = SH.mesh_sizes(mesh)
    k = max(1, int(flat.shape[0] * math.prod(sizes[a] for a in axes)
                   * frac))
    cands = torch.topk(flat, min(k, flat.shape[0])).values
    if axes:
        cands = SH.gather(cands, SH.P(axes), mesh)
    return torch.topk(cands, k).values[-1]


@torch.no_grad()
def compress_grads(grads, err_state, cfg: CompressionConfig, shardings=None):
    """Returns ``(wire_grads, new_err_state, stats)``.

    ``wire_grads`` are the values that would cross the slow link, already
    decompressed (the compression error is thereby applied), in the
    gradients' dtype; ``new_err_state`` holds what was lost, for the next
    step's feedback.  ``shardings`` ``(spec_tree, mesh)``: the trees hold
    this rank's blocks, and int8's scale and top-k's threshold are still
    each whole leaf's."""
    if cfg.kind == "none":
        return grads, err_state, {"compression_ratio": 1.0}
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)
    flat_g, flat_e = tree_leaves(grads), tree_leaves(err_state)
    gfs = [g.float() + e if cfg.error_feedback else g.float()
           for g, e in zip(flat_g, flat_e)]
    if shardings is None:
        thresholds = [None] * len(gfs)
    elif cfg.kind == "int8":
        thresholds = _sharded_maxes(gfs, shardings[1])
    else:
        thresholds = [_sharded_threshold(gf, sp, shardings[1],
                                         cfg.topk_fraction)
                      for gf, sp in zip(gfs, SH.tree_specs(shardings[0],
                                                           grads))]

    def one(g, gf, e, t):
        if cfg.kind == "int8":
            wire = _dequantize_int8(*_quantize_int8(gf, t))
        else:
            wire = gf * _topk_mask(gf, cfg.topk_fraction, t)
        new_e = (gf - wire) if cfg.error_feedback else e
        return wire.to(g.dtype), new_e

    out = [one(*a) for a in zip(flat_g, gfs, flat_e, thresholds)]
    wire = tree_unflatten(grads, [o[0] for o in out])
    new_err = tree_unflatten(grads, [o[1] for o in out])
    ratio = 4.0 if cfg.kind == "int8" else 1.0 / max(cfg.topk_fraction, 1e-9)
    return wire, new_err, {"compression_ratio": ratio}
