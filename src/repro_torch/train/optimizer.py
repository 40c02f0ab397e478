"""AdamW and its learning-rate schedule as plain functions on tensor
trees (the reference's ``train/optimizer.py``).

The arithmetic is the reference's, operation for operation (global-norm
clipping, bias-corrected moments, decoupled weight decay on the float32
reference copy, bf16 parameters re-cast from the master), which
``torch.optim.AdamW`` orders differently.  Unlike the reference, which
returns new arrays, ``adamw_update`` updates the parameters and the
optimizer state in place: a second copy of Gemma-2 2B's state would not
fit beside the first on one card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.sharding import sharded_global_norm
from repro_torch.utils.tree import global_norm, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio*peak, in float32 (a
    0-d tensor on ``step``'s device; ``step`` an int or an int tensor)."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * torch.clamp(
        (step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params, master_copy: bool = False) -> dict:
    """``{"m", "v", "step"}`` (float32 zeros, an int32 0-d step), plus a
    float32 ``"master"`` copy of ``params`` when ``master_copy`` (the
    mixed-precision layout: bf16 params for compute, float32 for the
    update)."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    state = {"m": zeros,
             "v": tree_map(torch.zeros_like, zeros),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if master_copy:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, shardings=None):
    """One AdamW step.  Returns ``(params, state, metrics)``: ``params``
    and ``state`` are the arguments, updated in place; ``metrics`` holds
    ``lr`` and ``grad_norm`` (0-d float32 tensors).  ``shardings``
    ``(spec_tree, mesh)``: every tree holds this rank's blocks under the
    specs; the update is elementwise, and the clipping norm is the
    global tree's (``utils.sharding.sharded_global_norm``)."""
    step = state["step"]
    if shardings is None:
        gnorm = global_norm(grads)
    else:
        gnorm = sharded_global_norm(grads, *shardings)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.clip_norm > 0 else 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    has_master = "master" in state
    flat_p = tree_leaves(params)
    flat_ref = (tree_leaves(state["master"]) if has_master
                else [None] * len(flat_p))
    for p, g, m, v, master in zip(flat_p, tree_leaves(grads),
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"]), flat_ref):
        # float32 params without a master are their own reference copy
        ref = master if master is not None else p.float()
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square_())
        del g
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(cfg.weight_decay * ref)
        ref.sub_(upd.mul_(lr))
        del upd
        if ref is not p:
            p.copy_(ref)
    state["step"] = step + 1
    return params, state, {"lr": lr, "grad_norm": gnorm}
