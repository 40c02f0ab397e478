"""Train step factory: loss -> grads -> (compress) -> AdamW, with
microbatch gradient accumulation (the reference's
``train/train_step.py``).

The step is ``(train_state, batch) -> (train_state, metrics)``.  It
updates the state's tensors in place and returns the same state: one
copy of Gemma-2 2B's state (bf16 params, float32 master, m and v) is
36.6 GB, and a second would not fit beside it on one card.  On a device
mesh (a model placed by ``to_mesh``) it is the ZeRO-3 data-parallel step
of ``make_train_step``'s docstring, the state sharded by ``state_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.transformer import _as_parameters, _tensors
from repro_torch.train.compression import (
    CompressionConfig, compress_grads, init_error_state)
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.utils import sharding as SH
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: dict
    err: Optional[dict] = None    # compression error feedback


def init_train_state(model, generator: Optional[torch.Generator] = None,
                     compression: Optional[CompressionConfig] = None):
    """The reference's layout: under a bf16 config, bf16 params plus a
    float32 ``master`` in ``opt``; under float32, float32 params.

    The float32 values are drawn from ``generator`` (the reference's
    ``model.init(key)``) or, without one, copied from the model's
    parameters.  The model is then rebound to ``state.params`` (the same
    tensors): it runs directly on them, and its own float32 tree is
    released, so the float32 copy lives only as the optimizer's master.
    The state lives on the model's device; on a mesh it holds this
    rank's blocks, as ``state_spec`` lays them out."""
    if generator is not None:
        params = model.init(generator)
    else:
        params = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                          _tensors(model.params))
    if model.cfg.dtype == "bfloat16":
        opt = init_opt_state(params, master_copy=True)   # float32 master
        params = tree_map(lambda p: p.to(torch.bfloat16), params)
    else:
        opt = init_opt_state(params)
    err = (init_error_state(params)
           if compression and compression.kind != "none" else None)
    model.params = _as_parameters(params)
    return TrainState(params, opt, err)


def _drain(t, buf):
    """Add a leaf's gradient into its buffer (a float32 sum of bf16
    gradients rounds as the reference's tree add does) and free it."""
    buf.add_(t.grad)
    t.grad = None


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    compression: Optional[CompressionConfig] = None,
                    dp_spec=None, grad_spec=None):
    """``train_step(state, batch)``: ``batch`` holds ``tokens`` and
    ``labels`` ([B, S] int tensors) and whatever else the model's loss
    reads (``audio_embeds``, ``patch_embeds``).  With ``microbatches >
    1`` the leading axis is split into that many equal parts, their
    gradients are summed in float32 and averaged, and ``metrics`` holds
    the mean ``loss`` only (as in the reference).

    ``dp_spec`` / ``grad_spec`` are the reference's mesh arguments, and
    act only on a model placed on a mesh (``model.to_mesh``; without one
    they change nothing, as in the reference without a mesh).  There the
    step runs SPMD, every rank on the same global batch, the state held
    as ``state_spec`` says (each rank its blocks):

    * ``dp_spec`` (a mesh axis or a tuple of axes) splits the batch's
      rows: microbatch i is rows ``[i b/m, (i+1) b/m)`` of the batch,
      split over those axes (the reference's ``P(None, dp_spec)``).
      Ranks that differ along other axes compute the same rows.  The
      loss divides by the global count of valid tokens, so the ranks'
      gradients and metrics sum to the global batch's.
    * A layer's weights are gathered for its compute (and again by a
      recomputing backward); each gradient comes back summed over the
      ``dp_spec`` ranks down to its block under ``grad_spec`` (a
      reduce-scatter) or, without one, whole on every rank (an
      all-reduce: plain data parallelism), then cut to the state's
      block.
    * Clipping, compression and AdamW run on the blocks, with the
      global tree's norm, int8 scales and top-k thresholds.
    * Under the model's ``act_spec`` each rank's loss covers its chunk
      of the sequence, and gradients and metrics are also summed over
      the axes that split it (``DenseLM._grad_axes``).
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, not {microbatches}")
    mesh = model.mesh
    if mesh is not None:
        model.batch_axes = SH.axes_of(dp_spec)
        model.grad_layout = (SH.replicated(model.layout) if grad_spec is None
                             else grad_spec)
        SH.tree_specs(model.grad_layout, model.layout)   # names must match
    shardings = None if mesh is None else (model.layout, mesh)

    def add_grads(params, batch, bufs):
        """Run the loss and add its gradients into ``bufs`` (a tree like
        ``params``); returns ``(loss, metrics)``."""
        pairs = []

        def leaf(p, buf):
            t = p.detach().requires_grad_()
            pairs.append((t, buf))
            return t
        # every stacked group the model names (``model.STACKS``: the
        # layers, an encoder's layers, cross attention, xLSTM's pairs) is
        # split by its own leading size, and each slice of a stacked
        # tensor is its own leaf, so its gradient goes straight into its
        # slice of the buffer (no full-size [L, ...] gradient per slice,
        # no stack of them); the other entries are leaves as they are
        tree = {}
        for k, v in params.items():
            if k in model.STACKS:
                n = tree_leaves(v)[0].shape[0]
                tree[k] = [tree_map(lambda p, buf, i=i: leaf(p[i], buf[i]),
                                    v, bufs[k]) for i in range(n)]
            else:
                tree[k] = tree_map(leaf, v, bufs[k])
        for t, buf in pairs:
            t.register_post_accumulate_grad_hook(
                lambda t, buf=buf: _drain(t, buf))
        loss, metrics = model.loss(batch, params=tree)
        loss.backward()
        return loss.detach(), metrics

    def accumulate(params, batch):
        """Gradients in the params' dtype at microbatches=1; else summed
        over the microbatches in float32 and averaged (the reference's
        arithmetic)."""
        if microbatches <= 1:
            grads = tree_map(torch.zeros_like, params)
            loss, metrics = add_grads(params, batch, grads)
            return loss, metrics, grads
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{microbatches} microbatches")
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for i in range(microbatches):
            mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
            loss, _ = add_grads(params, mb, grads)
            loss_sum = loss_sum + loss
        for acc in tree_leaves(grads):
            acc.div_(microbatches)
        loss = loss_sum / microbatches
        return loss, {"loss": loss}, grads

    def train_step(state: TrainState, batch):
        loss, metrics, grads = accumulate(state.params, batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        group = None if mesh is None else model._loss_group()
        if group is not None:
            # the ranks' shares of the loss and metrics sum to the batch's
            metrics = {k: group.sum(v) for k, v in metrics.items()}
        err = state.err
        if compression and compression.kind != "none":
            grads, err, cstats = compress_grads(grads, err, compression,
                                                shardings)
            metrics = {**metrics, **cstats}
        params, opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, opt_cfg, shardings)
        return TrainState(params, opt, err), {**metrics, **opt_metrics}

    return train_step


def state_spec(model, compression: Optional[CompressionConfig] = None):
    """The reference's ``PartitionSpec`` tree of a train state: params,
    the moments, the float32 master (bf16 configs) and the error
    feedback (compression) all by ``param_spec``, the step replicated."""
    pspec = model.param_spec()
    err = pspec if (compression and compression.kind != "none") else None
    opt = {"m": pspec, "v": pspec, "step": SH.P()}
    if model.cfg.dtype == "bfloat16":
        opt["master"] = pspec
    return TrainState(params=pspec, opt=opt, err=err)
