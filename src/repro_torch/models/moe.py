"""Mixture-of-Experts LM (OLMoE, DBRX), the reference's ``models/moe.py``:
capacity-based top-k routing, a Switch load-balance loss, tokens in
blocks of about ``block_tokens``.

Routing is the reference's, decision for decision: the router's product
in the compute dtype, its softmax in float32, the top ``k`` experts with
the lower expert index first among equal probabilities (a stable
descending sort; ``torch.topk`` promises no order on ties), and each
(token, choice) pair's slot in its expert's capacity counted over the
flat ``[G * k, E]`` one-hot, token-major then choice, so the same pairs
overflow the capacity and pass through the residual.

Dispatch form: the reference builds ``[G, E, C]`` one-hot tensors and
runs ``gec,gd->ecd``; each slot holds one token, so here each kept pair's
row is copied into its slot of an ``[E, C, D]`` buffer (the same bits),
the experts run as three batched matrix products over the expert axis,
and each token gathers its ``k`` rows back, weighted by its gate values
rounded to the compute dtype (the reference's ``comb``) and summed in
float32: the reference's ``gec,ecd->gd`` within rounding (the ``k``
terms are added in another order).  An expert takes at most one choice
of a token, so the buffer holds ``min(C, G)`` slots: slots past ``G``
stay empty in the reference too.  ``utils/analytic.py`` still counts the
reference's one-hot einsums (``moe_dispatch``).

On a device mesh a block spans the rows of every batch rank, as the
reference's global block does under GSPMD: its capacity is the global
block's, each rank's slots follow the expert counts of the ranks before
it, and the Switch fractions are summed over the ranks
(``moe_apply_block``'s ``group``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM, cross_entropy, remat_loop
from repro_torch.utils.sharding import P


def _capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(top_k * tokens * factor / n_experts))
    return max(8, ((c + 7) // 8) * 8)   # pad to a multiple of 8


def _top_k(probs, k: int):
    """The ``k`` largest of each row, the lower index first among equal
    values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xt, cfg, capacity: int):
    """The router of one token block ``xt`` [G, D]: ``(probs [G, E]
    float32, gate_vals [G, k] float32 (normalised), gate_idx [G, k],
    onehot [G, k, E] int32, pos [G, k] (each pair's slot in its
    expert), keep [G, k] (pos < capacity))``."""
    g = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"].to(xt.dtype)).float()             # [G,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                       # [G,k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(gate_idx, e).to(torch.int32)              # [G,k,E]
    flat = onehot.reshape(g * k, e)
    before = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat)
    pos = (before.reshape(g, k, e) * onehot).sum(dim=-1)         # [G,k]
    return probs, gate_vals, gate_idx, onehot, pos, pos < capacity


def moe_apply_block(p, xt, cfg, capacity: int, group=None):
    """One token block.  xt [G, D] -> (y [G, D], aux_loss scalar).

    ``group`` (a ``utils.sharding.BatchGroup``, on a mesh): ``xt`` is
    this rank's segment of a block that spans every batch rank's rows, in
    row order.  The routing stays the block's: each pair's slot counts
    the pairs of the ranks before this one (an exclusive prefix of their
    expert counts), so the same pairs overflow ``capacity`` (the global
    block's); the Switch loss's fractions are over the whole block, and
    the rank returns its share of it: ``1 / size`` of its value, and the
    gradient of the router probabilities of its own tokens, so the
    shares' values and gradients sum to the block's."""
    g, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xt.dtype
    probs, gate_vals, gate_idx, onehot, pos, keep = route(p, xt, cfg,
                                                          capacity)
    counts = onehot.sum(dim=(0, 1))                              # [E]
    if group is not None:
        every = group.gather(counts)                             # [R, E]
        keep = (pos + every[:group.index].sum(dim=0)[gate_idx]) < capacity
        counts = every.sum(dim=0)
    c = min(capacity, g)
    dump = e * c                        # the row a dropped pair writes to
    slot = torch.where(keep, gate_idx * c + pos, dump).reshape(-1)  # [G*k]
    tok = torch.arange(g, device=xt.device).repeat_interleave(k)

    if getattr(cfg, "moe_wire_int8", False):
        # the reference's int8 wire: tokens quantised per row before the
        # dispatch, their scales carried beside them
        scale = torch.clamp(xt.abs().amax(dim=-1, keepdim=True) / 127.0,
                            min=1e-8)
        xt_q = torch.clamp(torch.round(xt / scale), -127, 127).to(torch.int8)
        q_in = xt_q.new_zeros(dump + 1, d).index_put_((slot,), xt_q[tok])
        s_in = scale.new_zeros(dump + 1).index_put_((slot,), scale[tok, 0])
        expert_in = (q_in[:dump].float()
                     * s_in[:dump, None].float()).to(dt)
    else:
        expert_in = xt.new_zeros(dump + 1, d).index_put_((slot,), xt[tok])
        expert_in = expert_in[:dump]
    expert_in = expert_in.reshape(e, c, d)                       # [E,C,D]
    gate_w = F.silu(torch.bmm(expert_in, p["w_gate"].to(dt)))
    up = torch.bmm(expert_in, p["w_up"].to(dt))
    expert_out = torch.bmm(gate_w * up, p["w_down"].to(dt))      # [E,C,D]

    comb = torch.where(keep, gate_vals.to(dt).float(), 0.0)      # [G,k]
    rows = expert_out.reshape(e * c, d).index_select(
        0, torch.where(keep.reshape(-1), slot, 0))
    y = (rows.float().reshape(g, k, d) * comb[..., None]).sum(dim=1).to(dt)

    # Switch load-balance loss: E * sum_e f_e * p_e
    if group is None:
        frac_tokens = onehot.sum(dim=1).float().mean(dim=0)
        frac_probs = probs.mean(dim=0)
        return y, e * torch.sum(frac_tokens / k * frac_probs)
    n = g * group.size
    mine = probs.sum(dim=0)
    every = group.sum(mine.detach())
    # the block's value; a gradient through this rank's tokens only
    frac_probs = (every - mine.detach() + mine) / n
    aux = e * torch.sum(counts.float() / n / k * frac_probs)
    return y, aux.detach() / group.size + (aux - aux.detach())


def moe_apply(p, x, cfg, block_tokens: int = 1024, group=None):
    """x [B, S, D] -> (y, aux).  Tokens run in blocks of about
    ``block_tokens`` (``S / nb`` positions of every row; one block of the
    whole sequence when S does not divide), the capacity per block, as
    in the reference.  The expert weights are cast to the compute dtype
    once for all blocks.  On a mesh (``group``) ``x`` holds this rank's
    rows and each block spans every rank's rows: its size and capacity
    are the global batch's (``moe_apply_block``)."""
    b, s, d = x.shape
    b_all = b * (1 if group is None else group.size)
    g = b * s
    p = {name: w.to(x.dtype) for name, w in p.items()}
    sb = max(1, min(s, block_tokens // max(b_all, 1)))
    nb = s // sb if s % sb == 0 else 1
    if nb <= 1:
        cap = _capacity(b_all * s, cfg.n_experts, cfg.top_k,
                        cfg.capacity_factor)
        y, aux = moe_apply_block(p, x.reshape(g, d), cfg, cap, group)
        return y.reshape(b, s, d), aux
    cap = _capacity(b_all * sb, cfg.n_experts, cfg.top_k,
                    cfg.capacity_factor)
    xb = x.reshape(b, nb, sb, d).transpose(0, 1).reshape(nb, b * sb, d)
    ys = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nb):
        y, a = moe_apply_block(p, xb[i], cfg, cap, group)
        ys.append(y)
        aux = aux + a
    y = torch.stack(ys).reshape(nb, b, sb, d).transpose(0, 1)
    return y.reshape(b, s, d), aux / nb


class MoELM(DenseLM):
    family = "moe"

    @staticmethod
    def _init_layers(cfg, device, generator) -> dict:
        n, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
        return {
            "ln1": torch.zeros((n, d), device=device),
            "ln2": torch.zeros((n, d), device=device),
            "attn": L.init_attn(cfg, n, device, generator),
            "mlp": {
                "router": L._normal((n, d, e), d ** -0.5, device, generator),
                "w_gate": L._normal((n, e, d, f), d ** -0.5, device,
                                    generator),
                "w_up": L._normal((n, e, d, f), d ** -0.5, device,
                                  generator),
                "w_down": L._normal((n, e, f, d),
                                    (f ** -0.5) / max(n, 1) ** 0.5, device,
                                    generator),
            },
        }

    def _ffn(self, p_l, h, pos):
        return moe_apply(p_l["mlp"], h, self.cfg, group=self._batch_group())

    def loss(self, batch, vocab_chunk: int = 8, params=None):
        """Cross-entropy plus ``router_aux_coef`` times the layers' mean
        Switch loss: ``(loss, {"loss", "ce", "aux", "tokens"})``; on a
        mesh this rank's shares (``DenseLM.loss``)."""
        cfg = self.cfg
        p = self._top(self.params if params is None else params)
        batch, n_tokens = self._mesh_loss_args(batch)
        x, qpos = self._embed_inputs(p, batch)
        x, qpos, seq = self._seq_entry(x, qpos)

        def block(p_l, w, carry):
            x, aux = carry
            x, _, a = self._block_train(self._slice(p_l), w, x, qpos)
            return x, aux + a
        x, aux = remat_loop(
            [(block, (p_l, w)) for p_l, w in zip(self._slices(p),
                                                 self.windows)],
            (x, torch.zeros((), dtype=torch.float32, device=self.device)),
            cfg.remat and torch.is_grad_enabled(), seq)
        ce, cnt = cross_entropy(self._head(p), self._loss_hidden(x),
                                self._labels(batch), cfg, vocab_chunk,
                                n_tokens)
        aux_mean = aux / cfg.n_layers
        if self._seq_split() is not None:
            # every rank along the sequence axes computed the layers'
            # whole aux: its share is 1 / size of it
            aux_mean = aux_mean / self._seq_split().size
        loss = ce + cfg.router_aux_coef * aux_mean
        return loss, {"loss": loss, "ce": ce, "aux": aux_mean, "tokens": cnt}

    # ------------------------------------------------------- shardings
    def _mlp_spec(self, fs) -> dict:
        return {"router": P(None, None, None),
                "w_gate": P(None, "model", fs, None),
                "w_up": P(None, "model", fs, None),
                "w_down": P(None, "model", None, fs)}

    def _layer_spec(self, fs) -> dict:
        s = super()._layer_spec(fs)
        s["mlp"] = self._mlp_spec(fs)
        s.pop("ln1_post", None)
        s.pop("ln2_post", None)
        return s

    def param_spec(self) -> dict:
        spec = super().param_spec()
        if self.strip_tp:
            # strip_tp removes attention TP, but expert parallelism stays
            # on the model axis (the experts are the point of the axis)
            spec["layers"]["mlp"] = self._mlp_spec(self._fsdp_ax())
        return spec
