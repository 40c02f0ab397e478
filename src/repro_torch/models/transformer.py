"""Dense decoder-only LM (llama / mistral / gemma2 family), the
reference's ``models/transformer.py``, and the model API every family of
the port implements:

    DenseLM(cfg, device, generator)            parameters at the reference's
                                               shapes and scales
    init(generator) -> params                  a fresh float32 tree
    forward(batch) -> logits                   teacher-forced, all positions
    loss(batch, vocab_chunk, params) -> (loss, metrics)
                                               chunked next-token CE, with
                                               autograd (the training path)
    init_cache(batch, cache_len) -> cache
    prefill(batch, cache_len) -> (last_logits, cache)
    decode_step(tokens, cache, index) -> (logits, cache)

The other families subclass it and override its hooks, as the
reference's do: ``_init_layers``, ``_embed_inputs`` / ``_embed_token``,
``_mixer_train`` / ``_mixer_decode`` (the token mixer: attention here),
``_ffn`` (the MLP, with a MoE router's auxiliary loss beside it),
``_block_train`` / ``_block_decode`` (a whole layer), ``_hidden`` (the
final hidden states that get logits), ``init_cache`` / ``_fill_cache``.
``STACKS`` names the class's stacked groups, and
``cls.params_from_numpy(cfg, tree)`` carries the reference's
``model.init`` pytree (as numpy arrays) over, so both packages run the
same weights.  Layers run in a Python loop, each with its window as an
int; under ``cfg.remat`` the training path checkpoints each layer, as the
reference does.  ``forward``, ``prefill`` and ``decode_step`` compute no
gradients.

Shardings, as the reference writes them: ``param_spec()``,
``cache_spec(multi_pod)`` and ``input_specs(shape, multi_pod)`` give
``utils.sharding.P`` trees equal to the reference's, under the same
hooks (``fsdp_axes``, ``strip_tp``, ``act_spec``, ``ring_mesh``,
``ring_batch_axes``).  ``to_mesh(mesh)`` runs the model SPMD on a
``torch.distributed`` ``DeviceMesh`` (one process a rank): each rank
keeps its block of every parameter (``param_spec``) and of the cache
(``cache_spec``), and computes the rows of the batch that its batch axes
give it (``batch_axes``, the mesh's ``("pod", "data")``); a layer's
weights are gathered for its compute and freed after it (ZeRO-3), the
embedding and head once a call.  Ranks that differ only along ``model``
compute the same rows.  ``forward``, ``prefill`` and ``decode_step`` take
and return the global batch; ``loss`` returns this rank's share (the
shares of the batch ranks sum to the global loss and metrics).  The
result is the meshless one, up to the order of float sums.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.utils import sharding as SH
from repro_torch.utils.sharding import P
from repro_torch.utils.tree import tree_map

DP = ("pod", "data")   # the canonical data-parallel mesh axes (pod may be absent)


def dp_axes(multi_pod: bool = True):
    return DP if multi_pod else ("data",)


def _as_parameters(tree) -> nn.ParameterDict:
    """Nested dict of tensors -> nested ``ParameterDict`` of trainable
    parameters sharing the tensors' storage."""
    return nn.ParameterDict({
        k: _as_parameters(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()})


def _shapes(tree) -> dict:
    return {k: _shapes(v) if isinstance(v, (dict, nn.ParameterDict))
            else tuple(v.shape) for k, v in tree.items()}


def _check_tree(cls, cfg: ModelConfig, params, who: str) -> None:
    """Raise ``ValueError`` unless ``params`` has the keys and shapes of
    ``cfg``'s parameter tree under the model class ``cls``."""
    want = _shapes(cls.init_params(cfg, "meta"))
    if _shapes(params) != want:
        raise ValueError(f"{who}: the tree does not fit {cfg.name}: "
                         f"{_shapes(params)} != {want}")


def unstack(group) -> list[dict]:
    """A stacked group of the tree (nested dicts of tensors sharing one
    leading size: the layers, an encoder's layers, xLSTM's pairs) as the
    list of its slices, views into the stacked tensors."""
    if isinstance(group, (dict, nn.ParameterDict)):
        parts = {k: unstack(v) for k, v in group.items()}
        sizes = {len(v) for v in parts.values()}
        if len(sizes) != 1:
            raise ValueError(f"unstack: leading sizes differ: {sizes}")
        return [{k: v[i] for k, v in parts.items()}
                for i in range(sizes.pop())]
    return list(group.unbind(0))


def cross_entropy(head, x, targets, cfg, vocab_chunk: int = 8,
                  n_tokens=None):
    """Next-token cross-entropy of hidden states ``x`` [B, S, D] against
    ``targets`` [B, S] (-1 = masked): ``(mean over valid tokens (float32),
    their count (int32))``.  ``n_tokens`` (on a mesh: the global batch's
    count) divides the sum in place of the count of ``targets``.  As in the reference, the sequence is cut into
    ``vocab_chunk`` chunks (one when S does not divide) and each chunk's
    float32 logits are computed inside a checkpoint, so only one chunk's
    ``[B, S / vocab_chunk, V]`` logits are ever live.  ``head`` holds the
    unembedding's parameters."""
    s = targets.shape[1]
    nc = vocab_chunk if s % vocab_chunk == 0 else 1
    n = s // nc

    def chunk_loss(head, xx, tt):
        logits = L.unembed(head, xx, cfg)                 # [b, n, V] f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            tt.clamp(min=0).long()[..., None])[..., 0]
        valid = tt >= 0
        ce = torch.where(valid, logz - gold, 0.0)
        return ce.sum(), valid.sum(dtype=torch.int32)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for j in range(nc):
        ce, valid = checkpoint(chunk_loss, head, x[:, j * n:(j + 1) * n],
                               targets[:, j * n:(j + 1) * n],
                               use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + ce, cnt + valid
    return tot / torch.clamp(cnt if n_tokens is None else n_tokens,
                             min=1), cnt


def remat_loop(blocks, x, remat: bool):
    """Run ``x`` through ``blocks``, each a pair ``(fn, args)`` applied as
    ``x = fn(*args, x)``; under ``remat`` each block is checkpointed (only
    its inputs are kept: the reference's ``nothing_saveable``)."""
    for fn, args in blocks:
        x = (checkpoint(fn, *args, x, use_reentrant=False,
                        preserve_rng_state=False)
             if remat else fn(*args, x))
    return x


class DenseLM(nn.Module):
    """The dense LM on one device.

    ``params``: a tree from ``params_from_numpy`` (or a train state's
    params); without it the parameters are drawn from ``generator``
    (default: seed 0 on the device).  The model's parameters share the
    tree's tensors.  ``use_kernels=False`` runs the flash kernel's plain
    version wherever the model lives (parity runs on the card)."""

    family = "dense"
    # the stacked groups of the tree: nested dicts of tensors sharing one
    # leading size, which the train step splits into per-slice leaves
    STACKS = ("layers",)

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[dict] = None, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.windows = L.layer_windows(cfg)
        self.dtype = getattr(torch, cfg.dtype)
        self.use_kernels = use_kernels
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = self.init_params(cfg, self.device, generator)
        _check_tree(type(self), cfg, params, type(self).__name__)
        self.params = _as_parameters(params)
        # the reference's mesh hooks, with its defaults (a launcher sets
        # them): the FSDP axes of ``param_spec`` when ``cfg.fsdp``;
        # ``strip_tp`` takes "model" out of the param specs (MoE keeps
        # its experts on it); ``act_spec`` (sequence parallelism of the
        # residual stream) is not ported and raises on a mesh;
        # ``ring_mesh`` turns ``attn_impl="ring"`` on, its sequence split
        # over "model", its rows over ``ring_batch_axes``
        self.act_spec = None
        self.fsdp_axes = ("data",)
        self.strip_tp = False
        self.ring_mesh = None
        self.ring_batch_axes = ("data",)
        # the port's mesh state (``to_mesh``): the mesh, the axes that
        # split a batch's rows, the spec tree the parameters are stored
        # by, and (set by ``make_train_step``) the one gradients are
        # reduced to
        self.mesh = None
        self.batch_axes = ()
        self.layout = None
        self.grad_layout = None
        self._slice_specs = {}           # group -> its slice's specs
        self._cache_spec_memo = None

    @classmethod
    def init_params(cls, cfg: ModelConfig, device, generator=None) -> dict:
        """float32 parameters at the reference's shapes and scales
        (``layers.py`` ``init_*`` and the class's ``_init_layers``)."""
        params = L.init_embed(cfg, device, generator)
        params["layers"] = cls._init_layers(cfg, device, generator)
        return params

    @classmethod
    def params_from_numpy(cls, cfg: ModelConfig, tree, device=None) -> dict:
        """The reference's ``model.init`` pytree of ``cfg``, its leaves as
        numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), as
        the port's float32 parameter tree on ``device``: same keys, same
        ``x @ w`` layout (``wq`` is ``[L, d_model, q_dim]``), same stacked
        leading axes.  Raises ``ValueError`` when a key or a shape differs
        from ``cfg``'s."""
        dev = resolve_device(device)

        def conv(t):
            if isinstance(t, dict):
                return {k: conv(v) for k, v in t.items()}
            return torch.from_numpy(np.array(t, dtype=np.float32)).to(dev)

        params = conv(tree)
        _check_tree(cls, cfg, params, "params_from_numpy")
        return params

    @staticmethod
    def _init_layers(cfg: ModelConfig, device, generator) -> dict:
        n = cfg.n_layers
        layers = {
            "ln1": torch.zeros((n, cfg.d_model), device=device),
            "ln2": torch.zeros((n, cfg.d_model), device=device),
            "attn": L.init_attn(cfg, n, device, generator),
            "mlp": L.init_mlp(cfg, n, device, generator),
        }
        if cfg.post_norms:
            layers["ln1_post"] = torch.zeros((n, cfg.d_model), device=device)
            layers["ln2_post"] = torch.zeros((n, cfg.d_model), device=device)
        return layers

    def init(self, generator: torch.Generator) -> dict:
        """A fresh float32 parameter tree on the model's device, drawn from
        ``generator`` (the reference's ``init(key)``); on a mesh, this
        rank's blocks of it."""
        params = self.init_params(self.cfg, self.device, generator)
        if self.mesh is not None:
            params = SH.place(params, self.layout, self.mesh)
        return params

    # ------------------------------------------------------------- mesh
    def to_mesh(self, mesh):
        """Run SPMD on ``mesh`` (a ``DeviceMesh`` of ``launch/mesh.py``):
        each rank keeps its block of every parameter by ``param_spec()``
        (read now: set the hooks first) and computes the rows that the
        mesh's ``("pod", "data")`` axes give it (``make_train_step``'s
        ``dp_spec`` sets others).  Returns the model."""
        if self.mesh is not None:
            raise ValueError("to_mesh: the model is on a mesh already")
        self.layout = self.param_spec()
        params = SH.place(_tensors(self.params), self.layout, mesh)
        self.params = _as_parameters(params)
        self.mesh = mesh
        self.batch_axes = tuple(a for a in DP if a in mesh.mesh_dim_names)
        return self

    def _check_mesh_hooks(self):
        if self.mesh is not None and self.act_spec is not None:
            raise NotImplementedError(
                "act_spec (sequence parallelism of the residual stream) is "
                "not ported; ROADMAP.md §1 item 1")

    def _batch_group(self):
        """The ranks that split the batch's rows (None off a mesh or
        where one rank holds them all)."""
        if self.mesh is None:
            return None
        g = SH.BatchGroup(self.mesh, self.batch_axes)
        return g if g.size > 1 else None

    def _rows(self, batch):
        """This rank's rows of a global batch (a dict or a tensor)."""
        g = self._batch_group()
        if g is None:
            return batch
        if isinstance(batch, dict):
            return {k: g.rows(v) for k, v in batch.items()}
        return g.rows(batch)

    def _all_rows(self, x):
        g = self._batch_group()
        return x if g is None else g.gather_rows(x)

    def _gathered(self, tree, spec, grad_spec):
        """A tree of this rank's blocks (``spec``) gathered for compute;
        under autograd each gradient comes back reduced over the batch
        axes to ``grad_spec``."""
        if isinstance(tree, dict):
            return {k: self._gathered(v, spec[k], grad_spec[k])
                    for k, v in tree.items()}
        return SH.gather_for_compute(tree, spec, self.mesh, self.batch_axes,
                                     grad_spec)

    def _slice_spec(self, layout, group: str) -> dict:
        """The spec tree of one slice of the stacked ``group`` (its
        leading entry dropped)."""
        return tree_map(lambda sp: P(*tuple(sp)[1:]), layout[group])

    def _slice(self, p_l, group: str = "layers") -> dict:
        """One slice of a stacked group, gathered for its compute (the
        slice's specs kept while the layouts stay the same objects)."""
        if self.mesh is None:
            return p_l
        grads = self.grad_layout or self.layout
        hit = self._slice_specs.get(group)
        if hit is None or hit[0] is not self.layout or hit[1] is not grads:
            hit = (self.layout, grads, self._slice_spec(self.layout, group),
                   self._slice_spec(grads, group))
            self._slice_specs[group] = hit
        return self._gathered(p_l, hit[2], hit[3])

    def _top(self, params) -> dict:
        """``params`` with every entry outside the stacked groups (the
        embedding, the head, the final norms) gathered for compute."""
        self._check_mesh_hooks()
        if self.mesh is None:
            return params
        out = dict(params.items())
        grads = self.grad_layout or self.layout
        for k in out:
            if k not in self.STACKS:
                out[k] = self._gathered(out[k], self.layout[k], grads[k])
        return out

    def _cache_specs(self) -> dict:
        """Per cache entry, the spec of one layer's block with the batch
        entry dropped (the rank's rows are its own)."""
        memo = self._cache_spec_memo
        if memo is not None and memo[0] == self.batch_axes:
            return memo[1]
        specs = self.cache_spec(multi_pod="pod" in self.mesh.mesh_dim_names)
        out = {}
        for k, sp in specs.items():
            sp = tuple(sp)
            if SH.names(sp[1]) != self.batch_axes:
                raise ValueError(
                    f"cache_spec's batch entry {sp[1]!r} of {k!r} differs "
                    f"from the model's batch axes {self.batch_axes}")
            out[k] = P(None, *sp[2:])
        self._cache_spec_memo = (self.batch_axes, out)
        return out

    def _cache_layer(self, cache, i: int) -> dict:
        """Layer ``i`` of ``cache`` whole along every axis but the batch
        axes (views where nothing is gathered)."""
        if self.mesh is None:
            return {k: v[i] for k, v in cache.items()}
        specs = self._cache_specs()
        return {k: SH.gather(v[i], specs[k], self.mesh)
                for k, v in cache.items()}

    def _cache_store(self, cache, i: int, layer: dict) -> None:
        """Write back this rank's blocks of a gathered ``_cache_layer``."""
        if self.mesh is None:
            return
        for k, sp in self._cache_specs().items():
            if layer[k].data_ptr() != cache[k][i].data_ptr():
                cache[k][i].copy_(SH.shard_of(layer[k], sp, self.mesh))

    def _mesh_cache(self, cache) -> dict:
        """A cache of this rank's rows as this rank's blocks."""
        if self.mesh is None:
            return cache
        specs = self._cache_specs()
        return {k: SH.shard_of(v, P(None, *specs[k]), self.mesh).clone()
                for k, v in cache.items()}

    # ------------------------------------------------------------ block
    @staticmethod
    def _slices(params, group: str = "layers") -> list[dict]:
        """Each slice's parameters of a stacked group (views, split by
        the group's own leading size).  ``params[group]`` may also be the
        list of per-slice dicts itself (the train step passes each slice
        as leaves of their own)."""
        if isinstance(params[group], (list, tuple)):
            return list(params[group])
        return unstack(params[group])

    def _mixer_train(self, p_l, window: int, h, qpos):
        """The token mixer over a whole sequence: ``(out, state)``, the
        state what ``_fill_cache`` stores (here the roped k and v).
        ``cfg.prefix_len`` opens a VLM's bidirectional image prefix (0
        in every other family)."""
        cfg = self.cfg
        q, k, v = L.qkv_proj(p_l["attn"], h, cfg)
        q = L.rope(q, qpos, cfg.rope_theta)
        k = L.rope(k, qpos, cfg.rope_theta)
        if cfg.attn_impl == "ring" and self.ring_mesh is not None:
            # the reference's context parallelism: the sequence split
            # over the ring's "model" axis (these rows are the rank's)
            if cfg.window != 0 or cfg.prefix_len:
                raise ValueError("ring attention needs window 0 and no "
                                 "prefix-LM zone")
            o = L.attn_ring(q, k, v, mesh=self.ring_mesh,
                            batch_axes=self.ring_batch_axes, causal=True,
                            softcap=cfg.attn_logit_softcap,
                            chunk_k=min(cfg.attn_chunk, 512))
        else:
            o = L.attention_output(q, k, v, qpos, qpos, cfg.attn_impl,
                                   causal=True, window=window,
                                   softcap=cfg.attn_logit_softcap,
                                   chunk=cfg.attn_chunk,
                                   prefix=cfg.prefix_len,
                                   use_kernels=self.use_kernels)
        return L.out_proj(p_l["attn"], o, h.dtype), (k, v)

    def _mixer_decode(self, p_l, window: int, h, c, index: int, pos):
        """The token mixer for one new token at ``index`` (``pos`` the
        same as a [1] tensor), reading and updating this layer's cache
        ``c`` (views) in place."""
        cfg = self.cfg
        q, k1, v1 = L.qkv_proj(p_l["attn"], h, cfg)
        q = L.rope(q, pos, cfg.rope_theta)
        k1 = L.rope(k1, pos, cfg.rope_theta)
        c["k"][:, index] = k1[:, 0].to(c["k"].dtype)
        c["v"][:, index] = v1[:, 0].to(c["v"].dtype)
        o = L.attn_decode(q, c["k"], c["v"], index, causal=True,
                          window=window, softcap=cfg.attn_logit_softcap)
        return L.out_proj(p_l["attn"], o, h.dtype)

    def _ffn(self, p_l, h, pos):
        """The MLP: ``(out, aux)``, ``aux`` the layer's auxiliary loss
        (a MoE router's; None here)."""
        return L.mlp_apply(p_l["mlp"], h, self.cfg.mlp_act), None

    def _block_train(self, p_l, window: int, x, qpos):
        """One layer over a whole sequence: ``(x, mixer state, aux)``.
        ``qpos`` is what ``_embed_inputs`` returned beside ``x``."""
        cfg = self.cfg
        h = L.rms_norm(x, p_l["ln1"])
        o, state = self._mixer_train(p_l, window, h, qpos)
        if cfg.post_norms:
            o = L.rms_norm(o, p_l["ln1_post"])
        x = x + o
        h2 = L.rms_norm(x, p_l["ln2"])
        m, aux = self._ffn(p_l, h2, qpos)
        if cfg.post_norms:
            m = L.rms_norm(m, p_l["ln2_post"])
        return x + m, state, aux

    def _block_decode(self, p_l, window: int, x, c, index: int):
        cfg = self.cfg
        h = L.rms_norm(x, p_l["ln1"])
        pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
        o = self._mixer_decode(p_l, window, h, c, index, pos)
        if cfg.post_norms:
            o = L.rms_norm(o, p_l["ln1_post"])
        x = x + o
        h2 = L.rms_norm(x, p_l["ln2"])
        m = self._ffn(p_l, h2, pos)[0]
        if cfg.post_norms:
            m = L.rms_norm(m, p_l["ln2_post"])
        return x + m

    # ---------------------------------------------------------- forward
    def _embed_inputs(self, params, batch):
        """``(x [B, S, D], qpos)``: the embedded prompt and what the
        blocks take beside it (the positions here)."""
        tokens = batch["tokens"].to(self.device)
        x = L.embed_tokens(params, tokens, self.cfg, self.dtype)
        qpos = torch.arange(tokens.shape[1], dtype=torch.int32,
                            device=self.device)
        return x, qpos

    def _embed_token(self, params, tokens, index: int):
        """The embedding of one new token at ``index`` [B, 1, D]."""
        return L.embed_tokens(params, tokens.to(self.device), self.cfg,
                              self.dtype)

    def _run_layers(self, params, x, qpos):
        """The layer stack; under autograd and ``cfg.remat`` each layer is
        checkpointed."""
        def block(p_l, w, x):
            return self._block_train(self._slice(p_l), w, x, qpos)[0]
        return remat_loop([(block, (p_l, w)) for p_l, w in
                           zip(self._slices(params), self.windows)], x,
                          self.cfg.remat and torch.is_grad_enabled())

    def _hidden(self, params, batch):
        """Final hidden states ``[B, S, D]`` at the positions that get
        logits."""
        x, qpos = self._embed_inputs(params, batch)
        return self._run_layers(params, x, qpos)

    @torch.no_grad()
    def forward(self, batch):
        """Logits ``[B, S, padded_vocab]`` (float32) at every position."""
        p = self._top(self.params)
        return self._all_rows(L.unembed(
            p, self._hidden(p, self._rows(batch)), self.cfg))

    # ------------------------------------------------------------- loss
    def _head(self, p) -> dict:
        return {k: p[k] for k in ("embedding", "final_norm", "lm_head")
                if k in p}

    def loss(self, batch, vocab_chunk: int = 8, params=None):
        """Next-token cross-entropy over ``batch["labels"]`` ([B, S], -1 =
        masked), with autograd: ``(loss, {"loss", "tokens"})``, the mean
        over valid tokens (float32) and their count (int32).  ``params``:
        the tree to run on (a train state's), default the model's own.
        See ``cross_entropy`` for the chunks.  On a mesh ``batch`` is the
        global batch: the rank runs its rows, divides by the global count
        of valid tokens, and returns its share (``_mesh_loss_args``)."""
        p = self._top(self.params if params is None else params)
        batch, n_tokens = self._mesh_loss_args(batch)
        loss, cnt = cross_entropy(self._head(p), self._hidden(p, batch),
                                  batch["labels"].to(self.device), self.cfg,
                                  vocab_chunk, n_tokens)
        return loss, {"loss": loss, "tokens": cnt}

    def _mesh_loss_args(self, batch):
        """``(this rank's rows of batch, the global count of valid
        labels)``; off a mesh ``(batch, None)``."""
        if self._batch_group() is None:
            return batch, None
        n_tokens = (batch["labels"] >= 0).sum(dtype=torch.int32).to(
            self.device)
        return self._rows(batch), n_tokens

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """``{"k", "v"}``, each ``[L, B, cache_len, Hkv, Dh]`` zeros in
        ``cfg.dtype``."""
        cfg = self.cfg
        shp = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads,
               cfg.d_head)
        return {"k": torch.zeros(shp, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shp, dtype=self.dtype, device=self.device)}

    def _fill_cache(self, cache, i: int, state, s: int) -> None:
        """Store layer ``i``'s ``_mixer_train`` state of a prompt of ``s``
        positions."""
        k, v = state[:2]
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v

    @torch.no_grad()
    def prefill(self, batch, cache_len: Optional[int] = None):
        """Run the whole prompt: ``(last_logits [B, 1, V], cache)``, the
        cache holding each layer's roped k and v at positions ``0..S-1``
        (S: every position the layers see, a VLM's prefix included) and
        zeros up to ``cache_len`` (default S)."""
        p = self._top(self.params)
        x, qpos = self._embed_inputs(p, self._rows(batch))
        b, s = x.shape[:2]
        cache_len = cache_len or s
        if cache_len < s:
            raise ValueError(f"prefill: cache_len {cache_len} < prompt "
                             f"length {s}")
        cache = self._mesh_cache(self.init_cache(b, cache_len))
        for i, (p_l, w) in enumerate(zip(self._slices(p), self.windows)):
            x, state, _ = self._block_train(self._slice(p_l), w, x, qpos)
            layer = self._cache_layer(cache, i)
            self._fill_cache({k: v[None] for k, v in layer.items()}, 0,
                             state, s)
            self._cache_store(cache, i, layer)
        return self._all_rows(L.unembed(p, x[:, -1:, :], self.cfg)), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, index: int):
        """tokens ``[B, 1]``; ``index``: the position of the new token (an
        int below the cache length).  Writes the new token's state into
        ``cache`` in place (the reference returns a new cache) and
        returns ``(logits [B, 1, V], cache)``."""
        index = int(index)
        if not 0 <= index < cache["k"].shape[2]:
            raise ValueError(f"decode_step: index {index} outside the "
                             f"cache (length {cache['k'].shape[2]})")
        p = self._top(self.params)
        x = self._embed_token(p, self._rows(tokens), index)
        for i, (p_l, w) in enumerate(zip(self._slices(p), self.windows)):
            layer = self._cache_layer(cache, i)
            x = self._block_decode(self._slice(p_l), w, x, layer, index)
            self._cache_store(cache, i, layer)
        return self._all_rows(L.unembed(p, x, self.cfg)), cache

    # ------------------------------------------------------- shardings
    def _fsdp_ax(self):
        if not self.cfg.fsdp:
            return None
        axes = tuple(self.fsdp_axes)
        return axes if len(axes) > 1 else axes[0]

    def param_spec(self) -> dict:
        """The reference's ``PartitionSpec`` tree of the parameters."""
        cfg = self.cfg
        fs = self._fsdp_ax()
        spec = {
            "embedding": P("model", fs),
            "final_norm": P(None),
            "layers": self._layer_spec(fs),
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = P(fs, "model")
        if self.strip_tp:
            spec = tree_map(
                lambda sp: P(*[None if e == "model" else e for e in sp]),
                spec)
        return spec

    def _layer_spec(self, fs) -> dict:
        cfg = self.cfg
        s = {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "attn": {
                "wq": P(None, fs, "model"),
                "wk": P(None, fs, "model"),
                "wv": P(None, fs, "model"),
                "wo": P(None, "model", fs),
            },
            "mlp": {
                "w_gate": P(None, fs, "model"),
                "w_up": P(None, fs, "model"),
                "w_down": P(None, "model", fs),
            },
        }
        if cfg.post_norms:
            s["ln1_post"] = P(None, None)
            s["ln2_post"] = P(None, None)
        return s

    def cache_spec(self, multi_pod: bool = True) -> dict:
        dp = dp_axes(multi_pod)
        return {"k": P(None, dp, None, None, "model"),
                "v": P(None, dp, None, None, "model")}

    def input_specs(self, shape: ShapeSpec, multi_pod: bool = True) -> dict:
        """The reference's dry-run inputs: ``{"arrays": meta tensors of
        its shapes and dtypes, "specs": P trees}``."""
        b, s = shape.global_batch, shape.seq_len
        dp = dp_axes(multi_pod)
        if shape.kind == "train":
            return {"arrays": {"tokens": _meta((b, s)),
                               "labels": _meta((b, s))},
                    "specs": {"tokens": P(dp, None),
                              "labels": P(dp, None)}}
        if shape.kind == "prefill":
            return {"arrays": {"tokens": _meta((b, s))},
                    "specs": {"tokens": P(dp, None)}}
        if shape.kind == "decode":
            return {"arrays": {"tokens": _meta((b, 1))},
                    "specs": {"tokens": P(dp, None)}}
        raise ValueError(shape.kind)


def _meta(shape, dtype=torch.int32):
    """A tensor without storage: a shape and a dtype (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _tensors(tree) -> dict:
    """A ``ParameterDict`` tree as nested dicts of detached tensors."""
    return {k: _tensors(v) if isinstance(v, (dict, nn.ParameterDict))
            else v.detach() for k, v in tree.items()}
