"""Dense decoder-only LM (llama / mistral / gemma2 family), the
reference's ``models/transformer.py``:

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

``params_from_numpy(cfg, tree)`` carries the reference's ``DenseLM.init``
pytree (as numpy arrays) over, so both packages run the same weights.
Layers run in a Python loop, each with its window as an int; under
``cfg.remat`` the training path checkpoints each layer, as the reference
does.  ``forward``, ``prefill`` and ``decode_step`` compute no gradients.
The shardings and ``input_specs`` belong to the mesh work (ROADMAP.md §1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def _as_parameters(tree) -> nn.ParameterDict:
    """Nested dict of tensors -> nested ``ParameterDict`` of trainable
    parameters sharing the tensors' storage."""
    return nn.ParameterDict({
        k: _as_parameters(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()})


def _shapes(tree) -> dict:
    return {k: _shapes(v) if isinstance(v, (dict, nn.ParameterDict))
            else tuple(v.shape) for k, v in tree.items()}


def _check_tree(cfg: ModelConfig, params, who: str) -> None:
    """Raise ``ValueError`` unless ``params`` has the keys and shapes of
    ``cfg``'s parameter tree."""
    want = _shapes(init_params(cfg, "meta"))
    if _shapes(params) != want:
        raise ValueError(f"{who}: the tree does not fit {cfg.name}: "
                         f"{_shapes(params)} != {want}")


def init_params(cfg: ModelConfig, device, generator=None) -> dict:
    """float32 parameters at the reference's shapes and scales
    (``layers.py`` ``init_*``, ``DenseLM._init_layers``), drawn from
    ``generator`` (the same numbers as the reference's only in shape and
    distribution: ``jax.random`` and torch differ)."""
    n = cfg.n_layers
    params = L.init_embed(cfg, device, generator)
    layers = {
        "ln1": torch.zeros((n, cfg.d_model), device=device),
        "ln2": torch.zeros((n, cfg.d_model), device=device),
        "attn": L.init_attn(cfg, n, device, generator),
        "mlp": L.init_mlp(cfg, n, device, generator),
    }
    if cfg.post_norms:
        layers["ln1_post"] = torch.zeros((n, cfg.d_model), device=device)
        layers["ln2_post"] = torch.zeros((n, cfg.d_model), device=device)
    params["layers"] = layers
    return params


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """The reference's ``DenseLM.init`` pytree, its leaves as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's
    float32 parameter tree on ``device``: same keys, same ``x @ w`` layout
    (``wq`` is ``[L, d_model, q_dim]``), same stacked leading ``L`` axis.
    Raises ``ValueError`` when a key or a shape differs from ``cfg``'s."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, dtype=np.float32)).to(dev)

    params = conv(tree)
    _check_tree(cfg, params, "params_from_numpy")
    return params


class DenseLM(nn.Module):
    """The dense LM on one device.

    ``params``: a tree from ``params_from_numpy`` (or a train state's
    params); without it the parameters are drawn from ``generator``
    (default: seed 0 on the device).  The model's parameters share the
    tree's tensors.  ``use_kernels=False`` runs the flash kernel's plain
    version wherever the model lives (parity runs on the card)."""

    family = "dense"

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
            params = init_params(cfg, self.device, generator)
        _check_tree(cfg, params, "DenseLM")
        self.params = _as_parameters(params)

    def init(self, generator: torch.Generator) -> dict:
        """A fresh float32 parameter tree on the model's device, drawn from
        ``generator`` (the reference's ``init(key)``)."""
        return init_params(self.cfg, self.device, generator)

    # ------------------------------------------------------------ block
    def _layers(self, params) -> list[dict]:
        """Each layer's parameters: views into the stacked tensors, one
        ``unbind`` a tensor.  ``params["layers"]`` may also be the list
        of per-layer dicts itself (the train step passes each layer's
        slices as leaves of their own)."""
        if isinstance(params["layers"], (list, tuple)):
            return list(params["layers"])

        def split(t):
            if isinstance(t, (dict, nn.ParameterDict)):
                parts = {k: split(v) for k, v in t.items()}
                return [{k: v[i] for k, v in parts.items()}
                        for i in range(self.cfg.n_layers)]
            return t.unbind(0)
        return split(params["layers"])

    def _block_train(self, p_l, window: int, x, qpos):
        cfg = self.cfg
        h = L.rms_norm(x, p_l["ln1"])
        q, k, v = L.qkv_proj(p_l["attn"], h, cfg)
        q = L.rope(q, qpos, cfg.rope_theta)
        k = L.rope(k, qpos, cfg.rope_theta)
        o = L.attention_output(q, k, v, qpos, qpos, cfg.attn_impl,
                               causal=True, window=window,
                               softcap=cfg.attn_logit_softcap,
                               chunk=cfg.attn_chunk,
                               use_kernels=self.use_kernels)
        o = L.out_proj(p_l["attn"], o, h.dtype)
        if cfg.post_norms:
            o = L.rms_norm(o, p_l["ln1_post"])
        x = x + o
        h2 = L.rms_norm(x, p_l["ln2"])
        m = L.mlp_apply(p_l["mlp"], h2, cfg.mlp_act)
        if cfg.post_norms:
            m = L.rms_norm(m, p_l["ln2_post"])
        return x + m, (k, v)

    def _block_decode(self, p_l, window: int, x, k_cache, v_cache,
                      index: int):
        cfg = self.cfg
        h = L.rms_norm(x, p_l["ln1"])
        q, k1, v1 = L.qkv_proj(p_l["attn"], h, cfg)
        pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
        q = L.rope(q, pos, cfg.rope_theta)
        k1 = L.rope(k1, pos, cfg.rope_theta)
        k_cache[:, index] = k1[:, 0].to(k_cache.dtype)
        v_cache[:, index] = v1[:, 0].to(v_cache.dtype)
        o = L.attn_decode(q, k_cache, v_cache, index, causal=True,
                          window=window, softcap=cfg.attn_logit_softcap)
        o = L.out_proj(p_l["attn"], o, x.dtype)
        if cfg.post_norms:
            o = L.rms_norm(o, p_l["ln1_post"])
        x = x + o
        h2 = L.rms_norm(x, p_l["ln2"])
        m = L.mlp_apply(p_l["mlp"], h2, cfg.mlp_act)
        if cfg.post_norms:
            m = L.rms_norm(m, p_l["ln2_post"])
        return x + m

    # ---------------------------------------------------------- forward
    def _embed_inputs(self, params, batch):
        tokens = batch["tokens"].to(self.device)
        x = L.embed_tokens(params, tokens, self.cfg, self.dtype)
        qpos = torch.arange(tokens.shape[1], dtype=torch.int32,
                            device=self.device)
        return x, qpos

    def _run_layers(self, params, x, qpos):
        """The layer stack; under autograd and ``cfg.remat`` each layer is
        checkpointed (only its input is kept; the reference's
        ``nothing_saveable``)."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for p_l, w in zip(self._layers(params), self.windows):
            def block(p_l, x, w=w):
                return self._block_train(p_l, w, x, qpos)[0]
            x = (checkpoint(block, p_l, x, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else block(p_l, x))
        return x

    @torch.no_grad()
    def forward(self, batch):
        """Logits ``[B, S, padded_vocab]`` (float32) at every position."""
        x, qpos = self._embed_inputs(self.params, batch)
        x = self._run_layers(self.params, x, qpos)
        return L.unembed(self.params, x, self.cfg)

    # ------------------------------------------------------------- loss
    def loss(self, batch, vocab_chunk: int = 8, params=None):
        """Next-token cross-entropy over ``batch["labels"]`` ([B, S], -1 =
        masked), with autograd: ``(loss, {"loss", "tokens"})``, the mean
        over valid tokens (float32) and their count (int32).

        ``params``: the tree to run on (a train state's), default the
        model's own.  As in the reference, the sequence is cut into
        ``vocab_chunk`` chunks (one when S does not divide) and each
        chunk's float32 logits are computed inside a checkpoint, so only
        one chunk's ``[B, S / vocab_chunk, V]`` logits are ever live."""
        cfg = self.cfg
        p = self.params if params is None else params
        x, qpos = self._embed_inputs(p, batch)
        x = self._run_layers(p, x, qpos)
        targets = batch["labels"].to(self.device)
        s = targets.shape[1]
        nc = vocab_chunk if s % vocab_chunk == 0 else 1
        n = s // nc
        head = {k: p[k] for k in ("embedding", "final_norm", "lm_head")
                if k in p}

        def chunk_loss(head, xx, tt):
            logits = L.unembed(head, xx, cfg)             # [b, n, V] f32
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                tt.clamp(min=0).long()[..., None])[..., 0]
            valid = tt >= 0
            ce = torch.where(valid, logz - gold, 0.0)
            return ce.sum(), valid.sum(dtype=torch.int32)

        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.int32, device=self.device)
        for j in range(nc):
            ce, valid = checkpoint(chunk_loss, head, x[:, j * n:(j + 1) * n],
                                   targets[:, j * n:(j + 1) * n],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
            tot, cnt = tot + ce, cnt + valid
        loss = tot / torch.clamp(cnt, min=1)
        return loss, {"loss": loss, "tokens": cnt}

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """``{"k", "v"}``, each ``[L, B, cache_len, Hkv, Dh]`` zeros in
        ``cfg.dtype``."""
        cfg = self.cfg
        shp = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads,
               cfg.d_head)
        return {"k": torch.zeros(shp, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shp, dtype=self.dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, batch, cache_len: Optional[int] = None):
        """Run the whole prompt: ``(last_logits [B, 1, V], cache)``, the
        cache holding each layer's roped k and v at positions ``0..S-1``
        and zeros up to ``cache_len`` (default S)."""
        b, s = batch["tokens"].shape
        cache_len = cache_len or s
        if cache_len < s:
            raise ValueError(f"prefill: cache_len {cache_len} < prompt "
                             f"length {s}")
        cache = self.init_cache(b, cache_len)
        x, qpos = self._embed_inputs(self.params, batch)
        for i, (p_l, w) in enumerate(zip(self._layers(self.params),
                                         self.windows)):
            x, (k, v) = self._block_train(p_l, w, x, qpos)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        return L.unembed(self.params, x[:, -1:, :], self.cfg), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, index: int):
        """tokens ``[B, 1]``; ``index``: the position of the new token (an
        int below the cache length).  Writes the new k and v into ``cache``
        at ``index`` in place (the reference returns a new cache) and
        returns ``(logits [B, 1, V], cache)``."""
        index = int(index)
        if not 0 <= index < cache["k"].shape[2]:
            raise ValueError(f"decode_step: index {index} outside the "
                             f"cache (length {cache['k'].shape[2]})")
        x = L.embed_tokens(self.params, tokens.to(self.device), self.cfg,
                           self.dtype)
        for i, (p_l, w) in enumerate(zip(self._layers(self.params),
                                         self.windows)):
            x = self._block_decode(p_l, w, x, cache["k"][i],
                                   cache["v"][i], index)
        return L.unembed(self.params, x, self.cfg), cache
