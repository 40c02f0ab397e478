"""Whisper-style encoder-decoder backbone, the reference's
``models/encdec.py``.

The frontend is a stub, as in the reference: the batch carries
precomputed audio frame embeddings ``audio_embeds`` [B, encoder_seq,
d_model] (the conv and mel stack are out of scope).  Encoder:
bidirectional self-attention over sinusoidal positions, then
``enc_norm``.  Decoder: causal self-attention (k and v cached) and cross
attention into the encoder's output (its k and v computed once at
prefill and cached as ``cross_k`` / ``cross_v``).  Neither uses rope.
The parameter tree adds ``enc_layers`` (``n_encoder_layers`` stacked)
and ``cross`` (one cross-attention a decoder layer) to the dense one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM, _meta, dp_axes, remat_loop
from repro_torch.utils.sharding import P


def _sinusoid(seq: int, d: int, device):
    """[seq, d] float32: sines then cosines of ``pos / 10000^(2i/d)``,
    computed in float64 as the reference's numpy table."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def _sinusoid_at(index: int, d: int, dtype, device):
    """The table's row at ``index`` [1, 1, d], computed in float32 (the
    reference's ``_sinusoid_at``)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(index), device=device) / torch.pow(
        torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None].to(dtype)


class EncDecLM(DenseLM):
    family = "encdec"
    STACKS = ("layers", "enc_layers", "cross")

    @classmethod
    def init_params(cls, cfg, device, generator=None) -> dict:
        params = super().init_params(cfg, device, generator)  # the decoder
        ne, d = cfg.n_encoder_layers, cfg.d_model
        params["enc_layers"] = {
            "ln1": torch.zeros((ne, d), device=device),
            "ln2": torch.zeros((ne, d), device=device),
            "attn": L.init_attn(cfg, ne, device, generator),
            "mlp": L.init_mlp(cfg, ne, device, generator),
        }
        cross = L.init_attn(cfg, cfg.n_layers, device, generator)
        cross["ln"] = torch.zeros((cfg.n_layers, d), device=device)
        params["cross"] = cross
        params["enc_norm"] = torch.zeros((d,), device=device)
        return params

    def _attend(self, q, k, v, qpos, kpos, causal: bool):
        cfg = self.cfg
        return L.attention_output(q, k, v, qpos, kpos, cfg.attn_impl,
                                  causal=causal, window=0,
                                  chunk=cfg.attn_chunk,
                                  use_kernels=self.use_kernels)

    # ------------------------------------------------------------ encoder
    def _enc_block(self, p_l, pos, x):
        cfg = self.cfg
        h = L.rms_norm(x, p_l["ln1"])
        q, k, v = L.qkv_proj(p_l["attn"], h, cfg)
        o = self._attend(q, k, v, pos, pos, causal=False)
        x = x + L.out_proj(p_l["attn"], o, x.dtype)
        h2 = L.rms_norm(x, p_l["ln2"])
        return x + L.mlp_apply(p_l["mlp"], h2, cfg.mlp_act)

    def encode(self, params, audio_embeds):
        """Audio frame embeddings [B, T, D] -> the encoder's output [B, T,
        D] in ``cfg.dtype``."""
        x = audio_embeds.to(self.device).to(self.dtype)
        x = x + _sinusoid(x.shape[1], self.cfg.d_model,
                          self.device).to(self.dtype)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=self.device)

        def block(p_l, x):
            return self._enc_block(self._slice(p_l, "enc_layers"), pos, x)
        x = remat_loop([(block, (p_l,)) for p_l in
                        self._slices(params, "enc_layers")], x,
                       self.cfg.remat and torch.is_grad_enabled())
        return L.rms_norm(x, params["enc_norm"])

    # ------------------------------------------------------------ decoder
    def _slices(self, params, group: str = "layers") -> list[dict]:
        """A decoder layer's slice carries its cross attention's
        (``["cross"]``)."""
        slices = super()._slices(params, group)
        if group != "layers":
            return slices
        return [dict(p_l, cross=c_l) for p_l, c_l in
                zip(slices, super()._slices(params, "cross"))]

    def _slice_spec(self, layout, group: str) -> dict:
        spec = super()._slice_spec(layout, group)
        if group == "layers":
            spec["cross"] = super()._slice_spec(layout, "cross")
        return spec

    def _embed_inputs(self, params, batch):
        """The decoder prompt over sinusoids, and beside it ``(positions,
        the encoder's output)``."""
        enc_out = self.encode(params, batch["audio_embeds"])
        x, qpos = super()._embed_inputs(params, batch)
        x = x + _sinusoid(x.shape[1], self.cfg.d_model,
                          self.device).to(self.dtype)
        return x, (qpos, enc_out)

    def _embed_token(self, params, tokens, index: int):
        return super()._embed_token(params, tokens, index) + _sinusoid_at(
            index, self.cfg.d_model, self.dtype, self.device)

    def _cross_q(self, c_l, x):
        """Cross attention's queries from the residual stream ``x``."""
        cfg = self.cfg
        hc = L.rms_norm(x, c_l["ln"])
        return (hc @ c_l["wq"].to(x.dtype)).reshape(
            x.shape[0], x.shape[1], cfg.n_heads, cfg.d_head)

    def _block_train(self, p_l, window: int, x, ctx):
        """One decoder layer: causal self attention, cross attention into
        the encoder's output, the MLP: ``(x, (k, v, cross k, cross v),
        None)``."""
        cfg, dt = self.cfg, x.dtype
        qpos, enc_out = ctx
        q, k, v = L.qkv_proj(p_l["attn"], L.rms_norm(x, p_l["ln1"]), cfg)
        o = self._attend(q, k, v, qpos, qpos, causal=True)
        x = x + L.out_proj(p_l["attn"], o, dt)
        c_l = p_l["cross"]
        kc, vc = ((enc_out @ c_l[w].to(dt)).reshape(
            x.shape[0], -1, cfg.n_kv_heads, cfg.d_head) for w in ("wk", "wv"))
        epos = torch.arange(kc.shape[1], dtype=torch.int32,
                            device=self.device)
        oc = self._attend(self._cross_q(c_l, x), kc, vc, qpos, epos,
                          causal=False)
        x = x + L.out_proj(c_l, oc, dt)
        m = self._ffn(p_l, L.rms_norm(x, p_l["ln2"]), qpos)[0]
        return x + m, (k, v, kc, vc), None

    def _block_decode(self, p_l, window: int, x, c, index: int):
        """One decoder token: self attention over the cache (written in
        place), cross attention over the cached encoder k and v
        (``attn_decode(..., encoder_seq - 1, causal=False)``, as the
        reference)."""
        cfg, dt = self.cfg, x.dtype
        q, k1, v1 = L.qkv_proj(p_l["attn"], L.rms_norm(x, p_l["ln1"]), cfg)
        c["k"][:, index] = k1[:, 0].to(c["k"].dtype)
        c["v"][:, index] = v1[:, 0].to(c["v"].dtype)
        o = L.attn_decode(q, c["k"], c["v"], index, causal=True)
        x = x + L.out_proj(p_l["attn"], o, dt)
        c_l = p_l["cross"]
        oc = L.attn_decode(self._cross_q(c_l, x), c["cross_k"],
                           c["cross_v"], cfg.encoder_seq - 1, causal=False)
        x = x + L.out_proj(c_l, oc, dt)
        return x + self._ffn(p_l, L.rms_norm(x, p_l["ln2"]), None)[0]

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """The decoder's ``k`` / ``v`` and each layer's ``cross_k`` /
        ``cross_v`` over the ``encoder_seq`` positions."""
        cfg = self.cfg
        cache = super().init_cache(batch_size, cache_len)
        shp = (cfg.n_layers, batch_size, cfg.encoder_seq, cfg.n_kv_heads,
               cfg.d_head)
        cache["cross_k"] = torch.zeros(shp, dtype=self.dtype,
                                       device=self.device)
        cache["cross_v"] = torch.zeros_like(cache["cross_k"])
        return cache

    def _fill_cache(self, cache, i: int, state, s: int) -> None:
        super()._fill_cache(cache, i, state, s)
        cache["cross_k"][i] = state[2]
        cache["cross_v"][i] = state[3]

    # ------------------------------------------------------- shardings
    def param_spec(self) -> dict:
        spec = super().param_spec()
        fs = self._fsdp_ax()
        spec["enc_layers"] = {
            "ln1": P(None, None), "ln2": P(None, None),
            "attn": {
                "wq": P(None, fs, "model"), "wk": P(None, fs, "model"),
                "wv": P(None, fs, "model"), "wo": P(None, "model", fs),
            },
            "mlp": {
                "w_gate": P(None, fs, "model"),
                "w_up": P(None, fs, "model"),
                "w_down": P(None, "model", fs),
            },
        }
        spec["cross"] = {
            "ln": P(None, None),
            "wq": P(None, fs, "model"), "wk": P(None, fs, "model"),
            "wv": P(None, fs, "model"), "wo": P(None, "model", fs),
        }
        spec["enc_norm"] = P(None)
        return spec

    def cache_spec(self, multi_pod: bool = True) -> dict:
        dp = dp_axes(multi_pod)
        base = super().cache_spec(multi_pod)
        base["cross_k"] = P(None, dp, None, None, "model")
        base["cross_v"] = P(None, dp, None, None, "model")
        return base

    def input_specs(self, shape: ShapeSpec, multi_pod: bool = True) -> dict:
        cfg = self.cfg
        b = shape.global_batch
        base = super().input_specs(shape, multi_pod)
        if shape.kind in ("train", "prefill"):
            base["arrays"]["audio_embeds"] = _meta(
                (b, cfg.encoder_seq, cfg.d_model), torch.float32)
            base["specs"]["audio_embeds"] = P(dp_axes(multi_pod), None, None)
        return base
