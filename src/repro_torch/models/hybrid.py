"""Hymba hybrid-head LM: parallel attention and Mamba heads per layer,
the reference's ``models/hybrid.py``.

Each layer runs GQA attention (a sliding window everywhere except the
three global layers) and a selective-SSM mixer in parallel on the same
normalised input; each branch's output gets its own RMS norm, the two
are averaged, and the MLP follows.  The cache adds each layer's SSM
state ``ssm`` [L, B, di, N] (float32) and conv state ``conv`` [L, B,
K-1, di] to the attention's k and v.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.transformer import DenseLM


class HybridLM(DenseLM):
    family = "hybrid"

    @staticmethod
    def _init_layers(cfg, device, generator) -> dict:
        n, d = cfg.n_layers, cfg.d_model
        return {
            "ln1": torch.zeros((n, d), device=device),
            "ln2": torch.zeros((n, d), device=device),
            "norm_attn": torch.zeros((n, d), device=device),
            "norm_ssm": torch.zeros((n, d), device=device),
            "attn": L.init_attn(cfg, n, device, generator),
            "ssm": M.mamba_init(cfg, n, device, generator),
            "mlp": L.init_mlp(cfg, n, device, generator),
        }

    def _fuse(self, p_l, attn_out, ssm_out):
        return 0.5 * (L.rms_norm(attn_out, p_l["norm_attn"])
                      + L.rms_norm(ssm_out, p_l["norm_ssm"]))

    def _mixer_train(self, p_l, window: int, h, qpos):
        attn_out, (k, v) = super()._mixer_train(p_l, window, h, qpos)
        ssm_out, h_t, conv = M.mamba_mixer(p_l["ssm"], h, self.cfg)
        return self._fuse(p_l, attn_out, ssm_out), (k, v, h_t, conv)

    def _mixer_decode(self, p_l, window: int, h, c, index: int, pos):
        attn_out = super()._mixer_decode(p_l, window, h, c, index, pos)
        ssm_out, h_t, conv = M.mamba_decode(p_l["ssm"], h, self.cfg,
                                            c["ssm"], c["conv"])
        c["ssm"].copy_(h_t)
        c["conv"].copy_(conv)
        return self._fuse(p_l, attn_out, ssm_out)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        cfg = self.cfg
        di = cfg.ssm_expand * cfg.d_model
        cache = super().init_cache(batch_size, cache_len)
        cache["ssm"] = torch.zeros((cfg.n_layers, batch_size, di,
                                    cfg.ssm_state), device=self.device)
        cache["conv"] = torch.zeros((cfg.n_layers, batch_size,
                                     cfg.ssm_conv - 1, di), dtype=self.dtype,
                                    device=self.device)
        return cache

    def _fill_cache(self, cache, i: int, state, s: int) -> None:
        super()._fill_cache(cache, i, state, s)
        cache["ssm"][i] = state[2]
        cache["conv"][i] = state[3]
