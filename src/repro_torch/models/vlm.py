"""PaliGemma-style VLM backbone: a patch-embedding prefix and a Gemma
decoder, the reference's ``models/vlm.py``.

The frontend is a stub, as in the reference: the batch carries
precomputed SigLIP patch embeddings ``patch_embeds`` [B, prefix_len,
d_model], which come before the token embeddings.  Attention is
prefix-LM: bidirectional over the image prefix, causal over the text
(``cfg.prefix_len``, which ``DenseLM._mixer_train`` passes on).  Logits
and the loss cover the text positions only; the cache covers prefix and
text, so decoding starts at ``prefix_len + S``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM, _meta, dp_axes
from repro_torch.utils.sharding import P


class VLM(DenseLM):
    family = "vlm"

    def _embed_inputs(self, params, batch):
        tok = L.embed_tokens(params, batch["tokens"].to(self.device),
                             self.cfg, self.dtype)
        patches = batch["patch_embeds"].to(self.device).to(self.dtype)
        x = torch.cat([patches, tok], dim=1)
        qpos = torch.arange(x.shape[1], dtype=torch.int32, device=self.device)
        return x, qpos

    def _hidden(self, params, batch):
        """The text positions only."""
        return super()._hidden(params, batch)[:, self.cfg.prefix_len:]

    def input_specs(self, shape: ShapeSpec, multi_pod: bool = True) -> dict:
        """Text and prefix together fill the shape's ``seq_len``; the
        patch embeddings beside the tokens."""
        cfg = self.cfg
        b = shape.global_batch
        base = super().input_specs(shape, multi_pod)
        if shape.kind in ("train", "prefill"):
            s_text = shape.seq_len - cfg.prefix_len
            base["arrays"]["tokens"] = _meta((b, s_text))
            if shape.kind == "train":
                base["arrays"]["labels"] = _meta((b, s_text))
            base["arrays"]["patch_embeds"] = _meta(
                (b, cfg.prefix_len, cfg.d_model), torch.float32)
            base["specs"]["patch_embeds"] = P(dp_axes(multi_pod), None, None)
        return base
