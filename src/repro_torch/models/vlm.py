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

from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM


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
