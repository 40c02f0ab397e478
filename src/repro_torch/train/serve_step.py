"""Serving step factories: prefill and single-token decode, and the greedy
decoding loop that ``launch/serve.py`` drives."""
from __future__ import annotations

import torch


def make_prefill_step(model):
    def prefill_step(batch, cache_len: int):
        return model.prefill(batch, cache_len=cache_len)
    return prefill_step


def make_decode_step(model):
    def decode_step(tokens, cache, index: int):
        return model.decode_step(tokens, cache, index)
    return decode_step


def greedy_generate(model, batch, steps: int, cache_len: int):
    """Greedy decoding: one prefill, then ``steps - 1`` decode steps, each
    token the argmax over the padded vocabulary (padded logits are -inf-like
    and never win).  Returns the generated tokens ``[B, steps]`` (int32)."""
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    logits, cache = prefill(batch, cache_len)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    start = batch["tokens"].shape[1] + getattr(model.cfg, "prefix_len", 0)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = decode(tok, cache, start + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
