"""Serving entry point: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma2-2b --batch 2 --prompt-len 8192 --gen 16

runs on ``cuda:0`` (raising without CUDA); ``--reduced --device cpu``
serves the reduced config on the host.  Every architecture of every
family serves (DBRX-132B only reduced: its 132 B parameters do not fit
one card).  ``--attn-impl`` picks the prefill attention (``flash``: the
hand-written kernel on the card, its plain version on the CPU;
``chunked``, ``ref``: plain torch); its default is ``flash`` where the
kernel takes the family's prefill attention (dense, moe, hybrid) and
``chunked`` for ``vlm`` (the prefix-LM zone) and ``encdec`` (cross
attention over keys of another length), where ``flash`` raises.
Weights are random, drawn from ``--seed``; prompts are random tokens
from numpy's generator with the same seed, and the stub frontends' inputs
(``audio_embeds``, ``patch_embeds``) standard normal from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.serve_step import greedy_generate


def default_attn_impl(cfg) -> str:
    """``flash`` where the kernel takes the family's prefill attention,
    else the configs' own ``chunked``."""
    return "flash" if cfg.family in ("dense", "moe", "hybrid") else "chunked"


def build(arch: str, reduced: bool = False, device=None,
          attn_impl: Optional[str] = None, seed: int = 0):
    """The model ``main`` serves: ``arch``'s config (reduced on request)
    with ``attn_impl`` (default: ``default_attn_impl``), its weights drawn
    from a generator seeded with ``seed`` on the device."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl
                              or default_attn_impl(cfg))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return build_model(cfg, device=dev, generator=gen)


def prompts(cfg, batch: int, prompt_len: int, seed: int = 0,
            device=None) -> dict:
    """``{"tokens": [batch, prompt_len] int32}`` drawn uniformly from the
    vocabulary by numpy's generator seeded with ``seed``; then, from the
    same generator, ``audio_embeds`` [batch, encoder_seq, d_model]
    (``encdec``) or ``patch_embeds`` [batch, prefix_len, d_model]
    (``vlm``), standard normal float32 (the reference's
    ``launch/serve.py``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out = {"tokens": torch.from_numpy(tok.astype(np.int32)).to(dev)}
    frontend = {"encdec": ("audio_embeds", cfg.encoder_seq),
                "vlm": ("patch_embeds", cfg.prefix_len)}.get(cfg.family)
    if frontend:
        name, n = frontend
        emb = rng.standard_normal((batch, n, cfg.d_model))
        out[name] = torch.from_numpy(emb.astype(np.float32)).to(dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host")
    ap.add_argument("--attn-impl", default=None,
                    choices=("flash", "chunked", "ref"),
                    help="default: flash for dense, moe and hybrid, "
                         "chunked for the others")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model = build(args.arch, args.reduced, args.device, args.attn_impl,
                  args.seed)
    batch = prompts(model.cfg, args.batch, args.prompt_len, args.seed,
                    model.device)
    cache_len = args.prompt_len + args.gen + model.cfg.prefix_len
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = greedy_generate(model, batch, steps=args.gen, cache_len=cache_len)
    sync()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"{model.cfg.name} on {model.device}: generated "
          f"{tuple(out.shape)} in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          "prefill included)")
    print("sample:", out[0].tolist())


if __name__ == "__main__":
    main()
