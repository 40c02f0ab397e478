"""Serving entry point: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma2-2b --batch 2 --prompt-len 8192 --gen 16

runs on ``cuda:0`` (raising without CUDA); ``--reduced --device cpu``
serves the reduced config on the host.  ``--attn-impl`` picks the prefill
attention (``flash``: the hand-written kernel on the card, its plain
version on the CPU; ``chunked``, ``ref``: plain torch).  Weights are
random, drawn from ``--seed``; prompts are random tokens from numpy's
generator with the same seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.serve_step import greedy_generate


def build(arch: str, reduced: bool = False, device=None,
          attn_impl: str = "flash", seed: int = 0):
    """The model ``main`` serves: ``arch``'s config (reduced on request)
    with ``attn_impl``, its weights drawn from a generator seeded with
    ``seed`` on the device."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return build_model(cfg, device=dev, generator=gen)


def prompts(cfg, batch: int, prompt_len: int, seed: int = 0,
            device=None) -> dict:
    """``{"tokens": [batch, prompt_len] int32}`` drawn uniformly from the
    vocabulary by numpy's generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return {"tokens": torch.from_numpy(tok.astype(np.int32)).to(
        resolve_device(device))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host")
    ap.add_argument("--attn-impl", default="flash",
                    choices=("flash", "chunked", "ref"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model = build(args.arch, args.reduced, args.device, args.attn_impl,
                  args.seed)
    batch = prompts(model.cfg, args.batch, args.prompt_len, args.seed,
                    model.device)
    cache_len = args.prompt_len + args.gen
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
