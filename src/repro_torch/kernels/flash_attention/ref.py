"""Plain PyTorch version of the flash attention kernel.

The same function as the CUDA kernel (``csrc/flash.cu``), computed the
direct way: the whole ``[B, Hkv, G, S, S]`` logit tensor in float32, one
softmax, one product with v.  Like the kernel it divides the logits by
``sqrt(D)`` after the dot, applies the optional ``softcap * tanh(x /
softcap)``, then the causal and sliding-window masks; rows with no valid
key come out 0.

The wrapper (``ops``) runs this for tensors on the CPU; ``chip_smoke.py``
holds the CUDA kernel against it on the card, by ``rel_err`` within
``REL_TOL``.
"""
from __future__ import annotations

import math

import torch


def valid_mask(s: int, causal: bool, window: int,
               device=None) -> torch.Tensor:
    """``[S, S]`` bool: may query ``i`` attend to key ``j``?  ``causal``
    keeps ``j <= i``; ``window > 0`` keeps ``j > i - window``."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Hq, S, D]; k/v: [B, Hkv, S, D] (GQA: Hq % Hkv == 0; query
    head ``h`` reads kv head ``h // (Hq // Hkv)``) -> [B, Hq, S, D] in
    q's dtype.

    ``window > 0`` restricts attention to the last ``window`` positions
    (sliding-window / local attention, gemma2-style); ``softcap > 0``
    applies ``softcap * tanh(logits / softcap)``.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"mha_plain: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(self-attention: one length for q, k and v)")
    if hq % hkv:
        raise ValueError(f"mha_plain: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, s, d)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    # in place where it can be: at Gemma-2's B = 2, S = 8192 one logit
    # tensor is 4.3 GB
    logits = (qf @ kf.transpose(-1, -2)).div_(math.sqrt(d))
    if softcap > 0:
        logits.div_(softcap).tanh_().mul_(softcap)
    logits.masked_fill_(~valid_mask(s, causal, window, q.device),
                        float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs.nan_to_num_(nan=0.0)                      # fully-masked rows
    out = probs @ vf
    return out.reshape(b, hq, s, d).to(q.dtype)


#: ``rel_err`` limits: bf16 is one rounding of each side (at most 2^-8
#: of |want| each, 2^-7 together) plus the kernel's bf16 probabilities
#: (2^-9 of the row's size); float32 differs in summation order only
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``|got - want| / (|want| + rms(want's row))``, a row being
    one query's ``D`` outputs: each error against the size of what it
    compares.  An absolute bound is as large as a typical output of a
    long softmax average (about ``1.65 / sqrt(keys)`` on unit-normal
    inputs) and misses faults confined to long rows; this measure does
    not.  Rows of zeros must match exactly."""
    if want.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    scale = w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt()
    err = (g - w).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / scale.clamp_min(torch.finfo(torch.float32).tiny))
    return float(ratio.max())
