"""The port's default-device rule.

Every entry point that places data (graph builders, engines, the
platform) takes a ``device`` argument.  ``None`` means the first CUDA
device, and raises where CUDA is absent: nothing quietly falls back to
the CPU.  A caller that wants the host says so with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (``RuntimeError`` without CUDA); anything
    else is taken as given (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the host")
        return torch.device("cuda", 0)
    return torch.device(device)
