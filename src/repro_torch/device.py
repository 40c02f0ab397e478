"""The port's default-device rule.

Every entry point that places data (graph builders, engines, the
platform) takes a ``device`` argument.  ``None`` means the first CUDA
device, and raises where CUDA is absent: nothing quietly falls back to
the CPU.  A caller that wants the host says so with ``device="cpu"``.
On a device mesh ``None`` means the mesh's device for this rank: the
CUDA device ``launch.mesh.make_mesh`` made current, or the host for a
CPU mesh.
"""
from __future__ import annotations

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` -> ``cuda:0`` (``RuntimeError`` without CUDA), or on a
    ``DeviceMesh`` this rank's device; anything else is taken as given
    (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None and mesh is not None:
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(mesh.device_type)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the host")
        return torch.device("cuda", 0)
    return torch.device(device)
