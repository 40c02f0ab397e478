"""PyTorch/CUDA port of the hybrid graph-analytics platform.

Mirrors the reference package ``repro`` module for module; see
``repro_torch.core.query`` for the entry points (``GraphPlatform``,
``GraphQuery``).  Runs on the first CUDA device unless a caller passes
``device="cpu"``.
"""
