"""Architecture registry: config.family -> model class."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def model_class(family: str):
    """The port's model class of ``family`` (imported on first use)."""
    if family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM
    if family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM
    if family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM
    if family == "ssm":
        from repro_torch.models.xlstm import XLSTMLM
        return XLSTMLM
    if family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM
    if family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM
    raise ValueError(f"unknown family {family!r}")


def init_params(cfg: ModelConfig, device, generator=None) -> dict:
    """float32 parameters of ``cfg``'s family at the reference's shapes
    and scales, drawn from ``generator`` (the same numbers as the
    reference's only in shape and distribution: ``jax.random`` and torch
    differ)."""
    return model_class(cfg.family).init_params(cfg, device, generator)


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """The reference's ``model.init`` pytree of ``cfg``'s family (numpy
    leaves) as the port's float32 tree: the family class's
    ``params_from_numpy``."""
    return model_class(cfg.family).params_from_numpy(cfg, tree, device)


def build_model(cfg: ModelConfig, **kwargs):
    """The model of ``cfg``'s family; ``kwargs`` go to its constructor
    (``device``, ``generator``, ``params``, ``use_kernels``)."""
    return model_class(cfg.family)(cfg, **kwargs)
