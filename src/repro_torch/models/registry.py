"""Architecture registry: config.family -> model class."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

#: families of the reference that the port has no model for yet
UNPORTED_FAMILIES = ("moe", "hybrid", "ssm", "encdec", "vlm")


def build_model(cfg: ModelConfig, **kwargs):
    """The model of ``cfg``'s family; ``kwargs`` go to its constructor
    (``device``, ``generator``, ``params``, ``use_kernels``)."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg, **kwargs)
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP.md §1, Next: the other LM families)")
    raise ValueError(f"unknown family {cfg.family!r}")
