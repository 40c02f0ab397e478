from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import REL_TOL, mha_plain, rel_err

__all__ = ["REL_TOL", "flash_attention", "mha_plain", "rel_err"]
