from repro_torch.kernels.ell_intersect.ops import (
    ell_intersect,
    ell_intersect_counts,
)
from repro_torch.kernels.ell_intersect.ref import (
    ell_intersect_counts_plain,
    ell_intersect_plain,
)

__all__ = ["ell_intersect", "ell_intersect_counts",
           "ell_intersect_counts_plain", "ell_intersect_plain"]
