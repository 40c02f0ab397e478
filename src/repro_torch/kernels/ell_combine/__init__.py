from repro_torch.kernels.ell_combine.ops import ell_spmv, ell_spmv_ref
from repro_torch.kernels.ell_combine.ref import (
    ell_combine_plain,
    ell_combine_ref,
)

__all__ = ["ell_spmv", "ell_spmv_ref", "ell_combine_plain",
           "ell_combine_ref"]
