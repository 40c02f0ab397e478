from repro_torch.kernels.pregel_superstep.ops import (
    fused_superstep,
    msg_src,
    msg_src_plus_one,
    msg_src_plus_w,
    msg_src_times_w,
)
from repro_torch.kernels.pregel_superstep.ref import superstep_plain

__all__ = ["fused_superstep", "superstep_plain", "msg_src",
           "msg_src_plus_one", "msg_src_plus_w", "msg_src_times_w"]
