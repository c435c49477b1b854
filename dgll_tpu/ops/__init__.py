from dgll_tpu.ops.segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from dgll_tpu.ops.spmm import (
    fused_gcn_layer,
    sddmm_coo,
    spmm_coo,
    spmm_max_coo,
    spmm_mean_coo,
)

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "spmm_coo",
    "spmm_mean_coo",
    "spmm_max_coo",
    "sddmm_coo",
    "fused_gcn_layer",
]
