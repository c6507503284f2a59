"""Compute kernels: hybrid dense-tile / sparse-residual SDDMM."""

from bsmr_sddmm_tpu.ops.sddmm import (
    DevicePlan,
    device_plan,
    make_batched_sddmm_fn,
    make_sddmm_fn,
    sddmm_ref,
)
from bsmr_sddmm_tpu.ops import graph, graph_rphm, spmm

__all__ = ["DevicePlan", "device_plan", "make_batched_sddmm_fn",
           "make_sddmm_fn", "sddmm_ref", "graph", "graph_rphm", "spmm"]
