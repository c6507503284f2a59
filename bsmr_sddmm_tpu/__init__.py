"""bsmr_sddmm_tpu — a block-structured SDDMM framework in JAX.

Built from scratch in JAX with the capabilities of the CUDA reference
BSMR-SDDMM (CX9898/BSMR-SDDMM): computes ``P = (A @ B) * S`` only where the
sparse mask ``S`` is nonzero, by

1. reordering the mask's rows by pattern similarity (threshold ``alpha``,
   reference: src/rowReordering.cu),
2. splitting each row panel's columns into dense tensor-core tiles
   (density threshold ``delta``, reference: src/colReordering.cu) plus a
   sparse COO residual,
3. running a hybrid dense-tile kernel (batched matmuls, emitted back in
   CSR order) next to a gather/segment residual path
   (reference: src/sddmmKernel.cu), and
4. scaling across a device mesh by sharding row panels over devices
   (new work; the reference is single-GPU).

Layer map (mirrors SURVEY.md section 1 for the reference):

    harness / bench    scripts/, bench.py
    CLI / driver       bsmr_sddmm_tpu.cli
    orchestration      bsmr_sddmm_tpu.sddmm (BsmrSddmm pipeline)
    preprocessing      bsmr_sddmm_tpu.reorder, bsmr_sddmm_tpu.pack
    compute kernels    bsmr_sddmm_tpu.ops (XLA + Pallas)
    data layer         bsmr_sddmm_tpu.formats
    parallel layer     bsmr_sddmm_tpu.parallel
"""

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR, COO, load_matrix, make_dense
from bsmr_sddmm_tpu.reorder import BsmrReordering, row_reordering, col_reordering
from bsmr_sddmm_tpu.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu.sddmm import BsmrSddmm, sddmm

__version__ = "0.1.0"

__all__ = [
    "SddmmConfig",
    "CSR",
    "COO",
    "load_matrix",
    "make_dense",
    "BsmrReordering",
    "row_reordering",
    "col_reordering",
    "TilePlan",
    "pack_tiles",
    "BsmrSddmm",
    "sddmm",
    "__version__",
]
