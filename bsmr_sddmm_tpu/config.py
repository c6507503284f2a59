"""Configuration for the BSMR-SDDMM pipeline.

The reference exposes its knobs as CLI flags (-f/-k/-a/-d/-t/-l, reference
include/Options.hpp:38-43) plus compile-time tile macros
(ROW_PANEL_SIZE/BLOCK_COL_SIZE = 16, include/BSMR.hpp:8-10,
COL_BLOCK_SIZE = 32, src/rowReordering.cu:13). Here every knob is a runtime
dataclass field; tile geometry is a kernel *parameter* (default 32 x 128
tiles instead of WMMA's 16 x 16).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SddmmConfig:
    """All knobs for one BSMR-SDDMM run.

    Defaults mirror the reference defaults (K=32, alpha=0.3, delta=0.3,
    include/Options.hpp:38-43) except for tile geometry.
    """

    # --- problem shape ---------------------------------------------------
    k: int = 32                  # contraction dim (reference -k)
    alpha: float = 0.3           # row-similarity threshold (reference -a)
    delta: float = 0.3           # block-density threshold (reference -d)

    # --- tile geometry ----------------------------------------------------
    # Row-panel height. The reference hardwires 16 (WMMA_M). Larger panels
    # raise the arithmetic intensity of the per-tile B-column read
    # (useful flops/byte ~ density * panel_height/2) but dilute tile
    # density. Keep it a parameter.
    panel_height: int = 32
    # Column-block width (the reference's BLOCK_COL_SIZE is 16).
    block_width: int = 128
    # Column-block granularity of the row-pattern *encoding* used for
    # clustering (reference COL_BLOCK_SIZE=32, src/rowReordering.cu:13).
    encoding_block: int = 32

    # --- numerics ---------------------------------------------------------
    # The dot algorithm (bsmr_sddmm_tpu/precision.py): "tf32" is TF32
    # inputs with fp32 accumulation, the reference's tensor-core multiply
    # (src/sddmmKernel.cu:310-326); "bf16x3" is three bf16 products of
    # hi/lo splits; "fp32" is full fp32. Every one must pass the
    # reference tolerance (abs 1e-5 OR rel 1e-3,
    # include/checkData.hpp:14-30); a plain bf16 product does not.
    matmul_precision: str = "tf32"   # "tf32" | "bf16x3" | "fp32"
    dtype: str = "float32"
    # Output value dtype. "float16" halves the output bytes of every tier
    # (accumulation stays fp32; only the store narrows) and still passes
    # the reference tolerance (fp16 round-off is rel ~5e-4 < the 1e-3
    # rel gate, include/checkData.hpp:14-30). The reference stores fp32
    # (matrixP is float); results measured with fp16 emission are always
    # reported alongside fp32 ones.
    out_dtype: str = "float32"   # "float32" | "float16"

    # --- column split mode --------------------------------------------------
    # "bsr"     : No column permutation: dense tiles are the *natural*
    #             bw-wide column blocks whose in-panel nnz meets the delta
    #             threshold. B blocks are then contiguous slices of B^T —
    #             zero gather traffic — and row clustering alone
    #             concentrates density.
    # "reorder" : reference parity (colReordering_cpu semantics,
    #             src/colReordering.cu:274-404): per-panel columns sorted by
    #             count, gathered per tile.
    col_mode: str = "bsr"

    # --- reordering strategy ----------------------------------------------
    # "exact"  : faithful greedy accumulate-encoding clustering
    #            (src/rowReordering.cu:325-432 semantics), sequential host.
    # "fast"   : greedy with one representative per round but the
    #            similarity scan vectorized over all remaining rows (and
    #            candidate-pruned) — same alpha semantics, near-identical
    #            clusters, orders of magnitude faster.
    # "none"   : identity ordering (reference noReorderRow,
    #            src/rowReordering.cu:15-46).
    row_strategy: str = "fast"
    # Use the C++/OpenMP clustering (bsmr_sddmm_tpu.native) when it can be
    # built; same semantics as the NumPy strategies, ~100x faster.
    use_native: bool = True
    # Cache row-reordering results on disk keyed by (mask pattern, alpha,
    # strategy): a re-run or resumed sweep skips the dominant
    # preprocessing cost (SURVEY.md section 5 checkpoint/resume).
    reorder_cache: bool = False

    # --- residual packing ---------------------------------------------------
    # What happens to nonzeros outside dense tiles. "gathered": pack each
    # panel's residual columns (count-descending) into bw-wide *gathered*
    # tiles executed as matmuls against a take()-gathered B block, while
    # chunks too sparse to amortize a tile fall back to per-nonzero
    # gather-dot; "pernnz": everything per-nonzero.
    residual_mode: str = "gathered"   # "gathered" | "pernnz"
    # Serialize the four tiers with lax.optimization_barrier inside the
    # fused program, so the compiler cannot interleave them. "auto"
    # serializes a plan only where the device's cost-table row carries a
    # measured residual-share threshold (autotune.COSTS,
    # ops/sddmm._serialize_tiers); "on" / "off" force either arm. Bools
    # are accepted as on/off.
    tier_serialize: object = "auto"   # "auto" | "on" | "off" | bool
    # Minimum nonzeros a gathered bw-col chunk must cover to become a
    # tile; sparser chunks go per-nonzero.
    residual_tile_min_nnz: int = 96

    # --- sub-block packed tier ------------------------------------------
    # The tile-fill lever (SURVEY.md section 7 hard part 1): qualifying
    # subblock_width-wide *aligned* column sub-blocks of the same row
    # panel are packed S = block_width/subblock_width side-by-side into
    # one tile. The B operand of a packed tile is S contiguous
    # (subblock_width x K) slices of the column-permuted B^T instead of
    # bw gathered rows, so fill rises ~S-fold at near-constant per-tile
    # bytes. Entries land
    # here when their (panel, sub-block) count reaches subpack_min_nnz
    # and the enclosing 128-wide block did NOT meet delta (the dense BSR
    # tier keeps truly dense natural blocks, whose contiguous-B reuse is
    # cheaper still). 0 disables the tier.
    subblock_width: int = 32
    subpack_min_nnz: int = 12
    # B-gather windowing: when B exceeds gather_window_threshold_mb,
    # gathered tiles and residual entries are grouped by column window at
    # pack time and each group gathers from a static gather_window_mb-
    # sized slice of B. 0 (the default) disables: on the H100 it does not
    # pay (rmat_18 K=128, B = 128 MiB: 3.49 ms windowed vs 3.43 ms not;
    # PERF.md).
    gather_window_mb: int = 0
    gather_window_threshold_mb: int = 64
    # Cap on window groups per side per tier. Each (window, chunk) pair
    # unrolls into its own slice+gather+matmul in the XLA program, so an
    # unbounded window count on huge-N matrices would explode compile
    # time; when N implies more windows than this, the window grows to
    # N/max_gather_groups instead (a gradual gather-rate penalty beats an
    # op-count explosion).
    max_gather_groups: int = 48

    # Max dense tiles fused per step in bsr mode ("fat steps"): G
    # same-column-block tiles share one B block read and one step's
    # overhead. The packer picks the G minimizing padded-tiles x
    # per-tile-cost (autotune.dense_tile_ns) over the plan's actual
    # same-cblock run lengths. 1 disables.
    dense_fat_group: int = 32

    # --- execution --------------------------------------------------------
    # "auto"   : "xla".
    # "xla"    : gather + batched matmul per tier, XLA's own code.
    # "triton" : the Pallas-Triton tile kernel for the bsr dense and
    #            packed tiers (ops/triton_tiles.py) + XLA for the rest.
    backend: str = "auto"
    # Tiles processed per chunk in the dense path (bounds live memory for
    # the gathered B tiles: chunk * block_width * K floats).
    dense_chunk: int = 512
    # Residual nonzeros per chunk (bounds gathered A/B rows: chunk * K).
    residual_chunk: int = 1 << 16
    # Live-intermediate budget per tier (MB). Under the budget a tier runs
    # as ONE gather + ONE batched matmul; above it, an unrolled chunk
    # loop bounds live memory.
    tier_memory_mb: int = 384
    # Pad tile/residual counts up to buckets (powers of two between
    # min_bucket and exact) to bound recompilation across sweep configs.
    bucket_shapes: bool = True

    # --- benchmark --------------------------------------------------------
    num_iterations: int = 10     # timing iterations (reference Options.hpp:39)
    # Measured autotune refinement: with alpha="auto"/delta="auto", time
    # the N best-priced plans in-program on the device and pick the
    # measured argmin (autotune.choose_config refine_top). The affine
    # cost model cannot see how the fused schedule overlaps the tiers.
    # 0 = pure host-side estimate.
    autotune_refine_top: int = 0

    def __post_init__(self) -> None:
        # tile dims: powers of two >= 16, what the triton route's blocks
        # and tensor-core dots take (ops/triton_tiles.py)
        for name in ("panel_height", "block_width"):
            v = getattr(self, name)
            if v < 16 or v & (v - 1):
                raise ValueError(
                    f"{name} must be a power of two >= 16, got {v}")
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        if self.row_strategy not in ("exact", "fast", "none"):
            raise ValueError(f"unknown row_strategy {self.row_strategy!r}")
        if self.subpack_min_nnz and (
                self.subblock_width <= 0
                or self.block_width % self.subblock_width):
            raise ValueError(
                f"subblock_width ({self.subblock_width}) must divide "
                f"block_width ({self.block_width})")
        if self.col_mode not in ("bsr", "reorder"):
            raise ValueError(f"unknown col_mode {self.col_mode!r}")
        if self.residual_mode not in ("gathered", "pernnz"):
            raise ValueError(
                f"unknown residual_mode {self.residual_mode!r}")
        if self.tier_serialize not in ("auto", "on", "off", True, False):
            raise ValueError(
                f"unknown tier_serialize {self.tier_serialize!r}")
        if self.backend not in ("auto", "xla", "triton"):
            raise ValueError(f"unknown backend {self.backend!r}")
        from bsmr_sddmm_tpu.precision import PRECISIONS
        if self.matmul_precision not in PRECISIONS:
            raise ValueError(
                f"unknown matmul_precision {self.matmul_precision!r}"
            )
        if self.out_dtype not in ("float32", "float16"):
            raise ValueError(f"unknown out_dtype {self.out_dtype!r}")

    @property
    def block_size(self) -> int:
        """Elements per dense tile (reference BLOCK_SIZE=256, BSMR.hpp:10)."""
        return self.panel_height * self.block_width

    def replace(self, **kw) -> "SddmmConfig":
        return dataclasses.replace(self, **kw)


# Sweep grids for test mode. Alphas and Ks mirror the reference
# (src/sddmm.cu:64-66). The delta grid prepends low thresholds
# (0.006/0.02/0.05) suited to 32 x 128 natural-block tiles, whose density
# per tile is far below a 16 x 16 gathered tile's.
SWEEP_ALPHAS = (0.1, 0.3, 0.5, 0.7, 0.9)
SWEEP_DELTAS = (0.006, 0.02, 0.05, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.1)
SWEEP_KS = (32, 64, 128, 256)
