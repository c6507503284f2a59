"""Dense- and packed-tier SDDMM tile kernel, Pallas through Triton.

The reference's dense-tile design (sddmm_gpu_dense_block_m16n16k8,
src/sddmmKernel.cu:213-351) at this repo's tile geometry: each program
loads its own panel and column-block ids, reads the A panel straight from
the row-permuted ``A_perm`` and the B rows straight from ``Bᵀ``, and runs
``pl.dot`` with fp32 accumulation (TF32 inputs by default). XLA's plain
version (ops/sddmm.py) first writes the gathered A panels and B blocks to
device memory with ``jnp.take`` and reads them back in a batched matmul;
this kernel moves none of those bytes.

One kernel covers both tiers. A tile's B operand is S = bw / sw row
sub-blocks of ``Bᵀ``, each ``sw`` rows long:

* dense BSR tier: S = 1, sw = bw — one natural column block, shared by the
  G tiles of a fat step (``TilePlan.step_cblock``);
* packed hot-column tier: G = 1, S = bw / subblock_width sub-blocks of the
  column-permuted ``Bt2`` (``TilePlan.sp_sub``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

#: tiles one program computes; they share one fat step's B sub-blocks
TILES_PER_PROGRAM = 4
#: contraction chunk per dot: bounds the operand tiles a program holds
K_CHUNK = 128


def _pow2_at_least_16(n: int) -> bool:
    return n >= 16 and n & (n - 1) == 0


def make_tile_kernel(ph: int, bw: int, k: int, sw: int, group: int,
                     precision, out_dtype=jnp.float32,
                     interpret: bool = False,
                     num_warps: int = 4, num_stages: int = 2):
    """Build ``fn(A_perm (P*ph, K), Bt (N, K), tile_panel (T,),
    step_sub (T // group, bw // sw)) -> (T, ph, bw)``.

    Tile t multiplies rows ``tile_panel[t]*ph ...+ph`` of ``A_perm`` by
    the B rows ``step_sub[t // group, s]*sw ...+sw`` for each sub-block s,
    contracting K. ``precision`` is a resolved ``lax.DotAlgorithmPreset``
    (precision.dot_algorithm)."""
    for name, v in (("ph", ph), ("bw", bw), ("k", k), ("sw", sw)):
        if not _pow2_at_least_16(v):
            raise ValueError(f"triton tiles need {name} a power of two "
                             f">= 16, got {v}")
    if bw % sw:
        raise ValueError(f"sw ({sw}) must divide bw ({bw})")
    S = bw // sw
    G = group
    gp = next(g for g in (TILES_PER_PROGRAM, 2, 1) if G % g == 0)
    kc = min(k, K_CHUNK)

    def kernel(a_ref, b_ref, panel_ref, sub_ref, o_ref):
        t0 = pl.program_id(0) * gp
        step = t0 // G
        subs = [sub_ref[step * S + s] for s in range(S)]

        def tile(g, carry):
            row = panel_ref[t0 + g] * ph
            for s in range(S):
                acc = jnp.zeros((ph, sw), jnp.float32)
                for c in range(0, k, kc):
                    a = a_ref[pl.ds(row, ph), pl.ds(c, kc)]
                    b = b_ref[pl.ds(subs[s] * sw, sw), pl.ds(c, kc)]
                    acc += pl.dot(a, b, trans_b=True, precision=precision)
                o_ref[g, :, pl.ds(s * sw, sw)] = acc.astype(o_ref.dtype)
            return carry

        jax.lax.fori_loop(0, gp, tile, 0)

    def fn(A_perm: jax.Array, Bt: jax.Array, tile_panel: jax.Array,
           step_sub: jax.Array) -> jax.Array:
        T = tile_panel.shape[0]
        if T == 0:
            return jnp.zeros((0, ph, bw), out_dtype)
        npad = -Bt.shape[0] % sw
        if npad:
            Bt = jnp.pad(Bt, ((0, npad), (0, 0)))
        return pl.pallas_call(
            kernel,
            grid=(T // gp,),
            in_specs=[pl.no_block_spec] * 4,
            out_specs=pl.BlockSpec((gp, ph, bw), lambda i: (i, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((T, ph, bw), out_dtype),
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=num_warps, num_stages=num_stages),
            interpret=interpret,
            name="bsmr_tiles",
        )(A_perm, Bt, tile_panel, step_sub.reshape(-1))

    return fn
