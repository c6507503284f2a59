"""Multi-device SDDMM: row-panel sharding over a JAX mesh.

This layer is *new work* relative to the reference, which is strictly
single-GPU (SURVEY.md section 2d: no NCCL/MPI anywhere). The scaling design
follows the BASELINE.json north star: row panels of the reordered mask are
split into contiguous, nnz-balanced ranges, each range is packed
*independently* (pack.pack_shard_plans) so every shard keeps fat dense
steps and its own gathered/residual tiers, and each device runs the full
hybrid body on its own shard.

The hot path has NO combine step: the natural output of the sharded SDDMM
is the sharded rphm layout (each device holds its own panels' tiles),
which the tile-native SpMM/softmax consumers read in place. CSR-order
emission is one gather along a precomputed global map; under jit, GSPMD
inserts the all-gather it implies.

Everything compiles under ``jax.sharding.Mesh`` + ``shard_map``, so the
same code runs on N GPUs (collectives through NCCL) or on a virtual CPU
mesh (tests, __graft_entry__.dryrun_multichip)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.ops.sddmm import (DevicePlan, make_sddmm_body)
from bsmr_sddmm_tpu.pack import TilePlan, pack_shard_plans
from bsmr_sddmm_tpu.reorder import BsmrReordering

AXIS = "panels"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[list] = None) -> Mesh:
    """1-D mesh over the row-panel axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def put_global(arr, sharding) -> jax.Array:
    """Place a host-replicated numpy/jax array with ``sharding``. In a
    single process this is ``jax.device_put``; in a multi-process run
    (jax.distributed) the sharding spans non-addressable devices, so the
    global array is assembled from each process's local shards via
    ``jax.make_array_from_callback`` (every process holds the full host
    value — plans are packed deterministically everywhere)."""
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    np_arr = np.asarray(arr)
    return jax.make_array_from_callback(
        np_arr.shape, sharding, lambda idx: np_arr[idx])


def _pad_leading(arr: np.ndarray, mult: int, fill) -> np.ndarray:
    n = arr.shape[0]
    target = -(-n // mult) * mult
    if target == n:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_device_plan(plan: TilePlan, mesh: Mesh) -> DevicePlan:
    """GSPMD-style sharding of a single global plan's arrays: leading dims
    sharded over the mesh, permutation/emission maps replicated. This is
    the *data-parallel annotation* used by model forwards (the XLA
    partitioner decides the collectives); the explicitly-programmed
    multi-chip execution path is :func:`make_sharded_sddmm`."""
    n = mesh.devices.size
    sharded = NamedSharding(mesh, P(AXIS))
    repl = NamedSharding(mesh, P())

    def put(arr, spec):
        return put_global(arr, spec)

    if plan.mode != "bsr":
        tile_src = plan.tile_cols
    elif plan.fat_group > 1:
        tile_src = plan.step_cblock
    else:
        tile_src = plan.tile_cblock
    return DevicePlan(
        row_perm_padded=put(plan.row_perm_padded, repl),
        tile_panel=put(_pad_leading(plan.tile_panel, n, 0), sharded),
        tile_src=put(_pad_leading(tile_src, n, 0), sharded),
        tile_scatter=put(_pad_leading(plan.tile_scatter, n, plan.nnz),
                         sharded),
        sp_panel=put(_pad_leading(plan.sp_panel, n, 0), sharded),
        sp_sub=put(_pad_leading(plan.sp_sub, n, 0), sharded),
        sp_scatter=put(_pad_leading(plan.sp_scatter, n, plan.nnz),
                       sharded),
        sp_colperm=put(plan.sp_colperm, repl),
        g_panel=put(_pad_leading(plan.g_panel, n, 0), sharded),
        g_cols=put(_pad_leading(plan.g_cols, n,
                                max(plan.cols - 1, 0)), sharded),
        g_scatter=put(_pad_leading(plan.g_scatter, n, plan.nnz), sharded),
        res_arow=put(_pad_leading(plan.res_arow, n, 0), sharded),
        res_col=put(_pad_leading(plan.res_col, n, 0), sharded),
        res_out=put(_pad_leading(plan.res_out, n, plan.nnz), sharded),
        rphm_to_csr=put(plan.rphm_to_csr, repl),
    )


def shard_operands(A, Bt, mesh: Mesh, b_sharded: bool = False):
    """Place the dense operands for the sharded SDDMM: A is replicated
    (every shard owns whole row panels of the mask and needs its own A
    rows; replication is the row-shard-natural layout — SURVEY.md section
    2d); Bt is either replicated or row-sharded (= column panels of B)
    for the all-gather path."""
    repl = NamedSharding(mesh, P())
    if b_sharded and Bt.shape[0] % mesh.devices.size:
        raise ValueError(
            f"b_sharded needs N ({Bt.shape[0]}) divisible by the mesh "
            f"size ({mesh.devices.size}); pad B's columns first")
    b_spec = NamedSharding(mesh, P(AXIS)) if b_sharded else repl
    return put_global(A, repl), put_global(Bt, b_spec)


def _stack_shard_dplans(plans, mesh: Mesh) -> DevicePlan:
    """Concatenate per-shard plan arrays along the leading dim and place
    each with that dim sharded — shard_map then hands every device exactly
    its own shard's arrays."""
    sharded = NamedSharding(mesh, P(AXIS))
    repl = NamedSharding(mesh, P())

    def stack(name, fill=None):
        if name == "tile_src":
            arrs = []
            for p in plans:
                if p.mode != "bsr":
                    arrs.append(p.tile_cols)
                elif p.fat_group > 1:
                    arrs.append(p.step_cblock)
                else:
                    arrs.append(p.tile_cblock)
        else:
            arrs = [getattr(p, name) for p in plans]
        return put_global(np.concatenate(arrs, axis=0), sharded)

    return DevicePlan(
        row_perm_padded=stack("row_perm_padded"),
        tile_panel=stack("tile_panel"),
        tile_src=stack("tile_src"),
        tile_scatter=stack("tile_scatter"),
        sp_panel=stack("sp_panel"),
        sp_sub=stack("sp_sub"),
        sp_scatter=stack("sp_scatter"),
        sp_colperm=stack("sp_colperm"),
        g_panel=stack("g_panel"),
        g_cols=stack("g_cols"),
        g_scatter=stack("g_scatter"),
        res_arow=stack("res_arow"),
        res_col=stack("res_col"),
        res_out=stack("res_out"),
        rphm_to_csr=put_global(np.zeros(0, np.int32), repl),
    )


def sharded_rphm_to_csr(plans) -> np.ndarray:
    """Global map: CSR value index -> offset in the stacked sharded rphm
    layout ``concat(dense_all.ravel(), gathered_all.ravel(), res_all)``.
    Every CSR index is owned by exactly one shard (panels partition
    rows), so the map is a bijection onto a subset of slots."""
    nnz = plans[0].nnz
    n = len(plans)
    ph, bw = plans[0].panel_height, plans[0].block_width
    T = plans[0].tile_panel.shape[0]
    Tp = plans[0].sp_panel.shape[0]
    Tg = plans[0].g_panel.shape[0]
    E = plans[0].res_arow.shape[0]
    # stacked four-tier layout: [dense_all | packed_all | gathered_all |
    # res_all], each tier stacked shard-major
    base_p = n * T * ph * bw
    base_g = base_p + n * Tp * ph * bw
    base_r = base_g + n * Tg * ph * bw
    assert base_r + n * E < np.iinfo(np.int32).max
    out = np.zeros(nnz, np.int64)
    for s, p in enumerate(plans):
        ts = p.tile_scatter.reshape(-1)
        m = ts < nnz
        out[ts[m]] = np.nonzero(m)[0] + s * T * ph * bw
        sp = p.sp_scatter.reshape(-1)
        m = sp < nnz
        out[sp[m]] = np.nonzero(m)[0] + base_p + s * Tp * ph * bw
        gs = p.g_scatter.reshape(-1)
        m = gs < nnz
        out[gs[m]] = np.nonzero(m)[0] + base_g + s * Tg * ph * bw
        m = p.res_out < nnz
        out[p.res_out[m]] = np.nonzero(m)[0] + base_r + s * E
    return out.astype(np.int32)


def make_sharded_sddmm(csr: CSR, reord: BsmrReordering,
                       config: SddmmConfig, mesh: Mesh,
                       k: Optional[int] = None,
                       backend: Optional[str] = None,
                       b_sharded: bool = False,
                       emit: str = "rphm"
                       ) -> Tuple[Callable, DevicePlan, list]:
    """Build the explicitly-sharded hybrid SDDMM.

    Returns ``(fn, dplan, shard_plans)`` with ``fn(A, Bt, dplan)``:

    * ``emit="rphm"`` (the hot path): each device computes its own
      panels' dense/gathered/residual outputs — fat steps intact, zero
      collectives with replicated operands (one all_gather of B when
      ``b_sharded``). Output arrays are mesh-sharded along tiles.
    * ``emit="csr"``: the rphm outputs flow through one gather along the
      precomputed global map (GSPMD inserts the implied all-gather) and
      come back replicated in original CSR value order.

    ``b_sharded=True`` stores B column panels 1/n per device (the
    memory-scalable layout for large B) and all-gathers them inside the
    mapped body.
    """
    n = mesh.devices.size
    plans = pack_shard_plans(csr, reord, config, n, k=k)
    dplan = _stack_shard_dplans(plans, mesh)
    body = make_sddmm_body(plans[0], config, backend, emit="rphm")
    nnz = csr.nnz

    def shard_body(A, Bt, dplan):
        if b_sharded:
            # (N/n, K) shard -> full (N, K): one all-gather
            Bt = jax.lax.all_gather(Bt, AXIS, axis=0, tiled=True)
        return body(A, Bt, dplan)

    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P(AXIS) if b_sharded else P(),
                  DevicePlan(row_perm_padded=P(AXIS),
                             tile_panel=P(AXIS), tile_src=P(AXIS),
                             tile_scatter=P(AXIS),
                             sp_panel=P(AXIS), sp_sub=P(AXIS),
                             sp_scatter=P(AXIS), sp_colperm=P(AXIS),
                             g_panel=P(AXIS), g_cols=P(AXIS),
                             g_scatter=P(AXIS),
                             res_arow=P(AXIS), res_col=P(AXIS),
                             res_out=P(AXIS), rphm_to_csr=P())),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
    )

    if emit == "rphm":
        return jax.jit(mapped), dplan, plans

    if emit != "csr":
        raise ValueError(f"unknown emit {emit!r}")
    csr_map = jnp.asarray(sharded_rphm_to_csr(plans))

    def fn(A, Bt, dplan):
        d, p, g, r = mapped(A, Bt, dplan)
        big = jnp.concatenate([d.reshape(-1), p.reshape(-1),
                               g.reshape(-1), r])
        return jnp.take(big, csr_map)

    return jax.jit(fn), dplan, plans
