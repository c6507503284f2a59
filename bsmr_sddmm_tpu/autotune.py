"""Cost-model delta selection.

The reference finds each matrix's best (alpha, delta) by running the full
sweep on hardware (scripts/run_BSMR.sh: 140 configurations per matrix).
Here a plan's runtime is priced as

    T_dense * (floor + step / G)  +  Tp * packed_tile  +  Tg * gathered_tile
      + E * pernnz  +  fixed dispatch

with per-device constants in :data:`COSTS`, keyed by ``device_kind`` and
fitted on that device by :func:`calibrate`. ``choose_delta`` packs a
handful of candidate deltas (vectorized NumPy, no device work) and
returns the argmin — one compiled executable instead of a hardware sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu.reorder import BsmrReordering, split_columns

#: Tier costs per ``jax.Device.device_kind``, each row fitted by
#: :func:`calibrate` on that device. Per-unit costs are affine in K
#: (``<tier>_base_ns + <tier>_k_ns * K``): each tier's bytes scale with K
#: while its launch and index terms do not. Keys:
#:
#: * ``dense_floor_*`` per dense BSR tile and ``dense_step_*`` per fat
#:   step of G tiles (fitted from G = 1 and G = 32 runs);
#: * ``packed_*`` per hot-column packed tile, ``gathered_*`` per
#:   gathered-column tile, ``pernnz_*`` per residual nonzero;
#: * ``fixed_us``: a near-empty plan's whole call;
#: * ``sampled_dot_tflops``: the dense-fallback tier's rate (XLA's
#:   sampled dense dot over the full M x N x K product).
#:
#: An optional ``serialize_residual_share`` is the residual-tier share of
#: the predicted time above which ``tier_serialize="auto"`` serializes a
#: plan; a row carries it only when it was measured on that device.
H100_KIND = "NVIDIA H100 80GB HBM3"

COSTS = {
    # calibrate() on one NVIDIA H100 80GB HBM3 at a 700 W power limit
    # (scripts/calibrate.py, PR 1)
    H100_KIND: dict(
        dense_floor_base_ns=15.630361838712563,
        dense_floor_k_ns=0.1077059636828532,
        dense_step_base_ns=0.0,
        dense_step_k_ns=0.49562952344905525,
        packed_base_ns=11.6334970012763,
        packed_k_ns=0.6245541060140027,
        gathered_base_ns=15.688251710093459,
        gathered_k_ns=0.44659977649699995,
        pernnz_base_ns=0.0,
        pernnz_k_ns=0.001227104974036151,
        fixed_us=14.815200000128925,
        sampled_dot_tflops=117.3414593072754),
}


def _affine(costs: dict, prefix: str, k: int) -> float:
    return costs[f"{prefix}_base_ns"] + costs[f"{prefix}_k_ns"] * k


def dense_tile_ns(costs: dict, k: int, group: int) -> float:
    """Predicted ns per dense BSR tile at fat group ``group``."""
    return (_affine(costs, "dense_floor", k)
            + _affine(costs, "dense_step", k) / max(group, 1))


def estimate_dense_ms(rows: int, cols: int, nnz: int, k: int,
                      costs: dict) -> float:
    """Predicted time for the dense-fallback tier: XLA's sampled dense
    dot computes the full M*N*K product with the mask extraction fused
    (the product is never materialized in device memory), so the cost
    is one flops term at the measured effective rate."""
    flops_ms = 2.0 * rows * cols * k / (costs["sampled_dot_tflops"] * 1e9)
    return flops_ms + costs["fixed_us"] / 1e3


def estimate_plan_ms(plan: TilePlan, costs: dict) -> float:
    """Predicted kernel time (rphm emit) for one packed plan. Every tier
    cost is affine in K, so one cost table prices all of K in
    {32..256}."""
    k = plan.k
    total_ns = (plan.tile_panel.shape[0]
                * dense_tile_ns(costs, k, plan.fat_group)
                + plan.num_packed * _affine(costs, "packed", k)
                + plan.num_gathered * _affine(costs, "gathered", k)
                + plan.num_residual * _affine(costs, "pernnz", k)
                + costs["fixed_us"] * 1e3)
    return total_ns / 1e6


DELTA_CANDIDATES = (0.002, 0.006, 0.02, 0.05, 0.15, 0.3)
#: the reference sweeps alpha in {.1,.3,.5,.7,.9} on hardware
#: (src/sddmm.cu:64); on our row clustering the .5+ perms are usually
#: identical to .5 (they get deduped by row_perm hash), so the priced set
#: mirrors bench.py's measured sweep
ALPHA_CANDIDATES = (0.1, 0.3, 0.5)


@dataclasses.dataclass
class DeltaChoice:
    delta: float
    estimated_ms: float
    plan: TilePlan
    candidates: dict  # delta -> estimated ms; key "dense" = fallback arm
    use_dense: bool = False   # dense-fallback tier beats every tiled plan


def choose_delta(csr: CSR, reord: BsmrReordering, config: SddmmConfig,
                 candidates: Sequence[float] = DELTA_CANDIDATES,
                 k: Optional[int] = None,
                 allow_dense: bool = True) -> DeltaChoice:
    """Pack each candidate delta (host-side only) and return the one with
    the lowest predicted kernel time, along with its plan.

    A fourth arm competes with every tiled plan: the dense-fallback tier
    (masked full matmul). On near-uniform masks dense enough that the
    full product's flops cost less than the tiles' bytes, it wins — the
    reference's hybrid-ablation insight (its TC-only column sometimes beats hybrid,
    scripts/results_suiteSparse_dataset/k32/results_hybrid_32.csv) taken
    to the matrix level. The (M, N) product streams in row blocks, so the
    arm is only offered when a tile_m-row block of the product fits
    comfortably (cols <= ~8M)."""
    import dataclasses as _dc
    k_eff = config.k if k is None else k
    costs = current_costs()
    best: Optional[Tuple[float, float, TilePlan]] = None
    table = {}
    # the packed tier competes per matrix (it pays on hub-heavy masks and
    # not where the residual is singleton-dominated), so every delta is
    # priced with the tier on AND off
    subs = ((config.subpack_min_nnz, 0) if config.subpack_min_nnz
            else (0,))
    for d in candidates:
        r = split_columns(csr, _dc.replace(reord), config, delta=d)
        for sub in subs:
            plan = pack_tiles(csr, r, config.replace(subpack_min_nnz=sub),
                              k=k, costs=costs)
            ms = estimate_plan_ms(plan, costs)
            table[(d, sub)] = ms
            if best is None or ms < best[1]:
                best = (d, ms, plan)
    use_dense = False
    if allow_dense and csr.cols <= (1 << 23):
        dense_ms = estimate_dense_ms(csr.rows, csr.cols, csr.nnz, k_eff,
                                     costs)
        table["dense"] = dense_ms
        if dense_ms < best[1]:
            use_dense = True
            return DeltaChoice(delta=best[0], estimated_ms=dense_ms,
                               plan=best[2], candidates=table,
                               use_dense=True)
    return DeltaChoice(delta=best[0], estimated_ms=best[1], plan=best[2],
                       candidates=table, use_dense=use_dense)


@dataclasses.dataclass
class ConfigChoice:
    """Argmin of the priced (alpha, delta, subpack) grid."""
    alpha: float
    delta: float
    subpack: int
    estimated_ms: float
    plan: TilePlan
    candidates: dict   # (alpha, delta, subpack) -> ms; "dense" = fallback
    use_dense: bool = False


def choose_config(csr: CSR, row_reorder_fn, config: SddmmConfig,
                  alphas: Sequence[float] = ALPHA_CANDIDATES,
                  candidates: Sequence[float] = DELTA_CANDIDATES,
                  k: Optional[int] = None,
                  allow_dense: bool = True,
                  refine_top: int = 0) -> ConfigChoice:
    """Price the full (alpha, delta, subpack) grid host-side and return
    the argmin — the autotuned equivalent of the reference's alpha x
    delta test-mode hardware sweep (src/sddmm.cu:64-66), with alpha in
    the choice set (round-3 autotuning swept alpha only externally).

    ``row_reorder_fn(alpha)`` supplies the row clustering (cached
    upstream: BsmrSddmm._row_reordering / cache.cached_row_reordering —
    clustering dominates preprocessing, so the caller owns the cache).
    Alphas whose row permutation equals an already-priced alpha's are
    skipped: identical perms mean identical plans at every delta (banded
    matrices cluster the same at every alpha).

    ``refine_top=N`` (N >= 2, device runs only) re-times candidate
    plans IN-PROGRAM on the device and picks the measured argmin. The
    affine sum-of-tiers model cannot see how the fused XLA schedule
    overlaps the tiers; measured refinement is the reference's own
    answer (its test mode times every config on hardware,
    src/sddmm.cu:62-118) at a fraction of the sweep cost. The candidate
    set is DIVERSIFIED, not top-N-by-estimate: the union of the
    best-priced plan per (delta, subpack) family and the best-priced
    plan per alpha, capped at N by estimate order, because the model's
    bias is not confined to one axis. The dense-fallback arm still
    competes by estimate only."""
    import dataclasses as _dc
    k_eff = config.k if k is None else k
    costs = current_costs()
    subs = ((config.subpack_min_nnz, 0) if config.subpack_min_nnz
            else (0,))
    table = {}
    # per-(delta, sub) family best: family -> (ms, alpha, delta, sub, plan)
    fam_best = {}
    seen_perms = set()
    for alpha in alphas:
        reord = row_reorder_fn(alpha)
        perm_key = hash(reord.row_perm.tobytes())
        if perm_key in seen_perms:
            continue
        seen_perms.add(perm_key)
        for d in candidates:
            r = split_columns(csr, _dc.replace(reord), config, delta=d)
            for sub in subs:
                plan = pack_tiles(
                    csr, r, config.replace(subpack_min_nnz=sub), k=k,
                    costs=costs)
                ms = estimate_plan_ms(plan, costs)
                table[(alpha, d, sub)] = ms
                # without refinement only the global best plan is
                # retained (memory: plans are the big objects); with it,
                # the per-family and per-alpha bests stay alive for the
                # measured pass
                if refine_top >= 2:
                    fams = ((d, sub), ("alpha", alpha))
                else:
                    fams = ("best",)
                for fam in fams:
                    cur = fam_best.get(fam)
                    if cur is None or ms < cur[0]:
                        fam_best[fam] = (ms, alpha, d, sub, plan)
    # union-dedup (one plan can head several families)
    uniq = {}
    for entry in fam_best.values():
        uniq[entry[1:4]] = entry
    kept = sorted(uniq.values(), key=lambda t: t[0])
    if refine_top >= 2 and len(kept) >= 2:
        measured = _refine_measure(kept[:int(refine_top)], config, k_eff)
        if measured:   # (ms, alpha, d, sub, plan) by measured time
            for ms, alpha, d, sub, _ in measured:
                table[("measured", alpha, d, sub)] = ms
            kept = measured + kept[int(refine_top):]
    best = kept[0]
    use_dense = False
    estimated = best[0]
    if allow_dense and csr.cols <= (1 << 23):
        dense_ms = estimate_dense_ms(csr.rows, csr.cols, csr.nnz, k_eff,
                                     costs)
        table["dense"] = dense_ms
        if dense_ms < best[0]:
            use_dense = True
            estimated = dense_ms
    return ConfigChoice(alpha=best[1], delta=best[2], subpack=best[3],
                        estimated_ms=estimated, plan=best[4],
                        candidates=table, use_dense=use_dense)


def _refine_measure(kept, config: SddmmConfig, k: int):
    """Time each candidate plan in-program on the device; return the
    list re-sorted by measured ms, or None on the CPU backend (tests:
    there is nothing to measure, and the estimate ordering is kept). A
    candidate that fails to compile or run raises."""
    import jax
    if jax.default_backend() == "cpu":
        return None
    import jax.numpy as jnp

    from bsmr_sddmm_tpu.formats import make_dense
    from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_body
    from bsmr_sddmm_tpu.utils.timing import time_rphm_inprogram
    # operands: deterministic fills at the plan's shapes (timing is
    # value-independent)
    plan0 = kept[0][4]
    m, n = plan0.rows, plan0.cols
    A = jnp.asarray(make_dense(m, k, seed=1337))
    Bt = jnp.asarray(make_dense(k, n, seed=1338).T.copy())
    out = []
    for _, alpha, d, sub, plan in kept:
        cfg = config.replace(subpack_min_nnz=sub)
        body = make_sddmm_body(plan, cfg, None, emit="rphm")
        ms = time_rphm_inprogram(
            body, A, Bt, device_plan(plan, emit="rphm"),
            iterations=max(4, config.num_iterations // 2))
        out.append((ms, alpha, d, sub, plan))
    out.sort(key=lambda t: t[0])
    return out


# ---------------------------------------------------------------------------
# Per-device tables
# ---------------------------------------------------------------------------

#: tables installed at run time (calibrate(), or a test's explicit table),
#: keyed by device_kind; they take precedence over COSTS
_INSTALLED: dict = {}


def _device_kind() -> str:
    import jax
    return jax.devices()[0].device_kind


def install_costs(costs: dict, device_kind: Optional[str] = None) -> None:
    """Make ``costs`` the table for ``device_kind`` (default: the current
    device) in this process."""
    _INSTALLED[device_kind or _device_kind()] = dict(costs)


def current_costs(device_kind: Optional[str] = None) -> dict:
    """The cost table of ``device_kind`` (default: the current device):
    an installed table, else the committed :data:`COSTS` row. A device
    with neither raises — prices from another machine predict nothing;
    run :func:`calibrate` on it and commit the row."""
    kind = device_kind or _device_kind()
    if kind in _INSTALLED:
        return _INSTALLED[kind]
    if kind in COSTS:
        return COSTS[kind]
    raise KeyError(
        f"no cost table for device kind {kind!r} (have "
        f"{sorted(COSTS)}); run bsmr_sddmm_tpu.autotune.calibrate() on "
        f"it and add the row to autotune.COSTS")


def serialize_threshold(device_kind: Optional[str] = None
                        ) -> Optional[float]:
    """The measured ``serialize_residual_share`` of the device's table
    row, or None when the device has no such measurement."""
    kind = device_kind or _device_kind()
    row = _INSTALLED.get(kind) or COSTS.get(kind) or {}
    return row.get("serialize_residual_share")


CALIBRATION_KS = (32, 128)
#: fat groups the dense tier is timed at to separate floor from step
CALIBRATION_GROUPS = (1, 32)


def calibrate(ks=CALIBRATION_KS) -> dict:
    """Fit every entry of a :data:`COSTS` row on the current device.

    Each tier is timed alone (``only_tier``) on a small synthetic plan
    at each K in ``ks`` and fitted as base + slope*K; the dense tier is
    timed at each fat group in :data:`CALIBRATION_GROUPS` to separate
    the per-tile floor from the per-step term. ``fixed_us`` is a
    near-empty plan's whole call and ``sampled_dot_tflops`` the dense
    fallback's rate on a uniform mask. Returns the row and installs it
    for this process."""
    import numpy as _np

    import jax
    import jax.numpy as jnp

    from bsmr_sddmm_tpu.baselines import make_bcoo_fn
    from bsmr_sddmm_tpu.formats import make_dense, random_mask
    from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_body
    from bsmr_sddmm_tpu.reorder import bsmr
    from bsmr_sddmm_tpu.utils.timing import (time_jitted,
                                             time_tier_inprogram)

    def operands(csr, k):
        return (jnp.asarray(make_dense(csr.rows, k, seed=1)),
                jnp.asarray(make_dense(csr.cols, k, seed=2)))

    def tier_ms(csr, config, tier, k, group=1):
        # explicit fat groups: packing must not price with the table
        # this run is fitting
        config = config.replace(k=k)
        reord = bsmr(csr, config)
        plan = pack_tiles(csr, reord, config, fat_group_override=group)
        body = make_sddmm_body(plan, config, only_tier=tier)
        A, Bt = operands(csr, k)
        return time_tier_inprogram(body, A, Bt, device_plan(plan)), plan

    def fit(pairs):
        """pairs: [(k, per_unit_ns)] -> (base, slope), both >= 0."""
        karr = _np.array([p[0] for p in pairs], float)
        varr = _np.array([p[1] for p in pairs], float)
        if len(pairs) == 1:
            return max(float(varr[0]), 0.0), 0.0
        slope, base = _np.polyfit(karr, varr, 1)
        return max(float(base), 0.0), max(float(slope), 0.0)

    costs = {}
    cfg = SddmmConfig(k=128, panel_height=32)

    # 1. dense BSR tiles: blocky mask, everything tiled; per-tile time at
    # G = g is floor + step / g
    csr_d = random_mask(8192, 8192, 1_000_000, seed=3, block_rows=32,
                        block_cols=256, block_fill=0.8)
    cfg_d = cfg.replace(delta=0.02, subpack_min_nnz=0)
    floor_pairs, step_pairs = [], []
    for k in ks:
        per = {}
        for g in CALIBRATION_GROUPS:
            ms, plan = tier_ms(csr_d, cfg_d, "dense", k, group=g)
            per[g] = ms * 1e6 / plan.tile_panel.shape[0]
        g_lo, g_hi = CALIBRATION_GROUPS
        step = max((per[g_lo] - per[g_hi]) / (1 / g_lo - 1 / g_hi), 0.0)
        floor_pairs.append((k, max(per[g_hi] - step / g_hi, 0.0)))
        step_pairs.append((k, step))
    costs["dense_floor_base_ns"], costs["dense_floor_k_ns"] = \
        fit(floor_pairs)
    costs["dense_step_base_ns"], costs["dense_step_k_ns"] = fit(step_pairs)

    def per_unit(csr, config, tier, units_of):
        pairs = []
        for k in ks:
            ms, plan = tier_ms(csr, config, tier, k)
            pairs.append((k, ms * 1e6 / max(units_of(plan), 1)))
        return fit(pairs)

    # 2. packed sub-block tiles: block mask below the BSR threshold
    csr_p = random_mask(8192, 8192, 500_000, seed=5, block_rows=32,
                        block_cols=32, block_fill=0.6)
    cfg_p = cfg.replace(delta=1.1, residual_tile_min_nnz=1 << 30)
    costs["packed_base_ns"], costs["packed_k_ns"] = per_unit(
        csr_p, cfg_p, "packed", lambda p: p.sp_panel.shape[0])
    # 3. gathered tiles: uniform-ish mask, low tile cutoff, subpack off
    csr_g = random_mask(8192, 8192, 600_000, seed=4)
    cfg_g = cfg.replace(delta=0.02, residual_tile_min_nnz=16,
                        subpack_min_nnz=0)
    costs["gathered_base_ns"], costs["gathered_k_ns"] = per_unit(
        csr_g, cfg_g, "gathered", lambda p: p.g_panel.shape[0])
    # 4. per-nnz residual
    cfg_r = cfg.replace(delta=1.1, residual_mode="pernnz",
                        subpack_min_nnz=0)
    costs["pernnz_base_ns"], costs["pernnz_k_ns"] = per_unit(
        csr_g, cfg_r, "residual", lambda p: p.res_arow.shape[0])

    # 5. fixed cost: the whole call of a near-empty plan
    csr_0 = random_mask(256, 256, 64, seed=6)
    plan0 = pack_tiles(csr_0, bsmr(csr_0, cfg), cfg, fat_group_override=1)
    A0, Bt0 = operands(csr_0, 128)
    ms0, _ = time_jitted(jax.jit(make_sddmm_body(plan0, cfg, emit="rphm")),
                         A0, Bt0, device_plan(plan0, emit="rphm"))
    costs["fixed_us"] = ms0 * 1e3

    # 6. dense fallback: sampled dense dot on a uniform mask
    csr_u = random_mask(8192, 8192, 400_000, seed=7)
    A_u, Bt_u = operands(csr_u, 128)
    ms_u, _ = time_jitted(make_bcoo_fn(csr_u, 128), A_u, Bt_u)
    costs["sampled_dot_tflops"] = (2.0 * csr_u.rows * csr_u.cols * 128
                                   / (ms_u * 1e9))

    install_costs(costs)
    return costs
