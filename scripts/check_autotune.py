"""Autotune-vs-sweep-best check.

For each bench-suite matrix and K, compare the cost model's pick
(autotune.choose_delta at alpha=0.3 over the bench config grid) against
the MEASURED best from a bench sweep log (the ``# name a=.. d=.. k=..:
G GFLOPS`` stderr lines bench.py emits). Reports, per (matrix, K), the
measured throughput of the chosen config as a fraction of the measured
sweep best — the reference analogue is picking delta by on-hardware
sweep (scripts/test_script.sh); here it is the calibrated cost model,
and this script quantifies how much it leaves on the table.

Host-only (packing + prediction); prices with the H100 cost-table row
(autotune.COSTS).
"""
import argparse
import collections
import json
import re
import sys

PAT = re.compile(r"# (\S+) a=([\d.]+) d=([\d.]+) k=(\d+): (\d+) GFLOPS")
# bench.py CONFIGS order within one (matrix, alpha, K) group
BENCH_CONFIGS = ((0.002, 0), (0.006, 0), (0.002, 12), (0.02, 12))


def parse_log(path):
    """-> {(name, k): {(alpha, delta, sub): gflops}}"""
    runs = collections.defaultdict(dict)
    seen = collections.Counter()
    for ln in open(path):
        m = PAT.match(ln)
        if not m:
            continue
        name, a, d, k, gf = (m.group(1), float(m.group(2)),
                             float(m.group(3)), int(m.group(4)),
                             float(m.group(5)))
        idx = seen[(name, a, k)]
        seen[(name, a, k)] += 1
        _, sub = BENCH_CONFIGS[idx % len(BENCH_CONFIGS)]
        runs[(name, k)][(a, d, sub)] = gf
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("log", help="bench.py stderr log with sweep lines")
    p.add_argument("--ks", type=int, nargs="*", default=[32, 128])
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--auto-alpha", action="store_true",
                   help="check autotune.choose_config (alpha IN the "
                        "choice set) against the sweep best over ALL "
                        "alphas, instead of fixed-alpha choose_delta")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from bsmr_sddmm_tpu.utils.hostmem import tune_malloc
    tune_malloc()   # packing is allocation-bound (utils/hostmem.py)
    from bsmr_sddmm_tpu import autotune
    from bsmr_sddmm_tpu.autotune import choose_config, choose_delta
    # host-only: price with the H100 row whatever this host is
    autotune.install_costs(autotune.COSTS[autotune.H100_KIND])
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.datasets import SUITE
    from bsmr_sddmm_tpu.sddmm import BsmrSddmm

    runs = parse_log(args.log)
    names = {n for n, _ in runs}
    rows = []
    for name, gen in SUITE:
        if name not in names:
            continue
        csr = gen()
        pipe = BsmrSddmm(csr, SddmmConfig(k=128, panel_height=32,
                                          subpack_min_nnz=12,
                                          reorder_cache=True))
        base = pipe._row_reordering(args.alpha)
        for k in args.ks:
            sweep = runs.get((name, k), {})
            if args.auto_alpha:
                # alpha in the choice set: compare choose_config's
                # (alpha, delta, sub) pick to the sweep best over the
                # ENTIRE measured grid (alphas the sweep deduped away
                # are excluded from both sides)
                cands = dict(sweep)
                if not cands:
                    continue
                choice = choose_config(
                    csr, pipe._row_reordering, pipe.config,
                    alphas=sorted({a for a, _, _ in cands}),
                    candidates=sorted({d for _, d, _ in cands}),
                    k=k, allow_dense=False)
                picked = (choice.alpha, choice.plan.delta_used,
                          12 if choice.plan.num_packed else 0)
            else:
                # restrict to this alpha and the bench config grid
                cands = {(d, s): g for (a, d, s), g in sweep.items()
                         if a == args.alpha}
                if not cands:
                    continue
                choice = choose_delta(
                    csr, base, pipe.config,
                    candidates=sorted({d for d, _ in cands}),
                    k=k, allow_dense=False)
                picked = (choice.plan.delta_used,
                          12 if choice.plan.num_packed else 0)
            best_cfg = max(cands, key=cands.get)
            got = cands.get(picked)
            rows.append({"matrix": name, "k": k,
                         "picked": list(picked),
                         "picked_gflops": got,
                         "best": list(best_cfg),
                         "best_gflops": cands[best_cfg],
                         "fraction": (round(got / cands[best_cfg], 3)
                                      if got else None)})
            print(f"{name} k={k}: picked {picked} "
                  f"-> {got} GFLOPS; sweep best {best_cfg} "
                  f"-> {cands[best_cfg]} "
                  f"({rows[-1]['fraction']})", flush=True)
    fr = [r["fraction"] for r in rows if r["fraction"]]
    summary = {"mean_fraction": round(sum(fr) / max(len(fr), 1), 3),
               "min_fraction": min(fr, default=None), "rows": rows}
    print(json.dumps({k: summary[k] for k in
                      ("mean_fraction", "min_fraction")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
