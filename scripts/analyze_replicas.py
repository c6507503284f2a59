"""Analyze the replica-suite logs into the reference's results CSV shape
(file,M,N,NNZ,Sparsity,K,BSMR,<baselines>) plus a per-matrix comparison
against the reference's committed RTX-4090 best-BSMR numbers.

Usage: analyze_replicas.py [log_dir [out_dir [K]]]; writes
<out_dir>/results_<K>.csv and prints geomeans + accuracy.
"""
import csv
import glob
import json
import os
import sys

import numpy as np

from bsmr_sddmm_tpu.bench.analyze import best_per_matrix, parse_log_files
from bsmr_sddmm_tpu.replicas import load_manifest


def main() -> int:
    log_dir = sys.argv[1] if len(sys.argv) > 1 else "logs/replica_logs"
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "logs"
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 128
    results = parse_log_files(sorted(glob.glob(os.path.join(log_dir,
                                                            "*.log"))))
    best = best_per_matrix(results)
    ref = {s.name: s for s in load_manifest()}
    # fp16-emission arm logs live in a sibling dir so the analyzer never
    # mixes them into the fp32 bsmr method (run_replica_suite --fp16-arm)
    fp16_results = parse_log_files(sorted(glob.glob(
        os.path.join(log_dir + "_fp16", "*.log"))))
    fp16_best = best_per_matrix(fp16_results)

    methods = sorted({m for (_, kk, m) in best if kk == k})
    files = sorted({f for (f, kk, _) in best if kk == k})
    rows = []
    for f in files:
        name = f.removesuffix(".mtx")
        spec = ref.get(name)
        r = best.get((f, k, "bsmr"))
        row = {
            "file": f,
            "M": r.m if r else (spec.m if spec else 0),
            "N": r.n if r else (spec.n if spec else 0),
            "NNZ": r.nnz if r else (spec.nnz if spec else 0),
            "Sparsity": (f"{(1 - r.nnz / (r.m * r.n)) * 100:.2f}%"
                         if r and r.m and r.n else ""),
            "K": k,
            "regime": spec.regime if spec else "",
        }
        for m in methods:
            rm = best.get((f, k, m))
            row[m] = round(rm.gflops, 2) if rm else ""
        r16 = fp16_best.get((f, k, "bsmr"))
        if r16:
            row["bsmr_fp16"] = round(r16.gflops, 2)
        row["ref_bsmr_rtx4090"] = (spec.ref_bsmr_gflops.get(k, "")
                                   if spec else "")
        if r and spec and spec.ref_bsmr_gflops.get(k):
            row["vs_ref"] = round(r.gflops / spec.ref_bsmr_gflops[k], 4)
        rows.append(row)

    os.makedirs(out_dir, exist_ok=True)
    cols = (["file", "M", "N", "NNZ", "Sparsity", "K", "regime"]
            + methods + (["bsmr_fp16"] if fp16_best else [])
            + ["ref_bsmr_rtx4090", "vs_ref"])
    csv_path = os.path.join(out_dir, f"results_{k}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)

    def geomean(xs):
        xs = [x for x in xs if isinstance(x, (int, float)) and x > 0]
        return float(np.exp(np.mean(np.log(xs)))) if xs else 0.0

    summary = {"n_matrices": len(rows), "k": k}
    for m in methods + ["ref_bsmr_rtx4090"]:
        vals = [r.get(m) for r in rows
                if isinstance(r.get(m), (int, float))]
        summary[f"geomean_{m}"] = round(geomean(vals), 1)
        summary[f"n_{m}"] = len(vals)
    # speedups on MATCHED subsets only (round-2 weakness: quoting a
    # 5-matrix bcoo geomean against a 33-matrix bsmr geomean): geomean
    # of per-matrix ratios over matrices where BOTH methods ran
    for m in methods:
        if m == "bsmr":
            continue
        ratios = [r["bsmr"] / r[m] for r in rows
                  if isinstance(r.get("bsmr"), (int, float))
                  and isinstance(r.get(m), (int, float)) and r[m] > 0]
        summary[f"speedup_bsmr_vs_{m}"] = round(geomean(ratios), 2)
        summary[f"n_matched_{m}"] = len(ratios)
    summary["geomean_vs_ref"] = round(geomean([r.get("vs_ref")
                                               for r in rows]), 4)
    # accuracy
    n_checked = sum(1 for r in results
                    if r.method == "bsmr" and r.k == k
                    and r.check_result in ("pass", "fail"))
    n_pass = sum(1 for r in results if r.method == "bsmr" and r.k == k
                 and r.check_result == "pass")
    summary["bsmr_accuracy"] = (round(n_pass / n_checked, 4)
                                if n_checked else None)
    # fp16-emission arm: matched-subset speedup vs the fp32 best config
    # + its own oracle accuracy (every fp16 run is validated)
    if fp16_best:
        r16s = [(r.get("bsmr_fp16"), r.get("bsmr")) for r in rows]
        pairs = [(a, b) for a, b in r16s
                 if isinstance(a, (int, float))
                 and isinstance(b, (int, float)) and b > 0]
        summary["geomean_bsmr_fp16"] = round(
            geomean([a for a, _ in pairs]), 1)
        summary["speedup_fp16_vs_fp32"] = round(
            geomean([a / b for a, b in pairs]), 3)
        summary["n_matched_fp16"] = len(pairs)
        n16 = sum(1 for r in fp16_results
                  if r.method == "bsmr" and r.k == k
                  and r.check_result in ("pass", "fail"))
        p16 = sum(1 for r in fp16_results
                  if r.method == "bsmr" and r.k == k
                  and r.check_result == "pass")
        summary["fp16_accuracy"] = (round(p16 / n16, 4) if n16 else None)
    # per-regime
    for regime in ("mesh", "opt", "graph"):
        sub = [r for r in rows if r.get("regime") == regime]
        summary[f"geomean_bsmr_{regime}"] = round(
            geomean([r.get("bsmr") for r in sub]), 1)
        summary[f"n_{regime}"] = len(sub)
    with open(os.path.join(out_dir, f"summary_{k}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print("wrote", csv_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
