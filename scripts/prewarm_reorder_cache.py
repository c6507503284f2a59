"""Prewarm the row-reordering disk cache for the replica suite.

Row clustering is the dominant host-side cost of a suite run and depends
only on (mask pattern, alpha, clustering knobs) — so when the device is
unavailable (or before a planned sweep) this script precomputes every
replica's reordering into the cache (`bsmr_sddmm_tpu.cache`), and the
suite's in-process run then skips straight to packing + device work.
The cached entry preserves the original clustering wall time, so RunLog
`bsmr_rowReordering` fields stay honest. It never touches the device.

Exits between units when a stop file appears.
"""
import argparse
import os
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--count", type=int, default=180)
    p.add_argument("--max-nnz", type=int, default=2_500_000)
    p.add_argument("--alphas", type=float, nargs="*", default=[0.1, 0.3])
    p.add_argument("--dataset-dir", default="logs/replica_dataset",
                   help="npz replica cache shared with the suite runner")
    p.add_argument("--stop-file", default="logs/prewarm.stop")
    args = p.parse_args()

    from bsmr_sddmm_tpu.cache import cached_row_reordering, load_reordering
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.replicas import make_replica_cached, select_suite

    cfg = SddmmConfig(k=128, panel_height=32, reorder_cache=True)
    specs = select_suite(count=args.count, max_nnz=args.max_nnz)
    done = 0
    for i, s in enumerate(specs):
        if os.path.exists(args.stop_file):
            print(f"stop file; {done} warmed, {i}/{len(specs)} visited")
            return 0
        t0 = time.time()
        csr = None
        for alpha in args.alphas:
            if csr is None:
                csr = make_replica_cached(s, args.dataset_dir)
            probe = load_reordering(csr, alpha, cfg)
            if probe is not None:
                continue
            reord = cached_row_reordering(csr, alpha, cfg)
            done += 1
            print(f"[{i+1}/{len(specs)}] {s.name} a={alpha}: "
                  f"{reord.num_clusters} clusters "
                  f"{reord.row_time_ms:.0f} ms "
                  f"(total {time.time()-t0:.1f}s)", flush=True)
    print(f"prewarm complete: {done} new entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
