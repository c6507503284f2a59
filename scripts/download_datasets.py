"""Dataset acquisition: fetch the reference's evaluation datasets.

The analogue of the reference's acquisition scripts
(scripts/download_suiteSparse_dataset.sh — wget loop over
sparse.tamu.edu/MM/<group>/<name>.tar.gz; download_dlmc_dataset.sh —
clone of the DLMC pruned-transformer set plus smtx->mtx conversion;
download_matrix_from_suiteSparse.py). The 503-matrix target list ships
in-repo (bsmr_sddmm_tpu/data/suitesparse_replicas.csv carries every
name/group the reference's committed results cover), so this script
needs no scraping: it resolves each manifest row to its SuiteSparse
collection URL, downloads, extracts the .mtx, then applies the
reference's validity filter (datatools.filter_dataset: m,n >= 10000,
nnz >= 100000) and writes matrices_list.txt.

This environment has zero egress; the network step is injectable
(``--help`` works offline, tests pass a local fetcher) and a failed
download reports cleanly instead of stack-tracing.

Usage:
  python scripts/download_datasets.py suitesparse --dest DIR [--limit N]
  python scripts/download_datasets.py dlmc --dest DIR [--repo URL]
"""
import argparse
import os
import sys
import tarfile
import tempfile
import urllib.error
import urllib.request

SUITESPARSE_URL = "https://sparse.tamu.edu/MM/{group}/{name}.tar.gz"
DLMC_REPO = "https://github.com/CX9898/dlmc-dataset.git"


def _default_fetch(url: str, dest_path: str) -> None:
    urllib.request.urlretrieve(url, dest_path)


def download_suitesparse(dest: str, limit: int = 0, fetch=_default_fetch,
                         echo=print) -> int:
    """Fetch manifest matrices into ``dest``; returns the count fetched.

    Mirrors download_decompressing_move (download_suiteSparse_dataset.sh:
    10-16): fetch tarball, extract the contained <name>/<name>.mtx into
    the dataset dir, drop the tarball."""
    from bsmr_sddmm_tpu.replicas import load_manifest

    os.makedirs(dest, exist_ok=True)
    specs = load_manifest()
    if limit:
        specs = specs[:limit]
    n_ok = 0
    for s in specs:
        out = os.path.join(dest, f"{s.name}.mtx")
        if os.path.exists(out):
            n_ok += 1
            continue
        url = SUITESPARSE_URL.format(group=s.group, name=s.name)
        with tempfile.TemporaryDirectory() as td:
            tgz = os.path.join(td, f"{s.name}.tar.gz")
            try:
                fetch(url, tgz)
            except (urllib.error.URLError, OSError) as e:
                echo(f"FAILED {url}: {e}")
                continue
            with tarfile.open(tgz, "r:gz") as tf:
                member = f"{s.name}/{s.name}.mtx"
                try:
                    tf.extract(member, td, filter="data")
                except KeyError:
                    echo(f"FAILED {url}: no {member} in tarball")
                    continue
            os.replace(os.path.join(td, member), out)
        n_ok += 1
        echo(f"fetched {s.name} ({n_ok}/{len(specs)})")
    return n_ok


def download_dlmc(dest: str, repo: str = DLMC_REPO, echo=print) -> int:
    """Clone the DLMC set and convert every .smtx to .mtx
    (download_dlmc_dataset.sh: clone + make_matrices_list +
    convert_smtx_to_mtx loop). Returns the converted-file count."""
    import subprocess

    from bsmr_sddmm_tpu.datatools import (convert_smtx_to_mtx,
                                          make_matrices_list)

    if not os.path.isdir(os.path.join(dest, ".git")):
        try:
            subprocess.run(["git", "clone", "--depth=1", repo, dest],
                           check=True)
        except subprocess.CalledProcessError as e:
            echo(f"FAILED cloning {repo}: {e}")
            return 0
    n = 0
    for root, _, files in os.walk(dest):
        for f in files:
            if f.endswith(".smtx"):
                convert_smtx_to_mtx(os.path.join(root, f))
                n += 1
    make_matrices_list(dest, os.path.join(dest, "matrices_list.txt"))
    echo(f"converted {n} .smtx files")
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    ss = sub.add_parser("suitesparse")
    ss.add_argument("--dest", default="suiteSparse_dataset")
    ss.add_argument("--limit", type=int, default=0)
    dl = sub.add_parser("dlmc")
    dl.add_argument("--dest", default="dlmc-dataset")
    dl.add_argument("--repo", default=DLMC_REPO)
    args = p.parse_args(argv)
    if args.cmd == "suitesparse":
        from bsmr_sddmm_tpu.datatools import (filter_dataset,
                                              make_matrices_list)
        n = download_suitesparse(args.dest, limit=args.limit)
        if n:
            filter_dataset(args.dest)
            make_matrices_list(args.dest,
                               os.path.join(args.dest,
                                            "matrices_list.txt"))
        return 0 if n else 1
    return 0 if download_dlmc(args.dest, repo=args.repo) else 1


if __name__ == "__main__":
    sys.exit(main())
