"""One process of the multi-process (multi-host-style) SDDMM smoke run.

Usage: python scripts/multihost_worker.py <pid> <nproc> <port>

Each process initializes jax.distributed against a local coordinator,
contributes 2 virtual CPU devices to a (2 * nproc)-device global mesh,
and runs the per-shard-packed shard_map hybrid SDDMM with B column
panels sharded across the GLOBAL mesh (the in-body all_gather crosses
the process boundary over gloo — across GPU hosts this same code goes
through NCCL). Every process checks the full CSR-order output against the
fp64 oracle and prints one JSON line.

This is the real multi-process bootstrap path. Driven by
tests/test_multihost.py.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax                                               # noqa: E402
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)

import numpy as np                                       # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from bsmr_sddmm_tpu import autotune                      # noqa: E402
from bsmr_sddmm_tpu.config import SddmmConfig            # noqa: E402
from bsmr_sddmm_tpu.datasets import banded               # noqa: E402
from bsmr_sddmm_tpu.formats import make_dense            # noqa: E402
from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref           # noqa: E402
from bsmr_sddmm_tpu.parallel.sharding import (           # noqa: E402
    make_mesh, make_sharded_sddmm, shard_operands)
from bsmr_sddmm_tpu.reorder import bsmr                  # noqa: E402
from bsmr_sddmm_tpu.utils.checkdata import check_data    # noqa: E402

# the CPU has no cost table of its own: shard balancing prices with the
# H100 row
autotune.install_costs(autotune.COSTS[autotune.H100_KIND], "cpu")

n_global = jax.device_count()
assert n_global == 2 * nproc, (n_global, nproc)
mesh = make_mesh()                                       # all global devices

cfg = SddmmConfig(k=32, panel_height=16, dense_chunk=16,
                  residual_chunk=2048)
csr = banded(512, 16000, 64, seed=11)
reord = bsmr(csr, cfg)
A = make_dense(csr.rows, cfg.k, seed=1)
Bt = make_dense(csr.cols, cfg.k, seed=2)

# B column panels sharded over the global mesh: the hot path's
# all_gather is a real cross-process collective
fn, dplan, plans = make_sharded_sddmm(csr, reord, cfg, mesh,
                                      b_sharded=True, emit="csr")
A_dev, Bt_dev = shard_operands(A, Bt, mesh, b_sharded=True)
repl = NamedSharding(mesh, P())
out = jax.jit(lambda a, b, d: fn(a, b, d),
              out_shardings=repl)(A_dev, Bt_dev, dplan)
out_np = np.asarray(jax.block_until_ready(out))

expected = sddmm_ref(A, Bt.T, csr)
res = check_data(expected, out_np)

# ring layout: B stays sharded; lax.ppermute panel rotation crosses the
# process boundary each hop (gloo here; NCCL across GPU hosts)
from bsmr_sddmm_tpu.parallel.ring import (                # noqa: E402
    make_ring_sddmm, ring_operands)
fn_ring, rplan = make_ring_sddmm(csr, reord, cfg, mesh, emit="csr")
A_r, Bt_r = ring_operands(A, Bt, rplan, mesh)
out_ring = fn_ring(A_r, Bt_r)   # csr emission is already replicated
res_ring = check_data(expected, np.asarray(jax.block_until_ready(
    out_ring)))

print(json.dumps({
    "process": pid, "num_processes": nproc,
    "global_devices": n_global,
    "shards": len(plans),
    "nnz": int(csr.nnz),
    "b_sharded_all_gather": True,
    "check": "pass" if res.passed else "fail",
    "error_rate": float(res.error_rate),
    "ring_check": "pass" if res_ring.passed else "fail",
    "ring_error_rate": float(res_ring.error_rate),
}), flush=True)
sys.exit(0 if res.passed and res_ring.passed else 1)
