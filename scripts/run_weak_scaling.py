"""Weak scaling of the real sharded SDDMM on a virtual 8-device CPU mesh.

All 8 virtual devices timeshare the host's cores, so the measured
"efficiency" reflects host throughput, not device scaling. The
meaningful evidence is structural: (a) per-shard shapes/compile stay
constant as the mesh grows, and (b) the hot path adds NO collectives
(replicated B) — both asserted in
tests/test_harness.py::test_weak_scaling_real_sddmm. Writes
logs/weak_scaling_virtual.json.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")

from bsmr_sddmm_tpu import autotune
from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.parallel import distributed

# the CPU has no cost table of its own: shard balancing prices with the
# H100 row
autotune.install_costs(autotune.COSTS[autotune.H100_KIND], "cpu")

cfg = SddmmConfig(k=64, panel_height=32)
res = distributed.sddmm_weak_scaling(
    [1, 2, 4, 8], rows_per_device=4096, nnz_per_device=250_000,
    cols=8192, k=64, bandwidth=128, config=cfg, iterations=4)
out = {str(n): {k: float(v) for k, v in d.items()}
       for n, d in res.items()}
payload = {
    "metric": "virtual_mesh_weak_scaling",
    "host_cores": os.cpu_count(),
    "note": ("8 virtual devices timeshare the host cores; efficiency "
             "reflects host throughput, not device scaling. Constant "
             "per-shard work + zero hot-path collectives are the "
             "structural evidence."),
    "per_device": out,
}
print(json.dumps(payload, indent=1))
os.makedirs("logs", exist_ok=True)
with open("logs/weak_scaling_virtual.json", "w") as f:
    json.dump(payload, f, indent=1)
