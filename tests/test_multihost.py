"""Real multi-process (multi-host-style) execution of the sharded SDDMM.

Two OS processes bootstrap with ``jax.distributed.initialize``, form one
4-device global mesh (2 virtual CPU devices each), and run the
per-shard-packed shard_map SDDMM with B column panels sharded across the
global mesh — the in-body all_gather crosses the process boundary (gloo
on CPU; NCCL across GPU hosts) — and the ring layout, whose lax.ppermute
B-panel rotation crosses the boundary on every hop. Both processes
validate both full outputs against the fp64 oracle.
"""
import json
import os
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), os.pardir,
                       "scripts", "multihost_worker.py")


def test_two_process_sharded_sddmm(tmp_path):
    port = "9741"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    for out in outs:
        rec = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        assert rec["check"] == "pass"
        assert rec["ring_check"] == "pass"
        assert rec["global_devices"] == 4
        assert rec["num_processes"] == 2
