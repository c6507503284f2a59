"""Smoke run of the BSMR SDDMM main path on an NVIDIA GPU.

    python chip_smoke.py                # every one-card phase
    python chip_smoke.py --four-cards   # only the multi-card path (4 GPUs)
    python chip_smoke.py --phases 1,5   # a subset of the one-card phases

Everything runs in this one process: a JAX process reserves most of the
card's memory when it starts, so the CLI is driven in-process through
``cli.main``. Every timed run is validated against the fp64 oracle at
the reference tolerance (abs 1e-5 OR rel 1e-3); any failure is fatal.

Phases (one card):
  0. device checks: block_until_ready waits for the device; what each
     matmul precision costs and how far it is from fp64.
  1. every ``datasets.SUITE`` matrix at K=128 at its bench.py arm.
  2. banded_mesh_64k at K=32 and K=256, rmat_18 (datasets.EXTRA) at K=128.
  3. ablations on community_16k: delta 0 / 1.1 / "dense" / "auto",
     col_mode="reorder", subpack off, fp16 emission.
  4. the CLI on a saved .mtx.
  5. the Pallas-Triton tile kernel against XLA on every SUITE matrix,
     tier serialization and gather windowing on and off.
  6. a sparse_transformer train step (seq 8192, 4 heads, 2 layers,
     head_dim 128) and the SDDMM custom VJP against jax.grad of a plain
     masked dense product (seq 2048, head_dim 128).

It prints the card's name and power limit, and its last line is one JSON
object naming the device. Without a GPU, or outside a checkout of the
repository, it exits nonzero and prints no result. A summary goes to
``chiprun_out/chip_smoke.json``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = (0, 1, 2, 3, 4, 5, 6)
SUMMARY = {"phases": {}}


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def peak_bytes() -> int:
    import jax
    return int((jax.devices()[0].memory_stats() or {})
               .get("peak_bytes_in_use", 0))


def report(tag: str, log) -> dict:
    """Print one validated run and return its record; raise unless the
    run passed the oracle check."""
    rec = {"ms": log.sddmm_ms, "gflops": log.gflops,
           "check": log.check_result,
           "max_rel_err": float(log.extras.get("max_rel_err", "nan")),
           "tiles": {"dense": log.num_dense_blocks,
                     "packed": log.num_packed_blocks,
                     "gathered": log.num_gathered_blocks,
                     "residual_nnz": log.residual_nnz},
           "alpha": log.alpha, "delta": log.delta,
           "backend": log.backend, "peak_bytes": peak_bytes()}
    if "sddmm_csr_ms" in log.extras:
        rec["csr_ms"] = float(log.extras["sddmm_csr_ms"])
    print(f"  {tag}: {rec['ms']:.4f} ms {rec['gflops']:.1f} GFLOPS "
          f"tiles d/p/g {log.num_dense_blocks}/{log.num_packed_blocks}/"
          f"{log.num_gathered_blocks} res {log.residual_nnz} "
          f"max_rel_err {rec['max_rel_err']:.3e} "
          f"peak {rec['peak_bytes'] / 2**30:.2f} GiB "
          f"[checkResults : {log.check_result}]", flush=True)
    if log.check_result != "pass":
        raise AssertionError(f"{tag}: oracle check {log.check_result}")
    return rec


def operands(csr, k):
    import jax.numpy as jnp
    import numpy as np

    from bsmr_sddmm_tpu.formats import make_dense
    A = jnp.asarray(make_dense(csr.rows, k, seed=1337))
    Bt = jnp.asarray(np.ascontiguousarray(
        make_dense(k, csr.cols, seed=1338).T))
    return A, Bt


def pipe_for(csr, **cfg):
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.sddmm import BsmrSddmm
    base = dict(k=128, panel_height=32, num_iterations=10)
    base.update(cfg)
    return BsmrSddmm(csr, SddmmConfig(**base))


def matrices(names):
    from bsmr_sddmm_tpu.datasets import EXTRA, SUITE
    gens = dict(SUITE + EXTRA)
    return [(n, gens[n]()) for n in names]


# --- phases ------------------------------------------------------------------

def phase0(state):
    """block_until_ready semantics and the matmul precisions."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bsmr_sddmm_tpu.precision import PRECISIONS, dot_algorithm
    n = 8192
    x = jnp.asarray(np.random.default_rng(0).random((n, n), np.float32))
    f = jax.jit(lambda a: a @ a)
    jax.block_until_ready(f(x))
    t0 = time.perf_counter()
    y = f(x)
    t_dispatch = time.perf_counter() - t0
    jax.block_until_ready(y)
    t_block = time.perf_counter() - t0
    floor_s = 2 * n ** 3 / 1e15          # above any card's fp32-input rate
    waits = t_block >= floor_s
    print(f"  block_until_ready: dispatch {t_dispatch * 1e3:.3f} ms, "
          f"blocked {t_block * 1e3:.3f} ms for {2 * n ** 3 / 1e12:.2f} "
          f"TFLOP (floor {floor_s * 1e3:.3f} ms) -> waits={waits}")
    assert waits, "block_until_ready returned before the device finished"
    rec = {"dispatch_ms": t_dispatch * 1e3, "blocked_ms": t_block * 1e3}
    m, k = 4096, 128
    rng = np.random.default_rng(1)
    a = rng.random((m, k), np.float32) * 2
    b = rng.random((k, m), np.float32) * 2
    ref = a.astype(np.float64) @ b.astype(np.float64)
    arms = {f"config:{p}": dot_algorithm(p) for p in PRECISIONS}
    arms.update({"lax:DEFAULT": jax.lax.Precision.DEFAULT,
                 "lax:HIGH": jax.lax.Precision.HIGH,
                 "lax:HIGHEST": jax.lax.Precision.HIGHEST,
                 "bf16_inputs": jax.lax.DotAlgorithmPreset.BF16_BF16_F32})
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, prec in arms.items():
        g = jax.jit(lambda u, v, p=prec: jnp.dot(
            u, v, precision=p, preferred_element_type=jnp.float32))
        out = np.asarray(g(ja, jb))
        t0 = time.perf_counter()
        for _ in range(20):
            r = g(ja, jb)
        jax.block_until_ready(r)
        ms = (time.perf_counter() - t0) / 20 * 1e3
        err = float(np.max(np.abs(out - ref) / np.abs(ref)))
        rec[name] = {"max_rel_err": err, "ms": ms}
        print(f"  dot {name:18s}: max_rel_err {err:.3e}  {ms:.4f} ms "
              f"({m}x{k}x{m})")
    return rec


def phase1(state):
    """Every SUITE matrix at K=128, its bench.py arm, csr emit timed."""
    import bench
    from bsmr_sddmm_tpu.datasets import SUITE
    out = {}
    state["suite"] = {}
    for name, _ in SUITE:
        (_, csr), = matrices([name])
        alpha, delta, sub, _ = bench.ARMS[(name, 128)]
        pipe = pipe_for(csr, subpack_min_nnz=sub)
        A, Bt = operands(csr, 128)
        log = pipe.benchmark(A, Bt, alpha=alpha, delta=delta,
                             validate=True, time_csr_emit=True, file=name)
        out[name] = report(f"{name} k=128 (nnz {csr.nnz})", log)
        state["suite"][name] = (pipe, A, Bt, alpha, delta)
    return out


def phase2(state):
    """Operands larger than the card's L2."""
    out = {}
    cells = (("banded_mesh_64k", 32, (0.3, 0.006, 0)),
             ("banded_mesh_64k", 256, (0.5, 0.006, 0)),
             ("rmat_18", 128, (0.3, 0.002, 12)))
    for name, k, (alpha, delta, sub) in cells:
        (_, csr), = matrices([name])
        pipe = pipe_for(csr, k=k, subpack_min_nnz=sub)
        A, Bt = operands(csr, k)
        log = pipe.benchmark(A, Bt, alpha=alpha, delta=delta,
                             validate=True, time_csr_emit=False, file=name)
        out[f"{name}_k{k}"] = report(
            f"{name} k={k} (B {csr.cols * k * 4 / 2**20:.0f} MiB)", log)
    return out


def phase3(state):
    """Ablations on one matrix."""
    (name, csr), = matrices(["community_16k"])
    A, Bt = operands(csr, 128)
    arms = (("delta=0.0", {}, dict(delta=0.0)),
            ("delta=1.1", {}, dict(delta=1.1)),
            ("col_mode=reorder", dict(col_mode="reorder"),
             dict(delta=0.3)),
            ("subpack_min_nnz=0", dict(subpack_min_nnz=0),
             dict(delta=0.006)),
            ("out_dtype=float16", dict(out_dtype="float16"),
             dict(delta=0.006)),
            ("delta=dense", {}, dict(delta="dense")),
            ("delta=auto", {}, dict(delta="auto")))
    out = {}
    for tag, cfg, kw in arms:
        pipe = pipe_for(csr, **cfg)
        log = pipe.benchmark(A, Bt, alpha=0.1, validate=True,
                             time_csr_emit=False, file=name, **kw)
        out[tag] = report(f"{name} {tag}", log)
    return out


def phase4(state):
    """The CLI, in-process."""
    from bsmr_sddmm_tpu import cli
    from bsmr_sddmm_tpu.formats import save_mtx
    (name, csr), = matrices(["banded_mesh_12k"])
    d = os.path.join(HERE, "chiprun_out")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.mtx")
    save_mtx(path, csr)
    t0 = time.perf_counter()
    rc = cli.main(["-f", path, "-k", "128", "--validate"])
    os.remove(path)
    print(f"  cli rc={rc} ({time.perf_counter() - t0:.1f} s)")
    assert rc == 0, f"cli exited {rc}"
    return {"rc": rc}


def phase5(state):
    """Kernel decision and the one-time tier/windowing timings."""
    from bsmr_sddmm_tpu.datasets import SUITE
    if "suite" not in state:
        phase1(state)
    out = {"kernel": {}}
    for name, _ in SUITE:
        pipe, A, Bt, alpha, delta = state["suite"][name]
        tri = report(f"{name} triton", pipe.benchmark(
            A, Bt, alpha=alpha, delta=delta, backend="triton",
            validate=True, time_csr_emit=False, file=name))
        xla = report(f"{name} xla   ", pipe.benchmark(
            A, Bt, alpha=alpha, delta=delta, backend="xla",
            validate=True, time_csr_emit=False, file=name))
        out["kernel"][name] = {"triton_ms": tri["ms"], "xla_ms": xla["ms"],
                               "xla_ms_phase1":
                                   SUMMARY["phases"].get("1", {})
                                   .get("result", {}).get(name, {})
                                   .get("ms")}
    # tier serialization and gather windowing, once each
    (_, csr64), = matrices(["banded_mesh_64k"])
    A, Bt = operands(csr64, 256)
    for tag, cfg in (("serialize=on", dict(tier_serialize="on")),
                     ("serialize=off", dict(tier_serialize="off")),
                     ("window=on", dict(gather_window_mb=16,
                                        gather_window_threshold_mb=0)),
                     ("window=off", dict(gather_window_mb=0))):
        pipe = pipe_for(csr64, k=256, subpack_min_nnz=0, **cfg)
        out[f"banded_mesh_64k_k256 {tag}"] = report(
            f"banded_mesh_64k k=256 {tag}", pipe.benchmark(
                A, Bt, alpha=0.5, delta=0.006, validate=True,
                time_csr_emit=False, file="banded_mesh_64k"))
    (_, csr18), = matrices(["rmat_18"])
    A, Bt = operands(csr18, 128)
    for tag, cfg in (("window=on", dict(gather_window_mb=16)),
                     ("window=off", dict(gather_window_mb=0))):
        pipe = pipe_for(csr18, subpack_min_nnz=12, **cfg)
        out[f"rmat_18_k128 {tag}"] = report(
            f"rmat_18 k=128 {tag}", pipe.benchmark(
                A, Bt, alpha=0.3, delta=0.002, validate=True,
                time_csr_emit=False, file="rmat_18"))
    return out


def phase6(state):
    """Training through the custom VJP."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.formats import make_dense
    from bsmr_sddmm_tpu.models import sparse_transformer as st
    from bsmr_sddmm_tpu.ops.graph_rphm import make_diff_sddmm_body
    from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_body
    from bsmr_sddmm_tpu.pack import pack_tiles
    from bsmr_sddmm_tpu.reorder import bsmr
    from bsmr_sddmm_tpu.utils.checkdata import check_data

    model = st.SparseTransformer(seq_len=8192, vocab_size=256,
                                 head_dim=128, num_heads=4, num_layers=2)
    fwd, dplan, plan = st.make_forward(model)
    params = st.init_params(model)
    opt_init, step = st.make_train_step(model, fwd)
    tok = jnp.asarray(np.random.default_rng(0).integers(
        0, model.vocab_size, model.seq_len))
    step = jax.jit(step)
    opt = opt_init(params)
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, tok, dplan)
    loss0 = float(loss)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, tok, dplan)
    loss1 = float(loss)
    t_step = time.perf_counter() - t0
    print(f"  train step seq 8192 ({plan.nnz} mask nnz): loss "
          f"{loss0:.4f} -> {loss1:.4f}; first call {t_first:.1f} s, "
          f"step {t_step * 1e3:.1f} ms, peak {peak_bytes() / 2**30:.2f} GiB")
    assert np.isfinite(loss0) and np.isfinite(loss1), "non-finite loss"

    # custom VJP vs jax.grad of the plain masked dense product
    mask = st.local_strided_mask(2048)
    cfg = SddmmConfig(k=128, delta=0.05)
    plan = pack_tiles(mask, bsmr(mask, cfg), cfg)
    dp = device_plan(plan)
    diff = make_diff_sddmm_body(plan, make_sddmm_body(plan, cfg,
                                                      emit="rphm"))
    A = jnp.asarray(make_dense(mask.rows, 128, seed=3))
    Bt = jnp.asarray(make_dense(mask.cols, 128, seed=4))
    w = np.random.default_rng(5).random(mask.nnz).astype(np.float32)
    rows, cols = mask.coo_rows(), mask.col_indices

    def loss_tiled(A, Bt):
        d, p, g, r = diff(A, Bt, dp)
        flat = jnp.concatenate([d.ravel(), p.ravel(), g.ravel(), r])
        return jnp.sum(jnp.take(flat, dp.rphm_to_csr) * w)

    W = np.zeros((mask.rows, mask.cols), np.float32)
    W[rows, cols] = w

    def loss_dense(A, Bt):
        P = jnp.dot(A, Bt.T, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(P * W)

    got = jax.jit(jax.grad(loss_tiled, argnums=(0, 1)))(A, Bt)
    want = jax.jit(jax.grad(loss_dense, argnums=(0, 1)))(A, Bt)
    rec = {"loss": [loss0, loss1], "step_ms": t_step * 1e3}
    for nm, g_, w_ in zip(("dA", "dBt"), got, want):
        res = check_data(np.asarray(w_), np.asarray(g_))
        rec[nm] = {"max_rel_err": res.max_rel_err, "passed": res.passed}
        print(f"  vjp {nm} vs jax.grad(dense): max_rel_err "
              f"{res.max_rel_err:.3e} [checkResults : "
              f"{'pass' if res.passed else 'fail'}]")
        assert res.passed, f"custom VJP {nm}: {res}"
    return rec


def four_cards(state):
    """Sharded SDDMM (replicated and all-gathered B), the ppermute ring
    and the sharded train step, on every visible card."""
    import jax
    import numpy as np

    import __graft_entry__
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.datasets import banded
    from bsmr_sddmm_tpu.formats import make_dense
    from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref
    from bsmr_sddmm_tpu.parallel import (make_mesh, make_sharded_sddmm,
                                         shard_operands)
    from bsmr_sddmm_tpu.parallel.ring import (make_ring_sddmm,
                                              ring_operands)
    from bsmr_sddmm_tpu.reorder import bsmr
    from bsmr_sddmm_tpu.utils.checkdata import check_data
    from bsmr_sddmm_tpu.utils.timing import time_jitted

    n = len(jax.devices())
    mesh = make_mesh()
    # each card holds about one banded_mesh_64k: rows and nnz grow with
    # the mesh, the band (and so the tile structure) stays the same
    csr = banded(65536 * n, 3_500_000 * n, 384, seed=49)
    cfg = SddmmConfig(k=128, panel_height=32, delta=0.006)
    reord = bsmr(csr, cfg)
    A = make_dense(csr.rows, 128, seed=1337)
    Bt = np.ascontiguousarray(make_dense(128, csr.cols, seed=1338).T)
    oracle = sddmm_ref(A, Bt.T, csr)
    out = {"devices": n, "nnz": csr.nnz}
    layouts = [("replicated_b", False), ("allgather_b", True)]
    for tag, b_sharded in layouts:
        fn, dplan, _ = make_sharded_sddmm(csr, reord, cfg, mesh,
                                          b_sharded=b_sharded, emit="csr")
        A_d, Bt_d = shard_operands(A, Bt, mesh, b_sharded=b_sharded)
        ms, res_out = time_jitted(fn, A_d, Bt_d, dplan)
        res = check_data(oracle, np.asarray(res_out))
        out[tag] = {"ms": ms, "max_rel_err": res.max_rel_err}
        print(f"  {tag}: {ms:.3f} ms, max_rel_err {res.max_rel_err:.3e} "
              f"[checkResults : {'pass' if res.passed else 'fail'}]")
        assert res.passed, f"{tag}: {res}"
    fn_ring, rplan = make_ring_sddmm(csr, reord, cfg, mesh, emit="csr")
    A_r, Bt_r = ring_operands(A, Bt, rplan, mesh)
    ms, res_out = time_jitted(fn_ring, A_r, Bt_r)
    res = check_data(oracle, np.asarray(res_out))
    out["ring"] = {"ms": ms, "max_rel_err": res.max_rel_err}
    print(f"  ring: {ms:.3f} ms, max_rel_err {res.max_rel_err:.3e} "
          f"[checkResults : {'pass' if res.passed else 'fail'}]")
    assert res.passed, f"ring: {res}"
    __graft_entry__.dryrun_multichip(n)
    return out


# --- driver ------------------------------------------------------------------

def run_phase(key, fn, state) -> bool:
    print(f"== phase {key}: {fn.__doc__.strip().splitlines()[0]}",
          flush=True)
    t0 = time.perf_counter()
    try:
        result = fn(state)
        ok = True
    except Exception:
        traceback.print_exc()
        result, ok = None, False
    dt = time.perf_counter() - t0
    SUMMARY["phases"][str(key)] = {"ok": ok, "seconds": dt,
                                   "result": result}
    print(f"== phase {key}: {'ok' if ok else 'FAILED'} ({dt:.1f} s)",
          flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card path, on every card")
    p.add_argument("--phases", default=",".join(map(str, PHASES)),
                   help="comma-separated one-card phases to run")
    args = p.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        die(f"no GPU: JAX's first device is {devs[0].platform!r}")
    try:
        import bsmr_sddmm_tpu
    except ImportError:
        die("bsmr_sddmm_tpu is not importable; run from a checkout")
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(bsmr_sddmm_tpu.__file__)))
    if pkg_root != HERE:
        die(f"bsmr_sddmm_tpu comes from {pkg_root}, not this checkout")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    from bsmr_sddmm_tpu import native
    from bsmr_sddmm_tpu.utils.compilecache import enable_compile_cache
    from bsmr_sddmm_tpu.utils.hostmem import tune_malloc
    tune_malloc()
    cache = enable_compile_cache()
    built = native.available()
    print(f"device_kind: {devs[0].device_kind} x{len(devs)}; "
          f"jax {jax.__version__}; native clustering "
          f"{'built' if built else 'NOT built (NumPy fallback)'}; "
          f"compile cache {cache}", flush=True)
    SUMMARY.update(nvidia_smi=smi.stdout.strip(),
                   device_kind=devs[0].device_kind, count=len(devs),
                   jax=jax.__version__, native_built=built)

    state = {}
    if args.four_cards:
        todo = [("4cards", four_cards)]
    else:
        fns = {0: phase0, 1: phase1, 2: phase2, 3: phase3, 4: phase4,
               5: phase5, 6: phase6}
        todo = [(int(x), fns[int(x)]) for x in args.phases.split(",")]
    t0 = time.perf_counter()
    ok = all([run_phase(key, fn, state) for key, fn in todo])
    SUMMARY["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(SUMMARY, f, indent=1, default=str)
    if not ok:
        die("a phase failed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
