"""Backend selection, precision, the Pallas-Triton tile kernel (interpret
mode), the compile cache and the measurement entry points' failure
behaviour. Tests marked ``gpu`` run the compiled kernel on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bsmr_sddmm_tpu.formats import make_dense
from bsmr_sddmm_tpu.utils.checkdata import check_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- backend and precision ----------------------------------------------

def test_resolve_backend_auto_is_xla_on_every_platform(monkeypatch):
    from bsmr_sddmm_tpu.ops import sddmm as ops
    for platform in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
        assert ops.resolve_backend("auto") == "xla"
        assert ops.resolve_backend("triton") == "triton"
        assert ops.resolve_backend("xla") == "xla"


def test_unknown_backend_and_precision_raise():
    from bsmr_sddmm_tpu.config import SddmmConfig
    with pytest.raises(ValueError, match="backend"):
        SddmmConfig(backend="pallas")
    with pytest.raises(ValueError, match="matmul_precision"):
        SddmmConfig(matmul_precision="high")
    with pytest.raises(ValueError, match="power of two"):
        SddmmConfig(panel_height=24)


@pytest.mark.parametrize("name,gpu_alg,cpu_alg", [
    ("tf32", "TF32_TF32_F32", "F32_F32_F32"),
    ("bf16x3", "BF16_BF16_F32_X3", "BF16_BF16_F32_X3"),
    ("fp32", "F32_F32_F32", "F32_F32_F32"),
])
def test_precision_maps_per_platform(name, gpu_alg, cpu_alg):
    from bsmr_sddmm_tpu.precision import dot_algorithm
    P = jax.lax.DotAlgorithmPreset
    assert dot_algorithm(name, "gpu") == getattr(P, gpu_alg)
    assert dot_algorithm(name, "cpu") == getattr(P, cpu_alg)
    with pytest.raises(ValueError, match="unknown matmul precision"):
        dot_algorithm("highest", "gpu")
    # the CPU accepts whatever the mapping hands it
    a = jnp.ones((16, 32), jnp.float32)
    out = jnp.dot(a, a.T, precision=dot_algorithm(name, "cpu"),
                  preferred_element_type=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), 32.0)


def test_bf16_inputs_fail_the_reference_tolerance(tiny_mask):
    """A product of bf16-rounded inputs (8 mantissa bits) must fail the
    reference tolerance, or the tolerance could not tell a TF32 run from
    a bf16 one (at K=32 few products average the rounding away)."""
    from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref
    A = make_dense(tiny_mask.rows, 32, seed=1)
    B = make_dense(32, tiny_mask.cols, seed=2)
    expected = sddmm_ref(A, B, tiny_mask)
    bf = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    rounded = sddmm_ref(bf(A), bf(B), tiny_mask)
    assert not check_data(expected, rounded).passed
    assert check_data(expected, sddmm_ref(A, B, tiny_mask)).passed


# --- the Pallas-Triton tile kernel (interpret mode) ----------------------

def _tiles_ref(A, Bt, tile_panel, step_sub, ph, sw, G):
    S = step_sub.shape[1]
    pad = -Bt.shape[0] % sw
    Btp = np.pad(Bt, ((0, pad), (0, 0)))
    out = []
    for t, p in enumerate(tile_panel):
        b = np.concatenate([Btp[s * sw:(s + 1) * sw]
                            for s in step_sub[t // G]])
        out.append(A[p * ph:(p + 1) * ph].astype(np.float64)
                   @ b.T.astype(np.float64))
    assert b.shape[0] == sw * S
    return np.stack(out)


@pytest.mark.parametrize("k", [32, 64, 128, 256])
@pytest.mark.parametrize("sw,G", [(128, 8), (128, 1), (32, 1), (16, 2)])
def test_triton_tiles_match_reference(k, sw, G):
    """Fat groups (G tiles share one step's B sub-blocks), packed row
    indices (S = bw / sw sub-blocks), and padding of Bt to a multiple of
    sw rows (N = 300 is a multiple of neither 16 nor 128)."""
    from bsmr_sddmm_tpu.ops.triton_tiles import make_tile_kernel
    from bsmr_sddmm_tpu.precision import dot_algorithm
    ph, bw, P, N, n_steps = 16, 128, 5, 300, 3
    rng = np.random.default_rng(k + sw + G)
    A = make_dense(P * ph, k, seed=1)
    Bt = make_dense(N, k, seed=2)
    T = n_steps * G
    tile_panel = rng.integers(0, P, T).astype(np.int32)
    step_sub = rng.integers(0, -(-N // sw), (n_steps, bw // sw)) \
        .astype(np.int32)
    fn = make_tile_kernel(ph, bw, k, sw, G, dot_algorithm("tf32"),
                          interpret=True)
    out = np.asarray(fn(jnp.asarray(A), jnp.asarray(Bt),
                        jnp.asarray(tile_panel), jnp.asarray(step_sub)))
    want = _tiles_ref(A, Bt, tile_panel, step_sub, ph, sw, G)
    assert out.shape == (T, ph, bw)
    assert check_data(want, out).passed


def test_triton_tiles_reject_bad_geometry():
    from bsmr_sddmm_tpu.ops.triton_tiles import make_tile_kernel
    from bsmr_sddmm_tpu.precision import dot_algorithm
    alg = dot_algorithm("tf32")
    with pytest.raises(ValueError, match="power of two"):
        make_tile_kernel(16, 128, 24, 128, 1, alg)
    with pytest.raises(ValueError, match="power of two"):
        make_tile_kernel(8, 128, 32, 128, 1, alg)


def test_triton_backend_rphm_tiers_match_xla(small_mask):
    """With the same plan, the triton backend's dense and packed tiers
    equal XLA's; the gathered and residual tiers are XLA's in both."""
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.ops.sddmm import device_plan, make_sddmm_body
    from bsmr_sddmm_tpu.pack import pack_tiles
    from bsmr_sddmm_tpu.reorder import bsmr
    cfg = SddmmConfig(k=32, panel_height=16, delta=0.05,
                      subpack_min_nnz=4, dense_fat_group=8)
    plan = pack_tiles(small_mask, bsmr(small_mask, cfg), cfg)
    assert plan.fat_group > 1 and plan.num_packed > 0
    dplan = device_plan(plan, emit="rphm")
    A = jnp.asarray(make_dense(small_mask.rows, 32, seed=3))
    Bt = jnp.asarray(make_dense(small_mask.cols, 32, seed=4))
    xla = make_sddmm_body(plan, cfg, "xla", emit="rphm")(A, Bt, dplan)
    tri = make_sddmm_body(plan, cfg, "triton", emit="rphm")(A, Bt, dplan)
    for a, b in zip(xla, tri):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_triton_backend_compiled_on_gpu(gpu, small_mask):
    """The compiled (not interpreted) Triton kernel against the oracle."""
    from bsmr_sddmm_tpu.config import SddmmConfig
    from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref
    from bsmr_sddmm_tpu.sddmm import sddmm
    cfg = SddmmConfig(k=128, backend="triton", delta=0.05,
                      subpack_min_nnz=4)
    A = make_dense(small_mask.rows, 128, seed=1)
    B = make_dense(128, small_mask.cols, seed=2)
    out = sddmm(A, B, small_mask, cfg)
    assert check_data(sddmm_ref(A, B, small_mask), out).passed


# --- compile cache --------------------------------------------------------

def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda key, val: calls.__setitem__(key, val))
    return calls


def test_compile_cache_uses_the_environment_directory(monkeypatch,
                                                      tmp_path):
    from bsmr_sddmm_tpu.utils import compilecache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compilecache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls   # JAX reads the env


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    from bsmr_sddmm_tpu.utils import compilecache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    d = compilecache.enable_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == d


# --- measurement entry points fail loudly ---------------------------------

def test_bench_arm_failure_fails_the_run(monkeypatch):
    """An arm that raises stops the suite: no retry, no skip, no
    dense-fallback rescue."""
    sys.path.insert(0, REPO)
    import bench
    from bsmr_sddmm_tpu.datasets import banded
    from bsmr_sddmm_tpu.sddmm import BsmrSddmm

    calls = []

    def boom(self, *a, **kw):
        calls.append(kw.get("delta"))
        raise RuntimeError("kernel failed to compile")

    monkeypatch.setattr(BsmrSddmm, "benchmark", boom)
    suite = [("banded_mesh_12k", lambda: banded(512, 8000, 32, seed=1))]
    with pytest.raises(RuntimeError, match="failed to compile"):
        bench.run_suite(suite, budget_s=1e9)
    assert len(calls) == 1


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measurement_scripts_refuse_the_cpu(script):
    """Without an accelerator both scripts exit nonzero and print no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert '"ok"' not in line and '"value"' not in line, line
    assert "GPU" in proc.stderr or "accelerator" in proc.stderr
