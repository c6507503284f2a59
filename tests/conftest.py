"""Test env: run everything on CPU with 8 virtual devices so multi-device
sharding logic is exercised without accelerators (SURVEY.md section 4
item 7). Must run before jax initializes a backend."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# env vars don't reliably beat an externally-selected platform plugin;
# the config API does (must run before the backend initializes). The CPU
# unless JAX_PLATFORMS names another platform (the gpu-marked tests on
# the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)
jax.config.update("jax_platforms",
                  os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR, make_dense, random_mask


def pytest_collection_modifyitems(config, items):
    """Skip @pytest.mark.slow tests (multi-minute subprocess jax imports
    on this 1-core box) unless BSMR_RUN_SLOW=1 — keeps the default
    one-shot suite under ~5 minutes. The slow tests' logic is covered by
    fast in-process variants; the slow ones add subprocess isolation."""
    if os.environ.get("BSMR_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow; set BSMR_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="session")
def cpu_cost_table():
    """The CPU has no cost table of its own (autotune.current_costs raises
    for it); tests price plans with the H100 row, passed explicitly."""
    from bsmr_sddmm_tpu import autotune
    autotune.install_costs(autotune.COSTS[autotune.H100_KIND], "cpu")
    yield
    autotune._INSTALLED.pop("cpu", None)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (tests marked ``gpu``)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "JAX_PLATFORMS=cuda pytest -m gpu")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def small_mask() -> CSR:
    """Structured mask with planted dense blocks + uniform noise."""
    return random_mask(rows=512, cols=768, nnz=20000, seed=7,
                       block_rows=24, block_cols=96)


@pytest.fixture(scope="session")
def tiny_mask() -> CSR:
    return random_mask(rows=96, cols=160, nnz=900, seed=3,
                       block_rows=12, block_cols=40)


@pytest.fixture(scope="session")
def cfg() -> SddmmConfig:
    return SddmmConfig(k=32, panel_height=16, block_width=128,
                       dense_chunk=64, residual_chunk=4096)


def make_ab(csr: CSR, k: int, seed: int = 1337):
    A = make_dense(csr.rows, k, seed=seed)
    B = make_dense(k, csr.cols, seed=seed + 1)
    return A, B
