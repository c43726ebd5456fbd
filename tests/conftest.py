"""Test configuration: force CPU with 8 virtual devices and float64.

Sharding logic is tested on a virtual CPU mesh
(xla_force_host_platform_device_count=8) so multi-device paths run
without a cluster; float64 enables parity testing against the NumPy
reference oracle (the reference's useC=FALSE analog).  The GPU kernel
runs here in the Pallas interpreter, injected by the
``pallas_interpret`` fixture.  Tests marked ``gpu`` need a card: they
run only under ``-m gpu`` (see README), where the CPU is not forced.
"""

import os
import sys

_GPU_RUN = any(a == "gpu" for a in sys.argv) and "-m" in sys.argv
if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import matplotlib  # noqa: E402

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The XLA:CPU JIT segfaults (deterministically, inside LLVM
    compilation) once a single process accumulates ~190 tests' worth
    of live compiled programs (bisected: any ~190-test subset crashes
    at the same spot, every ~100-test subset passes).  Clearing per module
    bounds the live-executable count at a small recompilation cost.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def data_dir():
    """Bundled synthetic PBMC-like 10x trio (self-contained; the
    primary fixture — pytest must pass without any external mount)."""
    from ccfindr_tpu.data import pbmc_sim_dir

    return pbmc_sim_dir()


@pytest.fixture(scope="session")
def pbmc_dir():
    """Real 10x PBMC subsample from the reference mount (optional:
    scientific ground-truth cross-checks, skipped when absent)."""
    p = "/root/reference/inst/extdata"
    if not os.path.isdir(p):
        pytest.skip("reference PBMC data mount not available")
    return p


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the fused X-pass GPU kernel in the Pallas interpreter: the
    drivers' backend factories are swapped for interpret-mode ones,
    so backend='pallas' (single device, mesh, ML) runs on the CPU."""
    from ccfindr_tpu.ops.pallas import xpass

    monkeypatch.setattr(
        xpass, "make_vb_backend",
        lambda precision="f32": xpass.VBXPass(precision, interpret=True))
    ml = xpass.MLXPass(interpret=True)
    monkeypatch.setattr(xpass, "make_ml_backend", lambda: (ml.h, ml.w))
    return xpass


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform: {dev.platform})")
    return dev
