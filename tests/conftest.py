"""Test configuration: pin the suite to CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh.  The device count
flag must be in XLA_FLAGS before JAX initializes, and the default device is
pinned to an explicit CPU device object so eager and uncommitted jit work
stays on the host.  Tests that need a GPU carry the ``gpu`` marker, place
their arrays on it explicitly and skip when none is present (see
tests/test_gpu_smoke.py).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import jax
import pytest

_cpus = jax.local_devices(backend="cpu")
jax.config.update("jax_default_device", _cpus[0])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on an NVIDIA GPU (skipped when absent)"
    )

FIXTURE_DIR = pathlib.Path(__file__).parent / "fixtures" / "input"


@pytest.fixture(scope="session")
def ply_fixture(tmp_path_factory) -> str:
    """The committed deterministic fixture cloud (the reference layout's
    tests/fixtures/input/pcl_frame1.ply), regenerated on the fly if absent."""
    committed = FIXTURE_DIR / "pcl_frame1.ply"
    if committed.exists():
        return str(committed)
    import cwipc_util_jax as cwipc

    path = tmp_path_factory.mktemp("fixtures") / "pcl_frame1.ply"
    gen = cwipc.cwipc_synthetic(0, 1000)
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    cwipc.cwipc_write(str(path), pc, cwipc.CWIPC_FLAGS_BINARY)
    pc.free()
    return str(path)
