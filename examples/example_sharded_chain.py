"""Example: the headline processing chain sharded over a device mesh.

Runs the downsample -> outlier-removal -> tilefilter chain with the point
axis sharded across all available devices (one shard per device, partial
voxel sets fused over the interconnect).  On a machine without multiple
accelerators this demonstrates on a virtual CPU mesh — set
XLA_FLAGS=--xla_force_host_platform_device_count=8 (the script injects it
when only one device is visible).

Multi-chip analog of the reference's octree work-chunking + join pipeline
(reference: src/cwipc_filters.cpp:113-130, :388-418).
"""

import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import cwipc_util_jax as cwipc
from cwipc_util_jax.parallel.mesh import cpu_devices, make_mesh
from cwipc_util_jax.parallel.pointaxis import sharded_chain


def main() -> int:
    # prefer real accelerators when the host has several; the virtual CPU
    # mesh is the fallback for single-device hosts
    real = jax.devices()
    devices = real if len(real) >= 2 else cpu_devices(2)
    if len(devices) < 2:
        print("example_sharded_chain: needs >= 2 (virtual) devices; got 1")
        return 0
    mesh = make_mesh(devices=devices)
    print(f"mesh: {len(devices)} x {devices[0].platform}")

    gen = cwipc.cwipc_synthetic(0, 16000)
    gen.start()
    pc = gen.get()
    gen.stop()
    print(f"input: {pc.count()} points")

    out = sharded_chain(
        mesh, pc._access_buffer(), cellsize=0.02, k=8, mult=2.0, tile=1
    )
    n = int(out.count)
    print(f"chain over {len(devices)} shards: {n} tile-1 survivors")
    assert 0 < n < pc.count()
    pc.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
