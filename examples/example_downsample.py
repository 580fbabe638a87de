"""Example: generate a synthetic cloud and voxel-downsample it on device
(the reference's python/examples downsample round trip)."""

import cwipc_util_jax as cwipc


def main() -> None:
    gen = cwipc.cwipc_synthetic(0, 40000)
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    print(f"generated {pc.count()} points, cellsize {pc.cellsize():.4f}")
    down = cwipc.cwipc_downsample(pc, pc.cellsize() * 4)
    print(f"downsampled to {down.count()} points at cellsize {down.cellsize():.4f}")


if __name__ == "__main__":
    main()
