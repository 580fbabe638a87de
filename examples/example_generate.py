"""Example: write N synthetic frames as .ply files (reference: examples/generate.py)."""

import sys
import tempfile

import cwipc_util_jax as cwipc


def main() -> None:
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    outdir = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp("cwipc_generate")
    gen = cwipc.cwipc_synthetic(0, 10000)
    gen.start()
    for i in range(count):
        pc = gen.get()
        assert pc is not None
        filename = f"{outdir}/pointcloud-{pc.timestamp()}.ply"
        cwipc.cwipc_write(filename, pc, cwipc.CWIPC_FLAGS_BINARY)
        print(f"wrote {filename} ({pc.count()} points)")
        pc.free()
    gen.stop()


if __name__ == "__main__":
    main()
