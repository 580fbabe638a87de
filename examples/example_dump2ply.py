"""Example: cwipcdump -> ply conversion round trip (reference example)."""

import sys
import tempfile

import cwipc_util_jax as cwipc


def main() -> None:
    gen = cwipc.cwipc_synthetic(0, 10000)
    gen.start()
    pc = gen.get()
    gen.stop()
    with tempfile.TemporaryDirectory() as d:
        dump = f"{d}/cloud.cwipcdump"
        ply = f"{d}/cloud.ply"
        cwipc.cwipc_write_debugdump(dump, pc)
        pc2 = cwipc.cwipc_read_debugdump(dump)
        cwipc.cwipc_write(ply, pc2, cwipc.CWIPC_FLAGS_BINARY)
        pc3 = cwipc.cwipc_read(ply, 0)
        assert list(pc3.get_points()) == list(pc.get_points())
        print(f"round trip ok: {pc3.count()} points")


if __name__ == "__main__":
    main()
