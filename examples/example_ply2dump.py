"""Example: ply -> cwipcdump conversion (reference: examples/ply2dump.py)."""

import sys
import tempfile

import cwipc_util_jax as cwipc


def main() -> None:
    if len(sys.argv) >= 3:
        src, dst = sys.argv[1], sys.argv[2]
        pc = cwipc.cwipc_read(src, 0)
    else:  # self-contained demo
        d = tempfile.mkdtemp("cwipc_ply2dump")
        src, dst = f"{d}/in.ply", f"{d}/out.cwipcdump"
        gen = cwipc.cwipc_synthetic(0, 5000)
        gen.start()
        pc = gen.get()
        gen.stop()
        cwipc.cwipc_write(src, pc)
        pc = cwipc.cwipc_read(src, 0)
    cwipc.cwipc_write_debugdump(dst, pc)
    print(f"{src} ({pc.count()} points) -> {dst}")


if __name__ == "__main__":
    main()
