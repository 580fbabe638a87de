"""Example: record a fixed number of frames from any capturer to disk
(reference: examples/record.py).  Uses the synthetic capturer via the
generic registry so the same code works for real cameras."""

import sys
import tempfile

import cwipc_util_jax as cwipc


def main() -> None:
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    outdir = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp("cwipc_record")
    src = cwipc.cwipc_capturer('{"type":"synthetic"}')
    src.start()
    for i in range(count):
        if not src.available(True):
            break
        pc = src.get()
        if pc is None:
            break
        filename = f"{outdir}/frame-{i:04d}.cwipcdump"
        cwipc.cwipc_write_debugdump(filename, pc)
        print(f"recorded {filename} ts={pc.timestamp()} n={pc.count()}")
        pc.free()
    src.stop()


if __name__ == "__main__":
    main()
