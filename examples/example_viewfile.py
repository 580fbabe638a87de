"""Example: view a pointcloud file (reference: examples/viewfile.py).
Pass --nodisplay for headless environments."""

import sys
import tempfile
import threading

import cwipc_util_jax as cwipc
from cwipc_util_jax.io.visualizer import Visualizer
from cwipc_util_jax.models.playback import cwipc_playback


def view(source, headless: bool, max_frames: int) -> None:
    """Feed clouds from `source` into the Visualizer from a producer
    thread — the same source -> producer -> viewer-sink shape as the
    `cwipc view` script (scripts/cwipc_view.py)."""
    viz = Visualizer(nodisplay=headless)

    def feeder() -> None:
        shown = 0
        # also stop when the viewer quits (q): the producer must not
        # keep pulling frames from an infinite source
        while shown < max_frames and not source.eof() and not viz.stopped:
            if not source.available(True):
                break
            pc = source.get()
            if pc is None:
                break
            viz.feed(pc)
            shown += 1
        viz.stop()

    producer = threading.Thread(target=feeder, daemon=True)
    viz.set_producer(producer)
    producer.start()
    viz.run()
    producer.join(timeout=10)


def main() -> None:
    headless = "--nodisplay" in sys.argv
    files = [a for a in sys.argv[1:] if not a.startswith("-")]
    if not files:  # self-contained demo file
        d = tempfile.mkdtemp("cwipc_viewfile")
        gen = cwipc.cwipc_synthetic(0, 10000)
        gen.start()
        pc = gen.get()
        gen.stop()
        files = [f"{d}/demo.ply"]
        cwipc.cwipc_write(files[0], pc)
    src = cwipc_playback(files, loop=not headless)
    src.start()
    view(src, headless, max_frames=1 if headless else 10**9)
    src.stop()


if __name__ == "__main__":
    main()
