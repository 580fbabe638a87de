"""Example: play back a recorded directory of frames in the viewer
(reference: examples/viewrecording.py).  Records a small synthetic
sequence first if no directory is given."""

import os
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
    dirs = [a for a in sys.argv[1:] if not a.startswith("-")]
    if dirs:
        dirname = dirs[0]
    else:
        dirname = tempfile.mkdtemp("cwipc_viewrecording")
        gen = cwipc.cwipc_synthetic(0, 5000)
        gen.start()
        for i in range(3):
            pc = gen.get()
            cwipc.cwipc_write(f"{dirname}/frame-{i:04d}.ply", pc)
            pc.free()
        gen.stop()
    # play whatever the recording contains (.ply, .cwipcdump or .cwicpc —
    # e.g. example_record.py writes .cwipcdump frames)
    exts = [e for e in (".ply", ".cwipcdump", ".cwicpc")
            if any(f.lower().endswith(e) for f in os.listdir(dirname))]
    src = cwipc_playback(dirname, ext=exts[0] if exts else ".ply",
                         loop=not headless, fps=10)
    src.start()
    view(src, headless, max_frames=3 if headless else 10**9)
    src.stop()


if __name__ == "__main__":
    main()
