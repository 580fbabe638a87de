"""Example: view a live capturer through the generic registry
(reference: examples/viewcamera.py).  With no real camera plugin present
this opens the synthetic capturer; a cameraconfig.json or inline JSON
selects real hardware when its plugin is registered."""

import sys
import threading

import cwipc_util_jax as cwipc
from cwipc_util_jax.io.visualizer import Visualizer


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
    configs = [a for a in sys.argv[1:] if not a.startswith("-")]
    config = configs[0] if configs else '{"type":"synthetic"}'
    src = cwipc.cwipc_capturer(config)
    src.start()
    view(src, headless, max_frames=10 if headless else 10**9)
    src.stop()


if __name__ == "__main__":
    main()
