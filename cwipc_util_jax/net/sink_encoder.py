"""Encoder sink: pointclouds -> codec encoder group -> rawsink streams.

Re-implementation of the reference's encoder sink
(reference: python/cwipc/net/sink_encoder.py): a thread pulls clouds from a
bounded queue, compresses them with one encoder per
(tile x octree_bits x jpeg_quality) combination and feeds each compressed
packet to the rawsink's matching stream.  Fourcc "cwi1".
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from .. import codec
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.stats import Stats
from .abstract import cwipc_rawsink_abstract, cwipc_sink_abstract, cwipc_tileinfo_dict

DEFAULT_OCTREE_BITS = 9
DEFAULT_JPEG_QUALITY = 85


class _Sink_Encoder(threading.Thread, cwipc_sink_abstract):
    FOURCC = "cwi1"
    QUEUE_FULL_TIMEOUT = 0.001

    def __init__(self, sink: cwipc_rawsink_abstract, verbose: bool = False, nodrop: bool = False):
        threading.Thread.__init__(self, daemon=True)
        self.name = "cwipc_util_jax._Sink_Encoder"
        self.sink = sink
        self.sink.set_fourcc(self.FOURCC)
        self.verbose = verbose
        self.nodrop = nodrop
        self.producer = None
        self.input_queue: "queue.Queue[Optional[cwipc_pointcloud_wrapper]]" = queue.Queue(maxsize=2)
        self.stopped = False
        self.started = False
        self.stats = Stats("encoder")
        self.tiledescriptions: List[cwipc_tileinfo_dict] = [{}]
        self.octree_bits: List[int] = [DEFAULT_OCTREE_BITS]
        self.jpeg_quality: List[int] = [DEFAULT_JPEG_QUALITY]
        self.encoder_group: Optional[codec.cwipc_encodergroup_wrapper] = None
        self.encoders: List[codec.cwipc_encoder_wrapper] = []

    def set_encoder_params(self, tiles, octree_bits=None, jpeg_quality=None) -> None:
        if tiles is None:
            tiles = [{}]
        self.tiledescriptions = tiles
        if octree_bits is not None:
            self.octree_bits = [octree_bits] if isinstance(octree_bits, int) else list(octree_bits)
        if jpeg_quality is not None:
            self.jpeg_quality = [jpeg_quality] if isinstance(jpeg_quality, int) else list(jpeg_quality)

    def set_producer(self, producer) -> None:
        self.producer = producer
        self.sink.set_producer(producer)

    def _init_encoders(self) -> None:
        self.encoder_group = codec.cwipc_new_encodergroup()
        for tileIdx, tiledesc in enumerate(self.tiledescriptions):
            for octree_bits in self.octree_bits:
                for jpeg_quality in self.jpeg_quality:
                    srctile = tiledesc.get("cameraMask", 0)
                    params = codec.cwipc_encoder_params(
                        octree_bits=octree_bits,
                        jpeg_quality=jpeg_quality,
                        tilenumber=srctile,
                    )
                    self.encoders.append(self.encoder_group.addencoder(params=params))
                    self.sink.add_stream(
                        tileIdx, tiledesc, dict(octree_bits=octree_bits, jpeg_quality=jpeg_quality)
                    )

    def start(self) -> None:
        self._init_encoders()
        threading.Thread.start(self)
        self.sink.start()
        self.started = True

    def stop(self) -> None:
        # Drain: enqueue a sentinel and let the thread finish the backlog
        # (first-encode jit compiles can take tens of seconds on a cold
        # process, so the join timeout is generous).
        if self.started and self.is_alive():
            try:
                self.input_queue.put(None, timeout=30)
            except queue.Full:
                self.stopped = True
            self.join(timeout=120)
        self.stopped = True

    def is_alive(self) -> bool:
        return threading.Thread.is_alive(self)

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        try:
            if self.nodrop:
                # blocking, but responsive to a dead worker: an unbounded
                # put() would deadlock the producer forever if run() exited
                # on an encode error
                while not self.stopped and (not self.started or self.is_alive()):
                    try:
                        self.input_queue.put(pc, timeout=0.5)
                        return
                    except queue.Full:
                        continue
                if self.verbose:
                    print("encoder: worker stopped, dropping cloud")
            else:
                self.input_queue.put(pc, timeout=self.QUEUE_FULL_TIMEOUT)
        except queue.Full:
            if self.verbose:
                print("encoder: queue full, dropping cloud")

    def run(self) -> None:
        assert self.encoder_group is not None
        try:
            while not self.stopped:
                producer_done = (
                    self.producer is not None
                    and self.producer.ident is not None  # has started
                    and not self.producer.is_alive()
                )
                if producer_done and self.input_queue.empty():
                    break
                try:
                    pc = self.input_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if pc is None:
                    break
                t0 = time.time()
                self.encoder_group.feed(pc)
                packets = [enc.get_bytes() for enc in self.encoders]
                self.stats.add("encode_duration", time.time() - t0)
                self.stats.add("pointcount", pc.count(), isInt=True)
                for i, packet in enumerate(packets):
                    self.stats.add("packetsize", len(packet), isInt=True)
                    self.sink.feed(packet, stream_index=i)
                pc.free()
        finally:
            self.stopped = True
            self.sink.stop()

    def statistics(self) -> None:
        self.stats.print()
        self.sink.statistics()


def cwipc_sink_encoder(sink: cwipc_rawsink_abstract, verbose: bool = False, nodrop: bool = False) -> "_Sink_Encoder":
    """Sink that compresses pointclouds and forwards them to a rawsink."""
    return _Sink_Encoder(sink, verbose=verbose, nodrop=nodrop)
