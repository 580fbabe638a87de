"""End-to-end streaming throughput: forward -> TCP -> timing-sink loopback.

Measures the sustained full-stack delivery rate and end-to-end latency —
synthetic grab -> [encode] -> netserver TCP framing -> netclient ->
[decode] -> drop sink — over localhost, per config:

* ``raw``         — 16-byte point records, no codec (--noencode/--nodecode)
* ``compressed``  — the CTC1 codec path (octree geometry + JPEG colors)

The producer is PACED (default 30 fps, the production capture rate): an
unpaced synthetic source spins the grab loop flat out and — on a small
host — starves the encoder/serializer threads of CPU, so every queue
drops and the delivered rate collapses to a scheduling artifact instead
of the pipeline's capacity.  With pacing, the delivered rate is
min(offered, slowest-stage capacity) and the latency distribution shows
the drop-on-full freshness policy doing its job.

The consumer is ``cwipc timing``, which CSV-records each cloud's arrival
wall-clock (received_ms) and end-to-end latency (received - capture
timestamp); the steady-state rate comes from the arrival deltas with the
first WARMUP clouds (process spawn, socket dial, jit compiles) discarded.

The producer and the stage measurement run on the default JAX backend (the
GPU where there is one), so the codec's device geometry program is what
they exercise.  The consumer only decodes on the host and runs with
``JAX_PLATFORMS=cpu``, so one process holds the card.

Usage: python benchmarks/stream_bench.py [--npoints 160000] [--fps 30]
Prints one JSON line per config.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT = 200
WARMUP = 20


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(host_only: bool = False) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    if host_only:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _percentile(sorted_vals, q: float):
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def run_config(name: str, encode: bool, npoints: int,
               fps: int, count: int = COUNT, warmup: int = WARMUP) -> dict:
    env = _env()
    port = _free_port()
    fargs = [
        sys.executable, "-m", "cwipc_util_jax", "forward",
        "--synthetic", "--npoints", str(npoints), "--fps", str(fps),
        "--port", str(port),
        # no --count: unlimited; the producer is killed when done
    ]
    if not encode:
        fargs.append("--noencode")
    fwd = subprocess.Popen(
        fargs, env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    csv_path = tempfile.mktemp(suffix=".csv", prefix=f"stream_bench_{name}_")
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                if fwd.poll() is not None:
                    raise RuntimeError(f"forward exited rc={fwd.returncode}")
                time.sleep(0.2)
        else:
            raise RuntimeError("forward never opened its port")
        targs = [
            sys.executable, "-m", "cwipc_util_jax", "timing",
            "--netclient", f"localhost:{port}",
            "--count", str(count), "--output", csv_path,
        ]
        if not encode:
            targs.append("--nodecode")
        rc = subprocess.run(
            targs, env=_env(host_only=True), cwd=REPO, timeout=900,
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        ).returncode
        if rc != 0:
            raise RuntimeError(f"timing consumer exited rc={rc}")
        with open(csv_path) as fp:
            rows = list(csv.DictReader(fp))
    finally:
        fwd.terminate()
        try:
            fwd.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fwd.kill()
            fwd.wait()
        if os.path.exists(csv_path):
            os.unlink(csv_path)
    if len(rows) <= warmup + 1:
        raise RuntimeError(f"only {len(rows)} clouds recorded")
    steady = rows[warmup:]
    t0 = int(steady[0]["received_ms"])
    t1 = int(steady[-1]["received_ms"])
    n = len(steady) - 1
    per_cloud = max((t1 - t0) / 1e3 / n, 1e-9)
    lat = sorted(int(r["latency_ms"]) for r in steady)
    pts = int(steady[-1]["pointcount"])
    return {
        "config": name,
        "npoints": pts,
        "offered_fps": fps,
        "delivered_fps": round(1.0 / per_cloud, 2),
        "points_per_sec": round(pts / per_cloud),
        "latency_ms_p50": _percentile(lat, 0.50),
        "latency_ms_p95": _percentile(lat, 0.95),
        "measured_clouds": n + 1,
    }


# ---------------------------------------------------------------------------
# Per-stage serial costs: the DETERMINISTIC metric.
#
# On this 1-core shared VM the delivered fps fluctuates ±25-35% with
# machine load (BASELINE.md round-4 gotcha), so the number that supports
# cross-round claims is the measured SERIAL STAGE SUM: what one core pays
# per frame when the stages cannot overlap.  On any host with >= 2 cores
# the stages pipeline (each runs in its own thread/process already) and
# the ceiling becomes the slowest single stage instead.
# ---------------------------------------------------------------------------

_STAGE_SCRIPT = r"""
import json, socket, struct, sys, threading, time
import cwipc_util_jax as cwipc
from cwipc_util_jax.codec import cwipc_new_decoder, cwipc_new_encoder
from cwipc_util_jax.net.sink_netserver import pack_frame

npoints, encode, iters = int(sys.argv[1]), sys.argv[2] == "1", int(sys.argv[3])

def med_ms(fn, n=iters):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]

src = cwipc.cwipc_synthetic(0, npoints)
src.start()
out = {}

# grab + serialize (the producer stage: capture and wire-format the cloud)
state = {}
def grab_serialize():
    pc = None
    while pc is None:
        src.available(True)
        pc = src.get()
    state["packet"] = pc.get_packet()
    state["pc"] = pc
grab_serialize()  # warm any lazy init
out["grab_serialize"] = med_ms(grab_serialize)
pc, packet = state["pc"], bytes(state["packet"])

if encode:
    enc = cwipc_new_encoder(octree_bits=9, jpeg_quality=85)
    def do_encode():
        enc.feed(pc)
        state["bits"] = enc.get_bytes()
    do_encode()
    out["encode"] = med_ms(do_encode)
    payload = state["bits"]
else:
    payload = packet

# net transport: frame + localhost-TCP send/recv (what netserver ->
# netclient pays per cloud, without the inter-stage queues)
lsock = socket.socket(); lsock.bind(("127.0.0.1", 0)); lsock.listen(1)
csock = socket.create_connection(lsock.getsockname())
ssock, _ = lsock.accept()
csock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
ssock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
done = threading.Event()
need = len(pack_frame(0x30697763, payload))
def reader():
    while True:
        got = 0
        while got < need:
            b = csock.recv(1 << 20)
            if not b:
                return
            got += len(b)
        done.set()
threading.Thread(target=reader, daemon=True).start()
def net():
    done.clear()
    ssock.sendall(pack_frame(0x30697763, payload, 0))
    done.wait()
out["net"] = med_ms(net)

# consumer parse/decode back to a pointcloud
if encode:
    dec = cwipc_new_decoder()
    def decode():
        dec.feed(payload)
        dec.get().free()
    out["decode"] = med_ms(decode)
else:
    def parse():
        cwipc.cwipc_from_packet(packet).free()
    out["parse"] = med_ms(parse)

out["sum"] = sum(out.values())
print(json.dumps(out))
"""


def measure_stages(encode: bool, npoints: int, iters: int = 30) -> dict:
    """Median per-stage serial ms, measured in one subprocess with the
    same backend env as the pipeline subprocesses."""
    rv = subprocess.run(
        [sys.executable, "-c", _STAGE_SCRIPT, str(npoints),
         "1" if encode else "0", str(iters)],
        env=_env(), cwd=REPO, timeout=900, capture_output=True, text=True,
    )
    if rv.returncode != 0:
        raise RuntimeError(f"stage measurement failed: {rv.stderr[-800:]}")
    return json.loads(rv.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--npoints", type=int, default=160000,
                    help="synthetic cloud size (reference default 160k)")
    ap.add_argument("--fps", type=int, default=30,
                    help="offered (paced) capture rate")
    ap.add_argument("--count", type=int, default=COUNT)
    ap.add_argument("--configs", nargs="*", default=["raw", "compressed"])
    ap.add_argument("--stages-only", action="store_true",
                    help="skip the pipeline run; emit the per-stage serial "
                         "costs only (the deterministic metric)")
    args = ap.parse_args()
    for name in args.configs:
        encode = name == "compressed"
        stages = measure_stages(encode, args.npoints)
        res = {"config": name}
        if not args.stages_only:
            res = run_config(name, encode=encode,
                             npoints=args.npoints, fps=args.fps,
                             count=args.count)
        for k, v in stages.items():
            if k != "sum":
                res[f"stage_{k}_ms"] = round(v, 2)
        res["stage_sum_ms"] = round(stages["sum"], 2)
        res["stage_fps_capacity_1core"] = round(1000.0 / stages["sum"], 1)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
