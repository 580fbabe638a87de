"""Headline benchmark: fused downsample + outlier-removal + tilefilter chain
on a 1M-point synthetic cloud, on one NVIDIA GPU.

Each timed call runs one chain and ends in ``block_until_ready``; the
reported time is the median host wall time of the timed calls (the first
call, which compiles, is excluded).  The result line names the card
(``nvidia-smi`` name and power limit) and the device as JAX reports it.
Exits nonzero when JAX finds no GPU.

    python bench.py [--skip-exact] [--profile DIR]
"""

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import cwipc_util_jax  # noqa: F401  (enables the persistent compile cache)

REPS = 20  # timed calls of the fast chain; the exact chain takes REPS // 4


def _median_ms(fn, *args, reps=REPS):
    jax.block_until_ready(fn(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-exact", action="store_true",
                    help="skip the exact-outlier chain and the agreement metric")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a jax.profiler trace of the fast chain to DIR")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {jax.devices()})", file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    from cwipc_util_jax.core.buffers import PointBuffer
    from cwipc_util_jax.models.synthetic import _generate
    from cwipc_util_jax.ops.chain import (
        downsample_outliers_tilefilter,
        downsample_outliers_tilefilter_exact,
    )
    from cwipc_util_jax.ops.voxelize import downsample_cm

    hsteps = 1000  # 1,000,000 points
    n_points = hsteps * hsteps
    # the bench cloud reduces to ~217.6k voxels; 229376 leaves 5% headroom
    out_capacity = 229376
    cellsize = jnp.float32(2.0 / hsteps * 2.0)  # 4 mm voxels on 2 mm spacing
    k = 30
    mult = jnp.float32(1.0)
    tile = jnp.uint32(1)
    buf = _generate(hsteps, hsteps, 1 << 20, jnp.float32(0.5))

    def fast(b: PointBuffer):
        return downsample_outliers_tilefilter(
            b, cellsize, k=k, mult=mult, tile=tile, out_capacity=out_capacity)

    def exact(b: PointBuffer):
        out, _resid = downsample_outliers_tilefilter_exact(
            b, cellsize, k=k, mult=mult, tile=tile, out_capacity=out_capacity,
            gy=504, gz=152, cap=28)
        return out

    fast_ms = _median_ms(fast, buf)
    if args.profile:
        with jax.profiler.trace(args.profile):
            for _ in range(3):
                jax.block_until_ready(fast(buf))
    result = {
        "metric": "fast chain (downsample + window outliers + tilefilter), 1M points",
        "value": round(n_points / (fast_ms / 1e3)),
        "unit": "points/s",
        "fast_chain_ms": round(fast_ms, 4),
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if not args.skip_exact:
        exact_ms = _median_ms(exact, buf, reps=REPS // 4)
        result["exact_chain_ms"] = round(exact_ms, 4)
        result["exact_chain_points_per_s"] = round(n_points / (exact_ms / 1e3))

        # Keep-decision agreement of the fast chain with the exact chain:
        # both keep or drop whole voxels of the same downsample, so the
        # voxel-set symmetric difference counts the disagreements
        def voxel_set(out) -> set:
            n = int(out.count)
            keys = np.floor(np.asarray(out.xyz)[:n] / np.float32(cellsize))
            return {tuple(r) for r in keys.astype(np.int64)}

        total = int(jax.jit(lambda b: downsample_cm(b, cellsize, out_capacity)[4])(buf))
        sym_diff = len(voxel_set(fast(buf)) ^ voxel_set(exact(buf)))
        result["fast_keep_agreement_pct"] = round(100.0 * (total - sym_diff) / total, 2)
        result["fast_keep_agreement_metric"] = "voxel-set-symdiff"
    print(json.dumps(result))


if __name__ == "__main__":
    main()
