"""The EXACT outlier-removal tier: fused exact chain vs the fast chain.

The reference's outlier removal (PCL StatisticalOutlierRemoval,
src/cwipc_filters.cpp:181-278) is exact k-NN; this framework carries two
tiers — the fast Morton-window approximation in the headline chain and
the certified-exact column-grid path (ops/cols_knn.py).  This example
runs both on the same cloud and prints how many keep decisions the
approximation flips (the keep threshold sits inside the distance
distribution, so this is never zero on real clouds).

Run: python examples/example_exact_outliers.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import cwipc_util_jax as cwipc
from cwipc_util_jax.ops.chain import (
    downsample_outliers_tilefilter,
    downsample_outliers_tilefilter_exact,
)


def main() -> int:
    gen = cwipc.cwipc_synthetic(0, 40000)
    gen.start()
    pc = gen.get()
    gen.stop()
    buf = pc._access_buffer()
    cellsize = jnp.float32(0.01)
    k, mult, tile = 12, jnp.float32(1.0), jnp.uint32(0)

    fast = downsample_outliers_tilefilter(
        buf, cellsize, k=k, mult=mult, tile=tile
    )
    exact, resid = downsample_outliers_tilefilter_exact(
        buf, cellsize, k=k, mult=mult, tile=tile,
        out_capacity=buf.capacity, gy=96, gz=96, cap=32,
    )
    nf, ne = int(fast.count), int(exact.count)

    inv = 1.0 / float(cellsize)
    fkeys = {
        tuple(v)
        for v in np.floor(np.asarray(fast.xyz[:nf]) * inv).astype(np.int64)
    }
    ekeys = {
        tuple(v)
        for v in np.floor(np.asarray(exact.xyz[:ne]) * inv).astype(np.int64)
    }
    flipped = len(fkeys ^ ekeys)
    print(f"fast chain survivors:  {nf}")
    print(f"exact chain survivors: {ne} (brute-force fixups: {int(resid)})")
    print(f"keep decisions the window approximation flips: {flipped}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
