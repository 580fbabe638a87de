#!/bin/bash
# E2E CLI combo sweep — flag combinations the unit tests don't exercise.
# Runs on CPU (JAX_PLATFORMS=cpu); exits nonzero on any failure.
# History: this sweep caught the cwipc copy single-file dispatch gap that
# the flag-parity tests missed — run it each round.
set -u
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO"
export JAX_PLATFORMS=cpu
CLI="python -m cwipc_util_jax"
rm -rf /tmp/e2e_sweep_dir && mkdir -p /tmp/e2e_sweep_dir && cd /tmp/e2e_sweep_dir
fails=0
run() {
  desc="$1"; shift
  if timeout 240 "$@" > "last_out.txt" 2>&1; then
    echo "OK   $desc"
  else
    echo "FAIL $desc (rc=$?)"
    tail -5 last_out.txt | sed 's/^/     /'
    fails=$((fails+1))
  fi
}

# 1. view with a filter chain + latency CSV
run "view filter-chain + latencies" $CLI view --synthetic --npoints 20000 --count 3 --nodisplay \
    --filter "voxelize(0.02)" --latencies lat.csv
# 2. grab compressed, then play it back
mkdir -p cdump
run "grab compressed" $CLI grab --synthetic --npoints 20000 --count 3 --compress ./cdump
run "play compressed with count" $CLI play --count 2 --nodisplay ./cdump
# 3. grab ply, copy single ply -> single cwipcdump -> back to ply
mkdir -p plydir
run "grab ply" $CLI grab --synthetic --npoints 20000 --count 2 ./plydir
PLY=$(ls ./plydir/*.ply | head -1)
run "copy ply->dump single" $CLI copy "$PLY" out.cwipcdump
run "copy dump->ply single" $CLI copy out.cwipcdump back.ply
run "copy dump->cwicpc single" $CLI copy out.cwipcdump out.cwicpc
run "copy cwicpc->ply single" $CLI copy out.cwicpc roundtrip.ply
# 4. copy dir -> auto-created dir, compressed
run "copy dir->dir compress" $CLI copy --compress ./plydir ./cstream
test -n "$(ls ./cstream/*.cwicpc 2>/dev/null)" && echo "OK   cstream has cwicpc" || { echo "FAIL cstream empty"; fails=$((fails+1)); }
# 5. join ply + dump
run "join mixed formats" $CLI join joined.ply "$PLY" out.cwipcdump
# 6. timing on synthetic
run "timing synthetic" $CLI timing --synthetic --npoints 20000 --count 3 --output timing.csv
# 7. view playback of plydir with loop bounded by count
run "view playback loop+count" $CLI view --playback ./plydir --loop --count 5 --nodisplay
# 8. view with retimestamp + fps
run "view retimestamp fps" $CLI view --synthetic --npoints 20000 --fps 15 --retimestamp --count 3 --nodisplay
# 9. analyze_registration on a single grabbed cloud (tiled via filter first)
mkdir -p tiled
run "grab tiled" $CLI grab --synthetic --npoints 20000 --count 1 --filter "simulatecams(3)" ./tiled
TPLY=$(ls ./tiled/*.ply | head -1)
run "analyze_registration" $CLI analyze_registration "$TPLY"
# 10. multi-filter chain
run "view two filters" $CLI view --synthetic --npoints 20000 --count 3 --nodisplay \
    --filter "voxelize(0.02)" --filter "colorize(0.5,'camera')"
# 11. profile flag writes a trace
run "view profile trace" $CLI view --synthetic --npoints 20000 --count 2 --nodisplay --profile ./trace
test -n "$(ls -A ./trace 2>/dev/null)" && echo "OK   trace dir non-empty" || { echo "FAIL trace dir empty"; fails=$((fails+1)); }

echo "sweep done, failures: $fails"
exit $fails
