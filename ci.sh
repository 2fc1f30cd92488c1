#!/usr/bin/env bash
# One-command CI gate — run before every round-end commit.
#
# The reference enforces its suite serially AND under `mpirun -n 2`
# (reference .github/workflows/main.yml:19-46, main-mpi.yml:15-31);
# here one pytest run covers both because conftest.py builds an
# 8-virtual-device CPU mesh and the parallel tests shard over it.
#
# Stages (each independently fatal):
#   1. full test suite (serial + 8-virtual-device sharded, one run)
#   2. entry-point compile checks (entry + dryrun_multichip(8))
#   3. quick bench smoke on the CPU (`bench.py --cpu`; prints the JSON line)
#   4. demo smoke: every demo that advertises --quick, headless
#
# All stages run on the CPU.  On the GPU, `python chip_smoke.py` is the
# check (and `BEAT_TEST_GPU=1 python -m pytest -m gpu tests/`).
#
# Usage: ./ci.sh [--fast]   (--fast skips stage 4)
set -euo pipefail
cd "$(dirname "$0")"
FAST=${1:-}

echo "=== [1/4] test suite ==="
python -m pytest tests/ -q
# the NumPy fallbacks only engage when the native kit cannot build —
# exercise them explicitly on the assembly/FEM surface
BEAT_TPU_NO_NATIVE=1 python -m pytest tests/test_stencil.py tests/test_fem_core.py tests/test_monodomain.py -q

echo "=== [2/4] entry-point compile checks ==="
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
python - <<'EOF'
import jax
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
print("entry(): compiles")
g.dryrun_multichip(8)
print("dryrun_multichip(8): ok")
EOF

echo "=== [3/4] quick bench smoke + docs freshness ==="
timeout 600 python bench.py --cpu --quick
JAX_PLATFORMS=cpu python docs/gen_api.py --check

if [ "$FAST" = "--fast" ]; then
    echo "=== --fast: skipping demo smoke ==="
    echo "CI GATE PASSED (fast)"
    exit 0
fi

echo "=== [4/4] demo smoke (--quick, headless, CPU-pinned) ==="
export MPLBACKEND=Agg
export JAX_PLATFORMS=cpu
SMOKE=DEMO_SMOKE.json
echo '{"demos": {' > "$SMOKE.tmp"
first=1
for demo in demos/*.py; do
    name=$(basename "$demo" .py)
    [ $first = 1 ] || echo ',' >> "$SMOKE.tmp"
    first=0
    if grep -q -- '--quick' "$demo"; then
        echo "--- $demo --quick"
        t0=$SECONDS
        timeout 180 python "$demo" --quick
        printf '"%s": {"status": "ok", "seconds": %d}' "$name" $((SECONDS - t0)) >> "$SMOKE.tmp"
    else
        echo "--- $demo (no --quick path; skipped)"
        printf '"%s": {"status": "no --quick path"}' "$name" >> "$SMOKE.tmp"
    fi
done
printf '},\n"date": "%s"}\n' "$(date -u +%Y-%m-%dT%H:%M:%SZ)" >> "$SMOKE.tmp"
mv "$SMOKE.tmp" "$SMOKE"
echo "demo smoke artifact: $SMOKE"

echo "CI GATE PASSED"
