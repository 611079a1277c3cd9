#!/usr/bin/env bash
# Full test suite on the CPU, in CHUNKED pytest processes.
#
# The suite runs on JAX's CPU backend (conftest.py: an 8-device virtual
# mesh, the fused kernel in Pallas interpret mode).  Each chunk is a fresh
# pytest process, which keeps any one process's compile count bounded; the
# suite is green iff every chunk is.  Tests marked `gpu` skip here; on a
# machine with the card they run with
#   MONTECARLO_TEST_GPU=1 python -m pytest -m gpu tests/
#
# Usage: ./run_tests.sh [extra pytest args]

set -u
cd "$(dirname "$0")"

N_CHUNKS=${N_CHUNKS:-4}
# The CLI combination matrix alone compiles a few hundred tiny XLA:CPU
# programs — it runs as its OWN pytest process (after the chunks) rather
# than stacking that onto a quarter of the suite (the SIGSEGV horizon).
mapfile -t FILES < <(ls tests/test_*.py | grep -v test_cli_matrix | sort)

declare -a CHUNKS
for idx in "${!FILES[@]}"; do
    c=$((idx % N_CHUNKS))
    CHUNKS[c]="${CHUNKS[c]:-} ${FILES[idx]}"
done

total_fail=0
for c in $(seq 0 $((N_CHUNKS - 1))); do
    # An empty chunk (N_CHUNKS > file count) would invoke pytest with no
    # paths, which collects the whole tests/ tree in one long-lived
    # process — the exact SIGSEGV scenario the chunking avoids.
    if [ -z "${CHUNKS[c]:-}" ]; then
        echo "=== chunk $((c + 1))/$N_CHUNKS === (empty, skipped)"
        continue
    fi
    echo "=== chunk $((c + 1))/$N_CHUNKS ==="
    # shellcheck disable=SC2086
    python -m pytest ${CHUNKS[c]} -q "$@"
    rc=$?
    if [ $rc -ne 0 ]; then
        echo "chunk $((c + 1)) FAILED (rc=$rc)"
        total_fail=1
    fi
done

echo "=== cli-matrix (dedicated process) ==="
python -m pytest tests/test_cli_matrix.py -q "$@"
if [ $? -ne 0 ]; then
    echo "cli-matrix FAILED"
    total_fail=1
fi

if [ $total_fail -eq 0 ]; then
    echo "ALL CHUNKS GREEN"
else
    echo "SUITE FAILED"
fi
exit $total_fail
