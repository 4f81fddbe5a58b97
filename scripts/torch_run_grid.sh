#!/bin/bash
# The calibration grid of the PyTorch / CUDA port on the card, through
# bench_torch.py: the port's counterpart of scripts/run_grid.sh.  One
# process a model, run from the repository's root:
#   scripts/torch_run_grid.sh OUT CALIB MODEL...
# appends each model's final row (bench_torch.py's last stdout line: best-of
# and median minutes, capture / search seconds, peak_gib, the card, and
# vs_baseline against the reference's published minutes) to OUT and its
# per-repeat rows (stderr: minutes, num_groups, chunked_ops, chunked_calls)
# to OUT.repeats.  BENCH_REPEATS, BENCH_CONFIG, BENCH_BITS and the other
# knobs of bench_torch.py pass through.  Exits non-zero if any model's run
# failed (the others still run).
set -u -o pipefail
if [ "$#" -lt 3 ]; then
  echo "usage: $0 OUT CALIB MODEL..." >&2
  exit 2
fi
OUT="$1"
CALIB="$2"
shift 2
rc=0
for m in "$@"; do
  if ! BENCH_MODEL="$m" BENCH_CALIB="$CALIB" python bench_torch.py \
      2>>"$OUT.repeats" | tail -n 1 | tee -a "$OUT"; then
    echo "bench_torch.py failed on $m" >&2
    rc=1
  fi
done
exit $rc
