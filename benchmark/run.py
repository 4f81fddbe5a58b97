"""The benchmark of ptq4vit_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload vit_b384.calib32 --seed 7 \
        --seconds 51 --trace 0

Prints the run's result as the last line of standard output (one JSON
object: correct, attempted, failed, metrics, device, with --trace 1 also
breakdown, then the numbers compared with their limits under "check"),
and those numbers beside their limits as the last lines of standard
error.  Without a card it exits 3 and prints no result.
"""
import os
import sys
import time

T0 = time.time()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main(t0=T0))
