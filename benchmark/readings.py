"""Readings that set the limits of ``correct``: the program's numbers and
the control's (the reference in the precision below the configuration's)
over many seeds of one cell, in one process.

    python3 benchmark/readings.py --workload vit_b384.calib32 \
        --seeds 101,102,103 --seconds 1 [--warmup 0]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the check) with the control judged beside it; one JSON line a seed on
standard output: {"seed", "program": {...}, "control": {...}, "setup_s",
"reference_s"}.  ``--warmup`` overrides the mix's warm-up (jobs or
requests), which the numbers do not depend on.  Without a card it exits
3.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--warmup", type=int, default=None)
    args = p.parse_args()
    from benchmark import harness
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.host_threads(cell)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.warmup is not None:
        cell.mix = dict(cell.mix, warmup_jobs=args.warmup,
                        warmup=args.warmup)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        result, compared, run = harness.run_cell(
            cell, seed, args.seconds, False, "cuda:0", t0, control=True)
        print(json.dumps({
            "seed": seed,
            "program": {k: v for k, (v, _) in compared.items()},
            "control": run.records.get("control"),
            "attempted": run.attempted, "failed": run.failed,
            "setup_s": run.e2e["setup_s"],
            "reference_s": run.records.get("reference_s"),
            "seconds": time.time() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
