"""calib_mfu: a job's work (search and capture, counts.py) at the
published peaks, over the time of a job of the traced run (its untraced
jobs' mean, else the traced one), in percent."""
from benchmark import counts


def read(run):
    jobs = run.records.get("jobs") or [j for j in [
        run.records.get("traced_job")] if j]
    if not jobs:
        return None
    wall = sum(j[1] - j[0] for j in jobs) / len(jobs)
    mix = run.mix
    work = counts.calib_work(run.cfg, mix["images"], mix.get("eq_n", 100),
                             mix.get("search_round", 3))
    t = counts.peak_seconds(work["search"]) + \
        counts.peak_seconds(work["capture"])
    return 100.0 * t / wall
