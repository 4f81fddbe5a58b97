"""A full-width SwinV2-B/384 PTQ4ViT calibration job on the card, judged
against the plain reference search.

    python scripts/torch_swinv2_calib_job.py [--seed N] [--jobs 2]

(``--config FILE --device cpu`` runs another configuration file's model
group on the CPU, the kernels' plain versions: a rehearsal at a tiny
size.)

Draws the weights (``benchmark/traffic/serve_swinv2.make_params``), 32
images and the probe noise from the seed, and runs ``--jobs`` jobs of
``ptq4vit_tpu_torch.api.quantize`` with the ``calib32`` mix's policy
(PTQ4ViT W8A8, micro-batches of 4, bfloat16 caches, int8 scoring): the
first builds and warms, the others are timed; the last runs under the
profiler for the seconds of its split-of-softmax searches
(``ptq.calib.search.sos_matmul`` spans, as ``search_sos_s`` reads them).
Then the ops the calibration cells' check would sample (``calib32``'s
``check_ops`` in each stage, a reduction, the patch embedding and the
head) are searched by the benchmark's plain PTQ4ViT search on the plain
V2 reference's capture (``benchmark/reference/swinv2.capture``), and the
timed job's intervals judged against them (``gap``, ``moved``).  Prints
one JSON line, with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness, model  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402
from benchmark.reference import calib as ref_calib  # noqa: E402
from benchmark.reference import swinv2 as ref  # noqa: E402
from benchmark.trace import profiled  # noqa: E402
from benchmark.traffic import calib as calib_traffic  # noqa: E402
from benchmark.traffic import serve_swinv2 as gen  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=2147483659)
    p.add_argument("--jobs", type=int, default=2)
    p.add_argument("--config", default=os.path.join(
        harness.HERE, "configs", "swinv2_b384.json"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the job runs on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ptq4vit_tpu_torch.api import quantize
    from ptq4vit_tpu_torch.models.registry import net_from_config
    from ptq4vit_tpu_torch.ops import build
    cuda = dev.type == "cuda"
    if cuda:
        build.build_all()
    cfg = harness.load_json(args.config)["model"]
    mix = harness.load_json(harness.HERE, "mixes", "calib32.json")
    params = gen.make_params(cfg, args.seed, dev)
    n = mix["images"]
    images = model.make_images(n, cfg, args.seed, dev)
    probe = model.make_probe_u(n, cfg, args.seed, dev)
    net = net_from_config(gen.port_config(cfg, "swinv2_b384"), params)
    x_host, u_host = images.cpu().numpy(), probe.cpu().numpy()

    def job():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        _, qstate, report = quantize(
            net, x_host, config=calib_traffic.policy(mix),
            bits=tuple(mix["bits"]), batch_size=mix["micro_batch"],
            device=dev, probe_u=u_host, int8_score=True,
            cache_dtype=mix["cache_dtype"], return_report=True)
        host = model.qstate_to_host(qstate)
        return (time.time() - t0, host, report,
                torch.cuda.max_memory_allocated() if cuda else 0)

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip() if cuda else "cpu", "seed": args.seed, "jobs": []}
    for i in range(max(args.jobs, 2)):
        last = i == max(args.jobs, 2) - 1
        if last:
            rec = {}
            with profiled(dev, rec):
                s, host, report, peak = job()
            sos = _spans.length_s(_spans.union(rec["trace"],
                                               "ptq.calib.search.sos_matmul"))
        else:
            s, host, report, peak = job()
            sos = None
        out["jobs"].append({
            "seconds": s, "traced": last, "search_sos_s": sos,
            "capture_peak_bytes": report.capture_peak_bytes,
            "peak_allocated_bytes": peak,
            "capture_s": report.capture_seconds,
            "search_s": sum(report.search_seconds.values())})
        print(json.dumps(out["jobs"][-1]), file=sys.stderr, flush=True)
    kinds = calib_traffic.sample_ops(
        types.SimpleNamespace(cfg=cfg, mix=mix, seed=args.seed))
    pol = ref_calib.Policy(mix)
    t0 = time.time()
    caches = ref.capture(params, cfg, images, probe, list(kinds),
                         micro=mix["micro_batch"],
                         cache_dtype=getattr(torch, mix["cache_dtype"]))
    reference = {k: ref_calib.search_op(kind, caches[k], params, k, pol,
                                        torch.float32)
                 for k, kind in kinds.items()}
    program = {k: {f: None if v is None else v.to(dev)
                   for f, v in model.plain_intervals(host[k]).items()}
               for k in kinds}
    numbers, worst = ref_calib.judge(kinds, caches, params, pol, program,
                                     reference)
    out.update(numbers, worst=worst, ops=len(kinds),
               reference_s=time.time() - t0,
               limits=harness.load_json(harness.HERE, "workloads",
                                        "swin_b384.calib32.json")["limits"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
