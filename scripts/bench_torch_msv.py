"""Time the MSV kernel of checkouts of the PyTorch port in turns.

    python3 scripts/bench_torch_msv.py ROOT_A ROOT_B [ROOT_C ...] [--out FILE]

Each root is a checkout holding ``pyhmmer_tpu_torch`` (for example this
tree and a ``git archive`` of its parent, unpacked into a directory that
``.gitignore`` lists).  The roots run in turns A, B, ..., ..., B, A, each
in a process of its own that imports that root's package and builds its
kernels.  A run times, with CUDA events on one card, ``msv_cuda.msv`` at
the smoke workload's shapes (the chunk holding most profiles against the
512 and 2048 buckets, the widest chunk against the 512 and the longest
bucket, the narrowest chunk and the most populous one of width 160-256
against the 512 bucket), then one warm and three timed ``SearchEngine.search`` calls of
the whole smoke search, whose ``s1_fetched`` stage mark (seconds from
the end of set-up until the MSV outputs reach the host) it reports with
the wall time.  ``torch.profiler`` splits each shape's device time by
kernel name over one more launch.  The card's name and power limit head
the output; the JSON record of every run goes to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

SHAPES = (("big", 512, 20), ("big", 2048, 20), ("huge", 512, 20),
          ("huge", "longest", 3), ("narrow", 512, 20), ("mid", 512, 20))


def worker(root):
    sys.path.insert(0, root)
    import torch
    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch import engine as E
    from pyhmmer_tpu_torch.ops import batch as B
    from pyhmmer_tpu_torch.ops import msv_cuda

    if not torch.cuda.is_available():
        sys.exit("bench_torch_msv: no CUDA device")
    queries, _, targets, _ = syn.smoke_workload()
    coalesced = E.group_queries(queries)
    devs = {b[3].Lmax: b[3] for b in E._Buckets(targets, "cuda").buckets}
    keys = {"big": max(coalesced, key=lambda k: len(coalesced[k])),
            "huge": max(coalesced), "narrow": min(coalesced),
            "mid": max((k for k in coalesced if 160 <= k <= 256),
                       key=lambda k: len(coalesced[k]))}
    bg = E.Background(queries[0].alphabet)
    pbs = {}
    for name, Mp in keys.items():
        profs = [E.Profile(queries[q].M, queries[q].alphabet).configure(
            queries[q], bg, 400, multihit=True)
            for q in coalesced[Mp][:E.P_MAX]]
        pbs[name] = B.ProfileBatch(profs, Mp=Mp).to("cuda")
    out = {"root": root, "shapes": []}
    for name, Lmax, reps in SHAPES:
        pb = pbs[name]
        dev = devs[max(devs) if Lmax == "longest" else Lmax]
        for _ in range(2):
            msv_cuda.msv(pb, dev)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            msv_cuda.msv(pb, dev)
        end.record()
        end.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            msv_cuda.msv(pb, dev)
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0:
                by_kernel[e.key[:40]] = us / 1e3
        out["shapes"].append({
            "shape": f"P{pb.P} x B{dev.B} x L{dev.Lmax} x Mk{32 * pb.S}",
            "ms": start.elapsed_time(end) / reps, "reps": reps,
            "profiled_ms_by_kernel": by_kernel})
    eng = E.SearchEngine(queries[0].alphabet, device="cuda")
    eng.search(queries, targets)
    out["s1_fetched_s"], out["wall_s"] = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        eng.search(queries, targets)
        torch.cuda.synchronize()
        out["wall_s"].append(time.time() - t)
        out["s1_fetched_s"].append(eng.last_timing["s1_fetched"])
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--worker")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker))
        return
    roots = [os.path.abspath(r) for r in args.roots]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for root in roots + roots[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            sys.exit(f"run on {root} failed:\n{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "runs": runs}, fh, indent=1)


if __name__ == "__main__":
    main()
