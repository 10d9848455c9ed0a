"""Time the MSV or the Forward kernel of checkouts of the PyTorch port in
turns.

    python3 scripts/bench_torch_msv.py ROOT_A ROOT_B [ROOT_C ...] \
        [--kernel msv|fwd] [--out FILE]

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
kernel name over one more launch.

``--kernel fwd`` times ``fwd_cuda.forward`` (the wrapper with its pair
list, as the engine calls it) instead: first at the launches the main
path really makes -- the worker wraps ``fwd_cuda.forward`` from outside
the package for one warm smoke search (``SearchEngine.search``, rows
off) and records every argument set it was called with -- then at the
Forward parity shapes of ``chip_smoke.py`` (the same chunks, buckets and
seeded need masks, and the widest chunk against every lane of the
longest bucket).  Per launch it reports the pairs, P, Mk, Lmax, the DP
cells (the sum of M x L over the pairs), the time of the call and the
bound (``chip_smoke.bound``), the device time of the Forward kernel alone
and of every kernel of the call (``torch.profiler`` over one more call),
and the scores (so runs of two checkouts can be compared); then the
wall time and ``s2_fetched`` stage mark of three more smoke searches.

The card's name and power limit head the output; the JSON record of
every run goes to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

#: the Forward kernels' names (in the profiler's keys)
FWD_KERNELS = ("fwd_kernel<", "fwd_wide_kernel<")
SHAPES = (("big", 512, 20), ("big", 2048, 20), ("huge", 512, 20),
          ("huge", "longest", 3), ("narrow", 512, 20), ("mid", 512, 20))


def cuda_ms(fn, reps):
    """ms per call of ``fn`` over ``reps`` calls after two warm ones."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def worker_fwd(root):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as C
    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch import engine as E
    from pyhmmer_tpu_torch.ops import fwd_cuda

    queries, _, targets, _ = syn.smoke_workload()
    eng = E.SearchEngine(queries[0].alphabet, device="cuda")
    eng.search(queries, targets)
    calls = []
    real = fwd_cuda.forward

    def spy(*args):
        calls.append(args)
        return real(*args)
    fwd_cuda.forward = spy
    try:
        eng.search(queries, targets)
    finally:
        fwd_cuda.forward = real

    # the parity shapes of chip_smoke.phase_parity, same seeded masks
    coalesced = E.group_queries(queries)
    devs = {b[3].Lmax: b[3] for b in E._Buckets(targets, "cuda").buckets}
    big = max(coalesced, key=lambda k: len(coalesced[k]))
    mid = max((k for k in coalesced if 384 < k <= 768),
              key=lambda k: len(coalesced[k]))
    huge = max(coalesced)
    pbs = {Mp: C.chunk_batch(queries, coalesced[Mp], Mp)
           for Mp in (big, mid, huge)}
    gen = torch.Generator().manual_seed(0)
    parity = []
    for Mp, Lmax in ((big, 512), (big, 2048), (mid, 512)):
        pb, dev = pbs[Mp], devs[Lmax]
        cols = torch.arange(0, dev.B, 8, device="cuda")
        need = torch.rand((pb.P, len(cols)), generator=gen) < 0.25
        parity.append(("parity", pb, dev, cols, need.to("cuda"), 20))
    pb, dev = pbs[huge], devs[max(devs)]
    parity.append(("parity", pb, dev, torch.arange(dev.B, device="cuda"),
                   torch.ones((pb.P, dev.B), dtype=torch.bool,
                              device="cuda"), 3))

    out = {"root": root, "launches": []}
    for kind, pb, dev, rows, need, reps in (
            [("main", *c, 20) for c in calls] + parity):
        ms = cuda_ms(lambda: fwd_cuda.forward(pb, dev, rows, need), reps)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            scores = fwd_cuda.forward(pb, dev, rows, need)
            torch.cuda.synchronize()
        dev_us = {e.key: getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()}
        kernel_us = sum(us for k, us in dev_us.items()
                        if any(n in k for n in FWD_KERNELS))
        lens = torch.as_tensor(dev.lengths, dtype=torch.float64)[rows.cpu()]
        M = torch.as_tensor(pb.M, dtype=torch.float64)
        cells = float((M[:, None] * lens[None, :])[need.cpu()].sum())
        # the packed tables hold the bytes of the striped ones
        args = (dev.codes, dev.lens, dev.lm, pb.fwd_ems, pb.fwd_eis,
                pb.fwd_tr, rows, need)
        res = torch.empty(need.shape, dtype=torch.float32)
        out["launches"].append(dict(
            kind=kind, npairs=int(need.sum()), P=pb.P, Mk=32 * pb.S,
            Lmax=dev.Lmax, n=int(rows.shape[0]), cells=cells, ms=ms,
            reps=reps, kernel_ms=kernel_us / 1e3,
            device_ms=sum(dev_us.values()) / 1e3,
            scores=scores[need].cpu().tolist(),
            **C.bound(C.FILTER_FLOPS * cells / C.F32_RATE, args, (res,))))
    out["s2_fetched_s"], out["wall_s"] = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        eng.search(queries, targets)
        torch.cuda.synchronize()
        out["wall_s"].append(time.time() - t)
        out["s2_fetched_s"].append(eng.last_timing["s2_fetched"])
    out["main_ms_total"] = float(np.sum([r["ms"] for r in out["launches"]
                                         if r["kind"] == "main"]))
    print(json.dumps(out), flush=True)


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
    ap.add_argument("--kernel", choices=("msv", "fwd"), default="msv")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.worker:
        {"msv": worker, "fwd": worker_fwd}[args.kernel](
            os.path.abspath(args.worker))
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
                              "--worker", root, "--kernel", args.kernel],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.exit(f"run on {root} failed:\n{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if k != "launches"}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "kernel": args.kernel, "runs": runs},
                      fh, indent=1)


if __name__ == "__main__":
    main()
