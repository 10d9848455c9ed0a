"""Time the MSV, the Forward, the Viterbi or the survivor-rows kernels of
checkouts of the PyTorch port in turns.

    python3 scripts/bench_torch_msv.py ROOT_A ROOT_B [ROOT_C ...] \
        [--kernel msv|fwd|vit|rows] [--out FILE]

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
path really makes -- ``chip_smoke.main_path_launches`` (this tree's
``chip_smoke.py``, over the checkout's package) wraps
``fwd_cuda.forward`` from outside the package for one smoke search
(``SearchEngine.search``, rows off) and records every argument set it
was called with -- then at the
Forward parity shapes of ``chip_smoke.py`` (the same chunks, buckets and
seeded need masks, and the widest chunk against every lane of the
longest bucket), then at the launches of 32 to 128 slots a lane
(:func:`fwd_block_shapes`: 3,396 pairs at Mk 1,024, seeded stacks at Mk
2,048, 3,072 and 4,096, nhmmer's M 1,200 gate launches), where each
Mk 1,024 launch is also timed on the wide route's ``fwd_cta_kernel``
(:func:`cta_control_ms`).  Per launch it reports the pairs, P, Mk,
Lmax, the DP cells (the sum of M x L over the pairs), the time of the
call and the bound (``chip_smoke.bound``'s rule, with this tree's
operation counts), the device time of the Forward kernels alone
(kernel-only) and of every kernel of the call (``torch.profiler`` over five more calls), and the
scores (so runs of two checkouts can be compared); then the wall time
and ``s2_fetched`` stage mark of three more smoke searches.  Before all
that, each run takes the peak device memory of three
``hmmsearch(device="cuda")`` calls as ``chip_smoke.py`` phase 3 does, in
allocator blocks and requested bytes, per pool of the caching allocator
(:func:`search_memory`).

``--kernel vit`` does the same for ``vit_cuda.viterbi``, at the launches
of one smoke search and of one with the cascade forced
(``chip_smoke.FORCED``: the launches a Pfam-scale search would send),
then at the parity shapes and at every chunk width of the smoke
search against the 512 bucket (25% and 2% of every 8th lane); where the
checkout's wrapper has routes (``vit_cuda.ROUTES``, launched through
``vit_cuda._scores``) it also times the kernel-only time of each route
that compiles at the launch's width, and the route's largest score
difference from the default's; ``s3_fetched`` is the stage mark.
Each run also reports the ``-Xptxas -v`` registers and spills of the
kernel's instances.

``--kernel rows`` times ``rows_cuda.survivor_rows`` (as the engine calls
it) at every launch of one smoke search with the rows stage on and of
one with the cascade forced, then at ``chip_smoke.py``'s two rows parity
shapes: per launch the pairs, P, Mk, Lmax, every pair's length, the
call ms, the kernel-only ms (the rows kernels of a call summed, and by
kernel), the Forward filter kernel's on the same pairs, and each
route's where the checkout has routes (``rows_cuda.ROUTES``, launched
through ``rows_cuda._scores``); ``rows_done`` is the stage mark.

The last line summarises, per launch, each run's kernel-only and call
ms.

The card's name and power limit head the output; the JSON record of
every run goes to ``--out``.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

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


#: per --kernel: the wrapper's module and function, the kernels' names
#: (in the profiler's keys), and whether the forced cascade's launches
#: are captured too
FILTERS = {
    "fwd": ("fwd_cuda", "forward", ("fwd_kernel<", "fwd_wide_kernel<",
                                    "fwd_block_kernel<"),
            False),
    "vit": ("vit_cuda", "viterbi", ("vit_kernel<",),
            True),
}
#: calls a launch is profiled over
PROFILED = 5
#: this tree's root: its ``chip_smoke.py`` captures the launches and
#: builds the parity shapes for every checkout
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This tree's ``chip_smoke`` (the checkout's own may predate the
    helpers used here); it imports the package first on ``sys.path``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(call, names):
    """Device ms of one ``call``: of the kernels whose profiler key holds
    one of ``names`` (each kernel's mean over the launches the profiler
    recorded -- it may drop one -- summed over the kernels), and of every
    kernel of the call; profiled again where it recorded none of them."""
    import torch
    for _ in range(3):       # again where the profiler recorded none
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                call()
            torch.cuda.synchronize()
        events = [(e.key, getattr(e, "self_device_time_total", 0.0),
                   e.count) for e in prof.key_averages()]
        mine = {k: us / max(1, n) / 1e3 for k, us, n in events
                if any(name in k for name in names)}
        if mine:
            break
    return (sum(mine.values()),
            sum(us for _, us, _ in events) / 1e3 / PROFILED, mine)


def search_memory(queries, targets):
    """Peak device memory of three ``hmmsearch(device="cuda")`` calls
    after a warm one, as ``chip_smoke.py`` phase 3 takes it (each call
    builds its engine and tables anew), in allocator blocks and in
    requested bytes, over both pools of the caching allocator (requests
    up to 1 MiB share 2 MiB segments and are split to 512 bytes; larger
    ones keep a cached block whole when splitting it would leave 1 MiB
    or less, so their blocks can exceed what they asked for)."""
    import torch
    from pyhmmer_tpu_torch import hmmsearch
    list(hmmsearch(queries, targets, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        list(hmmsearch(queries, targets, device="cuda"))
        torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    return {f"{kind}_{pool}": stats.get(f"{kind}_bytes.{pool}.peak")
            for kind in ("allocated", "requested")
            for pool in ("all", "small_pool", "large_pool")}


def worker_filter(root, kernel):
    """The Forward or Viterbi wrapper of ``root`` at the main path's
    launches (and the forced cascade's), then at the parity shapes."""
    sys.path.insert(0, root)
    import importlib

    import numpy as np
    import torch

    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch import engine as E
    from pyhmmer_tpu_torch.ops import _build

    C = smoke_module()
    modname, fn, names, forced = FILTERS[kernel]
    mod = importlib.import_module(f"pyhmmer_tpu_torch.ops.{modname}")
    queries, _, targets, _ = syn.smoke_workload()
    memory = search_memory(queries, targets)
    eng = E.SearchEngine(queries[0].alphabet, device="cuda")
    eng.search(queries, targets)
    captured = [("main", c) for c in C.main_path_launches(
        mod, fn, queries, targets)]
    if forced:
        captured += [("forced", c) for c in C.main_path_launches(
            mod, fn, queries, targets, forced=True)]

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
    for Mp, Lmax in ((big, 512), (big, 2048), (mid, 512)):
        pb, dev = pbs[Mp], devs[Lmax]
        cols = torch.arange(0, dev.B, 8, device="cuda")
        need = torch.rand((pb.P, len(cols)), generator=gen) < 0.25
        captured.append(("parity", (pb, dev, cols, need.to("cuda"))))
    pb, dev = pbs[huge], devs[max(devs)]
    captured.append(("parity", (pb, dev, torch.arange(dev.B, device="cuda"),
                                torch.ones((pb.P, dev.B), dtype=torch.bool,
                                           device="cuda"))))
    # every chunk width of the smoke search against the 512 bucket, at a
    # survivor-like 25% of every 8th lane and at 2% (a launch of a few
    # dozen pairs, as the main path's are)
    gen = torch.Generator().manual_seed(1)
    dev = devs[512]
    cols = torch.arange(0, dev.B, 8, device="cuda")
    for Mp in sorted(coalesced):
        pb = pbs.get(Mp) or C.chunk_batch(queries, coalesced[Mp], Mp)
        for share in (0.25, 0.02):
            need = torch.rand((pb.P, len(cols)), generator=gen) < share
            captured.append((f"width{share}", (pb, dev, cols,
                                               need.to("cuda"))))
    if kernel == "fwd":
        captured += fwd_block_shapes(C, mod, pbs[huge], devs)

    # the kernel's code paths, where the checkout's wrapper has them
    routes = (list(mod.ROUTES)[1:] if hasattr(mod, "_scores") else [])
    out = {"root": root, "search_memory": memory, "launches": [],
           "ptxas": {k: v for k, v in C.ptxas_summary(
               _build.ptxas_report()).items()
               if any(k.startswith(n) for n in names)}}
    for kind, args in captured:
        pb, dev, rows, need = args[:4]
        call = lambda: getattr(mod, fn)(*args)  # noqa: E731
        reps = 3 if dev.Lmax > 8192 else 20
        ms = cuda_ms(call, reps)
        k_ms, d_ms, _ = kernel_ms(call, names)
        scores = call()
        route_ms = {}
        for route in routes:
            on_route = functools.partial(
                mod._scores, dev.codes, dev.lens, dev.lm, pb.vit_emis,
                pb.vit_trans, rows, need, args[4] if len(args) > 4 else None,
                route)
            try:
                route_ms[route] = kernel_ms(on_route, names)[0]
                err = (on_route() - scores)[need].abs().max().item()
                route_ms[route + "_max_abs_diff"] = err
            except RuntimeError:
                pass                     # not compiled at this width
        if kernel == "fwd" and pb.S and 32 * pb.S == 1024:
            route_ms["cta_control"] = cta_control_ms(pb, dev, rows, need)
        lens = torch.as_tensor(dev.lengths, dtype=torch.float64)[rows.cpu()]
        M = torch.as_tensor(pb.M, dtype=torch.float64)
        cells = float((M[:, None] * lens[None, :])[need.cpu()].sum())
        # inputs read once and the output written once (the tables of
        # both kernels hold the same bytes in every layout)
        nbytes = sum(t.numel() * t.element_size() for t in (
            dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans, rows,
            need)) + 4 * need.numel()
        out["launches"].append(dict(
            kind=kind, npairs=int(need.sum()), P=pb.P, Mk=32 * pb.S,
            Lmax=dev.Lmax, n=int(rows.shape[0]), cells=cells,
            bytes=nbytes, ms=ms, reps=reps, kernel_ms=k_ms, device_ms=d_ms,
            route_kernel_ms=route_ms, scores=scores[need].cpu().tolist()))
    out["stage_fetched_s"], out["wall_s"] = [], []
    mark = {"fwd": "s2_fetched", "vit": "s3_fetched"}[kernel]
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        eng.search(queries, targets)
        torch.cuda.synchronize()
        out["wall_s"].append(time.time() - t)
        out["stage_fetched_s"].append(eng.last_timing[mark])
    for kind in ("main", "forced"):
        out[f"{kind}_ms_total"] = float(np.sum(
            [r["ms"] for r in out["launches"] if r["kind"] == kind]))
        out[f"{kind}_kernel_ms_total"] = float(np.sum(
            [r["kernel_ms"] for r in out["launches"] if r["kind"] == kind]))
    print(json.dumps(out), flush=True)


def fwd_block_shapes(C, mod, pb1024, devs):
    """The Forward launches of 32 to 128 slots a lane beside the main
    path's: the Mk 1,024 chunk against every 4th lane of the 512 bucket,
    all needed (3,396 pairs, more than the card holds at once); seeded
    stacks of 4 models (``chip_smoke.block_stack``) at Mk 2,048, 3,072
    and 4,096 against the 512 bucket (18% of every 8th lane, about 300
    pairs) and against the longest bucket (its 2 lanes, 8 pairs);
    nhmmer's gate launches of its M 1,200 model (calibrated on the card
    first)."""
    import torch

    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch import nhmmer
    from pyhmmer_tpu_torch.plan7 import Background, Builder

    out = []
    dev = devs[512]
    cols = torch.arange(0, dev.B, 4, device="cuda")
    out.append(("many", (pb1024, dev, cols,
                         torch.ones((pb1024.P, len(cols)), dtype=torch.bool,
                                    device="cuda"))))
    gen = torch.Generator().manual_seed(2)
    longest = devs[max(devs)]
    for Mk in (2048, 3072, 4096):
        pb = C.block_stack(Mk)
        cols = torch.arange(0, dev.B, 8, device="cuda")
        need = torch.rand((pb.P, len(cols)), generator=gen) < 0.18
        out.append((f"mk{Mk}", (pb, dev, cols, need.to("cuda"))))
        out.append((f"mk{Mk}_long", (
            pb, longest, torch.arange(longest.B, device="cuda"),
            torch.ones((pb.P, longest.B), dtype=torch.bool,
                       device="cuda"))))
    models, genome, _ = syn.nhmmer_workload()
    h = next(m for m in models if m.M == 1200)
    Builder(genome.alphabet, device="cuda").calibrate(
        h, Background(genome.alphabet))
    _, calls = C.captured([(mod, "forward")],
                          lambda: list(nhmmer([h], genome, device="cuda")))
    out += [("nhmmer1200", c) for c in calls[0]]
    return out


def cta_control_ms(pb, dev, rows, need):
    """Kernel-only ms of the wide route's ``fwd_cta_kernel`` (512
    threads, the row in shared memory) on the same pairs of a Mk 1,024
    launch, its tables made thread-major here: the control the block
    route is held against.  None where the checkout has no wide route."""
    import numpy as np
    import torch

    from pyhmmer_tpu_torch.ops import _build, _pairs
    from pyhmmer_tpu_torch.ops import batch as B
    if not hasattr(_build.lib(), "fwd_cta_launch"):
        return None
    em, ei, tr = (t.cpu().numpy() for t in B.unpacked(pb.fwd_emis,
                                                       pb.fwd_trans))
    P, Mk, nt = em.shape[0], em.shape[2], B.CTA_THREADS
    emis = torch.from_numpy(np.ascontiguousarray(np.stack(
        [B.thread_major(em, nt), B.thread_major(ei, nt)], -1))).cuda()
    trans = torch.from_numpy(np.ascontiguousarray(B.thread_major(
        tr.reshape(P, 2, 4, Mk), nt).transpose(0, 3, 1, 4, 5, 2))).cuda()
    pair_p, pair_row, pair_out, out = _pairs.pairs(rows, need)
    npairs = int(pair_p.shape[0])
    nctas = _pairs.cta_grid(dev.codes.device, npairs)
    P_ = _build.ptr

    def call():
        err = _build.lib().fwd_cta_launch(
            P_(dev.codes), dev.codes.shape[1], P_(dev.lens), P_(dev.lm),
            P_(emis), P_(trans), P_(pair_p), P_(pair_row), P_(pair_out),
            npairs, emis.shape[1], Mk, nt, P_(out), None, nctas,
            _build.stream_ptr(dev.codes))
        _build.check(err, "fwd_cta_launch")
    return kernel_ms(call, ("fwd_cta_kernel<",))[0]


def worker_rows(root):
    """The survivor rows of ``root`` (``rows_cuda.survivor_rows``, as the
    engine calls it) at every launch of one smoke search with the rows
    stage on and of one with the cascade forced, then at the two rows
    parity shapes of ``chip_smoke.py``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch import engine as E
    from pyhmmer_tpu_torch.ops import _build, fwd_cuda, rows_cuda

    C = smoke_module()
    # fwd_rows_kernel and bck_rows_kernel
    names = ("rows_kernel<",)
    queries, _, targets, _ = syn.smoke_workload()
    memory = search_memory(queries, targets)
    captured = [(kind, c) for kind, forced in (("main", False),
                                               ("forced", True))
                for c in C.main_path_launches(
                    rows_cuda, "survivor_rows", queries, targets, forced,
                    device_rows=True)]
    coalesced = E.group_queries(queries)
    devs = {b[3].Lmax: b[3] for b in E._Buckets(targets, "cuda").buckets}
    big = max(coalesced, key=lambda k: len(coalesced[k]))
    mid = max((k for k in coalesced if 384 < k <= 768),
              key=lambda k: len(coalesced[k]))
    gen = torch.Generator().manual_seed(0)
    for Mp, Lmax, npairs in ((big, 512, 256), (mid, 2048, 64)):
        pb = C.chunk_batch(queries, coalesced[Mp], Mp)
        dev = devs[Lmax]
        captured.append(("parity", (pb, dev, *C.rows_pairs(pb, dev, npairs,
                                                           gen))))
    # the kernels' code paths, where the checkout's wrapper has them
    routes = list(getattr(rows_cuda, "ROUTES", {}))[1:]
    out = {"root": root, "search_memory": memory, "launches": [],
           "ptxas": {k: v for k, v in C.ptxas_summary(
               _build.ptxas_report()).items()
               if any(k.startswith(n.rstrip("<")) for n in names)}}
    for kind, (pb, dev, pair_p, pair_b) in captured:
        pair_p, pair_b = np.asarray(pair_p), np.asarray(pair_b)
        call = functools.partial(rows_cuda.survivor_rows, pb, dev, pair_p,
                                 pair_b)
        ms = cuda_ms(call, 20)
        k_ms, d_ms, by_kernel = kernel_ms(call, names)
        terms, fsc, bsc, order = call()
        # the Forward filter kernel on the same pairs: the forward rows
        # kernel runs its recurrence and also writes the rows
        cols, col = np.unique(pair_b, return_inverse=True)
        need = torch.zeros((pb.P, len(cols)), dtype=torch.bool)
        need[torch.as_tensor(pair_p, dtype=torch.long),
             torch.as_tensor(col, dtype=torch.long)] = True
        fwd_ms = kernel_ms(functools.partial(
            fwd_cuda.forward, pb, dev,
            torch.as_tensor(cols.astype(np.int64), device="cuda"),
            need.to("cuda")), ("fwd_kernel<",))[0]
        route_ms = {}
        if routes:
            pp = torch.as_tensor(pair_p[order], device="cuda")
            pr = torch.as_tensor(pair_b[order], device="cuda")
            for route in routes:
                on_route = functools.partial(
                    rows_cuda._scores, dev.codes, dev.lens, dev.lm,
                    pb.fwd_emis, pb.fwd_trans, pp, pr, route)
                try:
                    route_ms[route], _, split = kernel_ms(on_route, names)
                    route_ms[route + "_by_kernel"] = split
                    err = (on_route()[1] - fsc).abs().max().item()
                    route_ms[route + "_max_abs_diff"] = err
                except RuntimeError:
                    pass                 # not compiled at this width
        lens = dev.lengths[pair_b].astype(np.float64)
        cells = float((pb.M[pair_p].astype(np.float64) * lens).sum())
        # inputs read once, outputs written once: the packed tables (the
        # striped ones hold the same bytes), targets, pairs; terms and
        # both scores
        nbytes = (sum(t.numel() * t.element_size() for t in (
            dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans))
            + 8 * len(pair_p) + terms.numel() * 4 + 8 * len(pair_p))
        out["launches"].append(dict(
            kind=kind, npairs=len(pair_p), P=pb.P, Mk=32 * pb.S,
            Lmax=dev.Lmax, lengths=[int(x) for x in lens],
            residues=float(lens.sum()), cells=cells, bytes=nbytes, ms=ms,
            reps=20, kernel_ms=k_ms, device_ms=d_ms,
            kernel_ms_by_kernel=by_kernel, fwd_filter_kernel_ms=fwd_ms,
            route_kernel_ms=route_ms,
            scores=[float(x) for t in (fsc, bsc)
                    for x in t.cpu().numpy()[np.argsort(order)]]))
    eng = E.SearchEngine(queries[0].alphabet, device="cuda",
                         device_rows=True)
    eng.search(queries, targets)
    out["stage_fetched_s"], out["wall_s"] = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        eng.search(queries, targets)
        torch.cuda.synchronize()
        out["wall_s"].append(time.time() - t)
        out["stage_fetched_s"].append(eng.last_timing["rows_done"])
    for kind in ("main", "forced"):
        out[f"{kind}_ms_total"] = float(np.sum(
            [r["ms"] for r in out["launches"] if r["kind"] == kind]))
        out[f"{kind}_kernel_ms_total"] = float(np.sum(
            [r["kernel_ms"] for r in out["launches"] if r["kind"] == kind]))
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


def add_bounds(runs, kernel):
    """Each launch's bound (``chip_smoke.bound``'s rule with this tree's
    operation counts): Forward 16 float operations a cell at the FMA
    rate, Viterbi ``chip_smoke.vit_ops_s``."""
    sys.path.insert(0, HERE)
    C = smoke_module()
    for run in runs:
        for r in run["launches"]:
            if kernel == "rows":
                ops_s = C.rows_ops_s(r["cells"], r["residues"])
            elif kernel == "vit":
                ops_s = C.vit_ops_s(r["cells"])
            else:
                ops_s = C.FILTER_FLOPS * r["cells"] / C.F32_RATE
            bytes_s = r["bytes"] / C.HBM_RATE
            r["bound_ms"] = 1e3 * max(ops_s, bytes_s)
            r["bound_by"] = "operations" if ops_s >= bytes_s else "bytes"


def summary(runs):
    """Per launch (in capture order), each run's kernel-only ms, and the
    largest score difference between runs."""
    rows = []
    for i in range(min(len(run["launches"]) for run in runs)):
        r0 = runs[0]["launches"][i]
        rs = [run["launches"][i] for run in runs]
        diff = max(max((abs(a - b) for a, b in zip(r0["scores"],
                                                   r["scores"])),
                       default=0.0) for r in rs)
        rows.append({k: r0[k] for k in ("kind", "npairs", "P", "Mk", "Lmax",
                                        "bound_ms")}
                    | {"kernel_ms": [r["kernel_ms"] for r in rs],
                       "ms": [r["ms"] for r in rs],
                       "routes": [r["route_kernel_ms"] for r in rs],
                       "max_score_diff": diff})
    return {"per_launch": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--worker")
    ap.add_argument("--kernel", choices=("msv", "fwd", "vit", "rows"),
                    default="msv")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.worker:
        if args.kernel == "msv":
            worker(os.path.abspath(args.worker))
        elif args.kernel == "rows":
            worker_rows(os.path.abspath(args.worker))
        else:
            worker_filter(os.path.abspath(args.worker), args.kernel)
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
    if args.kernel != "msv":
        add_bounds(runs, args.kernel)
        print(json.dumps(summary(runs)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "kernel": args.kernel, "runs": runs},
                      fh, indent=1)


if __name__ == "__main__":
    main()
