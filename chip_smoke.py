"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Drives ``pyhmmer_tpu_torch`` end to end on the seeded smoke workload
(``pyhmmer_tpu_torch/_synthetic.py``: ~245 sampled profile HMMs against
4,002 targets) and fails (non-zero exit) on any of:

1. environment: no CUDA device, a device that is not sm_90, the host
   native library missing, or a kernel that does not build;
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at main-path shapes, with the bars below; both are timed
   with CUDA events (warm, many launches, in turns plain/kernel/kernel/
   plain; the survivor-rows kernel against one timed plain call);
3. search: ``hmmsearch(device="cuda")`` once warm, then three timed runs;
   every kernel's launch counter must be > 0 in the last run (the rows
   kernel's must stay 0); a fifth run through ``SearchEngine.search``
   reads the engine's stage marks.  Then the same with the device rows
   stage on (``device_rows=True``): the rows kernel's counter and the
   engine's ``n_rows_ext`` must be > 0;
4. correctness: for three distinct queries (padded model width <= 384,
   384..768 and > 768), the reported rows of the search equal the
   sequential oracle pipeline's over the same targets, with the same Z;
   and with the cascade forced (no speculation, no sparse host path), a
   search with the rows stage on reports for every query the same
   names, inclusion, domain envelopes and pass counts as one with it
   off, with scores and biases within 2e-3 bits;
5. ``jax`` was never imported.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the kernels' JSON record.
"""

import json
import re
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False")

import numpy as np  # noqa: E402

from pyhmmer_tpu import hmmer as oracle_hmmer  # noqa: E402
from pyhmmer_tpu.ops import native  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch import engine as E  # noqa: E402
from pyhmmer_tpu_torch import hmmsearch  # noqa: E402
from pyhmmer_tpu_torch.ops import _build  # noqa: E402
from pyhmmer_tpu_torch.ops import batch as B  # noqa: E402
from pyhmmer_tpu_torch.ops import (fwd_cuda, msv_cuda, rows_cuda,  # noqa: E402
                                   vit_cuda)

NEG_LIVE = -1e29
#: kernel-vs-plain bars (nats): f32 summation order only
VIT_TOL = 1e-3
FWD_TOL = 5e-3
#: rows bars: fsc and bsc (nats); btot, etot and mocc after an f64
#: cumsum (the JAX package's, tests/test_rows_pallas.py:111-116)
ROWS_SC, ROWS_ATOL, ROWS_RTOL = 2e-3, 3e-4, 2e-3
#: score and bias bar (bits) of the rows-on search against rows off
#: (tests/test_engine_pallas.py:63-73,106-109)
ROWS_SCORE_TOL = 2e-3
KERNELS = {
    "msv": (msv_cuda, "pyhmmer_tpu_torch/csrc/msv.cu",
            "pyhmmer_tpu/ops/msv_pallas.py:355"),
    "fwd": (fwd_cuda, "pyhmmer_tpu_torch/csrc/fwd.cu",
            "pyhmmer_tpu/ops/fwd_pallas.py:586,156"),
    "vit": (vit_cuda, "pyhmmer_tpu_torch/csrc/vit.cu",
            "pyhmmer_tpu/ops/vit_pallas.py:149"),
    "rows": (rows_cuda, "pyhmmer_tpu_torch/csrc/rows.cu",
             "pyhmmer_tpu/ops/rows_pallas.py:473,510"),
}
#: the kernels each search path runs
PATHS = {False: ("msv", "fwd", "vit"), True: ("msv", "fwd", "vit", "rows")}
#: routing that sends every bias survivor through the device cascade
#: (tests/test_torch_engine.py:force_device_cascade)
FORCED = {"SPECULATE_P1B": -1.0, "HOST_MIN_PAIRS": 0,
          "HOST_PAIRS_PER_ROW": 0.0}


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains)) for h in th.reported]


def ptxas_summary(report):
    """{kernel<S>: registers, static shared memory and spill bytes} from
    the ``-Xptxas -v`` report (``msv_kernel`` also takes Kp*S*32 + 128
    bytes of dynamic shared memory at launch)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)ILi(\d+)EE",
                      line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            out[name] = {"smem_static": 0}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            out[name].update(spill_st=int(st), spill_ld=int(ld))
        elif name and "registers" in line:
            out[name]["regs"] = int(re.search(r"(\d+) registers",
                                              line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[name]["smem_static"] = int(m.group(1))
    return out


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), ms) of one call, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def in_turns(kernel, plain, reps_k, reps_p):
    """(kernel ms, plain ms), each the mean of two runs taken in turns
    plain/kernel/kernel/plain; the parity calls before it warm both."""
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, reps_p)
    k1 = cuda_ms(kernel, reps_k)
    k2 = cuda_ms(kernel, reps_k)
    p2 = cuda_ms(plain, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_environment(smi):
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"device capability {cap} is not sm_90")
    if not native.available():
        fail("pyhmmer_tpu.ops.native is not available (g++ build failed?)")
    t = time.time()
    _build.lib()
    build_s = time.time() - t
    say("environment", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        build_s=build_s, nvcc_flags=" ".join(_build.NVCC_FLAGS))
    for kern, info in ptxas_summary(_build.ptxas_report()).items():
        say("ptxas", kernel=kern, **info)


def chunk_batch(queries, qidx, Mp):
    from pyhmmer_tpu.plan7.background import Background
    from pyhmmer_tpu.plan7.profile import Profile
    bg = Background(queries[0].alphabet)
    profs = [Profile(queries[q].M, queries[q].alphabet).configure(
        queries[q], bg, 400, multihit=True) for q in qidx[:E.P_MAX]]
    return B.ProfileBatch(profs, Mp=Mp).to("cuda")


def phase_parity(queries, targets):
    """Each kernel against its plain version at main-path shapes: the
    chunk holding most profiles, a chunk with 384 < Mp <= 768 and the
    widest chunk, against the buckets the search gives them.  ``tpu``
    names the JAX package's route for the same shape."""
    coalesced = E.group_queries(queries)
    devs = {b[3].Lmax: b[3] for b in E._Buckets(targets, "cuda").buckets}
    big = max(coalesced, key=lambda k: len(coalesced[k]))
    mid = max((k for k in coalesced if 384 < k <= 768),
              key=lambda k: len(coalesced[k]))
    huge = max(coalesced)
    pbs = {Mp: chunk_batch(queries, coalesced[Mp], Mp)
           for Mp in (big, mid, huge)}
    gen = torch.Generator().manual_seed(0)
    results = {k: [] for k in KERNELS}

    # MSV: every pair of a chunk x bucket
    for Mp, Lmax in ((big, 512), (big, 2048), (huge, 512)):
        pb, dev = pbs[Mp], devs[Lmax]
        args = (dev.codes, dev.lens, pb.msv_cost8, pb.msv_scal,
                pb.msv_odds, dev.tjb, dev.p1)
        k = msv_cuda.msv_scores(*args)
        p = msv_cuda.msv_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            fail(f"msv dx/ovf differ from the plain version (Mp {Mp}, "
                 f"Lmax {Lmax})")
        berr = (k[2] - p[2]).abs()
        bar = 0.25 * (2e-3 + 1e-6 * dev.lens.float().clamp(min=1))
        if not bool((berr <= bar[None, :]).all()):
            fail(f"msv biaslog off by {berr.max().item()} (Mp {Mp}, "
                 f"Lmax {Lmax})")
        ms, plain_ms = in_turns(lambda: msv_cuda.msv_scores(*args),
                                lambda: msv_cuda.msv_plain(*args), 20, 2)
        results["msv"].append(dict(
            shape=f"P{pb.P} x B{dev.B} x L{Lmax} x Mk{32 * pb.S}",
            tpu="_msv_pallas2",  # every Mp here is under its row cap
            max_abs_err=berr.max().item(), ms=ms, plain_ms=plain_ms))
        say("parity", kernel="msv", **results["msv"][-1],
            bar="dx, ovf exact; biaslog <= 0.25*(2e-3+1e-6 L)")

    # Forward / Viterbi: survivor-like columns (every 8th lane) with a
    # 25% need mask; the widest chunk x every lane of the long bucket
    cases = []
    for Mp, Lmax in ((big, 512), (big, 2048), (mid, 512)):
        pb, dev = pbs[Mp], devs[Lmax]
        cols = torch.arange(0, dev.B, 8, device="cuda")
        need = (torch.rand((pb.P, len(cols)), generator=gen) < 0.25)
        cases.append((pb, dev, cols, need.to("cuda"), 10, 1))
    pb, dev = pbs[huge], devs[max(devs)]
    cases.append((pb, dev, torch.arange(dev.B, device="cuda"),
                  torch.ones((pb.P, dev.B), dtype=torch.bool,
                             device="cuda"), 3, 1))
    for pb, dev, cols, need, reps_k, reps_p in cases:
        if pb.Mp > 768 or dev.Lmax > 8192:
            route = "batch XLA scan"
        else:
            route = "_pallas3" if pb.Mp <= 384 else "_pallas2"
        for name, fn, plain, tol, tabs in (
                ("fwd", fwd_cuda.fwd_scores, fwd_cuda.fwd_plain, FWD_TOL,
                 ("fwd_ems", "fwd_eis", "fwd_tr")),
                ("vit", vit_cuda.vit_scores, vit_cuda.vit_plain, VIT_TOL,
                 ("vit_msc", "vit_isc", "vit_tr"))):
            args = (dev.codes, dev.lens, dev.lm,
                    *(getattr(pb, t) for t in tabs), cols, need)
            k = fn(*args)
            p = plain(*args)
            torch.cuda.synchronize()
            live = (k > NEG_LIVE) & (p > NEG_LIVE)
            if not torch.equal(k > NEG_LIVE, p > NEG_LIVE):
                fail(f"{name}: live pairs differ from the plain version")
            if not torch.equal(k[~need], p[~need]):
                fail(f"{name}: pairs outside need were written")
            err = (k - p)[live].abs().max().item() if live.any() else 0.0
            if err > tol:
                fail(f"{name}: kernel vs plain {err} > {tol} nats")
            ms, plain_ms = in_turns(lambda: fn(*args), lambda: plain(*args),
                                    reps_k, reps_p)
            tpu = route if route.startswith("batch") else (
                "_fwd" + route if name == "fwd" else "_vit_pallas")
            results[name].append(dict(
                shape=f"P{pb.P} x n{len(cols)} (need {int(need.sum())}) x "
                      f"L{dev.Lmax} x Mk{32 * pb.S}", tpu=tpu,
                max_abs_err=err, ms=ms, plain_ms=plain_ms))
            say("parity", kernel=name, **results[name][-1],
                bar=f"|kernel - plain| <= {tol} nats on live pairs")

    # survivor rows: the most populous chunk x the 512 bucket, and the
    # chunk with 384 < Mp <= 768 x the 2048 bucket
    results["rows"] = [rows_parity(pbs[big], devs[512], 256, gen),
                       rows_parity(pbs[mid], devs[2048], 64, gen)]
    return results


def rows_parity(pb, dev, npairs, gen):
    """The rows kernel against ``rows_plain`` on ``npairs`` pairs of
    ``pb`` x ``dev``, sorted by profile as the engine launches them: the
    four with the highest Forward scores (planted domains, real domain
    mass) and random ones.  Timed in turns: 10 kernel launches, the plain
    version once (it loops over every row in Python), 10 launches."""
    everything = fwd_cuda.fwd_scores(
        dev.codes, dev.lens, dev.lm, pb.fwd_ems, pb.fwd_eis, pb.fwd_tr,
        torch.arange(dev.B, device="cuda"),
        torch.ones((pb.P, dev.B), dtype=torch.bool, device="cuda"))
    top = torch.topk(everything.flatten(), 4).indices.cpu()
    flat = torch.sort(torch.cat([top, torch.randint(
        0, pb.P * dev.B, (npairs - 4,), generator=gen)])).values
    pair_p = (flat // dev.B).to(torch.int32).cuda()
    pair_row = (flat % dev.B).to(torch.int32).cuda()
    args = (dev.codes, dev.lens, dev.lm, pb.fwd_ems, pb.fwd_eis, pb.fwd_tr,
            pair_p, pair_row)
    k = rows_cuda.rows_scores(*args)
    # in turns: kernel, plain, kernel
    ms = cuda_ms(lambda: rows_cuda.rows_scores(*args), 10)
    p, plain_ms = timed_once(lambda: rows_cuda.rows_plain(*args))
    ms = (ms + cuda_ms(lambda: rows_cuda.rows_scores(*args), 10)) / 2
    (kt, kf, kb), (pt, pf, pbk) = ([x.cpu().numpy() for x in r]
                                   for r in (k, p))
    shape = f"P{pb.P} x {npairs} pairs x L{dev.Lmax} x Mk{32 * pb.S}"
    if not (np.isfinite(kt).all() and np.isfinite(kf).all()
            and np.isfinite(kb).all()):
        fail(f"rows: non-finite kernel output ({shape})")
    sc_err = float(max(np.abs(kf - pf).max(), np.abs(kb - pbk).max()))
    if sc_err > ROWS_SC:
        fail(f"rows: fsc/bsc kernel vs plain {sc_err} > {ROWS_SC} nats "
             f"({shape})")
    row_err = 0.0
    for g, b in enumerate(pair_row.cpu().numpy()):
        L = int(dev.lengths[b])
        got = rows_cuda.ext_rows(kt[g], L)
        want = rows_cuda.ext_rows(pt[g], L)
        if not np.allclose(got, want, atol=ROWS_ATOL, rtol=ROWS_RTOL):
            fail(f"rows: btot/etot/mocc of pair {g} (L {L}) differ from "
                 f"the plain version ({shape})")
        if (kt[g, L + 1:] != 0).any():
            fail(f"rows: terms past the length of pair {g} ({shape})")
        row_err = max(row_err, float(np.abs(got - want).max()))
    rec = dict(shape=shape, tpu="_survivor_rows_impl", max_abs_err=sc_err,
               rows_max_abs_err=row_err, ms=ms, plain_ms=plain_ms,
               best_fsc=float(kf.max()),
               audit_fails=int((np.abs(kf - kb)
                                >= 2e-2 + 1e-4 * np.abs(kf)).sum()))
    say("parity", kernel="rows", **rec,
        bar=f"fsc, bsc within {ROWS_SC} nats; btot/etot/mocc atol "
            f"{ROWS_ATOL} rtol {ROWS_RTOL}")
    return rec


def phase_search(queries, targets, device_rows=False):
    """The search path with the device rows stage off or on: one warm
    run, three timed runs (the counts are read over the last), then one
    through ``SearchEngine.search`` for the stage marks."""
    ncmp = len(queries) * len(targets)
    suffix = "_rows" if device_rows else ""
    t = time.time()
    list(hmmsearch(queries, targets, device="cuda", device_rows=device_rows))
    torch.cuda.synchronize()
    say("search_warm" + suffix, wall_s=time.time() - t)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for run in range(3):
        if run == 2:
            for mod, _, _ in KERNELS.values():
                mod.launches = 0
        t = time.time()
        res = list(hmmsearch(queries, targets, device="cuda",
                             device_rows=device_rows))
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    launches = {k: mod.launches for k, (mod, _, _) in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    # once more through the engine that hmmsearch builds, for its marks
    eng = E.SearchEngine(queries[0].alphabet, device="cuda",
                         device_rows=device_rows)
    t = time.time()
    eng.search(queries, targets)
    torch.cuda.synchronize()
    marks = eng.last_timing
    say("search" + suffix, queries=len(queries), targets=len(targets),
        comparisons=ncmp, wall_s=walls, cmp_per_s=[ncmp / w for w in walls],
        max_memory_allocated=peak, launches=launches,
        marks_wall_s=time.time() - t, stage_marks=marks)
    for k, n in launches.items():
        if k in PATHS[device_rows] and n <= 0:
            fail(f"kernel {k} was not launched by the search{suffix}")
        if k not in PATHS[device_rows] and n != 0:
            fail(f"kernel {k} was launched by the search{suffix}")
    if device_rows:
        if marks.get("n_rows_ext", 0) <= 0:
            fail("no pair of the rows-on search took the device rows")
        say("rows_stage", pairs_launched=marks.get("n_rows_pairs", 0),
            n_rows_ext=marks.get("n_rows_ext", 0),
            sent_back=marks.get("n_rows_back", 0))
    return res, launches


def forced_search(queries, targets, device_rows):
    """One search with every bias survivor on the device cascade."""
    saved = {name: getattr(E, name) for name in FORCED}
    for name, value in FORCED.items():
        setattr(E, name, value)
    try:
        eng = E.SearchEngine(queries[0].alphabet, device="cuda",
                             device_rows=device_rows)
        t = time.time()
        res = eng.search(queries, targets)
        torch.cuda.synchronize()
        return res, time.time() - t, eng.last_timing
    finally:
        for name, value in saved.items():
            setattr(E, name, value)


def phase_rows_correctness(queries, targets):
    """The forced cascade with the rows stage on against it off: the same
    hits, envelopes and pass counts for every query; scores and biases
    carry the f32 device Forward score, so they agree within 2e-3."""
    off, wall_off, _ = forced_search(queries, targets, False)
    on, wall_on, marks = forced_search(queries, targets, True)
    if marks.get("n_rows_ext", 0) <= 0:
        fail("forced search: no pair took the device rows")
    worst = 0.0
    for a, b in zip(on, off):
        name = a.query_name.decode()
        if envelopes(a) != envelopes(b):
            fail(f"{name}: rows-on hits or envelopes differ from rows off")
        for n in ("n_past_msv", "n_past_bias", "n_past_vit", "n_past_fwd"):
            if getattr(a, n) != getattr(b, n):
                fail(f"{name}: {n} {getattr(a, n)} != {getattr(b, n)}")
        for ha, hb in zip(a.reported, b.reported):
            d = max(abs(ha.score - hb.score), abs(ha.bias - hb.bias))
            if d >= ROWS_SCORE_TOL:
                fail(f"{name}: {ha.name.decode()} score/bias off by {d}")
            worst = max(worst, d)
    say("rows_correctness", wall_off_s=wall_off, wall_on_s=wall_on,
        reported=sum(len(th.reported) for th in on),
        pairs_launched=marks.get("n_rows_pairs", 0),
        n_rows_ext=marks["n_rows_ext"], sent_back=marks.get("n_rows_back", 0),
        max_score_bias_diff=worst, bar=ROWS_SCORE_TOL)


def envelopes(th):
    return [(h.name, h.included, [(d.env_from, d.env_to) for d in h.domains])
            for h in th.reported]


def phase_correctness(queries, models, targets, planted, res):
    by_name = {th.query_name: th for th in res}
    picks = []
    for lo, hi in ((0, 384), (384, 768), (768, 1 << 30)):
        m = next(h for h in models
                 if lo < padded_width(queries, h) <= hi)
        picks.append(m)
    t = time.time()
    ref = list(oracle_hmmer.hmmsearch(picks, targets, backend="oracle"))
    oracle_s = time.time() - t
    for m, th_ref in zip(picks, ref):
        th = by_name[m.name]
        if rows(th) != rows(th_ref):
            fail(f"{m.name.decode()}: reported rows differ from the oracle")
        if th.Z != th_ref.Z:
            fail(f"{m.name.decode()}: Z {th.Z} != oracle {th_ref.Z}")
        if not th.reported:
            fail(f"{m.name.decode()}: no reported hit")
    silent = [th.query_name.decode() for th in res if not th.reported]
    if silent:
        fail(f"queries without a reported hit: {silent[:5]}")
    say("correctness", queries=[m.name.decode() for m in picks],
        Mp=[padded_width(queries, m) for m in picks],
        reported=[len(th.reported) for th in ref], Z=ref[0].Z,
        oracle_s=oracle_s, planted_recall=syn.recall(res, planted),
        queries_with_hits=sum(1 for th in res if th.reported),
        n_queries=len(res))


def padded_width(queries, h):
    """The padded model width of the engine chunk holding ``h``."""
    qi = next(i for i, q in enumerate(queries) if q is h)
    return next(Mp for Mp, qidx in E.group_queries(queries).items()
                if qi in qidx)


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # the plain versions use no matmul; full f32 is stated all the same,
    # so no reference number can come from TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    phase_environment(smi)
    queries, models, targets, planted = syn.smoke_workload()
    say("workload", queries=len(queries), distinct=len(models),
        targets=len(targets), residues=int(sum(len(s) for s in targets)),
        mean_M=float(np.mean([q.M for q in queries])))
    parity = phase_parity(queries, targets)
    res, launches = phase_search(queries, targets)
    _, launches_rows = phase_search(queries, targets, device_rows=True)
    launches["rows"] = launches_rows["rows"]
    phase_correctness(queries, models, targets, planted, res)
    phase_rows_correctness(queries, targets)
    if "jax" in sys.modules:
        fail("jax was imported")
    say("imports", jax_imported=False, total_s=time.time() - t0)
    record = []
    for name, (mod, src, replaces) in KERNELS.items():
        main_case = parity[name][0]
        record.append({"name": name, "route": "cuda", "source": src,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": max(r["max_abs_err"]
                                          for r in parity[name]),
                       "ms": main_case["ms"],
                       "plain_ms": main_case["plain_ms"]})
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
