"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Drives ``pyhmmer_tpu_torch`` end to end on the seeded smoke workload
(``pyhmmer_tpu_torch/_synthetic.py``: ~245 sampled profile HMMs against
4,002 targets) and fails (non-zero exit) on any of:

1. environment: no CUDA device, a device that is not sm_90, the port's
   host native library missing, a kernel that does not build (the DPX,
   permute, vote and reduce instructions of the MSV kernels, the wide
   route's ``msv_cta_kernel<R>`` among them, are counted from
   ``cuobjdump -sass``), a wide-route instance (``fwd_cta_kernel``,
   ``vit_cta_kernel``, ``msv_cta_kernel``) that spills, or an instance
   of Forward's block route (``fwd_block_kernel<S>``, S = 32 to 128
   slots a lane) that is missing or spills;
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at main-path shapes (for MSV also the widest chunk x the
   longest bucket; for Forward also the launch with the most pairs of
   one smoke search and, on its block route (32 to 128 slots a lane),
   every launch of the smoke search at those widths, replayed, and
   seeded stacks at Mk 2,048 and 4,096, each record naming its route,
   warps a pair and slots a thread; for Viterbi that of one smoke
   search and of one
   with the cascade forced, and for the survivor rows every launch of
   the smoke search with the rows stage on and the forced cascade's
   launch with the most pairs, replayed with their own arguments and the
   engine's pair lists), with the bars
   below (MSV: ovf identical, dx exact on
   every pair neither side flags, biaslog within 0.25 (2e-3 + 1e-6 L)
   nats); both are timed with CUDA events (warm, many launches, in turns
   plain/kernel/kernel/plain; the survivor-rows kernels against one timed
   plain call), beside each shape's bound (``bound``);
3. search: ``hmmsearch(device="cuda")`` once warm, then three timed runs;
   every kernel's launch counter must be > 0 in the last run, Forward's
   block route's too (the rows kernel's must stay 0); a fifth run through ``SearchEngine.search``
   reads the engine's stage marks and the bytes of the kernel tables
   (the rows kernels read the Forward kernel's).  Then the same with the
   device rows
   stage on (``device_rows=True``): the rows kernel's counter and the
   engine's ``n_rows_ext`` must be > 0;
4. correctness: for three distinct queries (padded model width <= 384,
   384..768 and > 768), the reported rows of the search equal the
   sequential oracle pipeline's (the port's own ``Pipeline.search_hmm``)
   over the same targets, with the same Z;
   and with the cascade forced (no speculation, no sparse host path), a
   search with the rows stage on reports for every query the same
   names, inclusion, domain envelopes and pass counts as one with it
   off, with scores and biases within 2e-3 bits;
5. calibrate: ``Builder(aa, device="cuda").calibrate`` of the 16
   distinct smoke models (EmN = EvN = 200 random sequences of 200
   residues, EfN = 200 of 100: HMMER's defaults) must give the evparams
   the JAX package stored (``tests/data/torch_smoke_evparams.json``):
   MSV mu, tau and lambda equal as float32, Viterbi mu within 1e-3 bits;
   exactly one MSV and one Viterbi launch a model, none of Forward (tau
   comes from the native host Forward, which must be present); the
   path's MSV and Viterbi launches of the narrowest and the widest model
   are held against the plain versions as in phase 2;
6. phmmer: 32 of the targets (the first two in name order planted with
   each model) as queries against the whole block, once warm, then three
   timed runs (the counts are read over the last); each query's best hit
   is itself; for three queries the reported rows equal the sequential
   oracle's (``Pipeline.search_seq``); the Forward and Viterbi launches
   with the most pairs of the warm run are held against the plain
   versions;
7. jackhmmer: two of those queries, three iterations each through the
   engine; for the first, every iteration equals ``IterativeSearch``
   without an engine (rows, MSA size, convergence, iteration); the
   engine's target buckets are packed once a query
   (``engine._Buckets`` constructions counted by a wrapper set here:
   ``bucket_builds``), not once a round;
7a. caches: one engine searches copies of the first 2 models against
    copies of 256 targets without their planted ones, again unedited,
    after ``pop``/``append`` of their planted targets on the same block
    object, after a planted domain is written into one item's residue
    array, and after one model's match rows are edited in place; each
    time its rows and Z equal a fresh engine's and the oracle's, and
    it packs the block (``bucket_builds``) once after each block edit
    and not otherwise; then the cost of the two cache keys
    (``engine.block_key`` over the 4,002 targets, ``engine.model_key``
    over the 245 queries) beside one ``_Buckets`` build of the block on
    the card, upload included;
7b. daemon: ``daemon.Server(device="cuda")`` on 127.0.0.1, over 512
    targets and the 16 models: a served ``search_seq`` of a planted
    target launches exactly one MSV and one Viterbi (its calibration on
    the card) and gives ``Pipeline.search_seq``'s hits with a
    ``Builder`` on the card; a served ``search_hmm`` and ``scan_seq``
    give ``Pipeline.search_hmm``'s and ``Pipeline.scan_seq``'s (scores
    within the wire's f32);
8. wide: the wide route (models over 4,096 slots, one CTA a pair) of
   each kernel against its plain version at Mk 4,608 (a sampled M 4,200
   model) and 9,216 (the model built from the 9,000-residue target)
   against the 512 bucket, and at 35,328 (the 35,000-residue target's)
   against 8 lanes, and MSV at the 9,000-residue query's calibration
   launch (200 lanes of 200 residues), each wide MSV record with its
   ``bias_kernel`` and ``msv_cta_kernel`` device times
   (``torch.profiler``); then phmmer with the 9,000-residue target as the
   query against the block, once warm and three timed runs (its query
   its own best hit), one run with the cascade forced (its launches
   counted, its rows those of the timed runs) and its rows against the
   sequential oracle on every 14th target;
9. nhmmer: three sampled DNA models (M 400, 1,200, 5,000: the last on
   the wide route), calibrated on the card, against a seeded 2 Mb
   genome of 4 records with 3 mutated copies of each planted on both
   strands (``_synthetic.nhmmer_workload``): once warm, three timed
   runs; the rows equal the host path's (``PYHMMER_TPU_NHMMER_DEVICE=0``)
   and every planted copy is reported on its strand; the gate launch
   with the most cells of each kernel against its plain version;
10. formats: (a) ``TopHits.write`` in the ``targets``, ``domains`` and
    ``pfam`` formats gives the same bytes for phase 4's three queries
    from the card's search (phase 3) as from the oracle's, and nhmmer's
    long-target table of phase 9's last timed run those of its host
    path; (b) the 4,002 targets written as a BLAST v4 protein volume
    (``easel.ncbi.write_protein_db``) and searched with the 16 distinct
    models through ``SequenceFile(format="ncbi")`` in 2 blocks give the
    rows and Z of the in-memory search; (c) the MSA of the last
    jackhmmer round's hits for the first query, written in Stockholm
    and read back with ``MSAFile`` (digital), has the same names and
    codes, builds (``Builder.build_msa`` on the card) the same model
    arrays, and that model's search rows equal the oracle's (the MSA
    jackhmmer emits repeats the query's name, for the query row and its
    own hit, which Stockholm cannot carry);
11. hmmscan: the 4,002 targets scanned against the 245-model stack, once
    warm and three timed runs, Z the number of models; the three
    targets with the most reported models against
    ``Pipeline.scan_seq``; then one scan of an ``hmmpress``ed copy of
    the stack through ``HMMPressedFile``, its rows those of the scan of
    the HMM list;
12. cascade: ``parallel.mesh.ShardedCascade`` on a 2 x 2 mesh of the one
    card, the 16 distinct models at one ``Mp`` against the 4,002
    targets: MSV scores and overflow flags identical to one unsharded
    launch, ``n_pass`` equal, Forward within 5e-3 nats of one unsharded
    launch;
13. sharded: ``sharded_search`` of the smoke search in 4 shards on the
    card (one thread a shard, one shared host pool): its rows and Z
    identical to phase 3's single-shot search, then three timed runs
    (walls, shard walls, overlap factor; the counts read over the
    last), then one run with the cascade forced and the rows stage on
    against phase 4's single-shot one (the rows-on bars), so all four
    kernel files run on the path; then ``sharded_nhmmer`` of phase 9's
    models in 2 shards, its rows those of phase 9's single-shot runs;
14. multihost: 2 ranks (``torch.distributed``, gloo on 127.0.0.1), each
    a fresh interpreter with its engine on the card
    (``parallel/_worker.py``), over the smoke search: both ranks' tables
    identical to phase 3's; each rank's walls, record bytes and kernel
    launches;
15. entry: ``graft_entry.entry()``'s Forward step on the card against
    the plain Forward on the same tensors (5e-3 nats), then
    ``graft_entry.dryrun_multichip(4)`` over the one card (its own
    checks and 2-process run);
16. neither ``jax`` nor any module of the JAX package ``pyhmmer_tpu``
    was imported: the port runs on its own host layers.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the kernels' JSON record (launches on the main
path and per search path, error, times of the first parity shape, its
bound; Forward's block route has an entry of its own, ``fwd_block``,
whose launches are among ``fwd``'s and whose first shape is the main
path's first launch on it), and the one before that the card's name and
power limit.  Phases
3 and 5-15 (7a and 7b among them) set every kernel's launch counter to
0 just before the run
they count and read them just after (the ranks of phase 14 count their
own).  A plain version that takes many
seconds (the 131,072-residue bucket, nhmmer's largest gate launch) is
timed on its parity call alone.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False")

import numpy as np  # noqa: E402

from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch import engine as E  # noqa: E402
from pyhmmer_tpu_torch import (hmmpress, hmmscan, hmmsearch,  # noqa: E402
                               jackhmmer, nhmmer, phmmer)
from pyhmmer_tpu_torch import daemon, graft_entry  # noqa: E402
from pyhmmer_tpu_torch.easel import (DigitalSequenceBlock,  # noqa: E402
                                     MSAFile, SequenceFile, ncbi)
from pyhmmer_tpu_torch.ops import _build, _pairs  # noqa: E402
from pyhmmer_tpu_torch.ops import batch as B  # noqa: E402
from pyhmmer_tpu_torch.ops import (fwd_cuda, msv_cuda, native,  # noqa: E402
                                   rows_cuda, vit_cuda)
from pyhmmer_tpu_torch.parallel import _worker, mesh  # noqa: E402
from pyhmmer_tpu_torch.plan7 import (Background, Builder,  # noqa: E402
                                     HMMFile, HMMPressedFile, Pipeline,
                                     Profile)


def _script(name):
    """The module ``scripts/<name>.py`` of this checkout."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: each kernel's device ms a call (``torch.profiler``)
device_ms = _script("bench_torch_wide").device_ms

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
#: Viterbi mu bar (bits) of the card's calibration against the stored
#: evparams: the f32 Viterbi scores add in another order than the JAX
#: package's XLA scan
V_MU_TOL = 1e-3
#: the least time a kernel could take (bound_ms): the larger of its
#: operations over the card's peak rate for their type and the bytes of
#: its inputs (each read once) and outputs (each written once) over the
#: memory rate; one H100 SXM (NVIDIA's data sheet): 3.35e12 B/s, 67e12
#: f32 FLOP/s outside the tensor cores, and 132 SMs x 64 integer
#: instructions a clock (32-bit add, minimum, maximum at compute
#: capability 9.0) x 1.98 GHz = 16.7e12 integer instructions/s.  Per DP
#: cell (M x L, real widths and lengths, pairs the launch computes): MSV
#: 1.25 instructions: HMMER's max with B, add of the cost, clamp at 0 and
#: max into E take, for a 32-bit word of two 16-bit cells, one
#: VIMNMX.S16x2.RELU, one VIADDMNMX.S16x2 and half a VIMNMX3.S16x2.RELU
#: (the row maximum folds two words an instruction; phase ``sass``
#: counts 2.54 a word in msv_cta_kernel<24,0>), the DPX issue rate, not
#: published, taken as the integer rate; plus the bias filter's 10 float
#: operations per (profile, residue); Forward 16 (M 8, I 4, D 3, E 1) at
#: the FMA rate; rows below.  Viterbi,
#: max-plus, has no FMA: per cell the
#: function needs 10 FADD (M 5, I 3, D 2) and 6 FMNMX (M 3 over its four
#: predecessors, I 1, D 1, E 1), at the issue rates of compute capability
#: 9.0 in the CUDA C++ Programming Guide's arithmetic-throughput table:
#: 128 f32 adds and 64 minimum/maximum results a clock per SM, x 132 SMs
#: x 1.98 GHz
HBM_RATE = 3.35e12
F32_RATE = 67e12
INT_RATE = 132 * 64 * 1.98e9
FADD_RATE = 132 * 128 * 1.98e9
FMNMX_RATE = 132 * 64 * 1.98e9
MSV_INSNS, BIAS_FLOPS, FILTER_FLOPS = 1.25, 10, 16
VIT_FADD, VIT_FMNMX = 10, 6
#: the survivor rows, counted from the two parsers' recurrences at the
#: same issue rates (FMUL, FADD and FFMA issue alike, 128 a clock a SM):
#: per cell the Forward parser needs 15 (M 5: four products summed by
#: three FFMA, times the emission; I 3; D 2; E 2 FADD; the row's rescale
#: of M, I and D 3 FMUL) and the Backward parser 12 (the emission product
#: 1; B 1 FFMA; M 4 with the I cell's emission product; I 2; D 2; the
#: rescale of M and I 2) f32 instructions and 1 FMNMX (the row's max);
#: per row of a pair 5 MUFU (the log of each pass's scale, the three exp
#: of the decode terms) at 16 a clock a SM.  (The earlier count, 40
#: float operations a cell at the FMA rate of 67e12, gave a bound 1.45x
#: lower.)
MUFU_RATE = 132 * 16 * 1.98e9
ROWS_F32, ROWS_FMNMX, ROWS_MUFU = 27, 1, 5


def vit_ops_s(cells):
    """Seconds the Viterbi recurrence's operations take on ``cells`` DP
    cells at the card's issue rates."""
    return cells * (VIT_FADD / FADD_RATE + VIT_FMNMX / FMNMX_RATE)


def rows_ops_s(cells, residues):
    """Seconds the survivor rows' operations take on ``cells`` DP cells
    (the sum of M x L over the pairs) and ``residues`` (the sum of L)."""
    return (cells * (ROWS_F32 / FADD_RATE + ROWS_FMNMX / FMNMX_RATE)
            + residues * ROWS_MUFU / MUFU_RATE)


KERNELS = {
    "msv": (msv_cuda, "pyhmmer_tpu_torch/csrc/msv.cu",
            "pyhmmer_tpu/ops/msv_pallas.py:355"),
    "fwd": (fwd_cuda, "pyhmmer_tpu_torch/csrc/fwd.cu",
            "pyhmmer_tpu/ops/fwd_pallas.py:586,419,156"),
    "vit": (vit_cuda, "pyhmmer_tpu_torch/csrc/vit.cu",
            "pyhmmer_tpu/ops/vit_pallas.py:149"),
    "rows": (rows_cuda, "pyhmmer_tpu_torch/csrc/rows.cu",
             "pyhmmer_tpu/ops/rows_pallas.py:473,510"),
}
#: the kernels each search path runs (``fwd_block``: Forward's block
#: route, the smoke stack's widest chunk)
PATHS = {False: ("msv", "fwd", "fwd_block", "vit"),
         True: ("msv", "fwd", "fwd_block", "vit", "rows")}
#: routing that sends every bias survivor through the device cascade
#: (tests/test_torch_engine.py:force_device_cascade)
FORCED = {"SPECULATE_P1B": -1.0, "HOST_MIN_PAIRS": 0,
          "HOST_PAIRS_PER_ROW": 0.0}


#: the kernels with a wide route (models over 4,096 slots), whose
#: wrappers count its launches apart (``launches_wide``)
WIDE_KERNELS = ("msv", "fwd", "vit")


def reset_launches():
    for name, (mod, _, _) in KERNELS.items():
        mod.launches = 0
        if name in WIDE_KERNELS:
            mod.launches_wide = 0
    fwd_cuda.launches_block = 0


def read_launches():
    """Each kernel's launches, as ``<kernel>_wide`` those of them on the
    wide route, and as ``fwd_block`` Forward's on its block route (32 to
    128 slots a lane)."""
    out = {k: mod.launches for k, (mod, _, _) in KERNELS.items()}
    out.update({f"{k}_wide": KERNELS[k][0].launches_wide
                for k in WIDE_KERNELS})
    out["fwd_block"] = fwd_cuda.launches_block
    return out


def fwd_route(trans):
    """Forward's route for the table ``trans``: on the block route its
    warps a pair (NW, as the kernel library launches them) and slots a
    thread (SP)."""
    S = B.packed_stripes(trans)
    if not S:
        return "wide route, %d threads, row in %s" % B.cta_shape(
            B.table_width(trans))
    nw = _build.lib().fwd_block_warps(S)
    if not nw:
        return "one warp a pair"
    return "block route, NW %d, SP %d" % (nw, S // nw)


def is_block(call):
    """Whether a recorded Forward launch (pb, dev, cols, need, pairs)
    runs on the block route."""
    return B.packed_stripes(call[0].fwd_trans) >= B.FWD_WIDE_S


def dp_cells(M, lens, cols, need):
    """The DP cells of a launch: the sum of M x L over the pairs of the
    profiles' lengths ``M`` and the columns ``cols`` where ``need``."""
    clens = lens[cols].to(torch.float64).cpu()
    return float((torch.as_tensor(M, dtype=torch.float64)[:, None]
                  * clens[None, :])[need.cpu()].sum())


def cells_of(call):
    """:func:`dp_cells` of a recorded launch (pb, dev, cols, need,
    pairs)."""
    pb, dev, cols, need = call[:4]
    return dp_cells(pb.M, dev.lens, cols, need)


def block_stack(Mk):
    """A seeded stack of 4 models of ``Mk`` - 40 to ``Mk`` - 160 match
    states at the padded width ``Mk`` (Forward's block route from 1,024),
    on the card."""
    hmms = syn.sample_models(tuple(Mk - 40 * k for k in range(1, 5)),
                             seed=Mk)
    bg = Background(hmms[0].alphabet)
    return B.ProfileBatch([Profile(h.M, h.alphabet).configure(
        h, bg, 400, multihit=True) for h in hmms], Mp=Mk).to("cuda")


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains)) for h in th.reported]


def ptxas_summary(report):
    """{kernel or kernel<template arguments>: registers, static shared
    memory and spill bytes} from the ``-Xptxas -v`` report
    (``msv_kernel`` also takes Kp * ceil(S/2) * 128 bytes of dynamic
    shared memory at launch)."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(
                r"function '_Z\d+([A-Za-z_]\w*?)(I(?:L[ib]\d+E)+E|P)", line)
            targs = re.findall(r"L[ib](\d+)E", m.group(2))
            name = m.group(1) + (f"<{','.join(targs)}>" if targs else "")
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


def bound(ops_s, inputs, outputs):
    """{bound_ms, bound_by} from the operations' seconds and the bytes of
    the input and output tensors."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs)
                 if torch.is_tensor(t))
    bytes_s = nbytes / HBM_RATE
    return {"bound_ms": 1e3 * max(float(ops_s), bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


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


def in_turns(kernel, plain, reps_k, reps_p, plain_once_ms=None):
    """(kernel ms, plain ms), each the mean of two runs taken in turns
    plain/kernel/kernel/plain; the parity calls before it warm both.
    With ``reps_p`` 0 (a plain call of many seconds) the plain version is
    not run again: its time is ``plain_once_ms``, the parity's own call,
    and the kernel's the mean of two runs."""
    torch.cuda.synchronize()
    if not reps_p:
        k1 = cuda_ms(kernel, reps_k)
        k2 = cuda_ms(kernel, reps_k)
        return (k1 + k2) / 2, plain_once_ms
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
        fail("the port's native host library is not available (g++ "
             "build failed?)")
    t = time.time()
    _build.lib()
    build_s = time.time() - t
    say("environment", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        build_s=build_s, nvcc_flags=" ".join(_build.NVCC_FLAGS))
    ptxas = ptxas_summary(_build.ptxas_report())
    for kern, info in ptxas.items():
        say("ptxas", kernel=kern, **info)
    # vit_kernel<S, NW, WIDE>: S slots a lane, NW warps a pair
    say("vit_spills", **{k: (v["regs"], v.get("spill_st", 0),
                             v.get("spill_ld", 0))
                         for k, v in ptxas.items()
                         if k.startswith("vit_kernel<")},
        note="registers, spill store and load bytes")
    # the wide route's kernels: fwd_cta_kernel<NT, SPT> and
    # vit_cta_kernel<NT, SPT>, NT threads, SPT slots a thread (0: the row
    # in memory; csrc/common.cuh:PYHMMER_CTA_REGS), and
    # msv_cta_kernel<R, STAGED>, R words a thread (0: the row in shared
    # memory, STAGED 1 with the table rows staged there;
    # csrc/msv.cu:PYHMMER_MSV_CTA_REGS); none may spill
    prefixes = ("fwd_cta_kernel<", "vit_cta_kernel<", "msv_cta_kernel<")
    cta = {k: (v["regs"], v.get("spill_st", 0), v.get("spill_ld", 0))
           for k, v in ptxas.items() if k.startswith(prefixes)}
    say("cta_spills", **cta, note="registers, spill store and load bytes")
    missing = [p for p in prefixes if not any(k.startswith(p) for k in cta)]
    msv_cta = {k for k in cta if k.startswith("msv_cta_kernel<")}
    msv_want = {"msv_cta_kernel<%d,%d>" % rs for rs in
                [(r, 0) for r in B.MSV_CTA_REGS] + [(0, 0), (0, 1)]}
    if missing or msv_cta != msv_want or any(
            st or ld for _, st, ld in cta.values()):
        fail(f"wide-route instances spill or are missing: {cta}")
    # Forward's block route: fwd_block_kernel<S>, one instance a compiled
    # width from FWD_WIDE_S slots a lane; none may spill
    block = {k: (v["regs"], v.get("spill_st", 0), v.get("spill_ld", 0))
             for k, v in ptxas.items() if k.startswith("fwd_block_kernel<")}
    say("fwd_block_spills", **block,
        note="registers, spill store and load bytes")
    if set(block) != {f"fwd_block_kernel<{s}>" for s in B.STRIPES
                      if s >= B.FWD_WIDE_S} or any(
            st or ld for _, st, ld in block.values()):
        fail(f"Forward's block-route instances spill or are missing: "
             f"{block}")
    say("sass", **sass_summary(_build.LIB, ("msv_kernel", "msv_cta_kernel")))


def sass_summary(lib, kernels):
    """Opcode counts of the DPX, permute, vote, reduce and reducing
    barrier instructions in each compiled ``kernel<S>`` of ``lib`` whose
    name is one of ``kernels`` (``cuobjdump -sass``), to show that the
    16-bit intrinsics compiled to DPX instructions."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", lib], capture_output=True,
                             text=True, timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = re.search(r"Function : _Z\d+(\w+?)I((?:L[ib]\d+E)+)E", line)
            name = (f"{m.group(1)}<"
                    f"{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                    if m and m.group(1) in kernels else None)
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if name and m and re.match(r"(VI|VHMNMX|PRMT|VOTE|REDUX|BAR\.RED)",
                                   m.group(1)):
            op = counts.setdefault(name, {})
            op[m.group(1)] = op.get(m.group(1), 0) + 1
    return {"kernels": counts}


def chunk_batch(queries, qidx, Mp):
    bg = Background(queries[0].alphabet)
    profs = [Profile(queries[q].M, queries[q].alphabet).configure(
        queries[q], bg, 400, multihit=True) for q in qidx[:E.P_MAX]]
    return B.ProfileBatch(profs, Mp=Mp).to("cuda")


def main_path_launches(mod, fn, queries, targets, forced=False,
                       device_rows=False):
    """The arguments of every call of ``mod.fn`` in one smoke search
    (``forced``: with the cascade forced; ``device_rows``: with the rows
    stage on), in order: (profile batch, bucket, rows, need, pairs) for
    ``fwd_cuda.forward`` and ``vit_cuda.viterbi``, (profile batch,
    bucket, pair_p, pair_b) for ``rows_cuda.survivor_rows``."""
    def run():
        if forced:
            forced_search(queries, targets, device_rows)
        else:
            E.SearchEngine(queries[0].alphabet, device="cuda",
                           device_rows=device_rows).search(queries, targets)
    return captured([(mod, fn)], run)[1][0]


def captured(calls_of, run):
    """(``run()``, per (module, function name) of ``calls_of`` the
    arguments of each call made during the run, in order)."""
    saved = [(mod, fn, getattr(mod, fn)) for mod, fn in calls_of]
    calls = [[] for _ in calls_of]

    def spy(real, out):
        def recorded(*args):
            out.append(args)
            return real(*args)
        return recorded
    for (mod, fn, real), out in zip(saved, calls):
        setattr(mod, fn, spy(real, out))
    try:
        result = run()
    finally:
        for mod, fn, real in saved:
            setattr(mod, fn, real)
    return result, calls


def msv_label(pb):
    """The MSV kernel's route of ``pb``: on the wide route its CTA size
    and where its row lives (``batch.msv_cta_shape``)."""
    if pb.S:
        return "MSV narrow route"
    return "MSV %d threads, row in %s" % B.msv_cta_shape(pb.Mk)


def msv_parity(pb, dev, reps_k, reps_p, label, tpu):
    """The MSV kernel against ``msv_plain`` on every pair of ``pb`` x
    ``dev`` (ovf identical, dx exact on unflagged pairs, biaslog within
    its bar), timed in turns; on the wide route also each of its two
    kernels' device time (``bias_kernel``, ``msv_cta_kernel``)."""
    args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
            dev.tjb, dev.p1)
    k = msv_cuda.msv_scores(*args)
    p, p_ms = timed_once(lambda: msv_cuda.msv_plain(*args))
    shape = f"{label}P{pb.P} x B{dev.B} x L{dev.Lmax} x Mk{pb.Mk}"
    if not torch.equal(k[1], p[1]):
        fail(f"msv ovf differs from the plain version ({shape})")
    clean = p[1] == 0
    if not torch.equal(k[0][clean], p[0][clean]):
        fail(f"msv dx differs from the plain version on an unflagged "
             f"pair ({shape})")
    berr = (k[2] - p[2]).abs()
    bar = 0.25 * (2e-3 + 1e-6 * dev.lens.float().clamp(min=1))
    if not bool((berr <= bar[None, :]).all()):
        fail(f"msv biaslog off by {berr.max().item()} ({shape})")
    ms, plain_ms = in_turns(lambda: msv_cuda.msv_scores(*args),
                            lambda: msv_cuda.msv_plain(*args), reps_k,
                            reps_p, p_ms)
    cells = float(pb.M.astype(np.float64).sum()
                  * dev.lengths.astype(np.float64).sum())
    rec = dict(shape=shape, tpu=tpu, max_abs_err=berr.max().item(), ms=ms,
               plain_ms=plain_ms, flagged=int((p[1] > 0).sum()),
               cells=cells,
               **bound(MSV_INSNS * cells / INT_RATE
                       + BIAS_FLOPS * pb.P * dev.lengths.sum() / F32_RATE,
                       args, k))
    if not pb.S:
        rec["device_ms"] = device_ms(lambda: msv_cuda.msv_scores(*args),
                                     ("bias_kernel", "msv_cta_kernel"))
    say("parity", kernel="msv", **rec,
        bar="ovf identical; dx exact on unflagged pairs; "
            "biaslog <= 0.25*(2e-3+1e-6 L)")
    return rec


def tpu_route(name, pb, dev):
    """The JAX package's route for the Forward ("fwd") or Viterbi
    ("vit") scores of ``pb`` x ``dev``."""
    if pb.Mp > 768 or dev.Lmax > 8192:
        return "batch XLA scan"
    if name == "vit":
        return "_vit_pallas"
    return "_fwd_pallas3" if pb.Mp <= 384 else "_fwd_pallas2"


def survivor_args(name, pb, dev, cols, need):
    """The Forward or Viterbi wrapper's arguments for the columns
    ``cols`` of ``dev`` where ``need`` is set."""
    return (dev.codes, dev.lens, dev.lm, getattr(pb, name + "_emis"),
            getattr(pb, name + "_trans"), cols, need)


def survivor_parity(name, args, pairs, M, reps_k, reps_p, label, tpu):
    """The Forward (``name`` "fwd") or Viterbi ("vit") kernel against its
    plain version on the wrapper's arguments ``args`` (codes, lens, lm,
    emis, trans, cols, need) and pair list ``pairs`` (None: the
    wrapper's own), ``M`` the profiles' lengths; timed in turns."""
    fn, plain, tol = {"fwd": (fwd_cuda.fwd_scores, fwd_cuda.fwd_plain,
                              FWD_TOL),
                      "vit": (vit_cuda.vit_scores, vit_cuda.vit_plain,
                              VIT_TOL)}[name]
    codes, lens, lm, emis, trans, cols, need = args
    k = fn(*args, pairs)
    p, p_ms = timed_once(lambda: plain(*args))
    live = (k > NEG_LIVE) & (p > NEG_LIVE)
    if not torch.equal(k > NEG_LIVE, p > NEG_LIVE):
        fail(f"{name}: live pairs differ from the plain version")
    if not torch.equal(k[~need], p[~need]):
        fail(f"{name}: pairs outside need were written")
    err = (k - p)[live].abs().max().item() if live.any() else 0.0
    if err > tol:
        fail(f"{name}: kernel vs plain {err} > {tol} nats")
    ms, plain_ms = in_turns(lambda: fn(*args, pairs), lambda: plain(*args),
                            reps_k, reps_p, p_ms)
    cells = dp_cells(M, lens, cols, need)
    rec = dict(
        shape=f"{label}P{emis.shape[0]} x n{len(cols)} (need "
              f"{int(need.sum())}) x L{codes.shape[1]} x "
              f"Mk{B.table_width(trans)}",
        tpu=tpu, max_abs_err=err, ms=ms, plain_ms=plain_ms, cells=cells,
        route=fwd_route(trans) if name == "fwd" else None,
        **bound(vit_ops_s(cells) if name == "vit"
                else FILTER_FLOPS * cells / F32_RATE, (*args, pairs), (k,)))
    say("parity", kernel=name, **rec,
        bar=f"|kernel - plain| <= {tol} nats on live pairs")
    return rec


def phase_parity(queries, targets):
    """Each kernel against its plain version at main-path shapes: the
    chunk holding most profiles, a chunk with 384 < Mp <= 768 and the
    widest chunk, against the buckets the search gives them, and for
    Forward the launch with the most pairs of one smoke search.  ``tpu``
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

    # MSV: every pair of a chunk x bucket, the last case the widest
    # chunk x the longest bucket (one plain call, it loops over 35,000
    # rows)
    for Mp, Lmax, reps_k, reps_p in ((big, 512, 20, 2), (big, 2048, 20, 2),
                                     (huge, 512, 20, 2),
                                     (huge, max(devs), 3, 0)):
        # every Mp here is under the stacked kernel's row cap
        results["msv"].append(msv_parity(pbs[Mp], devs[Lmax], reps_k,
                                         reps_p, "", "_msv_pallas2"))

    # Forward / Viterbi: survivor-like columns (every 8th lane) with a
    # 25% need mask; the widest chunk x every lane of the long bucket;
    # Forward alone: the main path's launch with the most pairs
    cases = []
    for Mp, Lmax in ((big, 512), (big, 2048), (mid, 512)):
        pb, dev = pbs[Mp], devs[Lmax]
        cols = torch.arange(0, dev.B, 8, device="cuda")
        need = (torch.rand((pb.P, len(cols)), generator=gen) < 0.25)
        cases.append((pb, dev, cols, need.to("cuda"), None, 10, 1, "",
                      ("fwd", "vit")))
    pb, dev = pbs[huge], devs[max(devs)]
    cases.append((pb, dev, torch.arange(dev.B, device="cuda"),
                  torch.ones((pb.P, dev.B), dtype=torch.bool,
                             device="cuda"), None, 3, 0, "", ("fwd", "vit")))
    launches = main_path_launches(fwd_cuda, "forward", queries, targets)
    pb, dev, cols, need, pairs = max(launches, key=lambda c: int(c[3].sum()))
    cases.append((pb, dev, cols, need, pairs, 20, 1,
                  f"main-path launch (most pairs of {len(launches)}): ",
                  ("fwd",)))
    # Forward's block route (32 to 128 slots a lane): every launch of the
    # main path at those widths, replayed with the engine's pairs, then
    # seeded stacks at Mk 2,048 and 4,096 against the 512 bucket (18% of
    # every 8th lane); the widest chunk x the long bucket above is its
    # long case
    block = [c for c in launches if c[0].S >= B.FWD_WIDE_S]
    if not block:
        fail("no Forward launch of the smoke search took the block route")
    for i, (pb, dev, cols, need, pairs) in enumerate(block):
        cases.append((pb, dev, cols, need, pairs, 20, 1,
                      f"main-path block-route launch {i + 1} of "
                      f"{len(block)}: ", ("fwd",)))
    gen_block = torch.Generator().manual_seed(3)
    for Mk in (2048, 4096):
        pb, dev = block_stack(Mk), devs[512]
        cols = torch.arange(0, dev.B, 8, device="cuda")
        need = torch.rand((pb.P, len(cols)), generator=gen_block) < 0.18
        cases.append((pb, dev, cols, need.to("cuda"), None, 10, 1,
                      f"seeded stack at Mk{Mk}: ", ("fwd",)))
    # Viterbi: the main path's launches, and the forced cascade's launch
    # with the most pairs (what a Pfam-scale search sends)
    for forced in (False, True):
        launches = main_path_launches(vit_cuda, "viterbi", queries, targets,
                                      forced)
        if not launches:
            fail(f"no Viterbi launch in the smoke search (forced {forced})")
        pb, dev, cols, need, pairs = max(launches,
                                         key=lambda c: int(c[3].sum()))
        label = "forced-cascade" if forced else "main-path"
        cases.append((pb, dev, cols, need, pairs, 20, 1,
                      f"{label} launch (most pairs of {len(launches)}): ",
                      ("vit",)))
    for pb, dev, cols, need, pairs, reps_k, reps_p, label, kernels in cases:
        for name in kernels:
            # the main path's launches with the engine's host-built pair
            # list, the others with the wrapper's own
            results[name].append(survivor_parity(
                name, survivor_args(name, pb, dev, cols, need), pairs,
                pb.M, reps_k, reps_p, label, tpu_route(name, pb, dev)))

    # survivor rows: the most populous chunk x the 512 bucket and the
    # chunk with 384 < Mp <= 768 x the 2048 bucket; then every launch of
    # the main path (rows on) and the forced cascade's launch with the
    # most pairs, replayed with the engine's pairs
    results["rows"] = [
        rows_parity(pbs[big], devs[512], *rows_pairs(pbs[big], devs[512],
                                                     256, gen), ""),
        rows_parity(pbs[mid], devs[2048], *rows_pairs(pbs[mid], devs[2048],
                                                      64, gen), "")]
    launches = main_path_launches(rows_cuda, "survivor_rows", queries,
                                  targets, device_rows=True)
    if not launches:
        fail("no rows launch in the smoke search with the rows stage on")
    for i, (pb, dev, pair_p, pair_b) in enumerate(launches):
        results["rows"].append(rows_parity(
            pb, dev, pair_p, pair_b,
            f"main-path launch {i + 1} of {len(launches)}: "))
    launches = main_path_launches(rows_cuda, "survivor_rows", queries,
                                  targets, forced=True, device_rows=True)
    pb, dev, pair_p, pair_b = max(launches, key=lambda c: len(c[2]))
    results["rows"].append(rows_parity(
        pb, dev, pair_p, pair_b,
        f"forced-cascade launch (most pairs of {len(launches)}): "))
    return results


def rows_pairs(pb, dev, npairs, gen):
    """``npairs`` pairs (pair_p, pair_b; numpy) of ``pb`` x ``dev``: the
    four with the highest Forward scores (planted domains, real domain
    mass) and random ones."""
    everything = fwd_cuda.forward(
        pb, dev, torch.arange(dev.B, device="cuda"),
        torch.ones((pb.P, dev.B), dtype=torch.bool, device="cuda"))
    top = torch.topk(everything.flatten(), 4).indices.cpu()
    flat = torch.cat([top, torch.randint(0, pb.P * dev.B, (npairs - 4,),
                                         generator=gen)])
    return ((flat // dev.B).numpy().astype(np.int32),
            (flat % dev.B).numpy().astype(np.int32))


def rows_parity(pb, dev, pair_p, pair_b, label):
    """The rows kernels against ``rows_plain`` on the pairs (``pair_p``,
    ``pair_b``) of ``pb`` x ``dev``, sorted by profile as
    ``rows_cuda.survivor_rows`` launches them.  Timed in turns: 10 kernel
    launches, the plain version once (it loops over every row in
    Python), 10 launches."""
    order = np.argsort(pair_p, kind="stable")
    pair_p = torch.as_tensor(np.asarray(pair_p)[order], dtype=torch.int32,
                             device="cuda")
    pair_row = torch.as_tensor(np.asarray(pair_b)[order], dtype=torch.int32,
                               device="cuda")
    args = (dev.codes, dev.lens, dev.lm, pb.fwd_emis, pb.fwd_trans, pair_p,
            pair_row)
    k = rows_cuda.rows_scores(*args)
    # in turns: kernel, plain, kernel
    ms = cuda_ms(lambda: rows_cuda.rows_scores(*args), 10)
    p, plain_ms = timed_once(lambda: rows_cuda.rows_plain(*args))
    ms = (ms + cuda_ms(lambda: rows_cuda.rows_scores(*args), 10)) / 2
    (kt, kf, kb), (pt, pf, pbk) = ([x.cpu().numpy() for x in r]
                                   for r in (k, p))
    npairs = len(order)
    shape = (f"{label}P{pb.P} x {npairs} pairs x L{dev.Lmax} x "
             f"Mk{pb.Mk}")
    if not (np.isfinite(kt).all() and np.isfinite(kf).all()
            and np.isfinite(kb).all()):
        fail(f"rows: non-finite kernel output ({shape})")
    sc_err = float(max(np.abs(kf - pf).max(), np.abs(kb - pbk).max()))
    if sc_err > ROWS_SC:
        fail(f"rows: fsc/bsc kernel vs plain {sc_err} > {ROWS_SC} nats "
             f"({shape})")
    row_err = 0.0
    rows_of = pair_row.cpu().numpy()
    for g, b in enumerate(rows_of):
        L = int(dev.lengths[b])
        got = rows_cuda.ext_rows(kt[g], L)
        want = rows_cuda.ext_rows(pt[g], L)
        if not np.allclose(got, want, atol=ROWS_ATOL, rtol=ROWS_RTOL):
            fail(f"rows: btot/etot/mocc of pair {g} (L {L}) differ from "
                 f"the plain version ({shape})")
        if (kt[g, L + 1:] != 0).any():
            fail(f"rows: terms past the length of pair {g} ({shape})")
        row_err = max(row_err, float(np.abs(got - want).max()))
    lens = dev.lengths[rows_of].astype(np.float64)
    cells = float((pb.M[pair_p.cpu().numpy()].astype(np.float64)
                   * lens).sum())
    rec = dict(shape=shape, tpu="_survivor_rows_impl", max_abs_err=sc_err,
               rows_max_abs_err=row_err, ms=ms, plain_ms=plain_ms,
               cells=cells, residues=float(lens.sum()),
               lengths=[int(x) for x in lens],
               **bound(rows_ops_s(cells, lens.sum()), args, k),
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
            reset_launches()
        t = time.time()
        res = list(hmmsearch(queries, targets, device="cuda",
                             device_rows=device_rows))
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # once more through the engine that hmmsearch builds, for its marks
    eng = E.SearchEngine(queries[0].alphabet, device="cuda",
                         device_rows=device_rows)
    t = time.time()
    eng.search(queries, targets)
    torch.cuda.synchronize()
    marks = eng.last_timing
    # the kernel tables on the card, by name (the rows kernels read the
    # Forward kernel's)
    tables = {}
    for c in eng._model_cache.values():
        for name, buf in c[4].named_buffers():
            tables[name] = (tables.get(name, 0)
                            + buf.numel() * buf.element_size())
    say("search" + suffix, queries=len(queries), targets=len(targets),
        comparisons=ncmp, wall_s=walls, cmp_per_s=[ncmp / w for w in walls],
        max_memory_allocated=peak, table_bytes=tables,
        launches=launches,
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


@contextlib.contextmanager
def forced_cascade():
    """The engine's routing set so every bias survivor takes the device
    cascade (:data:`FORCED`), restored on exit."""
    saved = {name: getattr(E, name) for name in FORCED}
    for name, value in FORCED.items():
        setattr(E, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(E, name, value)


def forced_search(queries, targets, device_rows):
    """One search with every bias survivor on the device cascade."""
    with forced_cascade():
        eng = E.SearchEngine(queries[0].alphabet, device="cuda",
                             device_rows=device_rows)
        t = time.time()
        res = eng.search(queries, targets)
        torch.cuda.synchronize()
        return res, time.time() - t, eng.last_timing


def phase_rows_correctness(queries, targets):
    """The forced cascade with the rows stage on against it off: the same
    hits, envelopes and pass counts for every query; scores and biases
    carry the f32 device Forward score, so they agree within 2e-3."""
    off, wall_off, _ = forced_search(queries, targets, False)
    on, wall_on, marks = forced_search(queries, targets, True)
    if marks.get("n_rows_ext", 0) <= 0:
        fail("forced search: no pair took the device rows")
    worst = rows_close(on, off, "rows-on against rows off")
    say("rows_correctness", wall_off_s=wall_off, wall_on_s=wall_on,
        reported=sum(len(th.reported) for th in on),
        pairs_launched=marks.get("n_rows_pairs", 0),
        n_rows_ext=marks["n_rows_ext"], sent_back=marks.get("n_rows_back", 0),
        max_score_bias_diff=worst, bar=ROWS_SCORE_TOL)
    return on


def rows_close(a_list, b_list, what):
    """Fail unless each query of ``a_list`` reports the hits, inclusion,
    domain envelopes and pass counts of ``b_list``'s, with scores and
    biases within :data:`ROWS_SCORE_TOL`; returns the largest score or
    bias difference."""
    worst = 0.0
    for a, b in zip(a_list, b_list):
        name = a.query_name.decode()
        if envelopes(a) != envelopes(b):
            fail(f"{name}: hits or envelopes differ ({what})")
        for n in ("n_past_msv", "n_past_bias", "n_past_vit", "n_past_fwd"):
            if getattr(a, n) != getattr(b, n):
                fail(f"{name}: {n} {getattr(a, n)} != {getattr(b, n)} "
                     f"({what})")
        for ha, hb in zip(a.reported, b.reported):
            d = max(abs(ha.score - hb.score), abs(ha.bias - hb.bias))
            if d >= ROWS_SCORE_TOL:
                fail(f"{name}: {ha.name.decode()} score/bias off by {d} "
                     f"({what})")
            worst = max(worst, d)
    return worst


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
    # the sequential oracle: what hmmsearch(backend="oracle") runs in
    # the JAX package, on the port's own copy of the pipeline
    ref = [Pipeline(targets.alphabet).search_hmm(q, targets) for q in picks]
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
    return picks, ref


def phase_calibrate(smi, parity):
    """Calibrate the 16 distinct smoke models on the card and hold them
    against the evparams the JAX package stored; then the path's MSV and
    Viterbi launches of the narrowest and the widest model against the
    plain versions (appended to ``parity``).  Returns the launches."""
    if not native.available():
        fail("calibrate: no native library, so tau would come from the "
             "Forward kernel fallback")
    models = syn.sample_models(syn.SMOKE_M, syn.SMOKE_SEED)
    with open(syn.EVPARAMS) as fh:
        stored = json.load(fh)
    aa = models[0].alphabet
    bg = Background(aa)
    builder = Builder(aa, device="cuda")
    walls = []

    def run():
        for h in models:
            t = time.time()
            builder.calibrate(h, bg)
            walls.append(time.time() - t)
    reset_launches()
    _, (msv_calls, vit_calls) = captured(
        [(msv_cuda, "msv"), (vit_cuda, "vit_scores")], run)
    launches = read_launches()
    worst = 0.0
    for h in models:
        name = h.name.decode()
        got = np.asarray(h.evparam, np.float32)
        want = np.asarray(stored[name]["evparams"], np.float32)
        for i, what in ((0, "m_mu"), (1, "lambda"), (3, "lambda"),
                        (4, "tau"), (5, "lambda")):
            if got[i] != want[i]:
                fail(f"calibrate {name}: {what} {got[i]} != stored "
                     f"{want[i]}")
        diff = abs(float(got[2]) - float(want[2]))
        if diff > V_MU_TOL:
            fail(f"calibrate {name}: v_mu off the stored one by {diff} "
                 f"bits")
        worst = max(worst, diff)
    n = len(models)
    if (launches["msv"], launches["vit"], launches["fwd"],
            launches["rows"]) != (n, n, 0, 0):
        fail(f"calibrate: launches {launches}, expected one MSV and one "
             f"Viterbi a model")
    say("calibrate", card=smi, models=n, M=[h.M for h in models],
        wall_s=sum(walls), wall_per_model_s=walls, launches=launches,
        max_v_mu_diff_bits=worst,
        bar=f"m_mu, tau, lambda equal as float32; v_mu within {V_MU_TOL} "
            f"bits")
    for i in (0, n - 1):
        label = f"calibrate launch ({models[i].name.decode()}): "
        pb, seq = msv_calls[i]
        parity["msv"].append(msv_parity(pb, seq, 20, 1, label,
                                        "batch._msv_kernel (XLA)"))
        parity["vit"].append(survivor_parity(
            "vit", vit_calls[i], None, pb.M, 20, 1, label,
            "batch._viterbi_kernel (XLA)"))
    return launches


def phmmer_queries(targets, planted, models):
    """For each distinct model, the first two of its planted targets in
    name order."""
    by_name = {s.name: s for s in targets}
    return [by_name[n] for h in models for n in sorted(planted[h.name])[:2]]


def phase_phmmer(smi, queries, targets, planted, models, parity):
    """phmmer of ``queries`` against the whole block: once warm (its
    Forward and Viterbi launches recorded), three timed runs (the counts
    read over the last); every query finds itself first; the builds
    alone, timed; three queries' rows against the sequential oracle; the
    warm run's Forward and Viterbi launches with the most pairs, and its
    Forward launch on the block route with the most cells, against the
    plain versions."""
    ncmp = len(queries) * len(targets)
    t = time.time()
    _, (fwd_calls, vit_calls) = captured(
        [(fwd_cuda, "forward"), (vit_cuda, "viterbi")],
        lambda: list(phmmer(queries, targets, device="cuda")))
    torch.cuda.synchronize()
    warm_s = time.time() - t
    walls = []
    for run in range(3):
        if run == 2:
            reset_launches()
        t = time.time()
        res = list(phmmer(queries, targets, device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    launches = read_launches()
    # each query's calibration adds one MSV and one Viterbi launch
    if (launches["msv"] <= len(queries) or launches["fwd"] <= 0
            or launches["rows"]):
        fail(f"phmmer: launches {launches}")
    if launches["vit"] != len(queries) + len(vit_calls):
        fail(f"phmmer: {launches['vit']} Viterbi launches, expected one a "
             f"query and the warm search's {len(vit_calls)}")
    for q, th in zip(queries, res):
        if not th.reported or th.reported[0].name != q.name:
            fail(f"phmmer {q.name.decode()}: the query is not its own "
                 f"best hit")
    aa = targets.alphabet
    # the part of the wall that builds and calibrates the query models
    t = time.time()
    builder, bg = Builder(aa, device="cuda"), Background(aa)
    for q in queries:
        builder.copy().build(q, bg)
    torch.cuda.synchronize()
    build_s = time.time() - t
    picks = (0, len(queries) // 2, len(queries) - 1)
    t = time.time()
    ref = [Pipeline(aa).search_seq(queries[i], targets,
                                   builder=Builder(aa, device="cuda"))
           for i in picks]
    oracle_s = time.time() - t
    for i, th_ref in zip(picks, ref):
        if rows(res[i]) != rows(th_ref) or res[i].Z != th_ref.Z:
            fail(f"phmmer {queries[i].name.decode()}: reported rows differ "
                 f"from the oracle's")
    share = []
    for q, th in zip(queries, res):
        model = next(h.name for h in models if q.name in planted[h.name])
        others = planted[model] - {q.name}
        found = others & {h.name for h in th.reported}
        share.append(len(found) / len(others))
    say("phmmer", card=smi, queries=len(queries), targets=len(targets),
        comparisons=ncmp, warm_s=warm_s, wall_s=walls,
        cmp_per_s=[ncmp / w for w in walls], build_s=build_s,
        launches=launches,
        oracle_queries=[queries[i].name.decode() for i in picks],
        oracle_M=[len(queries[i]) for i in picks], oracle_s=oracle_s,
        reported=[len(th.reported) for th in res],
        planted_share_mean=float(np.mean(share)), planted_share=share)
    for name, calls in (("fwd", fwd_calls), ("vit", vit_calls)):
        if not calls:
            continue
        pb, dev, cols, need, pairs = max(calls, key=lambda c: int(c[3].sum()))
        parity[name].append(survivor_parity(
            name, survivor_args(name, pb, dev, cols, need), pairs, pb.M, 20,
            1, f"phmmer launch (most pairs of {len(calls)}): ",
            tpu_route(name, pb, dev)))
    # the queries of 1,024 slots and more: Forward's block route
    block = [c for c in fwd_calls if is_block(c)]
    if not block:
        fail("phmmer: no Forward launch on the block route")
    pb, dev, cols, need, pairs = max(block, key=cells_of)
    parity["fwd"].append(survivor_parity(
        "fwd", survivor_args("fwd", pb, dev, cols, need), pairs, pb.M, 5, 0,
        f"phmmer's block-route launch with most cells (of {len(block)}): ",
        tpu_route("fwd", pb, dev)))
    return launches


@contextlib.contextmanager
def counted_buckets():
    """A list that grows by one at every construction of the engine's
    target buckets (``engine._Buckets``, wrapped here and restored on
    exit)."""
    built, real = [], E._Buckets

    class Counted(real):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)
    E._Buckets = Counted
    try:
        yield built
    finally:
        E._Buckets = real


def phase_jackhmmer(smi, queries, targets):
    """jackhmmer of the first two queries, three iterations each through
    the engine, its target buckets packed once a query; the first
    query's iterations against ``IterativeSearch`` without an engine.
    Returns the launches and the first query's last iteration."""
    aa = targets.alphabet
    picks = queries[:2]
    reset_launches()
    t = time.time()
    with counted_buckets() as built:
        out = list(jackhmmer(picks, targets, device="cuda",
                             max_iterations=3, checkpoints=True))
        torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_launches()
    if launches["msv"] <= 0 or launches["fwd"] <= 0 or launches["rows"]:
        fail(f"jackhmmer: launches {launches}")
    if len(built) != len(picks):
        fail(f"jackhmmer: {len(built)} bucket builds for {len(picks)} "
             f"queries of {[len(o) for o in out]} rounds (one a query)")
    t = time.time()
    search = Pipeline(aa, incE=0.001, incdomE=0.001).iterate_seq(
        picks[0], targets,
        builder=Builder(aa, architecture="hand", device="cuda"))
    ref = []
    for _ in range(3):
        try:
            ref.append(next(search))
        except StopIteration:
            break
        if ref[-1].converged:
            break
    oracle_s = time.time() - t
    if len(out[0]) != len(ref):
        fail(f"jackhmmer: {len(out[0])} iterations, the oracle "
             f"{len(ref)}")
    for g, r in zip(out[0], ref):
        if (rows(g.hits), len(g.msa), g.converged, g.iteration) != (
                rows(r.hits), len(r.msa), r.converged, r.iteration):
            fail(f"jackhmmer iteration {g.iteration} differs from "
                 f"IterativeSearch without an engine")
    say("jackhmmer", card=smi, queries=[q.name.decode() for q in picks],
        targets=len(targets), iterations=[len(o) for o in out],
        msa_sizes=[[len(r.msa) for r in o] for o in out],
        reported=[[len(r.hits.reported) for r in o] for o in out],
        converged=[o[-1].converged for o in out], wall_s=wall,
        bucket_builds=len(built), launches=launches,
        oracle_iterations=len(ref), oracle_s=oracle_s)
    return launches, out[0][-1]


#: targets of phase ``caches``' sub-block, and of phase ``daemon``'s
#: sequence database
CACHE_TARGETS = 256
DAEMON_TARGETS = 512


def hit_table(results):
    """Each query's name, reported rows and Z."""
    return [(th.query_name, rows(th), th.Z) for th in results]


def phase_caches(smi, queries, models, targets, planted):
    """The engine's two caches after in-place edits, on the card: one
    engine searches copies of the first 2 models against copies of
    :data:`CACHE_TARGETS` targets without their planted ones, then again
    unedited, then after ``pop``/``append`` of their 8 planted targets on
    the same block object (its length kept), then after a planted domain
    is written into one item's residue array, then after one model's
    match rows are moved halfway to uniform in place; each time its rows
    and Z equal a fresh engine's and ``Pipeline.search_hmm``'s (for the
    unedited repeat: those the first search gave), and its
    ``_Buckets`` builds are 1 after a block edit and 0 otherwise.  Then
    the cost of the two cache keys over the whole block and the 245
    queries, beside one ``_Buckets`` build of the block on the card,
    upload included.  Returns the launches."""
    t0 = time.time()
    aa = targets.alphabet
    pair = [h.copy() for h in models[:2]]
    names = planted[pair[0].name] | planted[pair[1].name]
    block = DigitalSequenceBlock(aa, [s.copy() for s in targets
                                      if s.name not in names]
                                 [:CACHE_TARGETS])
    plants = [s.copy() for s in targets if s.name in names]
    eng = E.SearchEngine(aa, device="cuda")
    checks = []

    def search(what, builds, changed=None, unedited=None):
        with counted_buckets() as built:
            t = time.time()
            got = hit_table(eng.search(pair, block))
            torch.cuda.synchronize()
            wall = time.time() - t
        t = time.time()
        if unedited is None:
            fresh = hit_table(E.SearchEngine(aa, device="cuda").search(
                pair, block))
            want = hit_table([Pipeline(aa).search_hmm(h, block)
                              for h in pair])
        else:
            # nothing changed: a fresh engine and the oracle give the
            # rows they gave on the last search
            fresh = want = unedited
        oracle_s = time.time() - t
        if got != fresh or got != want:
            fail(f"caches, {what}: the reused engine's rows differ from "
                 f"a fresh engine's or the oracle's")
        if len(built) != builds:
            fail(f"caches, {what}: {len(built)} bucket builds, expected "
                 f"{builds}")
        if changed is not None and got == changed:
            fail(f"caches, {what}: the edit changed no row")
        checks.append({"search": what, "bucket_builds": len(built),
                       "wall_s": wall, "fresh_and_oracle_s": oracle_s,
                       "reported": [len(r) for _, r, _ in got]})
        return got

    reset_launches()
    first = search("first", 1)
    search("repeat, unedited", 0, unedited=first)
    for p in plants:
        block.pop(0)
        block.append(p)
    moved = search("pop/append of the planted targets", 1, first)
    rng = np.random.default_rng(syn.SMOKE_SEED)
    dom = np.concatenate([syn.plant(pair[1], rng, 1.0) for _ in range(2)])
    item = next(s for s in block
                if s.name not in names and len(s) >= len(dom) + 20)
    item.sequence[10: 10 + len(dom)] = dom
    written = search("a planted domain written in place", 1, moved)
    me = pair[1].match_emissions
    me[1:] = 0.5 * me[1:] + 0.5 / me.shape[1]
    search("match rows of a model moved in place", 0, written)
    launches = read_launches()
    if launches["msv"] <= 0 or launches["rows"]:
        fail(f"caches: launches {launches}")
    key_ms = {"block_key": [], "model_key": [], "buckets_build": []}
    for _ in range(3):
        t = time.perf_counter()
        E.block_key(targets)
        key_ms["block_key"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        for h in queries:
            E.model_key(h)
        key_ms["model_key"].append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        t = time.perf_counter()
        E._Buckets(targets, "cuda")
        torch.cuda.synchronize()
        key_ms["buckets_build"].append(1e3 * (time.perf_counter() - t))
    say("caches", card=smi, models=[h.name.decode() for h in pair],
        targets=len(block), planted=len(plants), checks=checks,
        launches=launches, keys_over_targets=len(targets),
        keys_over_residues=int(sum(len(s) for s in targets)),
        keys_over_queries=len(queries), ms=key_ms,
        phase_s=time.time() - t0)
    return launches


def wire_model(hmm):
    """``hmm`` as the daemon's server reads it off the wire (HMMER3
    text)."""
    buf = io.BytesIO()
    hmm.write(buf)
    with HMMFile(io.BytesIO(buf.getvalue())) as f:
        return f.read()


def same_hits(got, want, what):
    """Fail unless the served ``got`` reports ``want``'s hits: names,
    inclusion, domain envelopes and Z identical, scores within 1e-4 bits
    and ln P within a relative 1e-6 (the wire carries them as f32)."""
    if len(got) != len(want) or not len(want) or got.Z != want.Z:
        fail(f"daemon {what}: {len(got)} hits, Z {got.Z}; expected "
             f"{len(want)}, Z {want.Z}")
    for g, w in zip(got, want):
        if (g.name, g.included, [(d.env_from, d.env_to) for d in g.domains]
                ) != (w.name, w.included,
                      [(d.env_from, d.env_to) for d in w.domains]):
            fail(f"daemon {what}: hit {w.name.decode()} differs")
        if abs(g.score - w.score) > 1e-4 or \
                abs(g.lnP - w.lnP) > 1e-6 * abs(w.lnP):
            fail(f"daemon {what}: hit {w.name.decode()} scores "
                 f"{g.score} (ln P {g.lnP}) against {w.score} ({w.lnP})")


def phase_daemon(smi, models, targets, planted):
    """``daemon.Server(device="cuda")`` on 127.0.0.1 holding the first
    :data:`DAEMON_TARGETS` targets and the 16 models: one served
    ``search_seq`` of a planted target in it (counts set to 0 just
    before, read just after: exactly one MSV and one Viterbi launch, the
    query's calibration on the card), ``search_hmm`` of that target's
    model and ``scan_seq`` of it, against ``Pipeline.search_seq`` with a
    ``Builder`` on the card, ``Pipeline.search_hmm`` of the model read
    back from its wire text, and ``Pipeline.scan_seq``.  The query is the
    planted target of the database with the least residues and match
    states together whose own model finds it with a P-value under 1e-6
    (the sequential ``Pipeline`` against it alone), and the model that
    one.  Returns the launches of the three served queries."""
    t0 = time.time()
    aa = targets.alphabet
    db = DigitalSequenceBlock(aa, list(targets)[:DAEMON_TARGETS])
    owner = {n: h for h in models for n in planted[h.name]}
    query = model = None
    for s in sorted((s for s in db if s.name in owner),
                    key=lambda s: (len(s) + owner[s.name].M, s.name)):
        alone = Pipeline(aa).search_hmm(owner[s.name],
                                        DigitalSequenceBlock(aa, [s]))
        if alone.reported and alone.reported[0].evalue < 1e-6:
            query, model = s, owner[s.name]
            break
    if query is None:
        fail("daemon: no planted target of the sequence database is found "
             "by its model")
    server = daemon.Server(seqdbs=[db], hmmdbs=[models],
                           address="127.0.0.1", port=0, device="cuda")
    server.start()
    walls = {}
    try:
        with daemon.Client("127.0.0.1", server.port) as client:
            reset_launches()
            t = time.time()
            got_seq = client.search_seq(query)
            walls["search_seq"] = time.time() - t
            seq_launches = read_launches()
            t = time.time()
            got_hmm = client.search_hmm(model)
            walls["search_hmm"] = time.time() - t
            t = time.time()
            got_scan = client.scan_seq(query)
            walls["scan_seq"] = time.time() - t
            launches = read_launches()
    finally:
        server.shutdown()
    want = {"msv": 1, "vit": 1, "fwd": 0, "rows": 0}
    if {k: seq_launches[k] for k in want} != want:
        fail(f"daemon: the served sequence query launched {seq_launches}, "
             f"expected its calibration on the card ({want})")
    if launches != seq_launches:
        fail(f"daemon: the served HMM query or scan launched a kernel "
             f"({launches} against {seq_launches})")
    t = time.time()
    ref_seq = Pipeline(aa).search_seq(query, db, Builder(aa, device="cuda"))
    ref_hmm = Pipeline(aa).search_hmm(wire_model(model), db)
    ref_scan = Pipeline(aa).scan_seq(query, models)
    oracle_s = time.time() - t
    same_hits(got_seq, ref_seq, "search_seq")
    same_hits(got_hmm, ref_hmm, "search_hmm")
    same_hits(got_scan, ref_scan, "scan_seq")
    if got_seq.reported[0].name != query.name:
        fail("daemon search_seq: the query is not its own best hit")
    say("daemon", card=smi, targets=len(db), models=len(models),
        query=query.name.decode(), query_length=len(query),
        model=model.name.decode(), served_wall_s=walls,
        reported={"search_seq": len(got_seq.reported),
                  "search_hmm": len(got_hmm.reported),
                  "scan_seq": len(got_scan.reported)},
        launches=launches, oracle_s=oracle_s, phase_s=time.time() - t0)
    return launches


#: the wide route's parity widths: a sampled model (Mp 4,224), and the
#: models built from the smoke's 9,000- and 35,000-residue targets (Mp
#: 9,024 and 35,008); the last against a few lanes only
WIDE_SAMPLED_M = 4200
WIDE_FEW_LANES = 8
#: targets of the wide phmmer's oracle comparison: every n-th
WIDE_ORACLE_STRIDE = 14
#: the wide phmmer's self-hit scores 20,830 bits; the engine's float64
#: Forward (the native ``domaindef``) and the oracle's
#: (``ops/reference.forward``, numpy) sum its 81 million cells in other
#: orders and differ by about 1.5e-9 of the score (3.2e-5 bits on the
#: CPU, where the JAX package's engine and oracle give the same two
#: scores: scripts/engine_oracle_gap.py), which
#: may cross a 4th-decimal rounding: there scores are held within this
#: share of their size, every other field of the rows exactly
WIDE_SCORE_RTOL = 1e-8


def rows_match(a, b, rtol):
    """The reported rows of ``a`` and ``b`` equal, but that a score
    may differ from the other by ``rtol`` of its size."""
    if len(a.reported) != len(b.reported):
        return False
    for ra, rb, ha, hb in zip(rows(a), rows(b), a.reported, b.reported):
        if ra[:1] + ra[2:] != rb[:1] + rb[2:]:
            return False
        if ra[1] != rb[1] and abs(ha.score - hb.score) > rtol * abs(
                hb.score):
            return False
    return True


def wide_batch(h):
    bg = Background(h.alphabet)
    prof = Profile(h.M, h.alphabet).configure(h, bg, 400, multihit=True)
    return B.ProfileBatch([prof], Mp=B.round_up(h.M, 32)).to("cuda")


def phase_wide(smi, targets, parity):
    """The wide route (models over 4,096 slots): each kernel against its
    plain version at three widths (appended to ``parity``), then phmmer
    with the 9,000-residue target as the query against the block, once
    warm and three timed runs; its launches are counted over one run
    with the cascade forced (every bias survivor on the device Forward
    and Viterbi); its rows against the sequential oracle on every
    ``WIDE_ORACLE_STRIDE``-th target and itself.  Returns the launches,
    and those of the 9,000-residue query's build and calibration.  The
    three widths take the three tiers of the wide Forward and Viterbi
    kernels: the row in registers (Mk 4,608), in shared memory (9,216),
    in a global scratch row (35,328)."""
    aa = targets.alphabet
    bg = Background(aa)
    by_len = {len(s): s for s in targets}
    q9k, q35k = by_len[syn.SMOKE_LONG[0]], by_len[syn.SMOKE_LONG[1]]
    builder = Builder(aa, device="cuda")
    t = time.time()
    h35, _, _ = builder.copy().build(q35k, bg)
    build35_s = time.time() - t
    reset_launches()
    t = time.time()
    (h9, _, _), calls = captured([(msv_cuda, "msv")],
                                 lambda: builder.copy().build(q9k, bg))
    build9_s = time.time() - t
    build_launches = read_launches()
    if build_launches["vit_wide"] != 1 or build_launches["msv_wide"] != 1:
        fail(f"wide: the 9,000-residue query's calibration launched "
             f"{build_launches}")
    hs = syn.sample_models((WIDE_SAMPLED_M,), seed=WIDE_SAMPLED_M)[0]
    _, codes, lengths, dev512 = next(
        b for b in E._Buckets(targets, "cuda").buckets if b[3].Lmax == 512)
    few = B.SeqDevice(codes[:WIDE_FEW_LANES], lengths[:WIDE_FEW_LANES],
                      aa.nonresidue_code, "cuda")
    gen = torch.Generator().manual_seed(1)
    for h, dev in ((hs, dev512), (h9, dev512), (h35, few)):
        pb = wide_batch(h)
        if pb.S:
            fail(f"wide: M {h.M} did not take the wide route")
        nt, tier = B.cta_shape(pb.Mk)
        label = f"wide route, M {h.M} ({msv_label(pb)}; Forward/Viterbi " \
                f"{nt} threads, row in {tier}): "
        parity["msv"].append(msv_parity(pb, dev, 5, 1, label,
                                        "_msv_pallas2"))
        cols = torch.arange(0, dev.B, 8 if dev.B > 64 else 1,
                            device="cuda")
        need = torch.rand((1, len(cols)), generator=gen) < 0.25
        need[0, 0] = True
        for name in ("fwd", "vit"):
            parity[name].append(survivor_parity(
                name, survivor_args(name, pb, dev, cols, need.to("cuda")),
                None, pb.M, 5, 1, label, "batch XLA scan"))

    # the 9,000-residue query's calibration launch (P1 x B200 x L200)
    pb, seq = calls[0][0]
    parity["msv"].append(msv_parity(
        pb, seq, 20, 1, f"wide route, the M {h9.M} query's calibration "
        f"launch ({msv_label(pb)}): ", "_msv_pallas2"))

    ncmp = len(targets)
    t = time.time()
    list(phmmer(q9k, targets, device="cuda"))
    torch.cuda.synchronize()
    warm_s = time.time() - t
    walls = []
    for _ in range(3):
        t = time.time()
        res = list(phmmer(q9k, targets, device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    if not res[0].reported or res[0].reported[0].name != q9k.name:
        fail("wide phmmer: the query is not its own best hit")
    # where a search of the built model spends its time (the engine's
    # stage marks; phmmer's wall adds the build)
    eng = E.SearchEngine(aa, device="cuda")
    eng.search([h9], targets)
    torch.cuda.synchronize()
    marks = eng.last_timing
    reset_launches()
    t = time.time()
    with forced_cascade():
        forced = list(phmmer(q9k, targets, device="cuda"))
    torch.cuda.synchronize()
    forced_s = time.time() - t
    launches = read_launches()
    if min(launches["msv"], launches["fwd"], launches["vit"]) <= 0 or \
            launches["rows"]:
        fail(f"wide phmmer: launches {launches}")
    if rows(forced[0]) != rows(res[0]):
        fail("wide phmmer: the forced cascade's rows differ")
    subset = DigitalSequenceBlock(aa, [q9k] + [
        targets[i] for i in range(0, len(targets), WIDE_ORACLE_STRIDE)])
    got = next(phmmer(q9k, subset, device="cuda"))
    t = time.time()
    ref = Pipeline(aa).search_seq(q9k, subset,
                                  builder=Builder(aa, device="cuda"))
    oracle_s = time.time() - t
    if not rows_match(got, ref, WIDE_SCORE_RTOL) or got.Z != ref.Z:
        fail(f"wide phmmer: reported rows differ from the oracle's: "
             f"{rows(got)} != {rows(ref)}")
    score_diff = max((abs(a.score - b.score) for a, b in
                      zip(got.reported, ref.reported)), default=0.0)
    say("wide", card=smi, query_M=h9.M,
        Mk=B.kernel_width(B.round_up(h9.M, 32)),
        targets=ncmp, warm_s=warm_s, wall_s=walls,
        cmp_per_s=[ncmp / w for w in walls], forced_s=forced_s,
        launches=launches, build_launches=build_launches,
        reported=len(res[0].reported),
        oracle_targets=len(subset), oracle_reported=len(ref.reported),
        oracle_score_diff_bits=score_diff, oracle_s=oracle_s,
        build_9k_s=build9_s, stage_marks=marks, build_35k_s=build35_s,
        M_35k=h35.M)
    return launches, build_launches


def nh_rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains), h.best_domain.env_from,
             h.best_domain.env_to) for h in th.reported]


def phase_nhmmer(smi, parity):
    """nhmmer of the seeded DNA workload (``_synthetic.nhmmer_workload``):
    each model calibrated on the card, once warm (the gates' launches
    recorded), three timed runs (the counts read over the last); the
    rows equal the host path's (gates off) and every planted copy is
    found on its strand; the gate launch with the most cells, and every
    gate launch on Forward's block route, against the plain versions.
    Returns the launches, the calibrated models, the genome and the last
    timed run's results."""
    models, genome, planted = syn.nhmmer_workload()
    dna = genome.alphabet
    bld, bg = Builder(dna, device="cuda"), Background(dna)
    cal = []
    for h in models:
        t = time.time()
        bld.calibrate(h, bg)
        cal.append(time.time() - t)
    t = time.time()
    _, calls = captured(
        [(msv_cuda, "msv"), (vit_cuda, "viterbi"), (fwd_cuda, "forward")],
        lambda: list(nhmmer(models, genome, device="cuda")))
    torch.cuda.synchronize()
    warm_s = time.time() - t
    walls = []
    for run in range(3):
        if run == 2:
            reset_launches()
        t = time.time()
        res = list(nhmmer(models, genome, device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    launches = read_launches()
    if min(launches["msv"], launches["fwd"], launches["vit"]) <= 0 or \
            launches["rows"]:
        fail(f"nhmmer: launches {launches}")
    os.environ["PYHMMER_TPU_NHMMER_DEVICE"] = "0"
    try:
        t = time.time()
        host = list(nhmmer(models, genome, device="cuda"))
        host_s = time.time() - t
    finally:
        del os.environ["PYHMMER_TPU_NHMMER_DEVICE"]
    for th, ref in zip(res, host):
        if nh_rows(th) != nh_rows(ref):
            fail(f"nhmmer {th.query_name.decode()}: rows differ from the "
                 f"host path's")
    for name, rec, a, b, strand in planted:
        th = next(x for x in res if x.query_name == name)
        if not any(h.name == rec and (h.best_domain.ali_from
                                      <= h.best_domain.ali_to)
                   == (strand == "+")
                   and min(h.best_domain.env_from, h.best_domain.env_to)
                   <= b and max(h.best_domain.env_from,
                                h.best_domain.env_to) >= a
                   for h in th.reported):
            fail(f"nhmmer: planted copy {name.decode()} {rec.decode()}:"
                 f"{a}-{b} ({strand}) not reported")
    residues = int(sum(len(s) for s in genome))
    k = max(range(len(calls[0])),
            key=lambda i: float(calls[0][i][0].M.sum())
            * float(calls[0][i][1].lengths.sum()))
    pb, dev = calls[0][k]
    route = ("%d threads, row in %s" % B.cta_shape(pb.Mk) if not pb.S
             else "narrow route")
    label = (f"nhmmer's largest gate launch ({k + 1} of {len(calls[0])}; "
             f"{msv_label(pb)}; Forward/Viterbi {route}): ")
    parity["msv"].append(msv_parity(pb, dev, 3, 0, label,
                                    "_msv_pallas (msv_scores_pallas)"))
    # the JAX package's gates: _vit_pallas, and _fwd_pallas2 up to Mp
    # 768, the XLA Forward scan beyond (pyhmmer_tpu/plan7/
    # longtargets.py:570-594)
    for name, j, tpu in (("vit", 1, "_vit_pallas"),
                         ("fwd", 2, "_fwd_pallas2" if pb.Mp <= 768
                          else "batch XLA scan")):
        pb, dev, cols, need, pairs = calls[j][k]
        parity[name].append(survivor_parity(
            name, survivor_args(name, pb, dev, cols, need), pairs, pb.M, 3,
            0, label, tpu))
    # the gate launches on Forward's block route (the M 1,200 model)
    block = [i for i, c in enumerate(calls[2]) if is_block(c)]
    if not block:
        fail("nhmmer: no gate launch on Forward's block route")
    for i in block:
        pb, dev, cols, need, pairs = calls[2][i]
        parity["fwd"].append(survivor_parity(
            "fwd", survivor_args("fwd", pb, dev, cols, need), pairs, pb.M,
            3, 0, f"nhmmer's gate launch {i + 1} of {len(calls[2])}: ",
            "_fwd_pallas2" if pb.Mp <= 768 else "batch XLA scan"))
    say("nhmmer", card=smi, models=[h.M for h in models],
        records=len(genome), residues=residues, calibrate_s=cal,
        warm_s=warm_s, wall_s=walls,
        residues_per_s=[2 * residues * len(models) / w for w in walls],
        host_path_s=host_s, launches=launches,
        gate_calls=len(calls[0]),
        gate_lanes=[c[1].B for c in calls[0]],
        gate_Lmax=[c[1].Lmax for c in calls[0]],
        reported=[len(th.reported) for th in res], planted=len(planted),
        n_past=[(th.n_past_msv, th.n_past_bias, th.n_past_vit,
                 th.n_past_fwd) for th in res])
    return launches, models, genome, res, host


def table(th, fmt):
    """``th``'s hit table in ``fmt`` (``TopHits.write``)."""
    buf = io.StringIO()
    th.write(buf, format=fmt)
    return buf.getvalue()


def same_tables(got, want, what, fmts):
    """Fail unless ``got`` and ``want`` write the same bytes in each of
    ``fmts``; returns the bytes compared."""
    n = 0
    for g, w in zip(got, want):
        for fmt in fmts:
            a, b = table(g, fmt), table(w, fmt)
            if a != b:
                diff = next((x, y) for x, y in zip(
                    a.splitlines() + [""], b.splitlines() + [""]) if x != y)
                fail(f"formats: {what} {g.query_name.decode()} {fmt} table "
                     f"differs: {diff}")
            n += len(a)
    return n


def phase_formats(smi, picks, oracle, res, nh_res, nh_host, models,
                  targets, last_round):
    """The copied file formats on the main path: (a) the hit tables of
    the card's search against the oracle's (phase 4's queries) and of
    nhmmer's card run against its host path; (b) the 16 distinct models
    against the targets read back from a BLAST volume in 2 blocks,
    against the in-memory block; (c) a Stockholm round trip of the last
    jackhmmer round's hits' MSA, its model built on the card from both
    sides and searched.  Returns the launches of (b) and (c)."""
    aa = targets.alphabet
    t = time.time()
    by_name = {th.query_name: th for th in res}
    n_bytes = same_tables([by_name[m.name] for m in picks], oracle,
                          "hmmsearch against the oracle",
                          ("targets", "domains", "pfam"))
    n_bytes += same_tables(nh_res, nh_host, "nhmmer against its host path",
                           ("targets",))
    tables_s = time.time() - t
    reset_launches()
    with tempfile.TemporaryDirectory() as td:
        # (b) a BLAST v4 protein volume of the 4,002 targets
        t = time.time()
        base = os.path.join(td, "smoke")
        ncbi.write_protein_db(targets, base)
        write_s = time.time() - t
        residues = int(sum(len(s) for s in targets))
        per_block = residues // 2 + 1
        t = time.time()
        with SequenceFile(base, format="ncbi", digital=True,
                          alphabet=aa) as f:
            blocks = 0
            while len(f.read_block(residues=per_block)):
                blocks += 1
        if blocks < 2:
            fail(f"formats: the volume reads in {blocks} block")
        count_s = time.time() - t
        t = time.time()
        with SequenceFile(base, format="ncbi", digital=True,
                          alphabet=aa) as f:
            vol = list(hmmsearch(models, f, device="cuda",
                                 block_residues=per_block))
        torch.cuda.synchronize()
        volume_s = time.time() - t
        t = time.time()
        mem = list(hmmsearch(models, targets, device="cuda"))
        torch.cuda.synchronize()
        memory_s = time.time() - t
        for a, b in zip(vol, mem):
            if (rows(a), a.Z) != (rows(b), b.Z):
                fail(f"formats: {a.query_name.decode()} from the BLAST "
                     f"volume differs from the in-memory search")
        # (c) the last jackhmmer round's hits, Stockholm and back
        t = time.time()
        msa = last_round.hits.to_msa(aa, all_consensus_cols=True,
                                     digitize=True)
        msa.name = last_round.msa.name
        path = os.path.join(td, "jackhmmer.sto")
        with open(path, "wb") as fh:
            msa.write(fh, format="stockholm")
        with MSAFile(path, format="stockholm", digital=True,
                     alphabet=aa) as f:
            back = f.read()
        if back.names != msa.names or not np.array_equal(back.codes,
                                                          msa.codes):
            fail("formats: the Stockholm round trip changed the MSA")
        bg = Background(aa)
        h_mem = Builder(aa, device="cuda").build_msa(msa, bg)[0]
        h_file = Builder(aa, device="cuda").build_msa(back, bg)[0]
        for name in ("t", "mat", "ins", "evparam"):
            if not np.array_equal(np.asarray(getattr(h_mem, name)),
                                  np.asarray(getattr(h_file, name))):
                fail(f"formats: the model built from the file differs in "
                     f"{name}")
        msa_s = time.time() - t
        t = time.time()
        got = next(hmmsearch(h_file, targets, device="cuda"))
        torch.cuda.synchronize()
        search_s = time.time() - t
        t = time.time()
        want = Pipeline(aa).search_hmm(h_file, targets)
        oracle_s = time.time() - t
        if (rows(got), got.Z) != (rows(want), want.Z) or not got.reported:
            fail("formats: the model built from the Stockholm file "
                 "searches unlike the oracle")
    launches = read_launches()
    need_launches("formats", launches, ("msv", "fwd", "vit"))
    say("formats", card=smi, table_queries=[m.name.decode() for m in picks],
        nhmmer_queries=[th.query_name.decode() for th in nh_res],
        table_bytes=n_bytes, tables_s=tables_s, volume_write_s=write_s,
        volume_blocks=blocks, volume_count_s=count_s,
        volume_search_s=volume_s, memory_search_s=memory_s,
        volume_models=len(models),
        volume_reported=[len(th.reported) for th in vol],
        msa_sequences=len(msa), msa_columns=msa.codes.shape[1],
        msa_round_trip_s=msa_s, msa_model_M=h_file.M,
        msa_search_s=search_s, msa_oracle_s=oracle_s,
        msa_reported=len(got.reported), launches=launches)
    return launches


def phase_hmmscan(smi, queries, targets):
    """hmmscan of the 4,002 targets against the 245-model stack: once
    warm, three timed runs (the counts read over the last); for the
    three targets with the most reported models (planted domains) the
    rows equal the sequential ``Pipeline.scan_seq``'s; then one scan of
    an ``hmmpress``ed copy of the stack through ``HMMPressedFile``,
    whose rows equal the last timed run's.  Returns the launches."""
    ncmp = len(queries) * len(targets)
    t = time.time()
    list(hmmscan(targets, queries, device="cuda"))
    torch.cuda.synchronize()
    warm_s = time.time() - t
    walls = []
    for run in range(3):
        if run == 2:
            reset_launches()
        t = time.time()
        res = list(hmmscan(targets, queries, device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    launches = read_launches()
    if min(launches["msv"], launches["fwd"], launches["vit"]) <= 0 or \
            launches["rows"]:
        fail(f"hmmscan: launches {launches}")
    if any(th.Z != len(queries) for th in res):
        fail("hmmscan: Z is not the number of models")
    by_name = {th.query_name: th for th in res}
    # the three targets with the most reported models (planted domains)
    picks = sorted(by_name, key=lambda n: (-len(by_name[n].reported),
                                           n))[:3]
    seqs = {s.name: s for s in targets}
    t = time.time()
    for name in picks:
        ref = Pipeline(targets.alphabet).scan_seq(seqs[name], queries)
        if rows(by_name[name]) != rows(ref) or by_name[name].Z != ref.Z:
            fail(f"hmmscan {name.decode()}: rows differ from "
                 f"Pipeline.scan_seq")
        if not ref.reported:
            fail(f"hmmscan {name.decode()}: no reported model")
    oracle_s = time.time() - t
    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "smoke")
        t = time.time()
        npressed = hmmpress(queries, db)
        press_s = time.time() - t
        t = time.time()
        with HMMPressedFile(db) as pressed:
            from_db = list(hmmscan(targets, pressed, device="cuda"))
        torch.cuda.synchronize()
        pressed_s = time.time() - t
    if npressed != len(queries):
        fail(f"hmmpress wrote {npressed} models of {len(queries)}")
    if [(th.query_name, th.Z, rows(th)) for th in from_db] != \
            [(th.query_name, th.Z, rows(th)) for th in res]:
        fail("hmmscan of the pressed database: rows differ from the scan "
             "of the HMM list")
    say("hmmscan", card=smi, queries=len(targets), models=len(queries),
        comparisons=ncmp, warm_s=warm_s, wall_s=walls,
        cmp_per_s=[ncmp / w for w in walls], launches=launches,
        oracle_queries=[n.decode() for n in picks], oracle_s=oracle_s,
        reported=sum(len(th.reported) for th in res), press_s=press_s,
        pressed_scan_s=pressed_s, pressed_rows_identical=True)
    return launches


#: shards of the sharded phases, all on the one card
SHARDS = 4
NHMMER_SHARDS = 2
#: the kernels each sharded path must have launched (Viterbi runs only
#: where the routing sends pairs to it, which in a shard of a quarter of
#: the targets it may not)
SHARDED_KERNELS = ("msv", "fwd")


def need_launches(path, launches, kernels):
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{path}: kernel {k} was not launched ({launches})")


def phase_cascade(smi, models, targets):
    """``ShardedCascade`` on a 2 x 2 mesh of the one card: the 16 distinct
    smoke models at one ``Mp`` against the 4,002 targets, held against
    one unsharded MSV and one unsharded Forward launch of the same
    inputs (dx and ovf identical, ``n_pass`` equal, Forward within
    :data:`FWD_TOL`).  Returns the sharded run's launches."""
    aa = targets.alphabet
    bg = Background(aa)
    Mp = B.round_up(max(h.M for h in models), 32)
    pb = B.ProfileBatch([Profile(h.M, aa).configure(h, bg, 400,
                                                    multihit=True)
                         for h in models], Mp=Mp)
    lengths = np.array([len(s) for s in targets], dtype=np.int64)
    codes = np.full((len(targets), int(lengths.max())), aa.nonresidue_code,
                    dtype=np.uint8)
    for i, s in enumerate(targets):
        codes[i, : len(s)] = s.sequence
    casc = mesh.ShardedCascade(mesh.make_mesh(2, 2, devices=["cuda:0"] * 4))
    reset_launches()
    t = time.time()
    usc, ovf, n_pass = casc.msv(pb, codes, lengths)
    msv_s = time.time() - t
    t = time.time()
    fwd = casc.forward(pb, codes, lengths)
    fwd_s = time.time() - t
    launches = read_launches()
    need_launches("cascade", launches, ("msv", "fwd"))
    # the same work in one launch each
    pbc = B.ProfileBatch(pb.profiles, Mp=Mp).to("cuda")
    seq = B.SeqDevice(codes, lengths, device="cuda")
    t = time.time()
    dx, o, _ = msv_cuda.msv(pbc, seq)
    want_usc = B.msv_nats(dx.cpu().numpy(), o.cpu().numpy(), seq.tjbu_host,
                          pb.scale_b)
    one_msv_s = time.time() - t
    if not np.array_equal(ovf, o.cpu().numpy() > 0):
        fail("cascade: ovf differs from the unsharded launch")
    if not np.array_equal(usc, want_usc):
        fail("cascade: MSV scores differ from the unsharded launch")
    want_pass = int(((dx > 0) & (o == 0)).sum())
    if n_pass != want_pass:
        fail(f"cascade: n_pass {n_pass} != unsharded {want_pass}")
    rows_ = np.arange(seq.B, dtype=np.int64)
    need = np.ones((pb.P, seq.B), dtype=bool)
    t = time.time()
    want_fwd = fwd_cuda.forward(
        pbc, seq, torch.as_tensor(rows_, device="cuda"),
        torch.as_tensor(need, device="cuda"),
        torch.as_tensor(_pairs.host_pairs(rows_, need),
                        device="cuda")).cpu().numpy()
    one_fwd_s = time.time() - t
    err = float(np.abs(fwd - want_fwd).max())
    if not err <= FWD_TOL:
        fail(f"cascade: Forward off the unsharded launch by {err} nats")
    say("cascade", card=smi, mesh=casc.mesh.shape, profiles=pb.P, Mp=Mp,
        targets=len(targets), Lmax=int(lengths.max()), n_pass=n_pass,
        overflowed=int(ovf.sum()), msv_s=msv_s, fwd_s=fwd_s,
        unsharded_msv_s=one_msv_s, unsharded_fwd_s=one_fwd_s,
        fwd_max_abs_diff=err, fwd_identical=err == 0.0, bar=FWD_TOL,
        launches=launches)
    return launches


def phase_sharded(smi, queries, targets, single, forced_rows_on,
                  nh_models, genome, nh_single):
    """``sharded_search`` of the smoke workload in :data:`SHARDS` shards
    on the one card: its first run's rows and Z identical to the
    single-shot search (phase 3), then three timed runs (the counts read
    over the last); one run with the cascade forced and the rows stage
    on, held against the single-shot one of ``phase_rows_correctness``
    (rows-on bars); then ``sharded_nhmmer`` of the nhmmer models in
    :data:`NHMMER_SHARDS` shards against the single-shot nhmmer's rows.
    Returns the launches of the timed run, the rows run and nhmmer."""
    devices = ["cuda:0"] * SHARDS
    ncmp = len(queries) * len(targets)
    t = time.time()
    first = mesh.sharded_search(queries, targets, devices=devices)
    torch.cuda.synchronize()
    first_s = time.time() - t
    for a, b in zip(first, single):
        if rows(a) != rows(b) or a.Z != b.Z:
            fail(f"sharded {a.query_name.decode()}: rows or Z differ from "
                 f"the single-shot search")
    walls, stats = [], []
    for run in range(3):
        if run == 2:
            reset_launches()
        t = time.time()
        res = mesh.sharded_search(queries, targets, devices=devices)
        torch.cuda.synchronize()
        walls.append(time.time() - t)
        stats.append(mesh.sharded_search.last_stats)
    launches = read_launches()
    need_launches("sharded", launches, SHARDED_KERNELS)
    if [rows(th) for th in res] != [rows(th) for th in single]:
        fail("sharded: a timed run's rows differ from the single-shot "
             "search")
    reset_launches()
    t = time.time()
    with forced_cascade():
        on = mesh.sharded_search(queries, targets, devices=devices,
                                 device_rows=True)
    torch.cuda.synchronize()
    rows_s = time.time() - t
    launches_rows = read_launches()
    need_launches("sharded rows", launches_rows, KERNELS)
    worst = rows_close(on, forced_rows_on,
                       "sharded rows-on against single-shot rows-on")
    say("sharded", card=smi, shards=SHARDS, queries=len(queries),
        targets=len(targets), comparisons=ncmp, first_s=first_s,
        wall_s=walls, cmp_per_s=[ncmp / w for w in walls],
        shard_walls=[s["shard_walls"] for s in stats],
        overlap_factor=[s["overlap_factor"] for s in stats],
        launches=launches, rows_on_s=rows_s, rows_on_launches=launches_rows,
        rows_on_max_score_bias_diff=worst)
    reset_launches()
    t = time.time()
    nh = [mesh.sharded_nhmmer(h, genome, n_shards=NHMMER_SHARDS,
                              devices=["cuda:0"] * NHMMER_SHARDS)
          for h in nh_models]
    torch.cuda.synchronize()
    nh_s = time.time() - t
    launches_nh = read_launches()
    need_launches("sharded_nhmmer", launches_nh, ("msv", "vit", "fwd"))
    for a, b in zip(nh, nh_single):
        if nh_rows(a) != nh_rows(b):
            fail(f"sharded_nhmmer {a.query_name.decode()}: rows differ from "
                 f"the single-shot nhmmer")
    say("sharded_nhmmer", card=smi, shards=NHMMER_SHARDS,
        models=[h.M for h in nh_models], wall_s=nh_s,
        reported=[len(th.reported) for th in nh], launches=launches_nh)
    return launches, launches_rows, launches_nh


def phase_multihost(smi, single):
    """Two ranks (``torch.distributed``, gloo on 127.0.0.1), each a fresh
    interpreter whose engine runs on the one card, over the smoke
    workload: each rank's table identical to the other's and to the
    single-process search (phase 3).  Returns the launches the ranks
    made together (each rank counts its own)."""
    want = _worker.table(single)
    with tempfile.TemporaryDirectory() as td:
        t = time.time()
        ranks, retries = _worker.spawn(["cuda:0", "cuda:0"], "smoke", td,
                                       timeout=600)
        wall = time.time() - t
    for r in ranks:
        if {"rows": r["rows"], "acct": r["acct"]} != want:
            fail(f"multihost: rank {r['rank']}'s table differs from the "
                 f"single-process search")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
    need_launches("multihost", launches, SHARDED_KERNELS)
    say("multihost", card=smi, ranks=len(ranks), wall_s=wall,
        port_retries=retries,
        rank_wall_s=[r["wall_s"] for r in ranks],
        rank_run_s=[r["run_s"] for r in ranks],
        search_wall_s=[r["search_wall"] for r in ranks],
        exchange_wall_s=[r["exchange_wall"] for r in ranks],
        bytes_sent=[r["bytes_sent"] for r in ranks],
        bytes_received=[r["bytes_received"] for r in ranks],
        rank_launches=[r["launches"] for r in ranks],
        reported=sum(len(x) for x in want["rows"]), tables_identical=True)
    return launches


def phase_entry(smi):
    """``graft_entry.entry()``'s Forward step on the card against the
    plain Forward on the same tensors (within :data:`FWD_TOL`), then
    ``dryrun_multichip(4)`` over the one card.  Returns the launches of
    both (the dryrun's 2-process run counts in its ranks)."""
    reset_launches()
    fn, args = graft_entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    want = fwd_cuda.fwd_plain(*args[:7])
    err = float((got - want).abs().max())
    if not err <= FWD_TOL:
        fail(f"entry: Forward step off the plain version by {err} nats")
    t = time.time()
    dry = graft_entry.dryrun_multichip(4)
    dry_s = time.time() - t
    launches = read_launches()
    need_launches("entry", launches, ("msv", "fwd"))
    say("entry", card=smi, shape=list(got.shape), max_abs_err=err,
        bar=FWD_TOL, dryrun_s=dry_s, dryrun=dry, launches=launches)
    return launches


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
    res, launches_off = phase_search(queries, targets)
    _, launches_on = phase_search(queries, targets, device_rows=True)
    # the main path of each kernel: rows off, and rows on for the rows
    # kernel (off by default, it runs only there)
    launches = dict(launches_off, rows=launches_on["rows"])
    picks, oracle = phase_correctness(queries, models, targets, planted,
                                      res)
    forced_rows_on = phase_rows_correctness(queries, targets)
    by_path = {"rows_off": launches_off, "rows_on": launches_on,
               "calibrate": phase_calibrate(smi, parity)}
    seqs = phmmer_queries(targets, planted, models)
    by_path["phmmer"] = phase_phmmer(smi, seqs, targets, planted, models,
                                     parity)
    by_path["jackhmmer"], last_round = phase_jackhmmer(smi, seqs, targets)
    by_path["caches"] = phase_caches(smi, queries, models, targets, planted)
    by_path["daemon"] = phase_daemon(smi, models, targets, planted)
    by_path["wide"], by_path["wide_build"] = phase_wide(smi, targets,
                                                        parity)
    (by_path["nhmmer"], nh_models, genome, nh_res,
     nh_host) = phase_nhmmer(smi, parity)
    by_path["formats"] = phase_formats(smi, picks, oracle, res, nh_res,
                                       nh_host, models, targets, last_round)
    by_path["hmmscan"] = phase_hmmscan(smi, queries, targets)
    by_path["cascade"] = phase_cascade(smi, models, targets)
    (by_path["sharded"], by_path["sharded_rows"],
     by_path["sharded_nhmmer"]) = phase_sharded(
        smi, queries, targets, res, forced_rows_on, nh_models, genome,
        nh_res)
    by_path["multihost"] = phase_multihost(smi, res)
    by_path["entry"] = phase_entry(smi)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "pyhmmer_tpu"))
    if foreign:
        fail(f"imported jax or the JAX package: {foreign[:5]}")
    say("imports", jax_imported=False, jax_package_imported=False,
        total_s=time.time() - t0)
    record = []
    for name, (mod, src, replaces) in KERNELS.items():
        main_case = parity[name][0]
        record.append({"name": name, "route": "cuda", "source": src,
                       "replaces": replaces, "launches": launches[name],
                       "launches_by_path": {path: n[name]
                                            for path, n in by_path.items()},
                       # of those, the wide route's (models over 4,096
                       # slots; not counted apart by the 2 gloo ranks)
                       "wide_launches_by_path": {
                           path: n.get(f"{name}_wide")
                           for path, n in by_path.items()}
                       if name in WIDE_KERNELS else None,
                       "max_abs_err": max(r["max_abs_err"]
                                          for r in parity[name]),
                       "ms": main_case["ms"],
                       "plain_ms": main_case["plain_ms"],
                       "bound_ms": main_case["bound_ms"],
                       "bound_by": main_case["bound_by"],
                       # no single PyTorch call computes these DP scans
                       "library_ms": None})
    # Forward's block route apart (its launches are among "fwd"'s): the
    # main path's first block-route launch, replayed, is its main case
    blocks = [r for r in parity["fwd"]
              if (r["route"] or "").startswith("block")]
    main_case = next(r for r in blocks
                     if r["shape"].startswith("main-path block-route"))
    record.append({"name": "fwd_block", "route": "cuda",
                   "source": KERNELS["fwd"][1],
                   "replaces": KERNELS["fwd"][2],
                   "launches": launches["fwd_block"],
                   "launches_by_path": {path: n.get("fwd_block")
                                        for path, n in by_path.items()},
                   "max_abs_err": max(r["max_abs_err"] for r in blocks),
                   "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                   "bound_ms": main_case["bound_ms"],
                   "bound_by": main_case["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
