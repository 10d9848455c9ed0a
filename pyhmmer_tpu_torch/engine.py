"""The batched search engine on PyTorch: filter cascade on the device,
domain machinery on the host.

The port of ``pyhmmer_tpu/engine.py``.  The cascade runs three device
stages over stacks of profiles x length buckets of targets, each followed
by host gating, and hands the final survivors to the exact float64 native
postprocessing (``ops/native.py``, the port's copy of the JAX
package's host library), so the reported hits are the sequential oracle
pipeline's:

1. MSV with the bias filter fused in, for every (profile chunk x bucket)
   (``ops/msv_cuda.py``), the long buckets' launches first, each on a
   side stream of its own; the exact host bias filter re-checks the
   pairs near the gate;
2. Forward on the bias survivors (``ops/fwd_cuda.py``);
3. Viterbi on the Forward survivors whose MSV P-value did not already
   let them skip it (``ops/vit_cuda.py``).

With ``device_rows=True`` (off by default, as ``PYHMMER_TPU_DEVICE_ROWS``
is in the JAX engine) the final survivors of stages 2 and 3 in eligible
(chunk, bucket)s also run their full-length Forward/Backward parsers and
posterior decode on the device (``ops/rows_cuda.py``), and the native
domain definition starts from those rows at region finding.

Every stage kernel runs if and only if the engine's ``device`` is a CUDA
device; on the CPU the kernels' plain PyTorch versions run.  Each stage's
device outputs come back with one ``torch.cat`` and one device-to-host
copy.
"""

from __future__ import annotations

import concurrent.futures as _cf
import contextlib
import hashlib
import math
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .easel.alphabet import Alphabet
from .easel.sequence import DigitalSequenceBlock
from .ops import batch as B
from .ops import fwd_cuda, msv_cuda, rows_cuda, vit_cuda
from .ops import _pairs
from .ops import native as _native
from .ops import reference as refops
from .plan7.background import Background
from .plan7.evalues import exp_surv, gumbel_invsurv, gumbel_surv
from .plan7.hmm import HMM
from .plan7.pipeline import (F2_SKIP_SLACK, F3_SLACK, LOG2,
                             MAX_TARGET_LENGTH, Pipeline)
from .plan7.profile import Profile
from .plan7.results import Alignment, Domain, Hit, TopHits

__all__ = ["SearchEngine"]

#: max profiles stacked per chunk
P_MAX = 64
#: length-bucket ladder (Lmax per level); the last level serves targets
#: up to ``MAX_TARGET_LENGTH``, longer ones raise as in the oracle
LADDER = (512, 2048, 8192, 131072)
#: bias survivors with a quantized-MSV P-value at or below this skip the
#: device Forward and go straight to the host domaindef pool (negative:
#: never)
SPECULATE_P1B = 1e-6
#: a (chunk, bucket) whose bias survivors number at most
#: max(HOST_MIN_PAIRS, HOST_PAIRS_PER_ROW * Lmax * P) takes the host path
#: instead of the device cascade (both 0: never)
HOST_MIN_PAIRS = 4
HOST_PAIRS_PER_ROW = 6e-4
#: the device rows stage takes (chunk, bucket)s with Lmax <= ROWS_MAX_L
#: and a model width, rounded up to 128, of at most ROWS_MAX_MP (the JAX
#: engine's limits, ``pyhmmer_tpu/engine.py:692-698``)
ROWS_MAX_L = 2048
ROWS_MAX_MP = 768
#: buckets with a longer Lmax launch their MSV scans on side streams
LONG_BUCKET = 2048
#: DP cells (M x L summed over its pairs) at which a batch of survivors
#: goes to the postprocessing pool: tens of milliseconds of native work
BATCH_CELLS = 2_000_000
#: a wave of survivors too small to give every worker this many batches
#: at ``BATCH_CELLS`` is cut into smaller ones
BATCHES_PER_WORKER = 4


def pool_size() -> int:
    """Workers of a native postprocessing pool: ``PYHMMER_TPU_THREADS``,
    or the core count (at least 2), as in the JAX engine."""
    return (int(os.environ.get("PYHMMER_TPU_THREADS", "0"))
            or max(2, os.cpu_count() or 2))


class _Buckets:
    """Length-bucketed packing of a target block on ``device``: one bucket
    per ladder level, lanes sorted by length, at most ``2**24 / Lmax``
    lanes each.  Empty targets get no lane (they score nothing, but the
    engine still counts them into Z)."""

    def __init__(self, block: DigitalSequenceBlock, device):
        lengths = np.array([len(s) for s in block], dtype=np.int64)
        fill = block.alphabet.nonresidue_code
        self.buckets = []   # (indices[B], codes[B, Lmax], lengths[B], dev)
        for li, Lmax in enumerate(LADDER):
            lo = 0 if li == 0 else LADDER[li - 1]
            sel = np.where((lengths > lo if li else lengths >= 1)
                           & (lengths <= Lmax))[0]
            if len(sel) == 0:
                continue
            sel = sel[np.argsort(lengths[sel], kind="stable")]
            Bcap = max(64, (1 << 24) // Lmax)
            for s0 in range(0, len(sel), Bcap):
                idx = sel[s0: s0 + Bcap]
                codes = np.full((len(idx), Lmax), fill, dtype=np.uint8)
                blens = np.zeros(len(idx), dtype=np.int64)
                for r, s in enumerate(idx):
                    seq = block[int(s)].sequence
                    codes[r, : len(seq)] = seq
                    blens[r] = len(seq)
                self.buckets.append((idx.astype(np.int64), codes, blens,
                                     B.SeqDevice(codes, blens, fill,
                                                 device)))


@contextlib.contextmanager
def span(tmark: dict, name: str):
    """One span of a search: a ``record_function("engine.<name>")`` range
    in the profiler's trace (on the kernels' clock) whose
    ``perf_counter`` seconds add up in ``tmark["<name>_s"]``.  The clock
    is read outside the range, so the span holds it and the range's calls
    into torch, which may wait to retake the GIL."""
    key = name + "_s"
    t = time.perf_counter()
    try:
        with torch.profiler.record_function("engine." + name):
            yield
    finally:
        tmark[key] = tmark.get(key, 0.0) + time.perf_counter() - t


def _pool_job(fn, *args):
    """``fn(*args)`` on a pool worker, returned with the job's wall and
    thread CPU seconds and those spent inside the native library's C
    calls (``ops/native.py:call_times``), each CPU interval inside its
    wall interval."""
    w0 = time.perf_counter()
    c0 = time.thread_time()
    n0 = _native.call_times()
    out = fn(*args)
    n1 = _native.call_times()
    c1 = time.thread_time()
    w1 = time.perf_counter()
    return out, (w1 - w0, c1 - c0, n1[0] - n0[0], n1[1] - n0[1])


class _Batcher:
    """Survivor pairs gathered into batches for the pool, in the order
    they come.  ``open(bound)`` starts a wave whose cells are at most
    ``bound``: its batches go out as they fill.  ``open()`` starts one
    held until ``close()``, which knows its cells.  The cap of a wave is
    ``BATCH_CELLS``, lowered so that the wave gives each of ``workers``
    ``BATCHES_PER_WORKER`` batches.  ``close()`` sends what is left, so
    no batch waits on the next stage."""

    def __init__(self, send, workers: int):
        self.send = send
        self.workers = workers
        self.jobs: list = []
        self.cells: list = []
        self.total = 0
        self.cap: Optional[int] = None

    def _cap(self, cells: int) -> int:
        return max(1, min(BATCH_CELLS, int(cells) // (
            BATCHES_PER_WORKER * self.workers)))

    def open(self, bound: Optional[int] = None) -> None:
        self.cap = None if bound is None else self._cap(bound)

    def add(self, job, cells: int) -> None:
        self.jobs.append(job)
        self.cells.append(cells)
        if self.cap is not None:
            self.total += cells
            if self.total >= self.cap:
                self.send(self.jobs)
                self.jobs, self.cells, self.total = [], [], 0

    def close(self) -> None:
        cap = self.cap if self.cap is not None else self._cap(sum(self.cells))
        start, acc = 0, 0
        for k, c in enumerate(self.cells):
            acc += c
            if acc >= cap:
                self.send(self.jobs[start: k + 1])
                start, acc = k + 1, 0
        if start < len(self.jobs):
            self.send(self.jobs[start:])
        self.jobs, self.cells, self.total, self.cap = [], [], 0, None


def _lse0(a):
    # log(1 + e^a), as Pipeline._build_hit computes it
    return math.log1p(math.exp(a)) if a < 30.0 else a


def _elogsurv(x, tau, lam):
    return 0.0 if x < tau else -lam * (x - tau)


def _batch_hit(pli: Pipeline, prof: Profile, sq, hits: TopHits,
               fwdsc: float, nullsc: float, nexpected: float, counts,
               n2sc: np.ndarray, doms) -> "Optional[Hit]":
    """The hit ``Pipeline._build_hit`` builds from the same domain
    definition, from a batch's outputs (``native.domaindef_batch``):
    ``counts`` (regions, clustered, overlaps, envelopes, domains),
    ``n2sc`` [L+1] and ``doms``, a domain's bounds (envelope, alignment,
    model), its scores (envelope, null2 correction, optimal accuracy)
    and its four display lines.  The same scores in the same order of
    operations, so every field is equal."""
    nregions, nclustered, noverlaps, nenvelopes, ndom = counts
    if nregions == 0 or ndom == 0:
        return None
    L = len(sq)
    ev = prof.evparam.astype(np.float64)
    log_omega = math.log(pli.background.omega)
    null2 = pli.null2
    seqbias = (_lse0(log_omega + float(n2sc[1:].sum())) if null2
               else 0.0)
    pre_score = (fwdsc - nullsc) / LOG2
    seq_score = (fwdsc - (nullsc + seqbias)) / LOG2
    sum_score = 0.0
    sum_bias = 0.0
    Ld_total = 0
    for (ienv, jenv, *_), (envsc, domcorrection, _), _ in doms:
        if (envsc - domcorrection > 0.0) if null2 else (envsc > 0.0):
            sum_score += envsc
            Ld_total += jenv - ienv + 1
            if null2:
                sum_bias += domcorrection
    sum_score += (L - Ld_total) * math.log(L / (L + 3.0))
    sum_bias = _lse0(log_omega + sum_bias) if null2 else 0.0
    pre2_score = (sum_score - nullsc) / LOG2
    sum_score = (sum_score - (nullsc + sum_bias)) / LOG2
    if Ld_total > 0 and sum_score > seq_score:
        seq_score = sum_score
        pre_score = pre2_score
    lnP = _elogsurv(seq_score, ev[4], ev[5])
    if pli._mode == "scan":
        tname, tacc = prof.name, prof.accession
        tdesc, tlen = prof.description, prof.M
    else:
        tname, tacc = sq.name, sq.accession or None
        tdesc, tlen = sq.description or None, L
    hit = Hit(hits, tname, tacc, tdesc, tlen,
              score=float(seq_score), pre_score=float(pre_score),
              sum_score=float(sum_score), lnP=lnP,
              nexpected=nexpected, nregions=nregions,
              nclustered=nclustered, noverlaps=noverlaps,
              nenvelopes=nenvelopes)
    best_idx, best_sc = 0, -np.inf
    log_l_l3 = math.log(L / (L + 3.0))
    hmm_accession = prof.accession or prof.name
    for di, ((ienv, jenv, iali, jali, hmmfrom, hmmto),
             (envsc, domcorrection, oasc), lines) in enumerate(doms):
        bitsc = envsc + (L - (jenv - ienv + 1)) * log_l_l3
        dombias = _lse0(log_omega + domcorrection) if null2 else 0.0
        bitsc = (bitsc - (nullsc + dombias)) / LOG2
        ali = Alignment(
            hmm_name=prof.name, hmm_accession=hmm_accession,
            hmm_from=hmmfrom, hmm_to=hmmto, hmm_sequence=lines[0],
            hmm_length=prof.M, target_name=sq.name, target_from=iali,
            target_to=jali, target_sequence=lines[1], target_length=L,
            identity_sequence=lines[2], posterior_probabilities=lines[3])
        hit.domains.append(Domain(
            hit, ienv, jenv, iali, jali, score=float(bitsc),
            bias=float(dombias), correction=float(domcorrection),
            envelope_score=float(envsc), oasc=oasc,
            lnP=_elogsurv(bitsc, ev[4], ev[5]), alignment=ali))
        if bitsc > best_sc:
            best_sc, best_idx = bitsc, di
    hit.best_domain_idx = best_idx
    return hit


def finish_pairs(tables, pairs, rerun):
    """Finish survivor pairs on a pool worker: one native call runs every
    pair's Viterbi F2 gate, domaindef, F3 gate and alignment lines
    (``native.domaindef_batch``, the GIL released), then the hits are
    built from its outputs (:func:`_batch_hit`).  A pair is ``(pipeline,
    profile, its row of tables, target, the address of its residues,
    seed, Forward floor, null score, Viterbi floor or None, TopHits)``.
    A pair that overflowed a buffer takes ``rerun(k)``, the per-pair
    path.  Returns the outcomes, as ``run_domaindef`` gives them, the
    pairs that reached the native domaindef and the native calls that
    ran it."""
    ndd, out = _native.domaindef_batch(
        tables, [p[2] for p in pairs], [p[4] for p in pairs],
        [len(p[3]) for p in pairs], [p[5] for p in pairs],
        [p[6] for p in pairs], [p[8] for p in pairs])
    status = out["status"].tolist()
    pair_dbl = out["pair_dbl"].tolist()
    pair_int = out["pair_int"].tolist()
    n2_off = out["n2_off"].tolist()
    dom_int = out["dom_int"].tolist()
    dom_dbl = out["dom_dbl"].tolist()
    dom_text = out["dom_text"].tolist()
    n2, text = out["n2"], out["text"].tobytes()
    outs, calls, d0 = [], 1 if ndd else 0, 0
    for k, (pli, prof, _, sq, _, _, _, nullsc, _, hits) in enumerate(pairs):
        code = status[k]
        if code == _native.DD_GATED_VIT:
            outs.append(("gated_vit",))
        elif code == _native.DD_GATED_F3:
            outs.append(("gated", pair_dbl[k][0]))
        elif code == _native.DD_OVERFLOW:
            calls += 1
            outs.append(rerun(k))
        else:
            d1 = d0 + pair_int[k][4]
            doms = []
            for d in range(d0, d1):
                o, n = dom_text[d]
                doms.append((dom_int[d], dom_dbl[d], [
                    text[o + q * n: o + (q + 1) * n].decode()
                    for q in range(4)]))
            d0 = d1
            o = n2_off[k]
            outs.append(("hit", _batch_hit(
                pli, prof, sq, hits, pair_dbl[k][0], nullsc, pair_dbl[k][1],
                pair_int[k], n2[o: o + len(sq) + 1], doms)))
    return outs, ndd, calls


def block_key(block: DigitalSequenceBlock) -> bytes:
    """A digest of all that :class:`_Buckets` packs from ``block``: the
    fill code, then each item's length and residue codes, in order.  The
    names and the other fields of the items reach the hits from the block
    itself, at result time, so they stay out of it."""
    d = hashlib.blake2b(digest_size=32)
    d.update(np.int64(block.alphabet.nonresidue_code).tobytes())
    d.update(np.array([len(s) for s in block], np.int64).tobytes())
    for s in block:
        d.update(np.ascontiguousarray(s.sequence, np.uint8))
    return d.digest()


def _update(d, value) -> None:
    """Feed ``value`` (an array, or a scalar, bytes or None) to the
    digest ``d``, dtype and shape first, so no two values feed alike."""
    if isinstance(value, np.ndarray):
        a = np.ascontiguousarray(value)
        d.update(repr((a.dtype.str, a.shape)).encode())
        d.update(a)
    else:
        d.update(repr(value).encode())


def model_key(hmm: HMM) -> bytes:
    """A digest of every field of ``hmm`` that ``Profile.configure``
    (``plan7/profile.py``) and :class:`_ChunkState` read: ``M``, ``t``
    (the transitions and match occupancy), ``mat``, ``ins`` and
    ``composition`` (with ``flags``, the bias filter's composition, set
    from ``mat``, ``ins`` and ``t`` when it is not flagged), ``evparam``,
    ``cutoffs`` (the pipelines' bit cutoffs), ``max_length``, ``name``,
    ``accession``, ``description``, ``consensus``,
    ``consensus_structure``, and the alphabet.  Exact: the arrays' bytes,
    not ``HMM.__eq__``'s ``np.allclose``."""
    d = hashlib.blake2b(digest_size=32)
    for value in (hmm.M, hmm.t, hmm.mat, hmm.ins, hmm.composition,
                  hmm.evparam, hmm.cutoffs, int(hmm.flags), hmm.max_length,
                  hmm.name, hmm.accession, hmm.description, hmm.consensus,
                  hmm.consensus_structure, hmm.alphabet.type,
                  hmm.alphabet.symbols):
        _update(d, value)
    return d.digest()


def group_queries(queries: Sequence[HMM]) -> dict:
    """``{Mp: [query index, ...]}``: queries grouped by model width padded
    to 32; groups of fewer than 32 profiles coalesce upward at 128
    granularity, so long-tail widths share a chunk, and models past the
    kernels' widest stripe (the wide route, over 4,096 slots) at the
    width the kernels pad them to (``ops/batch.py:kernel_width``)."""
    groups: dict = {}
    for qi, hmm in enumerate(queries):
        groups.setdefault(B.round_up(hmm.M, 32), []).append(qi)
    coalesced: dict = {}
    for Mp, qidx in groups.items():
        key = Mp if len(qidx) >= 32 else B.round_up(Mp, 128)
        if not B.stripe_width(key):
            key = B.kernel_width(key)
        coalesced.setdefault(key, []).extend(qidx)
    return coalesced


def _fetch_all(parts: List[torch.Tensor]) -> List[np.ndarray]:
    """Bring many device tensors back with one concatenation and one
    device-to-host copy (into pinned memory when they are on a CUDA
    device: a pageable copy runs at a fraction of the link's rate)."""
    if not parts:
        return []
    flat = torch.cat([p.reshape(-1) for p in parts])
    if flat.is_cuda:
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        flat = host.copy_(flat)
    buf = flat.numpy()
    out, off = [], 0
    for p in parts:
        n = p.numel()
        out.append(buf[off: off + n].reshape(tuple(p.shape)))
        off += n
    return out


class _ChunkState:
    """Per-chunk (stack of <= P_MAX same-Mp profiles) search state; the
    configured profiles and the device ``ProfileBatch`` are memoized on
    the engine by the queries' identity and content (:func:`model_key`):
    an entry holds its queries, and a query edited in place since it was
    configured replaces its chunk's entry."""

    def __init__(self, engine: "SearchEngine", queries, chunk, Mp):
        bg = engine.background
        self.chunk = chunk
        key = (tuple(id(queries[qi]) for qi in chunk), Mp)
        digests = [model_key(queries[qi]) for qi in chunk]
        cached = engine._model_cache.get(key)
        if cached is not None and (cached[1] != digests or any(
                h is not queries[qi] for h, qi in zip(cached[0], chunk))):
            cached = None
        if cached is None:
            profs, profs_uni = [], []
            for qi in chunk:
                hmm = queries[qi]
                profs.append(Profile(hmm.M, hmm.alphabet).configure(
                    hmm, bg, 400, multihit=True))
                profs_uni.append(Profile(hmm.M, hmm.alphabet).configure(
                    hmm, bg, 400, multihit=False))
            pb = B.ProfileBatch(profs, Mp=Mp).to(engine.device)
            ev = np.stack([p.evparam.astype(np.float64) for p in profs])
            for p in profs:
                _native.prewarm(p)
            cached = (list(queries[qi] for qi in chunk), digests, profs,
                      profs_uni, pb, ev)
            engine._model_cache[key] = cached
        _, _, self.profs, self.profs_uni, self.pb, self.ev = cached

        self.pipelines = []
        for pi, qi in enumerate(chunk):
            hmm = queries[qi]
            pli = Pipeline(engine.alphabet, bg.copy(), **engine.options)
            pli.nmodels = 1
            pli.nnodes = hmm.M
            pli.background.set_filter(hmm.M, self.profs[pi].compo)
            if pli.bit_cutoffs_mode is not None:
                idx = {"gathering": 0, "trusted": 2,
                       "noise": 4}[pli.bit_cutoffs_mode]
                c = hmm.cutoffs
                if c[idx] <= -99998.0:
                    raise ValueError(
                        f"model {hmm.name!r} has no "
                        f"{pli.bit_cutoffs_mode} cutoffs")
                pli.bit_cutoffs = (float(c[idx]), float(c[idx + 1]))
            self.pipelines.append(pli)

        self.Preal = len(chunk)
        self.F1 = np.array([pli.F1 for pli in self.pipelines])[:, None]
        self.F2 = np.array([pli.F2 for pli in self.pipelines])[:, None]
        self.F3 = np.array([pli.F3 for pli in self.pipelines])[:, None]
        # threshold form of the MSV gate: P(delta/LOG2) <= F1
        # <=> delta >= LOG2 * invsurv(F1)
        ev = self.ev
        self.thr1 = (LOG2 * gumbel_invsurv(
            self.F1[:, 0], ev[:, 0], ev[:, 1]))[:, None]

        self.tophits = []
        for pi, qi in enumerate(chunk):
            th = TopHits()
            th.query_name = self.profs[pi].name
            th.query_accession = self.profs[pi].accession
            th.query_length = self.profs[pi].M
            self.tophits.append(th)


class SearchEngine:
    """Batched hmmsearch over many queries and one target block.

    ``background`` is the null model every profile is configured
    against (default: the alphabet's, as in ``pyhmmer_tpu``'s engine).
    ``device`` selects where the cascade runs: a CUDA device runs the
    hand-written kernels, ``"cpu"`` their plain PyTorch versions.
    ``device_rows`` turns on the device rows stage (see the module
    docstring); it needs the native library.  ``shared_executor``: a
    caller-owned ``ThreadPoolExecutor`` that runs the native
    postprocessing jobs of every search, and that the engine never shuts
    down (engines running side by side on one host, as
    ``parallel.mesh.sharded_search``'s shards do, share one pool of the
    core count; pools of their own would oversubscribe the cores).
    Without one, each search runs a pool of ``PYHMMER_TPU_THREADS``
    workers (default: the core count, at least 2) and shuts it down."""

    def __init__(self, alphabet: Alphabet,
                 background: Optional[Background] = None, device="cuda",
                 device_rows: bool = False, shared_executor=None,
                 **pipeline_options):
        self.alphabet = alphabet
        self.background = background or Background(alphabet)
        self.device = resolve_device(device)
        self.device_rows = bool(device_rows)
        self.shared_executor = shared_executor
        self.options = pipeline_options
        # persistent across searches: configured-model artifacts keyed by
        # the queries' identity and content, the packed target buckets of
        # the last block by its identity and content (:func:`block_key`)
        self._model_cache: dict = {}
        self._buckets_cache: Optional[tuple] = None
        self._streams: List[torch.cuda.Stream] = []
        #: the last search's stage marks (seconds since set-up ended),
        #: spans (``<name>_s``, :func:`span`), pool and native counters,
        #: and HMMER's pipeline statistics summed over its queries
        self.last_timing: dict = {}

    def _side_stream(self, k: int) -> "torch.cuda.Stream":
        """The engine's ``k``-th side stream (created on first use)."""
        while len(self._streams) <= k:
            self._streams.append(torch.cuda.Stream(self.device))
        return self._streams[k]

    def _survivors(self, rows, need):
        """Bucket rows [n], the ``need`` mask [P, n] of a survivor stage
        and its pair list (``_pairs.host_pairs``, built here on the host so
        the kernel wrapper need not synchronise), on the engine's
        device."""
        rows = np.ascontiguousarray(rows, np.int64)
        need = np.ascontiguousarray(need, bool)
        return (torch.as_tensor(rows, device=self.device),
                torch.as_tensor(need, device=self.device),
                torch.as_tensor(_pairs.host_pairs(rows, need),
                                device=self.device))

    def _bias_host(self, st, pi, codes, lengths, cols):
        """Exact f64 bias-filter log scores (no null term) for one profile
        over selected rows of a bucket."""
        e1 = st.pipelines[pi].background.filter_odds_table()
        out = _native.bias_filter_rows(e1, codes, lengths, cols)
        if out is None:                      # no native library: per-seq
            bgf = st.pipelines[pi].background
            out = np.empty(len(cols))
            for j, b in enumerate(cols):
                Lb = int(lengths[b])
                dsq = codes[b, :Lb]
                p1 = Lb / (Lb + 1.0)
                out[j] = (bgf.filter_score(dsq)
                          - Lb * np.log(p1) - np.log(1.0 - p1))
        return out

    # -- search -------------------------------------------------------------

    def search(self, queries: Sequence[HMM], targets: DigitalSequenceBlock,
               callback=None) -> List[TopHits]:
        """Run hmmsearch for every query HMM; returns one TopHits each,
        in input order, identical to the sequential pipeline's output."""
        #: per-search stage marks (``perf_counter`` seconds since the
        #: stages start), spans (``<name>_s``: :func:`span`) and counters
        tmark: dict = {"submit_s": 0.0, "s1.bias_wait_s": 0.0,
                       "pool_jobs": 0, "pool_native_s": 0.0,
                       "pool_native_cpu_s": 0.0, "pool_py_s": 0.0,
                       "dd_pairs": 0, "dd_native_calls": 0}
        with span(tmark, "setup"):
            queries = list(queries)
            if any(len(s) > MAX_TARGET_LENGTH for s in targets):
                raise ValueError(
                    f"sequence length over comparison pipeline limit "
                    f"({MAX_TARGET_LENGTH})")
            with span(tmark, "setup.pack"):
                # the block is mutable (its items and their residue
                # arrays): reuse its buckets only while it holds the
                # residues they were packed from
                bkey = (id(targets), len(targets), block_key(targets))
                if (self._buckets_cache is not None
                        and self._buckets_cache[0] == bkey):
                    buckets = self._buckets_cache[2]
                else:
                    buckets = _Buckets(targets, self.device)
                    # hold a reference to the block so id() stays unique
                    self._buckets_cache = (bkey, targets, buckets)
            results: List[Optional[TopHits]] = [None] * len(queries)

            for hmm in queries:
                if hmm.alphabet != self.alphabet:
                    raise ValueError(
                        "alphabet mismatch between query and engine")
            states: List[_ChunkState] = []
            with span(tmark, "setup.profiles"):
                for Mp, qidx in sorted(group_queries(queries).items()):
                    for c0 in range(0, len(qidx), P_MAX):
                        states.append(_ChunkState(self, queries,
                                                  qidx[c0: c0 + P_MAX], Mp))

            # every target of the block counts into Z once, empty ones too
            nres = sum(len(s) for s in targets)
            for st in states:
                for pli in st.pipelines:
                    pli.nseqs += len(targets)
                    pli.nres += nres

        t0 = time.perf_counter()

        def mark(name):
            tmark[name] = time.perf_counter() - t0
        native_ok = _native.available()
        own_executor = native_ok and self.shared_executor is None
        if not native_ok:
            executor = None
        elif own_executor:
            executor = _cf.ThreadPoolExecutor(pool_size())
        else:
            executor = self.shared_executor
        # the pool's jobs' summed walls (``pool_result``), and the native
        # phase timers as the stages start
        pool_wall = 0.0
        phase0 = _native.phase_times()

        def to_pool(fn, *args):
            """Hand ``fn(*args)`` to the pool (:func:`_pool_job`)."""
            t = time.perf_counter()
            fut = executor.submit(_pool_job, fn, *args)
            tmark["submit_s"] += time.perf_counter() - t
            return fut

        def pool_result(fut):
            """A pool job's result; its seconds go to the counters."""
            nonlocal pool_wall
            out, (wall, cpu, nwall, ncpu) = fut.result()
            tmark["pool_jobs"] += 1
            tmark["pool_native_s"] += nwall
            tmark["pool_native_cpu_s"] += ncpu
            tmark["pool_py_s"] += cpu - ncpu
            pool_wall += wall
            return out

        pending = []   # ([job tuple, ...], future | None)

        if native_ok:
            # the batches' tables: every profile of the search, and every
            # packed target row's address and length
            tables = _native.BatchTables(
                [p for st in states for p in st.profs],
                [pli.null2 for st in states for pli in st.pipelines])
            prof_off = np.cumsum([0] + [len(st.profs) for st in states])
            row_ptr = np.concatenate([np.zeros(0, np.int64)] + [
                codes.ctypes.data + codes.shape[1] * np.arange(len(codes))
                for _, codes, _, _ in buckets.buckets])
            row_off = np.cumsum(
                [0] + [len(bk[2]) for bk in buckets.buckets])

        def run_batch(jobs):
            """Worker body of a batch of jobs (:func:`finish_pairs`; a
            pair that overflowed a buffer takes :func:`run_domaindef`)."""
            cbpb = np.array([(j[0], j[1], j[2], j[4]) for j in jobs],
                            np.int64).reshape(-1, 4)
            ptrs = row_ptr[row_off[cbpb[:, 1]] + cbpb[:, 3]].tolist()
            pairs = []
            for job, gp, ptr in zip(jobs, (prof_off[cbpb[:, 0]]
                                           + cbpb[:, 2]).tolist(), ptrs):
                st, pi = states[job[0]], job[2]
                pairs.append((st.pipelines[pi], st.profs[pi], gp,
                              targets[job[3]], ptr, job[5], job[6], job[8],
                              job[9], st.tophits[pi]))
            return finish_pairs(tables, pairs,
                                lambda k: run_domaindef(jobs[k]))

        def run_single(job, ext):
            """Worker body of a rows-stage pair: :func:`run_domaindef`,
            counted as one native domaindef call."""
            out = run_domaindef(job, ext)
            n = 0 if out is not None and out[0] == "gated_vit" else 1
            return [out], n, n

        batcher = (_Batcher(
            lambda jobs: pending.append(
                (jobs, executor.submit(_pool_job, run_batch, jobs))),
            executor._max_workers) if native_ok else None)

        def close_wave():
            """Send the wave's last batches before the stage's fetch."""
            if batcher is not None:
                t = time.perf_counter()
                batcher.close()
                tmark["submit_s"] += time.perf_counter() - t

        def run_domaindef(job, ext=None):
            """Worker body: optional native Viterbi F2 gate (host-routed
            sparse pairs), then native domaindef + the exact F3 gate +
            Hit construction; the collect loop appends serially.  ``ext``
            = (rows [3, L+1] f64, f32 Forward score) from the rows stage:
            the native call then skips its own parsers and reruns them
            itself where a region threshold is marginal."""
            (ci, bi, pi, tgt, b, seed, fwd_min, filtersc_b, nullsc_b,
             vit_min) = job
            st = states[ci]
            pli = st.pipelines[pi]
            sq = targets[tgt]
            if vit_min is not None and np.isfinite(vit_min):
                v = _native.viterbi_score(st.profs[pi], sq.sequence)
                if v is None:
                    return None                  # caller falls back
                if v < vit_min:
                    return ("gated_vit",)
            kw = {} if ext is None else dict(ext_rows=ext[0],
                                             ext_fwdsc=ext[1])
            out = _native.domaindef(st.profs[pi], sq.sequence, pli.null2,
                                    seed, fwd_min=fwd_min, **kw)
            if out is None:
                return None                      # caller falls back
            fwdsc, res = out
            if fwdsc < fwd_min:
                return ("gated", fwdsc)
            hit = pli._build_hit(st.profs[pi], sq, st.tophits[pi],
                                 fwdsc, nullsc_b, res)
            return ("hit", hit)

        ctx: dict = {}

        # -- device rows stage: final survivors of stages 2 and 3 are held
        # back per (chunk, bucket), launched through the rows kernels in
        # two waves and reach the pool with their rows attached --
        rows_enabled = self.device_rows and native_ok
        rows_pending: dict = {}      # (ci, bi) -> [job, ...]
        rows_launched: list = []     # (ci, bi, jobs, terms, fsc, bsc)

        def rows_ok(ci, bi):
            Lmax = buckets.buckets[bi][3].Lmax
            Mp = max(128, B.round_up(states[ci].pb.Mp, 128))
            return rows_enabled and Lmax <= ROWS_MAX_L and Mp <= ROWS_MAX_MP

        def launch_rows():
            """Enqueue the rows kernels for every held-back group."""
            for (ci, bi), jobs in rows_pending.items():
                pair_p = np.array([j[2] for j in jobs], np.int32)
                pair_b = np.array([j[4] for j in jobs], np.int32)
                terms, fsc, bsc, order = rows_cuda.survivor_rows(
                    states[ci].pb, buckets.buckets[bi][3], pair_p, pair_b)
                rows_launched.append((ci, bi, [jobs[k] for k in order],
                                      terms, fsc, bsc))
                tmark["n_rows_pairs"] = tmark.get("n_rows_pairs", 0) + len(
                    jobs)
            rows_pending.clear()

        def collect_rows():
            """One fetch of every rows launch; each job goes to the pool
            with its rows if the f32 Forward and Backward scores agree,
            and without them (the exact host parsers) if not."""
            parts = [a for launch in rows_launched for a in launch[3:]]
            arrs = _fetch_all(parts)
            for k, (ci, bi, jobs, *_) in enumerate(rows_launched):
                terms, fsc, bsc = arrs[3 * k: 3 * k + 3]
                lens_b = buckets.buckets[bi][2]
                for g, job in enumerate(jobs):
                    f32, b32 = float(fsc[g]), float(bsc[g])
                    ext = None
                    if (np.isfinite(f32) and np.isfinite(b32)
                            and abs(f32 - b32) < 2e-2 + 1e-4 * abs(f32)):
                        ext = (rows_cuda.ext_rows(terms[g],
                                                  int(lens_b[job[4]])), f32)
                        key = "n_rows_ext"
                    else:
                        key = "n_rows_back"
                    tmark[key] = tmark.get(key, 0) + 1
                    pending.append(([job], to_pool(run_single, job, ext)))
            rows_launched.clear()

        def submit(ci, bi, pi, pass_row, fcols, idx, vit_min_row=None,
                   defer=False):
            t_submit = time.perf_counter()
            st = states[ci]
            pli = st.pipelines[pi]
            c = ctx[(ci, bi)]
            ev = st.ev[pi]
            F3s = pli.F3 * F3_SLACK
            # exp_surv((fwdsc - filtersc)/LOG2) <= F3s  <=>  fwdsc >= min
            gate_off = (LOG2 * (ev[4] - math.log(F3s) / ev[5])
                        if F3s < 1.0 else -np.inf)
            defer = defer and rows_ok(ci, bi)
            M = st.profs[pi].M
            lens_b = buckets.buckets[bi][2]
            for col in np.where(pass_row)[0]:
                b = int(fcols[col])
                seed = (pli.seed if pli.do_reseeding
                        else int(pli._rng.integers(0, 2**62)))
                filtersc_b = float(c["filtersc"][pi, b])
                nullsc_b = float(c["nullsc"][b])
                vit_min = (None if vit_min_row is None
                           else float(vit_min_row[col]))
                job = (ci, bi, pi, int(idx[b]), b, seed,
                       filtersc_b + gate_off, filtersc_b, nullsc_b,
                       vit_min)
                if defer:
                    rows_pending.setdefault((ci, bi), []).append(job)
                elif batcher is not None:
                    batcher.add(job, M * int(lens_b[b]))
                else:
                    pending.append(([job], None))
            tmark["submit_s"] += time.perf_counter() - t_submit

        # -- stage 1 (device): MSV + fused bias for every chunk x bucket --
        # on a CUDA device every long-bucket launch (a few warps, a long
        # serial scan) goes first, each on a side stream of its own, so
        # they run at once and overlap the short buckets
        s1_keys = [(ci, bi) for ci in range(len(states))
                   for bi in range(len(buckets.buckets))]
        s1_out = {}
        side = []
        for ci, bi in s1_keys:
            dev = buckets.buckets[bi][3]
            if self.device.type == "cuda" and dev.Lmax > LONG_BUCKET:
                s = self._side_stream(len(side))
                s.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(s):
                    s1_out[(ci, bi)] = msv_cuda.msv(states[ci].pb, dev)
                side.append(s)
        for ci, bi in s1_keys:
            if (ci, bi) not in s1_out:
                s1_out[(ci, bi)] = msv_cuda.msv(states[ci].pb,
                                                buckets.buckets[bi][3])
        for s in side:
            torch.cuda.current_stream(self.device).wait_stream(s)
        s1_parts = []
        s1_pairs = []   # (ci, bi, part offset), in (chunk, bucket) order
        for ci, bi in s1_keys:
            s1_pairs.append((ci, bi, len(s1_parts)))
            s1_parts.extend(s1_out[(ci, bi)])
        mark("s1_enqueued")

        # -- stage 1 (host): MSV gate, then the exact bias filter on the
        # gate's candidates on the worker pool --
        s1_host_jobs = []   # (npairs, ci, bi, args, fut)
        s1_cells = [0]

        def bias_stage(st, codes, lengths, pass1, nullsc, usc):
            filtersc = np.full_like(usc, np.nan)
            P1b = np.full_like(usc, np.inf)
            pass2 = np.zeros_like(pass1)
            for pi, pli in enumerate(st.pipelines):
                cols = np.where(pass1[pi])[0]
                if len(cols) == 0:
                    continue
                if pli.bias_filter:
                    logsc = self._bias_host(st, pi, codes, lengths, cols)
                    filtersc[pi, cols] = logsc + nullsc[cols]
                else:
                    filtersc[pi, cols] = nullsc[cols]
                P1b[pi, cols] = gumbel_surv(
                    (usc[pi, cols] - filtersc[pi, cols]) / LOG2,
                    st.ev[pi, 0], st.ev[pi, 1])
                pass2[pi, cols] = P1b[pi, cols] <= pli.F1
            return filtersc, P1b, pass2

        for st in states:
            for pli in st.pipelines:
                if pli.bias_filter:
                    pli.background.filter_odds_table()

        def gate_pair(ci, bi, dx_raw, ovf_raw, biaslog_raw):
            st = states[ci]
            idx, codes, lengths, dev = buckets.buckets[bi]
            valid_b = lengths > 0
            L = np.maximum(lengths.astype(np.float64), 1.0)
            nullsc = dev.nullsc_host
            usc = B.msv_nats(dx_raw, ovf_raw, dev.tjbu_host, st.pb.scale_b)
            pass1 = (usc - nullsc[None, :] >= st.thr1) & valid_b[None, :]
            for pi, pli in enumerate(st.pipelines):
                pli.n_past_msv += int(pass1[pi].sum())
            if not pass1.any():
                return
            # the fused f32 bias score drops pairs that fail the MSV gate
            # even with a length-scaled margin in their favour; the rest
            # (and every lane holding a nonresidue code, where the device
            # scan froze) take the exact f64 host filter
            fsc32 = biaslog_raw.astype(np.float64) + nullsc
            delta = 2e-3 + 1e-6 * L
            keep = (usc - fsc32 + delta >= st.thr1) | dev.has_nonres[None, :]
            for pi, pli in enumerate(st.pipelines):
                if not pli.bias_filter:
                    keep[pi] = True
            cand = pass1 & keep
            if not cand.any():
                return
            args = (st, codes, lengths, cand, nullsc, usc)
            fut = (to_pool(bias_stage, *args)
                   if executor is not None else None)
            s1_host_jobs.append((int(cand.sum()), ci, bi, args, fut))
            # the DP cells of the candidates: a bound on those of the
            # pairs this stage hands to the pool
            ms = np.array([p.M for p in st.profs], np.int64)
            s1_cells[0] += int(ms @ (cand @ lengths))

        arrs = _fetch_all(s1_parts)
        mark("s1_fetched")
        with span(tmark, "s1_host"):
            for (ci, bi, off) in s1_pairs:
                gate_pair(ci, bi, *arrs[off: off + 3])

            # gate + route in descending survivor count, enqueueing each
            # job's Forward kernel as soon as it is routed; the pairs
            # routed to the host go out in batches as they fill
            if batcher is not None:
                batcher.open(s1_cells[0])
            s1_host_jobs.sort(key=lambda j: -j[0])
            s2_jobs = []
            s2_parts = []
            for npairs1, ci, bi, args, fut in s1_host_jobs:
                st = states[ci]
                idx, codes, lengths, dev = buckets.buckets[bi]
                if fut is None:
                    filtersc, P1b, pass2 = bias_stage(*args)
                else:
                    with span(tmark, "s1.bias_wait"):
                        filtersc, P1b, pass2 = pool_result(fut)
                nullsc = args[4]
                for pi, pli in enumerate(st.pipelines):
                    pli.n_past_bias += int(pass2[pi].sum())
                if not pass2.any():
                    continue
                bsel = np.where(pass2.any(axis=0))[0]
                ctx[(ci, bi)] = dict(filtersc=filtersc, nullsc=nullsc,
                                     pass2=pass2, P1b=P1b, bsel=bsel)
                # sparse jobs skip the device cascade: native Viterbi gate +
                # domaindef on the host pool
                npairs = int(pass2.sum())
                Lmax_b = codes.shape[1]
                if native_ok and npairs <= max(
                        HOST_MIN_PAIRS,
                        int(HOST_PAIRS_PER_ROW * Lmax_b * st.pb.P)):
                    for pi, pli in enumerate(st.pipelines):
                        cols = np.where(pass2[pi])[0]
                        if len(cols) == 0:
                            continue
                        ev = st.ev[pi]
                        skip = P1b[pi, cols] <= pli.F2 * F2_SKIP_SLACK
                        pli.n_past_vit += int(skip.sum())
                        vmin = (filtersc[pi, cols]
                                + LOG2 * (ev[2] - np.log(pli.F2) / ev[3]))
                        submit(ci, bi, pi, np.ones(len(cols), dtype=bool),
                               cols, idx, np.where(skip, -np.inf, vmin))
                    continue
                # speculative host routing of near-certain hits: such a pair
                # skips Viterbi legitimately and the device Forward is only a
                # prefilter, so starting its exact job now changes nothing
                if native_ok:
                    spec = pass2 & (P1b <= np.minimum(
                        st.F2 * F2_SKIP_SLACK, SPECULATE_P1B))
                    if spec.any():
                        c = ctx[(ci, bi)]
                        for pi, pli in enumerate(st.pipelines):
                            cols = np.where(spec[pi])[0]
                            if len(cols) == 0:
                                continue
                            pli.n_past_vit += len(cols)
                            submit(ci, bi, pi,
                                   np.ones(len(cols), dtype=bool), cols, idx)
                        pass2 = pass2 & ~spec
                        c["pass2"] = pass2
                        if not pass2.any():
                            continue
                        c["bsel"] = np.where(pass2.any(axis=0))[0]
                c = ctx[(ci, bi)]
                s2_parts.append(fwd_cuda.forward(st.pb, dev, *self._survivors(
                    c["bsel"], c["pass2"][:, c["bsel"]])))
                s2_jobs.append((ci, bi))
            close_wave()
        mark("s1_host_done")
        tmark["n_s2_jobs"] = len(s2_jobs)

        # -- stage 2 (host): Forward gate, Viterbi routing; the pairs it
        # hands to the pool are held as one wave until the stage ends --
        s3_jobs = []
        s3_parts = []
        s2_np = _fetch_all(s2_parts)
        mark("s2_fetched")
        with span(tmark, "s2_host"):
            for (cj, bi), fsc_raw in zip(s2_jobs, s2_np):
                st = states[cj]
                c = ctx[(cj, bi)]
                bsel = c["bsel"]
                c["fcols"] = bsel
                fsc = fsc_raw.astype(np.float64)
                P3 = exp_surv((fsc - c["filtersc"][:, bsel]) / LOG2,
                              st.ev[:, 4:5], st.ev[:, 5:6])
                # 1.5x device-side margin: borderline targets still reach the
                # exact float64 re-check, which applies F3 * F3_SLACK
                pass_fwd = c["pass2"][:, bsel] & (P3 <= st.F3 * F3_SLACK * 1.5)
                skip_vit = c["P1b"][:, bsel] <= st.F2 * F2_SKIP_SLACK
                need_vit = pass_fwd & ~skip_vit
                c["pass_fwd"] = pass_fwd
                c["need_vit"] = need_vit
                for pi, pli in enumerate(st.pipelines):
                    pli.n_past_vit += int((c["pass2"][pi, bsel]
                                           & skip_vit[pi]).sum())
                if need_vit.any():
                    vcols = np.where(need_vit.any(axis=0))[0]
                    c["vcols"] = vcols
                    s3_parts.append(vit_cuda.viterbi(
                        st.pb, buckets.buckets[bi][3],
                        *self._survivors(bsel[vcols], need_vit[:, vcols])))
                    s3_jobs.append((cj, bi))
                idx = buckets.buckets[bi][0]
                for pi in range(st.Preal):
                    submit(cj, bi, pi, pass_fwd[pi] & ~need_vit[pi], bsel, idx,
                           defer=True)
            # wave 1 of the rows stage: the survivors that skip Viterbi
            launch_rows()
            close_wave()
        mark("s2_done")
        tmark["n_s3_jobs"] = len(s3_jobs)
        s3_np = _fetch_all(s3_parts)
        mark("s3_fetched")
        # -- stage 3 (host): Viterbi gate on the leftover columns --
        with span(tmark, "s3_host"):
            for (cj, bi), vsc_raw in zip(s3_jobs, s3_np):
                st = states[cj]
                c = ctx[(cj, bi)]
                bsel, vcols = c["bsel"], c["vcols"]
                vsc = vsc_raw.astype(np.float64)
                P2 = gumbel_surv(
                    (vsc - c["filtersc"][:, bsel][:, vcols]) / LOG2,
                    st.ev[:, 2:3], st.ev[:, 3:4])
                keep = P2 <= st.F2
                c["pass_fwd"][:, vcols] &= (~c["need_vit"][:, vcols]) | keep
                for pi, pli in enumerate(st.pipelines):
                    pli.n_past_vit += int((c["need_vit"][pi, vcols]
                                           & keep[pi]).sum())
                idx = buckets.buckets[bi][0]
                survived = c["pass_fwd"][:, vcols] & c["need_vit"][:, vcols]
                for pi in range(st.Preal):
                    submit(cj, bi, pi, survived[pi], bsel[vcols], idx,
                           defer=True)
            # wave 2 (the Viterbi survivors), then the one rows fetch
            launch_rows()
            close_wave()
        mark("s3_host_done")
        with span(tmark, "rows"):
            collect_rows()
        mark("rows_done")

        def collected():
            """Each job and its outcome, batches in submission order and
            a batch's jobs in job order."""
            for jobs, fut in pending:
                if fut is None:
                    yield jobs[0], None
                    continue
                outs, ndd, calls = pool_result(fut)
                tmark["dd_pairs"] += ndd
                tmark["dd_native_calls"] += calls
                yield from zip(jobs, outs)

        # ---- collect: serial append of worker-built hits (deterministic
        # insertion order = deterministic tie-breaking in sort) ----
        with span(tmark, "collect"):
            for job, out in collected():
                (ci, bi, pi, tgt, b, seed, fwd_min, filtersc_b, nullsc_b,
                 vit_min) = job
                st = states[ci]
                pli = st.pipelines[pi]
                vit_gated_here = vit_min is not None and np.isfinite(vit_min)
                if out is None:
                    # pure-Python fallback (no native library)
                    sq = targets[tgt]
                    Lb = int(buckets.buckets[bi][2][b])
                    pli.background.set_length(Lb)
                    st.profs[pi].reconfig_length(Lb)
                    st.profs_uni[pi].reconfig_length(Lb)
                    if vit_gated_here:
                        v = refops.viterbi_score(st.profs[pi], sq.sequence)
                        if v < vit_min:
                            continue
                        pli.n_past_vit += 1
                    fwd = refops.forward(st.profs[pi], sq.sequence)
                    Px = float(exp_surv((fwd.score - filtersc_b) / LOG2,
                                        st.ev[pi, 4], st.ev[pi, 5]))
                    if Px > pli.F3 * F3_SLACK:
                        continue
                    pli.n_past_fwd += 1
                    pli._finish_target(st.profs[pi], st.profs_uni[pi], sq,
                                       st.tophits[pi], fwd, nullsc_b)
                    continue
                if out[0] == "gated_vit":
                    continue
                if vit_gated_here:
                    pli.n_past_vit += 1
                if out[0] == "gated":
                    continue
                pli.n_past_fwd += 1
                hit = out[1]
                if hit is not None:
                    st.tophits[pi].hits.append(hit)
            if own_executor:
                executor.shutdown()
        mark("collect_done")
        # the pool: its workers' seconds over the stages (what its jobs
        # leave of them is its idle time), and its jobs' walls split
        # into native calls (``pool_native_cpu_s`` of them on a core),
        # Python on a core, and the rest: waiting for the GIL or a core
        if executor is not None:
            tmark["pool_worker_s"] = (executor._max_workers
                                      * tmark["collect_done"])
        else:
            tmark["pool_worker_s"] = 0.0
        tmark["pool_py_wait_s"] = (pool_wall - tmark["pool_native_s"]
                                   - tmark["pool_py_s"])
        # the split of ``pool_native_s`` by domaindef phase (process-wide
        # timers: engines sharing one executor mix their deltas)
        phase1 = _native.phase_times()
        tmark["dd_phase_s"] = ([0.0] * len(_native.PHASE_LABELS)
                               if phase0 is None
                               else (phase1 - phase0).tolist())
        # HMMER's pipeline statistics, summed over the search's queries
        plis = [pli for st in states for pli in st.pipelines]
        tmark["n_seqs_searched"] = sum(pli.nseqs for pli in plis)
        for key in ("n_past_msv", "n_past_bias", "n_past_vit",
                    "n_past_fwd"):
            tmark[key] = sum(getattr(pli, key) for pli in plis)
        self.last_timing = tmark

        # ---- finalize ----
        for st in states:
            for pi, qi in enumerate(st.chunk):
                pli = st.pipelines[pi]
                if pli.Z_setby == "ntargets":
                    pli.Z = float(pli.nseqs)
                th = st.tophits[pi]
                th._take_accounting(pli)
                th.bit_cutoffs = pli.bit_cutoffs
                th.sort_by_key()
                th.threshold()
                results[qi] = th
                if callback is not None:
                    callback(queries[qi], len(queries))
        return results  # type: ignore[return-value]
