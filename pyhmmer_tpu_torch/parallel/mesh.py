"""Sharded search over torch devices: the port of
``pyhmmer_tpu/parallel/mesh.py``.

The reference's distribution mechanisms map onto a grid of devices: the
residue-balanced target chunks of its ``_ReverseSEARCHDispatcher`` become
the *data* axis, hmmscan's profile-database sharding the *model* axis,
and the hmmpgmd master's hit merge ``TopHits.merge`` (concatenate, sum
auto-Z, re-threshold).  Every (profile, sequence) pair is independent,
so the shards need no communication until the merge.

A :class:`Mesh` is an object array of ``torch.device`` of shape
``(n_model, n_data)``; a device may repeat, so shards can share one card
(as the JAX package's tests share 8 virtual CPU devices).  Without
``devices`` every function here takes the CUDA cards there are, and
raises where there is none: nothing moves to the CPU unless the caller
names it.
"""

from __future__ import annotations

import concurrent.futures as _cf
import contextlib
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import _pairs
from ..ops import batch as B
from ..ops import fwd_cuda, msv_cuda

__all__ = ["Mesh", "make_mesh", "ShardedCascade", "sharded_search",
           "sharded_nhmmer", "residue_balanced_chunks", "devices_or_cards"]


def devices_or_cards(devices=None) -> List[torch.device]:
    """``devices`` as torch devices, or every CUDA card there is; raises
    ``resolve_device``'s error where there is no card."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("no devices")
    return devices


def on_device(device: torch.device):
    """A context making ``device`` the current CUDA device (a kernel
    wrapper launches on the current stream of its tensors' device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Mesh:
    """A ``("model", "data")`` grid of torch devices."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"model": devices.shape[0], "data": devices.shape[1]}


def make_mesh(n_model: int = 1, n_data: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a ``("model", "data")`` mesh over ``devices`` (default: the
    CUDA cards there are)."""
    devices = devices_or_cards(devices)
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    if n_model < 1 or n_data < 1 or n_model * n_data > n:
        raise ValueError(f"a {n_model} x {n_data} mesh needs "
                         f"{n_model * n_data} devices, have {n}")
    arr = np.empty(n_model * n_data, dtype=object)
    arr[:] = devices[: n_model * n_data]
    return Mesh(arr.reshape(n_model, n_data))


def _pad_to(x: np.ndarray, axis: int, mult: int, fill) -> np.ndarray:
    n = x.shape[axis]
    target = ((n + mult - 1) // mult) * mult
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)


class ShardedCascade:
    """Run the MSV and Forward kernels with profiles sharded over the
    ``model`` axis and target sequences over the ``data`` axis.

    The lanes are padded to a multiple of ``n_data`` with empty lanes (as
    in the JAX package); the profiles are cut into ``n_model`` slices of
    ``ceil(P / n_model)`` (the JAX package's padding profiles, cost 255,
    pass nothing, so none is built).  Shard (i, j) packs profile slice
    ``i`` at the batch's ``Mp`` and target slice ``j`` onto device (i,
    j)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_model = mesh.shape["model"]
        self.n_data = mesh.shape["data"]

    def _shards(self, pb: B.ProfileBatch, codes: np.ndarray,
                lengths: np.ndarray):
        """(profile slice, lane slice, ProfileBatch, SeqDevice) of every
        shard, each on its device; and the padded lengths."""
        codes_p = _pad_to(codes, 0, self.n_data, 0)
        lengths_p = _pad_to(np.asarray(lengths), 0, self.n_data, 0)
        per_p = -(-pb.P // self.n_model)
        per_b = codes_p.shape[0] // self.n_data
        arrays = pb.arrays()
        shards = []
        for i in range(self.n_model):
            psl = slice(i * per_p, min(pb.P, (i + 1) * per_p))
            if psl.start >= psl.stop:
                continue
            part = {n: arrays[n][psl] for n in B.FIELDS}
            part.update(Mp=pb.Mp, Kp=pb.Kp, scale_b=pb.scale_b)
            for j in range(self.n_data):
                dev = self.mesh.devices[i, j]
                bsl = slice(j * per_b, (j + 1) * per_b)
                shards.append((psl, bsl,
                               B.profile_batch_from_arrays(part).to(dev),
                               B.SeqDevice(codes_p[bsl], lengths_p[bsl],
                                           device=dev)))
        return shards, lengths_p

    def msv(self, pb: B.ProfileBatch, codes: np.ndarray,
            lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """Sharded quantized MSV over all (profile, sequence) pairs.

        Returns ``(usc[P, B] nats, overflow[P, B], n_pass)``: ``n_pass``,
        the pairs with ``dx > 0`` and no overflow, is counted on each
        shard's device and summed (the JAX package's cross-device
        reduction)."""
        shards, lengths_p = self._shards(pb, codes, lengths)
        dx = np.zeros((pb.P, len(lengths_p)), np.float32)
        ovf = np.zeros_like(dx)
        counts = []
        for psl, bsl, pbi, seq in shards:
            with on_device(seq.device):
                d, o, _ = msv_cuda.msv(pbi, seq)
                counts.append(((d > 0) & (o == 0)).sum())
            dx[psl, bsl] = d.cpu().numpy()
            ovf[psl, bsl] = o.cpu().numpy()
        n_pass = sum(int(c) for c in counts)
        Breal = codes.shape[0]
        usc = B.msv_nats(dx, ovf, B.tjb_units(np.maximum(lengths_p, 1)),
                         pb.scale_b)[:, :Breal]
        return usc, ovf[:, :Breal] > 0, n_pass

    def forward(self, pb: B.ProfileBatch, codes: np.ndarray,
                lengths: np.ndarray) -> np.ndarray:
        """Sharded Forward scores [P, B] in nats, float64 (``NEGMASS``
        for an empty target, which the kernel does not score)."""
        shards, lengths_p = self._shards(pb, codes, lengths)
        out = np.zeros((pb.P, len(lengths_p)), np.float64)
        for psl, bsl, pbi, seq in shards:
            rows = np.arange(seq.B, dtype=np.int64)
            need = np.tile(seq.lengths > 0, (pbi.P, 1))
            with on_device(seq.device):
                sc = fwd_cuda.forward(
                    pbi, seq, torch.as_tensor(rows, device=seq.device),
                    torch.as_tensor(need, device=seq.device),
                    torch.as_tensor(_pairs.host_pairs(rows, need),
                                    device=seq.device))
            out[psl, bsl] = sc.cpu().numpy()
        return out[:, : codes.shape[0]]


def residue_balanced_chunks(targets, n_chunks: int):
    """Split a target block into ~residue-balanced contiguous chunks
    (the reference's ``_ReverseSEARCHDispatcher`` splitting rule,
    ``hmmer/_hmmsearch.py:115-289``).  Returns a list of index lists."""
    lengths = np.array([len(s) for s in targets], dtype=np.int64)
    total = int(lengths.sum())
    per = max(1, total // max(1, n_chunks))
    chunks, cur, acc = [], [], 0
    for i, ln in enumerate(lengths):
        cur.append(i)
        acc += int(ln)
        if acc >= per and len(chunks) < n_chunks - 1:
            chunks.append(cur)
            cur, acc = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def sharded_search(queries, targets, n_shards: Optional[int] = None,
                   engine_factory=None, devices=None,
                   concurrent: bool = True, **options):
    """Data-parallel hmmsearch: targets split residue-balanced into
    ``n_shards`` chunks (default: one a device; fewer where there are
    fewer targets), one ``SearchEngine`` a chunk on
    ``devices[k % len(devices)]`` (default: the CUDA cards there are),
    partial ``TopHits`` merged with the reference's contract
    (concatenate, sum auto-Z, re-threshold: ``TopHits.merge``).

    Shards run on one thread each, and every engine sends its native
    postprocessing to one host-wide pool of ``PYHMMER_TPU_THREADS``
    workers (default: the core count).  Shards on one card enqueue on
    its default stream, so their kernels run in turn while their host
    work overlaps.  An exception in a shard propagates once every shard
    has ended; the pool is shut down in every case.  The merged output
    is hit for hit the single-shot search's.

    Per-shard wall times, the overlap factor ``sum(shard walls) / total
    wall`` and each shard engine's stage marks (``last_timing``) are
    left in ``sharded_search.last_stats`` after each call.  Returns one merged ``TopHits`` per query, in query order."""
    from ..easel.sequence import DigitalSequenceBlock
    from ..engine import SearchEngine, pool_size

    queries = list(queries)
    if not queries:
        return []
    devices = devices_or_cards(devices)
    n_shards = n_shards or len(devices)
    chunks = residue_balanced_chunks(targets, n_shards) or [[]]
    alphabet = queries[0].alphabet
    shared_pool = _cf.ThreadPoolExecutor(pool_size())
    try:
        if engine_factory is None:
            def engine_factory(device):
                return SearchEngine(alphabet, device=device,
                                    shared_executor=shared_pool, **options)

        shard_jobs = []
        for si, chunk in enumerate(chunks):
            block = DigitalSequenceBlock(targets.alphabet,
                                         (targets[i] for i in chunk))
            shard_jobs.append((engine_factory(devices[si % len(devices)]),
                               block))
        walls = [0.0] * len(shard_jobs)

        def _run(si):
            eng, block = shard_jobs[si]
            t0 = time.time()
            with on_device(eng.device):
                out = eng.search(queries, block)
            walls[si] = time.time() - t0
            return out

        t_total = time.time()
        if concurrent and len(shard_jobs) > 1:
            with _cf.ThreadPoolExecutor(len(shard_jobs)) as ex:
                futures = [ex.submit(_run, si)
                           for si in range(len(shard_jobs))]
            partials = [f.result() for f in futures]
        else:
            partials = [_run(si) for si in range(len(shard_jobs))]
        total_wall = time.time() - t_total
    finally:
        shared_pool.shutdown()

    sharded_search.last_stats = {
        "n_shards": len(shard_jobs),
        "shard_walls": walls,
        "total_wall": total_wall,
        "overlap_factor": sum(walls) / max(total_wall, 1e-9),
        "shard_marks": [getattr(eng, "last_timing", None)
                        for eng, _ in shard_jobs],
    }
    return [partials[0][qi].merge(*(p[qi] for p in partials[1:]))
            for qi in range(len(queries))]


def sharded_nhmmer(query, targets, n_shards: Optional[int] = None,
                   devices=None, concurrent: bool = True, **options):
    """Sequence-length-parallel nhmmer: long targets cut into
    residue-balanced contiguous slices with a ``max_length``-residue halo
    (any reportable hit fits inside one slice), one
    ``LongTargetsPipeline`` a shard on ``devices[k % len(devices)]``
    (default: the CUDA cards there are), each on a thread of its own;
    hit coordinates shifted back to global positions and the halo's
    duplicates removed with the best-E-value rule
    (``p7_tophits_RemoveDuplicates``), E-values against the global
    residue count, so the merged output is the single-shot search's.

    Returns one merged ``TopHits`` for the query."""
    from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
    from ..plan7.longtargets import (LongTargetsPipeline,
                                     compute_max_length,
                                     _remove_duplicates)
    from ..plan7.results import TopHits

    targets = list(targets)
    devices = devices_or_cards(devices)
    n_shards = n_shards or len(devices)
    C = options.get("window_length") or compute_max_length(
        query, options.get("window_beta") or 7e-5)
    total = sum(len(s) for s in targets)
    stride = max(C + 1, -(-total // n_shards))

    # per-shard slice lists [(global_start0, full_len, sub)]: slices
    # overlap by C residues, so a boundary hit appears in one or two
    # shards and is deduplicated; a slice's global offset rides in its
    # name ("name//offset") and the name is restored after the shift
    shards = [[] for _ in range(n_shards)]
    si = 0
    for t, sq in enumerate(targets):
        L = len(sq)
        a = 0
        while a < L:
            b = min(L, a + stride + C)
            sub = DigitalSequence(
                sq.alphabet, name=sq.name + b"//%d" % a,
                accession=sq.accession, description=sq.description,
                sequence=sq.sequence[a: b])
            shards[si % n_shards].append((a, L, sub))
            si += 1
            if b >= L:
                break
            a += stride

    # each shard computes E-values over the global residue count
    opts = dict(options)
    opts["Z"] = total / 1e6

    def _run(k):
        chunk = shards[k]
        if not chunk:
            return None
        device = devices[k % len(devices)]
        pli = LongTargetsPipeline(query.alphabet, device=device, **opts)
        block = DigitalSequenceBlock(query.alphabet,
                                     [e[2] for e in chunk])
        with on_device(device):
            th = pli.search_hmm(query, block)
        return (chunk, th, pli)

    if concurrent and n_shards > 1:
        with _cf.ThreadPoolExecutor(n_shards) as ex:
            futures = [ex.submit(_run, k) for k in range(n_shards)]
        runs = [f.result() for f in futures]
    else:
        runs = [_run(k) for k in range(n_shards)]

    merged = TopHits()
    merged.query_name = query.name
    merged.query_accession = query.accession or None
    merged.query_length = query.M
    merged._mode = "search"
    merged.long_targets = True
    by_tag = {e[2].name: (e[0], e[1]) for sh in shards for e in sh}
    first = True
    for run in runs:
        if run is None:
            continue
        chunk, th, pli = run
        for h in th.hits:
            a0, Lfull = by_tag[h.name]
            h.name = h.name.rsplit(b"//", 1)[0]
            h.length = Lfull
            for d in h.domains:
                d.env_from += a0
                d.env_to += a0
                d.ali_from += a0
                d.ali_to += a0
                if d.alignment is not None:
                    d.alignment.target_from += a0
                    d.alignment.target_to += a0
                    d.alignment.target_length = Lfull
                    d.alignment.target_name = h.name
            h.hits = merged
            merged.hits.append(h)
        if first:
            merged._take_accounting(pli)
            first = False
        else:
            merged.nseqs += pli.nseqs
            merged.nres += pli.nres
            merged.n_past_msv += pli.n_past_msv
            merged.n_past_bias += pli.n_past_bias
            merged.n_past_vit += pli.n_past_vit
            merged.n_past_fwd += pli.n_past_fwd
        merged.bit_cutoffs = pli.bit_cutoffs
    merged.nseqs = len(targets)
    merged.Z = merged.domZ = 1.0
    merged.Z_setby = merged.domZ_setby = "option"
    merged.sort_by_seqidx()
    _remove_duplicates(merged)
    merged.sort_by_key()
    merged.threshold()
    return merged
