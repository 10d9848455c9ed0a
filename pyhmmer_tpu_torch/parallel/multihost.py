"""Multi-process distributed search over ``torch.distributed``: the port
of ``pyhmmer_tpu/parallel/multihost.py``.

The analog of the reference's hmmpgmd master/worker service: instead of
a TCP master sharding a cached sequence database across worker processes
and merging their serialized ``P7_HIT`` streams, each process searches
its own residue-balanced target shard with its own engine, and the
partial ``TopHits`` are exchanged as uint8 records through
``torch.distributed.all_gather``, then combined with the exact
``TopHits.merge`` contract (concatenate, sum auto-Z, re-threshold).

The hit records reuse the hmmpgmd wire codec (:mod:`..daemon`): one
length-prefixed stats block and the serialized hit stream, padded to the
longest record so that every process contributes a tensor of one shape.
The merge order is the rank order, so every rank returns the same
output, and that output is the one-process search's.

The records are host bytes, so the exchange runs on the ``gloo``
backend, whatever device each rank's engine searches on (``device=`` in
``options``).  Launch recipe (one process a host, or several on one)::

    # rank 0 (its host holds the coordinator's TCP store):
    PYHMMER_TPU_COORD=host0:8476 PYHMMER_TPU_NPROC=4 PYHMMER_TPU_PROC=0 \\
        python my_search.py
    # rank k:
    PYHMMER_TPU_COORD=host0:8476 PYHMMER_TPU_NPROC=4 PYHMMER_TPU_PROC=k \\
        python my_search.py

where ``my_search.py`` calls::

    from pyhmmer_tpu_torch.parallel import multihost
    multihost.initialize()                  # no-op when NPROC is unset/1
    hits = multihost.multihost_search(queries, full_targets,
                                      device="cuda:0")

Every process loads (or streams) the same target file; the shard split
is deterministic, so no data moves before the hit exchange.  A single
process needs no initialization and returns ``SearchEngine.search``'s
output.  ``python -m pyhmmer_tpu_torch.parallel._worker`` runs one rank
over a seeded workload.
"""

from __future__ import annotations

import os
import struct
import time
from typing import List, Optional

import numpy as np

__all__ = ["initialize", "encode_tophits", "decode_tophits",
           "allgather_bytes", "multihost_search", "world"]

_MAGIC = b"PTH1"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> int:
    """Initialize ``torch.distributed`` from the arguments or the
    ``PYHMMER_TPU_COORD`` (``host:port``) / ``PYHMMER_TPU_NPROC`` /
    ``PYHMMER_TPU_PROC`` environment (a no-op for one process).  Returns
    the process count."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("PYHMMER_TPU_NPROC", "1"))
    if num <= 1:
        return 1
    coord = coordinator_address or os.environ.get("PYHMMER_TPU_COORD")
    if not coord:
        raise ValueError("no coordinator address (PYHMMER_TPU_COORD)")
    pid = process_id if process_id is not None else int(
        os.environ.get("PYHMMER_TPU_PROC", "0"))
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=num, rank=pid)
    return num


def world():
    """(process count, this process's rank): (1, 0) without an
    initialized process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def encode_tophits(th) -> np.ndarray:
    """Serialize a partial ``TopHits`` (hits + the accounting the merge
    contract needs) into a flat uint8 record array."""
    from ..daemon import _serialize_hit

    setby = {"ntargets": 0, "option": 1, "fixed": 2}
    hit_blobs = [_serialize_hit(h, dp=True) for h in th.hits]
    head = _MAGIC + struct.pack(
        ">2d2B4q8q",
        float(th.Z), float(th.domZ),
        setby.get(th.Z_setby, 0), setby.get(th.domZ_setby, 0),
        int(th.nmodels), int(th.nseqs), int(th.nres), int(th.nnodes),
        int(th.n_past_msv), int(th.n_past_bias), int(th.n_past_vit),
        int(th.n_past_fwd), int(th.query_length or 0), len(hit_blobs),
        0, 0,
    )
    qn = th.query_name or b""
    qa = th.query_accession or b""
    head += struct.pack(">2I", len(qn), len(qa)) + qn + qa
    payload = head + b"".join(hit_blobs)
    return np.frombuffer(payload, dtype=np.uint8).copy()


def decode_tophits(buf: np.ndarray):
    """Inverse of :func:`encode_tophits`; returns a ``TopHits`` whose
    hits/flags/accounting round-trip exactly."""
    from ..daemon import _Reader, _deserialize_hit
    from ..plan7.results import TopHits

    raw = bytes(np.asarray(buf, dtype=np.uint8).tobytes())
    if raw[:4] != _MAGIC:
        raise ValueError("bad multihost TopHits record")
    r = _Reader(raw[4:])
    (Z, domZ, z_setby, domz_setby, nmodels, nseqs, nres, nnodes,
     n_past_msv, n_past_bias, n_past_vit, n_past_fwd, qlen, nhits,
     _r0, _r1) = r.take(">2d2B4q8q")
    nqn, nqa = r.take(">2I")
    qn = r.buf[r.pos: r.pos + nqn]
    qa = r.buf[r.pos + nqn: r.pos + nqn + nqa]
    r.pos += nqn + nqa

    th = TopHits()
    setby = {0: "ntargets", 1: "option", 2: "fixed"}
    th.Z, th.domZ = Z, domZ
    th.Z_setby = setby[z_setby]
    th.domZ_setby = setby[domz_setby]
    th.nmodels, th.nseqs, th.nres, th.nnodes = (nmodels, nseqs, nres,
                                                nnodes)
    th.n_past_msv, th.n_past_bias = n_past_msv, n_past_bias
    th.n_past_vit, th.n_past_fwd = n_past_vit, n_past_fwd
    th.query_name = qn or None
    th.query_accession = qa or None
    th.query_length = qlen or None
    for _ in range(nhits):
        th.hits.append(_deserialize_hit(th, r, dp=True))
    return th


def allgather_bytes(payload: np.ndarray) -> List[np.ndarray]:
    """Exchange one uint8 array a process; returns every process's
    payload in rank order.  The lengths go first (int64), then the
    payloads padded to the longest, sliced back after the gather.  One
    process: identity."""
    import torch
    import torch.distributed as dist

    nproc, _ = world()
    n = np.asarray(payload, dtype=np.uint8)
    if nproc == 1:
        return [n]
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(lengths, torch.tensor([n.size], dtype=torch.int64))
    width = max(int(x) for x in lengths)
    padded = torch.zeros(width, dtype=torch.uint8)
    padded[: n.size] = torch.from_numpy(n)
    gathered = [torch.zeros(width, dtype=torch.uint8) for _ in range(nproc)]
    dist.all_gather(gathered, padded)
    return [g[: int(x)].numpy() for g, x in zip(gathered, lengths)]


def multihost_search(queries, targets, engine=None, **options):
    """Distributed hmmsearch: this process searches its residue-balanced
    target shard, the partial hits are allgathered as records, and every
    process returns the same merged ``TopHits`` list.

    ``targets`` is the full target block (every process computes the
    same shard split; with more processes than chunks the last ones get
    an empty shard).  ``engine`` (default: a ``SearchEngine`` with
    ``options``, on ``device="cuda"`` unless ``options`` name another)
    searches the shard.  On one process: ``SearchEngine.search``.
    ``multihost_search.last_stats`` holds the search's and the
    exchange's walls and the record bytes sent and received."""
    from ..easel.sequence import DigitalSequenceBlock
    from ..engine import SearchEngine
    from .mesh import residue_balanced_chunks

    queries = list(queries)
    if not queries:
        return []
    nproc, pid = world()
    if engine is None:
        engine = SearchEngine(queries[0].alphabet, **options)

    t0 = time.time()
    if nproc == 1:
        out = engine.search(queries, targets)
        multihost_search.last_stats = {
            "search_wall": time.time() - t0, "exchange_wall": 0.0,
            "bytes_sent": 0, "bytes_received": 0}
        return out

    chunks = residue_balanced_chunks(targets, nproc)
    while len(chunks) < nproc:           # more processes than targets
        chunks.append([])
    local = DigitalSequenceBlock(targets.alphabet,
                                 (targets[i] for i in chunks[pid]))
    partials = engine.search(queries, local)
    t1 = time.time()

    merged = []
    sent = received = 0
    for qi in range(len(queries)):
        record = encode_tophits(partials[qi])
        blobs = allgather_bytes(record)
        sent += record.size
        received += sum(b.size for i, b in enumerate(blobs) if i != pid)
        parts = [decode_tophits(b) for b in blobs]
        # merge order = rank order; the local partial is replaced by its
        # own round-tripped copy, so every rank merges identical inputs
        merged.append(parts[0].merge(*parts[1:]))
    multihost_search.last_stats = {
        "search_wall": t1 - t0, "exchange_wall": time.time() - t1,
        "bytes_sent": sent, "bytes_received": received}
    return merged
