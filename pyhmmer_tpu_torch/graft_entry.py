"""Driver entry points of the port, beside the JAX package's
``__graft_entry__.py``.

``entry(device)``           -> (fn, example_args): one batched Forward
                               step on the port's Forward kernel
                               (``fwd_cuda.fwd_scores``) over a
                               [profiles, sequences] stack.
``dryrun_multichip(n)``     -> an n-device ``("model", "data")`` mesh:
                               the sharded cascade (MSV + Forward) on
                               tiny shapes against the float64 oracle,
                               a sharded hmmsearch hit for hit against
                               one engine, the multi-process runtime's
                               one-process path and record round trip,
                               and a real 2-process run over ``gloo``.

    python -m pyhmmer_tpu_torch.graft_entry [n_devices]

runs both on the CUDA cards there are (shards placed round robin when
there are fewer cards than ``n_devices``).
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from .ops import _pairs
from .ops import batch as B
from .ops import fwd_cuda


def _tiny_problem(n_profiles=2, n_seqs=8, L=96, seed=0):
    """A small random HMM stack and sequence batch (the JAX package's
    ``__graft_entry__._tiny_problem``, on the port's classes)."""
    from .easel.alphabet import Alphabet
    from .plan7.background import Background
    from .plan7.hmm import HMM
    from .plan7.profile import Profile

    rng = np.random.default_rng(seed)
    alph = Alphabet.amino()
    bg = Background(alph)
    profs = []
    for p in range(n_profiles):
        hmm = HMM.sample(alph, 40 + 10 * p, rng)
        profs.append(Profile(hmm.M, alph).configure(hmm, bg, 400))
    pb = B.ProfileBatch(profs)
    codes = rng.integers(0, alph.K, size=(n_seqs, L)).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, size=n_seqs).astype(np.int64)
    for i, l in enumerate(lengths):
        codes[i, l:] = alph.nonresidue_code
    return pb, codes, lengths


def entry(device="cuda"):
    """One batched Forward step: ``fn(*example_args)`` is the Forward
    scores [P, B] (nats) of the tiny problem's 2 profiles against its 8
    sequences, on ``device`` (the CUDA kernel; on ``"cpu"`` its plain
    version).  The arguments are ``fwd_cuda.fwd_scores``'s: codes,
    lens, length model, packed emission and transition odds, lanes,
    need mask and pair list."""
    from ._device import resolve_device

    dev = resolve_device(device)
    pb, codes, lengths = _tiny_problem()
    seq = B.SeqDevice(codes, lengths, device=dev)
    pb = pb.to(dev)
    rows = np.arange(seq.B, dtype=np.int64)
    need = np.ones((pb.P, seq.B), dtype=bool)
    args = (seq.codes, seq.lens, seq.lm, pb.fwd_emis, pb.fwd_trans,
            torch.as_tensor(rows, device=dev),
            torch.as_tensor(need, device=dev),
            torch.as_tensor(_pairs.host_pairs(rows, need), device=dev))

    def fn(codes, lens, lm, emis, trans, rows, need, pairs):
        return fwd_cuda.fwd_scores(codes, lens, lm, emis, trans, rows,
                                   need, pairs)

    return fn, args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Build an ``n_devices`` mesh over ``devices`` (default: the CUDA
    cards there are, round robin when fewer than ``n_devices``) and run
    on it the sharded cascade against the oracle, a sharded hmmsearch
    against one engine, the multi-process runtime's one-process path and
    record round trip, then a 2-process run over ``gloo`` (rank ``k`` on
    the mesh's ``k``-th device).  Raises on any disagreement; returns
    what it measured."""
    from .engine import SearchEngine
    from .ops import reference as ref
    from .parallel import _worker, multihost
    from .parallel.mesh import (ShardedCascade, devices_or_cards,
                                make_mesh, sharded_search)

    devs = devices_or_cards(devices)
    placed = [devs[i % len(devs)] for i in range(n_devices)]
    distinct = sorted({str(d) for d in placed})
    print(f"dryrun_multichip: {n_devices} shards on {len(distinct)} "
          f"distinct device(s) {distinct}")
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_model=n_model, n_data=n_devices // n_model,
                     devices=placed)
    casc = ShardedCascade(mesh)

    pb, codes, lengths = _tiny_problem(n_profiles=4, n_seqs=8, L=96)
    usc, ovf, n_pass = casc.msv(pb, codes, lengths)
    fwd = casc.forward(pb, codes, lengths)
    if usc.shape != (pb.P, codes.shape[0]) or fwd.shape != usc.shape:
        raise AssertionError(f"shapes {usc.shape}, {fwd.shape}")
    if not np.isfinite(fwd).all():
        raise AssertionError("non-finite Forward scores")
    # spot-check one pair against the float64 oracle
    prof = pb.profiles[0]
    prof.reconfig_length(int(lengths[0]))
    want = ref.forward(prof, codes[0, : lengths[0]]).score
    got = fwd[0, 0]
    if abs(want - got) >= 0.1:
        raise AssertionError(f"fwd[0, 0] {got} against the oracle {want}")
    print(f"sharded cascade ok: mesh={mesh.shape} fwd[0,0]={got:.3f} "
          f"(oracle {want:.3f}) n_pass={n_pass}")

    # a real hmmsearch data-sharded across the mesh, merged under the
    # TopHits.merge contract, hit for hit the single engine's
    queries, targets = _worker.workload("tiny")
    single = SearchEngine(queries[0].alphabet,
                          device=placed[0]).search(queries, targets)
    merged = sharded_search(queries, targets, n_shards=n_devices,
                            devices=placed)
    want_table = _worker.table(single)
    if _worker.table(merged) != want_table:
        raise AssertionError("sharded search differs from one engine")
    stats = sharded_search.last_stats
    nhits = sum(len(r) for r in want_table["rows"])
    print(f"dryrun_multichip ok: {n_devices}-shard hmmsearch "
          f"({len(queries)} queries x {len(targets)} targets) merged "
          f"{nhits} reported hits, identical to one engine; shard "
          f"walls={stats['shard_walls']} total={stats['total_wall']}s "
          f"overlap_factor={stats['overlap_factor']}")

    # the multi-process runtime: the one-process path and the records
    if multihost.initialize() != 1:
        raise AssertionError("a process group outside the dryrun")
    mh = multihost.multihost_search(queries, targets, device=placed[0])
    back = multihost.decode_tophits(multihost.encode_tophits(mh[0]))
    if [(h.name, h.score) for h in back.hits] != \
            [(h.name, h.score) for h in mh[0].hits]:
        raise AssertionError("record round trip changed the hits")
    if _worker.table(mh) != want_table:
        raise AssertionError("one-process multihost_search differs")
    print(f"multihost ok: 1-process search + record round trip "
          f"({len(mh[0].hits)} hits)")

    # the real 2-process run: gloo on a localhost coordinator
    with tempfile.TemporaryDirectory() as td:
        ranks, retries = _worker.spawn([str(d) for d in placed[:2]],
                                       "tiny", td)
    for r in ranks:
        if {k: r[k] for k in ("rows", "acct")} != want_table:
            raise AssertionError(f"rank {r['rank']}'s table differs from "
                                 f"the one-process search")
    print(f"2-process multihost ok: rank tables identical to the "
          f"one-process search (retries {retries})")
    return {"devices": distinct, "mesh": mesh.shape, "n_pass": n_pass,
            "fwd00": float(got), "oracle00": float(want),
            "sharded": stats, "reported": nhits,
            "ranks": [{k: r[k] for k in ("wall_s", "run_s", "search_wall",
                                         "bytes_sent", "bytes_received")}
                      for r in ranks], "retries": retries}


if __name__ == "__main__":
    fn, args = entry()
    print("entry forward step:", fn(*args).cpu().numpy()[:, :3])
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else torch.cuda.device_count())
