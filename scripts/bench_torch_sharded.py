"""Where the wall of a sharded smoke search goes on one NVIDIA GPU.

    python3 scripts/bench_torch_sharded.py [--shards 4] [--runs 3] [--out JSON]

Runs the smoke hmmsearch of ``chip_smoke.py`` (245 queries x 4,002
targets, ``pyhmmer_tpu_torch``) on one card, first (in a fresh process,
so its kernels and the native library load under the shards' threads)
as ``parallel.mesh.sharded_search`` in ``--shards`` shards, held against
the single-shot search; then ``--runs`` rounds, each in turns of: the
single-shot ``SearchEngine.search``, the sharded search with one thread
a shard (the default), and the same shards one after another
(``concurrent=False``).  Every run ends in ``torch.cuda.synchronize()``.
Prints per mode the walls, the shard walls and the overlap factor, and
per engine its stage marks (``SearchEngine.last_timing``, in
``last_stats["shard_marks"]`` for the shards), with the card's name and
power limit; writes them to ``--out`` as JSON
(default ``build/bench_torch_sharded.json``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from pyhmmer_tpu_torch import SearchEngine  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch.parallel import _worker, mesh  # noqa: E402


def sharded(queries, targets, shards, concurrent):
    """(results, wall, ``last_stats``)."""
    t = time.time()
    res = mesh.sharded_search(queries, targets, n_shards=shards,
                              devices=["cuda:0"] * shards,
                              concurrent=concurrent)
    torch.cuda.synchronize()
    return res, time.time() - t, dict(mesh.sharded_search.last_stats)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "bench_torch_sharded.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_torch_sharded: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    queries, _, targets, _ = syn.smoke_workload()
    first, first_s, first_stats = sharded(queries, targets, args.shards,
                                          True)
    single = SearchEngine(queries[0].alphabet, device="cuda").search(
        queries, targets)
    out = {"card": card, "shards": args.shards, "queries": len(queries),
           "targets": len(targets), "first_sharded_s": first_s,
           "first_sharded_stats": first_stats,
           "first_identical": _worker.table(first) == _worker.table(single),
           "single_s": [], "concurrent_s": [], "serial_s": [],
           "concurrent_stats": [], "serial_stats": [], "single_marks": []}
    for _ in range(args.runs):
        eng = SearchEngine(queries[0].alphabet, device="cuda")
        t = time.time()
        eng.search(queries, targets)
        torch.cuda.synchronize()
        out["single_s"].append(time.time() - t)
        out["single_marks"].append(eng.last_timing)
        for mode, conc in (("concurrent", True), ("serial", False)):
            res, wall, stats = sharded(queries, targets, args.shards,
                                       conc)
            if _worker.table(res) != _worker.table(single):
                sys.exit(f"bench_torch_sharded: {mode} rows differ")
            out[f"{mode}_s"].append(wall)
            out[f"{mode}_stats"].append(stats)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, default=str)
    print(card)
    print(json.dumps({k: out[k] for k in (
        "shards", "first_sharded_s", "first_identical", "single_s",
        "concurrent_s", "serial_s")}))
    for mode in ("concurrent", "serial"):
        print(mode, "shard walls", [s["shard_walls"]
                                    for s in out[f"{mode}_stats"]],
              "overlap", [s["overlap_factor"]
                          for s in out[f"{mode}_stats"]])
    for mode, marks in (("single", out["single_marks"][-1:]),
                        ("concurrent", out["concurrent_stats"][-1][
                            "shard_marks"]),
                        ("serial", out["serial_stats"][-1]["shard_marks"])):
        print(mode, {k: [m.get(k) for m in marks]
                     for k in ("setup_s", "s1_fetched", "s1_host_done",
                               "s2_done", "collect_done")})


if __name__ == "__main__":
    main()
