"""Time the walls of three end-to-end runs of checkouts of the PyTorch
port in turns.

    python3 scripts/bench_torch_walls.py ROOT_A [ROOT_B ...] [--out FILE]
        [--reps N] [--workloads NAME ...]

Each root is a checkout holding ``pyhmmer_tpu_torch`` (for example this
tree and a ``git archive`` of its parent, unpacked into a directory that
``.gitignore`` lists).  The roots run in turns A, B, ..., ..., B, A,
each in a process of its own that imports that root's package, builds
its kernels and the seeded workloads of ``chip_smoke.py``
(``_synthetic.smoke_workload``, ``_synthetic.nhmmer_workload``), then
times, after one warm run each, ``--reps`` runs (default 3) of: the
smoke search (``hmmsearch(device="cuda")`` of the 245 queries against
the 4,002 targets), the wide phmmer (the 9,000-residue target as the
query against the targets: its model's build, its calibration and the
wide route's kernels), nhmmer of the three DNA models (calibrated on
the card once) against the 2 Mb genome, and jackhmmer of
``chip_smoke.py``'s two jackhmmer queries (the first two planted
targets of the first model) against the targets, three rounds each;
``--workloads`` picks some of ``search``, ``wide_phmmer``, ``nhmmer``,
``jackhmmer`` (default: all).  Each wall ends in
``torch.cuda.synchronize()``.  The card's name and power limit head the
output; the last line gives every run's walls per workload; the JSON
record goes to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import time


WORKLOADS = ("search", "wide_phmmer", "nhmmer", "jackhmmer")


def one_run(root, reps, names):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import pyhmmer_tpu_torch as pt
    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch.ops import _build
    from pyhmmer_tpu_torch.plan7 import Background, Builder
    _build.lib()
    queries, smoke_models, targets, planted = syn.smoke_workload()
    q9k = next(s for s in targets if len(s) == syn.SMOKE_LONG[0])
    by_name = {s.name: s for s in targets}
    jack = [by_name[n] for n in sorted(planted[smoke_models[0].name])[:2]]
    if "nhmmer" in names:
        models, genome, _ = syn.nhmmer_workload()
        bld = Builder(genome.alphabet, device="cuda")
        for h in models:
            bld.calibrate(h, Background(genome.alphabet))
    work = {
        "search": lambda: list(pt.hmmsearch(queries, targets,
                                            device="cuda")),
        "wide_phmmer": lambda: list(pt.phmmer(q9k, targets,
                                              device="cuda")),
        "nhmmer": lambda: list(pt.nhmmer(models, genome, device="cuda")),
        "jackhmmer": lambda: list(pt.jackhmmer(
            jack, targets, device="cuda", max_iterations=3,
            checkpoints=True)),
    }
    walls = {}
    for name in names:
        fn = work[name]
        fn()
        torch.cuda.synchronize()
        walls[name] = []
        for _ in range(reps):
            t = time.time()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.time() - t)
        print(json.dumps({"root": root, name: walls[name]}), flush=True)
    return {"root": root, "walls": walls}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workloads", nargs="+", choices=WORKLOADS,
                    default=list(WORKLOADS))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print("RESULT " + json.dumps(one_run(a.one, a.reps, a.workloads)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    order = list(a.roots) + list(reversed(a.roots))
    runs = []
    for root in order:
        pr = subprocess.run([sys.executable, os.path.abspath(__file__),
                             root, "--one", root, "--reps", str(a.reps),
                             "--workloads", *a.workloads],
                            capture_output=True, text=True, timeout=1800)
        sys.stdout.write("".join(ln + "\n" for ln in pr.stdout.splitlines()
                                 if not ln.startswith("RESULT ")))
        if pr.returncode:
            print(pr.stderr[-4000:], flush=True)
            sys.exit(f"run of {root} failed")
        line = next(ln for ln in pr.stdout.splitlines()
                    if ln.startswith("RESULT "))
        runs.append(json.loads(line[len("RESULT "):]))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"card": smi, "runs": runs}, fh)
    summary = {}
    for r in runs:
        for name, w in r["walls"].items():
            summary.setdefault(name, []).append([round(x, 3) for x in w])
    print(json.dumps({"card": smi, "order": order, "walls_s": summary}))


if __name__ == "__main__":
    main()
