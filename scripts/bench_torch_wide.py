"""Time the wide route's Forward and Viterbi kernels (models over 4,096
slots) of checkouts of the PyTorch port in turns.

    python3 scripts/bench_torch_wide.py ROOT_A [ROOT_B ...] [--out FILE]
        [--plain] [--reps N]

Each root is a checkout holding ``pyhmmer_tpu_torch`` (for example this
tree and a ``git archive`` of its parent, unpacked into a directory that
``.gitignore`` lists).  The roots run in turns A, B, ..., ..., B, A,
each in a process of its own that imports that root's package, builds
its kernels and packs its own tables.  A run times, with CUDA events on
one card, ``fwd_cuda.fwd_scores`` and ``vit_cuda.vit_scores`` (the
wrappers, pair list included) at seeded shapes (:data:`SHAPES`): the
widths of ``chip_smoke.py``'s wide phase (a sampled M 4,200 model, Mk
4,608; M 9,000, Mk 9,216; M 35,000, Mk 35,328) against a P = 1 launch
of about a hundred lanes up to 512 residues (a few for the widest),
two more widths on the shared-memory tier (Mk 12,288 and 15,360), and nhmmer's largest gate launch (a DNA
model of M 5,000, Mk 5,120, against 4 subwindows of 18,632 residues).
Per shape it reports the pairs, the DP cells (the sum of M x L over the
pairs), ms per call, the scores, and with ``--plain`` the largest
difference from the plain version (``fwd_plain``, ``vit_plain``) on the
card; the first run also prints the ``-Xptxas -v`` registers, shared
memory and spills of the ``*_cta_kernel`` instances.  The last line
summarises each run's ms per shape and the largest score difference
between the roots.  The card's name and power limit head the output;
the JSON record of every run goes to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

#: (label, model length, DNA model, lanes, lane length or None for the
#: 50-512 residues of the smoke's 512 bucket)
SHAPES = (("M4200", 4200, False, 104, None),
          ("M9000", 9000, False, 113, None),
          ("M12000", 12000, False, 104, None),
          ("M15000", 15000, False, 8, None),
          ("M35000", 35000, False, 5, None),
          ("nhmmer", 5000, True, 4, 18632))


def cuda_ms(fn, reps):
    import torch
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


def one_run(root, plain, reps, ptxas):
    """One checkout's run: its package first on ``sys.path``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch.ops import _build, fwd_cuda, vit_cuda
    from pyhmmer_tpu_torch.ops import batch as B
    from pyhmmer_tpu_torch.plan7 import Background, Profile
    t = time.time()
    _build.lib()
    rec = {"root": root, "build_s": time.time() - t, "shapes": []}
    if ptxas:
        rec["ptxas"] = [ln.strip() for ln in _build.ptxas_report().splitlines()
                        if "cta_kernel" in ln or "registers" in ln
                        or "spill" in ln]
    for label, M, dna, n, L in SHAPES:
        h = (syn.sample_dna_models((M,), seed=M) if dna
             else syn.sample_models((M,), seed=M))[0]
        aa = h.alphabet
        prof = Profile(M, aa).configure(h, Background(aa), 400,
                                        multihit=True)
        pb = B.ProfileBatch([prof], Mp=B.round_up(M, 32)).to("cuda")
        rng = np.random.default_rng(M + 1)
        lens = (np.full(n, L) if L else rng.integers(50, 513, size=n))
        Lmax = int(lens.max())
        codes = np.full((n, Lmax), aa.Kp - 1, dtype=np.uint8)
        for i, ln in enumerate(lens):
            codes[i, :ln] = rng.integers(0, aa.K, size=ln)
        dev = B.SeqDevice(codes, lens, aa.nonresidue_code, "cuda")
        rows = torch.arange(n, device="cuda")
        need = torch.ones((1, n), dtype=torch.bool, device="cuda")
        cells = float(M) * float(lens.sum())
        out = {"shape": label, "M": M, "Mk": pb.Mk, "pairs": n,
               "Lmax": Lmax, "cells": cells}
        for name, fn, pl in (("fwd", fwd_cuda.fwd_scores,
                              fwd_cuda.fwd_plain),
                             ("vit", vit_cuda.vit_scores,
                              vit_cuda.vit_plain)):
            args = (dev.codes, dev.lens, dev.lm, getattr(pb, name + "_emis"),
                    getattr(pb, name + "_trans"), rows, need)
            k = fn(*args)
            torch.cuda.synchronize()
            out[name + "_ms"] = cuda_ms(lambda: fn(*args), reps)
            out[name + "_scores"] = k[0].tolist()
            if plain and not dna:
                p = pl(*args)
                out[name + "_plain_err"] = (k - p).abs().max().item()
        rec["shapes"].append(out)
        print(json.dumps({k: v for k, v in out.items()
                          if not k.endswith("_scores")}), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        rec = one_run(a.one, a.plain, a.reps, a.ptxas)
        print("RESULT " + json.dumps(rec), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    order = list(a.roots) + list(reversed(a.roots))
    runs = []
    for i, root in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), root, "--one",
               root, "--reps", str(a.reps)]
        if a.plain:
            cmd.append("--plain")
        if i < len(a.roots):
            cmd.append("--ptxas")
        pr = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=1800)
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
        for s in r["shapes"]:
            for k in ("fwd", "vit"):
                summary.setdefault(f"{s['shape']} {k}", []).append(
                    round(s[k + "_ms"], 4))
    diff = 0.0
    for r in runs[1:]:
        for s0, s in zip(runs[0]["shapes"], r["shapes"]):
            for k in ("fwd", "vit"):
                diff = max(diff, max(abs(x - y) for x, y in zip(
                    s0[k + "_scores"], s[k + "_scores"])))
    print(json.dumps({"card": smi, "order": order, "ms": summary,
                      "max_score_diff_between_runs": diff}))


if __name__ == "__main__":
    main()
