"""Time the wide route's kernels (models over 4,096 slots) of checkouts
of the PyTorch port in turns.

    python3 scripts/bench_torch_wide.py ROOT_A [ROOT_B ...] [--out FILE]
        [--plain] [--reps N] [--kernels msv,fwd,vit]

Each root is a checkout holding ``pyhmmer_tpu_torch`` (for example this
tree and a ``git archive`` of its parent, unpacked into a directory that
``.gitignore`` lists).  The roots run in turns A, B, ..., ..., B, A,
each in a process of its own that imports that root's package, builds
its kernels and packs its own tables.  A run times, with CUDA events on
one card:

* ``fwd_cuda.fwd_scores`` and ``vit_cuda.vit_scores`` (the wrappers,
  pair list included) at seeded shapes (:data:`SHAPES`): the widths of
  ``chip_smoke.py``'s wide phase (a sampled M 4,200 model, Mk 4,608; M
  9,000, Mk 9,216; M 35,000, Mk 35,328) against a P = 1 launch of about
  a hundred lanes up to 512 residues (a few for the widest), two more
  widths on the shared-memory tier (Mk 12,288 and 15,360), and nhmmer's
  largest gate launch (a DNA model of M 5,000, Mk 5,120, against 4
  subwindows of 18,632 residues);
* ``msv_cuda.msv_scores`` (``bias_kernel`` and ``msv_cta_kernel``) at
  ``chip_smoke.py``'s wide MSV shapes (:data:`MSV_SHAPES`): sampled
  models of M 9,000 and 4,200 against the 3,396 lanes of the smoke
  workload's 512 bucket, M 35,000 against its first 8, nhmmer's gate,
  the 9,000-residue query's calibration launch (200 random lanes of 200
  residues), and the widest model (M 100,000) against 8 random lanes of
  50-512; besides the call's ms, each kernel's device ms
  (``torch.profiler``).

Per shape it reports the pairs, the DP cells (the sum of M x L over the
pairs), ms per call, the scores (MSV: ``dx``, ``ovf``), and with
``--plain`` the largest difference from the plain version on the card
(MSV: whether ``ovf`` and ``dx`` on unflagged pairs equal
``msv_plain``'s); the first run of each root also prints the ``-Xptxas
-v`` registers, shared memory and spills of the ``*_cta_kernel``
instances.  The last line summarises each run's ms per shape, the
largest Forward and Viterbi score difference between the roots and
whether their MSV ``ovf`` and unflagged ``dx`` agree.  The card's name
and power limit head the output; the JSON record of every run goes to
``--out``.
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
#: the MSV launches, as :data:`SHAPES` but that the lanes ``"bucket"``
#: are the 3,396 of the smoke workload's 512 bucket and ``"few"`` its
#: first 8 (``chip_smoke.py``'s wide phase)
MSV_SHAPES = (("M9000", 9000, False, "bucket", None),
              ("M4200", 4200, False, "bucket", None),
              ("M35000", 35000, False, "few", None),
              ("nhmmer", 5000, True, 4, 18632),
              ("calib9000", 9000, False, 200, 200),
              ("M100000", 100_000, False, 8, None))
#: lanes of the smoke's 512 bucket in ``chip_smoke.py``'s Mk 35,328 case
FEW_LANES = 8
#: calls under the profiler a shape
PROFILED = 3


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


def device_ms(call, names=None, reps=PROFILED):
    """The device ms a ``call`` of each kernel whose name holds one of
    ``names`` (None: of every kernel it ran), by name: the mean over the
    launches ``torch.profiler`` recorded of ``reps`` calls; profiled
    again, up to three times, where it recorded none of them.
    ``chip_smoke.py`` uses it too."""
    import torch
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / 1e3 / max(1, e.count)
               for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0.0) > 0
               and (names is None or any(n in e.key for n in names))}
        if out:
            return out
    return out


def smoke_bucket():
    """(codes, lengths) of the smoke workload's 512 bucket, the lanes of
    ``chip_smoke.py``'s wide parity."""
    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch import engine as E
    targets = syn.smoke_workload()[2]
    _, codes, lengths, _ = next(b for b in E._Buckets(targets, "cpu").buckets
                                if b[3].Lmax == 512)
    return codes, lengths


def shape_case(label, M, dna, n, L, bucket=None):
    """(profile batch on the card, target bucket on the card, lengths) of
    a seeded shape: a sampled model of length ``M`` and ``n`` random
    lanes of ``L`` residues (None: 50-512), or for ``n`` ``"bucket"`` or
    ``"few"`` the lanes of :func:`smoke_bucket` (``bucket``)."""
    import numpy as np
    from pyhmmer_tpu_torch import _synthetic as syn
    from pyhmmer_tpu_torch.ops import batch as B
    from pyhmmer_tpu_torch.plan7 import Background, Profile
    h = (syn.sample_dna_models((M,), seed=M) if dna
         else syn.sample_models((M,), seed=M))[0]
    aa = h.alphabet
    prof = Profile(M, aa).configure(h, Background(aa), 400, multihit=True)
    pb = B.ProfileBatch([prof], Mp=B.round_up(M, 32)).to("cuda")
    if isinstance(n, str):
        codes, lens = bucket
        if n == "few":
            codes, lens = codes[:FEW_LANES], lens[:FEW_LANES]
    else:
        rng = np.random.default_rng(M + 1)
        lens = (np.full(n, L) if L else rng.integers(50, 513, size=n))
        codes = np.full((n, int(lens.max())), aa.Kp - 1, dtype=np.uint8)
        for i, ln in enumerate(lens):
            codes[i, :ln] = rng.integers(0, aa.K, size=ln)
    return pb, B.SeqDevice(codes, lens, aa.nonresidue_code, "cuda"), lens


def msv_run(plain, reps):
    """The MSV shapes of one run (:data:`MSV_SHAPES`)."""
    import torch
    from pyhmmer_tpu_torch.ops import msv_cuda
    out = []
    bucket = smoke_bucket()
    for label, M, dna, n, L in MSV_SHAPES:
        pb, dev, lens = shape_case(label, M, dna, n, L, bucket)
        args = (dev.codes, dev.lens, pb.msv_w16, pb.msv_scal, pb.msv_odds,
                dev.tjb, dev.p1)
        dx, ovf, _ = msv_cuda.msv_scores(*args)
        torch.cuda.synchronize()
        rec = {"kernel": "msv", "shape": label, "M": M, "Mk": pb.Mk,
               "pairs": dev.B, "Lmax": dev.Lmax,
               "cells": float(M) * float(lens.sum()),
               "msv_ms": cuda_ms(lambda: msv_cuda.msv_scores(*args), reps),
               "msv_device_ms": device_ms(
                   lambda: msv_cuda.msv_scores(*args)),
               "msv_dx": dx[0].tolist(), "msv_ovf": ovf[0].tolist()}
        if plain:
            dx2, ovf2, _ = msv_cuda.msv_plain(*args)
            clean = ovf2 == 0
            rec["msv_plain_match"] = bool(
                torch.equal(ovf, ovf2) and torch.equal(dx[clean],
                                                       dx2[clean]))
        out.append(rec)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("msv_dx", "msv_ovf")}), flush=True)
    return out


def one_run(root, plain, reps, ptxas, kernels):
    """One checkout's run: its package first on ``sys.path``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from pyhmmer_tpu_torch.ops import _build, fwd_cuda, vit_cuda
    t = time.time()
    _build.lib()
    rec = {"root": root, "build_s": time.time() - t, "shapes": []}
    if ptxas:
        rec["ptxas"] = [ln.strip() for ln in _build.ptxas_report().splitlines()
                        if "cta_kernel" in ln or "registers" in ln
                        or "spill" in ln]
    if "msv" in kernels:
        rec["msv_shapes"] = msv_run(plain, reps)
    filters = [k for k in ("fwd", "vit") if k in kernels]
    for label, M, dna, n, L in SHAPES if filters else ():
        pb, dev, lens = shape_case(label, M, dna, n, L)
        rows = torch.arange(n, device="cuda")
        need = torch.ones((1, n), dtype=torch.bool, device="cuda")
        cells = float(M) * float(lens.sum())
        out = {"shape": label, "M": M, "Mk": pb.Mk, "pairs": n,
               "Lmax": dev.Lmax, "cells": cells}
        for name, fn, pl in (("fwd", fwd_cuda.fwd_scores,
                              fwd_cuda.fwd_plain),
                             ("vit", vit_cuda.vit_scores,
                              vit_cuda.vit_plain)):
            if name not in filters:
                continue
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
    ap.add_argument("--kernels", default="msv,fwd,vit")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        rec = one_run(a.one, a.plain, a.reps, a.ptxas, a.kernels)
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
               root, "--reps", str(a.reps), "--kernels", a.kernels]
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
    filters = [k for k in ("fwd", "vit") if k in a.kernels]
    summary = {}
    for r in runs:
        for s in r.get("msv_shapes", []):
            summary.setdefault(f"{s['shape']} msv", []).append(
                round(s["msv_ms"], 4))
        for s in r["shapes"]:
            for k in filters:
                summary.setdefault(f"{s['shape']} {k}", []).append(
                    round(s[k + "_ms"], 4))
    diff, msv_agree = 0.0, True
    for r in runs[1:]:
        for s0, s in zip(runs[0]["shapes"], r["shapes"]):
            for k in filters:
                diff = max(diff, max(abs(x - y) for x, y in zip(
                    s0[k + "_scores"], s[k + "_scores"])))
        for s0, s in zip(runs[0].get("msv_shapes", []),
                         r.get("msv_shapes", [])):
            msv_agree &= s0["msv_ovf"] == s["msv_ovf"] and all(
                x == y for x, y, f in zip(s0["msv_dx"], s["msv_dx"],
                                          s0["msv_ovf"]) if not f)
    print(json.dumps({"card": smi, "order": order, "ms": summary,
                      "max_score_diff_between_runs": diff,
                      "msv_ovf_and_unflagged_dx_agree": msv_agree}))


if __name__ == "__main__":
    main()
