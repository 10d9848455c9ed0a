"""The control of the benchmark's check: the plain reference computed in
bfloat16, put in the program's place.

    python3 hmmbench/control.py --workload <cell> --calls <n> \\
        --seeds <a> <b> <c>

For each seed it makes the cell's inputs as a run does, takes the keys
that ``n`` calls of the cell's window would answer, draws the checked
sample from them as a run does, and compares the reference in bfloat16
(:func:`hmmbench.reference.dp.set_precision`) against the reference in
float64 with the cell's comparison.  Each line of output is one seed's
numbers beside the cell's limits; the last line holds, for each number,
the smallest reading over the seeds (the control's reading, which has to
exceed its limit for at least one number) and whether the seed failed.
The program is never called.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(workload: str, seed: int, calls: int, device, root: str
            ) -> dict:
    """The control's numbers for one seed."""
    from hmmbench import check, harness
    from hmmbench.apps import APPS
    from hmmbench.reference import dp
    spec = harness.Spec(root)
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    app = APPS[cfg["app"]](cfg, traffic, seed, device)
    for c in range(calls):
        inp = app.inputs(c)
        if inp is None:
            break
        for key, size in app.keys(inp):
            app.answers[key] = None
            app.key_size[key] = size
    app.free()
    order, first = app.sample(int(traffic["check"]))
    t0 = time.time()

    def answer(ks):
        try:
            dp.set_precision("bfloat16")
            low = app.reference(ks, device)
        finally:
            dp.set_precision("float64")
        return low, app.reference(ks, device)
    keys, _, _, numbers = check.grow(order, first, int(traffic["check"]),
                                     limits, answer)
    return {"seed": seed, "keys": [str(k) for k in keys],
            "numbers": numbers, "limits": limits,
            "fails": not check.judge(numbers, limits),
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    rows = []
    for seed in args.seeds:
        rows.append(control(args.workload, seed, args.calls, args.device,
                            ROOT))
        print(json.dumps(rows[-1]), flush=True)
    least = {k: min(r["numbers"][k] for r in rows)
             for k in rows[0]["numbers"]}
    print(json.dumps({"control_least": least,
                      "every_seed_fails": all(r["fails"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
