"""Run one cell of the benchmark of ``pyhmmer_tpu_torch`` once.

    python3 hmmbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up (imports, the kernels' build or load, the inputs, one
warm call at the cell's shapes) is timed from the start of this script;
then whole calls run back to back, as many as ``--seconds`` holds at the
traffic's nominal call time (``call_s``), so that every run of a length
does the same work.  With ``--trace 1`` the window runs under
``torch.profiler`` and the cell's per-layer metrics are reported instead
of its end-to-end ones.  After the window the plain reference checks a
sample of the answers drawn from the seed.  The last line of standard
output is the result's JSON object; the numbers compared, each beside
its limit, are the last lines of standard error.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from hmmbench import harness

    cell = harness.Spec(ROOT).cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    query = harness.power_query()
    try:
        result, summary = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            "cuda", ROOT, T_START, torch)
    finally:
        card = harness.card_info(torch, query)
    print(json.dumps({"card": card}), flush=True)
    print(json.dumps({"summary": summary}), flush=True)

    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for c in result["checked"]:
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {c['name']} {c['value']!r} limit {rel} "
              f"{c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
