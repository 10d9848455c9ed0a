"""Where the time of one smoke search goes on an NVIDIA GPU.

    python3 scripts/profile_torch_search.py [TRACE_JSON] [--device-rows]

Runs the smoke hmmsearch of ``chip_smoke.py`` (``pyhmmer_tpu_torch``,
``device="cuda"``, with the device rows stage on if ``--device-rows`` is
given) once warm, then once through ``SearchEngine.search`` (what
``hmmsearch`` runs) under ``torch.profiler`` with CPU and CUDA
activities.  Prints the wall time, the engine's stage marks, the
device time summed by kernel, and the device's busy share of the wall
time; writes the Chrome trace to ``TRACE_JSON`` (default
``build/torch_search_trace.json``).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pyhmmer_tpu_torch import SearchEngine, hmmsearch  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402

TRACE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "torch_search_trace.json")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_search: no CUDA device")
    args = [a for a in sys.argv[1:] if a != "--device-rows"]
    device_rows = "--device-rows" in sys.argv[1:]
    queries, _, targets, _ = syn.smoke_workload()
    list(hmmsearch(queries, targets, device="cuda",
                   device_rows=device_rows))
    torch.cuda.synchronize()
    before = smi()
    eng = SearchEngine(queries[0].alphabet, device="cuda",
                       device_rows=device_rows)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        eng.search(queries, targets)
        torch.cuda.synchronize()
        wall = time.time() - t
    after = smi()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    trace = args[0] if args else TRACE
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    print(json.dumps({
        "nvidia_smi_before": before, "nvidia_smi_after": after,
        "device_rows": device_rows,
        "wall_s": wall, "stage_marks": eng.last_timing,
        "device_busy_s": busy_s if rows else "not measured",
        "device_busy_share": busy_s / wall if rows else "not measured",
        "top_device": [{"us": r[0], "count": r[1], "name": r[2][:80]}
                       for r in rows[:12]]}, indent=1))


if __name__ == "__main__":
    main()
