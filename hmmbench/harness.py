"""One run of one cell: set-up, the measured window, the traced
timeline, the metrics, and the check that decides ``correct``.

Everything that belongs to one configuration, one traffic mix or one
metric is found by name: ``BENCHMARK.json`` names the cell's
configuration file and its traffic mix (``hmmbench/traffic/<mix>.json``),
the metrics' readers are ``hmmbench/metrics/<metric>.py`` (each with a
``read(run)`` that returns a number or None), and the limits of the
cell's check are ``hmmbench/limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import time
from typing import List, Optional

from . import check, trace
from .apps import APPS

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "pyhmmer_tpu")


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.bench = json.load(fh)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json("traffic", name)

    def limits(self, cell: str) -> dict:
        return load_json("limits", cell)

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as fh:
        return json.load(fh)


def reader(name: str):
    """The ``read`` function of ``hmmbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "hmmbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def power_query():
    """Start ``nvidia-smi``'s query of the cards' names and power limits
    (read by :func:`card_info`; None where there is no nvidia-smi)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def card_info(torch, query) -> dict:
    """Name and count of the cards, the power limit ``query`` read, and
    the host's cores."""
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "host_cores": os.cpu_count(), "power_limit": "not read"}
    if query is not None:
        try:
            out, _ = query.communicate(timeout=60)
            info["power_limit"] = out.strip().splitlines()[0]
        except (subprocess.SubprocessError, IndexError):
            query.kill()
            query.wait()
    return info


class Run:
    """What a metric's reader reads: the calls' records, their summed
    walls, the traced timeline (None untraced) and the set-up time."""

    def __init__(self, records: List[dict], setup_s: float,
                 timeline: Optional[trace.Timeline], peak_bytes: int):
        self.records = records
        self.setup_s = setup_s
        self.timeline = timeline
        self.peak_bytes = peak_bytes
        self.walls_s = sum(r["wall_s"] for r in records)

    def timing_sum(self, end: str, start: Optional[str] = None) -> float:
        """Sum over calls of the engine mark ``end`` (minus ``start``)."""
        tot = 0.0
        for r in self.records:
            t = r["timing"]
            if end in t and (start is None or start in t):
                tot += t[end] - (t[start] if start else 0.0)
        return tot


#: the engine's stage marks (``SearchEngine.last_timing``), in order,
#: and the stage each one ends
STAGES = (("s1_enqueued", "s1_enqueue"), ("s1_fetched", "s1_fetch"),
          ("s1_host_done", "s1_host"), ("s2_fetched", "s2_fetch"),
          ("s2_done", "s2_host"), ("s3_fetched", "s3_fetch"),
          ("s3_host_done", "s3_host"), ("rows_done", "rows"),
          ("collect_done", "postprocess"))


def stage_spans(records: List[dict]) -> List[tuple]:
    """``(stage, start, end)`` on the host clock for every call: engine
    set-up, each stage of the cascade, and what the call does after the
    engine returns."""
    out = []
    for r in records:
        t, t0 = r["timing"], r["start"]
        t_stages = t0 + t.get("setup_s", 0.0)
        out.append(("engine_setup", t0, t_stages))
        prev = t_stages
        for mark, name in STAGES:
            if mark in t:
                end = t_stages + t[mark]
                out.append((name, prev, end))
                prev = end
        out.append(("after_search", prev, r["start"] + r["wall_s"]))
    return out


def window_calls(seconds: float, traffic: dict) -> int:
    """The calls of a window: as many as ``seconds`` holds at the mix's
    nominal call time ``call_s``.  The work of a run is fixed by its
    length and the seed, whatever the program's speed, so no run's rate
    hangs on how many of the calls, which differ in their work, it
    reaches."""
    return max(1, math.ceil(seconds / float(traffic["call_s"])))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, root: str, t_start: float, torch) -> dict:
    """Run ``workload`` once; returns the result line's object and a
    summary of the run (calls, walls, set-up parts, the check's keys)."""
    spec = Spec(root)
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_enter = time.time()
    app = APPS[cfg["app"]](cfg, traffic, seed, device)
    t_app = time.time()
    app.call(app.inputs("warm"))
    sync()
    t_warm = time.time()
    setup_s = t_warm - t_start

    records: List[dict] = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cpu0 = os.times()
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    try:
        for c in range(window_calls(seconds, traffic)):
            inp = app.inputs(c)
            if inp is None:
                break
            sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"hmmbench.call.{c}"):
                out = app.call(inp)
                sync()
            wall = time.perf_counter() - t0
            rec = app.keep(inp, out)
            rec.update(start=t0, wall_s=wall)
            records.append(rec)
            del out
    finally:
        if prof is not None:
            prof.stop()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    cpu1 = os.times()

    timeline = None
    if prof is not None:
        events = trace.read_chrome_trace(prof)
        del prof
        timeline = trace.Timeline.from_chrome_trace(
            events, {k: r["start"] for k, r in enumerate(records)},
            [(r["start"], r["start"] + r["wall_s"]) for r in records])
        del events
    run = Run(records, setup_s, timeline, peak)
    metrics = {}
    for m in spec.metrics(workload, traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, once the program's state is gone
    app.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.time()
    order, first = app.sample(int(traffic["check"]))
    keys, prog, ref, numbers = check.grow(
        order, first, int(traffic["check"]), limits,
        lambda ks: ({k: app.answers[k] for k in ks},
                    app.reference(ks, device)))
    # a query the program never answered fails the run
    ok = (check.judge(numbers, limits) and check.enough(numbers, limits)
          and app.missing == 0)

    failed = sum(1 for k in keys if not check.judge(
        check.compare({k: prog[k]}, {k: ref[k]}), limits))
    result = {"correct": bool(ok),
              "attempted": len(app.answers) + app.missing,
              "failed": int(failed) + app.missing,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if timeline is not None:
        result["device"]["busy_s"] = timeline.busy_s()
        result["device"]["window_s"] = run.walls_s
        result["breakdown"] = {
            "device_ops": timeline.top_ops(10),
            "idle_gaps": timeline.idle_by_stage(stage_spans(records), 10)}
    result["compared"] = {k: int(numbers[k]) for k in check.COUNTS}
    result["checked"] = check.report(numbers, limits)
    summary = {"calls": len(records), "walls_s": run.walls_s,
               "work": sum(r["work"] for r in records),
               "setup_parts_s": {"imports": t_enter - t_start,
                                 "inputs": t_app - t_enter,
                                 "warm_call": t_warm - t_app},
               "call_walls_s": [r["wall_s"] for r in records],
               "window_cpu_s": (cpu1.user + cpu1.system)
               - (cpu0.user + cpu0.system),
               "call_timing": [r["timing"] for r in records],
               "checked_keys": [str(k) for k in keys],
               "check_s": time.time() - t_check}
    return result, summary
