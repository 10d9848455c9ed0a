"""Helpers of the benchmark's CPU tests: a copy of the benchmark cut to
a size the CPU runs in seconds, and a run of it."""

import contextlib
import json
import os
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
os.environ.setdefault("USE_FLAX", "0")


def make_tiny(dst: pathlib.Path) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` (with the cells of ``hmmbench/held``
    added) and of ``hmmbench/`` under ``dst`` whose databases hold 40
    (hmmsearch) and 24 (hmmscan) models, proteomes 120 proteins with a
    planted domain per model, calls of 8 models or sequences, and checks
    of 6 answers that have to cover one unclustered hit."""
    shutil.copytree(ROOT / "hmmbench", dst / "hmmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the cells held out of BENCHMARK.json, entries and all
    for p in sorted((ROOT / "hmmbench" / "held").glob("*.json")):
        for group, entries in json.loads(p.read_text()).items():
            bench[group] += entries
    for c in bench["configs"]:
        p = dst / c["file"]
        cfg = json.loads(p.read_text())
        cfg["models"] = 40 if cfg["app"] == "hmmsearch" else 24
        cfg["proteins"] = 120
        cfg["plants"]["per_model"] = 1.0
        p.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        p = dst / "hmmbench" / "traffic" / (w["traffic"] + ".json")
        t = json.loads(p.read_text())
        t["per_call"], t["check"] = 8, 6
        p.write_text(json.dumps(t))
        p = dst / "hmmbench" / "limits" / (w["name"] + ".json")
        lim = json.loads(p.read_text())
        lim["min_unclustered"] = 1
        p.write_text(json.dumps(lim))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run_tiny(root, workload, seed=11, seconds=0.5, traced=False):
    """``harness.run_cell`` of the copy at ``root`` on the CPU (the look
    for a card is run.py's, and skipped here)."""
    import time
    import torch
    with in_copy(root):
        from hmmbench import harness
        return harness.run_cell(workload, seed, seconds, traced, "cpu",
                                str(root), time.time(), torch)


def in_copy(root):
    """Import ``hmmbench`` from the copy at ``root`` (a context)."""
    @contextlib.contextmanager
    def ctx():
        saved = {k: v for k, v in sys.modules.items()
                 if k == "hmmbench" or k.startswith("hmmbench.")}
        for k in saved:
            del sys.modules[k]
        sys.path.insert(0, str(root))
        try:
            yield
        finally:
            sys.path.remove(str(root))
            for k in [k for k in sys.modules
                      if k == "hmmbench" or k.startswith("hmmbench.")]:
                del sys.modules[k]
            sys.modules.update(saved)
    return ctx()

