"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries of ``BENCHMARK.json``, with no file of the benchmark
edited, and a run finds them by name."""

import hashlib
import json

from hmmbench.tests.helpers import run_tiny

NEW_METRIC = '''"""Calls the window made."""


def read(run):
    return float(len(run.records))
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "hmmbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_files_dropped_into_a_copy_are_found(tiny_root):
    before = digests(tiny_root)
    hb = tiny_root / "hmmbench"
    cfg = json.loads((hb / "configs/pfam-hmmsearch.json").read_text())
    cfg.update(name="small-hmmsearch", models=24)
    (hb / "configs/small-hmmsearch.json").write_text(json.dumps(cfg))
    (hb / "traffic/slice4.json").write_text(json.dumps(
        {"unit": "models", "per_call": 4, "call_s": 1, "check": 2}))
    (hb / "metrics/calls_made.py").write_text(NEW_METRIC)
    limits = json.loads(
        (hb / "limits/pfam-hmmsearch.oneshot.json").read_text())
    (hb / "limits/small-hmmsearch.slice4.json").write_text(
        json.dumps(limits))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "small-hmmsearch", "source": "a test",
        "file": "hmmbench/configs/small-hmmsearch.json", "reduced": [],
        "why": "a test"})
    cell = "small-hmmsearch.slice4"
    bench["workloads"].append({"name": cell, "config": "small-hmmsearch",
                               "traffic": "slice4", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "search_cmp_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "calls_made", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "application",
        "moves": "search_cmp_per_s", "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, summary = run_tiny(tiny_root, cell, seconds=0.1, traced=True)
    assert result["metrics"]["calls_made"]["value"] == summary["calls"]
    assert result["correct"]
    result, summary = run_tiny(tiny_root, cell, seconds=0.1)
    assert set(result["metrics"]) == {"search_cmp_per_s", "setup_s"}
    assert summary["work"] == 4 * 120 * summary["calls"]

    after = digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
