"""The engine's spans and counters (``SearchEngine.last_timing``) on the
CPU: every key present, the spans nested in the stages they split, the
pool's seconds within its workers', the native phase timers within the
native calls, HMMER's pipeline statistics summed over the queries, and
the spans as ``engine.*`` ranges in the profiler's trace, which leaves
the hits as they were."""

import collections
import json
import os
import tempfile

import pytest
import torch

from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.engine import SearchEngine
from pyhmmer_tpu_torch.ops import native

torch.set_num_threads(1)

#: the spans of a search, as ``engine.<name>`` ranges and ``<name>_s``
SPANS = ("setup", "setup.pack", "setup.profiles", "s1_host",
         "s1.bias_wait", "s2_host", "s3_host", "rows", "collect")
COUNTERS = ("submit_s", "pool_jobs", "pool_native_s", "pool_native_cpu_s",
            "pool_py_s", "pool_py_wait_s", "pool_worker_s",
            "n_seqs_searched", "n_past_msv", "n_past_bias", "n_past_vit",
            "n_past_fwd")
FUNNEL = ("n_past_msv", "n_past_bias", "n_past_vit", "n_past_fwd")
#: clock slack of a comparison, seconds
SLACK = 1e-3


def hits(results):
    return [[(h.name, h.score, h.bias, h.evalue, h.included,
              [(d.env_from, d.env_to, d.score) for d in h.domains])
             for h in th.hits] for th in results]


@pytest.fixture(scope="module")
def workload():
    models = syn.smoke_models()[:4]
    targets, _ = syn.make_targets(models, 150, seed=21)
    return models, targets


def search(models, targets):
    eng = SearchEngine(models[0].alphabet, device="cpu")
    return eng.search(models, targets), eng.last_timing


@pytest.fixture(scope="module")
def plain(workload):
    assert native.available(), "the native library did not build"
    return search(*workload)


def traced_search(models, targets):
    """A search under the profiler, and the durations of its chrome
    trace's ``engine.*`` ranges summed by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        results, timing = search(models, targets)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.remove(path)
    ranges = collections.defaultdict(float)
    for e in doc["traceEvents"] if isinstance(doc, dict) else doc:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith("engine."):
            ranges[name[len("engine."):]] += float(e["dur"]) * 1e-6
    return results, timing, ranges


def agree(timing, ranges):
    return all(abs(ranges[n] - timing[n + "_s"]) <= SLACK for n in SPANS)


@pytest.fixture(scope="module")
def traced(workload):
    """:func:`traced_search`, run again (twice at most) where the
    process was held up (preempted, or collecting garbage) between a
    span's clock read and its range's timestamp, as on a loaded host."""
    for _ in range(3):
        results, timing, ranges = traced_search(*workload)
        if agree(timing, ranges):
            break
    return results, timing, ranges


@pytest.mark.parametrize("key", [s + "_s" for s in SPANS] + list(COUNTERS))
def test_key_present_and_not_negative(plain, key):
    assert plain[1][key] >= 0


@pytest.mark.parametrize("part, whole", [
    (("setup.pack_s", "setup.profiles_s"), ("setup_s", None)),
    (("s1.bias_wait_s",), ("s1_host_done", "s1_fetched")),
])
def test_spans_within_their_stage(plain, part, whole):
    t = plain[1]
    end, start = whole
    assert sum(t[k] for k in part) <= t[end] - (t[start] if start else 0) \
        + SLACK


def test_pool_seconds_within_its_workers(plain):
    t = plain[1]
    assert t["pool_jobs"] > 0 and t["pool_worker_s"] > 0
    assert t["pool_native_s"] + t["pool_py_s"] + t["pool_py_wait_s"] \
        <= t["pool_worker_s"]
    assert t["pool_native_cpu_s"] <= t["pool_native_s"] + SLACK


def test_native_phases_within_the_native_calls(plain):
    phases = plain[1]["dd_phase_s"]
    assert len(phases) == len(native.PHASE_LABELS) == 8
    assert all(p >= 0 for p in phases)
    assert 0 < sum(phases) <= plain[1]["pool_native_s"] + SLACK


@pytest.mark.parametrize("key", FUNNEL + ("nseqs",))
def test_funnel_sums_the_queries_statistics(plain, key):
    results, t = plain
    want = sum(getattr(th, key) for th in results)
    assert t["n_seqs_searched" if key == "nseqs" else key] == want


def test_without_native_the_pool_counts_nothing(workload, monkeypatch):
    """The switch is read when ``get_lib`` first loads the library, so
    its cached state is reset here (and restored after)."""
    monkeypatch.setenv("PYHMMER_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    models, targets = workload
    results, t = search(models[:2], targets[:60])
    assert not native.available()
    for key in ("pool_jobs", "pool_native_s", "pool_native_cpu_s",
                "pool_py_s", "pool_py_wait_s", "pool_worker_s",
                "s1.bias_wait_s"):
        assert t[key] == 0, key
    assert t["dd_phase_s"] == [0.0] * 8
    assert sum(len(th.reported) for th in results) > 0
    assert t["n_past_fwd"] == sum(th.n_past_fwd for th in results) > 0


@pytest.mark.parametrize("name", SPANS)
def test_spans_are_ranges_in_the_trace(traced, name):
    _, timing, ranges = traced
    assert name in ranges
    assert abs(ranges[name] - timing[name + "_s"]) <= SLACK


def test_the_profiler_leaves_the_hits_as_they_were(plain, traced):
    assert hits(traced[0]) == hits(plain[0])
    assert any(th.hits for th in plain[0])
