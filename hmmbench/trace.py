"""The traced run's device timeline: kernel intervals from the
profiler's trace, their union, and the breakdown of busy and idle time.

Times are seconds on the host's ``perf_counter`` clock: each timed call
is wrapped in a ``record_function("hmmbench.call.<k>")`` span, and the
span's start in the trace against the call's start on the host gives
the offset that maps the trace's clock onto the host's.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]

#: trace categories of work that occupies the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = re.compile(r"^hmmbench\.call\.(\d+)$")


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return float(sum(b - a for a, b in intervals))


def clip(intervals: Sequence[Interval], windows: Sequence[Interval]
         ) -> List[Interval]:
    """The parts of disjoint sorted ``intervals`` inside disjoint sorted
    ``windows``."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(windows) and windows[j][1] <= a:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < b:
            lo, hi = max(a, windows[k][0]), min(b, windows[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def gaps(busy: Sequence[Interval], windows: Sequence[Interval]
         ) -> List[Interval]:
    """The idle parts of ``windows`` (sorted, disjoint) that ``busy``
    (sorted, disjoint) leaves."""
    out = []
    for lo, hi in windows:
        t = lo
        for a, b in clip(busy, [(lo, hi)]):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
    return out


class Timeline:
    """Device operations of a traced window, on the host's clock.

    ``ops`` is a list of ``(name, start, end)``; ``calls`` the
    ``(start, end)`` of each timed call on the host."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 calls: List[Interval]):
        self.ops = ops
        self.calls = calls

    @classmethod
    def from_chrome_trace(cls, events: List[dict],
                          call_starts: Dict[int, float],
                          calls: List[Interval]) -> "Timeline":
        """Device operations of a chrome trace (``ts``, ``dur`` in us),
        mapped to the host clock by the ``hmmbench.call.<k>`` spans:
        ``call_starts[k]`` is call ``k``'s start on the host."""
        offs = []
        for e in events:
            m = CALL_SPAN.match(str(e.get("name", "")))
            if m and e.get("ph") == "X" and int(m.group(1)) in call_starts \
                    and e.get("cat") == "user_annotation":
                offs.append(call_starts[int(m.group(1))]
                            - float(e["ts"]) * 1e-6)
        if not offs:
            raise RuntimeError("the trace holds no hmmbench.call span")
        offs.sort()
        off = offs[len(offs) // 2]
        ops = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                a = float(e["ts"]) * 1e-6 + off
                ops.append((str(e.get("name", "")), a,
                            a + float(e.get("dur", 0.0)) * 1e-6))
        return cls(ops, calls)

    def busy(self, pattern: str = "") -> List[Interval]:
        """Union of the intervals of operations whose name matches
        ``pattern`` (a regular expression; all with ""), inside the
        calls."""
        rx = re.compile(pattern) if pattern else None
        iv = union((a, b) for n, a, b in self.ops
                   if rx is None or rx.search(n))
        return clip(iv, union(self.calls))

    def busy_s(self, pattern: str = "") -> float:
        return length(self.busy(pattern))

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` operation names with the most device seconds (their
        intervals' sum inside the calls)."""
        win = union(self.calls)
        tot: Dict[str, float] = {}
        for name, a, b in self.ops:
            s = length(clip([(a, b)], win))
            if s > 0:
                key = short_name(name)
                tot[key] = tot.get(key, 0.0) + s
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_stage(self, stages: List[Tuple[str, float, float]],
                      n: int = 10) -> List[List]:
        """The device's idle seconds inside the calls, summed by the
        stage (``(label, start, end)`` on the host clock) each idle gap's
        midpoint falls in; the ``n`` largest."""
        stages = sorted(stages, key=lambda s: s[1])
        tot: Dict[str, float] = {}
        for a, b in gaps(self.busy(), union(self.calls)):
            mid = 0.5 * (a + b)
            label = "outside any stage"
            for name, lo, hi in stages:
                if lo <= mid < hi:
                    label = name
                    break
            tot[label] = tot.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list, its
    template arguments kept (``void msv_kernel<4>(...)`` ->
    ``msv_kernel<4>``)."""
    m = re.match(r"^(?:void\s+)?([\w:]+(?:<[^()]*>)?)", name)
    return m.group(1) if m else name[:80]


def read_chrome_trace(prof) -> List[dict]:
    """Export ``prof``'s chrome trace to a file in the temporary
    directory (``TMPDIR``), read its events and delete the file."""
    fd, path = tempfile.mkstemp(prefix="hmmbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.remove(path)
    return doc["traceEvents"] if isinstance(doc, dict) else doc
