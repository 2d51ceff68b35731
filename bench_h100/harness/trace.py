"""Reduce a `torch.profiler` trace of the window to what the metric
readers and the result line need: device busy time (the union of every
device operation's interval), device time by operation name, and the idle
gaps, each labelled with the innermost benchmark span open at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Tuple

from harness.spans import PREFIX


@dataclass
class DeviceTrace:
    window_s: float  # the "bench:window" span in the trace's own clock
    busy_s: float  # union of device operation intervals inside it
    ops: Dict[str, Tuple[int, float]]  # name -> (count, device seconds)
    idle_by_span: Dict[str, float] = field(default_factory=dict)
    busy_by_span: Dict[str, float] = field(default_factory=dict)

    def op_time(self, substring: str) -> Tuple[int, float]:
        n, t = 0, 0.0
        for name, (c, s) in self.ops.items():
            if substring in name:
                n, t = n + c, t + s
        return n, t


def _raw_events(prof):
    """[(name, is_device, start_ns, end_ns)] of the profile."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() != DeviceType.CPU, int(e.start_ns()),
             int(e.end_ns()))
            for e in prof.profiler.kineto_results.events()]


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof) -> DeviceTrace:
    events = _raw_events(prof)
    win = [(s, e) for n, dev, s, e in events
           if not dev and n == PREFIX + "window"]
    if not win:
        raise RuntimeError("the trace holds no bench:window span")
    w0, w1 = win[0]
    # Device-side copies of the benchmark's own annotations are no work.
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events
           if d and e > w0 and s < w1 and not n.startswith(PREFIX)]
    ops: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for n, s, e in dev:
        ops[n][0] += 1
        ops[n][1] += (e - s) * 1e-9
    busy = _merge([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    spans = sorted((s, e, n[len(PREFIX):]) for n, d, s, e in events
                   if not d and n.startswith(PREFIX) and n != PREFIX + "window")
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    starts = [s for s, _, _ in spans]

    def label(t):
        # The innermost span open at t: the latest-starting one that
        # covers it (spans nest or are disjoint).
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[i][1] >= t:
                return spans[i][2]
        return "window"

    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        idle[label(0.5 * (g0 + g1))] += (g1 - g0) * 1e-9
    # Device work by the span open when it started (the host has queued it
    # by then).
    busy: Dict[str, float] = defaultdict(float)
    for _, s, e in dev:
        busy[label(s)] += (e - s) * 1e-9
    return DeviceTrace((w1 - w0) * 1e-9, busy_s,
                       {k: (v[0], v[1]) for k, v in ops.items()},
                       dict(idle), dict(busy))
