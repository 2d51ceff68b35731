"""Host-clock spans around the benchmark's calls into each layer.

`with spans("krylov", n=8):` records (name, start, end, n) on the host
clock; in a traced run it also opens a `torch.profiler.record_function`
named "bench:<name>", so the device trace can say which span was open
during an idle gap.  The spans are kept in memory.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "bench:"


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records: List[Tuple[str, float, float, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str, n: int = 1):
        ctx = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            ctx = record_function(PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter(), n))

    def totals(self, since: float = float("-inf"),
               until: float = float("inf")) -> Dict[str, Tuple[float, int]]:
        """{name: (seconds, count)} over the spans that start in
        [since, until)."""
        out: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        for name, t0, t1, n in self.records:
            if since <= t0 < until:
                out[name][0] += t1 - t0
                out[name][1] += n
        return {k: (v[0], v[1]) for k, v in out.items()}
