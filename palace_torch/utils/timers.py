"""Hierarchical wall-clock timing and the memory snapshot for the run
metadata (counterpart of palace_tpu/utils/timers.py).

The timer blocks are copied from the JAX package (reference:
palace/utils/timer.hpp:29-55): RAII-style `block(category)` context managers
over the reference's category set, nesting credits only the innermost block,
per-category memory growth is tracked alongside time (timer.hpp:99), and
`report()` returns the table used for the palace.json metadata
(basesolver.cpp:322-345).  `memory_stats` reads device memory from
PyTorch's CUDA allocator.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch

CATEGORIES = [
    "Initialization",
    "Mesh preprocessing",
    "Operator construction",
    "  Wave ports",
    "Linear solve",
    "  Setup",
    "  Preconditioner",
    "  Coarse solve",
    "Time stepping",
    "Eigenvalue solve",
    "PROM construction",
    "PROM solve",
    "Estimator construction",
    "Estimator solve",
    "Adaptation",
    "Postprocessing",
    "  Far fields",
    "  Paraview",
    "  Grid functions",
    "Disk IO",
    "Total",
]


def _rss_mb() -> float:
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except Exception:
        return 0.0


def memory_stats() -> Dict[str, float]:
    """Host resident/peak memory plus, once CUDA is initialized, device
    memory in use, peak (torch.cuda.max_memory_allocated) and capacity."""
    out: Dict[str, float] = {"HostCurrentMB": round(_rss_mb(), 3)}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    out["HostPeakMB"] = round(int(line.split()[1]) / 1e3, 3)
                    break
    except OSError:
        pass
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["DeviceInUseMB"] = round(torch.cuda.memory_allocated() / 1e6, 3)
        out["DevicePeakMB"] = round(torch.cuda.max_memory_allocated() / 1e6, 3)
        out["DeviceLimitMB"] = round(
            torch.cuda.get_device_properties(0).total_memory / 1e6, 3)
    return out


class Timer:
    def __init__(self):
        self.times: Dict[str, float] = {}
        self.mem: Dict[str, float] = {}
        self._stack: List[str] = []
        self._t0 = time.monotonic()
        self._last = self._t0
        self._last_mem = _rss_mb()

    def _credit(self):
        now = time.monotonic()
        m = _rss_mb()
        if self._stack:
            cat = self._stack[-1]
            self.times[cat] = self.times.get(cat, 0.0) + (now - self._last)
            self.mem[cat] = self.mem.get(cat, 0.0) + (m - self._last_mem)
        self._last = now
        self._last_mem = m

    @contextlib.contextmanager
    def block(self, category: str):
        self._credit()
        self._stack.append(category)
        try:
            yield
        finally:
            self._credit()
            self._stack.pop()

    def total(self) -> float:
        return time.monotonic() - self._t0

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for cat in CATEGORIES[:-1]:
            key = cat.strip()
            if cat in self.times:
                out[key] = {
                    "DurationSeconds": round(self.times[cat], 6),
                    "MemoryGrowthMB": round(self.mem.get(cat, 0.0), 3),
                }
        out["Total"] = {"DurationSeconds": round(self.total(), 6)}
        return out


# Global timer for the current solve (reset per palace_torch.run call).
GLOBAL = Timer()


def reset():
    global GLOBAL
    GLOBAL = Timer()
    return GLOBAL


def block(category: str):
    return GLOBAL.block(category)


def seconds(*categories: str) -> float:
    """Seconds the current solve's timer has credited so far to
    `categories` (the drivers difference it around each AMR pass)."""
    return sum(GLOBAL.times.get(c, 0.0) for c in categories)
