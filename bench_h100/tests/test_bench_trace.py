"""The trace reduction on a made-up device trace: busy time is the union
of device intervals, the benchmark's own annotations count as no work,
and idle gaps go to the innermost span open at their middle."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from harness import trace


class _Event:
    def __init__(self, name, device, s, e):
        self._v = (name, device, s, e)

    def name(self):
        return self._v[0]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]


def _prof(events):
    ev = [_Event(*e) for e in events]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))


def test_reduce():
    ms = 1_000_000
    t = trace.reduce(_prof([
        ("bench:window", False, 0, 100 * ms),
        ("bench:request", False, 0, 100 * ms),
        ("bench:krylov", False, 10 * ms, 50 * ms),
        ("bench:krylov", True, 10 * ms, 50 * ms),  # device-side annotation
        ("kernel_a", True, 12 * ms, 20 * ms),
        ("kernel_b", True, 18 * ms, 30 * ms),  # overlaps kernel_a
        ("kernel_a", True, 60 * ms, 70 * ms),
        ("Memcpy HtoD", True, 95 * ms, 110 * ms),  # clipped at the window
    ]))
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.018 + 0.010 + 0.005)
    assert t.ops["kernel_a"] == (2, pytest.approx(0.018))
    assert "bench:krylov" not in t.ops
    assert t.op_time("kernel") == (3, pytest.approx(0.030))
    # Gaps [0, 12], [30, 60] and [70, 95] ms, by the span open at each
    # one's middle.
    assert t.idle_by_span["krylov"] == pytest.approx(0.030)
    assert t.idle_by_span["request"] == pytest.approx(0.012 + 0.025)
    assert t.busy_by_span == {"krylov": pytest.approx(0.020),
                              "request": pytest.approx(0.015)}
