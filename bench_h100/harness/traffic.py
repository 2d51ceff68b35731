"""The one traffic generator: a closed loop of sweep requests whose
frequencies come from the seed.

A traffic file gives `freqs_per_request` (the block a request solves,
and with it the solver's block width) and the host thread count.  The
band is cut into `STRATA` equal sub-bands; the frequencies of the whole
run are a stream over them, each pass in an order the seed shuffles, each
frequency uniform inside its sub-band; request k takes the next
`freqs_per_request` of them.  Every seed so sends the same mix of the band
(a block of 8 holds one frequency of each sub-band), and every frequency
is new, so each request pays its per-frequency set-up.
"""

from __future__ import annotations

from typing import List

import numpy as np

#: Equal sub-bands the band is cut into.
STRATA = 8


def _rng(seed: int, stream: int) -> np.random.Generator:
    seed = int(seed)
    return np.random.default_rng([abs(seed), int(seed < 0), stream])


class FrequencyStream:
    """Request k's frequencies (GHz) for one seed and one stream (0: the
    window, 1: the warm-up)."""

    def __init__(self, seed: int, band, traffic: dict, stream: int = 0):
        self.f0, self.f1 = (float(f) for f in band)
        self.n = int(traffic["freqs_per_request"])
        self._rng = _rng(seed, stream)
        self._slots: List[int] = []

    def next_request(self) -> List[float]:
        while len(self._slots) < self.n:
            self._slots += self._rng.permutation(STRATA).tolist()
        slots, self._slots = self._slots[:self.n], self._slots[self.n:]
        u = self._rng.random(self.n)
        width = (self.f1 - self.f0) / STRATA
        return [self.f0 + (s + x) * width for s, x in zip(slots, u)]
