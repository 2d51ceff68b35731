"""Process-global solve provenance: which solver path produced the results.

The regression harness snapshots this into each case's REGRESSION.json
entry so a "green" case shows whether its numbers came from the device
Krylov path, a host sparse-direct fallback, or a mix (the reference
equivalent is the solver/iteration block of palace.json,
palace/drivers/basesolver.cpp:290-375 — here it also travels with the
regression record).

Drivers call `record(key, value)` / `add(key, n)`; `snapshot()` returns a
plain dict; `reset()` clears between runs.

Copied from palace_tpu/utils/provenance.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import Any, Dict

_DATA: Dict[str, Any] = {}


def reset() -> None:
    _DATA.clear()


def record(key: str, value) -> None:
    _DATA[key] = value


def add(key: str, n: int | float) -> None:
    _DATA[key] = _DATA.get(key, 0) + n


def append(key: str, value) -> None:
    _DATA.setdefault(key, []).append(value)


def snapshot() -> Dict[str, Any]:
    return dict(_DATA)
