"""The guard on what a run loaded: no JAX and nothing of the JAX package.

Names are compared whole by their top-level part (before the first dot),
so `palace_torch` passes although it shares a prefix with `palace_tpu`.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "palace_tpu")


def forbidden_modules(names: Iterable[str] | None = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
