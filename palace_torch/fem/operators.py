"""Quadrature-order policy and per-element coefficient tables (counterpart of
the jax-free parts of palace_tpu/fem/operators.py: `QuadraturePolicy`,
`default_qorder`, `_per_elem_tensor`)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


class QuadraturePolicy:
    """Default integration order q = 2 p + (jac ? order(|J|) : 0) + extra
    (reference: palace/fem/integrator.hpp:20-34), set from config
    Solver/QuadratureOrder{Jacobian,Extra} by api.run and overridable by the
    PALACE_TPU_QORDER_JAC / PALACE_TPU_QORDER_EXTRA /
    PALACE_TPU_SIMPLEX_EXACT_JAC environment variables, exactly as in the
    JAX package (simplices add the exact-|J| degree dim (g - 1) unless
    simplex_exact_jac is off)."""

    jac: bool = False
    extra: int = 0
    simplex_exact_jac: bool = True

    @classmethod
    def set(cls, jac: bool, extra: int) -> None:
        cls.jac = bool(jac)
        cls.extra = int(extra)


def _truthy(s: str) -> bool:
    return s.strip().lower() not in ("0", "false", "no", "off", "")


def _env_policy():
    """Apply the PALACE_TPU_QORDER_* env overrides (env beats config)."""
    j = os.environ.get("PALACE_TPU_QORDER_JAC")
    e = os.environ.get("PALACE_TPU_QORDER_EXTRA")
    s = os.environ.get("PALACE_TPU_SIMPLEX_EXACT_JAC")
    if j is not None:
        QuadraturePolicy.jac = _truthy(j)
    if e is not None:
        QuadraturePolicy.extra = int(e)
    if s is not None:
        QuadraturePolicy.simplex_exact_jac = _truthy(s)


_env_policy()


def default_qorder(p: int, geo_order: int, geom) -> int:
    """Quadrature order exact for 2 p (+ order(|J|) when the policy asks,
    + the policy's extra); order(|J|) is dim (g - 1) on simplices and dim g - 1 on
    tensor-product elements (MFEM's OrderW)."""
    from palace_torch.fem.reference import GEOM_DIM, Geom

    ow = 0
    g = geo_order
    dim = GEOM_DIM[geom]
    simplex = geom in (Geom.LINE, Geom.TRI, Geom.TET)
    if QuadraturePolicy.jac:
        ow = dim * max(g - 1, 0) if simplex else dim * g - 1
    elif simplex and QuadraturePolicy.simplex_exact_jac:
        ow = dim * max(g - 1, 0)
    return 2 * p + ow + QuadraturePolicy.extra


def _per_elem_tensor(table: Dict[int, np.ndarray], attrs: np.ndarray, dim: int
                     ) -> np.ndarray:
    uniq = np.unique(attrs)
    amax = int(uniq.max())
    lut = np.zeros((amax + 1, dim, dim))
    for a in uniq:
        t = np.asarray(table[int(a)], float)
        if t.ndim == 0:
            t = np.eye(dim) * t
        lut[int(a)] = t[:dim, :dim]
    return lut[attrs]
