"""Quadrature-order policy, per-element coefficient tables and the H1
bilinear forms (counterpart of palace_tpu/fem/operators.py:
`QuadraturePolicy`, `default_qorder`, `h1_operator`, `_per_elem_tensor`,
`_per_elem_scalar`; the operator's element matrices, or in qdata mode its
quadrature data, are built on the host and held on `device`)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch


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


def h1_operator(space, *, diffusion_coef: Optional[Dict[int, np.ndarray]] = None,
                mass_coef: Optional[Dict[int, np.ndarray]] = None,
                device: torch.device = torch.device("cpu"),
                mode: str = "element"):
    """(alpha grad u, grad v) + (beta u, v) on an H1 space in float64 on
    `device`, at the default quadrature order: dense per-element matrices
    (mode="element") or quadrature data with shared basis tables
    (mode="qdata").  Coefficients are per-attribute 3x3 tensors (mass uses
    the scalar trace/3 unless a scalar is given)."""
    from palace_torch.mesh import geometry
    from palace_torch.ops.partial import BucketTables, PAOperator

    mesh = space.mesh
    buckets: List[BucketTables] = []
    for b, ed in zip(mesh.buckets, space.elem_dofs):
        q = default_qorder(space.order, b.geo_order, b.geom)
        gf = geometry.compute(mesh.nodes, b, q)
        basis = space.basis(b.geom)
        B = basis.eval(gf.qpts)
        G = basis.eval_grad(gf.qpts)
        qd_diffp = qd_mass = None
        if diffusion_coef is not None:
            sdim = mesh.nodes.shape[1]
            C = _per_elem_tensor(diffusion_coef, b.attr, sdim)
            # Planar W[r, u][e, q] = wdetJ * (Jinv C Jinv^T)[r, u].
            Ji = gf.Jinvp  # (r, s, E, nq)
            r = Ji.shape[0]
            Wp = np.zeros((r, r) + gf.wdetJ.shape)
            for rr in range(r):
                for uu in range(r):
                    for s_ in range(sdim):
                        for t_ in range(sdim):
                            cst = C[:, s_, t_]
                            if not np.any(cst):
                                continue
                            Wp[rr, uu] += Ji[rr, s_] * cst[:, None] * Ji[uu, t_]
            Wp *= gf.wdetJ[None, None]
            qd_diffp = Wp
        if mass_coef is not None:
            c = _per_elem_scalar(mass_coef, b.attr)
            qd_mass = gf.wdetJ * c[:, None]
        buckets.append(BucketTables(gidx=ed, B=B, G=G, qd_diffp=qd_diffp,
                                    qd_mass=qd_mass))
    op = PAOperator(space.num_dofs, buckets, device=device, mode=mode)
    op.space = space  # for locality partitioning (parallel/dofsharded.py)
    return op


def _per_elem_scalar(table: Dict[int, np.ndarray], attrs: np.ndarray
                     ) -> np.ndarray:
    uniq = np.unique(attrs)
    amax = int(uniq.max())
    lut = np.zeros(amax + 1)
    for a in uniq:
        t = np.asarray(table[int(a)], float)
        lut[int(a)] = float(t) if t.ndim == 0 else float(np.trace(t) / t.shape[0])
    return lut[attrs]
