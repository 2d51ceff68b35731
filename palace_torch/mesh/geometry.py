"""Geometry factors at quadrature points.

The analog of the reference solver's quadrature-data assembly (reference:
palace/fem/libceed/integrator.cpp geometry factor assembly,
palace/fem/mesh.hpp:20-44): for each element bucket, evaluate the (possibly
curved, isoparametric) coordinate map's Jacobian at quadrature points.

All outputs are plain numpy arrays at setup time; the solver layers move
them to device as needed.

Copied from palace_tpu/mesh/geometry.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.mesh.mesh import ElemBucket
from palace_torch.utils import smallmat

# Cache keyed by (id(nodes), id(bucket), qorder, compute_xq) — meshes are
# immutable after load/scale within a solve.
# Cache keyed on object ids; values hold strong references to (nodes, bucket)
# so live ids stay unique (id() of a garbage-collected array can be reused,
# which would alias the cache onto a different mesh).
_cache: dict = {}
_cache_refs: list = []


@dataclass
class GeomFactors:
    """Per-bucket geometry data at quadrature points.

    Jacobian data is stored PLANAR (structure-of-arrays): Jp[s, r] is the
    contiguous (E, nq) array of d x_s / d xi_r — single-core-host and
    TPU-friendly (every qfunction is then a fused contiguous multiply-add).
    Interleaved (E, nq, s, r) views are materialized lazily via .J / .Jinv.

    For volume buckets (dim == space dim):
      detJ: (E, nq) determinant (> 0 for well-oriented elements)
      w:    (nq,) reference quadrature weights
      wdetJ: (E, nq) quadrature weight times detJ
      Jinvp: (rdim, sdim, E, nq) planar inverse Jacobian (dxi/dx)

    For boundary buckets (dim == space dim - 1), detJ is the surface
    measure sqrt(det(J^T J)) and `normal` holds the unit normal.
    """

    qpts: np.ndarray
    w: np.ndarray
    Jp: np.ndarray  # (sdim, rdim, E, nq) planar Jacobian
    detJ: np.ndarray
    wdetJ: np.ndarray
    Jinvp: np.ndarray | None = None  # (rdim, sdim, E, nq)
    normal: np.ndarray | None = None
    xq: np.ndarray | None = None  # (E, nq, sdim) physical quadrature points
    _J: np.ndarray | None = None
    _Jinv: np.ndarray | None = None

    @property
    def J(self) -> np.ndarray:
        if self._J is None:
            self._J = np.ascontiguousarray(np.moveaxis(self.Jp, (0, 1), (2, 3)))
        return self._J

    @property
    def Jinv(self) -> np.ndarray:
        if self._Jinv is None:
            self._Jinv = np.ascontiguousarray(
                np.moveaxis(self.Jinvp, (0, 1), (2, 3))
            )
        return self._Jinv


def compute(
    nodes: np.ndarray,
    bucket: ElemBucket,
    qorder: int,
    *,
    compute_xq: bool = False,
    sdim: int | None = None,
) -> GeomFactors:
    key = (id(nodes), id(bucket), qorder, compute_xq, sdim)
    hit = _cache.get(key)
    if hit is not None:
        return hit
    geom = bucket.geom
    rdim = ref.GEOM_DIM[geom]
    sdim = sdim if sdim is not None else nodes.shape[1]
    qpts, w = ref.quadrature(geom, qorder)
    basis = ref.gmsh_geometry_basis(bucket.etype)
    G = basis.eval_grad(qpts)  # (nq, nn, rdim)
    X = nodes[bucket.conn]  # (E, nn, sdim)
    # J[e, q, s, r] = sum_n X[e, n, s] G[q, n, r].  Computed as one dgemm per
    # (s, r) component pair so every intermediate stays contiguous — batched
    # tiny gemms and strided 3x3 slicing are pathologically slow on one host
    # core.
    nq, nn, _ = G.shape
    E = X.shape[0]
    Gq = [np.ascontiguousarray(G[:, :, r]) for r in range(rdim)]  # (nq, nn)
    Jp = np.empty((sdim, rdim, E, nq))
    for s in range(sdim):
        Xs = np.ascontiguousarray(X[:, :, s])  # (E, nn)
        for r in range(rdim):
            Jp[s, r] = Xs @ Gq[r].T

    xq = None
    if compute_xq:
        B = basis.eval(qpts)  # (nq, nn)
        xq = np.einsum("ens,qn->eqs", X, B, optimize=True)

    if rdim == sdim:
        detJ, Jinvp = _planar_det_inv(Jp)
        gf = GeomFactors(qpts, w, Jp, detJ, w[None, :] * np.abs(detJ), Jinvp, None, xq)
        _cache[key] = gf
        _cache_refs.append((nodes, bucket))
        return gf

    # Surface (or line) element embedded in higher dimension (small counts:
    # interleaved math is fine here).
    J = np.ascontiguousarray(np.moveaxis(Jp, (0, 1), (2, 3)))
    JtJ = np.einsum("eqsr,eqst->eqrt", J, J, optimize=True)
    detJ = np.sqrt(smallmat.det(JtJ))
    normal = None
    if rdim == 2 and sdim == 3:
        n = np.cross(J[..., 0], J[..., 1])
        normal = n / np.linalg.norm(n, axis=-1, keepdims=True)
    elif rdim == 1 and sdim == 2:
        t = J[..., 0]
        n = np.stack([t[..., 1], -t[..., 0]], axis=-1)
        normal = n / np.linalg.norm(n, axis=-1, keepdims=True)
    gf = GeomFactors(qpts, w, Jp, detJ, w[None, :] * detJ, None, normal, xq)
    _cache[key] = gf
    _cache_refs.append((nodes, bucket))
    return gf


def _planar_det_inv(Jp: np.ndarray):
    """det and inverse from planar components Jp (s, r, ...) with each
    component contiguous.  Returns (det (...), Jinvp (r, s, ...))."""
    n = Jp.shape[0]
    if n == 1:
        d = Jp[0, 0].copy()
        return d, (1.0 / d)[None, None]
    if n == 2:
        a, b = Jp[0, 0], Jp[0, 1]
        c, dd = Jp[1, 0], Jp[1, 1]
        det = a * dd - b * c
        inv = np.empty_like(Jp)
        inv[0, 0] = dd / det
        inv[0, 1] = -b / det
        inv[1, 0] = -c / det
        inv[1, 1] = a / det
        return det, inv
    (a, b, c), (d, e, f), (g, h, i) = (
        (Jp[0, 0], Jp[0, 1], Jp[0, 2]),
        (Jp[1, 0], Jp[1, 1], Jp[1, 2]),
        (Jp[2, 0], Jp[2, 1], Jp[2, 2]),
    )
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = np.empty_like(Jp)
    inv[0, 0] = A / det
    inv[1, 0] = B / det
    inv[2, 0] = C / det
    inv[0, 1] = (c * h - b * i) / det
    inv[1, 1] = (a * i - c * g) / det
    inv[2, 1] = (b * g - a * h) / det
    inv[0, 2] = (b * f - c * e) / det
    inv[1, 2] = (c * d - a * f) / det
    inv[2, 2] = (a * e - b * d) / det
    return det, inv


def bucket_volume(nodes: np.ndarray, bucket: ElemBucket, qorder: int = 4) -> float:
    gf = compute(nodes, bucket, qorder)
    return float(gf.wdetJ.sum())
