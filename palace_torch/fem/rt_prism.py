"""Raviart-Thomas H(div) elements on (triangular) prisms / wedges.

Tensor construction (the standard de Rham wedge H(div) space — the same
space MFEM >= 4.7's wedge RT collection spans, which the reference uses for
flux-recovery error estimation on prism meshes, e.g. the
cylinder/cavity_impedance case; reference: palace/linalg/errorestimator.cpp
FluxProjector on RT spaces, palace/models/spaceoperator.cpp:44 rt_fecs):

    RT_k(wedge) = [ RT_k(tri) (x) P_k(z) ]_{xy}  (+)  [ P_k(tri) (x) P_{k+1}(z) ]_z

  - in-plane family:  (w_m(x, y) m_j(z), 0),  w_m the canonical-triangle 2D
    RT_k dual basis (fem/rt.py rt_basis_simplex), m_j the open degree-k
    Lagrange ladder at (j+1/2)/(k+1) (as fem/rt_hex.py);
  - vertical family:  (0, 0, u_m(x, y) n_i(z)),  u_m the P_k(tri) monomial
    basis, n_i the closed degree-(k+1) Lagrange ladder (endpoints included).

Since the L2 flux projection the estimator performs depends only on the
SPACE, matching MFEM's wedge space (not its basis) reproduces the
reference's estimator numerics.

Conformity WITHOUT sign tables, exactly as fem/rt.py: elements are
in-plane canonicalized (mesh.canonicalize_simplices / canonicalize_prisms:
ascending bottom triangle, induced ascending top), so
  - a shared vertical quad face is parameterized by both neighbors via the
    same ascending bottom edge (a, b) and the same z; the (edge moment i,
    z level j) dof's normal trace t_i(s) m_j(z) is identical from both
    sides under the signed Piola map v = J v_ref / det J;
  - a shared horizontal tri face (stacked prisms) is the ascending
    canonical triangle for both; the closed z-ladder is nodal at the
    endpoints so only the i = 0 / i = k+1 dofs have a trace there, equal
    to u_m(x, y) from both sides;
  - 2D-interior in-plane dofs and z-interior vertical dofs have zero
    normal trace on every face (edge moments against full P_k determine
    the degree-k edge trace).

Copied from palace_tpu/fem/rt_prism.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from palace_torch.fem import dofmap
from palace_torch.fem import reference as ref
from palace_torch.fem.nd_hex import Ladder1D
from palace_torch.fem.reference import Geom
from palace_torch.fem.rt import (_RT_MARK, _eval_mono, _mono_exps,
                               rt_basis_simplex)


@functools.lru_cache(maxsize=None)
def _ladders(k: int) -> Tuple[Ladder1D, Ladder1D]:
    """(open degree-k, closed degree-(k+1)) z ladders."""
    m = Ladder1D((np.arange(k + 1) + 0.5) / (k + 1))
    n = Ladder1D(np.linspace(0.0, 1.0, k + 2))
    return m, n


@functools.lru_cache(maxsize=None)
def prism_rt_layout(k: int):
    """Structural local dof list: ('ip', tri_rt_index, j_open_level) and
    ('z', Pk_tri_monomial_index, i_closed_level)."""
    tri = rt_basis_simplex(Geom.TRI, k)
    out = []
    for m in range(tri.num_dofs):
        for j in range(k + 1):
            out.append(("ip", m, j))
    n_pk = (k + 1) * (k + 2) // 2
    for m in range(n_pk):
        for i in range(k + 2):
            out.append(("z", m, i))
    return tuple(out)


def prism_rt_num_dofs(k: int) -> int:
    return (k + 1) * (k + 3) * (k + 1) + (k + 1) * (k + 2) // 2 * (k + 2)


def prism_rt_eval(k: int, pts: np.ndarray) -> np.ndarray:
    """(nq, nd, 3) reference values on the canonical wedge
    (ascending unit triangle x [0, 1])."""
    pts = np.asarray(pts, float)
    nq = len(pts)
    xy, z = pts[:, :2], pts[:, 2]
    tri = rt_basis_simplex(Geom.TRI, k)
    Vt = tri.eval(xy)  # (nq, nt, 2)
    U = _eval_mono(_mono_exps(2, k), xy)  # (nq, n_pk)
    mlad, nlad = _ladders(k)
    M, N = mlad.eval(z), nlad.eval(z)
    layout = prism_rt_layout(k)
    V = np.zeros((nq, len(layout), 3))
    for n, (fam, m, j) in enumerate(layout):
        if fam == "ip":
            V[:, n, 0] = Vt[:, m, 0] * M[:, j]
            V[:, n, 1] = Vt[:, m, 1] * M[:, j]
        else:
            V[:, n, 2] = U[:, m] * N[:, j]
    return V


def prism_rt_eval_div(k: int, pts: np.ndarray) -> np.ndarray:
    """(nq, nd) reference divergences: div((w q, 0)) = div2(w) q,
    div((0, 0, u n)) = u n'."""
    pts = np.asarray(pts, float)
    nq = len(pts)
    xy, z = pts[:, :2], pts[:, 2]
    tri = rt_basis_simplex(Geom.TRI, k)
    Dt = tri.eval_div(xy)  # (nq, nt)
    U = _eval_mono(_mono_exps(2, k), xy)
    mlad, nlad = _ladders(k)
    M, dN = mlad.eval(z), nlad.deriv(z)
    layout = prism_rt_layout(k)
    D = np.zeros((nq, len(layout)))
    for n, (fam, m, j) in enumerate(layout):
        if fam == "ip":
            D[:, n] = Dt[:, m] * M[:, j]
        else:
            D[:, n] = U[:, m] * dN[:, j]
    return D


def prism_rt_keys_signs(k: int, corners: np.ndarray, bucket_id: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Global keys (E, nd, 7) and unit signs (E, nd) for an
    in-plane-canonicalized prism bucket; corners (E, 6) = [b0 b1 b2 t0 t1
    t2] with the bottom (and induced top) ascending."""
    g = corners.astype(np.int64)
    E = g.shape[0]
    layout = prism_rt_layout(k)
    nd = len(layout)
    edges2 = ref.GEOM_EDGES[Geom.TRI]  # [(0,1), (0,2), (1,2)] — rt.py order
    n_edge2 = 3 * (k + 1)
    keys = np.empty((E, nd, 7), np.int64)
    signs = np.ones((E, nd))
    interior_seen = 0
    for n, (fam, m, j) in enumerate(layout):
        if fam == "ip" and m < n_edge2:
            # Vertical quad face: (edge moment i, z level j).
            e_idx, i = divmod(m, k + 1)
            a, b = edges2[e_idx]
            quad = np.stack([g[:, a], g[:, b], g[:, 3 + b], g[:, 3 + a]],
                            axis=1)
            kk = np.full((E, 7), -1, np.int64)
            kk[:, 0] = dofmap.KIND_QUAD
            kk[:, 1:5] = np.sort(quad, axis=1)
            kk[:, 5] = i * (k + 1) + j
            kk[:, 6] = _RT_MARK
            keys[:, n] = kk
        elif fam == "z" and j in (0, k + 1):
            # Horizontal tri face: trace u_m on bottom (j = 0) / top.
            layer = 0 if j == 0 else 3
            ks = dofmap.tri_keys(g[:, layer:layer + 3],
                                 np.zeros((E, 3), np.int64),
                                 variant=m, stride=0)
            ks[:, 6] = m * 1000 + _RT_MARK
            keys[:, n] = ks
        else:
            keys[:, n] = dofmap.interior_keys(
                bucket_id, np.arange(E), np.full(E, interior_seen))
            interior_seen += 1
    return keys, signs
