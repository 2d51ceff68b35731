"""Fill-reducing orderings for sparse-direct factorization.

Geometric nested dissection on dof coordinates: recursive median bisection
along the widest axis with a graph-derived separator.  For 3D FEM meshes
this approaches METIS-quality fill (O(n^2) separator theory) and vastly
outperforms SuperLU's COLAMD default — the equivalent of the reference
solver's METIS-ordered distributed direct solvers
(reference: cmake/ExternalMETIS.cmake, SuperLU_DIST usage in
palace/linalg/superlu.cpp).

Copied from palace_tpu/linalg/ordering.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp


def dof_coordinates(space) -> np.ndarray:
    """Approximate dof positions: average centroid of adjacent elements."""
    mesh = space.mesh
    n = space.num_dofs
    acc = np.zeros((n, mesh.nodes.shape[1]))
    cnt = np.zeros(n)
    for b, ed in zip(mesh.buckets, space.elem_dofs):
        cent = mesh.nodes[b.corners].mean(axis=1)  # (E, sdim)
        E, nd = ed.shape
        np.add.at(acc, ed.ravel(), np.repeat(cent, nd, axis=0))
        np.add.at(cnt, ed.ravel(), 1.0)
    cnt[cnt == 0] = 1.0
    return acc / cnt[:, None]


def nested_dissection(A: sp.csr_matrix, coords: np.ndarray,
                      leaf_size: int = 400) -> np.ndarray:
    """Permutation p such that A[p][:, p] has low fill under LU."""
    A = A.tocsr()
    n = A.shape[0]
    order: List[np.ndarray] = []

    def recurse(idx: np.ndarray):
        if len(idx) <= leaf_size:
            order.append(idx)
            return
        c = coords[idx]
        widths = c.max(axis=0) - c.min(axis=0)
        ax = int(np.argmax(widths))
        med = np.median(c[:, ax])
        left_mask = c[:, ax] <= med
        if left_mask.all() or not left_mask.any():
            order.append(idx)
            return
        left = idx[left_mask]
        right = idx[~left_mask]
        # Separator: left dofs with a matrix-graph neighbor in right.
        in_right = np.zeros(n, bool)
        in_right[right] = True
        sep_mask = np.zeros(len(left), bool)
        indptr, indices = A.indptr, A.indices
        for k, d in enumerate(left):
            row = indices[indptr[d]:indptr[d + 1]]
            if in_right[row].any():
                sep_mask[k] = True
        sep = left[sep_mask]
        left = left[~sep_mask]
        recurse(left)
        recurse(right)
        order.append(sep)

    recurse(np.arange(n))
    return np.concatenate(order)


def splu_nd(A: sp.spmatrix, coords: np.ndarray):
    """SuperLU factorization with geometric nested-dissection pre-ordering.

    Returns an object with .solve(b).
    """
    from scipy.sparse.linalg import splu

    p = nested_dissection(A.tocsr(), coords)
    Ap = A.tocsr()[p][:, p].tocsc()
    # SymmetricMode + near-diagonal pivoting preserves the ordering
    # (5x+ faster than COLAMD on 3D curl-curl systems).
    lu = splu(Ap, permc_spec="NATURAL", diag_pivot_thresh=0.01,
              options=dict(SymmetricMode=True))
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))

    class _LU:
        def solve(self, b):
            return lu.solve(b[p])[inv]

    return _LU()
