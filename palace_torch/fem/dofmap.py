"""Canonical entity keys for conforming global dof numbering.

Replaces MFEM's prolongation/DofTransformation machinery (reference:
palace/fem/fespace.hpp:41-62, palace/fem/libceed/restriction.cpp) with a
static, orientation-independent scheme: every degree of freedom is
identified by an integer key derived from the *global vertex ids* of the
mesh entity it lives on plus its canonically-oriented position within
that entity.  Two elements sharing an entity then produce identical keys,
so `np.unique` over all (element, local dof) keys yields a conforming
global numbering with no communication or traversal.

Key layout (int64, 7 columns): [kind, i0, i1, i2, i3, c0, c1]
  kind 0 vertex:   i0 = vertex node id
  kind 1 edge:     i0 < i1 sorted vertex ids, c0 = lattice position
                   (1..p-1) measured from i0, c1 = variant id
  kind 2 tri face: i0 < i1 < i2 sorted ids, (c0, c1) = lattice barycentric
                   weights of i1, i2 (variant folded into c1 stride)
  kind 3 quad face:i0..i3 sorted ids, (c0, c1) canonical coords
  kind 4 interior: i0 = bucket id, i1 = element id, c0 = local counter

Copied from palace_tpu/fem/dofmap.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import numpy as np

KIND_VERTEX, KIND_EDGE, KIND_TRI, KIND_QUAD, KIND_INTERIOR = 0, 1, 2, 3, 4


def vertex_keys(vids: np.ndarray) -> np.ndarray:
    """(N,) vertex node ids -> (N, 7) keys."""
    n = len(vids)
    k = np.full((n, 7), -1, np.int64)
    k[:, 0] = KIND_VERTEX
    k[:, 1] = vids
    return k


def edge_keys(v0: np.ndarray, v1: np.ndarray, w: np.ndarray, p: int,
              variant: np.ndarray | int = 0) -> np.ndarray:
    """Edge dofs at lattice position w in (0, p) measured from v0.

    Returns (N, 7) keys plus the orientation sign convention: also returns
    nothing here — signs are handled by callers (H1 has none).
    """
    v0 = np.asarray(v0, np.int64)
    v1 = np.asarray(v1, np.int64)
    w = np.asarray(w, np.int64)
    flip = v0 > v1
    a = np.where(flip, v1, v0)
    b = np.where(flip, v0, v1)
    ww = np.where(flip, p - w, w)
    n = len(a)
    k = np.full((n, 7), -1, np.int64)
    k[:, 0] = KIND_EDGE
    k[:, 1] = a
    k[:, 2] = b
    k[:, 5] = ww
    k[:, 6] = np.asarray(variant, np.int64)
    return k


def edge_flip(v0, v1) -> np.ndarray:
    """True where the canonical edge direction is opposite (v0 > v1)."""
    return np.asarray(v0, np.int64) > np.asarray(v1, np.int64)


def tri_keys(vids: np.ndarray, bary: np.ndarray, variant: np.ndarray | int = 0,
             stride: int = 1) -> np.ndarray:
    """Tri-face dofs. vids (N, 3) global ids; bary (N, 3) integer lattice
    barycentric weights w.r.t. those ids (sum = p)."""
    vids = np.asarray(vids, np.int64)
    bary = np.asarray(bary, np.int64)
    order = np.argsort(vids, axis=1, kind="stable")
    vs = np.take_along_axis(vids, order, axis=1)
    bs = np.take_along_axis(bary, order, axis=1)
    n = len(vids)
    k = np.full((n, 7), -1, np.int64)
    k[:, 0] = KIND_TRI
    k[:, 1:4] = vs
    k[:, 5] = bs[:, 1]
    k[:, 6] = bs[:, 2] * stride + np.asarray(variant, np.int64)
    return k


def quad_canonical(vids: np.ndarray, s: np.ndarray, t: np.ndarray, p: int):
    """Canonicalize quad-face lattice coordinates.

    vids (N, 4): corner ids in cyclic order; (s, t) integer coords in
    [0, p]^2 with corner k at [(0,0), (p,0), (p,p), (0,p)][k].
    Returns (sorted ids (N, 4), s' (N,), t' (N,), orientation o (N,)).
    """
    vids = np.asarray(vids, np.int64)
    s = np.asarray(s, np.int64)
    t = np.asarray(t, np.int64)
    r = np.argmin(vids, axis=1)  # index of min corner
    nxt = vids[np.arange(len(vids)), (r + 1) % 4]
    prv = vids[np.arange(len(vids)), (r + 3) % 4]
    fwd = nxt < prv  # first axis toward next corner in cyclic order
    # Express (s, t) relative to corner r with axes (toward r+1, toward r+3)
    # (if fwd) or (toward r+3, toward r+1) (if not).
    # Corner positions: 0:(0,0) 1:(p,0) 2:(p,p) 3:(0,p)
    # For each r, coordinates along cyclic edges:
    #   u_k = coordinate from corner r toward corner r+1
    #   v_k = coordinate from corner r toward corner r-1
    u_tab = [
        (s, t),          # r=0: toward 1 is +s, toward 3 is +t
        (t, p - s),      # r=1: toward 2 is +t, toward 0 is p-s
        (p - s, p - t),  # r=2: toward 3 is p-s, toward 1 is p-t
        (p - t, s),      # r=3: toward 0 is p-t, toward 2 is +s
    ]
    u = np.select([r == k for k in range(4)], [u_tab[k][0] for k in range(4)])
    v = np.select([r == k for k in range(4)], [u_tab[k][1] for k in range(4)])
    s2 = np.where(fwd, u, v)
    t2 = np.where(fwd, v, u)
    orient = r * 2 + (~fwd).astype(np.int64)
    return np.sort(vids, axis=1), s2, t2, orient


def quad_keys(vids: np.ndarray, s: np.ndarray, t: np.ndarray, p: int,
              variant: np.ndarray | int = 0, stride: int = 1) -> np.ndarray:
    vs, s2, t2, _ = quad_canonical(vids, s, t, p)
    n = len(vs)
    k = np.full((n, 7), -1, np.int64)
    k[:, 0] = KIND_QUAD
    k[:, 1:5] = vs
    k[:, 5] = s2 * (p + 1) + t2
    k[:, 6] = np.asarray(variant, np.int64) * stride
    return k


def interior_keys(bucket_id: int, elem_ids: np.ndarray, counters: np.ndarray
                  ) -> np.ndarray:
    n = len(elem_ids)
    k = np.full((n, 7), -1, np.int64)
    k[:, 0] = KIND_INTERIOR
    k[:, 1] = bucket_id
    k[:, 2] = np.asarray(elem_ids, np.int64)
    k[:, 5] = np.asarray(counters, np.int64)
    return k


def number_dofs(all_keys: np.ndarray):
    """Global numbering from concatenated keys.

    Returns (num_dofs, dof_ids (N,) int32, unique_keys (ndof, 7)).
    """
    uniq, inv = np.unique(all_keys, axis=0, return_inverse=True)
    return len(uniq), inv.astype(np.int32), uniq


def lookup_keys(unique_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Map query keys to dof ids (rows of unique_keys); -1 if absent.

    unique_keys must be the sorted-unique table from number_dofs.
    """
    from palace_torch.mesh.mesh import _lookup_rows

    return _lookup_rows(unique_keys, queries)
