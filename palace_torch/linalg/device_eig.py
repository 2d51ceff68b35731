"""Device shift-invert eigensolver for the Maxwell pencil K x = lam M x
(counterpart of palace_tpu/linalg/device_eig.py).

Block Lanczos with thick restart and Rayleigh-Ritz projection (reference:
palace/drivers/eigensolver.cpp backend select at :98-155,
palace/linalg/slepc.cpp): every inner solve (K - sigma M)^-1 applied to a
whole block rides the blocked FGMRES + p-MG solver (linalg/device_ksp.py) on
the run's device, and the K and M products are its fine-level applies.  On a
uniform PEC box hex mesh that fine level runs in the carry-class lattice
layout, through the second hand-written structured-apply kernel.  With more
than one rank the inner solves and the applies ride the dof-sharded solver
(linalg/device_ksp_sharded.py).  The recurrence itself is orchestrated on
the host, as in the JAX package, and replicated on every rank: its start
block comes from a fixed seed and every input it reads is the same on every
rank.

The gradient nullspace of K (the lam = 0 cluster) is removed by an
M-orthogonal divergence-free projection through the discrete gradient,
x <- x - G (G^T M G)^-1 G^T M x, applied to every new block (reference:
palace/linalg/divfree.hpp:29-34).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from palace_torch import parallel
from palace_torch.linalg.device_ksp import BlockedDeviceSolver, Term
from palace_torch.linalg.eig import EigResult
from palace_torch.utils import timers


class DivFreeProjector:
    """M-orthogonal projection onto the divergence-free complement of the
    gradient space (reference: palace/linalg/divfree.hpp:29-34; the inner
    H1 solve is a host factorization of G^T M G, the analog of the
    reference's BoomerAMG-CG Laplace solve)."""

    def __init__(self, space, pec_attrs, M_csr: sp.spmatrix,
                 ess_mask: np.ndarray):
        from scipy.sparse.linalg import splu

        from palace_torch.fem.h1 import H1Space
        from palace_torch.fem.nd_operators import nd_h1_gradient

        h1 = H1Space(space.mesh, space.order)
        G = nd_h1_gradient(space, h1)
        essg = np.zeros(h1.num_dofs, bool)
        if pec_attrs:
            essg[h1.boundary_dofs(list(pec_attrs))] = True
        free_nd = sp.diags((~np.asarray(ess_mask, bool)).astype(float))
        free_h1 = sp.diags((~essg).astype(float))
        self.G = (free_nd @ G @ free_h1).tocsr()
        L = (self.G.T @ M_csr @ self.G).tocsr()
        L = (L + sp.diags(essg.astype(float))).tocsc()
        self._lu = splu(L)
        self.M = M_csr

    def __call__(self, X: np.ndarray) -> np.ndarray:
        """X (n, F) -> projected block."""
        R = self.G.T @ (self.M @ X)
        Y = np.stack(
            [self._lu.solve(np.ascontiguousarray(R[:, f].real))
             + 1j * self._lu.solve(np.ascontiguousarray(R[:, f].imag))
             for f in range(R.shape[1])], axis=1)
        return X - self.G @ Y


def _m_orthonormalize(V_blocks: List[np.ndarray], W: np.ndarray,
                      applyM: Callable) -> Optional[np.ndarray]:
    """CGS2 block orthogonalization of W against V_blocks in the M inner
    product, then M-orthonormalization of W itself (reference:
    palace/linalg/orthog.hpp:19-29)."""
    for _ in range(2):
        MW = applyM(W)
        for V in V_blocks:
            W = W - V @ (V.conj().T @ MW)
            MW = applyM(W)
    # Normalize columns first so genuinely-new small directions (the Lanczos
    # residual after near-invariance) survive the rank filter below.
    MW = applyM(W)
    cn = np.sqrt(np.abs(np.einsum("nf,nf->f", W.conj(), MW).real))
    keep0 = cn > 1e-150
    if not keep0.any():
        return None
    W = W[:, keep0] / cn[keep0][None, :]
    MW = applyM(W)
    S = W.conj().T @ MW
    S = 0.5 * (S + S.conj().T)
    w, U = np.linalg.eigh(S)
    keep = w > max(w.max(), 1.0) * 1e-12
    if not keep.any():
        return None
    T = U[:, keep] / np.sqrt(w[keep])[None, :]
    return W @ T


def eig_setup(space, pec_attrs, K_tables, M_tables, ess_mask: np.ndarray,
              sigma: float, F: int, *, tol: float,
              inner_tol: Optional[float] = None,
              log: Optional[Callable] = None, mg_opts: Optional[dict] = None,
              device: torch.device = torch.device("cpu")):
    """The shift-invert solver at sigma (K - sigma M through the
    carry-class structured fine level where it engages; with more than one
    rank the dof-sharded solver, as in palace_tpu/linalg/device_eig.py:
    116-128), the div-free projector and the K, M terms of
    `device_shift_invert_eigs`."""
    terms = [Term("K", K_tables, coef=lambda s: 1.0 + 0.0j),
             Term("M", M_tables, coef=lambda s: -complex(s))]
    kw = dict(tol=(inner_tol if inner_tol is not None
                   else max(1e-12, 0.01 * tol)),
              max_its=200, restart=30, max_block=min(F, 8), log=log,
              device=device, layout="class", **(mg_opts or {}))
    args = (space, pec_attrs, terms, [sigma], np.asarray(ess_mask))
    if parallel.n_shards() > 1:
        from palace_torch.linalg.device_ksp_sharded import (
            ShardedBlockedDeviceSolver)

        kw.pop("layout")  # no structured fine level on the sharded route
        solver = ShardedBlockedDeviceSolver(*args, **kw)
    else:
        solver = BlockedDeviceSolver(*args, **kw)
    project = DivFreeProjector(space, pec_attrs, terms[1].csr(space.num_dofs),
                               ess_mask)
    return solver, project, terms


def device_shift_invert_eigs(
    space, pec_attrs, K_tables, M_tables, ess_mask: np.ndarray,
    sigma: float, nev: int, *, tol: float = 1e-9, max_restart: int = 20,
    n_blocks: int = 5, inner_tol: Optional[float] = None,
    block_extra: int = 4, nconv: Optional[int] = None,
    log: Optional[Callable] = None, mg_opts: Optional[dict] = None,
    device: torch.device = torch.device("cpu"),
) -> EigResult:
    """Eigenvalues of K x = lam M x nearest sigma (K/M real symmetric,
    M SPD), K_tables/M_tables the (gidx, A) element tables.  Matches the
    semantics of linalg/eig.py shift_invert_eigs, computed on `device`.
    The run's restart and FGMRES iteration counts and its fine level are
    left in `device_shift_invert_eigs.last_info`."""
    log = log or (lambda s: None)
    n = space.num_dofs
    nconv = min(nev, nconv if nconv is not None else nev)
    F = min(n, max(nev // 2 + block_extra, 6))
    with timers.block("  Setup"):
        solver, project, terms = eig_setup(
            space, pec_attrs, K_tables, M_tables, ess_mask, sigma, F,
            tol=tol, inner_tol=inner_tol, log=log, mg_opts=mg_opts,
            device=device)
    eK = np.array([1.0, 0.0])
    eM = np.array([0.0, 1.0])
    applyK = lambda X: solver.apply_fine(eK, X)  # noqa: E731
    applyM = lambda X: solver.apply_fine(eM, X)  # noqa: E731

    ess = np.asarray(ess_mask, bool)
    rng = np.random.default_rng(17)
    X = rng.standard_normal((n, F)) + 0.0j
    X[ess] = 0.0
    Knorm = abs(terms[0].csr(n)).sum(axis=1).max()
    Mnorm = abs(terms[1].csr(n)).sum(axis=1).max()

    lam = np.full(nev, sigma, complex)
    vecs = X[:, :nev]
    prev_bkwd = np.inf
    ksp_its = 0
    restarts = 0

    for restart in range(max_restart):
        restarts = restart + 1
        X = project(X)
        V0 = _m_orthonormalize([], X, applyM)
        blocks = [V0]
        for j in range(n_blocks - 1):
            MB = applyM(blocks[-1])
            W, info = solver.solve(MB, omega_idx=np.zeros(MB.shape[1], int))
            ksp_its += int(info["iterations"].sum())
            W = project(W)
            Wn = _m_orthonormalize(blocks, W, applyM)
            if Wn is None:
                break
            blocks.append(Wn)
        V = np.concatenate(blocks, axis=1)
        # Rayleigh-Ritz: V^H K V z = theta V^H M V z with V M-orthonormal.
        KV = applyK(V)
        C = V.conj().T @ KV
        C = 0.5 * (C + C.conj().T)
        theta, Z = np.linalg.eigh(C)
        order = np.argsort(np.abs(theta - sigma))
        theta, Z = theta[order], Z[:, order]
        k = min(nev, V.shape[1])
        lam = np.asarray(theta[:k], complex)
        vecs = V @ Z[:, :k]
        # Residuals of the leading nconv Ritz pairs gate convergence.
        m = min(nconv, k)
        Kv = applyK(vecs[:, :m])
        Mv = applyM(vecs[:, :m])
        R = Kv - lam[None, :m] * Mv
        xn = np.linalg.norm(vecs[:, :m], axis=0)
        res_c = np.linalg.norm(R, axis=0) / np.where(xn > 0, xn, 1.0)
        bkwd = res_c / (Knorm + np.abs(lam[:m]) * Mnorm)
        log(f"  device eig: restart {restart + 1} "
            f"({V.shape[1]}-dim space), leading lam "
            f"{np.sort(np.real(lam[:m]))[:4]}, max bkwd {bkwd.max():.2e}")
        if bkwd.max() <= tol:
            break
        if restart > 2 and bkwd.max() > 0.5 * prev_bkwd:
            log("  device eig: stagnated; accepting current accuracy")
            break
        prev_bkwd = bkwd.max()
        # Thick restart from the best F Ritz vectors.
        X = V @ Z[:, :F] if V.shape[1] >= F else np.concatenate(
            [V @ Z, rng.standard_normal((n, F - V.shape[1]))], axis=1)
        X[ess] = 0.0

    k = len(lam)
    Kv = applyK(vecs)
    Mv = applyM(vecs)
    res_out = np.empty(k)
    bkwd_out = np.empty(k)
    for i in range(k):
        r = Kv[:, i] - lam[i] * Mv[:, i]
        nx = np.linalg.norm(vecs[:, i])
        res_out[i] = np.linalg.norm(r) / (nx if nx > 0 else 1.0)
        bkwd_out[i] = res_out[i] / (Knorm + abs(lam[i]) * Mnorm)
    device_shift_invert_eigs.last_info = {
        "restarts": restarts, "ksp_iterations": ksp_its,
        "fine_level": solver.fine_level,
        "parallel": (solver.describe() if parallel.n_shards() > 1
                     else None)}
    return EigResult(lam, vecs, res_out, bkwd_out)


device_shift_invert_eigs.last_info = None
