"""Eigenvalue solvers for the Maxwell operator pencil K x = lambda M x.

Replaces SLEPc/ARPACK (reference: palace/linalg/slepc.cpp, eps.hpp:22) with
two paths:

- Host shift-and-invert Arnoldi on the assembled sparse pencil (complex
  supported, used for moderate problems and as the robust default).
- Device LOBPCG with divergence-free projection (matrix-free; the scaling
  path for large problems, lands with the multichip work).

Copied from palace_tpu/linalg/eig.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


@dataclass
class EigResult:
    eigenvalues: np.ndarray  # (k,) complex lambda
    eigenvectors: np.ndarray  # (n, k) on the full dof set (ess rows zero)
    residuals: np.ndarray  # (k,) ||K x - lambda M x|| / ||x||
    backward_errors: np.ndarray  # (k,) residual / (||K|| + |lambda| ||M||)


def _det_v0(n: int) -> np.ndarray:
    """Deterministic ARPACK starting vector (scipy defaults to a random
    one, which makes solver paths — and their seed-quality-dependent
    fallback decisions — vary run to run)."""
    return np.cos(0.7 * np.arange(n)) + 0.1


def _eigs_partial_ok(op, nev, which, tol, maxiter):
    """ARPACK with graceful partial convergence: heavily damped pencils
    (e.g. p = 4 prism + impedance boundaries) can exhaust the restart
    budget long after the wanted interior modes have locked; use whatever
    converged instead of burning hours (the caller's retry loop expands the
    subspace if too few survive its filters)."""
    try:
        return spla.eigs(op, k=nev, which=which, tol=tol, maxiter=maxiter,
                         v0=_det_v0(op.shape[0]).astype(complex))
    except spla.ArpackNoConvergence as e:
        if len(e.eigenvalues) == 0:
            raise
        import warnings

        warnings.warn(
            f"ARPACK converged only {len(e.eigenvalues)}/{nev} eigenpairs "
            f"within {maxiter} iterations (tol {tol:.1e}); using the "
            "partial set — check the reported backward errors",
            RuntimeWarning, stacklevel=2)
        return e.eigenvalues, e.eigenvectors


def shift_invert_eigs(
    K: sp.spmatrix,
    M: sp.spmatrix,
    ess_dofs: np.ndarray,
    sigma: float,
    nev: int,
    tol: float = 1e-9,
    max_it: Optional[int] = None,
    which: str = "LM",
) -> EigResult:
    """Eigenvalues of K x = lambda M x nearest sigma, with essential dofs
    eliminated.  Supports complex M (lossy materials); K, M symmetric.

    which="LM": nearest sigma in magnitude.  which="LR": only eigenvalues
    ABOVE sigma (largest real 1/(lam - sigma)) — the reference's SLEPc RG
    interval [sigma, inf) semantics (slepc.cpp:432-445), used for Floquet
    solves where a dense spurious band sits just below the target.
    """
    n = K.shape[0]
    keep = np.setdiff1d(np.arange(n), np.asarray(ess_dofs, np.int64))
    Kr = K[keep][:, keep].tocsc()
    Mr = M[keep][:, keep].tocsc()
    is_complex = np.iscomplexobj(Mr.data) or np.iscomplexobj(Kr.data)

    if not is_complex and which == "LM":
        vals, vecs = spla.eigsh(
            Kr, k=nev, M=Mr, sigma=sigma, which="LM", tol=tol,
            maxiter=max_it or max(1000, 40 * nev),
            v0=_det_v0(Kr.shape[0]),
        )
    else:
        # General shift-invert Arnoldi: OP = (K - sigma M)^-1 M.
        A = (Kr - sigma * Mr).tocsc()
        lu = spla.splu(A)
        op = spla.LinearOperator(
            Kr.shape, matvec=lambda x: lu.solve(Mr @ x), dtype=np.complex128
        )
        mu, vecs = _eigs_partial_ok(op, nev, which, tol,
                                    max_it or max(300, 10 * nev))
        vals = sigma + 1.0 / mu
        order = np.argsort(np.abs(vals - sigma) if which == "LM"
                           else np.real(vals))
        vals, vecs = vals[order], vecs[:, order]

    # Residuals on the reduced pencil.
    res = np.empty(len(vals))
    bkwd = np.empty(len(vals))
    Knorm = spla.norm(Kr, np.inf)
    Mnorm = spla.norm(Mr, np.inf)
    for i, lam in enumerate(vals):
        x = vecs[:, i]
        r = Kr @ x - lam * (Mr @ x)
        res[i] = np.linalg.norm(r) / np.linalg.norm(x)
        bkwd[i] = res[i] / (Knorm + abs(lam) * Mnorm)

    full = np.zeros((n, len(vals)), vecs.dtype)
    full[keep] = vecs
    return EigResult(np.asarray(vals), full, res, bkwd)


def quadratic_eigs(
    K: sp.spmatrix,
    C: sp.spmatrix,
    M: sp.spmatrix,
    ess_dofs: np.ndarray,
    sigma: complex,
    nev: int,
    tol: float = 1e-9,
    max_it: Optional[int] = None,
    divfree: Optional[tuple] = None,
) -> EigResult:
    """Quadratic pencil P(lam) x = (K + lam C + lam^2 M) x = 0 nearest
    lam = sigma (reference: palace/drivers/eigensolver.cpp PEP path,
    slepc.cpp PEP linearization).  lam = i omega for the damped Maxwell
    problem.

    Companion linearization z = [x; lam x]:
      A z = lam B z,  A = [[0, I], [-K, -C]],  B = [[I, 0], [0, M]];
    the shift-invert apply (A - sigma B)^-1 B reduces by block elimination
    to one factorization of P(sigma) = K + sigma C + sigma^2 M.

    divfree = (G, M_real): discrete gradient (full-size) and real mass CSR;
    the Krylov iterates are M-orthogonally projected against the gradient
    subspace each apply (reference: eigensolver.cpp:204-218
    SetDivFreeProjector / linalg/divfree.hpp) — without this the
    O(num-H1-dof) gradient cluster at lam ~ 0 starves interior ARPACK
    convergence on damped problems.
    """
    n = K.shape[0]
    keep = np.setdiff1d(np.arange(n), np.asarray(ess_dofs, np.int64))
    Kr = K[keep][:, keep].tocsc().astype(complex)
    Cr = C[keep][:, keep].tocsc().astype(complex)
    Mr = M[keep][:, keep].tocsc().astype(complex)
    m = Kr.shape[0]

    # SLEPc-style pencil balancing (reference: slepc.cpp:884-896): solve for
    # lam~ = lam / gamma on the scaled pencil delta*(K + gamma lam~ C +
    # gamma^2 lam~^2 M) with gamma = sqrt(|K|/|M|), delta = 2/(|K| +
    # gamma |C|).  Without this the companion's identity blocks are O(1)
    # against O(|K|) matrix blocks and the shift-inverted operator is
    # artificially non-normal — the near-PEC impedance pencil (|C| huge)
    # then starves Arnoldi convergence.
    normK = spla.norm(Kr, np.inf)
    normC = spla.norm(Cr, np.inf) if Cr.nnz else 0.0
    normM = spla.norm(Mr, np.inf)
    if normK > 0.0 and normM > 0.0:
        gamma = float(np.sqrt(normK / normM))
        delta = 2.0 / (normK + gamma * normC)
    else:
        gamma, delta = 1.0, 1.0
    Ks = (delta * Kr).tocsc()
    Cs = (delta * gamma * Cr).tocsc()
    Ms = (delta * gamma * gamma * Mr).tocsc()
    sigma_full = sigma
    sigma = sigma / gamma

    P = (Ks + sigma * Cs + sigma * sigma * Ms).tocsc()
    lu = spla.splu(P)

    project = None
    if divfree is not None:
        G_full, M_real = divfree
        Gcsr = G_full.tocsr()
        Gr = Gcsr[keep].tocsc()
        # Keep only H1 dofs whose full gradient lives entirely on kept ND
        # dofs (dropping PEC-boundary H1 dofs, reference: divfree.hpp
        # h1_bdr_tdof_lists) — otherwise the reduced K_r G_r != 0 and the
        # projection corrupts the physical spectrum.
        ess_idx = np.setdiff1d(np.arange(G_full.shape[0]), keep)
        Gess = Gcsr[ess_idx] if len(ess_idx) else None
        on_ess = (np.asarray(abs(Gess).sum(axis=0)).ravel()
                  if Gess is not None else np.zeros(G_full.shape[1]))
        colnrm = np.sqrt(np.asarray(Gr.multiply(Gr).sum(axis=0)).ravel())
        cols = np.where((colnrm > 1e-12 * max(colnrm.max(), 1e-300))
                        & (on_ess <= 1e-8 * np.maximum(colnrm, 1e-300)))[0]
        Gr = Gr[:, cols].tocsc()
        MrR = M_real[keep][:, keep].tocsr().astype(float)
        W = (Gr.T @ (MrR @ Gr)).tocsc()
        W = W + 1e-12 * spla.norm(W, np.inf) * sp.eye(W.shape[0], format="csc")
        lu_W = spla.splu(W)

        def project(x):
            y = Gr.T @ (MrR @ x)
            z = lu_W.solve(y.real) + 1j * lu_W.solve(y.imag)
            return x - Gr @ z

    def matvec(z):
        # Solve (A - sigma B) [u; v] = B [f; g] = [f; M g]:
        #   -sigma u + v = f  ->  v = f + sigma u
        #   -K u - C v - sigma M v = M g
        #   => P(sigma) u = -(M g) - (C + sigma M) f
        f = z[:m]
        g = z[m:]
        rhs = -(Ms @ g) - (Cs @ f) - sigma * (Ms @ f)
        u = lu.solve(rhs)
        if project is not None:
            u = project(u)
        v = f + sigma * u
        if project is not None:
            v = project(v)
        return np.concatenate([u, v])

    op = spla.LinearOperator((2 * m, 2 * m), matvec=matvec,
                             dtype=np.complex128)
    # Restart budget: the reduced default (300, 10*nev) is tuned for the
    # loose-tolerance production path; an explicitly tight tolerance gets
    # the full classic budget so user-requested accuracy is not silently
    # abandoned via partial convergence.
    default_it = max(300, 10 * nev) if tol >= 1e-6 else max(1000, 40 * nev)
    mu, zvecs = _eigs_partial_ok(op, nev, "LM", tol,
                                 max_it or default_it)
    vals = gamma * (sigma + 1.0 / mu)  # un-scale lam = gamma * lam~
    sigma = sigma_full
    vecs = zvecs[:m]
    order = np.argsort(np.abs(vals - sigma))
    vals, vecs = vals[order], vecs[:, order]

    res = np.empty(len(vals))
    bkwd = np.empty(len(vals))
    Knorm = spla.norm(Kr, np.inf)
    Cnorm = spla.norm(Cr, np.inf)
    Mnorm = spla.norm(Mr, np.inf)
    for i, lam in enumerate(vals):
        x = vecs[:, i]
        nx = np.linalg.norm(x)
        if nx == 0:
            res[i] = bkwd[i] = np.inf
            continue
        r = Kr @ x + lam * (Cr @ x) + lam * lam * (Mr @ x)
        res[i] = np.linalg.norm(r) / nx
        bkwd[i] = res[i] / (Knorm + abs(lam) * Cnorm + abs(lam) ** 2 * Mnorm)

    full = np.zeros((n, len(vals)), vecs.dtype)
    full[keep] = vecs
    return EigResult(np.asarray(vals), full, res, bkwd)


def quadratic_eigs_jd(
    K: sp.spmatrix,
    C: sp.spmatrix,
    M: sp.spmatrix,
    ess_dofs: np.ndarray,
    sigma: complex,
    nev: int,
    X0: np.ndarray,
    tol: float = 1e-9,
    max_rounds: int = 12,
    divfree: Optional[tuple] = None,
    log=None,
    polish_tol: Optional[float] = None,
    n_polish: Optional[int] = None,
) -> Optional[EigResult]:
    """Subspace-projection solver for the damped quadratic pencil, seeded
    with the LOSSLESS modes: project (K + lam C + lam^2 M) onto span(V),
    solve the small dense companion GEP, and expand V Jacobi-Davidson-style
    with preconditioned residuals t = P(sigma)^{-1} r using ONE reused
    complex factorization.  For near-PEC damping (e.g. the impedance
    cavity, Rs ~ 0.02 Ohm) the seed subspace is already accurate to the
    perturbation and 1-2 rounds converge — replacing the hours-long host
    ARPACK companion iteration (reference analogue: SLEPc PEP/TOAR,
    palace/linalg/slepc.cpp, selected at drivers/eigensolver.cpp:98-155;
    the seeding strategy itself has no reference analogue — it is how this
    framework reaches TOAR-class wall-clock without a TOAR recurrence).

    Returns None if the wanted modes do not reach `tol` within
    `max_rounds` (caller falls back to `quadratic_eigs`)."""
    import scipy.linalg as sla

    log = log or (lambda s: None)
    n = K.shape[0]
    keep = np.setdiff1d(np.arange(n), np.asarray(ess_dofs, np.int64))
    Kr = K[keep][:, keep].tocsr().astype(complex)
    Cr = C[keep][:, keep].tocsr().astype(complex)
    Mr = M[keep][:, keep].tocsr().astype(complex)

    P = (Kr + sigma * Cr + sigma * sigma * Mr).tocsc()
    lu = spla.splu(P)

    project = None
    if divfree is not None:
        # Same reduced div-free projector as quadratic_eigs.
        G_full, M_real = divfree
        Gcsr = G_full.tocsr()
        Gr = Gcsr[keep].tocsc()
        ess_idx = np.setdiff1d(np.arange(G_full.shape[0]), keep)
        Gess = Gcsr[ess_idx] if len(ess_idx) else None
        on_ess = (np.asarray(abs(Gess).sum(axis=0)).ravel()
                  if Gess is not None else np.zeros(G_full.shape[1]))
        colnrm = np.sqrt(np.asarray(Gr.multiply(Gr).sum(axis=0)).ravel())
        cols = np.where((colnrm > 1e-12 * max(colnrm.max(), 1e-300))
                        & (on_ess <= 1e-8 * np.maximum(colnrm, 1e-300)))[0]
        Gr = Gr[:, cols].tocsc()
        MrR = M_real[keep][:, keep].tocsr().astype(float)
        W = (Gr.T @ (MrR @ Gr)).tocsc()
        W = W + 1e-12 * spla.norm(W, np.inf) * sp.eye(W.shape[0],
                                                      format="csc")
        lu_W = spla.splu(W)

        def project(x):
            y = Gr.T @ (MrR @ x)
            z = lu_W.solve(y.real) + 1j * lu_W.solve(y.imag)
            return x - Gr @ z

    V = np.asarray(X0[keep], complex)
    nrm = np.linalg.norm(V, axis=0)
    V = V[:, nrm > 0] / nrm[nrm > 0]
    V, _ = np.linalg.qr(V)
    max_dim = max(4 * nev + 16, V.shape[1] + nev * max_rounds)

    Knorm = spla.norm(Kr, np.inf)
    Cnorm = spla.norm(Cr, np.inf) if Cr.nnz else 0.0
    Mnorm = spla.norm(Mr, np.inf)

    best = None
    prev_max_bkwd = np.inf
    for rnd in range(max_rounds):
        k = V.shape[1]
        KV, CV, MV = Kr @ V, Cr @ V, Mr @ V
        Kp = V.conj().T @ KV
        Cp = V.conj().T @ CV
        Mp = V.conj().T @ MV
        # Companion GEP: A z = lam B z, z = [y; lam y].
        A = np.block([[np.zeros((k, k)), np.eye(k)], [-Kp, -Cp]])
        B = np.block([[np.eye(k), np.zeros((k, k))],
                      [np.zeros((k, k)), Mp]])
        lam_all, Z = sla.eig(A, B)
        finite = np.isfinite(lam_all)
        # Physical branch: lam = i omega with Re(omega) = Im(lam) > 0, and
        # away from the gradient-nullspace/overdamped clusters (whose tiny
        # K-residuals "converge" instantly, crowd the nev Ritz slots, and
        # hand the caller modes its Re(omega) > 1e-3 omega_t filter drops —
        # which then falls back to the hours-long companion ARPACK).  Use
        # the same 1e-3 threshold as the caller: overdamped spurious modes
        # are pure-real lam whose Im is roundoff noise (up to ~1e-11 |lam|),
        # far below 1e-3 |sigma|; physical resonances sit at Im lam ~
        # |sigma|, far above.
        phys = (finite & (np.imag(lam_all) > 1e-3 * abs(sigma))
                & (np.abs(lam_all) > 1e-6 * abs(sigma)))
        if phys.sum() == 0:
            fin = lam_all[finite]
            log("  quadratic JD: no physical Ritz values in the projected "
                f"pencil (|Im lam| max {np.abs(np.imag(fin)).max():.2e} vs "
                f"threshold {1e-3 * abs(sigma):.2e}) — seed subspace misses "
                "the damped modes")
            return None
        if phys.sum() < nev:
            log(f"  quadratic JD: only {int(phys.sum())}/{nev} physical "
                "Ritz values in the projected pencil (threshold "
                f"{1e-3 * abs(sigma):.2e}) — proceeding with fewer")
        idx = np.where(phys)[0]
        idx = idx[np.argsort(np.abs(lam_all[idx] - sigma))][:nev]
        lam = lam_all[idx]
        Y = Z[:k, idx]
        X = V @ Y
        nx = np.linalg.norm(X, axis=0)
        X = X / np.where(nx > 0, nx, 1.0)

        R = KV @ Y + CV @ (Y * lam[None, :]) + MV @ (Y * lam[None, :] ** 2)
        R = R / np.where(nx > 0, nx, 1.0)
        res = np.linalg.norm(R, axis=0)
        bkwd = res / (Knorm + np.abs(lam) * Cnorm
                      + np.abs(lam) ** 2 * Mnorm)
        log(f"  quadratic JD: round {rnd + 1} dim {k}, "
            f"{len(lam)}/{int(phys.sum())} selected/physical, "
            f"max bkwd {bkwd.max():.2e}")
        if best is None or bkwd.max() < best[3].max():
            best = (lam, X, res, bkwd)
        if bkwd.max() <= tol:
            break
        if rnd == max_rounds - 1 or (rnd > 3
                                     and bkwd.max() > 0.5 * prev_max_bkwd):
            break  # stagnated; polish the best snapshot below
        prev_max_bkwd = bkwd.max()
        # Expand with preconditioned residuals of unconverged pairs.
        T = []
        for i in np.where(bkwd > tol)[0]:
            t = lu.solve(R[:, i])
            if project is not None:
                t = project(t)
            t = t - V @ (V.conj().T @ t)
            nt = np.linalg.norm(t)
            if nt > 1e-13:
                T.append(t / nt)
        if not T:
            return None
        V = np.concatenate([V, np.stack(T, axis=1)], axis=1)
        if V.shape[1] > max_dim:
            # Compress to the current Ritz vectors + fresh directions.
            V = np.concatenate([X, np.stack(T, axis=1)], axis=1)
        V, _ = np.linalg.qr(V)

    if best is None:
        return None
    lam, X, res, bkwd = best
    # On strongly non-normal pencils (near-PEC impedance, Q ~ 1-10 sheet
    # ports) the EIGENVALUE condition number is large: a backward error at
    # the user tolerance (1e-6) still admits percent-level forward error in
    # Im(lam), which is what the regression refs compare.  polish_tol
    # drives the pairs further down (RQI converges quadratically in the
    # basin) so the forward error is reproducible run-to-run.
    if polish_tol is None:
        polish_tol = tol
    # Polish only the pairs that will be reported (closest to sigma):
    # each RQI step refactorizes P(lam), which dominates wall-clock on
    # large meshes (the cpw lumped_eigen solve requests 1 mode but the
    # subspace holds 5+ Ritz pairs).
    order0 = np.argsort(np.abs(lam - sigma))
    lam, X = lam[order0], X[:, order0]
    res, bkwd = res[order0], bkwd[order0]
    np_polish = len(lam) if n_polish is None else min(n_polish, len(lam))
    if bkwd[:np_polish].max() > polish_tol:
        # Per-pair quadratic Rayleigh-quotient polish: the subspace rounds
        # stall around 1e-5 on strongly non-normal pencils (expansion
        # directions crowd the Ritz selection), but each pair is already in
        # the basin where inverse iteration with exact refactorization
        # converges quadratically.  One splu per step is cheap at the
        # assembled sizes this path handles.
        if bkwd[:np_polish].max() > 1e-2:
            return None  # nowhere near; let the caller fall back
        lam = lam.copy()
        X = X.copy()
        res = res.copy()
        bkwd = bkwd.copy()
        for i in range(np_polish):
            li, xi = lam[i], X[:, i]
            for _ in range(8):
                Ti = (Kr + li * Cr + li * li * Mr).tocsc()
                ri = Ti @ xi
                nrm = np.linalg.norm(ri) / (Knorm + abs(li) * Cnorm
                                            + abs(li) ** 2 * Mnorm)
                if nrm <= 0.5 * polish_tol:
                    break
                try:
                    lui = spla.splu(Ti)
                except RuntimeError:
                    break  # exactly singular: converged
                y = lui.solve((Cr + 2.0 * li * Mr) @ xi)
                ny = np.linalg.norm(y)
                if not np.isfinite(ny) or ny == 0:
                    break
                xi = y / ny
                if project is not None:
                    xi = project(xi)
                    xi = xi / np.linalg.norm(xi)
                # Rayleigh update: root of x^H T(lam) x closest to lam.
                a = np.vdot(xi, Mr @ xi)
                b = np.vdot(xi, Cr @ xi)
                c = np.vdot(xi, Kr @ xi)
                roots = np.roots([a, b, c])
                if len(roots) == 0:
                    break  # x^H M x and x^H C x both vanished; keep lam
                li = roots[np.argmin(np.abs(roots - li))]
            Ti = Kr @ xi + li * (Cr @ xi) + li * li * (Mr @ xi)
            res[i] = np.linalg.norm(Ti)
            bkwd[i] = res[i] / (Knorm + abs(li) * Cnorm
                                + abs(li) ** 2 * Mnorm)
            lam[i], X[:, i] = li, xi
        log("  quadratic JD: RQI polish -> max bkwd "
            f"{bkwd[:np_polish].max():.2e} over {np_polish} pair(s)")
        if bkwd[:np_polish].max() > tol:
            return None
    order = np.argsort(np.abs(lam - sigma))
    lam, X = lam[order], X[:, order]
    res, bkwd = res[order], bkwd[order]
    full = np.zeros((n, len(lam)), complex)
    full[keep] = X
    return EigResult(np.asarray(lam), full, res, bkwd)
