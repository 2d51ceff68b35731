"""The pieces of the blocked FGMRES + p-MG solver (linalg/device_ksp.py)
against their palace_tpu counterparts on the same inputs: the multigrid
order sequence, ELL tables and SpMV, the element and ELL term operators,
4th-kind Chebyshev smoothing, the lambda_max power iteration and the
Hessenberg least squares.  Tolerance 1e-12 relative (float64 on both
sides, other summation order); integer tables and orders exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from palace_tpu.linalg import device_ksp as jksp
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.linalg import device_ksp as tksp
from palace_torch.mesh.generate import box_hex, box_tet
from palace_torch.mesh.mesh import canonicalize_simplices
from palace_torch.ops.partial import signed_tables

MESHES = [("tet", 3), ("hex", 2)]
F = 3


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _terms(kind, p):
    """(K, M, M_im)-like terms with their palace_tpu and port classes, on
    tables the port assembles on its own space."""
    mesh = box_tet(2, 2, 2) if kind == "tet" else box_hex(2, 2, 2)
    canonicalize_simplices(mesh)
    space = NDSpace(mesh, p)
    K = signed_tables(nd_operator(space, curl_coef={1: np.eye(3)}).buckets)
    M = signed_tables(nd_operator(space, mass_coef={1: np.diag(
        [2.0, 1.5, 1.0])}).buckets)
    coefs = [lambda w: 1.0 + 0.0j, lambda w: -w * w, lambda w: -0.01j * w * w]
    jterms = [jksp.Term(n, t, c) for n, t, c in zip(("K", "M", "M_im"),
                                                    (K, M, M), coefs)]
    tterms = [tksp.Term(n, t, c) for n, t, c in zip(("K", "M", "M_im"),
                                                    (K, M, M), coefs)]
    return space.num_dofs, jterms, tterms


@pytest.mark.parametrize("p", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("coarsening", ["Logarithmic", "Linear"])
def test_mg_orders_match_jax(p, coarsening):
    for levels in (100, 2):
        assert tksp.mg_orders(p, coarsening, levels) == \
            jksp.mg_orders(p, coarsening, levels)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ell_tables_and_apply_match_jax(seed):
    rng = np.random.default_rng(seed)
    A = sp.random(40, 40, density=0.15, random_state=seed, format="csr")
    A = (A + sp.eye(40)).tocsr()
    cols, vals = tksp._csr_to_ell(A, torch.device("cpu"))
    cols_j, vals_j = jksp._csr_to_ell(A)
    assert np.array_equal(cols.numpy(), np.asarray(cols_j))
    assert np.array_equal(vals.numpy(), np.asarray(vals_j))
    u = _cplx(rng, 40, F)
    y = tksp._ell_apply((cols, vals), torch.as_tensor(u)).numpy()
    assert _rel(y, np.asarray(jksp._ell_apply((cols_j, vals_j),
                                              jnp.asarray(u)))) < 1e-12
    assert _rel(y, A @ u) < 1e-12


@pytest.mark.parametrize("kind,p", MESHES)
def test_elem_term_operator_matches_jax(kind, p):
    n, jterms, tterms = _terms(kind, p)
    jop = jksp.ElemTermOperator(jterms, n)
    top = tksp.ElemTermOperator(tterms, n, torch.device("cpu"))
    assert top.group == jop.group
    rng = np.random.default_rng(p)
    coefs, u = _cplx(rng, len(tterms), F), _cplx(rng, n, F)
    y = top(torch.as_tensor(coefs), torch.as_tensor(u)).numpy()
    assert _rel(y, np.asarray(jop(jnp.asarray(coefs), jnp.asarray(u)))) < 1e-12


@pytest.mark.parametrize("kind,p", MESHES)
def test_ell_term_operator_matches_jax(kind, p):
    n, jterms, tterms = _terms(kind, p)
    jop = jksp.EllTermOperator([t.csr(n) for t in jterms])
    top = tksp.EllTermOperator([t.csr(n) for t in tterms],
                               torch.device("cpu"))
    rng = np.random.default_rng(10 + p)
    coefs, u = _cplx(rng, len(tterms), F), _cplx(rng, n, F)
    y = top(torch.as_tensor(coefs), torch.as_tensor(u)).numpy()
    assert _rel(y, np.asarray(jop(jnp.asarray(coefs), jnp.asarray(u)))) < 1e-12
    # The term CSRs themselves: one assembly on both sides.
    for tj, tt in zip(jterms, tterms):
        assert abs(tt.csr(n) - tj.csr(n)).max() <= 1e-12 * abs(
            tj.csr(n)).max()


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_cheb4_matches_jax(order):
    rng = np.random.default_rng(order)
    G = rng.standard_normal((30, 30))
    B = G @ G.T + 30.0 * np.eye(30)
    dinv = np.tile((1.0 / np.diag(B))[:, None], (1, F)).astype(complex)
    lmax = np.array([1.1, 1.5, 2.0]) * np.abs(np.linalg.eigvalsh(
        B / np.diag(B)[:, None])).max()
    r = _cplx(rng, 30, F)
    Bt = torch.as_tensor(B.astype(complex))
    y = tksp._cheb4(lambda d: Bt @ d, torch.as_tensor(dinv),
                    torch.as_tensor(lmax), torch.as_tensor(r), order).numpy()
    Bj = jnp.asarray(B.astype(complex))
    y_j = jksp._cheb4(lambda d: Bj @ d, jnp.asarray(dinv), jnp.asarray(lmax),
                      jnp.asarray(r), order)
    assert _rel(y, np.asarray(y_j)) < 1e-12


@pytest.mark.parametrize("cplx", [False, True])
def test_lmax_est_matches_jax(cplx):
    n, jterms, _ = _terms("tet", 2)
    K, M = jterms[0].csr(n), jterms[1].csr(n)
    B = (K + 0.3 * M) if not cplx else (K - (0.3 + 0.02j) * M)
    ess = np.zeros(n, bool)
    ess[::7] = True
    lam = tksp._lmax_est(B.tocsr(), ess)
    assert abs(lam - jksp._lmax_est(B.tocsr(), ess)) <= 1e-12 * lam


@pytest.mark.parametrize("deficient", [False, True])
def test_hessenberg_lstsq_matches_jax(deficient):
    """Rank-deficient case: a column converged inside the cycle leaves
    zero subdiagonal and columns; both sides return the minimum-norm y."""
    m = 6
    rng = np.random.default_rng(int(deficient))
    H = np.triu(_cplx(rng, m + 1, m, F).transpose(2, 0, 1), -1).transpose(
        1, 2, 0)
    beta = np.abs(rng.standard_normal(F)) + 0.5
    if deficient:  # column 1 converged at step 3
        H[:, 3:, 1] = 0.0
    y = tksp._hessenberg_lstsq(H, beta)
    for f in range(F):
        e1 = np.zeros(m + 1, complex)
        e1[0] = beta[f]
        y_j = jnp.linalg.lstsq(jnp.asarray(H[:, :, f]), jnp.asarray(e1))[0]
        assert _rel(y[:, f], np.asarray(y_j)) < 1e-12
