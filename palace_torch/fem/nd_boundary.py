"""H(curl) boundary-facet forms (counterpart of palace_tpu/fem/nd_boundary.py):
Robin-type port/impedance/absorbing terms (c u_t, v_t)_dS, the second-order
absorbing surface-curl term (c n.curl u, n.curl v)_dS and excitation
right-hand sides (f, v)_dS, from the volume element's ND basis evaluated at
surface quadrature points and projected tangentially (host numpy)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.fem.evaluation import BoundaryTrace
from palace_torch.ops.partial import BucketTables


@dataclass
class NDTraceBasis:
    """Physical-frame ND basis values at boundary-trace quadrature points."""

    tr: BoundaryTrace
    Vt: np.ndarray  # (n, nq, nd, sdim) tangentially projected basis values
    V: np.ndarray  # (n, nq, nd, sdim) unprojected values
    dofs: np.ndarray  # (n, nd) global dofs of the adjacent volume element
    Cn: Optional[np.ndarray] = None  # (n, nq, nd) n . curl(basis)


def nd_trace_basis(space, tr: BoundaryTrace, with_curl: bool = False
                   ) -> NDTraceBasis:
    """The trace tables; `with_curl` adds the normal component of each
    basis function's curl (3D meshes)."""
    from palace_torch.utils import smallmat

    mesh = space.mesh
    n, nq = tr.wdetJ.shape
    sdim = mesh.nodes.shape[1]
    nd = space.elem_dofs[0].shape[1]
    V = np.zeros((n, nq, nd, sdim))
    Cn = np.zeros((n, nq, nd)) if with_curl else None
    dofs = np.zeros((n, nd), np.int64)
    for bi, b in enumerate(mesh.buckets):
        sel = np.where(tr.bucket == bi)[0]
        if len(sel) == 0:
            continue
        xis = tr.xi[sel].reshape(-1, tr.xi.shape[-1])
        Vr, Cr = space.basis_tables(b.geom, xis)  # (n_sel*nq, nd, rdim)
        Vr = Vr.reshape(len(sel), nq, -1, Vr.shape[-1])
        gb = ref.gmsh_geometry_basis(b.etype)
        Gg = gb.eval_grad(xis).reshape(len(sel), nq, -1, xis.shape[-1])
        X = mesh.nodes[b.conn[tr.elem[sel]]]
        J = np.einsum("ens,enqr->eqsr", X, Gg.transpose(0, 2, 1, 3))
        Jinv = smallmat.inv(J)
        # Covariant transform u_phys = J^{-T} u_ref, orientation signs folded.
        V[sel] = np.einsum("eqrs,eqnr->eqns", Jinv, Vr)
        sg = getattr(space, "elem_signs", None)
        sgsel = (sg[bi][tr.elem[sel]]
                 if sg is not None and sg[bi] is not None else None)
        if sgsel is not None:
            V[sel] *= sgsel[:, None, :, None]
        if with_curl and sdim == 3:
            # Contravariant curl: curl u = J curl_ref u_ref / det J.
            Cr = Cr.reshape(len(sel), nq, -1, Cr.shape[-1])
            cphys = np.einsum("eqsr,eqnr->eqns", J, Cr) \
                / smallmat.det(J)[..., None, None]
            cn = np.einsum("eqns,eqs->eqn", cphys, tr.normal[sel])
            Cn[sel] = cn * sgsel[:, None, :] if sgsel is not None else cn
        dofs[sel] = space.elem_dofs[bi][tr.elem[sel]]
    nrm = tr.normal  # (n, nq, sdim)
    Vt = V - np.einsum("fqs,fqn->fqns", nrm, np.einsum("fqns,fqs->fqn", V, nrm))
    return NDTraceBasis(tr, Vt, V, dofs, Cn)


def boundary_curl_bucket(tb: NDTraceBasis, coef: np.ndarray) -> BucketTables:
    """Facet matrices A_f[n,m] = sum_q w c_f (n.curl u)(n.curl v), the
    surface-curl term of the second-order absorbing boundary (reference:
    palace/models/farfieldboundaryoperator.cpp); coef is per facet (n,)."""
    A = np.einsum("fq,f,fqn,fqm->fnm", tb.tr.wdetJ, coef, tb.Cn, tb.Cn,
                  optimize=True)
    return BucketTables(gidx=tb.dofs, A=A)


def boundary_mass_bucket(tb: NDTraceBasis, coef: np.ndarray) -> BucketTables:
    """Facet matrices A_f[n,m] = sum_q w c_f (u_t . v_t) as an extra operator
    bucket; coef is a per-facet scalar (n,) or tensor (n, sdim, sdim)."""
    w = tb.tr.wdetJ
    if coef.ndim == 1:
        A = np.einsum("fq,f,fqns,fqms->fnm", w, coef, tb.Vt, tb.Vt, optimize=True)
    else:
        cu = np.einsum("fst,fqmt->fqms", coef, tb.Vt)
        A = np.einsum("fq,fqns,fqms->fnm", w, tb.Vt, cu, optimize=True)
    return BucketTables(gidx=tb.dofs, A=A)


def boundary_rhs(tb: NDTraceBasis, fvals: np.ndarray, num_dofs: int,
                 tangential: bool = False) -> np.ndarray:
    """rhs[n] = sum_f sum_q w f(x_q) . v_n over the trace facets (v_n
    tangentially projected if `tangential`); fvals: (n, nq, sdim) field
    values at the trace quadrature points."""
    contrib = np.einsum("fq,fqs,fqns->fn", tb.tr.wdetJ, fvals,
                        tb.Vt if tangential else tb.V, optimize=True)
    out = np.zeros(num_dofs, fvals.dtype if fvals.dtype.kind == "c" else float)
    np.add.at(out, tb.dofs.ravel(), contrib.ravel())
    return out
