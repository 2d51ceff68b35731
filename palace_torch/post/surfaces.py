"""Surface postprocessing: flux integrals and interface-dielectric loss
(reference: palace/models/surfacepostoperator.cpp,
palace/fem/coefficient.hpp:164-430).

Flux: Φ = ∫ F . n dS with F = ε E (Electric), B (Magnetic), or E x H (Power);
interior facets use the two-sided jump (charge) or average.  Interface
dielectric participation: thin-layer energy with the Wenner et al. (2011)
MA/MS/SA specializations; p = energy / (E_elec + E_cap), Q = 1/(p tan δ).

Copied from palace_tpu/post/surfaces.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from palace_torch.fem.evaluation import BoundaryTrace, trace_nd


def _domain_attrs(mesh, bucket, elem) -> np.ndarray:
    out = np.empty(len(elem), np.int32)
    for bi, b in enumerate(mesh.buckets):
        s = bucket == bi
        out[s] = b.attr[elem[s]]
    return out


def _eval_sides(sop, E, tr: BoundaryTrace, which="value"):
    """Field at trace qpoints on both sides: (vals1, vals2, has2, attr1, attr2)."""
    v1 = trace_nd(sop.space, E, tr, which=which)
    a1 = _domain_attrs(sop.mesh, tr.bucket, tr.elem)
    has2 = tr.elem2 >= 0
    v2 = np.zeros_like(v1)
    a2 = np.full(len(tr.elem), -1, np.int32)
    if has2.any():
        tr2 = tr.side2()
        v2[has2] = trace_nd(sop.space, E, tr2, which=which)
        a2[has2] = _domain_attrs(sop.mesh, tr2.bucket, tr2.elem)
    return v1, v2, has2, a1, a2


def _complex_eval(sop, E, tr, which):
    """Complex field at qpoints per side (evaluating re/im parts)."""
    if np.iscomplexobj(E):
        r1, r2, h2, a1, a2 = _eval_sides(sop, np.real(E).copy(), tr, which)
        i1, i2, _, _, _ = _eval_sides(sop, np.imag(E).copy(), tr, which)
        return r1 + 1j * i1, r2 + 1j * i2, h2, a1, a2
    return _eval_sides(sop, E, tr, which)


def surface_flux(sop, cfg, tr: BoundaryTrace, E: np.ndarray,
                 omega: Optional[float] = None, aB: Optional[np.ndarray] = None
                 ) -> complex:
    """One flux integral for a (possibly complex) E-dof vector.

    For Power flux in the frequency domain pass omega (B = -curl E/(i omega));
    in the time domain pass aB (B = -curl aB).
    """
    mats = sop.materials
    typ = cfg.type
    sdim = sop.mesh.nodes.shape[1]

    def jump_or_avg(F1, F2, has2):
        if cfg.two_sided:
            F = F1 - np.where(has2[:, None, None], F2, 0.0)
            return np.einsum("fq,fqs,fqs->", tr.wdetJ, F, -tr.normal)
        F = np.where(has2[:, None, None], 0.5 * (F1 + F2), F1)
        return np.einsum("fq,fqs,fqs->", tr.wdetJ, F, tr.normal)

    if typ == "Electric":
        v1, v2, has2, a1, a2 = _complex_eval(sop, E, tr, "value")
        d = v1.shape[-1]
        eps1 = mats.attr_tensor(mats.permittivity, a1)[:, :d, :d]
        eps2 = mats.attr_tensor(mats.permittivity,
                                np.where(a2 < 0, a1, a2))[:, :d, :d]
        F1 = np.einsum("fst,fqt->fqs", eps1, v1)
        F2 = np.einsum("fst,fqt->fqs", eps2, v2)
        return complex(jump_or_avg(F1, F2, has2))

    if typ == "Magnetic":
        c1, c2, has2, a1, a2 = _complex_eval(sop, E if aB is None else aB, tr,
                                             "curl")
        scale = (-1.0 / (1j * omega)) if omega is not None else -1.0
        return complex(jump_or_avg(c1 * scale, c2 * scale, has2))

    if typ == "Power":
        # Poynting E x H with H = mu^-1 B; stationary real part only
        # (reference: surfacepostoperator.cpp GetSurfaceFlux POWER branch
        # sums the re-re and im-im contributions).
        v1, v2, has2, a1, a2 = _complex_eval(sop, E, tr, "value")
        Ev = np.where(has2[:, None, None], 0.5 * (v1 + v2), v1)
        c1, c2, _, _, _ = _complex_eval(sop, E if aB is None else aB, tr, "curl")
        Bv = np.where(has2[:, None, None], 0.5 * (c1 + c2), c1)
        Bv = Bv * ((-1.0 / (1j * omega)) if omega is not None else -1.0)
        muinv = mats.attr_tensor(mats.inv_permeability, a1)
        total = 0.0
        for Ep, Bp in ((np.real(Ev), np.real(Bv)), (np.imag(Ev), np.imag(Bv))):
            if sdim == 2:
                H = muinv[:, 2, 2][:, None] * Bp[..., 0]
                S = np.stack([Ep[..., 1] * H, -Ep[..., 0] * H], axis=-1)
            else:
                H = np.einsum("fst,fqt->fqs", muinv, Bp)
                S = np.cross(Ep, H)
            total += float(np.einsum("fq,fqs,fqs->", tr.wdetJ, S, tr.normal))
        return complex(total, 0.0)

    raise ValueError(typ)


def interface_energy(sop, dcfg, tr: BoundaryTrace, E: np.ndarray) -> float:
    """Thin-layer interface dielectric energy (nondimensional).

    dcfg: InterfaceDielectricConfig with type MA|MS|SA|Default, thickness
    (nondim), permittivity, loss_tan (reference coefficient.hpp:370-470).
    """
    mats = sop.materials
    typ = dcfg.type
    t_i = dcfg.thickness
    eps_i = dcfg.permittivity

    # Vacuum-side detection via the material light speed (c=1 nondim vacuum).
    def is_vacuum(attrs):
        out = np.zeros(len(attrs), bool)
        for k, a in enumerate(attrs):
            if a < 0:
                continue
            mu = np.linalg.inv(mats.inv_permeability[int(a)])
            c2 = np.linalg.eigvalsh(
                np.linalg.inv(0.5 * (mu @ mats.permittivity[int(a)]
                                     + (mu @ mats.permittivity[int(a)]).T)))
            out[k] = np.sqrt(max(c2.max(), 0.0)) >= 1.0 - 1.0e-6
        return out

    total = 0.0
    parts = [np.real(E), np.imag(E)] if np.iscomplexobj(E) else [E]
    v1_all, v2_all, has2, a1, a2 = _eval_sides(sop, parts[0], tr, "value")
    vac1 = is_vacuum(a1)
    vac2 = is_vacuum(np.where(has2, a2, -1))

    for part in parts:
        v1, v2, h2, _, _ = _eval_sides(sop, part, tr, "value")
        if typ in ("MA", "SA"):
            use1 = vac1
            use2 = has2 & vac2
        elif typ == "MS":
            use1 = ~vac1
            use2 = has2 & ~vac2
        else:  # Default: average both sides
            use1 = np.ones(len(a1), bool)
            use2 = has2
        both = use1 & use2
        V = np.where(use1[:, None, None], v1, 0.0) \
            + np.where(use2[:, None, None], v2, 0.0)
        V = np.where(both[:, None, None], 0.5 * V, V)
        attr_used = np.where(use1, a1, np.where(use2, a2, -1))
        valid = (use1 | use2)[:, None]

        Vn = np.einsum("fqs,fqs->fq", V, tr.normal)
        if typ == "MA":
            dens = (t_i / eps_i) * Vn * Vn
        elif typ == "MS":
            eps_s = mats.attr_tensor(
                mats.permittivity, np.where(attr_used < 0, a1, attr_used))
            W = np.einsum("fst,fqt->fqs",
                          eps_s[:, :V.shape[-1], :V.shape[-1]], V)
            Wn = np.einsum("fqs,fqs->fq", W, tr.normal)
            dens = (t_i / eps_i) * Wn * Wn
        elif typ == "SA":
            Vt = V - Vn[..., None] * tr.normal
            dens = t_i * (eps_i * np.einsum("fqs,fqs->fq", Vt, Vt)
                          + Vn * Vn / eps_i)
        else:
            dens = t_i * eps_i * np.einsum("fqs,fqs->fq", V, V)
        total += 0.5 * float(np.sum(tr.wdetJ * dens * valid))
    return total
