"""Eigenmode driver (counterpart of palace_tpu/drivers/eigenmode.py; reference:
palace/drivers/eigensolver.cpp): the damped Maxwell eigenproblem
(K + lam C + lam^2 M) x = 0 with lam = i omega, and the linear pencil
K x = omega^2 M x when there is no damping.

The lossless linear branch runs block Lanczos on the run's device
(`linalg/device_eig.py:device_shift_invert_eigs`) when the configuration
selects the iterative solver (`use_device_ksp`); otherwise the host
shift-invert ARPACK branch runs (`linalg/eig.py:shift_invert_eigs`), which
also takes a lossy (complex) permittivity.  Damping (domain conductivity,
impedance Rs/Ls, lumped-port R, first-order absorbing boundaries) makes C
nonzero: the quadratic branch runs the host subspace solver
`quadratic_eigs_jd`, seeded with lossless modes (and, under strong
damping, with the modes of the damped surfaces held at zero), on the
pencil projected off its gradients (the div-free data, H1 constrained on
`SpaceOperator.aux_bdr_attrs`), and falls back to the companion ARPACK
iteration `quadratic_eigs` when it does not converge.  Wave ports and
second-order absorbing boundaries make the problem nonlinear in omega:
A2(omega) is interpolated by a quadratic Newton polynomial on
[i omega_t, i omega_u] into the pencil, and each pair found is refined by
fixed point against the true A2.  With Model/Refinement/MaxIts > 0 the
solve runs inside the AMR loop on tets (`drivers/amr.py`); hex-mesh AMR
raises NotImplementedError naming its ROADMAP item.  A FloquetWaveVector
adds the Bloch terms Fm + i Fc to K (complex Hermitian): those pencils run
host shift-invert ARPACK with `which="LR"`, keep only modes at or above the
target (which drops the spurious gradient band), and add the Floquet part
of the magnetic energy and the Floquet correction of the indicators.

Deliberate divergence from the JAX package: only the non-convergence the
ARPACK fallback exists for is caught (`quadratic_eigs_jd` returning None,
ARPACK's no-convergence error from a seed); any other exception of the
damped path propagates, where palace_tpu catches every exception and
falls back quietly.  The path taken is in the provenance (`eigen_path`,
`jd_attempts`, `jd_strong_seed`, `divfree`, and for the nonlinear branch
`nonlinear_harvest_rounds` and `nonlinear_refine_iterations`).

Eigenvectors are normalized to unit M-norm so the per-mode electric field
energy is 1/2 nondimensional (reference: palace/linalg/slepc.cpp:470-510);
the run writes eig.csv, domain-E.csv, lumped-port tables, surface-F.csv
and surface-Q.csv (SurfaceFlux, Dielectric), farfield-rE.csv (FarField,
Stratton-Chu at the complex omega), error-indicators.csv, palace.json
and, with `Save` > 0, the ParaView mode fields.  As in the driven driver,
an exception on the device path propagates: there is no quiet host
re-solve.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch
from scipy.sparse.linalg import ArpackNoConvergence

from palace_torch.config import IoData, ValueType
from palace_torch.drivers.common import (
    make_output_dir, prepare_mesh, print_log, write_error_indicators,
)
from palace_torch.drivers.amr import adapt_loop, refuse_hex_amr
from palace_torch.drivers.driven import _energy, use_device_ksp
from palace_torch.linalg.eig import (quadratic_eigs, quadratic_eigs_jd,
                                     shift_invert_eigs)
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.post.tables import Column, Table, index_column
from palace_torch.utils import provenance, timers


def _check_unported(iodata: IoData):
    """Refuse, before any work, what palace_tpu's eigenmode driver
    refuses."""
    b = iodata.boundaries
    if b.conductivities:
        # As in palace_tpu (and the reference for non-PEP solvers).
        raise NotImplementedError(
            "conductivity boundaries make the eigenproblem nonlinear in "
            "omega (reference rejects this for non-PEP solvers too)")


def _funcA2(sop: SpaceOperator, omega: float):
    """A2(omega) of the eigenproblem: the wave-port and second-order
    absorbing terms, or None."""
    parts = [a for a in (sop.waveport_a2_csr(omega), sop.abc2_a2_csr(omega))
             if a is not None]
    if not parts:
        return None
    out = parts[0]
    for a in parts[1:]:
        out = (out + a).tocsr()
    return out


def newton_a2_pencil(sop: SpaceOperator, omega_t: float, omega_u: float,
                     Kcsr, Ccsr, Mcsr):
    """Fold A2(lam) ~ P0 + lam P1 + lam^2 P2 (the quadratic Newton
    polynomial through i omega_t, i (omega_t + omega_u) / 2, i omega_u; the
    reference's HYBRID interpolation, nleps.cpp
    NewtonInterpolationOperator) into (K, C, M); returns (K, C, M, A2 at
    omega_t), or the pencil unchanged and None without A2 terms."""
    probe = _funcA2(sop, omega_t)
    if probe is None:
        return Kcsr, Ccsr, Mcsr, None
    pts = [1j * omega_t, 1j * 0.5 * (omega_t + omega_u), 1j * omega_u]
    S = [probe, _funcA2(sop, 0.5 * (omega_t + omega_u)),
         _funcA2(sop, omega_u)]
    d01 = (S[1] - S[0]) * (1.0 / (pts[1] - pts[0]))
    d12 = (S[2] - S[1]) * (1.0 / (pts[2] - pts[1]))
    d012 = (d12 - d01) * (1.0 / (pts[2] - pts[0]))
    P2 = d012
    P1 = d01 - (pts[0] + pts[1]) * d012
    P0 = S[0] - pts[0] * d01 + pts[0] * pts[1] * d012
    return ((Kcsr + P0).tocsr(),
            (P1 if Ccsr is None else Ccsr + P1).tocsr(),
            (Mcsr + P2).tocsr(), probe)


def divfree_data(iodata: IoData, sop: SpaceOperator):
    """(G, M_re) of the damped pencil's div-free projection, with the H1
    space held Dirichlet on `aux_bdr_attrs` (reference:
    eigensolver.cpp:204-218, spaceoperator.cpp:193-204), and a note of why
    it is or is not built; off with Floquet terms or London depths, as in
    palace_tpu (eigensolver.cpp:204-218)."""
    from palace_torch.fem.h1 import H1Space
    from palace_torch.fem.nd_operators import nd_h1_gradient

    if sop.K_flo_mass is not None:
        return None, "off: Floquet terms"
    if any(abs(l) > 0 for l in sop.materials.london_depth.values()):
        return None, "off: London penetration depths"
    try:
        h1 = H1Space(sop.mesh, iodata.solver.order)
        G = nd_h1_gradient(sop.space, h1).tocsr()
        aux = sop.aux_bdr_attrs()
        if aux:
            bdr = np.asarray(h1.boundary_dofs(aux), np.int64)
            G = G[:, np.setdiff1d(np.arange(G.shape[1]), bdr)].tocsr()
    except (NotImplementedError, RuntimeError) as e:
        return None, f"off: {e!r}"
    return ((G, sop._csr(sop._combine(sop.M_re, []))),
            f"built: {G.shape[1]} H1 columns, Dirichlet on {aux}")


def _damped_jd(iodata, Kcsr, Ccsr, Mcsr, ess, omega_t, attempt, divfree):
    """One JD attempt of the damped branch (palace_tpu/drivers/
    eigenmode.py:144-193): the lossless seed (doubled on attempt 1), the
    PEC-seeded second seed under strong damping (median C / (omega M) > 10
    on the damped dofs), then `quadratic_eigs_jd`.  Returns (result or
    None, strong); a seed's ARPACK no-convergence gives None."""
    cfg = iodata.solver.eigenmode
    nev = max(cfg.n, 1)
    Kre = (Kcsr.real if np.iscomplexobj(Kcsr.data) else Kcsr).tocsr()
    Mre = (Mcsr.real if np.iscomplexobj(Mcsr.data) else Mcsr).tocsr()
    k_seed = min((nev + 8) << attempt, Kcsr.shape[0] // 4)
    cd = np.abs(np.asarray(Ccsr.diagonal()))
    damped = np.where(cd > 1e-12 * cd.max())[0] if cd.max() > 0 \
        else np.zeros(0, np.int64)
    md = np.abs(np.asarray(Mcsr.diagonal()))[damped]
    strong = bool(len(damped) and np.median(
        cd[damped] / np.maximum(omega_t * md.real, 1e-300)) > 10.0)
    try:
        X0 = shift_invert_eigs(Kre, Mre, ess, omega_t ** 2, k_seed,
                               tol=min(cfg.tol, 1e-9)).eigenvectors
        if strong:
            ess2 = np.union1d(ess, damped)
            if len(ess2) < Kcsr.shape[0] - 4 * k_seed:
                seed2 = shift_invert_eigs(Kre, Mre, ess2, omega_t ** 2,
                                          k_seed, tol=min(cfg.tol, 1e-9))
                X0 = np.concatenate([X0, seed2.eigenvectors], axis=1)
    except ArpackNoConvergence as e:
        print_log(iodata, f"quadratic JD seed did not converge ({e})")
        return None, strong
    return quadratic_eigs_jd(
        Kcsr, Ccsr, Mcsr, ess, 1j * omega_t, nev + 4 + 8 * attempt, X0,
        tol=cfg.tol, divfree=divfree, log=lambda s: print_log(iodata, s),
        # The tight polish refactorizes P(lam) per RQI step: affordable
        # below 150,000 reduced dofs, as in palace_tpu.
        polish_tol=(min(cfg.tol * 1e-4, 1e-10) if Kcsr.shape[0] < 150_000
                    else None),
        n_polish=cfg.n + 2), strong


def _refine_nonlinear(iodata, sop, ess, omega, vecs, res, bkwd):
    """Fixed point of each interpolated pair against the true A2: freeze
    A2 at the pair's Re omega, re-solve the pencil seeded with the pair
    (`quadratic_eigs_jd`, one vector; `quadratic_eigs` when it returns
    None), repeat until omega moves by less than max(Tol, 1e-9), at most
    12 times (palace_tpu/drivers/eigenmode.py:292-338; its floor of 1e-10
    on the inner tolerance is inherited).  Updates the arrays in place and
    returns the iterations per pair."""
    cfg = iodata.solver.eigenmode
    K0, C0, M0 = sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr()
    iters = []
    for i in range(len(omega)):
        om, x = omega[i], vecs[:, i]
        rr = j = None
        for it in range(12):
            A2f = _funcA2(sop, float(np.real(om)))
            Kf = (K0 + A2f).tocsr()
            Cf = (C0 + 0 * A2f).tocsr() if C0 is not None else \
                (0 * A2f).tocsr()
            rr = quadratic_eigs_jd(Kf, Cf, M0, ess, 1j * om, 1, x[:, None],
                                   tol=max(cfg.tol, 1e-10), max_rounds=6,
                                   log=lambda s: print_log(iodata, s))
            if rr is None:
                rr = quadratic_eigs(Kf, Cf, M0, ess, 1j * om, 4, tol=cfg.tol)
            omr = -1j * rr.eigenvalues
            j = int(np.argmin(np.abs(omr - om)))
            dw = abs(omr[j] - om) / max(abs(om), 1e-30)
            om, x = omr[j], rr.eigenvectors[:, j]
            if dw < max(cfg.tol, 1e-9):
                break
        iters.append(it + 1)
        omega[i], vecs[:, i] = om, x
        res[i], bkwd[i] = rr.residuals[j], rr.backward_errors[j]
    return iters


def _harvest(iodata, Kcsr, Ccsr, Mcsr, ess, omega_t, omega, vecs, res, bkwd):
    """The interpolated pencil's reach around the shift is limited: while
    fewer than N physical pairs are found, harvest candidates from a
    second pencil solve targeted above the highest mode so far (at most 3
    rounds; palace_tpu/drivers/eigenmode.py:266-290).  Returns the grown
    arrays; records the rounds taken."""
    cfg = iodata.solver.eigenmode
    nev = max(cfg.n, 1)
    rounds = 0
    if len(omega) < cfg.n:
        sig2 = 1.15 * (np.real(omega).max() if len(omega) else omega_t)
        for _ in range(3):
            rounds += 1
            r2 = quadratic_eigs(Kcsr, Ccsr, Mcsr, ess, 1j * sig2,
                                2 * nev + 8, tol=cfg.tol)
            om2 = -1j * r2.eigenvalues
            k2 = ((np.real(om2) > omega_t)
                  & (np.imag(om2) > -1e-2 * abs(omega_t)))
            fresh = [j for j in np.where(k2)[0]
                     if all(abs(om2[j] - o) > 1e-6 * abs(o) for o in omega)]
            if fresh:
                fr = sorted(fresh, key=lambda j: np.real(om2[j]))
                fr = fr[: cfg.n - len(omega)]
                omega = np.concatenate([omega, om2[fr]])
                vecs = np.concatenate([vecs, r2.eigenvectors[:, fr]], axis=1)
                res = np.concatenate([res, r2.residuals[fr]])
                bkwd = np.concatenate([bkwd, r2.backward_errors[fr]])
            if len(omega) >= cfg.n:
                break
            sig2 *= 1.2
    provenance.record("nonlinear_harvest_rounds", rounds)
    return omega, vecs, res, bkwd


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    t0 = time.time()
    _check_unported(iodata)
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    refuse_hex_amr(iodata, mesh, "Eigenmode")
    post_dir = make_output_dir(iodata, output_dir)
    units = iodata.units
    cfg = iodata.solver.eigenmode

    def solve_and_estimate(m):
        setup0 = timers.seconds("Operator construction", "  Setup")
        solve0 = timers.seconds("Eigenvalue solve")
        with timers.block("Operator construction"):
            sop = SpaceOperator(iodata, m, device=device)
            space = sop.space
            Kcsr = sop.stiffness_csr()
            Ccsr = sop.damping_csr()
            Mcsr = sop.mass_csr()
        print_log(iodata, f"eigenmode: {space.num_dofs} dofs, "
                          f"{m.num_elements} elements, device {device}")
        ess = np.where(sop.ess_mask)[0]

        f_t = units.nondimensionalize(ValueType.FREQUENCY, cfg.target)
        omega_t = 2 * np.pi * f_t
        nev = max(cfg.n, 1)

        # Frequency-dependent boundary terms (wave ports, second-order
        # absorbing) make the problem nonlinear in omega: interpolate them
        # into the quadratic pencil on [i omega_t, i omega_u].
        with timers.block("Operator construction"):
            f_u = cfg.target_upper
            omega_u = 2 * np.pi * units.nondimensionalize(
                ValueType.FREQUENCY, f_u if f_u > 0 else 3 * cfg.target)
            Kcsr, Ccsr, Mcsr, probeA2 = newton_a2_pencil(
                sop, omega_t, omega_u, Kcsr, Ccsr, Mcsr)
        damped = Ccsr is not None and abs(Ccsr).max() > 0
        divfree = None
        if damped:
            with timers.block("Operator construction"):
                divfree, note = divfree_data(iodata, sop)
            provenance.record("divfree", note)
        # Request extra vectors (the gradient-nullspace cluster at
        # lambda = 0 is filtered below); grow the subspace and retry if the
        # filter leaves fewer than the n requested physical modes.
        extra = 8
        # Floquet terms make K complex Hermitian: they stay on the host
        # shift-invert branch, as in palace_tpu.
        floquet = sop.K_flo_mass is not None
        lossless_linear = (probeA2 is None and sop.M_im is None
                           and not floquet)
        for attempt in range(3):
            k_req = 2 * nev + extra
            with timers.block("Eigenvalue solve"):
                if damped:
                    # The JD fast path first (twice, the second time with
                    # doubled seeds), the companion ARPACK iteration when
                    # it does not converge (reference: SLEPc PEP/TOAR,
                    # eigensolver.cpp:98-155).
                    result = None
                    if attempt <= 1:
                        provenance.record("jd_attempts", attempt + 1)
                        result, strong = _damped_jd(
                            iodata, Kcsr, Ccsr, Mcsr, ess, omega_t, attempt,
                            divfree)
                        provenance.record("jd_strong_seed", strong)
                    if result is not None:
                        provenance.record("eigen_path", "quadratic-jd")
                    else:
                        result = quadratic_eigs(Kcsr, Ccsr, Mcsr, ess,
                                                1j * omega_t, k_req,
                                                tol=cfg.tol, divfree=divfree)
                        provenance.record("eigen_path", "quadratic-arpack")
                    omega = -1j * result.eigenvalues  # lam = i omega
                elif lossless_linear and use_device_ksp(iodata,
                                                        space.num_dofs):
                    from palace_torch.linalg.device_eig import (
                        device_shift_invert_eigs)

                    result = device_shift_invert_eigs(
                        space, list(iodata.boundaries.pec),
                        sop._combine(sop.K_dom, sop.K_bdr),
                        sop._combine(sop.M_re, sop.M_bdr),
                        sop.ess_mask, omega_t ** 2, k_req, tol=cfg.tol,
                        nconv=min(k_req, cfg.n + 4),
                        log=lambda s: print_log(iodata, s), device=device)
                    info = device_shift_invert_eigs.last_info
                    provenance.record("eigen_path", "device-lanczos")
                    provenance.record("fine_level", info["fine_level"])
                    if info["parallel"] is not None:
                        provenance.record("parallel", info["parallel"])
                    provenance.record("lanczos_restarts", info["restarts"])
                    provenance.record("ksp_iterations",
                                      info["ksp_iterations"])
                else:
                    result = shift_invert_eigs(
                        Kcsr, Mcsr, ess, omega_t ** 2, k_req, tol=cfg.tol,
                        which="LR" if floquet else "LM")
                    provenance.record("eigen_path", "host-arpack")
                if not damped:
                    omega = np.sqrt(result.eigenvalues.astype(complex))
            keep = (np.real(omega) > max(1e-8, 1e-3 * abs(omega_t)))
            if floquet:
                # The reference's shift-invert keeps the interval [sigma,
                # inf) (slepc.cpp:432-445): modes below the target go,
                # and with them the Floquet spurious gradient band
                # (lambda <= 2 k^T mu^-1 k / eps).
                keep &= (np.real(omega) >= omega_t * (1.0 - 1e-9))
            if probeA2 is not None:
                # The interpolated pencil sprays spurious anti-damped
                # modes; keep the physical branch above the target
                # (reference: nleps.cpp:786 Im lam > Im sigma).
                keep &= (np.real(omega) > omega_t)
                keep &= (np.imag(omega) > -1e-2 * abs(omega_t))
            if keep.sum() >= cfg.n or 2 * nev + extra > Kcsr.shape[0] // 4:
                break
            extra = 2 * extra + 2 * nev

        # Drop the gradient-nullspace cluster near omega = 0 (the role of
        # the div-free projection, reference: palace/linalg/divfree.hpp),
        # sort ascending Re(omega), keep n.
        omega = omega[keep]
        order = np.argsort(np.real(omega))[: cfg.n]
        vecs = result.eigenvectors[:, keep][:, order]
        res = result.residuals[keep][order]
        bkwd = result.backward_errors[keep][order]
        omega = omega[order]

        if probeA2 is not None:
            with timers.block("Eigenvalue solve"):
                omega, vecs, res, bkwd = _harvest(
                    iodata, Kcsr, Ccsr, Mcsr, ess, omega_t, omega, vecs, res,
                    bkwd)
                iters = _refine_nonlinear(iodata, sop, ess, omega, vecs,
                                          res, bkwd)
            provenance.record("nonlinear_refine_iterations", iters)
            order = np.argsort(np.real(omega))
            omega, vecs = omega[order], vecs[:, order]
            res, bkwd = res[order], bkwd[order]
        if iodata.model.refinement.max_it > 0:
            prov = provenance.snapshot()
            ghz = omega * units.scale_factor(ValueType.FREQUENCY) / (
                2 * np.pi)
            provenance.append("amr_passes", dict(
                elements=m.num_elements, dofs=space.num_dofs,
                setup_s=timers.seconds("Operator construction", "  Setup")
                - setup0, solve_s=timers.seconds("Eigenvalue solve") - solve0,
                eigen_path=prov.get("eigen_path"),
                fine_level=prov.get("fine_level"),
                re_f_ghz=[float(f.real) for f in ghz], im_f_ghz=[
                    float(f.imag) for f in ghz]))

        # Curl-flux error indicators per mode, normalized by the mode
        # energy (unit M-norm: E_elec = 1/4 -> total E = 1/2).
        from palace_torch.fem.estimators import (
            curl_flux_indicators, grad_flux_indicators)

        eta2, energies = [], []
        is_2d = space.mesh.nodes.shape[1] == 2
        with timers.block("Postprocessing"):
            for i in range(len(omega)):
                x = vecs[:, i]
                mnorm2 = abs(np.real(np.conj(x) @ (Mcsr @ x)))
                x = x / math.sqrt(mnorm2)
                vecs[:, i] = x
                # Combined grad + curl flux indicators with B = -i/omega
                # curl E (reference: eigensolver.cpp:339-343), Et the mode's
                # total energy.  On a 2D mesh the grad part alone and E_mag
                # 0, as in palace_tpu (the reference's 2D B is ~0).
                e2 = (np.zeros(space.mesh.num_elements) if is_2d else
                      curl_flux_indicators(
                          space, sop.materials, x, floquet_k=sop.floquet_k,
                          device=device) / abs(omega[i]) ** 2)
                try:
                    e2 = e2 + grad_flux_indicators(space, sop.materials, x,
                                                   device=device)
                except NotImplementedError:
                    pass  # RT on hex/prism meshes: curl-only indicators
                eta2.append(e2)
                E_elec = 0.5 * _quad(sop.M_re, x)
                E_mag = 0.0 if is_2d else 0.5 * (
                    _quad(sop.K_dom, x) + sop.floquet_mag_quad(
                        x, abs(omega[i]))) / abs(omega[i]) ** 2
                E_cap = E_ind = 0.0
                for idx, port in sop.ports.items():
                    s, v = sop.port_functionals(idx)
                    Vp = complex(np.dot(v, x))
                    if abs(port.C) > 0:
                        E_cap += 0.5 * abs(port.C) * float(
                            np.real(Vp * np.conj(Vp)))
                    if abs(port.L) > 0:
                        Ip = Vp / port.characteristic_impedance(
                            float(np.real(omega[i])), "L")
                        E_ind += 0.5 * abs(port.L) * float(
                            np.real(Ip * np.conj(Ip)))
                energies.append(E_elec + E_mag + E_cap + E_ind)
        return ((sop, Kcsr, Ccsr, Mcsr, omega, vecs, res, bkwd), eta2,
                energies, space.num_dofs)

    ((sop, Kcsr, Ccsr, Mcsr, omega, vecs, res, bkwd), eta_elem, _, mesh,
     n_adapt) = adapt_loop(iodata, mesh, solve_and_estimate,
                           post_dir=post_dir)
    space = sop.space

    with timers.block("Postprocessing"):
        ghz = units.scale_factor(ValueType.FREQUENCY)
        f = omega / (2 * np.pi) * ghz
        t = Table()
        t.add(index_column("m"))
        t.add(Column("refreq", "Re{f} (GHz)"))
        t.add(Column("imfreq", "Im{f} (GHz)"))
        t.add(Column("q", "Q"))
        t.add(Column("err_bkwd", "Error (Bkwd.)"))
        t.add(Column("err_abs", "Error (Abs.)"))
        for i in range(len(omega)):
            fi = f[i]
            Q = (abs(fi) / (2 * fi.imag)) if fi.imag != 0 else np.inf
            t.col("i").data.append(float(i + 1))
            t.col("refreq").data.append(fi.real)
            t.col("imfreq").data.append(fi.imag)
            t.col("q").data.append(Q if np.isfinite(Q) else 0.0)
            t.col("err_bkwd").data.append(bkwd[i])
            t.col("err_abs").data.append(res[i])
        t.write(os.path.join(post_dir, "eig.csv"))

        # Normalize to unit M-norm.
        modes = []
        for i in range(len(omega)):
            x = vecs[:, i]
            mnorm2 = abs(np.real(np.conj(x) @ (Mcsr @ x)))
            modes.append(x / math.sqrt(mnorm2))

        _write_domain_energy(iodata, sop, post_dir, omega, modes)
        if sop.ports:
            _write_port_tables(iodata, sop, post_dir, omega, modes)
        if iodata.boundaries.surface_fluxes or iodata.boundaries.dielectrics:
            _write_surface_tables(iodata, sop, post_dir, omega, modes)
        with timers.block("  Far fields"):
            _write_farfield_eigen(iodata, sop, post_dir, omega, modes)
        if iodata.problem.output_formats.paraview and cfg.n_post > 0 \
                and modes:
            from palace_torch.drivers.driven import nodal_field
            from palace_torch.post.paraview import ParaviewSaver

            with timers.block("  Paraview"):
                pv = ParaviewSaver(post_dir, "eigenmode", mesh)
                for i in range(min(cfg.n_post, len(modes))):
                    Ev = nodal_field(space, modes[i])
                    pv.save(float(i + 1),
                            {"E_real": np.real(Ev), "E_imag": np.imag(Ev)})
                pv.finalize()
        write_error_indicators(post_dir, [eta_elem**2], [None])
    from palace_torch.post import metadata

    metadata.save_problem(post_dir, "Eigenmode", mesh.num_elements,
                          space.num_dofs)
    metadata.save_timing(post_dir)
    print_log(iodata, f"eigenmode done in {time.time() - t0:.1f}s; "
                      f"f[0] = {f[0].real:.6f} GHz" if len(f) else "no modes")
    return dict(frequencies_ghz=f, post_dir=post_dir, num_dofs=space.num_dofs,
                modes=np.stack(modes, axis=1) if modes else None,
                residuals=res, backward_errors=bkwd, sop=sop,
                amr_iterations=n_adapt, provenance=provenance.snapshot())


def _write_domain_energy(iodata, sop, post_dir, omega, modes):
    units = iodata.units
    Escale = units.scale_factor(ValueType.ENERGY)
    td = Table()
    td.add(index_column("m"))
    td.add(Column("Ee", "E_elec (J)"))
    td.add(Column("Em", "E_mag (J)"))
    td.add(Column("Ec", "E_cap (J)"))
    td.add(Column("Ei", "E_ind (J)"))
    for ecfg in iodata.domains.energies:
        td.add(Column(f"Ee{ecfg.index}", f"E_elec[{ecfg.index}] (J)"))
        td.add(Column(f"pe{ecfg.index}", f"p_elec[{ecfg.index}]"))
        td.add(Column(f"Em{ecfg.index}", f"E_mag[{ecfg.index}] (J)"))
        td.add(Column(f"pm{ecfg.index}", f"p_mag[{ecfg.index}]"))
    # 2D: E_mag 0, palace_tpu's convention (its committed 2D references
    # have E_mag ~ 1e-16; KNOWN_GAPS.md "2D E_mag"), and p_mag 1.
    is_2d = sop.mesh.nodes.shape[1] == 2
    for i in range(len(omega)):
        x = modes[i]
        Ee = 0.5 * _quad(sop.M_re, x)
        Em = 0.0 if is_2d else 0.5 * (_quad(sop.K_dom, x) + sop.floquet_mag_quad(
            x, abs(omega[i]))) / abs(omega[i]) ** 2
        Ec = Ei = 0.0
        for idx, port in sop.ports.items():
            s, v = sop.port_functionals(idx)
            V = complex(np.dot(v, x))
            if abs(port.L) > 0:
                I = V / port.characteristic_impedance(np.real(omega[i]), "L")
                Ei += 0.5 * abs(port.L) * float(np.real(I * np.conj(I)))
            if abs(port.C) > 0:
                Ec += 0.5 * abs(port.C) * float(np.real(V * np.conj(V)))
        td.col("i").data.append(float(i + 1))
        td.col("Ee").data.append(Ee * Escale)
        td.col("Em").data.append(Em * Escale)
        td.col("Ec").data.append(Ec * Escale)
        td.col("Ei").data.append(Ei * Escale)
        for ecfg in iodata.domains.energies:
            EeA = 0.5 * _masked_quad(sop.M_re, x, ecfg.attributes)
            EmA = 0.0 if is_2d else 0.5 * (
                _masked_quad(sop.K_dom, x, ecfg.attributes)
                + sop.floquet_mag_quad(x, abs(omega[i]), ecfg.attributes)
            ) / abs(omega[i]) ** 2
            td.col(f"Ee{ecfg.index}").data.append(EeA * Escale)
            td.col(f"pe{ecfg.index}").data.append(EeA / Ee if Ee > 0 else 0.0)
            td.col(f"Em{ecfg.index}").data.append(EmA * Escale)
            td.col(f"pm{ecfg.index}").data.append(
                EmA / Em if Em > 0 else (1.0 if is_2d else 0.0))
    td.write(os.path.join(post_dir, "domain-E.csv"))


def _write_surface_tables(iodata, sop, post_dir, omega, modes):
    """surface-F.csv / surface-Q.csv per eigenmode (reference:
    postoperatorcsv.cpp PrintSurfaceF/PrintSurfaceQ with the "m" index
    column in the eigenmode branch; measurements via postoperator.cpp
    MeasureSurfaceFlux / MeasureInterfaceEFieldEnergy)."""
    from palace_torch.drivers.driven import build_surface_traces, dielectric_pq
    from palace_torch.post.surfaces import surface_flux

    units = iodata.units
    traces = build_surface_traces(iodata, sop)
    fluxes = iodata.boundaries.surface_fluxes
    diels = iodata.boundaries.dielectrics

    if fluxes:
        Qc = units.scale_factor(ValueType.CAPACITANCE) * units.scale_factor(
            ValueType.VOLTAGE)
        Wb = units.scale_factor(ValueType.INDUCTANCE) * units.scale_factor(
            ValueType.CURRENT)
        W = units.scale_factor(ValueType.POWER)
        t = Table()
        t.add(index_column("m"))
        for fcfg in fluxes:
            i = fcfg.index
            if fcfg.type == "Electric":
                t.add(Column(f"fr{i}", f"Re{{Φ_elec[{i}]}} (C)"))
                t.add(Column(f"fi{i}", f"Im{{Φ_elec[{i}]}} (C)"))
            elif fcfg.type == "Magnetic":
                t.add(Column(f"fr{i}", f"Re{{Φ_mag[{i}]}} (Wb)"))
                t.add(Column(f"fi{i}", f"Im{{Φ_mag[{i}]}} (Wb)"))
            else:
                t.add(Column(f"fr{i}", f"Φ_pow[{i}] (W)"))
        for i in range(len(omega)):
            t.col("i").data.append(float(i + 1))
            om = abs(float(np.real(omega[i])))
            for fcfg in fluxes:
                v = surface_flux(sop, fcfg, traces["flux"][fcfg.index],
                                 modes[i], omega=om)
                scale = {"Electric": Qc, "Magnetic": Wb, "Power": W}[fcfg.type]
                t.col(f"fr{fcfg.index}").data.append(v.real * scale)
                if fcfg.type != "Power":
                    t.col(f"fi{fcfg.index}").data.append(v.imag * scale)
        t.write(os.path.join(post_dir, "surface-F.csv"))

    if diels:
        t = Table()
        t.add(index_column("m"))
        for d in diels:
            t.add(Column(f"p{d.index}", f"p_surf[{d.index}]"))
            t.add(Column(f"q{d.index}", f"Q_surf[{d.index}]"))
        for i in range(len(omega)):
            x = modes[i]
            Ee = 0.5 * _quad(sop.M_re, x)
            E_cap = 0.0
            for idx, port in sop.ports.items():
                if abs(port.C) > 0:
                    s, v = sop.port_functionals(idx)
                    V = complex(np.dot(v, x))
                    E_cap += 0.5 * abs(port.C) * float(np.real(V * np.conj(V)))
            denom = Ee + E_cap
            t.col("i").data.append(float(i + 1))
            for d in diels:
                p, Q = dielectric_pq(iodata, sop, d, traces["eps"][d.index],
                                     x, denom)
                t.col(f"p{d.index}").data.append(p)
                # palace_tpu's eigenmode table writes 0 for an infinite Q
                # (its driven table writes inf).
                t.col(f"q{d.index}").data.append(Q if np.isfinite(Q) else 0.0)
        t.write(os.path.join(post_dir, "surface-Q.csv"))


def _write_farfield_eigen(iodata, sop, post_dir, omega, modes):
    """farfield-rE.csv per eigenmode (reference: postoperatorcsv.cpp
    InitializeFarFieldE/PrintFarFieldE EIGENMODE branch: m, f_re, f_im,
    exc=0, theta, phi, r*E components).  The Stratton-Chu prefactor, phase
    and B = -curl E/(i omega) use the full complex omega (reference:
    postoperator.cpp:1438-1440, strattonchu.cpp:101-140).  Inherited: a
    mode with Re omega < 0 is mirrored by negating the whole omega, which
    also flips Im omega (the driver keeps only Re omega > 0)."""
    from palace_torch.drivers.driven import build_farfield
    from palace_torch.post.farfield import stratton_chu

    tb, grid = build_farfield(iodata, sop)
    if tb is None:
        return
    units = iodata.units
    ghz = units.scale_factor(ValueType.FREQUENCY)
    V = 1.0 / units.scale_factor(ValueType.FIELD_E)
    t = Table()
    t.add(index_column("m"))
    t.add(Column("fre", "f_re (GHz)"))
    t.add(Column("fim", "f_im (GHz)"))
    t.add(Column("exc", "exc", min_left_padding=2, print_as_int=True))
    t.add(Column("theta", "theta (deg.)", min_left_padding=2))
    t.add(Column("phi", "phi (deg.)", min_left_padding=2))
    for d in ("x", "y", "z"):
        t.add(Column(f"re{d}", f"r*Re{{E_{d}}} (V)"))
        t.add(Column(f"im{d}", f"r*Im{{E_{d}}} (V)"))
    for i in range(len(omega)):
        f = omega[i] / (2 * math.pi) * ghz
        om_i = complex(omega[i])
        if om_i.real < 0:
            om_i = -om_i
        rE = stratton_chu(sop, tb, modes[i], om_i, grid)
        for p in range(len(grid)):
            t.col("i").data.append(float(i + 1))
            t.col("fre").data.append(float(np.real(f)))
            t.col("fim").data.append(float(np.imag(f)))
            t.col("exc").data.append(0.0)
            t.col("theta").data.append(math.degrees(grid[p, 0]))
            t.col("phi").data.append(math.degrees(grid[p, 1]))
            for di, d in enumerate(("x", "y", "z")):
                t.col(f"re{d}").data.append(rE[p, di].real * V)
                t.col(f"im{d}").data.append(rE[p, di].imag * V)
    t.write(os.path.join(post_dir, "farfield-rE.csv"))


def _write_port_tables(iodata, sop, post_dir, omega, modes):
    """port-V / port-I / port-EPR / port-Q for eigen modes (reference:
    postoperator.cpp MeasureLumpedPorts eigenmode branch)."""
    units = iodata.units
    Vs = units.scale_factor(ValueType.VOLTAGE)
    As = units.scale_factor(ValueType.CURRENT)
    ghz = units.scale_factor(ValueType.FREQUENCY)
    fn = {idx: sop.port_functionals(idx) for idx in sop.ports}
    with_L = [i for i, p in sop.ports.items() if abs(p.L) > 0]
    with_R = [i for i, p in sop.ports.items() if abs(p.R) > 0]

    tv, ti = Table(), Table()
    for T in (tv, ti):
        T.add(index_column("m"))
    for idx in sop.ports:
        tv.add(Column(f"re{idx}", f"Re{{V[{idx}]}} (V)"))
        tv.add(Column(f"im{idx}", f"Im{{V[{idx}]}} (V)"))
        ti.add(Column(f"re{idx}", f"Re{{I[{idx}]}} (A)"))
        ti.add(Column(f"im{idx}", f"Im{{I[{idx}]}} (A)"))
    tq = Table()
    tq.add(index_column("m"))
    for idx in with_R:
        tq.add(Column(f"q{idx}", f"Q_ext[{idx}]"))
        tq.add(Column(f"k{idx}", f"κ_ext[{idx}] (GHz)"))
    te = Table()
    te.add(index_column("m"))
    for idx in with_L:
        te.add(Column(f"p{idx}", f"p[{idx}]"))

    for i in range(len(omega)):
        x = modes[i]
        om_re = float(np.real(omega[i]))
        Ee = 0.5 * _quad(sop.M_re, x)
        E_cap = 0.0
        for idx, port in sop.ports.items():
            if abs(port.C) > 0:
                V = complex(np.dot(fn[idx][1], x))
                E_cap += 0.5 * abs(port.C) * float(np.real(V * np.conj(V)))
        E_tot = Ee + E_cap
        for T in (tv, ti, tq, te):
            T.col("i").data.append(float(i + 1))
        for idx, port in sop.ports.items():
            V = complex(np.dot(fn[idx][1], x))
            I = 0.0 + 0.0j
            I_R = I_L = 0.0 + 0.0j
            for br, val in (("R", port.R), ("L", port.L), ("C", port.C)):
                if abs(val) > 0:
                    Ib = V / port.characteristic_impedance(om_re, br)
                    I += Ib
                    if br == "R":
                        I_R = Ib
                    if br == "L":
                        I_L = Ib
            tv.col(f"re{idx}").data.append(V.real * Vs)
            tv.col(f"im{idx}").data.append(V.imag * Vs)
            ti.col(f"re{idx}").data.append(I.real * As)
            ti.col(f"im{idx}").data.append(I.imag * As)
            if idx in with_R:
                P_R = 0.5 * abs(port.R) * float(np.real(I_R * np.conj(I_R)))
                kappa = math.copysign(P_R / E_tot, I_R.real) if E_tot > 0 \
                    else 0.0
                Q = (om_re / abs(kappa)) if kappa != 0 else np.inf
                tq.col(f"q{idx}").data.append(Q if np.isfinite(Q) else 0.0)
                tq.col(f"k{idx}").data.append(kappa * ghz / (2 * math.pi))
            if idx in with_L:
                p = 0.5 * abs(port.L) * float(np.real(I_L * np.conj(I_L))) / \
                    E_tot if E_tot > 0 else 0.0
                te.col(f"p{idx}").data.append(p)
    tv.write(os.path.join(post_dir, "port-V.csv"))
    ti.write(os.path.join(post_dir, "port-I.csv"))
    if with_R:
        tq.write(os.path.join(post_dir, "port-Q.csv"))
    if with_L:
        te.write(os.path.join(post_dir, "port-EPR.csv"))


def _quad(op, x) -> float:
    """Re x^H A x over the domain operator `op`."""
    return _energy(op, np.ascontiguousarray(x))


def _masked_quad(op, x, attrs) -> float:
    """Re x^H A x over the elements of `op` with an attribute in `attrs`."""
    return _energy(op, np.ascontiguousarray(x), attrs)
