"""Eigenmode driver (counterpart of palace_tpu/drivers/eigenmode.py; reference:
palace/drivers/eigensolver.cpp), for the linear pencil K x = omega^2 M x.

Two branches are ported.  The lossless linear branch runs block Lanczos on
the run's device (`linalg/device_eig.py:device_shift_invert_eigs`) when the
configuration selects the iterative solver (`use_device_ksp`); otherwise the
host shift-invert ARPACK branch runs (`linalg/eig.py:shift_invert_eigs`),
which also takes a lossy (complex) permittivity.  The damped quadratic
branch, the nonlinear branch of frequency-dependent boundaries, Floquet
terms, and the surface, far-field and ParaView outputs raise
NotImplementedError naming their ROADMAP item.

Eigenvectors are normalized to unit M-norm so the per-mode electric field
energy is 1/2 nondimensional (reference: palace/linalg/slepc.cpp:470-510);
the run writes eig.csv, domain-E.csv, lumped-port tables, error-indicators.csv
and palace.json.  As in the driven driver, an exception on the device path
propagates: there is no quiet host re-solve.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from palace_torch.config import IoData, ValueType
from palace_torch.drivers.common import (
    make_output_dir, prepare_mesh, print_log, write_error_indicators,
)
from palace_torch.drivers.driven import _energy, use_device_ksp
from palace_torch.linalg.eig import shift_invert_eigs
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.post.tables import Column, Table, index_column
from palace_torch.utils import provenance, timers, unported


def _check_unported(iodata: IoData):
    """Refuse, before any work, the eigenmode features the port lacks."""
    b = iodata.boundaries
    if iodata.model.refinement.max_it > 0:
        unported("Eigenmode AMR (Model/Refinement/MaxIts)",
                 "driven and eigenmode AMR")
    if b.wave_ports or (b.absorbing is not None and b.absorbing.attributes
                        and b.absorbing.order > 1):
        unported("The nonlinear eigenproblem (wave ports, second-order "
                 "absorbing boundaries)", "nonlinear eigenmode")
    if b.conductivities:
        # As in palace_tpu (and the reference for non-PEP solvers).
        raise NotImplementedError(
            "conductivity boundaries make the eigenproblem nonlinear in "
            "omega (reference rejects this for non-PEP solvers too)")
    if b.floquet_ports or (b.floquet_wave_vector is not None and
                           np.linalg.norm(b.floquet_wave_vector) > 0):
        unported("Floquet terms of the eigenproblem",
                 "Floquet ports and Floquet eigenmode")
    if b.surface_fluxes or b.dielectrics or (b.farfield is not None
                                             and b.farfield.attributes):
        unported("SurfaceFlux / Dielectric / FarField tables of the "
                 "eigenmode driver", "eigenmode surface, far-field and "
                 "ParaView output")
    if iodata.problem.output_formats.paraview \
            and iodata.solver.eigenmode.n_post > 0:
        unported("ParaView mode output", "eigenmode surface, far-field and "
                 "ParaView output")


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    t0 = time.time()
    _check_unported(iodata)
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    post_dir = make_output_dir(iodata, output_dir)
    units = iodata.units
    cfg = iodata.solver.eigenmode

    def solve_and_estimate(m):
        with timers.block("Operator construction"):
            sop = SpaceOperator(iodata, m, device=device)
            space = sop.space
            Kcsr = sop.stiffness_csr()
            Ccsr = sop.damping_csr()
            Mcsr = sop.mass_csr()
        print_log(iodata, f"eigenmode: {space.num_dofs} dofs, "
                          f"{m.num_elements} elements, device {device}")
        if Ccsr is not None and abs(Ccsr).max() > 0:
            unported("The damped (quadratic) eigenproblem (resistive or "
                     "absorbing boundaries, conductivity)", "damped eigenmode")
        ess = np.where(sop.ess_mask)[0]

        f_t = units.nondimensionalize(ValueType.FREQUENCY, cfg.target)
        omega_t = 2 * np.pi * f_t
        nev = max(cfg.n, 1)
        # Request extra vectors (the gradient-nullspace cluster at
        # lambda = 0 is filtered below); grow the subspace and retry if the
        # filter leaves fewer than the n requested physical modes.
        extra = 8
        lossless_linear = sop.M_im is None
        for attempt in range(3):
            k_req = 2 * nev + extra
            with timers.block("Eigenvalue solve"):
                if lossless_linear and use_device_ksp(iodata,
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
                    provenance.record("lanczos_restarts", info["restarts"])
                    provenance.record("ksp_iterations",
                                      info["ksp_iterations"])
                else:
                    result = shift_invert_eigs(
                        Kcsr, Mcsr, ess, omega_t ** 2, k_req, tol=cfg.tol,
                        which="LM")
                    provenance.record("eigen_path", "host-arpack")
            omega = np.sqrt(result.eigenvalues.astype(complex))
            keep = (np.real(omega) > max(1e-8, 1e-3 * abs(omega_t)))
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

        # Curl-flux error indicators per mode, normalized by the mode
        # energy (unit M-norm: E_elec = 1/4 -> total E = 1/2).
        from palace_torch.fem.estimators import (
            curl_flux_indicators, grad_flux_indicators)

        eta2, energies = [], []
        with timers.block("Postprocessing"):
            for i in range(len(omega)):
                x = vecs[:, i]
                mnorm2 = abs(np.real(np.conj(x) @ (Mcsr @ x)))
                x = x / math.sqrt(mnorm2)
                vecs[:, i] = x
                # Combined grad + curl flux indicators with B = -i/omega
                # curl E (reference: eigensolver.cpp:339-343), Et the mode's
                # total energy.
                e2 = curl_flux_indicators(space, sop.materials, x,
                                          device=device) / abs(omega[i]) ** 2
                try:
                    e2 = e2 + grad_flux_indicators(space, sop.materials, x,
                                                   device=device)
                except NotImplementedError:
                    pass  # RT on hex/prism meshes: curl-only indicators
                eta2.append(e2)
                E_elec = 0.5 * _quad(sop.M_re, x)
                E_mag = 0.5 * _quad(sop.K_dom, x) / abs(omega[i]) ** 2
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
        return ((sop, Mcsr, omega, vecs, res, bkwd), eta2, energies,
                space.num_dofs)

    from palace_torch.drivers.amr import adapt_loop

    ((sop, Mcsr, omega, vecs, res, bkwd), eta_elem, _, mesh, _) = adapt_loop(
        iodata, mesh, solve_and_estimate)
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
                provenance=provenance.snapshot())


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
    for i in range(len(omega)):
        x = modes[i]
        Ee = 0.5 * _quad(sop.M_re, x)
        Em = 0.5 * _quad(sop.K_dom, x) / abs(omega[i]) ** 2
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
            EmA = 0.5 * _masked_quad(sop.K_dom, x,
                                     ecfg.attributes) / abs(omega[i]) ** 2
            td.col(f"Ee{ecfg.index}").data.append(EeA * Escale)
            td.col(f"pe{ecfg.index}").data.append(EeA / Ee if Ee > 0 else 0.0)
            td.col(f"Em{ecfg.index}").data.append(EmA * Escale)
            td.col(f"pm{ecfg.index}").data.append(EmA / Em if Em > 0 else 0.0)
    td.write(os.path.join(post_dir, "domain-E.csv"))


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
