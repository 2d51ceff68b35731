"""Transient driver (counterpart of palace_tpu/drivers/transient.py;
reference: palace/drivers/transientsolver.cpp, palace/models/timeoperator.cpp).

First-order ODE system on [dE/dt; E; A_B], where A_B is the "vector
potential accumulator" in the ND space with B = -curl A_B: every update
the reference applies to its RT B dofs is the curl of an ND-space linear
combination, so B = -curl(A_B) holds exactly with the same
time-discretization coefficients.

Time integration: MFEM's first-order generalized-alpha with rho_inf = 1,
the SDIRK23 Runge-Kutta scheme, and the adaptive SDIRK ("ARKODE") and BDF
("CVODE") steppers.  `TransientOperator`, `SDIRK23`, `_WRMS`,
`AdaptiveSDIRK`, `AdaptiveBDF` and `GeneralizedAlpha` are copied from the
JAX package (numpy and scipy): the implicit system A = M + dt^2 K + dt C
is one host `splu` per dt, reused every step, and the ODE state stays on
the host.  The run's device builds the domain operators, computes every
step's energies (`PAOperator.element_energy` on M and K) and the
indicators' flux-recovery mass solves; the port currents, probes and the
indicators' integrals are host numpy.

Inherited from the JAX package: `DeltaPost` is parsed but every step is
measured and written; lossy permittivity, Conductivity boundaries and more
than one excitation are refused; with Model/Refinement/MaxIts > 0 the run
warns and goes on without AMR.  Deliberate divergence: the per-step
indicators catch nothing (palace_tpu drops them quietly on
NotImplementedError, which the RT space raises on mixed prism meshes).
The provenance records the wall time of the implicit solves, of the
energies and port integrals, and of the indicators (`transient_seconds`),
and the route of the indicators' mass solves (`estimator_mass_route`).
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from palace_torch.config import IoData, ValueType
from palace_torch.drivers.common import (
    make_output_dir, nondim_point, prepare_mesh, print_log,
    write_error_indicators,
)
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.post.tables import Column, Table
from palace_torch.utils import provenance, timers, unported
from palace_torch.utils.excitations import get_excitation


class TransientOperator:
    """M u1' = -(K u2 + C u1) + g'(t) NegJ;  u2' = u1;  A_B' = u2."""

    def __init__(self, iodata: IoData, sop: SpaceOperator, dJ):
        from scipy.sparse.linalg import splu
        import scipy.sparse as sp

        self.sop = sop
        self.dJ = dJ
        ess = sop.ess_mask
        free = sp.diags((~ess).astype(float))
        one = sp.diags(ess.astype(float))
        self.K = (free @ sop.stiffness_csr() @ free).tocsr()
        C = sop.damping_csr()
        self.C = (free @ C @ free).tocsr() if C is not None else None
        M = sop.mass_csr()
        if np.iscomplexobj(M.data):
            raise ValueError("transient solve requires lossless permittivity")
        self.M = (free @ M @ free + one).tocsr()
        excitations = sop.excitations()
        if len(excitations) != 1:
            raise ValueError("transient solve requires exactly one excitation")
        self.excitation_idx = next(iter(excitations))
        self.NegJ = sop.rhs1(self.excitation_idx)
        self._luM = splu(self.M.tocsc())
        self._luA = None
        self._dt = None
        self._splu = splu
        self.tol = iodata.solver.linear.tol

    def rhs(self, u1, u2, t):
        r1 = -(self.K @ u2) + self.dJ(t) * self.NegJ
        if self.C is not None:
            r1 -= self.C @ u1
        return r1

    def mult(self, u1, u2, t):
        """du = f(u, t): (du1, du2)."""
        return self._luM.solve(self.rhs(u1, u2, t)), u1

    def implicit_solve(self, dt, u1, u2, t):
        """Solve M k = f(u + dt k, t): returns (k1, k2) via block elimination
        (reference: timeoperator.cpp:183-224)."""
        if self._luA is None or dt != self._dt:
            import scipy.sparse as sp

            A = (self.M + dt * dt * self.K
                 + (dt * self.C if self.C is not None else 0.0)).tocsc()
            self._luA = self._splu(A)
            self._dt = dt
        r1 = self.rhs(u1, u2, t)
        r2 = u1
        k1 = self._luA.solve(r1 - dt * (self.K @ r2))
        k2 = r2 + dt * k1
        return k1, k2


class SDIRK23:
    """2-stage singly-diagonally-implicit Runge-Kutta (MFEM SDIRK23Solver
    with gamma_opt = 2, the L-stable gamma = (2 - sqrt(2))/2; reference:
    timeoperator.cpp:324-330 TimeSteppingScheme::RUNGE_KUTTA).

    Butcher tableau: a11 = g; a21 = 1 - 2g, a22 = g; b = (1/2, 1/2),
    c = (g, 1 - g)."""

    def __init__(self, op: TransientOperator, gamma_opt: int = 2):
        self.op = op
        if gamma_opt == 2:
            self.g = (2.0 - math.sqrt(2.0)) / 2.0  # L-stable
        elif gamma_opt == 0:
            self.g = (3.0 - math.sqrt(3.0)) / 6.0  # 3rd order, not A-stable
        else:
            self.g = (3.0 + math.sqrt(3.0)) / 6.0  # 3rd order, A-stable

    def step(self, x, t, dt):
        op = self.op
        g = self.g
        u1, u2, aB = x
        k1_1, k1_2 = op.implicit_solve(g * dt, u1, u2, t + g * dt)
        k1_B = u2 + g * dt * k1_2
        c = dt * (1.0 - 2.0 * g)
        k2_1, k2_2 = op.implicit_solve(g * dt, u1 + c * k1_1, u2 + c * k1_2,
                                       t + (1.0 - g) * dt)
        k2_B = (u2 + c * k1_2) + g * dt * k2_2
        h = 0.5 * dt
        return ((u1 + h * (k1_1 + k2_1), u2 + h * (k1_2 + k2_2),
                 aB + h * (k1_B + k2_B)), t + dt)


class _WRMS:
    """SUNDIALS-style weighted RMS error norm over the stacked state
    (reference: ARKodeSStolerances/CVodeSStolerances with scalar rel/abs
    tolerances, timeoperator.cpp:345,369)."""

    def __init__(self, rel_tol: float, abs_tol: float):
        self.rel = rel_tol
        self.abs = abs_tol

    def __call__(self, err, x) -> float:
        num = 0.0
        n = 0
        for e, xi in zip(err, x):
            e = np.asarray(e)
            w = self.abs + self.rel * np.abs(np.asarray(xi))
            num += float(np.sum((e / w) ** 2))
            n += e.size
        return math.sqrt(num / max(n, 1))


class AdaptiveSDIRK:
    """Adaptive implicit RK (the reference's Solver/Transient/Type "ARKODE",
    timeoperator.cpp:331-355: SUNDIALS ARKODE with ARKodeSetOrder and
    SStolerances).  A re-implementation: an embedded SDIRK pair —
    the 2-stage stiffly-accurate scheme of SDIRK23 with an embedded
    lower-order solution err = dt/2 (k2 - k1) — driven by a PI step-size
    controller on the SUNDIALS WRMS norm.  "Order" selects the stage gamma
    (<= 2: L-stable gamma = (2-sqrt(2))/2; >= 3: the 3rd-order A-stable
    gamma = (3+sqrt(3))/6; orders above 3 clamp to 3, logged by the caller).

    Step-size changes refactorize A = M + dt*g C + (dt*g)^2 K, so the
    controller applies hysteresis: dt only changes when the proposal moves
    >15% or a step is rejected (the lagged-reconfiguration idea of
    timeoperator.cpp:95-109/ImplicitSolve dt_ caching)."""

    def __init__(self, op: TransientOperator, rel_tol: float, abs_tol: float,
                 order: int = 2):
        self.op = op
        self.g = ((2.0 - math.sqrt(2.0)) / 2.0 if order <= 2
                  else (3.0 + math.sqrt(3.0)) / 6.0)
        self.norm = _WRMS(rel_tol, abs_tol)
        self.dt = None  # current internal step
        self.err_prev = 1.0
        self.n_steps = 0
        self.n_rejected = 0

    def _stages(self, x, t, dt):
        op = self.op
        g = self.g
        u1, u2, aB = x
        k1_1, k1_2 = op.implicit_solve(g * dt, u1, u2, t + g * dt)
        k1_B = u2 + g * dt * k1_2
        c = dt * (1.0 - 2.0 * g)
        k2_1, k2_2 = op.implicit_solve(g * dt, u1 + c * k1_1, u2 + c * k1_2,
                                       t + (1.0 - g) * dt)
        k2_B = (u2 + c * k1_2) + g * dt * k2_2
        h = 0.5 * dt
        x_new = (u1 + h * (k1_1 + k2_1), u2 + h * (k1_2 + k2_2),
                 aB + h * (k1_B + k2_B))
        err = (h * (k2_1 - k1_1), h * (k2_2 - k1_2), h * (k2_B - k1_B))
        return x_new, err

    def advance(self, x, t, t_target, dt_hint):
        """Integrate from t to t_target with internal adaptive substeps."""
        if self.dt is None:
            self.dt = dt_hint
        while t < t_target - 1e-14 * max(abs(t_target), 1.0):
            dt = min(self.dt, t_target - t)
            x_new, err = self._stages(x, t, dt)
            e = self.norm(err, x_new)
            if not math.isfinite(e):
                e = 10.0
            if e <= 1.0:  # accept
                x, t = x_new, t + dt
                self.n_steps += 1
                # PI controller (H211-like): order-2 method, order-1 embedded.
                fac = 0.9 * (max(e, 1e-10) ** -0.35) * \
                    (max(self.err_prev, 1e-10) ** 0.15)
                self.err_prev = max(e, 1e-10)
                fac = min(max(fac, 0.2), 5.0)
                if fac > 1.15 or fac < 0.85:  # hysteresis: avoid refactoring
                    self.dt = self.dt * fac
            else:  # reject, shrink
                self.n_rejected += 1
                self.dt = dt * min(max(0.9 * e ** -0.5, 0.2), 0.9)
        return x, t


class AdaptiveBDF:
    """Adaptive multistep BDF (the reference's Solver/Transient/Type "CVODE",
    timeoperator.cpp:356-373: SUNDIALS CVODE CV_BDF with SetMaxOrder and
    SStolerances).  A re-implementation: variable-step BDF2 (BDF1
    startup) with a variable-step AB2 predictor; the local error estimate is
    the scaled predictor-corrector difference (the standard Milne device),
    stepped by the same WRMS controller as AdaptiveSDIRK.  "Order" clamps
    the BDF order to min(order, 2)."""

    def __init__(self, op: TransientOperator, rel_tol: float, abs_tol: float,
                 order: int = 2):
        self.op = op
        self.max_order = max(1, min(order, 2))
        self.norm = _WRMS(rel_tol, abs_tol)
        self.dt = None
        self.hist = []  # [(t, x, f)] most recent last
        self.n_steps = 0
        self.n_rejected = 0

    def _f(self, x, t):
        d1, d2 = self.op.mult(x[0], x[1], t)
        return (d1, d2, x[1].copy())

    def _bdf_step(self, t, dt):
        """One BDF step from the newest history point; returns (x_new, err)."""
        tn, xn, fn = self.hist[-1]
        if len(self.hist) < 2 or self.max_order == 1:
            # BDF1 (backward Euler): x = xn + dt f(x).  Error estimate vs
            # the forward-Euler predictor: err ~ (x - xp)/2.
            k = self.op.implicit_solve(dt, xn[0], xn[1], t + dt)
            kB = xn[1] + dt * k[1]
            x = (xn[0] + dt * k[0], xn[1] + dt * k[1], xn[2] + dt * kB)
            xp = tuple(xi + dt * fi for xi, fi in zip(xn, fn))
            err = tuple(0.5 * (a - b) for a, b in zip(x, xp))
            return x, err
        tm, xm, fm = self.hist[-2]
        r = dt / (tn - tm)
        # Variable-step BDF2: x - a1 xn - a2 xm = b dt f(x) with
        # a1 = (1+r)^2/(1+2r), a2 = -r^2/(1+2r), b = (1+r)/(1+2r).
        a1 = (1 + r) ** 2 / (1 + 2 * r)
        a2 = -(r ** 2) / (1 + 2 * r)
        b = (1 + r) / (1 + 2 * r)
        ystar = tuple(a1 * yn + a2 * ym for yn, ym in zip(xn, xm))
        h = b * dt
        k = self.op.implicit_solve(h, ystar[0], ystar[1], t + dt)
        kB = ystar[1] + h * k[1]
        x = (ystar[0] + h * k[0], ystar[1] + h * k[1], ystar[2] + h * kB)
        # Variable-step AB2 predictor (order 2, different error constant).
        xp = tuple(xi + dt * ((1 + r / 2) * fi - (r / 2) * gi)
                   for xi, fi, gi in zip(xn, fn, fm))
        err = tuple((a - bb) / 6.0 for a, bb in zip(x, xp))
        return x, err

    def advance(self, x, t, t_target, dt_hint):
        if self.dt is None:
            self.dt = dt_hint
        if not self.hist:
            self.hist = [(t, x, self._f(x, t))]
        while t < t_target - 1e-14 * max(abs(t_target), 1.0):
            dt = min(self.dt, t_target - t)
            x_new, err = self._bdf_step(t, dt)
            e = self.norm(err, x_new)
            if not math.isfinite(e):
                e = 10.0
            if e <= 1.0:
                t = t + dt
                x = x_new
                self.hist.append((t, x, self._f(x, t)))
                if len(self.hist) > 2:
                    self.hist.pop(0)
                self.n_steps += 1
                p = 1 if len(self.hist) < 2 or self.max_order == 1 else 2
                fac = min(max(0.9 * max(e, 1e-10) ** (-1.0 / (p + 1)),
                              0.2), 5.0)
                if fac > 1.15 or fac < 0.85:
                    self.dt = self.dt * fac
            else:
                self.n_rejected += 1
                self.dt = dt * min(max(0.9 * e ** -0.5, 0.2), 0.9)
        return x, t


class GeneralizedAlpha:
    """MFEM first-order generalized-alpha (rho_inf = 1: alpha_m = alpha_f =
    gamma = 1/2, the implicit midpoint family)."""

    def __init__(self, op: TransientOperator, rho_inf: float = 1.0):
        self.op = op
        self.am = 0.5 * (3.0 - rho_inf) / (1.0 + rho_inf)
        self.af = 1.0 / (1.0 + rho_inf)
        self.gamma = 0.5 + self.am - self.af
        self.xdot: Optional[Tuple] = None

    def step(self, x, t, dt):
        """x = (u1, u2, aB); returns (x_new, t + dt)."""
        op = self.op
        u1, u2, aB = x
        if self.xdot is None:
            d1, d2 = op.mult(u1, u2, t)
            self.xdot = (d1, d2, u2.copy())
        ga = self.gamma / self.am
        c0 = self.af * (1.0 - ga) * dt
        y1 = u1 + c0 * self.xdot[0]
        y2 = u2 + c0 * self.xdot[1]
        yB = aB + c0 * self.xdot[2]
        dt_eff = ga * self.af * dt
        k1, k2 = op.implicit_solve(dt_eff, y1, y2, t + self.af * dt)
        kB = y2 + dt_eff * k2  # rhs3 analog: A_B' = E
        c1 = (1.0 - ga) * dt
        c2 = ga * dt
        x_new = (u1 + c1 * self.xdot[0] + c2 * k1,
                 u2 + c1 * self.xdot[1] + c2 * k2,
                 aB + c1 * self.xdot[2] + c2 * kB)
        oam = 1.0 / self.am
        self.xdot = (self.xdot[0] * (1.0 - oam) + oam * k1,
                     self.xdot[1] * (1.0 - oam) + oam * k2,
                     self.xdot[2] * (1.0 - oam) + oam * kB)
        return x_new, t + dt


def _refuse_outputs(iodata: IoData):
    """Deliberate divergence: palace_tpu's transient driver ignores the
    surface, far-field and ParaView outputs a config asks for (upstream
    Palace writes its surface tables and SaveStep fields); the port refuses
    them rather than write none."""
    item = "transient surface and ParaView output"
    b = iodata.boundaries
    if b.surface_fluxes or b.dielectrics:
        unported("SurfaceFlux and Dielectric tables of the transient driver",
                 item)
    if b.farfield is not None and b.farfield.attributes:
        unported("FarField output of the transient driver", item)
    if iodata.problem.output_formats.paraview \
            and iodata.solver.transient.delta_post > 0:
        unported("ParaView fields of the transient driver (SaveStep)", item)


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    t0 = time.time()
    _refuse_outputs(iodata)
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    post_dir = make_output_dir(iodata, output_dir)
    units = iodata.units
    cfg = iodata.solver.transient
    if iodata.model.refinement.max_it > 0:
        # Reference parity: basesolver.cpp:163-169 warns and disables AMR
        # for transient simulations.
        print_log(iodata,
                  "WARNING: AMR is not currently supported for transient "
                  "simulations!")

    with timers.block("Operator construction"):
        sop = SpaceOperator(iodata, mesh, device=device)
    if sop._conductivity:
        raise NotImplementedError(
            "transient solves do not support surface conductivity "
            "boundaries (reference: iodata.cpp:362-366)")
    print_log(iodata, f"transient: {sop.space.num_dofs} dofs, "
                      f"{mesh.num_elements} elements, device {device}")

    # Nondimensionalize time parameters (reference: configfile.cpp:1620-1627).
    fscale = units.scale_factor(ValueType.FREQUENCY)
    tscale = units.scale_factor(ValueType.TIME)

    class NondimPulse:
        excitation = cfg.excitation
        pulse_f = 2 * math.pi * cfg.pulse_f / fscale
        pulse_tau = cfg.pulse_tau / tscale

    g = get_excitation(NondimPulse, dot=False)
    dg = get_excitation(NondimPulse, dot=True)
    max_t = cfg.max_t / tscale
    dt = cfg.delta_t / tscale
    nstep = int(round(max_t / dt)) + 1

    with timers.block("Operator construction"):
        op = TransientOperator(iodata, sop, dg)
    if cfg.type in ("Default", "GeneralizedAlpha"):
        ode = GeneralizedAlpha(op)
    elif cfg.type in ("RungeKutta", "SDIRK23"):
        ode = SDIRK23(op)
    elif cfg.type == "ARKODE":
        if cfg.order > 3:
            print_log(iodata, "  ARKODE order > 3 clamps to the 3rd-order "
                              "SDIRK stage (embedded pair)")
        ode = AdaptiveSDIRK(op, cfg.rel_tol, cfg.abs_tol, cfg.order)
    elif cfg.type == "CVODE":
        ode = AdaptiveBDF(op, cfg.rel_tol, cfg.abs_tol, cfg.order)
    else:
        raise NotImplementedError(f"transient scheme {cfg.type}")

    n = sop.space.num_dofs
    x = (np.zeros(n), np.zeros(n), np.zeros(n))
    t = 0.0

    probe_locs = None
    if iodata.domains.probes:
        from palace_torch.fem import evaluation

        locator = evaluation.PointLocator(mesh)
        pts = np.array([nondim_point(iodata, p.center)
                        for p in iodata.domains.probes])
        probe_locs = locator.locate(pts)

    from palace_torch.fem.estimators import (curl_flux_indicators,
                                             grad_flux_indicators)

    port_fn = {idx: sop.port_functionals(idx) for idx in sop.ports}
    masks = {ecfg.index: [torch.as_tensor(np.isin(b.attr, ecfg.attributes),
                                          device=sop.device)
                          for b in mesh.buckets]
             for ecfg in iodata.domains.energies}
    rows = []
    eta2_steps, energies = [], []
    clock = dict.fromkeys(("implicit_solve", "energies", "indicators"), 0.0)
    adaptive = isinstance(ode, (AdaptiveSDIRK, AdaptiveBDF))
    for step_i in range(nstep):
        c0 = time.perf_counter()
        if step_i > 0:
            with timers.block("Time stepping"):
                if adaptive:
                    x, t = ode.advance(x, t, step_i * dt, dt)
                else:
                    x, t = ode.step(x, t, dt)
        c1 = time.perf_counter()
        with timers.block("Postprocessing"):
            row = measure_transient(iodata, sop, op, x, t, g, port_fn,
                                    probe_locs, masks)
        rows.append(row)
        c2 = time.perf_counter()
        # Per-step combined grad + curl flux indicators (reference:
        # transientsolver.cpp:108 AddEstimate(E, B, Et) every step); on a
        # 2D mesh the grad part alone, as in palace_tpu.
        with timers.block("Estimator solve"):
            e2 = grad_flux_indicators(sop.space, sop.materials, x[1],
                                      device=device)
            if mesh.nodes.shape[1] == 3:
                e2 = e2 + curl_flux_indicators(sop.space, sop.materials,
                                               x[2], device=device)
        eta2_steps.append(e2)
        energies.append(row["E_elec"] + row["E_mag"] + row["E_cap"]
                        + row["E_ind"])
        c3 = time.perf_counter()
        clock["implicit_solve"] += c1 - c0
        clock["energies"] += c2 - c1
        clock["indicators"] += c3 - c2
        if step_i % 50 == 0:
            print_log(iodata, f"  step {step_i}/{nstep - 1}, "
                              f"t = {t * tscale:.4f} ns")

    if adaptive:
        # Stepper statistics, mirroring the reference's ARKODE/CVODE report
        # (timeoperator.cpp:425-450 PrintStats).
        print_log(iodata, f"  adaptive stepper: {ode.n_steps} internal steps,"
                          f" {ode.n_rejected} rejected, final dt = "
                          f"{(ode.dt or dt) * tscale:.3e} ns")
        provenance.record("transient_internal_steps", ode.n_steps)
        provenance.record("transient_rejected_steps", ode.n_rejected)
    provenance.record("transient_seconds", dict(clock, steps=nstep))
    with timers.block("Postprocessing"):
        write_transient_tables(iodata, sop, post_dir, rows)
        write_error_indicators(post_dir, eta2_steps, energies)
    print_log(iodata, f"transient done in {time.time() - t0:.1f}s")
    from palace_torch.post import metadata as _metadata
    _metadata.save_problem(post_dir, "Transient", mesh.num_elements,
                           sop.space.num_dofs)
    _metadata.save_timing(post_dir)
    return dict(post_dir=post_dir, num_dofs=sop.space.num_dofs, rows=rows,
                sop=sop, op=op, provenance=provenance.snapshot())


def measure_transient(iodata, sop: SpaceOperator, op: TransientOperator, x, t,
                      g, port_fn, probe_locs, masks):
    """Energies, port V/I/P and probes of one step.  E_elec = 1/2 E^T M_eps E
    and E_mag = 1/2 (curl aB)^T mu^-1 (curl aB), the K_dom quadratic form of
    the accumulator aB, come from the device operators in one read;
    `masks` holds each domain-energy config's per-bucket element masks on
    the operators' device."""
    u1, u2, aB = x
    m: Dict = {"t": t}
    eE = sop.M_re.element_energy(torch.as_tensor(u2, device=sop.device))
    eM = sop.K_dom.element_energy(torch.as_tensor(aB, device=sop.device))
    parts = [_op_energy(eE), _op_energy(eM)]
    for ecfg in iodata.domains.energies:
        parts += [_masked(eE, masks[ecfg.index]),
                  _masked(eM, masks[ecfg.index])]
    vals = torch.stack(parts).cpu().numpy()
    if sop.mesh.nodes.shape[1] == 2:
        # 2D: E_mag 0, palace_tpu's convention (the reference's 2D B is ~0;
        # KNOWN_GAPS.md "2D E_mag").
        vals[1::2] = 0.0
    m["E_elec"] = 0.5 * float(vals[0])
    m["E_mag"] = 0.5 * float(vals[1])
    m["E_cap"] = 0.0
    m["E_ind"] = 0.0
    m["domain_E"] = {}
    m["domain_M"] = {}
    for k, ecfg in enumerate(iodata.domains.energies):
        m["domain_E"][ecfg.index] = 0.5 * float(vals[2 + 2 * k])
        m["domain_M"][ecfg.index] = 0.5 * float(vals[3 + 2 * k])
    m["ports"] = {}
    for idx, port in sop.ports.items():
        s, v = port_fn[idx]
        V = float(v @ u2)
        # Transient current from P = V I (reference: postoperator.cpp
        # MeasureLumpedPorts else-branch: I = conj(P/V)); P here from the
        # instantaneous fields E and H = -mu^-1 curl aB.
        Pval = _port_power_transient(sop, idx, u2, aB)
        I = Pval / V if abs(V) > 0 else 0.0
        m["ports"][idx] = dict(V=V, I=I, P=Pval)
        if abs(port.L) > 0:
            m["E_ind"] += 0.5 * abs(port.L) * (I * I)
        if abs(port.C) > 0:
            m["E_cap"] += 0.5 * abs(port.C) * (V * V)
    m["g"] = g(t)
    if probe_locs is not None:
        from palace_torch.fem import evaluation

        m["probe_E"] = evaluation.eval_nd(sop.space, u2, probe_locs, "value")
        m["probe_B"] = -evaluation.eval_nd(sop.space, aB, probe_locs, "curl")
    return m


def _op_energy(elem_energy) -> torch.Tensor:
    """x^T A x from a domain PAOperator's per-bucket element energies
    (element_energy returns 1/2 x^T A x), on their device."""
    return 2.0 * torch.stack([e.sum() for e in elem_energy]).sum()


def _masked(elem_energy, masks) -> torch.Tensor:
    return 2.0 * torch.stack([(e * mask).sum() for e, mask in
                              zip(elem_energy, masks)]).sum()


def _port_power_transient(sop: SpaceOperator, idx: int, E, aB) -> float:
    """P(t) = ∫ (E x H) . n dS into the domain, H = -mu^-1 curl aB (host)."""
    from palace_torch.fem.evaluation import trace_nd

    P = 0.0
    for tb in sop._port_trace_bases[idx]:
        tr = tb.tr
        attrs = np.empty(len(tr.elem), np.int32)
        for bi, b in enumerate(sop.mesh.buckets):
            ssel = tr.bucket == bi
            attrs[ssel] = b.attr[tr.elem[ssel]]
        muinv = sop.materials.attr_tensor(sop.materials.inv_permeability, attrs)
        Ev = trace_nd(sop.space, E, tr, which="value")
        Bv = -trace_nd(sop.space, aB, tr, which="curl")
        if sop.mesh.nodes.shape[1] == 2:
            # 2D: H = (mu^-1)_zz B_z out of plane; E x H = (Ey H, -Ex H).
            H = muinv[:, 2, 2][:, None] * Bv[..., 0]
            ExH = np.stack([Ev[..., 1] * H, -Ev[..., 0] * H], axis=-1)
        else:
            H = np.einsum("fst,fqt->fqs", muinv, Bv)
            ExH = np.cross(Ev, H)
        P += float(np.einsum("fq,fqs,fqs->", tr.wdetJ, ExH, -tr.normal))
    return P


def write_transient_tables(iodata: IoData, sop: SpaceOperator, post_dir, rows):
    units = iodata.units
    ns = units.scale_factor(ValueType.TIME)
    V = units.scale_factor(ValueType.VOLTAGE)
    A = units.scale_factor(ValueType.CURRENT)
    J = units.scale_factor(ValueType.ENERGY)

    def time_col():
        return Column("t", "t (ns)", min_left_padding=0, precision=8, sign="")

    excitation_idx = next(iter(sop.excitations()))
    drive = [i for i, p in sop.ports.items() if p.excitation == excitation_idx]

    # port-V / port-I
    for name, unit, scale, inc in (
        ("V", "(V)", V, lambda p, gval: p.excitation_voltage() * gval),
        ("I", "(A)", A,
         lambda p, gval: p.excitation_voltage() / p.R * gval),
    ):
        t = Table()
        tc = t.add(time_col())
        for d in drive:
            t.add(Column(f"inc{d}", f"{name}_inc[{d}] {unit}"))
        for idx in sop.ports:
            t.add(Column(f"v{idx}", f"{name}[{idx}] {unit}"))
        for row in rows:
            tc.data.append(row["t"] * ns)
            for d in drive:
                t.col(f"inc{d}").data.append(inc(sop.ports[d], row["g"]) * scale)
            for idx in sop.ports:
                t.col(f"v{idx}").data.append(row["ports"][idx][name] * scale)
        t.write(os.path.join(post_dir, f"port-{name}.csv"))

    # domain-E
    t = Table()
    tc = t.add(time_col())
    t.add(Column("Ee", "E_elec (J)"))
    t.add(Column("Em", "E_mag (J)"))
    t.add(Column("Ec", "E_cap (J)"))
    t.add(Column("Ei", "E_ind (J)"))
    for ecfg in iodata.domains.energies:
        t.add(Column(f"Ee{ecfg.index}", f"E_elec[{ecfg.index}] (J)"))
        t.add(Column(f"pe{ecfg.index}", f"p_elec[{ecfg.index}]"))
        t.add(Column(f"Em{ecfg.index}", f"E_mag[{ecfg.index}] (J)"))
        t.add(Column(f"pm{ecfg.index}", f"p_mag[{ecfg.index}]"))
    for row in rows:
        tc.data.append(row["t"] * ns)
        t.col("Ee").data.append(row["E_elec"] * J)
        t.col("Em").data.append(row["E_mag"] * J)
        t.col("Ec").data.append(row["E_cap"] * J)
        t.col("Ei").data.append(row["E_ind"] * J)
        for ecfg in iodata.domains.energies:
            Ee, Em = row["domain_E"][ecfg.index], row["domain_M"][ecfg.index]
            t.col(f"Ee{ecfg.index}").data.append(Ee * J)
            t.col(f"pe{ecfg.index}").data.append(
                Ee / row["E_elec"] if row["E_elec"] > 0 else 0.0)
            t.col(f"Em{ecfg.index}").data.append(Em * J)
            t.col(f"pm{ecfg.index}").data.append(
                Em / row["E_mag"] if row["E_mag"] > 0 else 0.0)
    t.write(os.path.join(post_dir, "domain-E.csv"))

    # probes
    if iodata.domains.probes:
        Efield = units.scale_factor(ValueType.FIELD_E)
        Bfield = units.scale_factor(ValueType.FIELD_B)
        for name, unit, scale, key in (
            ("E", "(V/m)", Efield, "probe_E"),
            ("B", "(Wb/m²)", Bfield, "probe_B"),
        ):
            t = Table()
            tc = t.add(time_col())
            dims = ["x", "y", "z"]
            for p in iodata.domains.probes:
                for d in dims:
                    t.add(Column(f"{d}{p.index}", f"{name}_{d}[{p.index}] {unit}"))
            for row in rows:
                tc.data.append(row["t"] * ns)
                for pi, p in enumerate(iodata.domains.probes):
                    for di, d in enumerate(dims):
                        t.col(f"{d}{p.index}").data.append(
                            float(row[key][pi][di]) * scale)
            t.write(os.path.join(post_dir, f"probe-{name}.csv"))
