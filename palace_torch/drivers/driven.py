"""Driven (frequency sweep) driver (counterpart of palace_tpu/drivers/driven.py).

Per sweep: assemble the term-structured system, solve all frequencies of
each excitation as one blocked FGMRES + p-MG system on the run's device (or
per frequency with host sparse direct), or, with `AdaptiveTol > 0`, build
the adaptive PROM (`driven_adaptive.sweep_adaptive`) and evaluate it at
every frequency; then measure port V/I/S/power, domain energies, probes,
surface fluxes, interface-dielectric participation and the Stratton-Chu
far field (host integrals, `post/{surfaces,farfield}.py`), compute error
indicators, and write the reference CSV table set and the ParaView fields
at `SaveFreqs` (`post/paraview.py`); ports are lumped, wave or Floquet
ports, and the system carries the frequency-dependent boundary terms
A2(omega) on every path.  A FloquetWaveVector adds the Bloch terms to the
system (device terms `floquet_mass` and `floquet_cross`), to the magnetic
energy and to the indicators.  Floquet ports send the sweep to host sparse
direct, as in palace_tpu, with their low-rank diffraction-order term
solved by Woodbury, and write port-floquet-S.csv.

Deliberate divergence from the JAX package: an exception raised on the
device path propagates; there is no silent re-solve with sparse direct.
Unconverged columns are still re-solved per column (numerics, recorded in
provenance).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from palace_torch import parallel
from palace_torch.config import IoData, ValueType
from palace_torch.drivers.amr import adapt_loop, refuse_hex_amr
from palace_torch.drivers.common import (
    _surface_bbox_center, make_output_dir, nondim_point, prepare_mesh,
    print_log, write_error_indicators,
)
from palace_torch.mesh.mesh import canonicalize_simplices
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.post.tables import Column, Table
from palace_torch.utils import provenance, timers


def driven_samples_ghz(iodata: IoData) -> List[float]:
    """Flattened, deduplicated frequency sample list in GHz."""
    cfg = iodata.solver.driven
    samples: List[float] = []

    def linear_range(min_f, max_f, delta_f):
        n = int(round((max_f - min_f) / delta_f))
        return [min_f + i * delta_f for i in range(n + 1)]

    if cfg.min_freq is not None and cfg.max_freq is not None \
            and cfg.freq_step is not None:
        samples += linear_range(cfg.min_freq, cfg.max_freq, cfg.freq_step)
    for s in cfg.samples:
        stype = s.get("Type", "Point" if "Freq" in s else "Linear")
        if stype == "Linear":
            if s.get("FreqStep"):
                samples += linear_range(s["MinFreq"], s["MaxFreq"],
                                        s["FreqStep"])
            else:
                samples += list(np.linspace(s["MinFreq"], s["MaxFreq"],
                                            int(s["NSample"])))
        elif stype == "Log":
            samples += list(np.geomspace(s["MinFreq"], s["MaxFreq"],
                                         int(s["NSample"])))
        else:
            f = s["Freq"]
            samples += list(f) if isinstance(f, (list, tuple)) else [f]
    out: List[float] = []
    for f in sorted(samples):
        if not out or abs(f - out[-1]) > 1.0e-9:
            out.append(f)
    if not out:
        raise ValueError("driven solver requires frequency samples")
    return out


@dataclass
class PortMeasurement:
    V: complex = 0.0
    I: complex = 0.0
    S: complex = 0.0
    P: complex = 0.0
    Z_PV: complex = 0.0  # wave port mode characteristic impedance V V* / P
    I_RLC: Tuple[complex, complex, complex] = (0.0, 0.0, 0.0)
    inductor_energy: float = 0.0
    capacitor_energy: float = 0.0


@dataclass
class StepMeasurement:
    """All measurements for one (excitation, frequency) sample."""

    omega: float
    ports: Dict[int, PortMeasurement] = field(default_factory=dict)
    E_elec: float = 0.0
    E_mag: float = 0.0
    E_cap: float = 0.0
    E_ind: float = 0.0
    domain_E: Dict[int, float] = field(default_factory=dict)
    domain_M: Dict[int, float] = field(default_factory=dict)
    probe_E: Optional[np.ndarray] = None  # (nprobe, 3) complex
    probe_B: Optional[np.ndarray] = None
    surf_flux: Dict[int, complex] = field(default_factory=dict)
    floquet_s: Optional[Dict] = None  # {port: {(m, n, is_te): S}}
    surf_q: Dict[int, Tuple[float, float]] = field(default_factory=dict)  # (p, Q)
    farfield: Optional[np.ndarray] = None  # (npts, 3) complex rE


def _energy(op, x: np.ndarray, attrs=None) -> float:
    """Re x^H A x over the domain operator (optionally attribute-masked)."""
    s = 0.0
    for part in (np.real(x), np.imag(x)):
        for b, e in zip(op.space.mesh.buckets, op.element_energy(part)):
            if attrs is not None:
                e = e * torch.as_tensor(np.isin(b.attr, attrs),
                                        device=e.device)
            s += 2.0 * float(torch.sum(e))
    return s


def measure_step(sop: SpaceOperator, E: np.ndarray, omega: float,
                 excitation_idx: int, port_fn, probe_locs=None
                 ) -> StepMeasurement:
    """Measure ports, energies, probes for one solution vector."""
    m = StepMeasurement(omega=omega)
    # E_elec = 1/2 Re E^H M E, E_mag = 1/(2 w^2) Re E^H K E (domain parts,
    # K with the Floquet terms).  On a 2D mesh E_mag is 0, as in palace_tpu
    # (the reference's B there is ~0; KNOWN_GAPS.md "2D E_mag").
    is_2d = sop.mesh.nodes.shape[1] == 2
    m.E_elec = 0.5 * _energy(sop.M_re, E)
    m.E_mag = 0.0 if is_2d else 0.5 * (
        _energy(sop.K_dom, E) + sop.floquet_mag_quad(E, omega)) / (
            omega * omega)
    for ecfg in sop.iodata.domains.energies:
        m.domain_E[ecfg.index] = 0.5 * _energy(sop.M_re, E, ecfg.attributes)
        m.domain_M[ecfg.index] = 0.0 if is_2d else 0.5 * (
            _energy(sop.K_dom, E, ecfg.attributes)
            + sop.floquet_mag_quad(E, omega, ecfg.attributes)) / omega ** 2

    for idx, port in sop.ports.items():
        pm = PortMeasurement()
        s, v = port_fn(idx)
        pm.V = complex(np.dot(v, E))
        pm.S = complex(np.dot(s, E))
        I_RLC = [0.0 + 0.0j] * 3
        for bi, branch in enumerate(("R", "L", "C")):
            val = {"R": port.R, "L": port.L, "C": port.C}[branch]
            if abs(val) > 0:
                I_RLC[bi] = pm.V / port.characteristic_impedance(omega, branch)
        pm.I_RLC = tuple(I_RLC)
        pm.I = sum(I_RLC)
        pm.P = sop.port_power(idx, E, omega)
        if abs(port.L) > 0:
            pm.inductor_energy = 0.5 * abs(port.L) * float(
                np.real(I_RLC[1] * np.conj(I_RLC[1])))
            m.E_ind += pm.inductor_energy
        if abs(port.C) > 0:
            pm.capacitor_energy = 0.5 * abs(port.C) * float(
                np.real(pm.V * np.conj(pm.V)))
            m.E_cap += pm.capacitor_energy
        if idx == _drive_port(sop, excitation_idx):
            pm.S = pm.S - 1.0
        m.ports[idx] = pm

    for idx, wp in sop.wave_ports.items():
        pm = PortMeasurement()
        pm.S = sop.waveport_sparam(idx, E, omega)
        if idx == _drive_port(sop, excitation_idx):
            pm.S = pm.S - 1.0
        pm.P = sop.port_power_trace(sop._wp_trace_bases[idx], E, omega)
        if getattr(wp.cfg, "voltage_path", None):
            # V_wp = int E . dl along the VoltagePath; Z_PV = V_exc V_exc*
            # of the power-normalized mode.
            pm.V = wp.solution_voltage(sop.space, E)
            V_exc = wp.solve_mode(omega).V_exc
            pm.Z_PV = V_exc * np.conj(V_exc)
        m.ports[idx] = pm

    if probe_locs is not None:
        from palace_torch.fem import evaluation

        m.probe_E = evaluation.eval_nd(sop.space, E, probe_locs, which="value")
        m.probe_B = evaluation.eval_nd(sop.space, E, probe_locs,
                                       which="curl") * (-1.0 / (1j * omega))
    return m


def _drive_port(sop: SpaceOperator, excitation_idx: int) -> Optional[int]:
    ports = [i for i, p in sop.ports.items() if p.excitation == excitation_idx]
    ports += [i for i, p in sop.wave_ports.items()
              if p.excitation == excitation_idx]
    return ports[0] if len(ports) == 1 else None


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    """Driven solve, inside the reference's solve-estimate-mark-refine AMR
    wrapper when Model/Refinement/MaxIts > 0 (reference:
    palace/drivers/basesolver.cpp:160-288 around drivensolver.cpp): each
    pass builds a fresh SpaceOperator, device solver and PROM on the
    refined tet mesh; hex meshes are refused (nonconforming ND AMR)."""
    t0 = time.time()
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    refuse_hex_amr(iodata, mesh, "Driven")
    post_dir = make_output_dir(iodata, output_dir)
    if iodata.model.refinement.max_it <= 0:
        result, _, _ = _solve_on_mesh(iodata, mesh, post_dir, device)
    else:
        if max(int(iodata.solver.driven.restart), 1) > 1:
            # Reference style: warn for incompatible options and continue
            # with the option disabled rather than aborting the solve.
            print_log(iodata, 'WARNING: "Restart" is incompatible with AMR; '
                              "restarting the sweep from the first sample")
            iodata.solver.driven.restart = 1

        def solve_and_estimate(m):
            canonicalize_simplices(m)
            setup0 = timers.seconds("Operator construction", "  Setup")
            solve0 = timers.seconds("Linear solve", "PROM construction")
            res, eta2_steps, energies = _solve_on_mesh(iodata, m, post_dir,
                                                       device)
            relres = (res["ksp"] or {}).get("col_relres", {})
            provenance.append("amr_passes", dict(
                elements=m.num_elements, dofs=res["num_dofs"],
                setup_s=timers.seconds("Operator construction", "  Setup")
                - setup0,
                solve_s=timers.seconds("Linear solve", "PROM construction")
                - solve0,
                solver_path=provenance.snapshot().get("solver_path"),
                max_relres=max(relres.values()) if relres else None))
            return res, eta2_steps, energies, res["num_dofs"]

        result, _, eta_norm, mesh, n_adapt = adapt_loop(
            iodata, mesh, solve_and_estimate, post_dir=post_dir)
        result["amr_iterations"] = n_adapt
        result["provenance"] = provenance.snapshot()
        print_log(iodata, f"AMR finished after {n_adapt} iterations "
                          f"(indicator norm {eta_norm:.3e})")
    print_log(iodata, f"driven done in {time.time() - t0:.1f}s")
    return result


def _solve_on_mesh(iodata: IoData, mesh, post_dir: str,
                   device: torch.device = torch.device("cpu")):
    """One full driven sweep + postprocessing on a fixed mesh; returns
    (result dict, eta2 indicator steps, step energies).  The result also
    carries the SpaceOperator, the solution vectors, the device solver's
    info and the solve provenance."""
    from palace_torch.fem import evaluation
    from palace_torch.fem.estimators import (curl_flux_indicators,
                                             grad_flux_indicators)
    from palace_torch.post import metadata

    units = iodata.units
    with timers.block("Operator construction"):
        sop = SpaceOperator(iodata, mesh, device=device)
    print_log(iodata, f"driven: {sop.space.num_dofs} dofs, "
                      f"{mesh.num_elements} elements, "
                      f"{len(sop.ports)} lumped + {len(sop.wave_ports)} wave "
                      f"ports, device {device}")

    freqs_ghz = driven_samples_ghz(iodata)
    fscale = units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fscale for f in freqs_ghz]
    excitations = sop.excitations()
    if not excitations:
        raise ValueError("driven solver requires at least one excited port")

    # Driven restart: skip already-computed (excitation, frequency) samples
    # (flattened excitation-major index, 1-based) and reload their fields.
    restart = max(int(iodata.solver.driven.restart), 1)
    skip = restart - 1
    prom = None
    if iodata.solver.driven.adaptive_tol > 0.0:
        from palace_torch.drivers.driven_adaptive import (PromReport,
                                                          sweep_adaptive)

        if restart > 1:
            raise ValueError('"Restart" is incompatible with adaptive sweeps')
        # palace.json then counts no linear-solver iterations, as the JAX
        # package's does; the HDM solves are in `prom` and provenance.
        sweep_uniform_device._last_info = None
        prom = PromReport()
        with timers.block("PROM construction"):
            sols = sweep_adaptive(iodata, sop, omegas, excitations, prom,
                                  post_dir=post_dir)
    else:
        with timers.block("Linear solve"):
            sols = sweep_uniform(iodata, sop, omegas, excitations, skip=skip)
        ckpt = os.path.join(post_dir, "checkpoint-E.npz")
        if skip > 0 and os.path.exists(ckpt):
            old = np.load(ckpt)
            for key in old.files:
                ex, i = map(int, key.split("_"))
                if (ex, i) not in sols and i < len(omegas):
                    sols[(ex, i)] = old[key]
        if parallel.is_root():
            np.savez_compressed(ckpt, **{f"{ex}_{i}": E
                                         for (ex, i), E in sols.items()})

    with timers.block("Postprocessing"):
        probe_locs = None
        if iodata.domains.probes:
            pts = np.array([nondim_point(iodata, p.center)
                            for p in iodata.domains.probes])
            probe_locs = evaluation.PointLocator(mesh).locate(pts)
        port_fn_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def port_fn(idx):
            if idx not in port_fn_cache:
                port_fn_cache[idx] = sop.port_functionals(idx)
            return port_fn_cache[idx]

        surf_traces = build_surface_traces(iodata, sop)
        ff_tb, ff_grid = build_farfield(iodata, sop)
        measurements: Dict[Tuple[int, int], StepMeasurement] = {}
        for (ex, i), E in sols.items():
            m = measure_step(sop, E, omegas[i], ex, port_fn, probe_locs)
            if sop.floquet_ports:
                m.floquet_s = sop.floquet_sparams(E, omegas[i], ex)
            measure_surfaces(iodata, sop, m, E, omegas[i], surf_traces)
            if ff_tb is not None:
                from palace_torch.post.farfield import stratton_chu

                with timers.block("  Far fields"):
                    m.farfield = stratton_chu(sop, ff_tb, E, omegas[i],
                                              ff_grid)
            measurements[(ex, i)] = m
        write_driven_tables(iodata, sop, post_dir, freqs_ghz, excitations,
                            measurements)
        if ff_tb is not None:
            write_farfield_table(iodata, sop, post_dir, freqs_ghz,
                                 excitations, measurements, ff_grid)
        with timers.block("  Paraview"):
            write_paraview_fields(iodata, sop, post_dir, freqs_ghz, omegas,
                                  excitations, sols)
        # Combined grad + curl flux indicators with B = -curl E/(i w); on a
        # 2D mesh the grad flux alone, as in palace_tpu (the reference's B
        # there is ~0, so its curl part is noise).
        eta2_steps, energies = [], []
        for (ex, i), E in sols.items():
            fk = sop.floquet_k
            if fk is not None and sop.floquet_omega_ref > 0:
                fk = fk * omegas[i]
            e2 = (np.zeros(mesh.num_elements) if mesh.nodes.shape[1] == 2
                  else curl_flux_indicators(sop.space, sop.materials, E,
                                            floquet_k=fk, device=device)
                  / omegas[i] ** 2)
            try:
                e2 = e2 + grad_flux_indicators(sop.space, sop.materials, E,
                                               device=device)
            except NotImplementedError:
                pass  # RT on hex/prism meshes: curl-only indicators
            eta2_steps.append(e2)
            mm = measurements[(ex, i)]
            energies.append(mm.E_elec + mm.E_mag + mm.E_cap + mm.E_ind)
        write_error_indicators(post_dir, eta2_steps, energies)
    metadata.save_problem(post_dir, "Driven", mesh.num_elements,
                          sop.space.num_dofs)
    metadata.save_excitations(post_dir, excitations)
    ksp_info = sweep_uniform_device._last_info or {}
    metadata.save_solver(post_dir, len(sols), ksp_info.get("total_its", 0))
    metadata.save_timing(post_dir)
    return (dict(post_dir=post_dir, num_dofs=sop.space.num_dofs,
                 freqs_ghz=freqs_ghz, measurements=measurements, sop=sop,
                 solutions=sols, omegas=omegas, ksp=ksp_info, prom=prom,
                 provenance=provenance.snapshot()),
            eta2_steps, energies)


def nodal_field(space, x: np.ndarray, which: str = "value") -> np.ndarray:
    """The complex ND field x (or its curl) averaged at the mesh nodes, real
    and imaginary parts apart: (num_nodes, sdim), for the ParaView output
    of the driven and eigenmode drivers."""
    from palace_torch.post.paraview import nodal_average_nd

    return nodal_average_nd(space, np.real(x).copy(), which) \
        + 1j * nodal_average_nd(space, np.imag(x).copy(), which)


def write_paraview_fields(iodata: IoData, sop: SpaceOperator, post_dir: str,
                          freqs_ghz, omegas, excitations, sols):
    """ParaView E and B (real and imaginary parts, averaged at the mesh
    nodes) at the requested save frequencies, one collection per
    excitation."""
    save_f = set(round(f, 9) for f in iodata.solver.driven.save_freqs)
    if not (iodata.problem.output_formats.paraview and save_f):
        return
    from palace_torch.post.paraview import ParaviewSaver

    for ex in excitations:
        pv = ParaviewSaver(post_dir, f"driven_{ex}" if multi_name(
            excitations) else "driven", sop.mesh)
        for i, f in enumerate(freqs_ghz):
            if round(f, 9) not in save_f or (ex, i) not in sols:
                continue
            E = sols[(ex, i)]
            Ev = nodal_field(sop.space, E)
            Bv = nodal_field(sop.space, E, "curl") * (-1 / (1j * omegas[i]))
            pv.save(f, {"E_real": np.real(Ev), "E_imag": np.imag(Ev),
                        "B_real": np.real(Bv), "B_imag": np.imag(Bv)})
        pv.finalize()


#: dof count above which "Default" selects the device iterative path over
#: host sparse-direct.
DEVICE_KSP_MIN_DOFS = 20000


def use_device_ksp(iodata, num_dofs: int) -> bool:
    t = iodata.solver.linear.type.lower()
    if t in ("superlu", "strumpack", "mumps"):
        return False
    if t in ("gmg", "multigrid", "ams"):
        return True
    return num_dofs >= DEVICE_KSP_MIN_DOFS


def sweep_uniform(iodata, sop: SpaceOperator, omegas, excitations, skip=0
                  ) -> Dict[Tuple[int, int], np.ndarray]:
    """Device FGMRES sweep when the configuration selects it, else sparse
    direct (always with Floquet ports, as in palace_tpu: their low-rank
    DtN term is solved by Woodbury on the host factorization).  Exceptions
    on the device path propagate (no direct fallback); columns left above
    10x the tolerance are re-solved sparse-direct and recorded in
    provenance."""
    sweep_uniform_device._last_info = None
    if sop.floquet_ports or not use_device_ksp(iodata, sop.space.num_dofs):
        provenance.record("solver_path", "direct")
        return sweep_uniform_direct(iodata, sop, omegas, excitations,
                                    skip=skip)
    sols = sweep_uniform_device(iodata, sop, omegas, excitations, skip=skip)
    info = sweep_uniform_device._last_info or {}
    provenance.record("solver_path", "device")
    provenance.record("ksp_iterations", int(info.get("total_its", 0)))
    gate = 10.0 * max(iodata.solver.linear.tol, 1e-12)
    col_relres = info.get("col_relres", {})
    bad = sorted(c for c, r in col_relres.items() if r > gate)
    if not bad:
        return sols
    print_log(iodata, f"  device ksp left {len(bad)} frequency column(s) "
                      f"above {gate:.1e} (max relres "
                      f"{max(col_relres.values()):.2e}); re-solving those "
                      "with the sparse-direct path")
    provenance.record("solver_path", f"device+fallback-{len(bad)}-columns")
    sols.update(_direct_resolve_columns(iodata, sop, omegas, bad))
    return sols


def sweep_uniform_device(iodata, sop: SpaceOperator, omegas, excitations,
                         skip=0) -> Dict[Tuple[int, int], np.ndarray]:
    """Frequency-blocked FGMRES + p-multigrid sweep on sop.device; with more
    than one rank, the dof-sharded solver over the ranks (palace_tpu:
    drivers/driven.py:474-482; it runs the ELL fine level)."""
    from palace_torch.linalg.device_ksp import BlockedDeviceSolver

    lin = iodata.solver.linear
    kw = dict(tol=lin.tol, max_its=lin.max_its,
              restart=(lin.max_size if lin.max_size > 0 else 30),
              smooth_order=(lin.mg_smooth_order if lin.mg_smooth_order > 0
                            else 4),
              smooth_its=lin.mg_smooth_its, use_aux=lin.mg_use_aux,
              coarsening=lin.mg_coarsening, max_levels=lin.mg_max_levels,
              log=lambda s: print_log(iodata, s), device=sop.device)
    args = (sop.space, iodata.boundaries.pec, sop.driven_terms(omegas),
            omegas, sop.ess_mask)
    with timers.block("  Setup"):
        if parallel.n_shards() > 1:
            from palace_torch.linalg.device_ksp_sharded import (
                ShardedBlockedDeviceSolver)

            solver = ShardedBlockedDeviceSolver(*args, **kw)
            provenance.record("parallel", solver.describe())
        else:
            solver = BlockedDeviceSolver(*args, **kw)
    provenance.record("fine_level", solver.fine_level)
    nfreq = len(omegas)
    sols: Dict[Tuple[int, int], np.ndarray] = {}
    total_its = 0
    relres_max = 0.0
    col_relres: Dict[Tuple[int, int], float] = {}
    for k, ex in enumerate(excitations):
        todo = [i for i in range(nfreq) if k * nfreq + i >= skip]
        if not todo:
            continue
        rhs1 = sop.rhs1(ex)
        rhs = np.stack([_rhs(sop, ex, w, rhs1) for w in omegas], axis=1)
        X, info = solver.solve(rhs)
        total_its += int(info["iterations"].sum())
        relres_max = max(relres_max, float(np.max(info["relres"])))
        for i in todo:
            sols[(ex, i)] = X[:, i]
            col_relres[(ex, i)] = float(info["relres"][i])
    sweep_uniform_device._last_info = {"total_its": total_its,
                                       "solves": len(sols),
                                       "relres_max": relres_max,
                                       "col_relres": col_relres}
    return sols


sweep_uniform_device._last_info = None


def _rhs(sop: SpaceOperator, ex: int, omega: float,
         rhs1: Optional[np.ndarray] = None) -> np.ndarray:
    """b(omega) = i omega rhs1 (+ the wave-port and Floquet-port RHS2 of
    excitation ex)."""
    b = 1j * omega * (sop.rhs1(ex) if rhs1 is None else rhs1)
    if sop.wave_ports:
        b = b + sop.waveport_rhs2(ex, omega)
    if sop.floquet_ports:
        b = b + sop.floquet_rhs2(ex, omega)
    return b


def _system(sop: SpaceOperator, omega: float, KCM):
    """A(omega) = K + i omega C - omega^2 M + A2(omega), PEC eliminated
    (the Floquet ports' low-rank term excepted: see `_woodbury`)."""
    A = sop.system_csr(omega, *KCM)
    A2 = sop.a2_csr(omega)
    return A if A2 is None else (A + A2).tocsr()


def _direct_resolve_columns(iodata, sop: SpaceOperator, omegas, cols
                            ) -> Dict[Tuple[int, int], np.ndarray]:
    """Sparse-direct re-solve of specific (excitation, frequency-index)
    columns (one factorization per distinct omega)."""
    from palace_torch.linalg.ordering import dof_coordinates, splu_nd

    KCM = (sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr())
    coords = dof_coordinates(sop.space)
    by_freq: Dict[int, list] = {}
    for ex, i in cols:
        by_freq.setdefault(i, []).append(ex)
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for i, ex_list in sorted(by_freq.items()):
        omega = omegas[i]
        lu = splu_nd(_system(sop, omega, KCM), coords)
        for ex in ex_list:
            out[(ex, i)] = lu.solve(_rhs(sop, ex, omega))
    return out


def _woodbury(sop: SpaceOperator, omega: float, lu):
    """x = (A + U g U^H)^-1 b from the factorization `lu` of A, with
    U diag(g) U^H the Floquet ports' low-rank DtN correction
    (`floquet_lowrank`): x = A^-1 b - A^-1 U (g^-1 + U^H A^-1 U)^-1 U^H
    A^-1 b, one solve a rank-1 term (densifying the port block into the
    sparse matrix costs the square of the port dofs).  Without Floquet
    ports, lu.solve.  Only `sweep_uniform_direct` needs it: `sweep_uniform`
    sends every sweep with Floquet ports there."""
    U, g = sop.floquet_lowrank(omega) if sop.floquet_ports else (None, None)
    if U is None:
        return lu.solve
    AinvU = np.stack([lu.solve(U[:, k]) for k in range(U.shape[1])], axis=1)
    cap = np.linalg.inv(np.diag(1.0 / g) + U.conj().T @ AinvU)

    def solve(b):
        x = lu.solve(b)
        return x - AinvU @ (cap @ (U.conj().T @ x))

    return solve


def sweep_uniform_direct(iodata, sop: SpaceOperator, omegas, excitations,
                         skip=0) -> Dict[Tuple[int, int], np.ndarray]:
    """Frequency loop with one nested-dissection-ordered sparse-direct
    factorization per frequency, reused across excitations."""
    from palace_torch.linalg.ordering import dof_coordinates, splu_nd

    KCM = (sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr())
    rhs1 = {ex: sop.rhs1(ex) for ex in excitations}
    coords = dof_coordinates(sop.space)
    ex_list = list(excitations)
    nfreq = len(omegas)
    sols = {}
    for i, omega in enumerate(omegas):
        todo = [ex for k, ex in enumerate(ex_list) if k * nfreq + i >= skip]
        if not todo:
            continue
        A = _system(sop, omega, KCM)
        solve = _woodbury(sop, omega, splu_nd(A, coords))
        for ex in todo:
            sols[(ex, i)] = solve(_rhs(sop, ex, omega, rhs1[ex]))
        print_log(iodata, f"  freq {i + 1}/{len(omegas)} solved "
                          f"({A.shape[0]} dofs x {len(todo)} excitations)")
    return sols


def multi_name(excitations) -> bool:
    return len(excitations) > 1


def build_surface_traces(iodata: IoData, sop: SpaceOperator):
    """Boundary traces for SurfaceFlux and Dielectric postprocessing."""
    from palace_torch.fem.evaluation import boundary_trace

    out = {"flux": {}, "eps": {}}
    for f in iodata.boundaries.surface_fluxes:
        center = None
        if not f.two_sided:
            center = (nondim_point(iodata, f.center) if f.center is not None
                      else _surface_bbox_center(sop.mesh, f.attributes))
        out["flux"][f.index] = boundary_trace(
            sop.mesh, f.attributes, sop.bdr_qorder, center=center,
            both_sides=True)
    for d in iodata.boundaries.dielectrics:
        out["eps"][d.index] = boundary_trace(
            sop.mesh, d.attributes, sop.bdr_qorder, both_sides=True)
    return out


def build_farfield(iodata: IoData, sop: SpaceOperator):
    """(trace basis, (theta, phi) grid) for far-field postprocessing."""
    ff = iodata.boundaries.farfield
    if ff is None or not ff.attributes or sop.mesh.nodes.shape[1] != 3:
        return None, None
    from palace_torch.fem.evaluation import boundary_trace
    from palace_torch.fem.nd_boundary import nd_trace_basis
    from palace_torch.post.farfield import sample_sphere

    tr = boundary_trace(sop.mesh, ff.attributes, sop.bdr_qorder)
    tb = nd_trace_basis(sop.space, tr)
    grid = sample_sphere(ff.n_sample, ff.theta_phis)
    return tb, grid


def write_farfield_table(iodata, sop, post_dir, freqs_ghz, excitations, meas,
                         grid):
    """farfield-rE.csv (reference: postoperatorcsv.cpp farfield table)."""
    units = iodata.units
    # The reference scales the nondimensional r*E by 1/FIELD_E for output
    # (postoperatorcsv.cpp:131-132 applies Nondimensionalize<FIELD_E> in
    # the dimensionalization pass); match its committed data convention.
    V = 1.0 / units.scale_factor(ValueType.FIELD_E)
    t = Table()
    fc = t.add(Column("f", "f (GHz)", min_left_padding=0, precision=8, sign=""))
    ec = t.add(Column("exc", "exc", min_left_padding=8, print_as_int=True))
    t.add(Column("theta", "theta (deg.)"))
    t.add(Column("phi", "phi (deg.)"))
    for d in ("x", "y", "z"):
        t.add(Column(f"re{d}", f"r*Re{{E_{d}}} (V)"))
        t.add(Column(f"im{d}", f"r*Im{{E_{d}}} (V)"))
    # Reference row order: all frequencies for one excitation, then the
    # next excitation.
    for ex in excitations:
        for i, f in enumerate(freqs_ghz):
            rE = meas[(ex, i)].farfield
            for p in range(len(grid)):
                fc.data.append(f)
                ec.data.append(ex)
                t.col("theta").data.append(math.degrees(grid[p, 0]))
                t.col("phi").data.append(math.degrees(grid[p, 1]))
                for di, d in enumerate(("x", "y", "z")):
                    t.col(f"re{d}").data.append(rE[p, di].real * V)
                    t.col(f"im{d}").data.append(rE[p, di].imag * V)
    t.write(os.path.join(post_dir, "farfield-rE.csv"))


def measure_surfaces(iodata: IoData, sop: SpaceOperator, m: StepMeasurement,
                     E: np.ndarray, omega: float, traces):
    """Surface flux + interface dielectric measurements (reference:
    postoperator.cpp MeasureSurfaceFlux/MeasureInterfaceEFieldEnergy)."""
    from palace_torch.post.surfaces import surface_flux

    for f in iodata.boundaries.surface_fluxes:
        m.surf_flux[f.index] = surface_flux(
            sop, f, traces["flux"][f.index], E, omega=omega)
    denom = m.E_elec + m.E_cap
    for d in iodata.boundaries.dielectrics:
        m.surf_q[d.index] = dielectric_pq(iodata, sop, d,
                                          traces["eps"][d.index], E, denom)


def dielectric_pq(iodata: IoData, sop: SpaceOperator, d, trace,
                  E: np.ndarray, denom: float) -> Tuple[float, float]:
    """Participation p of one Dielectric interface in the field energy
    `denom`, and its Q = 1 / (p tan delta) (inf where p or tan delta is 0);
    reference: postoperator.cpp MeasureInterfaceEFieldEnergy."""
    from palace_torch.post.surfaces import interface_energy

    class _D:
        type = d.type
        thickness = d.thickness / iodata.units.mesh_length_scale
        permittivity = d.permittivity

    en = interface_energy(sop, _D, trace, E)
    p = en / denom if denom > 0 else 0.0
    Q = (np.inf if (p == 0.0 or d.loss_tan == 0.0)
         else 1.0 / (d.loss_tan * p))
    return p, Q


# ---------------------------------------------------------------------------
# CSV output (reference: palace/models/postoperatorcsv.cpp)


def write_floquet_table(sop: SpaceOperator, post_dir: str, freqs_ghz,
                        excitations, meas):
    """port-floquet-S.csv: |S| (dB) and arg S (deg.) of every requested
    diffraction order of every Floquet port, TE and TM (RHC and LHC when
    the excitation is circularly polarized); an evanescent order prints
    NaN (reference: postoperatorcsv.cpp:1234-1276, PrintFloquetPortS)."""
    def pols(ex):
        circ = any(fp.excitation == ex and abs(fp.alpha_te) > 1e-14
                   and abs(fp.alpha_tm) > 1e-14
                   for fp in sop.floquet_ports.values())
        return ((True, "RHC" if circ else "TE"),
                (False, "LHC" if circ else "TM"))

    def columns(ex):
        for idx, fp in sorted(sop.floquet_ports.items()):
            for o in fp.orders:
                if o.out:
                    for te, pol in pols(ex):
                        yield idx, o, te, pol, f"fs{idx}_{o.m}_{o.n}_{pol}_{ex}"

    t = Table()
    fc = t.add(Column("f", "f (GHz)", min_left_padding=0, precision=8,
                      sign=""))
    for ex in excitations:
        for idx, o, te, pol, key in columns(ex):
            t.add(Column(f"abs_{key}",
                         f"|S[P{idx}({o.m};{o.n}){pol}][{ex}]| (dB)"))
            t.add(Column(f"arg_{key}",
                         f"arg(S[P{idx}({o.m};{o.n}){pol}][{ex}]) (deg.)"))
    for i, f in enumerate(freqs_ghz):
        fc.data.append(f)
        for ex in excitations:
            fs = meas[(ex, i)].floquet_s or {}
            for idx, o, te, pol, key in columns(ex):
                S = fs.get(idx, {}).get((o.m, o.n, te))
                t.col(f"abs_{key}").data.append(
                    float("nan") if S is None
                    else 20.0 * math.log10(max(abs(S), 1e-300)))
                t.col(f"arg_{key}").data.append(
                    float("nan") if S is None
                    else math.degrees(math.atan2(S.imag, S.real)))
    t.write(os.path.join(post_dir, "port-floquet-S.csv"))


def write_driven_tables(iodata: IoData, sop: SpaceOperator, post_dir: str,
                        freqs_ghz, excitations, meas):
    """port-S, port-floquet-S, port-V, port-I, port-Z, domain-E, surface-F,
    surface-Q and probe-E/B tables."""
    units = iodata.units
    multi = len(excitations) > 1

    def freq_col():
        return Column("f", "f (GHz)", min_left_padding=0, precision=8, sign="")

    V = units.scale_factor(ValueType.VOLTAGE)
    A = units.scale_factor(ValueType.CURRENT)
    J = units.scale_factor(ValueType.ENERGY)

    # port-S: columns S[observation][drive-port], over lumped and wave
    # ports.
    all_ports = sorted(list(sop.ports) + list(sop.wave_ports))
    t = Table()
    fc = t.add(freq_col())
    for ex in excitations:
        drive = [j for j, p in sop.ports.items() if p.excitation == ex] + \
                [j for j, p in sop.wave_ports.items() if p.excitation == ex]
        dsfx = f"[{drive[0]}]" if len(drive) == 1 else f"[{ex}]"
        for idx in all_ports:
            t.add(Column(f"smag{idx}{ex}", f"|S[{idx}]{dsfx}| (dB)"))
            t.add(Column(f"sarg{idx}{ex}", f"arg(S[{idx}]{dsfx}) (deg.)"))
    for i, f in enumerate(freqs_ghz):
        fc.data.append(f)
        for ex in excitations:
            for idx in all_ports:
                S = meas[(ex, i)].ports[idx].S
                t.col(f"smag{idx}{ex}").data.append(
                    20.0 * math.log10(max(abs(S), 1e-300)))
                t.col(f"sarg{idx}{ex}").data.append(
                    math.degrees(math.atan2(S.imag, S.real)))
    t.write(os.path.join(post_dir, "port-S.csv"))
    if sop.floquet_ports:
        write_floquet_table(sop, post_dir, freqs_ghz, excitations, meas)

    # port-V / port-I (lumped ports; wave ports with a VoltagePath get
    # V_wp columns in port-V).
    vwp_ports = [i for i, wp in sorted(sop.wave_ports.items())
                 if getattr(wp.cfg, "voltage_path", None)]
    for name, unit, scale, inc_fn, get in () if not sop.ports else (
        ("V", "(V)", V, lambda p: p.excitation_voltage(), lambda pm: pm.V),
        ("I", "(A)", A,
         lambda p: (p.excitation_voltage() / p.R if abs(p.R) > 0 else 0.0),
         lambda pm: pm.I),
    ):
        t = Table()
        fc = t.add(freq_col())
        for ex in excitations:
            sfx = f"[{ex}]" if multi else ""
            for d in [i for i, p in sop.ports.items() if p.excitation == ex]:
                t.add(Column(f"inc{d}{ex}", f"{name}_inc[{d}]{sfx} {unit}"))
            for idx in sop.ports:
                t.add(Column(f"re{idx}{ex}", f"Re{{{name}[{idx}]{sfx}}} {unit}"))
                t.add(Column(f"im{idx}{ex}", f"Im{{{name}[{idx}]{sfx}}} {unit}"))
            for idx in vwp_ports if name == "V" else ():
                t.add(Column(f"rew{idx}{ex}",
                             f"Re{{V_wp[{idx}]{sfx}}} {unit}"))
                t.add(Column(f"imw{idx}{ex}",
                             f"Im{{V_wp[{idx}]{sfx}}} {unit}"))
        for i, f in enumerate(freqs_ghz):
            fc.data.append(f)
            for ex in excitations:
                mm = meas[(ex, i)]
                for d in [j for j, p in sop.ports.items()
                          if p.excitation == ex]:
                    t.col(f"inc{d}{ex}").data.append(
                        inc_fn(sop.ports[d]) * scale)
                for idx in sop.ports:
                    val = get(mm.ports[idx])
                    t.col(f"re{idx}{ex}").data.append(val.real * scale)
                    t.col(f"im{idx}{ex}").data.append(val.imag * scale)
                for idx in vwp_ports if name == "V" else ():
                    val = mm.ports[idx].V
                    t.col(f"rew{idx}{ex}").data.append(val.real * scale)
                    t.col(f"imw{idx}{ex}").data.append(val.imag * scale)
        t.write(os.path.join(post_dir, f"port-{name}.csv"))

    # port-Z: wave-port impedances.  Z_PV[i] = V_exc V_exc* of the
    # power-normalized mode; Z[i][ex] = V_wp V_wp* / P with P the full
    # Poynting integral through the port (Re Z < 0 where power leaves).
    if vwp_ports:
        Ohm = units.scale_factor(ValueType.IMPEDANCE)
        t = Table()
        fc = t.add(freq_col())
        for idx in vwp_ports:
            t.add(Column(f"zpvr{idx}", f"Re{{Z_PV[{idx}]}} (Ohm)"))
            t.add(Column(f"zpvi{idx}", f"Im{{Z_PV[{idx}]}} (Ohm)"))
        for ex in excitations:
            sfx = f"[{ex}]" if multi else ""
            for idx in vwp_ports:
                t.add(Column(f"zr{idx}{ex}", f"Re{{Z[{idx}]{sfx}}} (Ohm)"))
                t.add(Column(f"zi{idx}{ex}", f"Im{{Z[{idx}]{sfx}}} (Ohm)"))
        ex0 = next(iter(excitations))
        for i, f in enumerate(freqs_ghz):
            fc.data.append(f)
            for idx in vwp_ports:
                zpv = meas[(ex0, i)].ports[idx].Z_PV * Ohm
                t.col(f"zpvr{idx}").data.append(zpv.real)
                t.col(f"zpvi{idx}").data.append(zpv.imag)
            for ex in excitations:
                for idx in vwp_ports:
                    pm = meas[(ex, i)].ports[idx]
                    Zv = (pm.V * np.conj(pm.V) / pm.P * Ohm
                          if abs(pm.P) > 0 else 0.0 + 0.0j)
                    t.col(f"zr{idx}{ex}").data.append(Zv.real)
                    t.col(f"zi{idx}{ex}").data.append(Zv.imag)
        t.write(os.path.join(post_dir, "port-Z.csv"))

    # domain-E
    t = Table()
    fc = t.add(freq_col())
    for ex in excitations:
        sfx = f"[{ex}]" if multi else ""
        t.add(Column(f"Ee{ex}", f"E_elec{sfx} (J)"))
        t.add(Column(f"Em{ex}", f"E_mag{sfx} (J)"))
        t.add(Column(f"Ec{ex}", f"E_cap{sfx} (J)"))
        t.add(Column(f"Ei{ex}", f"E_ind{sfx} (J)"))
        for ecfg in iodata.domains.energies:
            t.add(Column(f"Ee{ecfg.index}_{ex}",
                         f"E_elec[{ecfg.index}]{sfx} (J)"))
            t.add(Column(f"pe{ecfg.index}_{ex}", f"p_elec[{ecfg.index}]{sfx}"))
            t.add(Column(f"Em{ecfg.index}_{ex}",
                         f"E_mag[{ecfg.index}]{sfx} (J)"))
            t.add(Column(f"pm{ecfg.index}_{ex}", f"p_mag[{ecfg.index}]{sfx}"))
    for i, f in enumerate(freqs_ghz):
        fc.data.append(f)
        for ex in excitations:
            mm = meas[(ex, i)]
            t.col(f"Ee{ex}").data.append(mm.E_elec * J)
            t.col(f"Em{ex}").data.append(mm.E_mag * J)
            t.col(f"Ec{ex}").data.append(mm.E_cap * J)
            t.col(f"Ei{ex}").data.append(mm.E_ind * J)
            for ecfg in iodata.domains.energies:
                Ee = mm.domain_E[ecfg.index]
                Em = mm.domain_M[ecfg.index]
                t.col(f"Ee{ecfg.index}_{ex}").data.append(Ee * J)
                t.col(f"pe{ecfg.index}_{ex}").data.append(
                    Ee / mm.E_elec if mm.E_elec > 0 else 0.0)
                t.col(f"Em{ecfg.index}_{ex}").data.append(Em * J)
                t.col(f"pm{ecfg.index}_{ex}").data.append(
                    Em / mm.E_mag if mm.E_mag > 0 else 0.0)
    t.write(os.path.join(post_dir, "domain-E.csv"))

    # surface-F
    if iodata.boundaries.surface_fluxes:
        Qc = units.scale_factor(ValueType.CAPACITANCE) * units.scale_factor(
            ValueType.VOLTAGE)
        Wb = units.scale_factor(ValueType.INDUCTANCE) * units.scale_factor(
            ValueType.CURRENT)
        W = units.scale_factor(ValueType.POWER)
        t = Table()
        fc = t.add(freq_col())
        for ex in excitations:
            sfx = f"[{ex}]" if multi else ""
            for fcfg in iodata.boundaries.surface_fluxes:
                i = fcfg.index
                if fcfg.type == "Electric":
                    t.add(Column(f"fr{i}_{ex}", f"Re{{Φ_elec[{i}]{sfx}}} (C)"))
                    t.add(Column(f"fi{i}_{ex}", f"Im{{Φ_elec[{i}]{sfx}}} (C)"))
                elif fcfg.type == "Magnetic":
                    t.add(Column(f"fr{i}_{ex}", f"Re{{Φ_mag[{i}]{sfx}}} (Wb)"))
                    t.add(Column(f"fi{i}_{ex}", f"Im{{Φ_mag[{i}]{sfx}}} (Wb)"))
                else:
                    t.add(Column(f"fr{i}_{ex}", f"Φ_pow[{i}]{sfx} (W)"))
        for i, f in enumerate(freqs_ghz):
            fc.data.append(f)
            for ex in excitations:
                mm = meas[(ex, i)]
                for fcfg in iodata.boundaries.surface_fluxes:
                    v = mm.surf_flux[fcfg.index]
                    scale = {"Electric": Qc, "Magnetic": Wb,
                             "Power": W}[fcfg.type]
                    t.col(f"fr{fcfg.index}_{ex}").data.append(v.real * scale)
                    if fcfg.type != "Power":
                        t.col(f"fi{fcfg.index}_{ex}").data.append(
                            v.imag * scale)
        t.write(os.path.join(post_dir, "surface-F.csv"))

    # surface-Q
    if iodata.boundaries.dielectrics:
        t = Table()
        fc = t.add(freq_col())
        for ex in excitations:
            sfx = f"[{ex}]" if multi else ""
            for d in iodata.boundaries.dielectrics:
                t.add(Column(f"p{d.index}_{ex}", f"p_surf[{d.index}]{sfx}"))
                t.add(Column(f"q{d.index}_{ex}", f"Q_surf[{d.index}]{sfx}"))
        for i, f in enumerate(freqs_ghz):
            fc.data.append(f)
            for ex in excitations:
                mm = meas[(ex, i)]
                for d in iodata.boundaries.dielectrics:
                    p, Q = mm.surf_q[d.index]
                    t.col(f"p{d.index}_{ex}").data.append(p)
                    t.col(f"q{d.index}_{ex}").data.append(Q)
        t.write(os.path.join(post_dir, "surface-Q.csv"))

    # probe-E / probe-B
    if iodata.domains.probes:
        Efield = units.scale_factor(ValueType.FIELD_E)
        Bfield = units.scale_factor(ValueType.FIELD_B)
        for name, unit, scale, get in (
            ("E", "(V/m)", Efield, lambda mm: mm.probe_E),
            ("B", "(Wb/m²)", Bfield, lambda mm: mm.probe_B),
        ):
            t = Table()
            fc = t.add(freq_col())
            dims = ["x", "y", "z"]
            for ex in excitations:
                sfx = f"[{ex}]" if multi else ""
                for p in iodata.domains.probes:
                    for d in dims:
                        t.add(Column(f"re{d}{p.index}_{ex}",
                                     f"Re{{{name}_{d}[{p.index}]{sfx}}} {unit}"))
                        t.add(Column(f"im{d}{p.index}_{ex}",
                                     f"Im{{{name}_{d}[{p.index}]{sfx}}} {unit}"))
            for i, f in enumerate(freqs_ghz):
                fc.data.append(f)
                for ex in excitations:
                    vals = get(meas[(ex, i)])
                    for pi, p in enumerate(iodata.domains.probes):
                        for di, d in enumerate(dims):
                            t.col(f"re{d}{p.index}_{ex}").data.append(
                                vals[pi][di].real * scale)
                            t.col(f"im{d}{p.index}_{ex}").data.append(
                                vals[pi][di].imag * scale)
            t.write(os.path.join(post_dir, f"probe-{name}.csv"))
