"""Adaptive fast frequency sweep via a projection-based reduced-order model
(counterpart of palace_tpu/drivers/driven_adaptive.py; reference:
palace/models/romoperator.cpp, palace/drivers/drivensolver.cpp:235-486).

Offline greedy sampling driven by minimal rational interpolation (MRI): the
next high-fidelity (HDM) sample is placed at the minimizer of the MRI
denominator |Q(z)| = |sum_i q_i / (z - z_i)| over a 200,001-point grid, the
sample's true PROM error ||E - V y|| / ||E|| is recorded, and the loop stops
after `AdaptiveMemory` consecutive samples below `AdaptiveTol` or at
`AdaptiveMaxSamples`.  HDM solutions are orthonormalized into the reduced
basis V with CGS2.  Online: per frequency solve (V^H A(omega) V) z =
V^H b(omega), E = V z.

The reduced-order bookkeeping (basis, MRI, reduced tables, online dense
solves) is host float64/complex128 numpy, as in the JAX package: the MRI's
grid argmin picks the next sample, and another summation order could pick a
neighbouring grid point.  Each HDM solve is one complex column of the
device FGMRES + p-MG solver (`BlockedDeviceSolver`, `max_block=1`, sample
frequencies added by `add_omega`), whose structured fine level launches the
natural-layout structured-apply kernel.

Wave ports enter through the factored form of their contribution,
A_wp(omega) = i sum_p Re kn_p(omega) Mwp_p with constant PEC-eliminated
boundary masses Mwp_p: the reduced projections Wr_p = V^H Mwp_p V are
updated with the basis, and the online dense solve only evaluates the
scalar Re kn_p(omega) (reference: romoperator.hpp:177-187); the excitation
adds the projected wave-port RHS2.  The finite-conductivity (~ sqrt(omega))
and second-order absorbing (~ 1/omega) terms do not factor this way: they
are re-assembled and re-projected at every evaluation frequency (the slow
path, romoperator.hpp:186-189), and with them every HDM solve is sparse
direct, as in palace_tpu.  That is a route, not a fallback: the provenance
records it as `prom_hdm_path = "direct-slow-a2"` ("device" or "direct"
otherwise).

The Floquet volume terms enter K when they do not scale with omega; with
FloquetReferenceFrequency they are omega^2 Fm + i omega Fc, and the
reduced tables carry V^H Fm V and V^H Fc V for the online solve.  That is
a deliberate divergence: palace_tpu's PROM leaves them out of the reduced
system (its HDM solves have them), and its adaptive sweep then disagrees
with its uniform one (249x relative to the maximum E_elec on a periodic
box_tet(3,3,3), Order 2, 14-17 GHz).  Floquet ports are refused
(`unported`, ROADMAP "adaptive sweeps with Floquet ports"): palace_tpu's
PROM never adds their RHS2 or low-rank term and fails on the empty
excitation.

Deliberate divergence from the JAX package: an exception raised while
building or running the device solver propagates; there is no quiet
sparse-direct HDM path behind it.  A device solve left above
max(100 Tol, 1e-8) is re-solved sparse-direct (numerics, counted in
provenance as `prom_hdm_direct_fallbacks`).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from palace_torch.drivers.common import print_log
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.ops.partial import signed_tables
from palace_torch.utils import provenance, unported


def _orthonormalize(V: List[np.ndarray], w: np.ndarray,
                    R: List[np.ndarray] | None = None) -> List[np.ndarray]:
    """CGS2 against the current basis; append if not in span.  When R is
    given, the orthogonalization coefficients (upper-triangular column
    [h_0..h_{m-1}, ||residual||]) are recorded: the reference's orth_R,
    whose diagonal carries the pre-normalization vector norms used by the
    circuit-synthesis scaling (romoperator.cpp:979-1000)."""
    h = np.zeros(len(V) + 1, complex)
    for _ in range(2):
        for i, v in enumerate(V):
            c = np.vdot(v, w)
            h[i] += c
            w = w - c * v
    n = np.linalg.norm(w)
    h[-1] = n
    if n > 1e-13:
        V.append(w / n)
        if R is not None:
            R.append(h)
    return V


class MinimalRationalInterpolation:
    """MRI of the frequency response used as the greedy error surrogate
    (reference: romoperator.cpp:149-172 ComputeMRI, 233-360).

    Snapshots [u; i omega u] are QR-accumulated (CGS2); the interpolation
    weights q are the right singular vector of R for the smallest singular
    value, with rank-deficiency fallback (ORTHOG_TOL)."""

    def __init__(self):
        self.Q: List[np.ndarray] = []
        self.R = np.zeros((0, 0), complex)
        self.z: List[float] = []
        self.q: np.ndarray | None = None

    def add_sample(self, omega: float, u: np.ndarray):
        col = np.concatenate([u, 1j * omega * u]).astype(complex)
        S = len(self.z)
        R = np.zeros((S + 1, S + 1), complex)
        R[:S, :S] = self.R
        for _ in range(2):
            for i, qv in enumerate(self.Q):
                h = np.vdot(qv, col)
                R[i, S] += h
                col = col - h * qv
        nrm = np.linalg.norm(col)
        R[S, S] = nrm
        self.Q.append(col / nrm if nrm > 0 else col)
        self.R = R
        self.z.append(float(omega))
        _, s, Vh = np.linalg.svd(R)
        m = len(s) - 1
        while m > 0 and s[m] < 1e-12 * s[0]:
            m -= 1
        self.q = Vh[m].conj()

    def find_max_error(self, n_grid: int = 200000) -> float:
        """argmin_z |Q(z)| over [min z, max z] (brute-force fine grid,
        reference: romoperator.cpp:318-360)."""
        z = np.asarray(self.z)
        grid = np.linspace(z.min(), z.max(), n_grid + 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            Qv = np.abs((self.q[None, :] / (grid[:, None] - z[None, :]))
                        .sum(axis=1))
        Qv[~np.isfinite(Qv)] = np.inf
        return float(grid[int(np.argmin(Qv))])


def _print_prom_matrices(iodata, sop, post_dir, V, labels, orth_R,
                         n_port_modes, K, C, M):
    """Write the circuit-synthesis reduced matrices rom-Linv/rom-C/rom-Rinv
    (+ the orthogonalization matrix R) as CSV tables (reference:
    romoperator.cpp:970-1094 CalculateNormalizedPROMMatrices /
    PrintPROMMatrices).  Port rows/cols are scaled by orth_R's diagonal to
    recover the physical port-port circuit block; sample rows keep unit
    scaling (their normalization is irrelevant for port quantities)."""
    from palace_torch.config import ValueType
    from palace_torch.post.tables import Column, Table

    units = iodata.units
    m = len(V)
    Vm = np.stack(V, axis=1)
    R = np.zeros((m, m), complex)
    for j, col in enumerate(orth_R):
        R[: len(col), j] = col
    v_conc = np.ones(m)
    for j in range(n_port_modes):
        v_conc[j] = R[j, j].real
    D = np.diag(v_conc)

    Kr = D @ (Vm.conj().T @ (K @ Vm)) @ D
    Mr = D @ (Vm.conj().T @ (M @ Vm)) @ D
    Cr = D @ (Vm.conj().T @ (C @ Vm)) @ D if C is not None else None

    L_inv = Kr / units.scale_factor(ValueType.INDUCTANCE)
    C_mat = Mr * units.scale_factor(ValueType.CAPACITANCE)
    R_inv = (Cr / units.scale_factor(ValueType.IMPEDANCE)
             if Cr is not None else None)

    def write(mat, name):
        t = Table()
        cols = [t.add(Column(f"c{i}", lab, precision=17))
                for i, lab in enumerate(labels)]
        for i in range(m):
            for j in range(m):
                cols[j].data.append(float(mat[i, j]))
        t.write(os.path.join(post_dir, name))

    write(L_inv.real, "rom-Linv-re.csv")
    write(C_mat.real, "rom-C-re.csv")
    if np.iscomplexobj(K) and np.abs(L_inv.imag).max() > 0:
        write(L_inv.imag, "rom-Linv-im.csv")
        write(C_mat.imag, "rom-C-im.csv")
    if R_inv is not None:
        write(R_inv.real, "rom-Rinv-re.csv")
        if np.iscomplexobj(C) and np.abs(R_inv.imag).max() > 0:
            write(R_inv.imag, "rom-Rinv-im.csv")
    write(R.real, "rom-orthogonalization-matrix-R.csv")


def _reduced_tables(V, K, C, M, rhs1, Mwp, flo=None):
    """(Vm, V^H K V, V^H C V or None, V^H M V, {port: V^H Mwp V},
    {ex: V^H b1}, (V^H Fm V, V^H Fc V) or None) of the basis (host scipy
    products over the whole basis, as the reference recomputes them at
    every greedy iteration); `flo` is the frequency-scaled Floquet pair
    (Fm, Fc) or None."""
    Vm = np.stack(V, axis=1)  # (n, m)
    Kr = Vm.conj().T @ (K @ Vm)
    Cr = Vm.conj().T @ (C @ Vm) if C is not None else None
    Mr = Vm.conj().T @ (M @ Vm)
    Wr = {idx: Vm.conj().T @ (Mp @ Vm) for idx, Mp in Mwp.items()}
    b1r = {ex: Vm.conj().T @ b for ex, b in rhs1.items()}
    Fr = (None if flo is None
          else tuple(Vm.conj().T @ (X @ Vm) for X in flo))
    return Vm, Kr, Cr, Mr, Wr, b1r, Fr


def _prom_solve(om, ex, tabs, kn, a2_extra, rhs2):
    """Reduced coefficients z of (V^H A(om) V) z = V^H b(om); `kn(port, om)`
    is Re kn of a wave port, `a2_extra(om)` the non-factorable A2 CSR (or
    None), `rhs2(ex, om)` the wave-port RHS2 (or None)."""
    Vm, Kr, Cr, Mr, Wr, b1r, Fr = tabs
    Ar = Kr - om * om * Mr
    if Cr is not None:
        Ar = Ar + 1j * om * Cr
    if Fr is not None:
        Ar = Ar + om * om * Fr[0] + 1j * om * Fr[1]
    for idx, W in Wr.items():
        Ar = Ar + 1j * kn(idx, om) * W
    X = a2_extra(om)
    if X is not None:
        Ar = Ar + Vm.conj().T @ (X @ Vm)  # slow path: project per omega
    br = 1j * om * b1r[ex]
    b2 = rhs2(ex, om)
    if b2 is not None:
        br = br + Vm.conj().T @ b2
    return np.linalg.solve(Ar, br)


@dataclass
class PromReport:
    """What one adaptive sweep did, filled in by `sweep_adaptive` for the
    caller that passes it: per HDM sample (excitation, omega, the PROM error
    measured before the sample joined the basis, inf at the two endpoints),
    the final basis size, each excitation's stopping reason ("memory" or
    "max samples"), each sample's HDM solution, device FGMRES iterations and
    relres, and the device solver (None on the sparse-direct path)."""

    samples: List[Tuple[int, float, float]] = field(default_factory=list)
    basis_size: int = 0
    stopped_by: Dict[int, str] = field(default_factory=dict)
    hdm: Dict[Tuple[int, float], np.ndarray] = field(default_factory=dict)
    hdm_iterations: Dict[Tuple[int, float], int] = field(default_factory=dict)
    hdm_relres: Dict[Tuple[int, float], float] = field(default_factory=dict)
    solver: Optional[object] = None


def sweep_adaptive(iodata, sop: SpaceOperator, omegas, excitations,
                   report: PromReport, post_dir: str | None = None
                   ) -> Dict[Tuple[int, int], np.ndarray]:
    """The PROM's solution at every (excitation, frequency index); what the
    greedy loop did goes into `report`."""
    from palace_torch.drivers.driven import _rhs, _system, use_device_ksp
    from palace_torch.linalg.ordering import dof_coordinates, splu_nd

    if sop.floquet_ports:
        unported("Adaptive sweeps with Floquet ports",
                 "adaptive sweeps with Floquet ports")
    cfg = iodata.solver.driven
    tol = cfg.adaptive_tol
    max_size = max(cfg.adaptive_max_size, 4)
    conv_memory = max(cfg.adaptive_memory, 1)

    K = sop.stiffness_csr()
    C = sop.damping_csr()
    M = sop.mass_csr()
    flo = (sop.floquet_csrs() if sop.K_flo_mass is not None
           and sop.floquet_omega_ref > 0.0 else None)
    coords = dof_coordinates(sop.space)
    rhs1 = {ex: sop.rhs1(ex).astype(complex) for ex in excitations}
    free_mask = ~sop.ess_mask
    wave_ports = {idx: wp for idx, wp in sop.wave_ports.items() if wp.active}
    Mwp = {idx: sop._free_csr(signed_tables([sop._waveport_mass_bucket(idx)]))
           for idx in wave_ports}

    def kn(idx, omega):
        # Re kn only, as in the uniform sweep's term (the reference ROM's
        # GetWavePortKn -> kn0.real(), romoperator.cpp:889).
        return float(wave_ports[idx].solve_mode(omega).kn.real)

    def rhs2(ex, omega):
        return sop.waveport_rhs2(ex, omega) if sop.wave_ports else None

    # Non-factorable A2(omega) terms, re-assembled per frequency (cached).
    has_slow_a2 = bool(sop._conductivity) or sop._abc2_tb is not None
    a2_cache: Dict[float, object] = {}

    def a2_extra(omega):
        if not has_slow_a2:
            return None
        key = float(omega)
        if key not in a2_cache:
            parts = [X for X in (sop.conductivity_a2_csr(omega),
                                 sop.abc2_a2_csr(omega)) if X is not None]
            a2_cache[key] = sum(parts[1:], parts[0]).tocsr()
        return a2_cache[key]

    def rhs(ex, omega):
        return _rhs(sop, ex, omega, rhs1[ex])

    def prom_solve(om, ex, tabs):
        return _prom_solve(om, ex, tabs, kn, a2_extra, rhs2)

    # Greedy HDM solves: the device FGMRES + p-MG solver with lazily added
    # sample frequencies (add_omega), built at the first sample; with the
    # slow A2 terms, sparse direct.
    omega_idx: Dict[float, int] = {}
    lin = iodata.solver.linear
    if has_slow_a2:
        hdm_path = "direct-slow-a2"
    else:
        hdm_path = ("device" if use_device_ksp(iodata, sop.space.num_dofs)
                    else "direct")

    def device_solver():
        if report.solver is None:
            from palace_torch.linalg.device_ksp import BlockedDeviceSolver

            report.solver = BlockedDeviceSolver(
                sop.space, iodata.boundaries.pec, sop.driven_terms([]), [],
                sop.ess_mask, tol=lin.tol, max_its=lin.max_its,
                restart=(lin.max_size if lin.max_size > 0 else 30),
                max_block=1, log=lambda s: print_log(iodata, s),
                device=sop.device)
            provenance.record("fine_level", report.solver.fine_level)
        return report.solver

    def solve_hdm(omega, ex):
        provenance.record("solver_path", "prom-adaptive")
        provenance.record("prom_hdm_path", hdm_path)
        if hdm_path == "device":
            solver = device_solver()
            if omega not in omega_idx:
                omega_idx[omega] = solver.add_omega(omega)
            b = rhs(ex, omega).copy()
            b[~free_mask] = 0.0
            X, info = solver.solve(b[:, None], omega_idx=[omega_idx[omega]])
            relres = float(np.max(info["relres"]))
            report.hdm_iterations[(ex, omega)] = int(info["iterations"][0])
            report.hdm_relres[(ex, omega)] = relres
            provenance.add("ksp_iterations", int(info["iterations"][0]))
            if relres <= max(100.0 * lin.tol, 1e-8):
                return X[:, 0]
            print_log(iodata, "  PROM: device HDM solve not converged; "
                              "sparse-direct fallback for this sample")
            provenance.add("prom_hdm_direct_fallbacks", 1)
        A = _system(sop, omega, (K, C, M)).tocsc()
        return splu_nd(A, coords).solve(rhs(ex, omega))

    V: List[np.ndarray] = []
    labels: List[str] = []
    orth_R: List[np.ndarray] = []

    def add_vector(w, label):
        before = len(V)
        _orthonormalize(V, w, orth_R)
        if len(V) > before:
            labels.append(label)

    def add_solution(E, label="sample"):
        add_vector(E.real.astype(complex), label)
        add_vector(1j * E.imag.astype(complex), label)

    # Circuit synthesis: seed the basis with the lumped-port mode fields so
    # the reduced K/C/M carry a port-port circuit block (reference:
    # romoperator.cpp:624-675 AddLumpedPortModesForSynthesis; port modes
    # come first and in port order).
    synthesis = bool(cfg.adaptive_circuit_synthesis)
    n_port_modes = 0
    if synthesis:
        for idx in sorted(sop.ports):
            et = sop.lumped_port_primary_et(idx).astype(complex)
            add_vector(et, f"port_{idx}")
        n_port_modes = len(V)

    omega_lo, omega_hi = float(min(omegas)), float(max(omegas))
    total_hdm = 0
    for ex in excitations:
        mri = MinimalRationalInterpolation()
        sample_no = 0
        # Endpoint initialization (drivensolver.cpp:1167 prom_indices); the
        # PROM error estimates there are inaccurate.
        for om in (omega_lo, omega_hi):
            E = report.hdm[(ex, om)] = solve_hdm(om, ex)
            total_hdm += 1
            report.samples.append((ex, om, math.inf))
            add_solution(E, f"sample_e{ex}_s{sample_no}")
            sample_no += 1
            mri.add_sample(om, E)
        err = math.inf
        memory = 0
        it = 2
        while it < max_size and memory < conv_memory:
            om_star = mri.find_max_error()
            E = report.hdm[(ex, om_star)] = solve_hdm(om_star, ex)
            total_hdm += 1
            tabs = _reduced_tables(V, K, C, M, rhs1, Mwp, flo)
            z = prom_solve(om_star, ex, tabs)
            err = (np.linalg.norm(tabs[0] @ z - E)
                   / max(np.linalg.norm(E), 1e-300))
            report.samples.append((ex, om_star, float(err)))
            memory = memory + 1 if err < tol else 0
            print_log(iodata, f"  PROM greedy it {it - 1} (n = {len(V)}): "
                              f"omega* = {om_star:.6f}, error = {err:.3e}, "
                              f"memory = {memory}/{conv_memory}")
            add_solution(E, f"sample_e{ex}_s{sample_no}")
            sample_no += 1
            mri.add_sample(om_star, E)
            it += 1
        converged = memory >= conv_memory
        report.stopped_by[ex] = "memory" if converged else "max samples"
        status = "converged" if converged else "reached maximum samples"
        print_log(iodata, f"  PROM {status}: {it} samples, basis {len(V)}, "
                          f"last error {err:.3e} (tol {tol:.1e})")

    if synthesis and post_dir is not None:
        _print_prom_matrices(iodata, sop, post_dir, V, labels, orth_R,
                             n_port_modes, K, C, M)

    # Online sweep.
    tabs = _reduced_tables(V, K, C, M, rhs1, Mwp, flo)
    Vm = tabs[0]
    report.basis_size = len(V)
    sols = {}
    for i, om in enumerate(omegas):
        for ex in excitations:
            sols[(ex, i)] = Vm @ prom_solve(om, ex, tabs)
    print_log(iodata, f"  PROM online: {len(omegas)} frequencies x "
                      f"{len(excitations)} excitations (basis {len(V)}, "
                      f"{total_hdm} HDM solves)")
    return sols
