"""Electrostatic driver (counterpart of palace_tpu/drivers/electrostatic.py;
reference: palace/drivers/electrostaticsolver.cpp).

Per-terminal Laplace solves with unit voltage (Jacobi-CG on the device);
Maxwell capacitance matrix from field energies C_ij = V_j^T K V_i; charge,
probe, and energy postprocessing written as Palace-format CSV tables.  On a
nonconforming (hex-AMR) mesh the constrained system is solved on the host
with sparse LU, as in palace_tpu.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from palace_torch.config import IoData, ValueType
from palace_torch.drivers.common import (
    compute_error_indicator_h1, domain_energies, make_output_dir,
    prepare_mesh, print_log, solve_spd, write_domain_energy_table,
    write_error_indicators, write_probe_table, write_surface_flux_table,
)
from palace_torch.models.laplace import LaplaceOperator
from palace_torch.post.tables import Column, Table, index_column
from palace_torch.utils import provenance, timers


def _solve_nonconforming(iodata, lap, P, true_idx, terminals, V, its):
    """Direct solve in the constrained true-dof space x = P x_t (reference:
    MFEM conforming prolongation inside rap.hpp:18-39; P from
    fem/hanging.py)."""
    from scipy.sparse.linalg import splu

    A = lap.K.assemble_csr().tocsr()
    At = (P.T @ A @ P).tolil()
    ess_t = np.asarray(lap.ess_mask, bool)[true_idx]
    At[ess_t, :] = 0.0
    At[:, ess_t] = 0.0
    At[ess_t, ess_t] = 1.0
    lu = splu(At.tocsc())
    provenance.record("solver_path", "direct-nonconforming")
    for idx in terminals:
        xbc, _ = lap.excitation(idx)
        xbc_t = xbc.cpu().numpy()[true_idx]
        r = -(P.T @ (A @ (P @ xbc_t)))
        r[ess_t] = 0.0
        x_t = lu.solve(r)
        x_t[ess_t] = 0.0
        V[idx] = P @ (x_t + xbc_t)
        its.append(1)
        print_log(iodata, f"  terminal {idx}: direct NC solve "
                          f"({len(true_idx)} true dofs)")


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    t0 = time.time()
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    post_dir = make_output_dir(iodata, output_dir)
    units = iodata.units
    from palace_torch.drivers.amr import adapt_loop

    def solve_and_estimate(m):
        # Canonicalize simplices up front (before any space is built on m)
        # so the ND space used by the flux estimator can be constructed.
        from palace_torch.fem.hanging import h1_hanging_matrix
        from palace_torch.mesh.mesh import canonicalize_simplices

        try:
            canonicalize_simplices(m)
        except NotImplementedError:
            pass
        with timers.block("Operator construction"):
            lap = LaplaceOperator.build(iodata, m, device=device)
            P, true_idx = h1_hanging_matrix(lap.space, m)
        space = lap.space
        print_log(iodata, f"electrostatic: {space.num_dofs} dofs, "
                          f"{m.num_elements} elements")
        terminals = sorted(lap.terminals.keys())
        V: Dict[int, np.ndarray] = {}
        its = []
        if P is not None:
            with timers.block("Linear solve"):
                _solve_nonconforming(iodata, lap, P, true_idx, terminals, V,
                                     its)
        else:
            provenance.record("solver_path", "device-cg")
            for idx in terminals:
                _, b = lap.excitation(idx)
                x, it, _ = solve_spd(iodata, lap.Keli, lap.K, b, lap.ess_mask)
                its.append(it)
                V[idx] = x.cpu().numpy()
                print_log(iodata, f"  terminal {idx}: {it} CG iterations")
        # Grad-flux indicators on E = -grad V interpolated into the ND space
        # (reference: electrostaticsolver.cpp:77-86 — E in ND via the
        # discrete gradient, GradFluxErrorEstimator with RT_{p-1} recovery).
        with timers.block("Estimator solve"):
            try:
                from palace_torch.fem.estimators import grad_flux_indicators
                from palace_torch.fem.nd import NDSpace
                from palace_torch.fem.nd_operators import nd_h1_gradient

                nd = NDSpace(m, iodata.solver.order)
                G = nd_h1_gradient(nd, space)
                eta2 = [grad_flux_indicators(nd, lap.materials, -(G @ V[i]),
                                             device=device)
                        for i in terminals]
            except NotImplementedError:
                eta2 = [compute_error_indicator_h1(iodata, space,
                                                   lap.materials, V[i],
                                                   device=device)
                        for i in terminals]
            en = [domain_energies(iodata, lap.K, space, V[i])[0]
                  for i in terminals]
        return (lap, V, its), eta2, en, space.num_dofs

    (lap, V, its), eta_elem, eta_norm, mesh, n_adapt = adapt_loop(
        iodata, mesh, solve_and_estimate, post_dir=post_dir)
    space = lap.space
    terminals = sorted(lap.terminals.keys())
    n = len(terminals)

    with timers.block("Postprocessing"):
        # Capacitance matrix C_ij = V_j^T K V_i (unit voltages).
        KV = {i: lap.K(V[i]).cpu().numpy() for i in terminals}
        C = np.zeros((n, n))
        for a, i in enumerate(terminals):
            for b_, j in enumerate(terminals):
                C[a, b_] = V[j] @ KV[i]
        C = 0.5 * (C + C.T)
        # Mutual capacitance matrix (reference:
        # electrostaticsolver.cpp:125-141): Cm_ij = -C_ij (i != j),
        # Cm_ii = C_ii + sum_{j != i} C_ij.
        Cm = -C.copy()
        for a in range(n):
            Cm[a, a] = C[a, a] + np.sum(np.delete(C[a], a))
        Cinv = np.linalg.inv(C)

        farads = units.scale_factor(ValueType.CAPACITANCE)

        def write_matrix(fname, name, unit, mat, scale):
            t = Table()
            t.add(index_column())
            for j in terminals:
                t.add(Column(f"i2{j}", f"{name}[i][{j}] {unit}"))
            for a, i in enumerate(terminals):
                t.col("i").data.append(float(i))
                for b_, j in enumerate(terminals):
                    t.col(f"i2{j}").data.append(mat[a, b_] * scale)
            t.write(os.path.join(post_dir, fname))

        write_matrix("terminal-C.csv", "C", "(F)", C, farads)
        write_matrix("terminal-Cinv.csv", "C⁻¹", "(1/F)", Cinv, 1.0 / farads)
        write_matrix("terminal-Cm.csv", "C_m", "(F)", Cm, farads)

        tv = Table()
        tv.add(index_column())
        tv.add(Column("Vinc", "V_inc[i] (V)"))
        for i in terminals:
            tv.col("i").data.append(float(i))
            tv.col("Vinc").data.append(
                units.dimensionalize(ValueType.VOLTAGE, 1.0))
        tv.write(os.path.join(post_dir, "terminal-V.csv"))

        # Step-indexed measurements (one row per terminal solve).
        steps = [(float(i), V[i]) for i in terminals]
        write_domain_energy_table(iodata, post_dir, lap.K, space, steps)
        write_probe_table(iodata, post_dir, space, steps)
        write_surface_flux_table(iodata, post_dir, space, lap.materials,
                                 steps)
        write_error_indicators(post_dir, [eta_elem**2], [None])

    print_log(iodata, f"electrostatic done in {time.time() - t0:.1f}s")
    from palace_torch.post import metadata

    metadata.save_problem(post_dir, "Electrostatic", mesh.num_elements,
                          space.num_dofs)
    metadata.save_timing(post_dir)
    return dict(C=C * farads, Cm=Cm * farads, Cinv=Cinv / farads,
                iterations=its, num_dofs=space.num_dofs, post_dir=post_dir,
                V=V, operator=lap, amr_iterations=n_adapt,
                provenance=provenance.snapshot())
