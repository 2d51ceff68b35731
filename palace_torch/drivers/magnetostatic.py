"""Magnetostatic driver (counterpart of palace_tpu/drivers/magnetostatic.py;
reference: palace/drivers/magnetostaticsolver.cpp).

Per-source curl-curl solves with unit current (Jacobi-CG on the device);
Maxwell inductance matrix from field energies M_ij = A_j^T K A_i; B = curl A
for probes and fluxes.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from palace_torch.config import IoData, ValueType
from palace_torch.drivers.common import (
    _surface_bbox_center, make_output_dir, nondim_point, prepare_mesh,
    print_log, solve_spd, write_error_indicators,
)
from palace_torch.fem import evaluation
from palace_torch.models.curlcurl import CurlCurlOperator
from palace_torch.post.tables import Column, Table, index_column
from palace_torch.utils import provenance, timers


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    """Magnetostatic solve inside the reference's AMR wrapper when
    Model/Refinement/MaxIts > 0 (reference: basesolver.cpp
    SolveEstimateMarkRefine around magnetostaticsolver.cpp)."""
    t0 = time.time()
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    from palace_torch.drivers.amr import adapt_loop, refuse_hex_amr

    refuse_hex_amr(iodata, mesh, "Magnetostatic")
    from palace_torch.fem.estimators import curl_flux_indicators
    from palace_torch.mesh.mesh import canonicalize_simplices

    post_dir = make_output_dir(iodata, output_dir)
    units = iodata.units

    def solve_and_estimate(m):
        canonicalize_simplices(m)
        with timers.block("Operator construction"):
            cc = CurlCurlOperator.build(iodata, m, device=device)
        print_log(iodata, f"magnetostatic: {cc.space.num_dofs} dofs, "
                          f"{m.num_elements} elements")
        provenance.record("solver_path", "device-cg")
        sources = sorted(cc.sources.keys())
        A: Dict[int, np.ndarray] = {}
        its = []
        for idx in sources:
            with timers.block("Operator construction"):
                b = cc.excitation(idx)
            x, it, _ = solve_spd(iodata, cc.Keli, cc.K, b, cc.ess_mask)
            its.append(it)
            A[idx] = x.cpu().numpy()
            print_log(iodata, f"  source {idx}: {it} CG iterations")
        # Curl-flux indicators on B = curl A per source, normalized by the
        # source's magnetic energy (reference: magnetostaticsolver.cpp:96
        # CurlFluxErrorEstimator::AddErrorIndicator(B, total energy)).
        with timers.block("Estimator solve"):
            KA = {i: cc.K(A[i]).cpu().numpy() for i in sources}
            eta2 = [curl_flux_indicators(cc.space, cc.materials, A[i],
                                         device=device) for i in sources]
            en = [0.5 * float(A[i] @ KA[i]) for i in sources]
        return (cc, A, its, KA, eta2, en), eta2, en, cc.space.num_dofs

    ((cc, A, its, KA, eta2_steps, energies), _, _, mesh,
     n_adapt) = adapt_loop(iodata, mesh, solve_and_estimate,
                           post_dir=post_dir)
    space = cc.space
    sources = sorted(cc.sources.keys())
    n = len(sources)

    with timers.block("Postprocessing"):
        # Inductance matrix M_ij = A_j^T K A_i (unit currents).
        M = np.zeros((n, n))
        for a_, i in enumerate(sources):
            for b_, j in enumerate(sources):
                M[a_, b_] = A[j] @ KA[i]
        M = 0.5 * (M + M.T)
        Mm = -M.copy()
        for a_ in range(n):
            Mm[a_, a_] = M[a_, a_] + np.sum(np.delete(M[a_], a_))
        Minv = np.linalg.inv(M)

        henries = units.scale_factor(ValueType.INDUCTANCE)

        def write_matrix(fname, name, unit, mat, scale):
            t = Table()
            t.add(index_column())
            for j in sources:
                t.add(Column(f"i2{j}", f"{name}[i][{j}] {unit}"))
            for a_, i in enumerate(sources):
                t.col("i").data.append(float(i))
                for b_, j in enumerate(sources):
                    t.col(f"i2{j}").data.append(mat[a_, b_] * scale)
            t.write(os.path.join(post_dir, fname))

        write_matrix("terminal-M.csv", "M", "(H)", M, henries)
        write_matrix("terminal-Minv.csv", "M⁻¹", "(1/H)", Minv, 1.0 / henries)
        write_matrix("terminal-Mm.csv", "M_m", "(H)", Mm, henries)

        ti = Table()
        ti.add(index_column())
        ti.add(Column("Iinc", "I_inc[i] (A)"))
        for i in sources:
            ti.col("i").data.append(float(i))
            ti.col("Iinc").data.append(
                units.dimensionalize(ValueType.CURRENT, 1.0))
        ti.write(os.path.join(post_dir, "terminal-I.csv"))

        _write_domain_energy(iodata, post_dir, cc, sources, A)
        _write_probe_B(iodata, post_dir, space, sources, A)
        _write_surface_flux(iodata, post_dir, space, sources, A)
        write_error_indicators(post_dir, eta2_steps, energies)

    print_log(iodata, f"magnetostatic done in {time.time() - t0:.1f}s")
    from palace_torch.post import metadata

    metadata.save_problem(post_dir, "Magnetostatic", mesh.num_elements,
                          space.num_dofs)
    metadata.save_timing(post_dir)
    return dict(M=M * henries, Mm=Mm * henries, iterations=its,
                num_dofs=space.num_dofs, post_dir=post_dir, A=A,
                operator=cc, amr_iterations=n_adapt,
                provenance=provenance.snapshot())


def _write_domain_energy(iodata, post_dir, cc, sources, A):
    units = iodata.units
    J = units.scale_factor(ValueType.ENERGY)
    t = Table()
    t.add(index_column())
    t.add(Column("Ee", "E_elec (J)"))
    t.add(Column("Em", "E_mag (J)"))
    t.add(Column("Ec", "E_cap (J)"))
    t.add(Column("Ei", "E_ind (J)"))
    for ecfg in iodata.domains.energies:
        t.add(Column(f"Ee{ecfg.index}", f"E_elec[{ecfg.index}] (J)"))
        t.add(Column(f"pe{ecfg.index}", f"p_elec[{ecfg.index}]"))
        t.add(Column(f"Em{ecfg.index}", f"E_mag[{ecfg.index}] (J)"))
        t.add(Column(f"pm{ecfg.index}", f"p_mag[{ecfg.index}]"))
    for idx in sources:
        per_bucket = [e.cpu().numpy() for e in cc.K.element_energy(A[idx])]
        total = float(sum(float(np.sum(e)) for e in per_bucket))
        t.col("i").data.append(float(idx))
        t.col("Ee").data.append(0.0)
        t.col("Em").data.append(total * J)
        t.col("Ec").data.append(0.0)
        t.col("Ei").data.append(0.0)
        for ecfg in iodata.domains.energies:
            s = 0.0
            for b, e in zip(cc.space.mesh.buckets, per_bucket):
                s += float(np.sum(e * np.isin(b.attr, ecfg.attributes)))
            t.col(f"Ee{ecfg.index}").data.append(0.0)
            t.col(f"pe{ecfg.index}").data.append(0.0)
            t.col(f"Em{ecfg.index}").data.append(s * J)
            t.col(f"pm{ecfg.index}").data.append(
                s / total if total > 0 else 0.0)
    t.write(os.path.join(post_dir, "domain-E.csv"))


def _write_probe_B(iodata, post_dir, space, sources, A):
    if not iodata.domains.probes:
        return
    units = iodata.units
    scale = units.scale_factor(ValueType.FIELD_B)
    locator = evaluation.PointLocator(space.mesh)
    pts = np.array([nondim_point(iodata, p.center)
                    for p in iodata.domains.probes])
    locs = locator.locate(pts)
    t = Table()
    t.add(index_column())
    for p in iodata.domains.probes:
        for d in ["x", "y", "z"]:
            t.add(Column(f"B{d}{p.index}", f"B_{d}[{p.index}] (Wb/m²)"))
    for idx in sources:
        B = evaluation.eval_nd(space, A[idx], locs, which="curl")
        t.col("i").data.append(float(idx))
        for pi, p in enumerate(iodata.domains.probes):
            for di, d in enumerate(["x", "y", "z"]):
                t.col(f"B{d}{p.index}").data.append(float(B[pi, di]) * scale)
    t.write(os.path.join(post_dir, "probe-B.csv"))


def _write_surface_flux(iodata, post_dir, space, sources, A):
    fluxes = [f for f in iodata.boundaries.surface_fluxes
              if f.type == "Magnetic"]
    if not fluxes:
        return
    units = iodata.units
    t = Table()
    t.add(index_column())
    q = 2 * space.order + 2
    traces = {}
    for f in fluxes:
        t.add(Column(f"F{f.index}", f"Φ_mag[{f.index}] (Wb)"))
        center = (nondim_point(iodata, f.center) if f.center is not None
                  else _surface_bbox_center(space.mesh, f.attributes))
        traces[f.index] = evaluation.boundary_trace(
            space.mesh, f.attributes, q, center=center)
    weber = units.scale_factor(ValueType.INDUCTANCE) * units.scale_factor(
        ValueType.CURRENT)
    for idx in sources:
        t.col("i").data.append(float(idx))
        for f in fluxes:
            tr = traces[f.index]
            B = evaluation.trace_nd(space, A[idx], tr, which="curl")
            flux = float(np.einsum("eq,eqs,eqs->", tr.wdetJ, B, tr.normal))
            t.col(f"F{f.index}").data.append(flux * weber)
    t.write(os.path.join(post_dir, "surface-F.csv"))
