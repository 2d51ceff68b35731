"""Shared driver utilities: logging, mesh preparation, output directory,
the SPD solve (single device, or dof-sharded over the ranks), coordinates,
the measurement tables of the static drivers and the error-indicator table
(counterpart of palace_tpu/drivers/common.py).  Only rank 0 logs and makes
the output directory."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from palace_torch import parallel
from palace_torch.config import IoData, ValueType
from palace_torch.fem import evaluation
from palace_torch.mesh.mesh import Mesh, load_mesh
from palace_torch.post.tables import Column, Table, index_column
from palace_torch.utils import provenance, timers


def print_log(iodata: IoData, msg: str):
    """Log on rank 0 (every run has one) when the config is verbose."""
    if iodata.problem.verbose > 0 and parallel.is_root():
        print(f"[palace-torch] {msg}", flush=True)


def prepare_mesh(iodata: IoData) -> Mesh:
    """Load the mesh, set units (Lc defaults to the max bounding-box extent),
    nondimensionalize coordinates, refine uniformly, crack interior boundary
    sheets and identify periodic boundaries, as the JAX package does."""
    mesh = load_mesh(iodata.mesh_path())
    bbmin, bbmax = mesh.bounding_box()
    iodata.set_units_from_mesh(float((bbmax - bbmin).max()))
    mesh.scale_coordinates(iodata.units.mesh_length_scale)
    if iodata.model.refinement.uniform_ref_levels > 0:
        from palace_torch.mesh.refine import refine_uniform

        mesh = refine_uniform(mesh, iodata.model.refinement.uniform_ref_levels)
    if iodata.model.crack_bdr_elements:
        from palace_torch.mesh.crack import (crack_attributes,
                                           crack_internal_boundaries,
                                           local_edge_split)
        from palace_torch.mesh.mfem_refine import (is_pure_tet,
                                                 seam_bisection_refine)

        attrs = crack_attributes(iodata)
        n_split = n_its = 0
        while True:
            cracked, info = crack_internal_boundaries(mesh, attrs)
            if (not info.interior_seam_edges
                    or not iodata.model.refine_crack_elements):
                break
            # Interior seam edges cannot be decoupled by vertex duplication:
            # locally refine and re-crack.
            try:
                ne = mesh.num_elements
                if is_pure_tet(mesh) and not iodata.boundaries.periodic:
                    mesh = seam_bisection_refine(
                        mesh, info.interior_seam_edges,
                        info.seam_refine_elems, first_pass=(n_its == 0))
                else:
                    mesh = local_edge_split(mesh, info.interior_seam_edges)
                n_split += mesh.num_elements - ne
                n_its += 1
            except NotImplementedError:
                break
        mesh = cracked
        if info.n_crack_facets:
            print_log(iodata,
                      f"Cracked {info.n_crack_facets} interior boundary "
                      f"facets (attrs {sorted(info.cracked_attrs)}, "
                      f"{info.n_dup_nodes} duplicated nodes)")
        if n_split:
            print_log(iodata, f"Added {n_split} elements in {n_its} "
                              "iterations of local bisection for "
                              "under-resolved interior boundaries")
        if info.n_interior_seam_edges:
            print_log(iodata, f"  WARNING: {info.n_interior_seam_edges} "
                              "interior seam edges remain coupled")
    if iodata.boundaries.periodic:
        from palace_torch.mesh.periodic import apply_periodic

        n = apply_periodic(mesh, iodata.boundaries.periodic,
                           iodata.units.mesh_length_scale)
        print_log(iodata, f"Periodic boundaries: identified {n} node pairs")
    return mesh


def make_output_dir(iodata: IoData, output_dir: Optional[str]) -> str:
    if output_dir is None:
        base = os.path.dirname(os.path.abspath(iodata.path or "."))
        output_dir = os.path.join(base, iodata.problem.output)
    if parallel.is_root():  # only rank 0 writes files
        os.makedirs(output_dir, exist_ok=True)
    return output_dir


def nondim_point(iodata: IoData, p) -> np.ndarray:
    """Config coordinates (mesh L0 units) -> nondimensional frame."""
    return np.asarray(p, float) / iodata.units.mesh_length_scale


def solve_spd(iodata: IoData, eliminated_op, raw_op, b: torch.Tensor,
              ess_mask) -> Tuple[torch.Tensor, int, float]:
    """Jacobi-preconditioned CG on the operator's device for an SPD system;
    returns (x, iterations, relres).  As in palace_tpu, the iteration cap is
    max(Linear.MaxIts, 1000) and a solve that stops at it prints a WARNING
    and carries on; every solve's iterations and relres also go to the
    provenance (`cg_iterations`, `cg_relres`).

    With more than one rank, an element-mode operator with a space routes
    through the dof-sharded CG (parallel/dofsharded.py: SFC partition,
    packed interior blocks, an all-reduce over the interface only), under
    the condition of palace_tpu/drivers/common.py:122-125."""
    from palace_torch.linalg.iterative import cg
    from palace_torch.linalg.smoothers import jacobi

    ln = iodata.solver.linear
    max_its = max(ln.max_its, 1000)
    if (parallel.n_shards() > 1
            and getattr(raw_op, "space", None) is not None
            and raw_op.mode == "element"):
        from palace_torch.parallel import dofsharded as ds

        cache = getattr(raw_op, "_dofsharded_cache", None)
        if cache is None:
            part = ds.partition_for_space(raw_op.space, parallel.n_shards())
            cache = raw_op._dofsharded_cache = ds.shard_pa_operator(raw_op,
                                                                    part)
        with timers.block("Linear solve"):
            x, its, relres, _ = ds.solve_spd_sharded(
                raw_op, b, ess_mask, sharded=cache, tol=ln.tol,
                max_its=max_its)
        provenance.record("parallel", {
            **parallel.describe(), "num_dofs": cache.part.num_dofs,
            "max_int": cache.part.max_int, "n_ifc": cache.part.n_ifc})
        if relres > ln.tol:
            print_log(iodata, f"  WARNING: sharded CG did not converge "
                              f"(relres={relres:.2e})")
    else:
        with timers.block("Linear solve"):
            mask = torch.as_tensor(np.asarray(ess_mask, bool),
                                   device=raw_op.device)
            M = jacobi(raw_op.diagonal(), mask)
            res = cg(eliminated_op, b, M=M, tol=ln.tol, max_its=max_its)
        x, its, relres = res.x, res.iterations, res.relres
        if not res.converged:
            print_log(iodata, f"  WARNING: CG did not converge "
                              f"(relres={relres:.2e})")
    provenance.append("cg_iterations", its)
    provenance.append("cg_relres", relres)
    return x, its, relres


# ---------------------------------------------------------------------------
# Measurement tables


def domain_energies(iodata: IoData, op, space, u: np.ndarray
                    ) -> Tuple[float, Dict[int, float]]:
    """(total, per-config-index) field energy 0.5 u^T A u, nondimensional."""
    per_bucket = [e.cpu().numpy() for e in op.element_energy(u)]
    total = float(sum(float(np.sum(e)) for e in per_bucket))
    per_idx = {}
    for ecfg in iodata.domains.energies:
        s = 0.0
        for b, e in zip(space.mesh.buckets, per_bucket):
            m = np.isin(b.attr, ecfg.attributes)
            s += float(np.sum(e * m))
        per_idx[ecfg.index] = s
    return total, per_idx


def write_domain_energy_table(iodata: IoData, post_dir: str, op, space,
                              steps: List[Tuple[float, np.ndarray]]):
    """domain-E.csv of the electrostatic steps: electric energies 0.5 V^T K V
    (reference: postoperatorcsv.cpp domain energy table)."""
    J = iodata.units.scale_factor(ValueType.ENERGY)
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
    for idx, u in steps:
        Ee, per = domain_energies(iodata, op, space, u)
        t.col("i").data.append(idx)
        t.col("Ee").data.append(Ee * J)
        t.col("Em").data.append(0.0)
        t.col("Ec").data.append(0.0)
        t.col("Ei").data.append(0.0)
        for ecfg in iodata.domains.energies:
            eE = per.get(ecfg.index, 0.0)
            t.col(f"Ee{ecfg.index}").data.append(eE * J)
            t.col(f"pe{ecfg.index}").data.append(eE / Ee if Ee > 0 else 0.0)
            t.col(f"Em{ecfg.index}").data.append(0.0)
            t.col(f"pm{ecfg.index}").data.append(0.0)
    t.write(os.path.join(post_dir, "domain-E.csv"))


def write_probe_table(iodata: IoData, post_dir: str, space,
                      steps: List[Tuple[float, np.ndarray]]):
    """probe-E.csv of a scalar potential: E = -grad V at the probes."""
    if not iodata.domains.probes:
        return
    scale = iodata.units.scale_factor(ValueType.FIELD_E)
    locator = evaluation.PointLocator(space.mesh)
    pts = np.array([nondim_point(iodata, p.center)
                    for p in iodata.domains.probes])
    locs = locator.locate(pts)
    t = Table()
    t.add(index_column())
    dims = ["x", "y", "z"][: space.mesh.nodes.shape[1]]
    for p in iodata.domains.probes:
        for d in dims:
            t.add(Column(f"E{d}{p.index}", f"E_{d}[{p.index}] (V/m)"))
    for idx, u in steps:
        _, grads = evaluation.eval_h1(space, np.asarray(u), locs)
        t.col("i").data.append(idx)
        for pi, p in enumerate(iodata.domains.probes):
            for di, d in enumerate(dims):
                t.col(f"E{d}{p.index}").data.append(
                    -float(grads[pi][di]) * scale)
    t.write(os.path.join(post_dir, "probe-E.csv"))


def write_surface_flux_table(iodata: IoData, post_dir: str, space,
                             materials, steps: List[Tuple[float, np.ndarray]]):
    """surface-F.csv: electric flux (charge) Phi = -int (eps grad V) . n dS
    with n oriented away from the surface center (reference:
    palace/models/surfacepostoperator.cpp:82-117)."""
    fluxes = iodata.boundaries.surface_fluxes
    if not fluxes:
        return
    units = iodata.units
    t = Table()
    t.add(index_column())
    traces = {}
    qorder = 2 * space.order + 2
    for f in fluxes:
        if f.type != "Electric":
            raise NotImplementedError(
                f"surface flux type {f.type} for H1 problems")
        t.add(Column(f"F{f.index}", f"Φ_elec[{f.index}] (C)"))
        center = (nondim_point(iodata, f.center) if f.center is not None else
                  _surface_bbox_center(space.mesh, f.attributes))
        traces[f.index] = evaluation.boundary_trace(
            space.mesh, f.attributes, qorder, center=center)
    coul = units.scale_factor(ValueType.CAPACITANCE) * units.scale_factor(
        ValueType.VOLTAGE)
    for idx, u in steps:
        t.col("i").data.append(idx)
        for f in fluxes:
            tr = traces[f.index]
            grads = evaluation.trace_gradient(space, np.asarray(u), tr)
            eps = materials.attr_tensor(
                materials.permittivity, _trace_attrs(space.mesh, tr),
            )[:, : grads.shape[-1], : grads.shape[-1]]
            D = -np.einsum("est,eqt->eqs", eps, grads)
            flux = float(np.einsum("eq,eqs,eqs->", tr.wdetJ, D, tr.normal))
            t.col(f"F{f.index}").data.append(flux * coul)
    t.write(os.path.join(post_dir, "surface-F.csv"))


def _trace_attrs(mesh: Mesh, tr) -> np.ndarray:
    """Domain attribute of the volume element adjacent to each trace facet."""
    out = np.empty(len(tr.elem), np.int32)
    for bi, b in enumerate(mesh.buckets):
        sel = tr.bucket == bi
        out[sel] = b.attr[tr.elem[sel]]
    return out


def _surface_bbox_center(mesh: Mesh, attrs) -> np.ndarray:
    pts = []
    for b in mesh.bdr_buckets:
        sel = np.isin(b.attr, list(attrs))
        if sel.any():
            pts.append(mesh.nodes[np.unique(b.conn[sel].ravel())])
    allp = np.concatenate(pts)
    return 0.5 * (allp.min(axis=0) + allp.max(axis=0))


# ---------------------------------------------------------------------------
# Error indicators (ZZ-style flux recovery, reference:
# palace/linalg/errorestimator.hpp:62-65)


def compute_error_indicator_h1(iodata: IoData, space, materials,
                               u: np.ndarray,
                               device: torch.device = torch.device("cpu")
                               ) -> np.ndarray:
    """Squared, un-normalized per-element error indicators for the gradient
    flux eps grad V, by global L2 projection of the flux onto the vector H1
    space (Jacobi-CG mass solves on `device`); the fallback of the
    electrostatic driver where the ND grad-flux estimator is not available."""
    from palace_torch.fem.estimators import count_mass_route
    from palace_torch.fem.operators import default_qorder, h1_operator
    from palace_torch.linalg.iterative import cg
    from palace_torch.linalg.smoothers import jacobi
    from palace_torch.mesh import geometry as geom_mod

    mesh = space.mesh
    sdim = mesh.nodes.shape[1]
    Mop = h1_operator(space, mass_coef={int(a): np.eye(3)
                                        for a in mesh.attributes()},
                      device=device)
    Mprec = jacobi(Mop.diagonal())

    rhs = np.zeros((sdim, space.num_dofs))
    flux_q = []  # per bucket: flux at qpoints, wdetJ, basis table, bucket
    for bi, b in enumerate(mesh.buckets):
        q = default_qorder(space.order, b.geo_order, b.geom)
        gf = geom_mod.compute(mesh.nodes, b, q)
        basis = space.basis(b.geom)
        B = basis.eval(gf.qpts)
        G = basis.eval_grad(gf.qpts)
        ue = np.asarray(u)[space.elem_dofs[bi]]
        gref = np.einsum("qnr,en->eqr", G, ue)
        gphys = np.einsum("eqrs,eqr->eqs", gf.Jinv, gref)
        eps = materials.attr_tensor(materials.permittivity,
                                    b.attr)[:, :sdim, :sdim]
        flux = np.einsum("est,eqt->eqs", eps, gphys)
        flux_q.append((flux, gf.wdetJ, B, b, bi))
        contrib = np.einsum("eqs,qn,eq->ens", flux, B, gf.wdetJ)
        for d in range(sdim):
            np.add.at(rhs[d], space.elem_dofs[bi].ravel(),
                      contrib[..., d].ravel())

    w = np.zeros_like(rhs)
    for d in range(sdim):
        res = cg(Mop, torch.as_tensor(rhs[d], device=Mop.device), M=Mprec,
                 tol=1e-10, max_its=500)
        count_mass_route("device-cg")
        w[d] = res.x.cpu().numpy()

    eta2 = np.zeros(sum(b.num_elem for b in mesh.buckets))
    ofs = 0
    for flux, wdetJ, B, b, bi in flux_q:
        we = w[:, space.elem_dofs[bi]]  # (sdim, E, nd)
        wq = np.einsum("qn,den->eqd", B, we)
        diff = flux - wq
        eta2[ofs: ofs + b.num_elem] = np.einsum("eqs,eqs,eq->e", diff, diff,
                                                wdetJ)
        ofs += b.num_elem
    return eta2


def write_error_indicators(post_dir: str, eta2_steps: List[np.ndarray],
                           energies: Optional[List[float]] = None):
    """error-indicators.csv: Norm/Min/Max/Mean of the combined indicators
    (reference: palace/fem/errorindicator.cpp:11-48)."""
    combined = None
    n = 0
    for i, eta2 in enumerate(eta2_steps):
        Et = energies[i] if energies else None
        eta = np.sqrt(eta2 * (0.5 / Et if Et and Et > 0 else 1.0))
        if combined is None:
            combined = eta
            n = 1
        else:
            combined = np.sqrt((combined**2 * n + eta**2) / (n + 1))
            n += 1
    if combined is None:
        combined = np.zeros(1)
    t = Table()
    t.add(Column("norm", "Norm"))
    t.add(Column("min", "Minimum"))
    t.add(Column("max", "Maximum"))
    t.add(Column("mean", "Mean"))
    t.col("norm").data.append(float(np.sqrt((combined**2).sum())))
    t.col("min").data.append(float(combined.min()))
    t.col("max").data.append(float(combined.max()))
    t.col("mean").data.append(float(combined.mean()))
    t.write(os.path.join(post_dir, "error-indicators.csv"))
