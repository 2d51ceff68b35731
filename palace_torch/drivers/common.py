"""Shared driver utilities: logging, mesh preparation, output directory,
coordinates and the error-indicator table (counterpart of the driven-path
parts of palace_tpu/drivers/common.py)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from palace_torch.config import IoData
from palace_torch.mesh.mesh import Mesh, load_mesh
from palace_torch.post.tables import Column, Table


def print_log(iodata: IoData, msg: str):
    if iodata.problem.verbose > 0:
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
    os.makedirs(output_dir, exist_ok=True)
    return output_dir


def nondim_point(iodata: IoData, p) -> np.ndarray:
    """Config coordinates (mesh L0 units) -> nondimensional frame."""
    return np.asarray(p, float) / iodata.units.mesh_length_scale


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
