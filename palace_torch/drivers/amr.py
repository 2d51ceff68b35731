"""Adaptive mesh refinement: Dörfler marking + conforming local refinement
(counterpart of palace_tpu/drivers/amr.py: `dorfler_mark`,
`combine_indicators`, `refine_marked`, `archive_iteration`, `adapt_loop`;
host numpy, the same loop and the same refinement).

The reference drives AMR from BaseSolver (reference:
palace/drivers/basesolver.cpp SolveEstimateMarkRefine: solve, estimate,
Dörfler-mark, refine, repeat until the relative error indicator meets
config["Model"]["Refinement"]["Tol"] or "MaxIts" is reached) with
mfem conforming/nonconforming refinement.  Here marked simplex elements are
refined by splitting their longest edge with the conforming edge-fan
bisection (`mesh/crack.py:local_edge_split`), the standard
longest-edge-bisection AMR pattern.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from palace_torch import parallel
from palace_torch.config import IoData
from palace_torch.mesh.crack import local_edge_split
from palace_torch.mesh.mesh import Mesh
from palace_torch.utils import timers, unported


def dorfler_mark(eta2: np.ndarray, fraction: float) -> np.ndarray:
    """Smallest element set carrying at least `fraction` of the total
    squared error (reference: palace/utils/dorfler.cpp
    ComputeDorflerThreshold)."""
    order = np.argsort(eta2)[::-1]
    csum = np.cumsum(eta2[order])
    k = int(np.searchsorted(csum, fraction * csum[-1])) + 1
    return order[:min(k, len(order))]


def combine_indicators(eta2_steps: Sequence[np.ndarray],
                       energies: Sequence[float]) -> Tuple[np.ndarray, float]:
    """Mean of the energy-normalized indicators over solve steps and its
    l2 norm (the global relative error, the "Norm" column of
    error-indicators.csv; reference: palace/fem/errorindicator.cpp)."""
    combined = None
    for eta2, Et in zip(eta2_steps, energies):
        eta = np.sqrt(eta2 * (0.5 / Et if Et and Et > 0 else 1.0))
        if combined is None:
            combined, n = eta, 1
        else:
            combined = np.sqrt((combined**2 * n + eta**2) / (n + 1))
            n += 1
    if combined is None:
        return np.zeros(0), 0.0
    return combined, float(np.linalg.norm(combined))


def refine_marked(mesh: Mesh, marked: np.ndarray) -> Mesh:
    """Refine the marked elements (global element ids across domain
    buckets, in bucket concatenation order): hexes via nonconforming 1->8
    isotropic refinement (mesh/refine_hex.py, hanging constraints handled
    by fem/hanging.py), simplices via conforming longest-edge bisection."""
    from palace_torch.fem.reference import Geom

    if all(b.geom is Geom.HEX for b in mesh.buckets):
        from palace_torch.mesh.refine_hex import refine_hexes

        return refine_hexes(mesh, np.asarray(marked))
    offsets = np.cumsum([0] + [b.num_elem for b in mesh.buckets])
    edges: List[Tuple[int, int]] = []
    seen = set()
    for ge in np.asarray(marked):
        bi = int(np.searchsorted(offsets, int(ge), side="right")) - 1
        b = mesh.buckets[bi]
        corners = b.corners[int(ge) - int(offsets[bi])]
        pts = mesh.nodes[corners]
        nv = len(corners)
        best, blen = None, -1.0
        for i in range(nv):
            for j in range(i + 1, nv):
                l = float(np.sum((pts[i] - pts[j]) ** 2))
                if l > blen:
                    blen, best = l, (int(corners[i]), int(corners[j]))
        key = (min(best), max(best))
        if key not in seen:
            seen.add(key)
            edges.append(key)
    return local_edge_split(mesh, edges)


def refuse_hex_amr(iodata: IoData, mesh, problem: str):
    """Hex refinement leaves hanging nodes, and fem/hanging.py constrains
    H1 spaces only: palace_tpu solves the ND system unconstrained on such a
    mesh, a nonconforming answer that is no reference."""
    from palace_torch.fem.reference import Geom

    if (iodata.model.refinement.max_it > 0
            and any(b.geom is Geom.HEX for b in mesh.buckets)):
        unported(f"{problem} AMR on hexahedral meshes "
                 "(Model/Refinement/MaxIts)", "nonconforming ND AMR")


def archive_iteration(post_dir: str, it: int, max_it: int) -> None:
    """Copy the current postprocessing outputs into post_dir/iterationNN
    before the next AMR solve overwrites them (reference:
    palace/drivers/basesolver.cpp:224-229 SaveIteration /
    utils/filesystem.cpp — width 1 + floor(log10(max_it)))."""
    import math
    import os
    import shutil

    files = [n for n in os.listdir(post_dir)
             if os.path.isfile(os.path.join(post_dir, n))]
    if not files:
        return  # driver writes tables after the loop: nothing to archive
    width = 1 + int(math.log10(max(max_it, 1)))
    dst = os.path.join(post_dir, f"iteration{it:0{width}d}")
    os.makedirs(dst, exist_ok=True)
    for name in files:
        shutil.copy2(os.path.join(post_dir, name), dst)


def adapt_loop(iodata: IoData, mesh: Mesh, solve_and_estimate,
               post_dir: str | None = None):
    """Generic solve-estimate-mark-refine loop.

    `solve_and_estimate(mesh)` returns (result, eta2_steps, energies,
    num_dofs); iterates while the combined relative indicator exceeds
    Refinement.Tol, up to Refinement.MaxIts adaptation steps (0 = AMR off)
    and Refinement.MaxSize dofs.  When `post_dir` is given and
    Refinement.SaveAdaptIterations is set, each superseded iteration's
    output tables are archived under post_dir/iterationNN (reference:
    basesolver.cpp SaveIteration); SaveAdaptMesh writes each adapted mesh.
    Returns (result, eta_elem, eta_norm, mesh, n_iterations)."""
    from palace_torch.drivers.common import print_log

    cfg = iodata.model.refinement
    it = 0
    while True:
        result, eta2_steps, energies, ndof = solve_and_estimate(mesh)
        eta_elem, eta_norm = combine_indicators(eta2_steps, energies)
        if (it >= cfg.max_it or eta_norm <= cfg.tol
                or (cfg.max_size > 0 and ndof >= cfg.max_size)):
            return result, eta_elem, eta_norm, mesh, it
        if (post_dir is not None and cfg.save_adapt_iterations
                and parallel.is_root()):
            archive_iteration(post_dir, it + 1, cfg.max_it)
        marked = dorfler_mark(eta_elem**2, cfg.update_fraction)
        ne = mesh.num_elements
        try:
            with timers.block("Adaptation"):
                mesh = refine_marked(mesh, marked)
        except NotImplementedError as e:
            print_log(iodata,
                      f"  WARNING: AMR stopped after {it} iterations "
                      f"(error {eta_norm:.3e}): {e}")
            return result, eta_elem, eta_norm, mesh, it
        it += 1
        if (post_dir is not None and cfg.save_adapt_mesh
                and parallel.is_root()):
            import os

            from palace_torch.mesh import gmsh_write

            gmsh_write.write(mesh, os.path.join(post_dir,
                                                f"amr-mesh-{it}.msh"))
        print_log(iodata,
                  f"AMR iteration {it}: error {eta_norm:.3e} > {cfg.tol:.1e},"
                  f" marked {len(marked)} elements "
                  f"({ne} -> {mesh.num_elements})")
