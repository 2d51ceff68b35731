"""Analytic magnetostatic validation: concentric square ribbon loops.

The reference validates its `rings` example against analytic inductances of
two concentric coplanar circular ribbon loops
(palace's docs/src/examples/rings.md:71-87, M_ab = 1.973921 pH), but
its unstructured ring mesh only ships as a Gmsh generator script we cannot
run.  This module provides the same class of validation on geometry we CAN
mesh exactly with `mesh/generate.py:box_hex_coords`: two concentric
coplanar SQUARE ribbon loops, whose filament inductances have closed-form
Neumann integrals (parallel-segment formula below), so the solver is
checked against machine-accurate analytics instead of a mesh-locked CSV.

Conventions: loops lie in the z = 0 plane, centered at the origin.  A
"half-side" alpha loop is the square path max(|x|, |y|) = alpha traversed
counterclockwise.  A ribbon loop of half-side a and width w occupies the
square annulus a - w/2 < max(|x|, |y|) < a + w/2.

Filament mutual (exact): only parallel segment pairs contribute.  For two
parallel segments at lateral distance d with longitudinal extents
[s1, s2], [t1, t2],

    I = int int ds dt / sqrt((s - t)^2 + d^2)
      = Phi(s2 - t1) + Phi(s1 - t2) - Phi(s2 - t2) - Phi(s1 - t1),
    Phi(u) = u asinh(u / d) - sqrt(u^2 + d^2),

and M = (mu0 / 4 pi) * sum over pairs with orientation sign.

Ribbon self-inductance (uniform surface current): cross-section average
L = (1/w^2) int int M_fil(a + s, a + t) ds dt over s, t in [-w/2, w/2],
with the log-singular diagonal handled by the strip GMD (a subcell of
width D has self geometric-mean-distance D e^{-3/2}).  A perfectly
conducting ribbon's true (energy-minimizing, edge-peaked) current gives a
slightly smaller L; percent-level agreement is the expected outcome, the
same as the reference documents for its own circular-ring example.

Copied from palace_tpu/testing/rings.py, imports pointed at palace_torch;
`run_validation` runs the port's `api.run` on the device it is given.
"""

from __future__ import annotations

import numpy as np

MU0 = 4.0e-7 * np.pi  # H/m (exact in the pre-2019 SI; error 2e-10 relative)


def _parallel_segment_integral(l1: float, l2: float, d: float) -> float:
    """int int ds dt / sqrt((s-t)^2 + d^2) for centered parallel segments of
    lengths l1, l2 at lateral distance d > 0."""
    s1, s2 = -0.5 * l1, 0.5 * l1
    t1, t2 = -0.5 * l2, 0.5 * l2

    def phi(u):
        return u * np.arcsinh(u / d) - np.hypot(u, d)

    return phi(s2 - t1) + phi(s1 - t2) - phi(s2 - t2) - phi(s1 - t1)


def square_loop_mutual(alpha: float, beta: float,
                       d_same: float | None = None) -> float:
    """Mutual inductance [H] of two concentric coplanar square filament
    loops with half-sides alpha, beta (lengths in meters).

    `d_same` overrides the lateral distance of same-side segment pairs
    (used by the GMD diagonal of the ribbon average; default |alpha-beta|).
    """
    d1 = abs(alpha - beta) if d_same is None else d_same
    d2 = alpha + beta
    # 4 same-side pairs (parallel, +) and 4 opposite-side pairs
    # (antiparallel, -); x-pairs and y-pairs are equal by symmetry.
    same = _parallel_segment_integral(2 * alpha, 2 * beta, d1)
    opp = _parallel_segment_integral(2 * alpha, 2 * beta, d2)
    return MU0 / (4 * np.pi) * 4.0 * (same - opp)


def square_ribbon_self(a: float, w: float, n: int = 96,
                       model: str = "pec") -> float:
    """Self-inductance [H] of a square ribbon loop (half-side a, width w).

    model="uniform": current forced uniform across the width —
    cross-section average of the filament mutual with the GMD rule on the
    diagonal (subcell self-GMD = D e^{-3/2}).

    model="pec": perfectly conducting ribbon — the current distribution is
    the edge-peaked electrostatic one, for which the 2D strip has conformal
    equivalent radius w/4; L = filament mutual of the loop with itself at
    same-side distance w/4.  This is what a PEC-sheet FEM solve realizes,
    up to O(w/a) corrections from ribbon curvature at the corners
    (reference docs' circular analog: rings.md:71-87, which likewise
    reports percent-level FEM agreement).
    """
    if model == "pec":
        return square_loop_mutual(a, a, d_same=0.25 * w)
    assert model == "uniform"
    delta = w / n
    s = (np.arange(n) + 0.5) * delta - 0.5 * w
    acc = 0.0
    for i in range(n):
        for j in range(i, n):
            if i == j:
                m = square_loop_mutual(a + s[i], a + s[j],
                                       d_same=delta * np.exp(-1.5))
                acc += m
            else:
                acc += 2.0 * square_loop_mutual(a + s[i], a + s[j])
    return acc / (n * n)


def square_ribbon_mutual(a: float, b: float, w: float, n: int = 16) -> float:
    """Mutual inductance [H] of two concentric coplanar square ribbon loops
    (half-sides a < b, common width w, uniform current) by cross-section
    averaging; converges fast since the loops are well separated."""
    delta = w / n
    s = (np.arange(n) + 0.5) * delta - 0.5 * w
    acc = 0.0
    for si in s:
        for tj in s:
            acc += square_loop_mutual(a + si, b + tj)
    return acc / (n * n)


# ---------------------------------------------------------------------------
# Mesh + config for the solver run
# ---------------------------------------------------------------------------

# Boundary attributes.
ATTR_FARFIELD = (1, 2, 3, 4, 5, 6)  # box faces (box_hex_coords convention)
ATTR_RING_A, ATTR_RING_B = 7, 8     # PEC ribbon sheets
ATTR_SRC_A, ATTR_SRC_B = 11, 12     # surface-current gap strips


def rings_mesh(a: float, b: float, w: float, L: float, h: float,
               ratio: float = 1.9):
    """Graded hex box mesh with the two ribbon loops as internal z=0 sheets.

    The source strip of each ring is the one cell-row of its +x arm nearest
    y = 0+ (current direction +y).  Lengths in mesh units (microns when used
    with the default config L0 = 1e-6).
    """
    from palace_torch.mesh.generate import (
        box_hex_coords,
        graded_one_sided,
        graded_segment,
        stitch_segments,
        uniform_segment,
    )

    hw = 0.5 * w
    xs = stitch_segments(
        graded_one_sided(-L, -(b + hw), h, ratio),
        uniform_segment(-(b + hw), -(b - hw), h),
        graded_segment(-(b - hw), -(a + hw), h, ratio),
        uniform_segment(-(a + hw), -(a - hw), h),
        graded_segment(-(a - hw), a - hw, h, ratio),
        uniform_segment(a - hw, a + hw, h),
        graded_segment(a + hw, b - hw, h, ratio),
        uniform_segment(b - hw, b + hw, h),
        -graded_one_sided(-L, -(b + hw), h, ratio)[::-1],
    )
    ys = xs.copy()
    zs = stitch_segments(graded_one_sided(-L, 0.0, h, ratio),
                         -graded_one_sided(-L, 0.0, h, ratio)[::-1])
    k0 = int(np.argmin(np.abs(zs)))
    zs[k0] = 0.0

    # One fine cell row just above y = 0 hosts the source strips.
    y_src_hi = ys[np.searchsorted(ys, 1e-12)]

    def attr_fn(xc, yc):
        half = max(abs(xc), abs(yc))
        for (r, attr_ring, attr_src) in ((a, ATTR_RING_A, ATTR_SRC_A),
                                         (b, ATTR_RING_B, ATTR_SRC_B)):
            if r - 0.5 * w < half < r + 0.5 * w:
                if xc > r - 0.5 * w and 0.0 < yc < y_src_hi:
                    return attr_src
                return attr_ring
        return 0

    mesh = box_hex_coords(xs, ys, zs, z_sheets=[(k0, attr_fn)])
    return mesh


def rings_config(mesh_path: str, order: int = 1, tol: float = 1e-8) -> dict:
    return {
        "Problem": {"Type": "Magnetostatic", "Verbose": 1,
                    "Output": "postpro"},
        "Model": {"Mesh": mesh_path, "L0": 1e-6},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0}]},
        "Boundaries": {
            "PEC": {"Attributes": list(ATTR_FARFIELD)
                    + [ATTR_RING_A, ATTR_RING_B]},
            "SurfaceCurrent": [
                {"Index": 1, "Attributes": [ATTR_SRC_A],
                 "Direction": [0.0, 1.0, 0.0]},
                {"Index": 2, "Attributes": [ATTR_SRC_B],
                 "Direction": [0.0, 1.0, 0.0]},
            ],
        },
        "Solver": {"Order": order,
                   "Magnetostatic": {"Save": 0},
                   "Linear": {"Type": "Default", "KSPType": "CG",
                              "Tol": tol, "MaxIts": 500}},
    }


def run_validation(a=6.0, b=24.0, w=1.0, L=140.0, h=0.5, order=1,
                   workdir=None, device: str = "GPU"):
    """Mesh, solve on `device` ("GPU" or "CPU"), and compare terminal-M
    against the analytics.  Lengths in microns.  Returns a report dict."""
    import json
    import os
    import tempfile

    from palace_torch import api
    from palace_torch.mesh import gmsh_write

    workdir = workdir or tempfile.mkdtemp(prefix="rings_")
    os.makedirs(workdir, exist_ok=True)
    mesh = rings_mesh(a, b, w, L, h)
    mesh_path = os.path.join(workdir, "rings.msh")
    gmsh_write.write(mesh, mesh_path)
    cfg = rings_config("rings.msh", order=order)
    cfg["Solver"]["Device"] = device
    cfg_path = os.path.join(workdir, "rings.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    api.run(cfg_path, os.path.join(workdir, "out"))

    import csv

    with open(os.path.join(workdir, "out", "terminal-M.csv")) as f:
        rows = list(csv.reader(f))
    # header: i, M[i][1] (H), M[i][2] (H)
    M = np.array([[float(v) for v in r[1:3]] for r in rows[1:3]]) / 1e-12

    um = 1e-6
    ana = {
        "M_aa_pH": square_ribbon_self(a * um, w * um, model="pec") / 1e-12,
        "M_bb_pH": square_ribbon_self(b * um, w * um, model="pec") / 1e-12,
        "M_ab_pH": square_ribbon_mutual(a * um, b * um, w * um) / 1e-12,
        "M_aa_uniform_pH":
            square_ribbon_self(a * um, w * um, model="uniform") / 1e-12,
        "M_bb_uniform_pH":
            square_ribbon_self(b * um, w * um, model="uniform") / 1e-12,
    }
    sol = {"M_aa_pH": M[0, 0], "M_bb_pH": M[1, 1],
           "M_ab_pH": 0.5 * (M[0, 1] + M[1, 0])}
    rel = {k: abs(sol[k] - ana[k]) / abs(ana[k]) for k in sol}
    return {"geometry_um": {"a": a, "b": b, "w": w, "L": L, "h": h,
                            "order": order},
            "num_elements": mesh.num_elements,
            "analytic": ana, "solved": sol, "rel_err": rel,
            "workdir": workdir}
