"""Generated input decks.

Both cases use the same cavity: a 24 mm PEC cube meshed as a uniform n^3 hex
box, filled with one dielectric of eps_r 2.0 (first modes: f_101 =
c0 / (2 L sqrt(2)) = 6.245676 GHz, triply degenerate, and f_111 =
7.649360 GHz).  On this mesh every term is a uniform domain table, so the
structured fine level engages.

`write_slice_case` writes the driven check of the port's first path: tan
delta 0.01, a z-directed current dipole near the centre, and an 8-point
2.0-5.5 GHz sweep (one frequency block, below the first resonance) solved by
FGMRES + geometric multigrid.  `write_adaptive_case` writes the same driven
cavity as an adaptive PROM sweep over 2.0-7.0 GHz in 0.1 GHz steps, a band
that crosses the first resonance (Q about 100 from the loss tangent).
`write_eigen_case` writes the eigenmode check: the cavity made lossless (tan
delta 0, no ports, so the linear branch runs), the 4 modes nearest 5.0 GHz
at Tol 1e-8, with the iterative (GMG) inner solver by default.

`write_waveguide_case` writes a WR-90 rectangular waveguide (a = 22.86 mm,
b = 10.16 mm, 60 mm long, vacuum) meshed as a uniform hex box and driven
by a wave port at x = 0 over X band (8.2-12.4 GHz, where only TE10
propagates: f_c = 6.557 GHz, TE20 from 13.11 GHz), with PEC side walls and
the far end x = 60 mm a second wave port (a matched line), a copper
`Conductivity` short (sigma = 5.8e7 S/m) or a second-order `Absorbing`
boundary.  The port terms are not domain tables, so its fine level is the
element operator.

`write_rings_case` writes the static checks on `testing/rings.py`'s mesh:
two concentric coplanar square ribbon loops (half-sides 6 and 24 um, width
1 um) as interior sheets of a graded 280 um hex box.  "Magnetostatic" is
`rings_config` (unit surface currents through each ring's gap strip, the
rings and the box PEC); "Electrostatic" makes the rings terminals 1 and 2
(sheet and strip) and the box faces ground.
"""

from __future__ import annotations

import json
import os


def _write(directory: str, n: int, problem: dict, material: dict,
           solver: dict, domains: dict | None = None) -> str:
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_hex

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_hex(n, n, n, lx=24.0, ly=24.0, lz=24.0),
                     os.path.join(directory, "box.msh"))
    cfg = {
        "Problem": dict(problem, Output="postpro"),
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": dict({"Materials": [dict({"Attributes": [1]},
                                            **material)]},
                        **(domains or {})),
        "Boundaries": {"PEC": {"Attributes": [1, 2, 3, 4, 5, 6]}},
        "Solver": solver,
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def write_slice_case(directory: str, n: int, order: int, *, tol: float = 1e-8,
                     max_its: int = 200, device: str = "GPU",
                     verbose: int = 1) -> str:
    """Write box.msh and case.json into `directory`; returns the config path."""
    return _write(
        directory, n, {"Type": "Driven", "Verbose": verbose},
        {"Permeability": 1.0, "Permittivity": 2.0, "LossTan": 0.01},
        {"Order": order, "Device": device,
         "Driven": {"MinFreq": 2.0, "MaxFreq": 5.5, "FreqStep": 0.5},
         "Linear": {"Type": "GMG", "Tol": tol, "MaxIts": max_its}},
        {"CurrentDipole": [{"Index": 1, "Moment": 1.0,
                            "Center": [11.0, 12.5, 13.0],
                            "Direction": [0.0, 0.0, 1.0]}]})


def write_adaptive_case(directory: str, n: int, order: int, *,
                        tol: float = 1e-8, device: str = "GPU",
                        verbose: int = 1) -> str:
    """Write box.msh and case.json of the adaptive sweep (AdaptiveTol 1e-6,
    at most 20 samples, stop after 2 below it) into `directory`; returns
    the config path."""
    return _write(
        directory, n, {"Type": "Driven", "Verbose": verbose},
        {"Permeability": 1.0, "Permittivity": 2.0, "LossTan": 0.01},
        {"Order": order, "Device": device,
         "Driven": {"MinFreq": 2.0, "MaxFreq": 7.0, "FreqStep": 0.1,
                    "AdaptiveTol": 1e-6, "AdaptiveMaxSamples": 20,
                    "AdaptiveMemory": 2},
         "Linear": {"Type": "GMG", "Tol": tol, "MaxIts": 200}},
        {"CurrentDipole": [{"Index": 1, "Moment": 1.0,
                            "Center": [11.0, 12.5, 13.0],
                            "Direction": [0.0, 0.0, 1.0]}]})


def write_eigen_case(directory: str, n: int, order: int, *, tol: float = 1e-8,
                     modes: int = 4, target: float = 5.0,
                     linear: str = "GMG", device: str = "GPU",
                     verbose: int = 1) -> str:
    """Write box.msh and case.json of the eigenmode case into `directory`;
    returns the config path."""
    return _write(
        directory, n, {"Type": "Eigenmode", "Verbose": verbose},
        {"Permeability": 1.0, "Permittivity": 2.0, "LossTan": 0.0},
        {"Order": order, "Device": device,
         "Eigenmode": {"N": modes, "Target": target, "Tol": tol},
         "Linear": {"Type": linear}})


#: WR-90 inner dimensions (mm), the guide's length (mm) and copper's
#: conductivity (S/m).
WR90_A, WR90_B, WAVEGUIDE_L, COPPER_SIGMA = 22.86, 10.16, 60.0, 5.8e7


def write_waveguide_case(directory: str, n_len: int, n_a: int, n_b: int,
                         order: int, *, termination: str = "waveport",
                         adaptive: bool = False,
                         freq_step: float | None = None, tol: float = 1e-8,
                         linear: str = "GMG", device: str = "GPU",
                         verbose: int = 1) -> str:
    """Write guide.msh (n_len x n_a x n_b hexes) and case.json of the WR-90
    guide into `directory`; returns the config path.  `termination` ends
    the guide at x = L: "waveport", "conductivity" or "absorbing".  The
    sweep runs 8.2-12.4 GHz in `freq_step` GHz steps (0.6 uniform: 8
    frequencies; 0.05 adaptive: 85, AdaptiveTol 1e-6, AdaptiveMemory 2);
    the ports' mode solves use EigenTol 1e-12."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_hex

    if termination not in ("waveport", "conductivity", "absorbing"):
        raise ValueError(f"waveguide case: unknown termination "
                         f"{termination!r}")
    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_hex(n_len, n_a, n_b, lx=WAVEGUIDE_L, ly=WR90_A,
                             lz=WR90_B), os.path.join(directory, "guide.msh"))
    ports = [{"Index": 1, "Attributes": [1], "Excitation": True}]
    bdr = {"PEC": {"Attributes": [3, 4, 5, 6]}, "WavePort": ports}
    if termination == "waveport":
        ports.append({"Index": 2, "Attributes": [2]})
    elif termination == "conductivity":
        bdr["Conductivity"] = [{"Attributes": [2],
                                "Conductivity": COPPER_SIGMA}]
    else:
        bdr["Absorbing"] = {"Attributes": [2], "Order": 2}
    for wp in ports:
        wp.update(Mode=1, EigenTol=1e-12)
    driven = {"MinFreq": 8.2, "MaxFreq": 12.4,
              "FreqStep": freq_step or (0.05 if adaptive else 0.6)}
    if adaptive:
        driven.update(AdaptiveTol=1e-6, AdaptiveMaxSamples=20,
                      AdaptiveMemory=2)
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "guide.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                                   "Permittivity": 1.0}]},
        "Boundaries": bdr,
        "Solver": {"Order": order, "Device": device, "Driven": driven,
                   "Linear": {"Type": linear, "Tol": tol, "MaxIts": 400}},
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def write_rings_case(directory: str, h: float, order: int, *,
                     problem: str = "Magnetostatic", tol: float = 1e-8,
                     max_its: int = 500, device: str = "GPU",
                     verbose: int = 1) -> str:
    """Write rings.msh (cell size `h` um at the rings) and case.json into
    `directory`; returns the config path."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.testing import rings

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(rings.rings_mesh(6.0, 24.0, 1.0, 140.0, h),
                     os.path.join(directory, "rings.msh"))
    cfg = rings.rings_config("rings.msh", order=order, tol=tol)
    cfg["Problem"]["Verbose"] = verbose
    cfg["Solver"]["Linear"]["MaxIts"] = max_its
    cfg["Solver"]["Device"] = device
    if problem == "Electrostatic":
        cfg["Problem"]["Type"] = "Electrostatic"
        cfg["Domains"] = {"Materials": [{"Attributes": [1],
                                         "Permittivity": 1.0}]}
        cfg["Boundaries"] = {
            "Ground": {"Attributes": list(rings.ATTR_FARFIELD)},
            "Terminal": [
                {"Index": 1, "Attributes": [rings.ATTR_RING_A,
                                            rings.ATTR_SRC_A]},
                {"Index": 2, "Attributes": [rings.ATTR_RING_B,
                                            rings.ATTR_SRC_B]}]}
        cfg["Solver"]["Electrostatic"] = {"Save": 0}
        del cfg["Solver"]["Magnetostatic"]
    elif problem != "Magnetostatic":
        raise ValueError(f"rings case: unknown problem {problem!r}")
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path
