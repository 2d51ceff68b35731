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

`write_cavity_case` writes the damped eigenmode check: a WR-90 cavity
(22.86 x 10.16 x 30 mm, vacuum) with copper walls as an `Impedance` Rs of
0.02369 Ohm on all six faces (copper's surface resistance at 8.244 GHz),
the 2 modes nearest 8 GHz (TE101 at 8.2438772 GHz, Q_c = 7706.542).
`write_guide_eigen_case` writes the nonlinear eigenmode check: the WR-90
guide of `write_waveguide_case` shorted by PEC at x = L and opened at
x = 0 through a wave port (or a second-order `Absorbing` boundary), the 2
modes nearest 9 GHz.  `write_amr_eigen_case` and `write_amr_driven_case`
write the tet AMR checks of tests/test_amr.py:73 and :105: a 1 cm PEC
cube cavity (its lowest mode near 15 GHz, analytic 21.198518 GHz, or a
box of other sides) and a 10 mm TEM box between two 377 Ohm lumped ports
at 8 GHz, both on `box_tet` meshes under `Model/Refinement`.

`write_tem_line_case` writes the parallel-plate TEM line of
tests/test_driven_transient.py:24 with its length and cell counts as
parameters: a vacuum box_tet line along x, PEC plates on the z faces, PMC
(natural) sides, and 377 Ohm lumped ports (+Z) at both ends, port 1
excited; as a Transient run (a ModulatedGaussian pulse by default) or a
Driven one.  The line is matched, so a pulse crosses it in L / c0 and
leaves through port 2.  `write_dipole_case` writes the short current
dipole at the centre of a 60 mm vacuum box ended on all faces by a
second-order Absorbing boundary, with a FarField on those faces, of
tests/test_farfield_dipole.py (the infinitesimal dipole's sin theta
pattern).

`write_rings_case` writes the static checks on `testing/rings.py`'s mesh:
two concentric coplanar square ribbon loops (half-sides 6 and 24 um, width
1 um) as interior sheets of a graded 280 um hex box.  "Magnetostatic" is
`rings_config` (unit surface currents through each ring's gap strip, the
rings and the box PEC); "Electrostatic" makes the rings terminals 1 and 2
(sheet and strip) and the box faces ground.
"""

from __future__ import annotations

import cmath
import json
import math
import os

from palace_torch.utils.constants import C0, Z0


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
                         linear: str = "GMG", save_freqs=(),
                         postprocessing: dict | None = None,
                         device: str = "GPU", verbose: int = 1) -> str:
    """Write guide.msh (n_len x n_a x n_b hexes) and case.json of the WR-90
    guide into `directory`; returns the config path.  `termination` ends
    the guide at x = L: "waveport", "conductivity" or "absorbing".  The
    sweep runs 8.2-12.4 GHz in `freq_step` GHz steps (0.6 uniform: 8
    frequencies; 0.05 adaptive: 85, AdaptiveTol 1e-6, AdaptiveMemory 2);
    the ports' mode solves use EigenTol 1e-12.  `save_freqs` (GHz) are the
    ParaView `Save` frequencies and `postprocessing` the
    Boundaries/Postprocessing block."""
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
    if save_freqs:
        driven["Save"] = list(save_freqs)
    if postprocessing:
        bdr["Postprocessing"] = postprocessing
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


def _write_config(directory: str, cfg: dict) -> str:
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


#: Copper's surface resistance (Ohm) at the WR-90 cavity's TE101 frequency.
COPPER_RS = 0.02369
#: The WR-90 cavity's length (mm).
CAVITY_D = 30.0


def shorted_guide_mode(f_guess_ghz: float, length: float = WAVEGUIDE_L * 1e-3,
                       a: float = WR90_A * 1e-3, max_it: int = 200):
    """The TE10 mode of a guide (lengths in m) shorted at x = length and
    matched at x = 0 by a port that absorbs the mode at its real frequency,
    the oracle of `write_guide_eigen_case`: the fixed point in Re omega of
    k cot(k length) = -i beta(Re omega), beta(w) = sqrt((w / c)^2 -
    (pi / a)^2), solved for complex k by Newton on k cos(k length) +
    i beta sin(k length) = 0 from k = beta(f_guess); omega = c sqrt(k^2 +
    (pi / a)^2).  Returns (f GHz complex, k, beta)."""
    kc = math.pi / a
    om_r = 2 * math.pi * f_guess_ghz * 1e9
    k = complex(math.sqrt((om_r / C0) ** 2 - kc ** 2), 0.0)
    for _ in range(max_it):
        beta = math.sqrt((om_r / C0) ** 2 - kc ** 2)
        for _ in range(100):
            s, c = cmath.sin(k * length), cmath.cos(k * length)
            dk = (k * c + 1j * beta * s) / (
                c - k * length * s + 1j * beta * length * c)
            k -= dk
            if abs(dk) <= 1e-16 * abs(k):
                break
        om = C0 * cmath.sqrt(k * k + kc * kc)
        done = abs(om.real - om_r) <= 1e-15 * abs(om)
        om_r = om.real
        if done:
            break
    return om / (2 * math.pi * 1e9), k, math.sqrt((om_r / C0) ** 2 - kc ** 2)


def te10l_qc(a: float, b: float, d: float, rs: float, l: int = 1):
    """(Q_c, f Hz) of a vacuum-filled rectangular a x b x d cavity's (m)
    TE10l mode with walls of surface resistance rs (Ohm), the oracle of
    `write_cavity_case` (the textbook wall-loss formula; Pozar, Microwave
    Engineering, rectangular cavity resonators): Q_c = (k a d)^3 b eta0 /
    (2 pi^2 Rs) / (2 l^2 a^3 b + 2 b d^3 + l^2 a^3 d + a d^3)."""
    k = math.pi * math.sqrt((1 / a) ** 2 + (l / d) ** 2)
    q = (k * a * d) ** 3 * b * Z0 / (2 * math.pi ** 2 * rs) / (
        2 * l * l * a ** 3 * b + 2 * b * d ** 3 + l * l * a ** 3 * d
        + a * d ** 3)
    return q, k * C0 / (2 * math.pi)


def write_cavity_case(directory: str, n_a: int, n_b: int, n_d: int,
                      order: int, *, device: str = "GPU",
                      verbose: int = 1) -> str:
    """Write cavity.msh (n_a x n_b x n_d hexes along x, y, z) and case.json
    of the copper-walled WR-90 cavity (the 2 modes nearest 8 GHz) into
    `directory`; returns the config path."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_hex

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_hex(n_a, n_b, n_d, lx=WR90_A, ly=WR90_B,
                             lz=CAVITY_D),
                     os.path.join(directory, "cavity.msh"))
    return _write_config(directory, {
        "Problem": {"Type": "Eigenmode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "cavity.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                                   "Permittivity": 1.0}]},
        "Boundaries": {"Impedance": [{"Attributes": [1, 2, 3, 4, 5, 6],
                                      "Rs": COPPER_RS}]},
        "Solver": {"Order": order, "Device": device,
                   "Eigenmode": {"N": 2, "Target": 8.0, "Tol": 1e-8},
                   "Linear": {"Type": "Default"}}})


def write_guide_eigen_case(directory: str, n_len: int, n_a: int, n_b: int,
                           order: int, *, opening: str = "waveport",
                           device: str = "GPU",
                           verbose: int = 1) -> str:
    """Write guide.msh and case.json of the shorted WR-90 guide (the 2
    modes nearest 9 GHz) into `directory`; returns the config path.  The
    guide is open at x = 0 through wave port 1 (Mode 1, EigenTol 1e-12)
    or, with `opening="absorbing"`, a second-order Absorbing boundary."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_hex

    if opening not in ("waveport", "absorbing"):
        raise ValueError(f"guide eigen case: unknown opening {opening!r}")
    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_hex(n_len, n_a, n_b, lx=WAVEGUIDE_L, ly=WR90_A,
                             lz=WR90_B), os.path.join(directory, "guide.msh"))
    bdr = {"PEC": {"Attributes": [2, 3, 4, 5, 6]}}
    if opening == "waveport":
        bdr["WavePort"] = [{"Index": 1, "Attributes": [1], "Mode": 1,
                            "EigenTol": 1e-12}]
    else:
        bdr["Absorbing"] = {"Attributes": [1], "Order": 2}
    return _write_config(directory, {
        "Problem": {"Type": "Eigenmode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "guide.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                                   "Permittivity": 1.0}]},
        "Boundaries": bdr,
        "Solver": {"Order": order, "Device": device,
                   "Eigenmode": {"N": 2, "Target": 9.0, "Tol": 1e-8},
                   "Linear": {"Type": "Default"}}})


def _write_tet_box(directory: str, n: int, size, jitter: float = 0.0
                   ) -> None:
    import numpy as np

    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet

    os.makedirs(directory, exist_ok=True)
    mesh = box_tet(n, n, n, lx=size[0], ly=size[1], lz=size[2])
    if jitter:
        x, hi = mesh.nodes, np.asarray(size, float)
        inner = np.all((x > 1e-9 * hi) & (x < (1 - 1e-9) * hi), axis=1)
        x[inner] += jitter * hi / n * np.random.default_rng(7).uniform(
            -1, 1, (int(inner.sum()), 3))
    gmsh_write.write(mesh, os.path.join(directory, "box.msh"))


def write_amr_eigen_case(directory: str, n: int, order: int, *,
                         size=(1.0, 1.0, 1.0), jitter: float = 0.0,
                         max_its: int = 2, linear: str = "GMG",
                         device: str = "GPU", verbose: int = 1) -> str:
    """Write box.msh (a box_tet n^3 of `size` cm, the unit cube by
    default; with `jitter` > 0 its interior nodes move by up to that
    fraction of a cell, from a fixed seed) and case.json of the PEC box
    cavity under AMR (L0 1 cm, the mode nearest 15 GHz, UpdateFraction
    0.95, `max_its` passes, each adapted mesh saved) into `directory`;
    returns the config path.  The cube's lowest mode is triply degenerate,
    so which vector of it a solve returns follows round-off; and the
    structured mesh ties many indicators exactly, so which tied elements
    are marked does too.  A box of three different sides has a simple
    lowest mode, and jittered nodes untie the indicators."""
    _write_tet_box(directory, n, size, jitter)
    return _write_config(directory, {
        "Problem": {"Type": "Eigenmode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-2,
                  "Refinement": {"Tol": 1e-12, "MaxIts": max_its,
                                 "UpdateFraction": 0.95,
                                 "SaveAdaptMesh": True}},
        "Domains": {"Materials": [{"Attributes": [1],
                                   "Permittivity": 1.0}]},
        "Boundaries": {"PEC": {"Attributes": [1, 2, 3, 4, 5, 6]}},
        "Solver": {"Order": order, "Device": device,
                   "Eigenmode": {"N": 1, "Target": 15.0, "Tol": 1e-9},
                   "Linear": {"Type": linear, "Tol": 1e-9}}})


def write_amr_driven_case(directory: str, n: int, order: int, *,
                          linear: str = "GMG",
                          device: str = "GPU", verbose: int = 1) -> str:
    """Write box.msh (a box_tet n^3, 10 mm cube) and case.json of the TEM
    box under AMR: eps_r 2, tan delta 0.01, PEC z faces, lumped ports of
    eta0 on the x faces (+Z, port 1 excited), 8 GHz, UpdateFraction 0.4,
    MaxIts 1; returns the config path."""
    eta0 = 376.730313412
    _write_tet_box(directory, n, (10.0, 10.0, 10.0))
    return _write_config(directory, {
        "Problem": {"Type": "Driven", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3,
                  "Refinement": {"Tol": 1e-12, "MaxIts": 1,
                                 "UpdateFraction": 0.4}},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 2.0,
                                   "LossTan": 0.01}]},
        "Boundaries": {
            "PEC": {"Attributes": [5, 6]},
            "LumpedPort": [
                {"Index": 1, "Attributes": [1], "R": eta0, "Direction": "+Z",
                 "Excitation": True},
                {"Index": 2, "Attributes": [2], "R": eta0,
                 "Direction": "+Z"}]},
        "Solver": {"Order": order, "Device": device,
                   "Driven": {"MinFreq": 8.0, "MaxFreq": 8.0, "FreqStep": 1.0},
                   "Linear": {"Type": linear, "Tol": 1e-10, "MaxIts": 500}}})


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


#: Impedance of free space (Ohm) as the TEM line's lumped ports take it.
ETA0 = 376.730313412


def write_tem_line_case(directory: str, length: float, n_len: int,
                        n_cross: int, order: int, *,
                        problem: str = "Transient",
                        scheme: str = "GeneralizedAlpha",
                        excitation_freq: float = 30.0,
                        excitation_width: float = 0.02,
                        max_time: float = 0.3, time_step: float = 0.002,
                        save_freqs=(),
                        postprocessing: dict | None = None,
                        domain_post: dict | None = None,
                        device: str = "GPU", verbose: int = 1) -> str:
    """Write box.msh (box_tet n_len x n_cross x n_cross over length x 10 x
    10 mm) and case.json of the TEM line into `directory`; returns the
    config path.  A Transient case takes the scheme (Solver/Transient/Type),
    the ModulatedGaussian pulse (frequency in GHz, width and times in ns),
    the adaptive schemes at the default RelTol 1e-4 and AbsTol 1e-9; a
    Driven case runs at
    15 GHz and takes the ParaView `Save` frequencies.
    `postprocessing` is the Boundaries/Postprocessing block (SurfaceFlux,
    Dielectric, ...) and `domain_post` the Domains/Postprocessing block
    (Probe, Energy)."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_tet(n_len, n_cross, n_cross, lx=length, ly=10.0,
                             lz=10.0), os.path.join(directory, "box.msh"))
    bdr = {"PEC": {"Attributes": [5, 6]},
           "LumpedPort": [
               {"Index": 1, "Attributes": [1], "R": ETA0, "Direction": "+Z",
                "Excitation": True},
               {"Index": 2, "Attributes": [2], "R": ETA0, "Direction": "+Z"}]}
    if postprocessing:
        bdr["Postprocessing"] = postprocessing
    solver = {"Order": order, "Device": device,
              "Linear": {"Tol": 1e-10, "MaxIts": 300}}
    if problem == "Transient":
        solver["Transient"] = {
            "Type": scheme, "Excitation": "ModulatedGaussian",
            "ExcitationFreq": excitation_freq,
            "ExcitationWidth": excitation_width, "MaxTime": max_time,
            "TimeStep": time_step}
    elif problem == "Driven":
        solver["Driven"] = {"Samples": [{"Type": "Point", "Freq": [15.0]}]}
        if save_freqs:
            solver["Driven"]["Save"] = list(save_freqs)
    else:
        raise ValueError(f"TEM line case: unknown problem {problem!r}")
    domains = {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                              "Permittivity": 1.0}]}
    if domain_post:
        domains["Postprocessing"] = domain_post
    return _write_config(directory, {
        "Problem": {"Type": problem, "Verbose": verbose, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": domains,
        "Boundaries": bdr,
        "Solver": solver})


def write_dipole_case(directory: str, n: int, order: int, *,
                      device: str = "GPU", verbose: int = 1) -> str:
    """Write box.msh (box_tet n^3 over a 60 mm cube centred on the origin)
    and case.json of the z-directed unit current dipole at the origin,
    second-order Absorbing on all six faces and a FarField there sampled at
    (theta, phi) = (90, 0), (45, 0) and (30, 45) degrees, at 5 GHz (the
    box is one wavelength wide); returns the config path."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet

    size = 60.0
    os.makedirs(directory, exist_ok=True)
    mesh = box_tet(n, n, n, lx=size, ly=size, lz=size)
    mesh.nodes -= 0.5 * size
    gmsh_write.write(mesh, os.path.join(directory, "box.msh"))
    faces = [1, 2, 3, 4, 5, 6]
    return _write_config(directory, {
        "Problem": {"Type": "Driven", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {
            "Materials": [{"Attributes": [1], "Permeability": 1.0,
                           "Permittivity": 1.0}],
            "CurrentDipole": [{"Index": 1, "Moment": 1.0,
                               "Center": [0.0, 0.0, 0.0],
                               "Direction": [0, 0, 1]}]},
        "Boundaries": {
            "Absorbing": {"Attributes": faces, "Order": 2},
            "Postprocessing": {
                "FarField": {"Attributes": faces,
                             "ThetaPhis": [[90.0, 0.0], [45.0, 0.0],
                                           [30.0, 45.0]]}}},
        "Solver": {"Order": order, "Device": device,
                   "Driven": {"Samples": [{"Type": "Point", "Freq": [5.0]}]},
                   "Linear": {"Tol": 1e-10, "MaxIts": 300}}})


def floquet_box_freq(k: float, l: int = 0) -> float:
    """f (GHz) of the lowest Bloch pair of the box of `write_floquet_box_case`
    (side L = 1 cm, periodic in x, PEC on the y and z faces) at Floquet
    wave number k (1/cm) on branch l: omega^2 = c0^2 ((pi / L)^2 + beta^2)
    with beta = k + 2 pi l / L, so f = c0 sqrt(pi^2 + (beta L)^2) /
    (2 pi L).  The pair is doubly degenerate (E along z times sin(pi y / L),
    or along y times sin(pi z / L)); l = -1 is the backward branch."""
    beta_l = k + 2.0 * math.pi * l  # beta L, with L = 1 cm
    return C0 * math.sqrt(math.pi ** 2 + beta_l ** 2) / (
        2.0 * math.pi * 1e-2) / 1e9


def slab_transmission(f_ghz: float, n: float = 2.0, t: float = 0.5) -> float:
    """|T|^2 of a lossless dielectric slab of index n and thickness t (cm)
    in vacuum at normal incidence (the Airy formula): 1 / (1 + ((n^2 - 1) /
    (2 n))^2 sin^2(n k0 t)), k0 = 2 pi f / c0."""
    k0 = 2.0 * math.pi * f_ghz * 1e9 / C0
    s = math.sin(n * k0 * t * 1e-2)
    return 1.0 / (1.0 + ((n * n - 1.0) / (2.0 * n)) ** 2 * s * s)


def _periodic(kf, fref, pairs) -> dict:
    out = {"FloquetWaveVector": list(kf), "BoundaryPairs": [
        {"DonorAttributes": [d], "ReceiverAttributes": [r],
         "Translation": list(t)} for d, r, t in pairs]}
    if fref:
        out["FloquetReferenceFrequency"] = fref
    return out


def write_floquet_box_case(directory: str, n: int, order: int, *,
                           kx: float = 2.0, target: float = 17.0,
                           modes: int = 2, device: str = "GPU",
                           verbose: int = 1) -> str:
    """Write box.msh (box_tet n^3, a 1 cm cube) and case.json of the Floquet
    eigenproblem of tests/test_floquet.py: periodic in x (Translation
    [1, 0, 0] cm), PEC on the y and z faces, vacuum, FloquetWaveVector
    [kx, 0, 0] /cm, the `modes` modes at or above `target` GHz at Tol
    1e-9; returns the config path.  `floquet_box_freq` has the analytic
    modes."""
    _write_tet_box(directory, n, (1.0, 1.0, 1.0))
    return _write_config(directory, {
        "Problem": {"Type": "Eigenmode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-2},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0}],
                    "Postprocessing": {"Energy": [{"Index": 1,
                                                   "Attributes": [1]}]}},
        "Boundaries": {
            "Periodic": _periodic([kx, 0.0, 0.0], None,
                                  [(1, 2, (1.0, 0.0, 0.0))]),
            "PEC": {"Attributes": [3, 4, 5, 6]}},
        "Solver": {"Order": order, "Device": device,
                   "Eigenmode": {"N": modes, "Target": target, "Tol": 1e-9},
                   "Linear": {"Tol": 1e-9}}})


def write_floquet_dipole_case(directory: str, n: int, order: int, *,
                              freqs=(16.0, 17.5, 19.0), fref: float = 0.0,
                              adaptive_tol: float = 0.0, fstep: float = 0.1,
                              hex_mesh: bool = False, linear: str = "GMG",
                              tol: float = 1e-8, device: str = "GPU",
                              verbose: int = 1) -> str:
    """Write box.msh and case.json of the Bloch-phase driven sweep: the box
    of `write_floquet_box_case` (box_tet n^3, or box_hex n^3 with
    `hex_mesh`) with tan delta 0.01, driven by a z current dipole at
    (0.3, 0.45, 0.55) cm at the points `freqs` (GHz), FloquetWaveVector
    [2, 0, 0] /cm (with FloquetReferenceFrequency `fref` GHz when > 0),
    and the `linear` solver at `tol`; with `adaptive_tol` > 0, the
    adaptive sweep over 14-17 GHz in steps of `fstep` instead.  Returns
    the config path."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_hex

    if hex_mesh:
        os.makedirs(directory, exist_ok=True)
        gmsh_write.write(box_hex(n, n, n), os.path.join(directory, "box.msh"))
    else:
        _write_tet_box(directory, n, (1.0, 1.0, 1.0))
    driven = ({"MinFreq": 14.0, "MaxFreq": 17.0, "FreqStep": fstep,
               "AdaptiveTol": adaptive_tol} if adaptive_tol > 0 else
              {"Samples": [{"Type": "Point", "Freq": list(freqs)}]})
    return _write_config(directory, {
        "Problem": {"Type": "Driven", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-2},
        "Domains": {
            "Materials": [{"Attributes": [1], "Permittivity": 1.0,
                           "LossTan": 0.01}],
            "CurrentDipole": [{"Index": 1, "Moment": 1.0,
                               "Center": [0.3, 0.45, 0.55],
                               "Direction": [0.0, 0.0, 1.0]}],
            "Postprocessing": {"Energy": [{"Index": 1, "Attributes": [1]}]}},
        "Boundaries": {
            "Periodic": _periodic([2.0, 0.0, 0.0], fref,
                                  [(1, 2, (1.0, 0.0, 0.0))]),
            "PEC": {"Attributes": [3, 4, 5, 6]}},
        "Solver": {"Order": order, "Device": device, "Driven": driven,
                   "Linear": {"Type": linear, "Tol": tol, "MaxIts": 400}}})


def write_floquet_cell_case(directory: str, n: int, order: int, *,
                            freqs=(12.0,), kf=(0.0, 0.0, 0.0),
                            fref: float = 0.0, slab=None,
                            device: str = "GPU", verbose: int = 1) -> str:
    """Write cell.msh (box_tet n x n x 2n over a 1 x 1 x 2 cm cell) and
    case.json of the Floquet-port cell of tests/test_floquet_port.py:
    periodic in x and y, Floquet port 1 on z = 2 cm (attribute 6, excited,
    TE, MaxOrder 1) and port 2 on z = 0 (attribute 5), FloquetWaveVector
    `kf` /cm (frequency-scaled with FloquetReferenceFrequency `fref` GHz
    when > 0), at the points `freqs` (GHz).  `slab` = (z0, z1, eps_r) fills
    z0 <= z <= z1 cm with a dielectric (attribute 2; put z0 and z1 on mesh
    planes).  Returns the config path."""
    import numpy as np

    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet

    os.makedirs(directory, exist_ok=True)
    mesh = box_tet(n, n, 2 * n, lx=1.0, ly=1.0, lz=2.0)
    materials = [{"Attributes": [1], "Permittivity": 1.0,
                  "Permeability": 1.0}]
    if slab is not None:
        z0, z1, eps = slab
        b = mesh.buckets[0]
        zc = mesh.nodes[b.conn].mean(axis=1)[:, 2]
        b.attr = np.where((zc > z0) & (zc < z1), 2, b.attr).astype(np.int32)
        materials.append({"Attributes": [2], "Permittivity": eps,
                          "Permeability": 1.0})
    gmsh_write.write(mesh, os.path.join(directory, "cell.msh"))
    return _write_config(directory, {
        "Problem": {"Type": "Driven", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "cell.msh", "L0": 1.0e-2},
        "Domains": {"Materials": materials},
        "Boundaries": {
            "Periodic": _periodic(kf, fref, [(1, 2, (1.0, 0.0, 0.0)),
                                             (3, 4, (0.0, 1.0, 0.0))]),
            "FloquetPort": [
                {"Index": 1, "Attributes": [6], "Excitation": True,
                 "IncidentPolarization": "TE", "MaxOrder": 1},
                {"Index": 2, "Attributes": [5], "MaxOrder": 1}]},
        "Solver": {"Order": order, "Device": device,
                   "Driven": {"Samples": [{"Type": "Point",
                                           "Freq": list(freqs)}]},
                   "Linear": {"Tol": 1e-10, "MaxIts": 400}}})


# -- 2D meshes --------------------------------------------------------------


def rect_mesh(nx: int, ny: int, lx: float, ly: float, *, quad: bool = False,
              jitter: float = 0.0):
    """A 2D mesh of the rectangle [0, lx] x [0, ly] in nx x ny cells, each
    cut into two triangles (or kept as a quadrilateral with `quad`), with
    domain attribute 1 and rim LINE elements of attribute 1 (y = 0), 2 (x =
    lx), 3 (y = ly) and 4 (x = 0).  `jitter` > 0 moves the interior nodes by
    up to that fraction of a cell, from a fixed seed."""
    import numpy as np

    from palace_torch.fem.reference import Geom
    from palace_torch.mesh.mesh import ElemBucket, Mesh

    xs, ys = np.meshgrid(np.linspace(0.0, lx, nx + 1),
                         np.linspace(0.0, ly, ny + 1), indexing="ij")
    nodes = np.stack([xs.ravel(), ys.ravel()], axis=1)
    if jitter:
        inner = ((nodes[:, 0] > 1e-9 * lx) & (nodes[:, 0] < (1 - 1e-9) * lx)
                 & (nodes[:, 1] > 1e-9 * ly) & (nodes[:, 1] < (1 - 1e-9) * ly))
        h = np.array([lx / nx, ly / ny])
        nodes[inner] += jitter * h * np.random.default_rng(7).uniform(
            -1, 1, (int(inner.sum()), 2))

    def nid(i, j):
        return i * (ny + 1) + j

    cells = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), \
                nid(i, j + 1)
            cells += [[a, b, c, d]] if quad else [[a, b, c], [a, c, d]]
    conn = np.array(cells, np.int32)
    attr = np.ones(len(conn), np.int32)
    edges, eattr = [], []
    for i in range(nx):
        edges += [[nid(i, 0), nid(i + 1, 0)], [nid(i, ny), nid(i + 1, ny)]]
        eattr += [1, 3]
    for j in range(ny):
        edges += [[nid(nx, j), nid(nx, j + 1)], [nid(0, j), nid(0, j + 1)]]
        eattr += [2, 4]
    dom = (ElemBucket(3, Geom.QUAD, 1, conn, attr) if quad
           else ElemBucket(2, Geom.TRI, 1, conn, attr))
    return Mesh(nodes, [dom], [ElemBucket(1, Geom.LINE, 1,
                                          np.array(edges, np.int32),
                                          np.array(eattr, np.int32))], {})


def _write_rect(directory: str, name: str, nx: int, ny: int, lx: float,
                ly: float, **kw) -> None:
    from palace_torch.mesh import gmsh_write

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(rect_mesh(nx, ny, lx, ly, **kw),
                     os.path.join(directory, name))


def rect_mode_freq(m: int, n: int, a: float = WR90_A, b: float = WR90_B,
                   eps_r: float = 1.0) -> float:
    """f (GHz) of the in-plane (m, n) mode of a PEC rectangle of sides a x b
    (mm): f = c0 / (2 sqrt(eps_r)) sqrt((m / a)^2 + (n / b)^2)."""
    return C0 / (2.0 * math.sqrt(eps_r)) * math.hypot(
        m / (a * 1e-3), n / (b * 1e-3)) / 1e9


def write_rect_eigen_case(directory: str, nx: int, ny: int, order: int, *,
                          modes: int = 3, linear: str = "Default",
                          device: str = "GPU", verbose: int = 1) -> str:
    """Write rect.msh (`rect_mesh` of the WR-90 cross-section, 22.86 x 10.16
    mm) and case.json of the 2D PEC-rectangle eigenproblem: vacuum, the
    `modes` modes nearest 5 GHz at Tol 1e-9 with the `linear` solver;
    returns the config path.  The analytic modes are `rect_mode_freq(m,
    n)`: 6.557140 (1, 0), 13.114281 (2, 0), 14.753566 (0, 1) GHz."""
    _write_rect(directory, "rect.msh", nx, ny, WR90_A, WR90_B)
    return _write_config(directory, {
        "Problem": {"Type": "Eigenmode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "rect.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0}],
                    "Postprocessing": {"Energy": [{"Index": 1,
                                                   "Attributes": [1]}]}},
        "Boundaries": {"PEC": {"Attributes": [1, 2, 3, 4]}},
        "Solver": {"Order": order, "Device": device,
                   "Eigenmode": {"N": modes, "Target": 5.0, "Tol": 1e-9},
                   "Linear": {"Type": linear, "Tol": 1e-10}}})


#: The 2D plate line's plate separation (mm).
PLATE_D = 2.0


def plate_line_r(length: float) -> float:
    """The lumped-port R (Ohm) that matches the 2D plate line of
    `write_plate_line_case`: a 2D lumped port has length d = PLATE_D along
    its direction and unit depth (models/lumpedport.py), in the
    nondimensional units whose length scale Lc is the mesh's largest
    extent, max(length, d) mm.  Its sheet impedance R w / l matches eta0
    when R = eta0 d / Lc."""
    return Z0 * PLATE_D / max(length, PLATE_D)


def write_plate_line_case(directory: str, length: float, n_len: int,
                          n_h: int, order: int, *, problem: str = "Driven",
                          freqs=(4.0, 6.0, 8.0), adaptive: bool = False,
                          tol: float = 1e-10, max_time: float = 0.3,
                          time_step: float = 0.002, device: str = "GPU",
                          verbose: int = 1) -> str:
    """Write line.msh (`rect_mesh` n_len x n_h over length x PLATE_D mm) and
    case.json of the 2D parallel-plate line: vacuum, PEC plates on y = 0
    and y = PLATE_D (attributes 1 and 3), lumped ports (+Y) on x = 0
    (attribute 4, excited) and x = length (attribute 2) of R =
    `plate_line_r`, the matched load; returns the config path.  A Driven
    case sweeps the points `freqs` (GHz; with `adaptive`, AdaptiveTol 1e-6
    over 2-10 GHz in 0.1 GHz steps) with GMG at `tol`; a Transient case
    runs GeneralizedAlpha on the 30 GHz ModulatedGaussian pulse of width
    0.02 ns of `write_tem_line_case`.  The TEM wave crosses the matched
    line unreflected: |S11| -> 0, |S21| -> 1, arg S21 -> -k0 length, and a
    pulse arrives after length / c0."""
    _write_rect(directory, "line.msh", n_len, n_h, length, PLATE_D)
    r = plate_line_r(length)
    bdr = {"PEC": {"Attributes": [1, 3]},
           "LumpedPort": [
               {"Index": 1, "Attributes": [4], "R": r, "Direction": "+Y",
                "Excitation": True},
               {"Index": 2, "Attributes": [2], "R": r, "Direction": "+Y"}]}
    solver = {"Order": order, "Device": device,
              "Linear": {"Type": "GMG", "Tol": tol, "MaxIts": 400}}
    if problem == "Driven":
        solver["Driven"] = (
            {"MinFreq": 2.0, "MaxFreq": 10.0, "FreqStep": 0.1,
             "AdaptiveTol": 1e-6, "AdaptiveMemory": 2} if adaptive else
            {"Samples": [{"Type": "Point", "Freq": list(freqs)}]})
    elif problem == "Transient":
        solver["Transient"] = {
            "Type": "GeneralizedAlpha", "Excitation": "ModulatedGaussian",
            "ExcitationFreq": 30.0, "ExcitationWidth": 0.02,
            "MaxTime": max_time, "TimeStep": time_step}
    else:
        raise ValueError(f"plate line case: unknown problem {problem!r}")
    return _write_config(directory, {
        "Problem": {"Type": problem, "Verbose": verbose, "Output": "postpro"},
        "Model": {"Mesh": "line.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0}],
                    "Postprocessing": {"Energy": [{"Index": 1,
                                                   "Attributes": [1]}]}},
        "Boundaries": bdr,
        "Solver": solver})


def write_rect_magnetostatic_case(directory: str, nx: int, ny: int,
                                  order: int, *, device: str = "GPU",
                                  verbose: int = 1) -> str:
    """Write rect.msh (`rect_mesh` of the WR-90 cross-section) and
    case.json of a 2D magnetostatic run: PEC on x = a, y = b and x = 0
    (attributes 2, 3 and 4: one connected piece of the rim) and a unit +X
    surface current on y = 0 (attribute 1); returns the config path.  The
    current's ends lie on the PEC, so its right-hand side is orthogonal to
    every curl-free field the eliminated curl-curl operator keeps (the
    gradients of H1 functions that vanish on the PEC), and CG converges.
    With the PEC in two pieces (x = 0 and x = a only) one more curl-free
    field (the gradient of a function 0 on one piece and 1 on the other)
    meets the current, and CG diverges in both packages."""
    _write_rect(directory, "rect.msh", nx, ny, WR90_A, WR90_B)
    return _write_config(directory, {
        "Problem": {"Type": "Magnetostatic", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "rect.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1],
                                   "Permeability": 1.0}]},
        "Boundaries": {"PEC": {"Attributes": [2, 3, 4]},
                       "SurfaceCurrent": [{"Index": 1, "Attributes": [1],
                                           "Direction": "+X"}]},
        "Solver": {"Order": order, "Device": device,
                   "Magnetostatic": {"Save": 0},
                   "Linear": {"Tol": 1e-10, "MaxIts": 2000}}})


#: The BoundaryMode decks' frequency (GHz): TE10 propagates in the WR-90
#: cross-section, TE20 (13.1 GHz) does not.
MODE_FREQ = 10.0


def te10_kn(f_ghz: float, a: float = WR90_A, eps_r: float = 1.0) -> float:
    """kn (1/m) of the TE10 mode of a PEC guide of width a (mm) filled with
    eps_r at f (GHz): kn = sqrt(eps_r k0^2 - (pi / a)^2)."""
    k0 = 2.0 * math.pi * f_ghz * 1e9 / C0
    return math.sqrt(eps_r * k0 * k0 - (math.pi / (a * 1e-3)) ** 2)


def write_boundarymode_case(directory: str, nx: int, ny: int, order: int, *,
                            modes: int = 2, quad: bool = False,
                            loss_tan: float = 0.0, eps_r: float = 1.0,
                            sheet_ls: float = 0.0, absorbing: bool = False,
                            dielectric: bool = False,
                            device: str = "GPU", verbose: int = 1) -> str:
    """Write rect.msh (`rect_mesh` of the WR-90 cross-section, 22.86 x 10.16
    mm) and case.json of the BoundaryMode run at MODE_FREQ: the `modes`
    modes of largest Re kn of a PEC guide filled with eps_r (and tan delta
    `loss_tan`), a Voltage and an Impedance path across the middle; returns
    the config path.  With `sheet_ls` > 0 the y = b wall (attribute 3) is
    an Impedance sheet of that Ls (H/sq); with `absorbing` the x = a wall
    (attribute 2) is a first-order Absorbing boundary; with `dielectric` a
    1 um interface layer (eps_r 10, tan delta 1e-3) lines the y = 0 wall
    (surface-Q.csv).  The PEC guide's TE10 has kn = `te10_kn(MODE_FREQ)`
    (1/m)."""
    _write_rect(directory, "rect.msh", nx, ny, WR90_A, WR90_B, quad=quad)
    pec = [1, 2, 3, 4]
    bdr = {}
    if sheet_ls > 0:
        pec.remove(3)
        bdr["Impedance"] = [{"Attributes": [3], "Ls": sheet_ls}]
    if absorbing:
        pec.remove(2)
        bdr["Absorbing"] = {"Attributes": [2], "Order": 1}
    bdr["PEC"] = {"Attributes": pec}
    path = [[WR90_A / 2, 0.0], [WR90_A / 2, WR90_B]]
    post = {"Voltage": [{"Index": 1, "VoltagePath": path, "NSamples": 41}],
            "Impedance": [{"Index": 1, "VoltagePath": path,
                           "NSamples": 41}]}
    if dielectric:
        post["Dielectric"] = [{"Index": 1, "Attributes": [1],
                               "Thickness": 1e-3, "Permittivity": 10.0,
                               "LossTan": 1e-3}]
    bdr["Postprocessing"] = post
    return _write_config(directory, {
        "Problem": {"Type": "BoundaryMode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "rect.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": eps_r,
                                   "LossTan": loss_tan}],
                    "Postprocessing": {"Energy": [{"Index": 1,
                                                   "Attributes": [1]}]}},
        "Boundaries": bdr,
        "Solver": {"Order": order, "Device": device,
                   "BoundaryMode": {"Freq": MODE_FREQ, "N": modes}}})


#: The TEM cross-section of `write_tem_section_case`: width and plate
#: separation (mm) and eps_r.
TEM_W, TEM_D, TEM_EPS = 10.0, 2.0, 2.25


def tem_section_z() -> float:
    """Z_PV (Ohm) of the TEM mode of the parallel-plate cross-section of
    `write_tem_section_case`: eta0 d / (w sqrt(eps_r))."""
    return Z0 * TEM_D / (TEM_W * math.sqrt(TEM_EPS))


def write_tem_section_case(directory: str, nx: int, ny: int, order: int, *,
                           device: str = "GPU", verbose: int = 1) -> str:
    """Write plate.msh (`rect_mesh` nx x ny over TEM_W x TEM_D mm) and
    case.json of the BoundaryMode run on a parallel-plate cross-section:
    PEC plates on y = 0 and y = TEM_D (attributes 1 and 3), natural
    (magnetic-wall) sides, one dielectric TEM_EPS, the mode nearest n_eff =
    sqrt(TEM_EPS) at 5 GHz, a Voltage and an Impedance path from plate to
    plate; returns the config path.  Its TEM mode has n_eff =
    sqrt(TEM_EPS) and Z_PV = `tem_section_z()`.  The constant field lies
    in the ND space, so both hold to the solver's tolerance on any mesh."""
    _write_rect(directory, "plate.msh", nx, ny, TEM_W, TEM_D)
    path = [[TEM_W / 2, 0.0], [TEM_W / 2, TEM_D]]
    return _write_config(directory, {
        "Problem": {"Type": "BoundaryMode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "plate.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1],
                                   "Permittivity": TEM_EPS}]},
        "Boundaries": {
            "PEC": {"Attributes": [1, 3]},
            "Postprocessing": {
                "Voltage": [{"Index": 1, "VoltagePath": path,
                             "NSamples": 21}],
                "Impedance": [{"Index": 1, "VoltagePath": path,
                               "NSamples": 21}]}},
        "Solver": {"Order": order, "Device": device,
                   "BoundaryMode": {"Freq": 5.0, "N": 1,
                                    "Target": math.sqrt(TEM_EPS)}}})


def write_port_face_mode_case(directory: str, n_len: int, n_a: int, n_b: int,
                              order: int, *, eps=None, device: str = "GPU",
                              verbose: int = 1) -> str:
    """Write guide.msh (box_tet n_len x n_a x n_b over the WR-90 guide of
    `write_waveguide_case`, 60 x 22.86 x 10.16 mm) and case.json of the
    BoundaryMode run on its port face x = 0 (Solver/BoundaryMode/
    Attributes [1]): PEC side walls, wave ports on both ends (the far one
    plays no part in the mode solve), the first mode at MODE_FREQ; returns
    the config path.  `eps` = (exx, eyy, ezz) makes the filling an
    anisotropic dielectric (MaterialAxes the global axes).  The face is the
    guide's y-z cross-section, so its TE10 (E along z) has kn =
    `te10_kn(MODE_FREQ, eps_r=ezz)` (1/m); the face's normal is x, so only
    a rotation into the face's frame takes exx out of the in-plane
    block."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_tet(n_len, n_a, n_b, lx=WAVEGUIDE_L, ly=WR90_A,
                             lz=WR90_B), os.path.join(directory, "guide.msh"))
    mat = {"Attributes": [1], "Permeability": 1.0, "Permittivity": 1.0}
    if eps is not None:
        mat.update(Permittivity=list(eps),
                   MaterialAxes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                 [0.0, 0.0, 1.0]])
    return _write_config(directory, {
        "Problem": {"Type": "BoundaryMode", "Verbose": verbose,
                    "Output": "postpro"},
        "Model": {"Mesh": "guide.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [mat]},
        "Boundaries": {
            "PEC": {"Attributes": [3, 4, 5, 6]},
            "WavePort": [{"Index": 1, "Attributes": [1]},
                         {"Index": 2, "Attributes": [2]}]},
        "Solver": {"Order": order, "Device": device,
                   "BoundaryMode": {"Freq": MODE_FREQ, "N": 1,
                                    "Attributes": [1]}}})
