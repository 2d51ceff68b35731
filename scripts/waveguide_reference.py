#!/usr/bin/env python3
"""The WR-90 guide of palace_torch/cases.py through both packages on the
CPU at reduced depth, against the analytic TE10 line: the numbers behind
chip_smoke.py's wave-port gates (phase 14) and its copper-short gate
(phase 16a); and the oracles of its eigenmode phases: the shorted guide
opened through a wave port (phase 19), whose modes are the fixed point of
the 1D TE10 problem E = sin(k (L - x)), omega^2 = c^2 (k^2 + (pi/a)^2),
with the port's condition k cot(k L) = -i beta(Re omega) at x = 0
(`palace_torch.cases.shorted_guide_mode`), and the copper-walled cavity
(phase 18), whose TE101 quality factor is the textbook wall-loss Q_c of a
rectangular cavity's TE10l mode (`palace_torch.cases.te10l_qc`).

Run from the repository root (about 7 minutes on 4 CPU threads):

    JAX_PLATFORMS=cpu python scripts/waveguide_reference.py

For each depth it prints, per package (palace_torch through `run` with
sparse direct; palace_tpu through its SpaceOperator, sparse-direct sweep
and measure_step), the worst over the 8 frequencies of ||S21| - 1|, |S11|,
|arg S21 + beta L| and |Re kn / beta - 1|; then how far the port's S at 18
and 24 cells along the guide (Order 3) is from its S at 36 cells (phase
15 runs a shorter guide than phase 14 and compares their S); then Re kn
of the 8 x 6, Order 3 cross-section alone, and the copper short's worst
|(1 - |S11|) / (1 - |Gamma|) - 1|; then both packages' modes of the
shorted guide (9 x 4 x 3, Order 2) against `shorted_guide_mode` and of
the cavity (4 x 2 x 5, Order 2) against `te10l_qc`.  This script compares the port with palace_tpu, so it
imports both (as the tests do); the port itself imports no JAX.
"""

import cmath
import math
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())

from palace_torch.cases import shorted_guide_mode, te10l_qc  # noqa: E402

C0, MU0, ETA0 = 299792458.0, 1.25663706127e-6, 376.730313412
A, L, SIGMA = 22.86e-3, 60e-3, 5.8e7


def te10(f_ghz):
    k = 2 * math.pi * f_ghz * 1e9 / C0
    return k, math.sqrt(k * k - (math.pi / A) ** 2)


def jax_sweep(path):
    """{(ex, i): measurement}, freqs, omegas and SpaceOperator of
    palace_tpu's sparse-direct sweep."""
    from palace_tpu.config import IoData, ValueType
    from palace_tpu.drivers import driven
    from palace_tpu.drivers.common import prepare_mesh
    from palace_tpu.models.spaceoperator import SpaceOperator

    io = IoData(path)
    sop = SpaceOperator(io, prepare_mesh(io))
    freqs = driven.driven_samples_ghz(io)
    fs = io.units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fs for f in freqs]
    sols = driven.sweep_uniform_direct(io, sop, omegas, sop.excitations())
    meas = {k: driven.measure_step(sop, E, omegas[k[1]], k[0],
                                   sop.port_functionals)
            for k, E in sols.items()}
    return meas, freqs, omegas, sop


def torch_sweep(path):
    import palace_torch

    res = palace_torch.run(path)
    return res["measurements"], res["freqs_ghz"], res["omegas"], res["sop"]


def line_errors(meas, freqs, omegas, sop):
    worst = dict.fromkeys(("S21", "S11", "phase", "kn"), 0.0)
    for (_, i), m in meas.items():
        k, beta = te10(freqs[i])
        S11, S21 = m.ports[1].S, m.ports[2].S
        kn = sop.wave_ports[1].solve_mode(omegas[i]).kn.real
        worst["S21"] = max(worst["S21"], abs(abs(S21) - 1.0))
        worst["S11"] = max(worst["S11"], abs(S11))
        worst["phase"] = max(worst["phase"], abs(cmath.phase(
            S21 * cmath.exp(1j * beta * L))))
        worst["kn"] = max(worst["kn"], abs(kn / omegas[i] * k / beta - 1))
    return worst


def short_error(meas, freqs):
    worst = 0.0
    for (_, i), m in meas.items():
        k, beta = te10(freqs[i])
        omega = 2 * math.pi * freqs[i] * 1e9
        Zs = (1 + 1j) * math.sqrt(omega * MU0 / (2 * SIGMA))
        gamma = (Zs - ETA0 * k / beta) / (Zs + ETA0 * k / beta)
        worst = max(worst, abs((1 - abs(m.ports[1].S)) / (1 - abs(gamma))
                               - 1))
    return worst


def main():
    import torch

    from palace_torch.cases import write_waveguide_case

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as wd:
        S = {}
        for n in ((18, 4, 3, 2), (36, 4, 3, 3), (18, 4, 3, 3), (24, 4, 3, 3)):
            path = write_waveguide_case(
                os.path.join(wd, "x".join(map(str, n))), *n,
                linear="SuperLU", device="CPU", verbose=0)
            both = n in ((18, 4, 3, 2), (36, 4, 3, 3))
            for name, sweep in (("palace_torch", torch_sweep),
                                ("palace_tpu", jax_sweep))[:2 if both else 1]:
                out = sweep(path)
                if name == "palace_torch":
                    S[n] = {k: (m.ports[1].S, m.ports[2].S)
                            for k, m in out[0].items()}
                if not both:
                    continue
                w = line_errors(*out)
                print(f"line {'x'.join(map(str, n[:3]))} p={n[3]} {name}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in w.items()),
                      flush=True)
        for n_len in (18, 24):
            a, b = S[(n_len, 4, 3, 3)], S[(36, 4, 3, 3)]
            d = max(abs(x - y) for k in b for x, y in zip(a[k], b[k]))
            print(f"depth {n_len} against 36 cells, 4x3 p=3 palace_torch: "
                  f"max |S difference| {d:.3e}", flush=True)
        path = write_waveguide_case(os.path.join(wd, "section"), 2, 8, 6, 3,
                                    linear="SuperLU", device="CPU", verbose=0)
        from palace_torch.config import IoData, ValueType
        from palace_torch.drivers.common import prepare_mesh
        from palace_torch.drivers.driven import driven_samples_ghz
        from palace_torch.models.spaceoperator import SpaceOperator

        io = IoData(path)
        sop = SpaceOperator(io, prepare_mesh(io))
        fs = io.units.scale_factor(ValueType.FREQUENCY)
        worst = 0.0
        for f in driven_samples_ghz(io):
            k, beta = te10(f)
            om = 2 * math.pi * f / fs
            kn = sop.wave_ports[1].solve_mode(om).kn.real
            worst = max(worst, abs(kn / om * k / beta - 1))
        print(f"cross-section 8x6 p=3 palace_torch: kn {worst:.3e}",
              flush=True)
        path = write_waveguide_case(os.path.join(wd, "short"), 9, 4, 3, 2,
                                    termination="conductivity",
                                    linear="SuperLU", freq_step=1.4,
                                    device="CPU", verbose=0)
        for name, sweep in (("palace_torch", torch_sweep),
                            ("palace_tpu", jax_sweep)):
            meas, freqs, _, _ = sweep(path)
            print(f"copper short 9x4x3 p=2 {name}: 1 - |S11| against "
                  f"1 - |Gamma| {short_error(meas, freqs):.3e}", flush=True)
        eigen_errors(wd)


def eigen_errors(wd):
    """Both packages' modes of the shorted guide and the copper cavity
    against their oracles."""
    import numpy as np

    import palace_torch
    import palace_tpu
    from palace_torch.cases import (COPPER_RS, WR90_B, CAVITY_D,
                                    write_cavity_case, write_guide_eigen_case)

    roots = [shorted_guide_mode(g)[0] for g in (9.4, 11.4)]
    q, f101 = te10l_qc(A, WR90_B * 1e-3, CAVITY_D * 1e-3, COPPER_RS)
    print(f"1D fixed point: {roots[0]:.9f}, {roots[1]:.9f} GHz; TE101 "
          f"{f101 / 1e9:.9f} GHz, Q_c {q:.6f}", flush=True)
    for tag, path, oracle in (
            ("shorted guide 9x4x3 p=2", write_guide_eigen_case(
                os.path.join(wd, "guide_eigen"), 9, 4, 3, 2, device="CPU",
                verbose=0), None),
            ("copper cavity 4x2x5 p=2", write_cavity_case(
                os.path.join(wd, "cavity"), 4, 2, 5, 2, device="CPU",
                verbose=0), (f101 / 1e9, q))):
        for name, run in (("palace_torch", palace_torch.run),
                          ("palace_tpu", palace_tpu.run)):
            f = np.asarray(run(path, os.path.join(
                os.path.dirname(path), name))
                           ["frequencies_ghz"])
            if oracle is None:
                err = max(abs(x - r) / abs(r) for x, r in zip(f, roots))
                print(f"{tag} {name}: modes {f}, max |df| / |f| {err:.3e}",
                      flush=True)
            else:
                Q = abs(f[0]) / (2 * f[0].imag)
                print(f"{tag} {name}: TE101 {f[0]:.9f} GHz (Re f "
                      f"{abs(f[0].real / oracle[0] - 1):.3e}), Q {Q:.6f} "
                      f"({abs(Q / oracle[1] - 1):.3e})", flush=True)


if __name__ == "__main__":
    main()
