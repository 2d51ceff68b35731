#!/usr/bin/env python3
"""Where a slice's time goes, on one CUDA GPU.

--problem driven (default): builds the driven slice case
(palace_torch/cases.py:write_slice_case, default 16^3 hex, Order 3) on
cuda:0 and reports:
  1. solver setup under cProfile (host), top functions by cumulative time;
  2. one plain solve of the 8-column block (wall time, synchronized);
  3. one solve with synchronizing timers around the solver's components
     (exclusive time per component);
  4. one solve under torch.profiler: device busy time and top kernels;
  5. postprocessing (measurements + error indicators) under cProfile.
Writes chiprun_out/profile_slice.txt.

--problem eigen: builds the eigenmode case (write_eigen_case, default 12^3
hex, Order 3, as in chip_smoke.py) and reports:
  1. the shift-invert solver and div-free projector setup under cProfile;
  2. one plain inner block solve (8 columns at the shift, synchronized);
  3. the whole block Lanczos eigensolve with synchronizing timers around
     its components (inner solves, fine K/M applies, host projection and
     orthonormalization; the rest is the host Lanczos recurrence);
  4. one inner block solve under torch.profiler: device busy time and top
     kernels;
  5. the modes' postprocessing (energies + error indicators) under cProfile.
Writes chiprun_out/profile_eigen.txt.

--problem adaptive: runs the adaptive PROM case (write_adaptive_case,
default 12^3 hex, Order 3, as in chip_smoke.py) through palace_torch.run and
reports:
  1. the whole run with synchronizing timers around its components: the
     solver setup, each sample's add_omega (_lmax_est, coarse splu, term
     sums), the HDM FGMRES solves (kernel #1, ELL SpMV, host coarse solve,
     V-cycle and Krylov work), reduced_tables, the MRI, the dense PROM
     solves and the postprocessing;
  2. one more sample's add_omega under cProfile;
  3. that sample's HDM solve plain and under torch.profiler: device busy
     time and top kernels.
Writes chiprun_out/profile_adaptive.txt.

--problem static: runs the rings magnetostatic and electrostatic cases
(cases.py:write_rings_case, h = 0.5 um, Order 2, as in chip_smoke.py; --h
and --order change them) through palace_torch.run and reports, for each:
  1. the whole run with synchronizing timers around its components: mesh
     preparation, the finite-element spaces, the host element matrices,
     the operators' copies to the device, the excitations, the CG solves
     (element applies, preconditioner and vector work), the estimator's
     discrete gradient, flux setup, mass solves and host integrals, and
     the tables;
  2. one more CG solve under torch.profiler: device busy time and top
     kernels.
Writes chiprun_out/profile_static.txt.

Each report is printed too.  Usage (repository root):
    python scripts/profile_torch_slice.py [--problem eigen|adaptive|static]
        [--n N] [--order P] [--h H]
(--device cpu rehearses the script at a small --n, or a large --h, without
a GPU.)
"""

from __future__ import annotations

import argparse
import cProfile
import io
import math
import os
import pstats
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


class ComponentTimer:
    """Exclusive wall time per label, synchronizing the device at every
    boundary (nested labels are subtracted from their parent)."""

    def __init__(self, sync):
        self.sync = sync
        self.excl = defaultdict(float)
        self.calls = defaultdict(int)
        self._stack = []

    def wrap(self, label, fn):
        def inner(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                dt = time.perf_counter() - t0
                child = self._stack.pop()
                self.excl[label] += dt - child
                self.calls[label] += 1
                if self._stack:
                    self._stack[-1] += dt
        return inner


def _device_busy(prof, work):
    """(busy seconds, [(name, (seconds, count))] by time) from the kernel,
    memcpy and memset intervals of the profiler's trace."""
    import json

    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, per = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            per[e["name"]][0] += e["dur"] * 1e-6
            per[e["name"]][1] += 1
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6, sorted(per.items(), key=lambda kv: -kv[1][0])


def _cprofile_top(fn, n=12):
    pr = cProfile.Profile()
    pr.enable()
    out = fn()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(n)
    return out, s.getvalue()


def _patched_run(patches, sync, fn):
    """Run fn with ComponentTimer wrappers around the (object, attribute,
    label) patches; returns (fn's result, wall seconds, timer)."""
    ct = ComponentTimer(sync)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, label in patches:
        setattr(obj, name, ct.wrap(label, getattr(obj, name)))
    try:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, f in saved:
            setattr(obj, name, f)
    return out, wall, ct


def _component_lines(ct, wall):
    out = []
    for label, t in sorted(ct.excl.items(), key=lambda kv: -kv[1]):
        out.append(f"  {label:45s} {t:9.3f} s  {100 * t / wall:5.1f}%  "
                   f"{ct.calls[label]} calls")
    rest = wall - sum(ct.excl.values())
    out.append(f"  {'unwrapped (host orchestration)':45s} {rest:9.3f} s  "
               f"{100 * rest / wall:5.1f}%")
    return out


def _profiled(fn, cuda, sync, work, launches, lines, label):
    """One call of fn under torch.profiler: device busy share and top
    device activities (CPU-only: the profiler's CPU table)."""
    from torch.profiler import ProfilerActivity, profile

    n0 = launches()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        pwall = time.perf_counter() - t0
    if cuda:
        busy, kernels = _device_busy(prof, work)
        lines.append(f"{label} (torch.profiler): wall {pwall:.3f} s, device "
                     f"busy {busy:.3f} s ({100 * busy / pwall:.1f}%, idle "
                     f"{100 * (1 - busy / pwall):.1f}%), structured kernel "
                     f"launches {launches() - n0}")
        lines.append("top device activities (s, count):")
        for name, (t, c) in kernels[:15]:
            lines.append(f"  {t:9.4f} {c:7d}  {name[:100]}")
    else:
        lines.append(f"{label} (torch.profiler, CPU only): wall {pwall:.3f} s")
        lines.append(prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=18,
            max_name_column_width=60))


def _profile_driven(args, dev, cuda, sync, lines, work):
    from palace_torch.cases import write_slice_case
    from palace_torch.config import IoData, ValueType
    from palace_torch.drivers import driven
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.fem import estimators
    from palace_torch.linalg import device_ksp
    from palace_torch.models.spaceoperator import SpaceOperator
    from palace_torch.ops import structured, structured_kernel

    lines.append(f"case: slice n={args.n} order={args.order}")
    iodata = IoData(write_slice_case(work, args.n, args.order,
                                     device="GPU" if cuda else "CPU",
                                     verbose=0))
    t0 = time.perf_counter()
    sop = SpaceOperator(iodata, prepare_mesh(iodata), device=dev)
    lines.append(f"operator construction {time.perf_counter() - t0:.2f} s, "
                 f"{sop.space.num_dofs} dofs")
    fscale = iodata.units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fscale
              for f in driven.driven_samples_ghz(iodata)]
    lin = iodata.solver.linear

    def build():
        return device_ksp.BlockedDeviceSolver(
            sop.space, iodata.boundaries.pec, sop.driven_terms(omegas),
            omegas, sop.ess_mask, tol=lin.tol, max_its=lin.max_its,
            device=dev)

    t0 = time.perf_counter()
    solver, prof = _cprofile_top(build)
    lines.append(f"solver setup (under cProfile) "
                 f"{time.perf_counter() - t0:.2f} s")
    lines.append(prof)
    rhs = np.stack([1j * w * sop.rhs1(1) for w in omegas], axis=1)

    sync()
    t0 = time.perf_counter()
    X, info = solver.solve(rhs)
    sync()
    wall = time.perf_counter() - t0
    lines.append(f"solve (plain): {wall:.3f} s, iterations "
                 f"{info['iterations'].tolist()}, max relres "
                 f"{info['relres'].max():.3e}")

    # Component timers (module-level functions and methods patched in place).
    _, timed, ct = _patched_run([
        (device_ksp, "_ell_apply", "ELL SpMV (G, Gt, P, Pt, aux terms)"),
        (device_ksp, "_hessenberg_lstsq", "host lstsq"),
        (device_ksp.BlockedDeviceSolver, "_coarse_solve",
         "coarse solve (host splu + copies)"),
        (structured.StructuredTermApply, "__call__",
         "structured fine apply (layout + combine)"),
        (structured, "structured_apply_flat", "structured kernel"),
        (device_ksp.BlockedDeviceSolver, "_vcycle", "V-cycle other"),
        (device_ksp.BlockedDeviceSolver, "_solve_block",
         "FGMRES other (MGS, updates)"),
    ], sync, lambda: solver.solve(rhs))
    lines.append(f"solve (component timers, synchronizing): {timed:.3f} s")
    lines += _component_lines(ct, timed)

    _profiled(lambda: solver.solve(rhs), cuda, sync, work,
              lambda: structured_kernel.structured_apply_flat.launches,
              lines, "solve")

    # Postprocessing under cProfile.
    def post():
        port_fn = {}
        for i, w in enumerate(omegas):
            driven.measure_step(sop, X[:, i], w, 1, port_fn.get, None)
            e2 = estimators.curl_flux_indicators(sop.space, sop.materials,
                                                 X[:, i], device=dev)
            e2 = e2 / w ** 2 + estimators.grad_flux_indicators(
                sop.space, sop.materials, X[:, i], device=dev)
        return e2

    t0 = time.perf_counter()
    _, prof = _cprofile_top(post)
    lines.append(f"postprocessing (under cProfile) "
                 f"{time.perf_counter() - t0:.2f} s")
    lines.append(prof)


def _profile_eigen(args, dev, cuda, sync, lines, work):
    from palace_torch.cases import write_eigen_case
    from palace_torch.config import IoData, ValueType
    from palace_torch.drivers import eigenmode
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.fem import estimators
    from palace_torch.linalg import device_eig, device_ksp
    from palace_torch.models.spaceoperator import SpaceOperator
    from palace_torch.ops import structured, structured_kernel

    lines.append(f"case: eigen n={args.n} order={args.order}")
    iodata = IoData(write_eigen_case(work, args.n, args.order,
                                     device="GPU" if cuda else "CPU",
                                     verbose=0))
    t0 = time.perf_counter()
    sop = SpaceOperator(iodata, prepare_mesh(iodata), device=dev)
    n = sop.space.num_dofs
    lines.append(f"operator construction {time.perf_counter() - t0:.2f} s, "
                 f"{n} dofs")
    # The arguments the eigenmode driver's first attempt passes.
    cfg = iodata.solver.eigenmode
    omega_t = 2 * math.pi * iodata.units.nondimensionalize(
        ValueType.FREQUENCY, cfg.target)
    sigma, nev = omega_t ** 2, 2 * max(cfg.n, 1) + 8
    F = min(n, max(nev // 2 + 4, 6))
    pec = list(iodata.boundaries.pec)
    K_t = sop._combine(sop.K_dom, sop.K_bdr)
    M_t = sop._combine(sop.M_re, sop.M_bdr)

    t0 = time.perf_counter()
    (solver, _, _), prof = _cprofile_top(lambda: device_eig.eig_setup(
        sop.space, pec, K_t, M_t, sop.ess_mask, sigma, F, tol=cfg.tol,
        device=dev))
    lines.append(f"solver + projector setup (under cProfile) "
                 f"{time.perf_counter() - t0:.2f} s")
    lines.append(prof)

    # One inner block solve at the shift (the Lanczos step's unit of work).
    rng = np.random.default_rng(5)
    B = rng.standard_normal((n, min(F, 8))) + 0.0j
    B[sop.ess_mask] = 0.0
    zeros = np.zeros(B.shape[1], int)
    sync()
    t0 = time.perf_counter()
    _, info = solver.solve(B, omega_idx=zeros)
    sync()
    lines.append(f"inner block solve (plain, {B.shape[1]} columns): "
                 f"{time.perf_counter() - t0:.3f} s, iterations "
                 f"{info['iterations'].tolist()}, max relres "
                 f"{info['relres'].max():.3e}")

    # The whole eigensolve with synchronizing component timers.
    res, timed, ct = _patched_run([
        (device_eig, "eig_setup", "solver + projector setup (host)"),
        (device_eig.DivFreeProjector, "__call__",
         "div-free projection (host splu)"),
        (device_eig, "_m_orthonormalize", "M-orthonormalization (host)"),
        (device_ksp.BlockedDeviceSolver, "apply_fine",
         "fine K/M applies (+ host copies)"),
        (device_ksp.BlockedDeviceSolver, "solve",
         "inner solve (host layout + copies)"),
        (device_ksp, "_ell_apply", "ELL SpMV (G, Gt, P, Pt, aux terms)"),
        (device_ksp, "_hessenberg_lstsq", "host lstsq"),
        (device_ksp.BlockedDeviceSolver, "_coarse_solve",
         "coarse solve (host splu + copies)"),
        (structured.StructuredTermApply, "__call__",
         "structured fine apply (layout + combine)"),
        (structured, "structured_apply_flat_v2", "structured kernel v2"),
        (device_ksp.BlockedDeviceSolver, "_vcycle", "V-cycle other"),
        (device_ksp.BlockedDeviceSolver, "_solve_block",
         "FGMRES other (MGS, updates)"),
    ], sync, lambda: device_eig.device_shift_invert_eigs(
        sop.space, pec, K_t, M_t, sop.ess_mask, sigma, nev, tol=cfg.tol,
        nconv=min(nev, cfg.n + 4), device=dev))
    info = device_eig.device_shift_invert_eigs.last_info
    lines.append(f"eigensolve (component timers, synchronizing): "
                 f"{timed:.3f} s, {info['restarts']} restarts, "
                 f"{info['ksp_iterations']} FGMRES iterations, fine level "
                 f"{info['fine_level']}")
    lines += _component_lines(ct, timed)

    _profiled(lambda: solver.solve(B, omega_idx=zeros), cuda, sync, work,
              lambda: structured_kernel.structured_apply_flat_v2.launches,
              lines, "inner block solve")

    # The modes' postprocessing (as the driver: the n lowest physical
    # modes, unit M-norm, energies and indicators) under cProfile.
    omega = np.sqrt(res.eigenvalues.astype(complex))
    keep = np.where(np.real(omega) > max(1e-8, 1e-3 * omega_t))[0]
    keep = keep[np.argsort(np.real(omega[keep]))][:cfg.n]
    M = sop.mass_csr()

    def post():
        for i in keep:
            x = res.eigenvectors[:, i]
            x = x / math.sqrt(abs(np.real(np.conj(x) @ (M @ x))))
            e2 = estimators.curl_flux_indicators(
                sop.space, sop.materials, x, device=dev) / abs(omega[i]) ** 2
            e2 = e2 + estimators.grad_flux_indicators(
                sop.space, sop.materials, x, device=dev)
            eigenmode._quad(sop.M_re, x)
            eigenmode._quad(sop.K_dom, x)
        return e2

    t0 = time.perf_counter()
    _, prof = _cprofile_top(post)
    lines.append(f"postprocessing of {len(keep)} modes (under cProfile) "
                 f"{time.perf_counter() - t0:.2f} s")
    lines.append(prof)


def _profile_adaptive(args, dev, cuda, sync, lines, work):
    import scipy.sparse.linalg as spla

    import palace_torch
    from palace_torch.cases import write_adaptive_case
    from palace_torch.config import ValueType
    from palace_torch.drivers import driven, driven_adaptive
    from palace_torch.fem import estimators
    from palace_torch.linalg import device_ksp
    from palace_torch.ops import structured, structured_kernel

    lines.append(f"case: adaptive n={args.n} order={args.order}")
    cfg = write_adaptive_case(work, args.n, args.order,
                              device="GPU" if cuda else "CPU", verbose=0)
    BDS = device_ksp.BlockedDeviceSolver
    MRI = driven_adaptive.MinimalRationalInterpolation
    n0 = structured_kernel.structured_apply_flat.launches

    # The whole run (palace_torch.run) with synchronizing timers around the
    # components of the greedy loop, the online sweep and postprocessing.
    res, timed, ct = _patched_run([
        (BDS, "__init__", "solver setup, once (Galerkin, aux, tables)"),
        (device_ksp, "_lmax_est", "add_omega: _lmax_est power iterations"),
        (spla, "splu", "add_omega: coarse splu"),
        (BDS, "add_omega", "add_omega: other (B(omega) term sums)"),
        (BDS, "solve", "HDM solve: host layout + copies"),
        (BDS, "_solve_block", "HDM FGMRES other (MGS, updates)"),
        (BDS, "_vcycle", "HDM V-cycle other"),
        (device_ksp, "_ell_apply", "HDM ELL SpMV (G, Gt, P, Pt, aux terms)"),
        (device_ksp, "_hessenberg_lstsq", "HDM host lstsq"),
        (BDS, "_coarse_solve", "HDM coarse solve (host splu + copies)"),
        (structured.StructuredTermApply, "__call__",
         "HDM structured fine apply (layout + combine)"),
        (structured, "structured_apply_flat", "HDM kernel #1"),
        (driven_adaptive, "_reduced_tables", "reduced_tables (host scipy)"),
        (MRI, "add_sample", "MRI add_sample"),
        (MRI, "find_max_error", "MRI find_max_error"),
        (driven_adaptive, "_prom_solve", "PROM dense solves (greedy + online)"),
        (driven_adaptive, "sweep_adaptive",
         "PROM other (CGS2, rhs, online V z)"),
        (driven, "measure_step", "postprocessing: measure_step"),
        (estimators, "curl_flux_indicators", "postprocessing: curl indicators"),
        (estimators, "grad_flux_indicators", "postprocessing: grad indicators"),
        (driven, "write_driven_tables", "postprocessing: tables"),
    ], sync, lambda: palace_torch.run(cfg))
    prom = res["prom"]
    sop = res["sop"]
    fscale = sop.iodata.units.scale_factor(ValueType.FREQUENCY)
    lines.append(f"{res['num_dofs']} dofs; {len(prom.samples)} HDM samples "
                 f"(f* GHz, iterations, relres): " + ", ".join(
                     f"{om * fscale / (2 * math.pi):.6f} "
                     f"{prom.hdm_iterations[(ex, om)]} "
                     f"{prom.hdm_relres[(ex, om)]:.2e}"
                     for ex, om, _ in prom.samples))
    lines.append(f"basis {prom.basis_size}, stopped by {prom.stopped_by}; "
                 f"kernel #1 launches "
                 f"{structured_kernel.structured_apply_flat.launches - n0}")
    lines.append(f"run (component timers, synchronizing): {timed:.3f} s")
    lines += _component_lines(ct, timed)

    # One more sample's host setup under cProfile, then its HDM solve plain
    # and under torch.profiler (device idle share).
    solver = prom.solver
    om = 2 * math.pi * 6.2 / fscale
    k, prof = _cprofile_top(lambda: solver.add_omega(om))
    lines.append("add_omega at 6.2 GHz (under cProfile)")
    lines.append(prof)
    b = (1j * om * sop.rhs1(1))[:, None]
    sync()
    t0 = time.perf_counter()
    _, info = solver.solve(b, omega_idx=[k])
    sync()
    lines.append(f"HDM solve at 6.2 GHz (plain): "
                 f"{time.perf_counter() - t0:.3f} s, iterations "
                 f"{info['iterations'].tolist()}, relres "
                 f"{info['relres'].max():.3e}")
    _profiled(lambda: solver.solve(b, omega_idx=[k]), cuda, sync, work,
              lambda: structured_kernel.structured_apply_flat.launches,
              lines, "HDM solve at 6.2 GHz")


def _profile_static(args, dev, cuda, sync, lines, work):
    import palace_torch
    from palace_torch.cases import write_rings_case
    from palace_torch.config import IoData
    from palace_torch.drivers import common, electrostatic, magnetostatic
    from palace_torch.fem import estimators, h1, nd, nd_operators
    from palace_torch.linalg import iterative
    from palace_torch.models import curlcurl, laplace
    from palace_torch.ops import partial

    PA = partial.PAOperator
    for problem, tol, max_its in (("Magnetostatic", 1e-8, 5000),
                                  ("Electrostatic", 1e-10, 3000)):
        lines.append(f"case: rings {problem} h={args.h} order={args.order}")
        cfg = write_rings_case(os.path.join(work, problem), args.h,
                               args.order, problem=problem, tol=tol,
                               max_its=max_its,
                               device="GPU" if cuda else "CPU", verbose=0)
        res, timed, ct = _patched_run([
            (common, "load_mesh", "mesh: load"),
            (electrostatic, "prepare_mesh", "mesh: crack, units"),
            (magnetostatic, "prepare_mesh", "mesh: crack, units"),
            (h1.H1Space, "__init__", "setup: H1 space"),
            (nd.NDSpace, "__init__", "setup: ND space"),
            (partial, "_assemble_element_matrices",
             "setup: H1 element matrices (host)"),
            (nd_operators, "_assemble", "setup: ND element matrices (host)"),
            (nd_operators, "_planar_sandwich", "setup: ND qdata (host)"),
            (PA, "__init__", "setup: operator tables to the device"),
            (curlcurl.CurlCurlOperator, "excitation",
             "setup: excitation (host traces)"),
            (laplace.LaplaceOperator, "excitation",
             "setup: excitation (eliminated rhs)"),
            (iterative, "cg", "solve: CG vector work + host reads"),
            (estimators, "cg", "estimator: mass CG"),
            (PA, "__call__", "element apply (solves, estimator, energies)"),
            (PA, "diagonal", "element diagonal"),
            (nd_operators, "nd_h1_gradient", "estimator: discrete gradient"),
            (estimators, "_rt_flux_setup", "estimator: RT flux setup"),
            (estimators, "grad_flux_indicators",
             "estimator: grad-flux host integrals"),
            (estimators, "curl_flux_indicators",
             "estimator: curl-flux host integrals"),
            (PA, "element_energy", "postprocessing: element energies"),
        ], sync, lambda: palace_torch.run(cfg))
        prov = res["provenance"]
        lines.append(f"{res['num_dofs']} dofs; CG iterations "
                     f"{prov['cg_iterations']}, relres {prov['cg_relres']}")
        lines.append(f"run (component timers, synchronizing): {timed:.3f} s")
        lines += _component_lines(ct, timed)
        op = res["operator"]
        b = (op.excitation(1) if problem == "Magnetostatic"
             else op.excitation(1)[1])
        sync()
        t0 = time.perf_counter()
        iodata = IoData(cfg)
        x, its, _ = common.solve_spd(iodata, op.Keli, op.K, b, op.ess_mask)
        sync()
        lines.append(f"one more solve (plain): {time.perf_counter() - t0:.3f}"
                     f" s, {its} iterations")
        _profiled(lambda: common.solve_spd(iodata, op.Keli, op.K, b,
                                           op.ess_mask),
                  cuda, sync, work, lambda: 0, lines,
                  f"{problem} CG solve")
        del res, op, x, b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=("driven", "eigen", "adaptive",
                                          "static"), default="driven")
    ap.add_argument("--n", type=int, default=None,
                    help="cells per side (default 16 driven, 12 eigen and "
                    "adaptive)")
    ap.add_argument("--order", type=int, default=None,
                    help="element order (default 3; 2 for static)")
    ap.add_argument("--h", type=float, default=0.5,
                    help="rings cell size in um (static)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if args.n is None:
        args.n = 16 if args.problem == "driven" else 12
    if args.order is None:
        args.order = 2 if args.problem == "static" else 3
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    def sync():
        if cuda:
            torch.cuda.synchronize()

    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() if cuda else "cpu")
    lines = [f"card: {card}; torch {torch.__version__}"]
    work = tempfile.mkdtemp()
    {"driven": _profile_driven, "eigen": _profile_eigen,
     "adaptive": _profile_adaptive, "static": _profile_static}[args.problem](
        args, dev, cuda, sync, lines, work)

    report = "\n".join(lines)
    os.makedirs("chiprun_out", exist_ok=True)
    name = {"driven": "profile_slice.txt", "eigen": "profile_eigen.txt",
            "adaptive": "profile_adaptive.txt",
            "static": "profile_static.txt"}[args.problem]
    with open(os.path.join("chiprun_out", name), "w") as f:
        f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
