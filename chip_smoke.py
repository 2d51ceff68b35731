#!/usr/bin/env python3
"""Smoke run of palace_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line; any failure exits nonzero and prints no
result line):
  1. card: CUDA must be available; prints nvidia-smi's name and power limit;
  2. build: compiles every hand-written kernel in palace_torch/csrc, one nvcc
     process per source, all started together; prints each kernel's
     registers and spills (ptxas) and its count of float64 tensor-core
     (DMMA) instructions (cuobjdump -sass), and fails if a float64 entry
     point has none;
  3. kernels against plain: both structured-apply kernels (natural channel
     order, carry-class order) against their plain PyTorch versions on the
     card at small shapes and at p = 3, 16^3 and 12^3, B = 16 (the driven
     and eigen paths' shape), float64 and float32; the first kernel also at
     the adaptive path's p = 3, 12^3, B = 2, float64.  At those shapes: the
     CUDA-event
     medians of both kernels (one call each, host work included), both
     plain versions and the stencil F.conv3d that computes the same
     operator (library_ms), the card's least time for the work (bound_ms),
     each kernel's achieved TFLOP/s (useful operations over its median) and
     share of the bound, and its device time alone (device_ms: 50 launches
     queued behind a sleeping kernel);
  4. driven path: palace_torch.run on the driven slice case (12^3 hex box,
     Order 3, 147,852 dofs, 8 frequencies, GMG, Tol 1e-8) on the GPU; checks
     the structured fine level engaged, the first kernel launched (and the
     second did not), every column converged, the host-recomputed residual
     of every column, and the written tables;
  5. driven card against host: the 4^3, Order 2 case on the GPU and on the
     CPU; domain-E.csv must agree to 1e-8;
  6. eigenmode path: palace_torch.run on the eigenmode case (12^3 hex box,
     Order 3, 147,852 dofs, 4 modes near 5 GHz, Tol 1e-8) on the GPU; checks
     the device Lanczos branch and the structured fine level ran, the second
     kernel launched (and the first did not), the modes against the analytic
     cavity frequencies, every backward error, an independent host residual
     of every pair, and the written tables;
  7. eigenmode card against host: the 3^3, Order 2 case (Tol 1e-5) on the
     GPU and on the CPU; eig.csv Re{f} must agree to 1e-10;
  8. adaptive path: palace_torch.run on the adaptive PROM case (12^3 hex
     box, Order 3, 147,852 dofs, 2.0-7.0 GHz in 0.1 GHz steps across the
     first resonance, AdaptiveTol 1e-6, GMG Tol 1e-8) on the GPU; checks
     every greedy HDM solve ran on the device solver with the structured
     fine level (no sparse-direct fallback), the first kernel launched (and
     the second did not), the loop stopped by AdaptiveMemory, every HDM
     relres and its host residual, the PROM field against a fresh HDM solve
     at 3.0, 6.2 and 6.9 GHz (1e-4 relative), and the written tables;
  9. adaptive card against host: the 4^3, Order 2 case on the GPU and on
     the CPU; the same sample count, every omega* within one MRI grid step,
     and domain-E.csv within 1e-5.
The line before the last is the kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

#: p = 4 (39 n-tiles) runs the core's two-pass route; p <= 3 one pass.
KERNEL_CASES = [(1, (3, 2, 4)), (2, (3, 2, 4)), (3, (3, 2, 4)),
                (4, (3, 2, 4)), (4, (8, 8, 8)), (2, (24, 24, 24)),
                (3, (12, 12, 12)), (3, (16, 16, 16))]
BATCH = 16  # B = 2F, F = 8 columns
#: Uniform driven phase depth (cut from 16^3 so that the adaptive phases
#: fit the time limit) and the dof counts at p = 3.
DRIVEN_N = 12
P3_DOFS = {12: 147852, 16: 345744}
#: The main-path shape of each kernel: the driven path runs the first
#: kernel at DRIVEN_N^3, the eigenmode path the second at 12^3.  Both
#: kernels are timed at 12^3 and 16^3.
DRIVEN_SHAPE, EIGEN_SHAPE = (DRIVEN_N,) * 3, (12, 12, 12)
TIMED_SHAPES = ((16, 16, 16), (12, 12, 12))
MAIN_P = 3
#: The adaptive path: one complex column per greedy HDM solve, so the first
#: kernel runs at B = 2 on the 12^3 lattice.
ADAPTIVE_SHAPE, ADAPTIVE_BATCH = (12, 12, 12), 2
TOL = {"float64": 1e-12, "float32": 1e-5}  # max abs err / max |y|
#: NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, and float64 FLOP/s on
#: the tensor cores (DMMA; 34 TFLOP/s on the FMA pipes) and float32 FLOP/s
#: outside them.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
C0 = 299792458.0  # m/s
CAVITY_L, CAVITY_EPS = 24e-3, 2.0  # palace_torch/cases.py


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def phase_card():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)
    return card


def _ptxas_usage(log: str):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    `nvcc -Xptxas -v` log of one source."""
    usage, name, spills = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage[name] = (int(m.group(1)),) + spills
    return usage


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    cands = [found] if found else []
    cands.append(os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump"))
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise SmokeFailure("cuobjdump not found")


def _dmma_counts(library: str):
    """{kernel: count of DMMA instructions} from cuobjdump -sass."""
    out = subprocess.run([_cuobjdump(), "-sass", library],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts, name = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bDMMA\b", ln):
            counts[name] += 1
    return counts


def _dtype_of(kernel: str) -> str:
    """"f64" / "f32", the stage count and "passes" (p >= 4) of a mangled
    instance of the core's kernel template,
    structured_apply_core<double|float, stages, passes>."""
    m = re.search(r"structured_apply_coreI([df])Li(\d+)ELb([01])E", kernel)
    if not m:
        return kernel
    return (f"{'f64' if m.group(1) == 'd' else 'f32'} x{m.group(2)}"
            f"{' passes' if m.group(3) == '1' else ''}")


def phase_build():
    from palace_torch.ops import structured_kernel as sk

    t0 = time.perf_counter()
    built = sk.build_kernels()
    for stem in ("structured_apply", "structured_apply_v2"):
        sk._library(stem)
    dt = time.perf_counter() - t0
    for path, log in built:
        usage = _ptxas_usage(log)
        dmma = _dmma_counts(path)
        f64 = [n for k, n in dmma.items() if _dtype_of(k).startswith("f64")]
        check(f64 and min(f64) > 0,
              f"{os.path.basename(path)}: a float64 kernel without DMMA "
              f"instructions ({dmma})")
        parts = []
        for k in sorted(dmma, key=_dtype_of):
            regs = (f"{usage[k][0]} registers, spills {usage[k][1]}/"
                    f"{usage[k][2]} bytes" if k in usage else "cached")
            parts.append(f"{_dtype_of(k)}: {regs}, {dmma[k]} DMMA")
        print(f"[2 build] {os.path.relpath(path)} ({dt:.2f} s for all); "
              f"{'; '.join(parts)}", flush=True)


def _time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, launches: int = 50) -> float:
    """Device time per launch: `launches` calls queued behind a sleeping
    kernel, so that the host's launch work overlaps the device's and the
    events time the kernels alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / launches


def _useful_ops(p: int, shape, batch: int) -> float:
    """2 nd^2 per real cell and batch column."""
    nd = 3 * p * (p + 1) ** 2
    return 2.0 * nd * nd * math.prod(shape) * batch


def _bound(p: int, shape, dtype_name: str, batch: int):
    """(bound_ms, bound_by): the card's least time for y = A u at this shape
    and batch, the larger of the compulsory bytes (Af, mask and u read once,
    y written once) over the memory rate and the useful operations (2 nd^2
    per real cell and column) over the peak rate of the type."""
    from palace_torch.ops.structured_kernel import _flat_tables

    _, _, _, _, Lp, Lu, _ = _flat_tables(p, tuple(shape))
    nd, C = 3 * p * (p + 1) ** 2, 3 * p ** 3
    size = 8 if dtype_name == "float64" else 4
    nbytes = (2 * batch * C * Lu + nd * nd + Lp) * size
    t_bytes = nbytes / PEAK_BYTES
    t_ops = _useful_ops(p, shape, batch) / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    """Both kernels against their plain versions; returns the JSON records
    of each kernel at its main-path shape (float64)."""
    import numpy as np
    import torch

    from palace_torch.ops import structured_kernel as sk
    from palace_torch.ops.structured import (StructuredNDOperator,
                                             structured_apply_conv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    kernels = {"structured_apply_flat": (sk.structured_apply_flat,
                                         sk.structured_apply_flat_ref),
               "structured_apply_flat_v2": (sk.structured_apply_flat_v2,
                                            sk.structured_apply_flat_v2_ref)}
    main_shape = {"structured_apply_flat": DRIVEN_SHAPE,
                  "structured_apply_flat_v2": EIGEN_SHAPE}
    records = {}
    t0 = time.perf_counter()
    for p, shape in KERNEL_CASES:
        sop = StructuredNDOperator.build_uniform(p, shape, 1.5, curl=1.0,
                                                 mass=-0.3)
        Af_perm = sk.v2_tables(sop)[0]
        u64 = rng.standard_normal((BATCH, 3 * p ** 3, sk.flat_size(p, shape)))
        timed = p == MAIN_P and shape in TIMED_SHAPES
        for dt in (torch.float64, torch.float32):
            name = str(dt).replace("torch.", "")
            u = torch.as_tensor(u64, dtype=dt, device=dev)
            line = f"[3 kernels] p={p} shape={shape} B={BATCH} {name}:"
            if timed:
                bound_ms, bound_by = _bound(p, shape, name, BATCH)
            for kname, (fn, ref) in kernels.items():
                A = sop.Af if kname == "structured_apply_flat" else Af_perm
                A = torch.as_tensor(A, dtype=dt, device=dev).contiguous()
                y = fn(A, u, p=p, shape=shape)
                torch.cuda.synchronize()
                y_ref = ref(A, u, p=p, shape=shape)
                err = float((y - y_ref).abs().max())
                scale = float(y_ref.abs().max())
                check(err <= TOL[name] * scale,
                      f"{kname} p={p} {shape} {name}: max abs err {err:.3e} "
                      f"> {TOL[name]:.0e} x {scale:.3e}")
                line += f" {kname} max abs err {err:.3e};"
                if not timed:
                    continue
                ms = _time_ms(lambda: fn(A, u, p=p, shape=shape))
                dev_ms = _device_ms(lambda: fn(A, u, p=p, shape=shape))
                plain_ms = _time_ms(lambda: ref(A, u, p=p, shape=shape))
                tflops = _useful_ops(p, shape, BATCH) / (ms * 1e-3) / 1e12
                share = bound_ms / ms
                line += (f" median {ms:.4f} ms ({tflops:.2f} TFLOP/s, "
                         f"{100 * share:.1f}% of bound), device "
                         f"{dev_ms:.4f} ms ({100 * bound_ms / dev_ms:.1f}% "
                         f"of bound), plain {plain_ms:.4f} ms;")
                if name != "float64":
                    continue
                at = {"ms": ms, "tflops": tflops, "bound_share": share,
                      "device_ms": dev_ms,
                      "device_bound_share": bound_ms / dev_ms}
                if shape == main_shape[kname]:
                    records.setdefault(kname, {}).update(
                        max_abs_err=err, plain_ms=plain_ms, **at)
                else:
                    records.setdefault(kname, {})["other_shape"] = dict(
                        shape="x".join(map(str, shape)), **at)
            if timed:
                # The library yardstick: the stencil convolution on the
                # lattice layout of the same data (never called by the port).
                W = torch.as_tensor(sop.W, dtype=dt, device=dev)
                lat = sk.from_flat(u, p, shape).contiguous()
                ess = torch.as_tensor(sop.ess_lat, device=dev)
                y_conv = structured_apply_conv(W, lat, ess)
                y_flat = sk.structured_apply_lattice(sop, lat)
                conv_err = float((y_conv - y_flat).abs().max())
                check(conv_err <= 1e3 * TOL[name] * float(
                    y_flat.abs().max()), f"conv3d disagrees: {conv_err:.3e}")
                lib_ms = _time_ms(lambda: torch.nn.functional.conv3d(
                    lat, W, padding=1))
                line += (f" F.conv3d {lib_ms:.4f} ms; bound {bound_ms:.4f} "
                         f"ms ({bound_by})")
                for kname, rec in records.items():
                    if name == "float64" and shape == main_shape[kname]:
                        rec.update(bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib_ms)
            print(line, flush=True)
    records["structured_apply_flat"]["adaptive_shape"] = _time_adaptive_shape()
    print(f"[3 kernels] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return records


def _time_adaptive_shape():
    """Kernel #1 at the adaptive path's shape: one complex column of a
    greedy HDM solve, B = 2 (its real and imaginary parts), p = 3, 12^3,
    float64; the same timings as the main-path rows."""
    import numpy as np
    import torch

    from palace_torch.ops import structured_kernel as sk
    from palace_torch.ops.structured import (StructuredNDOperator,
                                             structured_apply_conv)

    p, shape, batch = MAIN_P, ADAPTIVE_SHAPE, ADAPTIVE_BATCH
    dev = torch.device("cuda:0")
    sop = StructuredNDOperator.build_uniform(p, shape, 1.5, curl=1.0,
                                             mass=-0.3)
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.standard_normal(
        (batch, 3 * p ** 3, sk.flat_size(p, shape))), device=dev)
    A = torch.as_tensor(sop.Af, device=dev).contiguous()
    fn, ref = sk.structured_apply_flat, sk.structured_apply_flat_ref
    y = fn(A, u, p=p, shape=shape)
    torch.cuda.synchronize()
    y_ref = ref(A, u, p=p, shape=shape)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    check(err <= TOL["float64"] * scale,
          f"structured_apply_flat p={p} {shape} B={batch}: max abs err "
          f"{err:.3e} > {TOL['float64']:.0e} x {scale:.3e}")
    ms = _time_ms(lambda: fn(A, u, p=p, shape=shape))
    dev_ms = _device_ms(lambda: fn(A, u, p=p, shape=shape))
    plain_ms = _time_ms(lambda: ref(A, u, p=p, shape=shape))
    W = torch.as_tensor(sop.W, device=dev)
    lat = sk.from_flat(u, p, shape).contiguous()
    y_conv = structured_apply_conv(W, lat, torch.as_tensor(sop.ess_lat,
                                                           device=dev))
    conv_err = float((y_conv - sk.structured_apply_lattice(sop, lat))
                     .abs().max())
    check(conv_err <= 1e3 * TOL["float64"] * scale,
          f"conv3d disagrees at B={batch}: {conv_err:.3e}")
    lib_ms = _time_ms(lambda: torch.nn.functional.conv3d(lat, W, padding=1))
    bound_ms, bound_by = _bound(p, shape, "float64", batch)
    tflops = _useful_ops(p, shape, batch) / (ms * 1e-3) / 1e12
    print(f"[3 kernels] adaptive shape p={p} shape={shape} B={batch} "
          f"float64: structured_apply_flat max abs err {err:.3e}; median "
          f"{ms:.4f} ms ({tflops:.2f} TFLOP/s, {100 * bound_ms / ms:.1f}% of "
          f"bound), device {dev_ms:.4f} ms ({100 * bound_ms / dev_ms:.1f}% "
          f"of bound), plain {plain_ms:.4f} ms; F.conv3d {lib_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(shape="x".join(map(str, shape)), batch=batch,
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=tflops, bound_share=bound_ms / ms,
                device_bound_share=bound_ms / dev_ms)


def _table(path: str):
    import numpy as np

    check(os.path.exists(path), f"missing {path}")
    data = np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=1))
    check(data.size > 0 and np.isfinite(data).all(),
          f"{os.path.basename(path)} is empty or not finite")
    return data


def _rel_diff(a, b) -> float:
    """Max over columns of max |a - b| / max |b| (columns of zeros must
    match exactly)."""
    import numpy as np

    worst = 0.0
    for j in range(b.shape[1]):
        d = float(np.abs(a[:, j] - b[:, j]).max())
        s = float(np.abs(b[:, j]).max())
        worst = max(worst, d / s if s > 0 else (0.0 if d == 0 else np.inf))
    return worst


def _zero_counts():
    from palace_torch.ops import structured_kernel as sk

    sk.structured_apply_flat.launches = 0
    sk.structured_apply_flat_v2.launches = 0


def _counts():
    from palace_torch.ops import structured_kernel as sk

    return (sk.structured_apply_flat.launches,
            sk.structured_apply_flat_v2.launches)


def _durations(post: str) -> str:
    with open(os.path.join(post, "palace.json")) as f:
        dur = json.load(f)["ElapsedTime"]["Durations"]
    return ", ".join(f"{k} {dur[k]:.2f} s" for k in (
        "Operatorconstruction", "Setup", "Linearsolve", "PROMconstruction",
        "Eigenvaluesolve", "Postprocessing") if k in dur)


def phase_driven(workdir: str):
    import numpy as np
    import torch

    import palace_torch
    from palace_torch.cases import write_slice_case

    t_phase = time.perf_counter()
    cfg = write_slice_case(os.path.join(workdir, "driven"), DRIVEN_N, 3,
                           tol=1e-8, max_its=200, device="GPU", verbose=0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = _counts()
    peak = torch.cuda.max_memory_allocated()
    prov, info = res["provenance"], res["ksp"]
    check(res["num_dofs"] == P3_DOFS[DRIVEN_N],
          f"unexpected dof count {res['num_dofs']}")
    check(prov.get("fine_level") == "structured",
          f"structured fine level did not engage ({prov})")
    check(prov.get("solver_path") == "device", f"solver path {prov}")
    check(launches > 0, "structured_apply_flat was never launched")
    check(other == 0, f"structured_apply_flat_v2 launched {other} times on "
                      "the driven path")
    relres = info.get("col_relres", {})
    check(len(relres) == 8 and max(relres.values()) <= 1e-8,
          f"column relres {relres}")

    # Host residual per column from the assembled system (scipy only).
    sop = res["sop"]
    K, C, M = sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr()
    worst = 0.0
    for (ex, i), x in res["solutions"].items():
        w = res["omegas"][i]
        b = 1j * w * sop.rhs1(ex)
        r = b - sop.system_csr(w, K, C, M) @ x
        worst = max(worst, float(np.linalg.norm(r) / np.linalg.norm(b)))
    check(worst <= 1e-7, f"host residual {worst:.3e} > 1e-7")
    post = res["post_dir"]
    for name in ("domain-E.csv", "error-indicators.csv", "port-S.csv"):
        _table(os.path.join(post, name))
    print(f"[4 driven] {DRIVEN_N}^3 hex p=3: {res['num_dofs']} dofs, 8 "
          f"columns, "
          f"iterations {info.get('total_its')} total, max relres "
          f"{max(relres.values()):.3e}, host residual {worst:.3e}; "
          f"structured_apply_flat launches {launches}; {_durations(post)}, "
          f"run {wall:.2f} s; peak device memory {peak / 2 ** 30:.3f} GiB; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_driven_parity(workdir: str):
    import palace_torch
    from palace_torch.cases import write_slice_case

    tabs = {}
    t0 = time.perf_counter()
    for device in ("GPU", "CPU"):
        cfg = write_slice_case(os.path.join(workdir, f"driven_{device}"), 4,
                               2, tol=1e-10, device=device, verbose=0)
        res = palace_torch.run(cfg)
        tabs[device] = _table(os.path.join(res["post_dir"], "domain-E.csv"))
    rel = _rel_diff(tabs["GPU"], tabs["CPU"])
    check(rel <= 1e-8, f"domain-E GPU vs CPU relative difference {rel:.3e}")
    print(f"[5 driven parity] 4^3 hex p=2: domain-E.csv GPU vs CPU max "
          f"relative difference {rel:.3e}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_eigen(workdir: str):
    import numpy as np
    import torch

    import palace_torch
    from palace_torch.cases import write_eigen_case

    tol = 1e-8
    t_phase = time.perf_counter()
    cfg = write_eigen_case(os.path.join(workdir, "eigen"), 12, 3, tol=tol,
                           device="GPU", verbose=0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    other, launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    prov = res["provenance"]
    check(res["num_dofs"] == 147852, f"unexpected dof count {res['num_dofs']}")
    check(prov.get("eigen_path") == "device-lanczos", f"eigen path {prov}")
    check(prov.get("fine_level") == "structured",
          f"structured fine level did not engage ({prov})")
    check(launches > 0, "structured_apply_flat_v2 was never launched")
    check(other == 0, f"structured_apply_flat launched {other} times on the "
                      "eigenmode path")
    f = np.real(res["frequencies_ghz"])
    f101 = C0 / (2 * CAVITY_L * math.sqrt(CAVITY_EPS)) * math.sqrt(2) / 1e9
    f111 = C0 / (2 * CAVITY_L * math.sqrt(CAVITY_EPS)) * math.sqrt(3) / 1e9
    ref = np.array([f101, f101, f101, f111])
    check(len(f) == 4, f"{len(f)} modes returned")
    ferr = np.abs(f - ref) / ref
    check(ferr.max() <= 1e-7, f"frequencies {f} GHz vs analytic {ref}: "
                              f"relative error {ferr.max():.3e} > 1e-7")
    bkwd = np.asarray(res["backward_errors"])
    check(bkwd.max() <= tol, f"backward errors {bkwd}")

    # Independent host residual of every pair (scipy only), free rows.
    from palace_torch.config import ValueType

    sop = res["sop"]
    K, M = sop.stiffness_csr(), sop.mass_csr()
    free = ~sop.ess_mask
    fscale = sop.iodata.units.scale_factor(ValueType.FREQUENCY)
    Kn, Mn = abs(K).sum(axis=0).max(), abs(M).sum(axis=0).max()
    worst = 0.0
    for i in range(res["modes"].shape[1]):
        x = res["modes"][:, i]
        lam = (2 * math.pi * complex(res["frequencies_ghz"][i]) / fscale) ** 2
        r = (K @ x - lam * (M @ x))[free]
        worst = max(worst, float(np.linalg.norm(r) / (
            (Kn + abs(lam) * Mn) * np.linalg.norm(x))))
    check(worst <= 10 * tol, f"host residual {worst:.3e} > {10 * tol:.0e}")
    post = res["post_dir"]
    for name in ("eig.csv", "domain-E.csv", "error-indicators.csv"):
        _table(os.path.join(post, name))
    print(f"[6 eigen] 12^3 hex p=3: {res['num_dofs']} dofs, Re f "
          f"{', '.join(f'{v:.9f}' for v in f)} GHz (analytic {f101:.9f} x3, "
          f"{f111:.9f}; max relative error {ferr.max():.3e}), max backward "
          f"error {bkwd.max():.3e}, host residual {worst:.3e}; Lanczos "
          f"restarts {prov.get('lanczos_restarts')}, FGMRES iterations "
          f"{prov.get('ksp_iterations')}; structured_apply_flat_v2 launches "
          f"{launches}; {_durations(post)}, run {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_eigen_parity(workdir: str):
    import numpy as np

    import palace_torch
    from palace_torch.cases import write_eigen_case

    freqs = {}
    t0 = time.perf_counter()
    for device in ("GPU", "CPU"):
        cfg = write_eigen_case(os.path.join(workdir, f"eigen_{device}"), 3, 2,
                               tol=1e-5, device=device, verbose=0)
        res = palace_torch.run(cfg)
        check(res["provenance"].get("eigen_path") == "device-lanczos",
              f"eigen path {res['provenance']}")
        freqs[device] = _table(os.path.join(res["post_dir"], "eig.csv"))[:, 1]
    rel = float(np.abs(freqs["GPU"] - freqs["CPU"]).max()
                / np.abs(freqs["CPU"]).max())
    check(rel <= 1e-10, f"eig.csv Re f GPU vs CPU relative difference "
                        f"{rel:.3e}")
    print(f"[7 eigen parity] 3^3 hex p=2: eig.csv Re f GPU vs CPU max "
          f"relative difference {rel:.3e}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _host_residual(sop, E, omega, ex, KCM) -> float:
    """||b - A(omega) E|| / ||b|| from the assembled system (scipy only)."""
    import numpy as np

    b = 1j * omega * sop.rhs1(ex)
    r = b - sop.system_csr(omega, *KCM) @ E
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _ghz(sop, omega) -> float:
    from palace_torch.config import ValueType

    return omega * sop.iodata.units.scale_factor(ValueType.FREQUENCY) / (
        2 * math.pi)


def phase_adaptive(workdir: str):
    """The adaptive PROM sweep on the 12^3, p = 3 cavity (2.0-7.0 GHz, 51
    online frequencies, across the 6.245676 GHz resonance)."""
    import numpy as np
    import torch

    import palace_torch
    from palace_torch.cases import write_adaptive_case

    t_phase = time.perf_counter()
    tol = 1e-6  # the case's AdaptiveTol
    cfg = write_adaptive_case(os.path.join(workdir, "adaptive"), 12, 3,
                              device="GPU", verbose=0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = _counts()
    peak = torch.cuda.max_memory_allocated()
    prov, prom = res["provenance"], res["prom"]
    check(res["num_dofs"] == P3_DOFS[12],
          f"unexpected dof count {res['num_dofs']}")
    check(prov.get("solver_path") == "prom-adaptive"
          and prov.get("prom_hdm_path") == "device"
          and prov.get("fine_level") == "structured"
          and not prov.get("prom_hdm_direct_fallbacks"),
          f"adaptive provenance {prov}")
    check(launches > 0, "structured_apply_flat was never launched")
    check(other == 0, f"structured_apply_flat_v2 launched {other} times on "
                      "the adaptive path")
    check(prom.stopped_by == {1: "memory"},
          f"greedy loop stopped by {prom.stopped_by}, not AdaptiveMemory")
    relres = prom.hdm_relres
    check(len(relres) == len(prom.samples) and max(relres.values()) <= 1e-8,
          f"HDM relres {relres}")

    sop = res["sop"]
    KCM = (sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr())
    worst = max(_host_residual(sop, E, om, ex, KCM)
                for (ex, om), E in prom.hdm.items())
    check(worst <= 1e-7, f"HDM host residual {worst:.3e} > 1e-7")

    # The PROM field against a fresh HDM solve through the same solver at
    # three online frequencies (the printed samples show they are not
    # samples).
    solver = prom.solver
    errs = []
    for f in (3.0, 6.2, 6.9):
        i = int(np.argmin(np.abs(np.asarray(res["freqs_ghz"]) - f)))
        om = res["omegas"][i]
        b = 1j * om * sop.rhs1(1)
        X, info = solver.solve(b[:, None], omega_idx=[solver.add_omega(om)])
        check(float(info["relres"][0]) <= 1e-8,
              f"fresh HDM solve at {f} GHz: relres {info['relres']}")
        E = res["solutions"][(1, i)]
        errs.append(float(np.linalg.norm(E - X[:, 0])
                          / np.linalg.norm(X[:, 0])))
    check(max(errs) <= 100 * tol,
          f"PROM against HDM at 3.0, 6.2, 6.9 GHz: {errs} > {100 * tol:.0e}")
    post = res["post_dir"]
    for name in ("domain-E.csv", "error-indicators.csv", "port-S.csv"):
        _table(os.path.join(post, name))
    samples = ", ".join(
        f"{_ghz(sop, om):.6f} ({err:.2e})" for _, om, err in prom.samples)
    its = sum(prom.hdm_iterations.values())
    print(f"[8 adaptive] 12^3 hex p=3: {res['num_dofs']} dofs, "
          f"{len(prom.samples)} HDM samples, f* GHz (PROM error) {samples}; "
          f"stopped by AdaptiveMemory; basis {prom.basis_size}; HDM FGMRES "
          f"iterations {its}, max relres {max(relres.values()):.3e}, host "
          f"residual {worst:.3e}; PROM vs fresh HDM at 3.0/6.2/6.9 GHz "
          f"{', '.join(f'{e:.3e}' for e in errs)}; structured_apply_flat "
          f"launches {launches}; {_durations(post)}, run {wall:.2f} s; peak "
          f"device memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_adaptive_parity(workdir: str):
    import numpy as np

    import palace_torch
    from palace_torch.cases import write_adaptive_case

    tol = 1e-6  # the case's AdaptiveTol
    tabs, omegas = {}, {}
    t0 = time.perf_counter()
    for device in ("GPU", "CPU"):
        cfg = write_adaptive_case(os.path.join(workdir, f"adaptive_{device}"),
                                  4, 2, device=device, verbose=0)
        res = palace_torch.run(cfg)
        omegas[device] = np.array([om for _, om, _ in res["prom"].samples])
        tabs[device] = _table(os.path.join(res["post_dir"], "domain-E.csv"))
    grid_step = (max(res["omegas"]) - min(res["omegas"])) / 200000
    check(len(omegas["GPU"]) == len(omegas["CPU"]),
          f"GPU took {len(omegas['GPU'])} samples, CPU {len(omegas['CPU'])}")
    dz = float(np.abs(omegas["GPU"] - omegas["CPU"]).max())
    check(dz <= grid_step, f"sample frequencies differ by {dz:.3e} > one "
                           f"MRI grid step {grid_step:.3e}")
    rel = _rel_diff(tabs["GPU"], tabs["CPU"])
    check(rel <= 10 * tol, f"domain-E GPU vs CPU relative difference "
                           f"{rel:.3e}")
    print(f"[9 adaptive parity] 4^3 hex p=2: {len(omegas['GPU'])} samples "
          f"on both, max omega* difference {dz:.3e} (grid step "
          f"{grid_step:.3e}); domain-E.csv GPU vs CPU max relative "
          f"difference {rel:.3e}; phase {time.perf_counter() - t0:.1f} s",
          flush=True)


def main() -> int:
    try:
        import torch

        card = phase_card()
        phase_build()
        records = phase_kernels()
        with tempfile.TemporaryDirectory() as workdir:
            by_path = {"structured_apply_flat": {"eigen": 0},
                       "structured_apply_flat_v2": {"driven": 0,
                                                    "adaptive": 0}}
            by_path["structured_apply_flat"]["driven"] = phase_driven(workdir)
            phase_driven_parity(workdir)
            by_path["structured_apply_flat_v2"]["eigen"] = phase_eigen(
                workdir)
            phase_eigen_parity(workdir)
            by_path["structured_apply_flat"]["adaptive"] = phase_adaptive(
                workdir)
            phase_adaptive_parity(workdir)
    except SmokeFailure as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    except ImportError as e:
        print(f"FAILED: {e} (run from the repository root)", flush=True)
        return 1
    source = {"structured_apply_flat": (
        "palace_torch/csrc/structured_apply.cu",
        "palace_tpu/ops/pallas_structured.py:241"),
        "structured_apply_flat_v2": (
        "palace_torch/csrc/structured_apply_v2.cu",
        "palace_tpu/ops/pallas_structured.py:151")}
    kernels = {"kernels": [dict(
        name=name, route="cuda", source=source[name][0],
        replaces=source[name][1], launches=sum(by_path[name].values()),
        launches_by_path=by_path[name], **records[name])
        for name in ("structured_apply_flat", "structured_apply_flat_v2")]}
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
