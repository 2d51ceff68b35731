#!/usr/bin/env python3
"""Rehearse chip_smoke.py phases on the CPU, without a GPU.

Every run a phase sends to the GPU goes to the CPU instead (the device
resolver answers "cpu" and the CUDA timing calls do nothing), so a phase's
GPU-against-CPU parity compares the CPU with itself and its times are CPU
times: use it to find faults and to size a phase before its first chip
call, never as a device measurement (the element fine level's CUDA
timing, `chip_smoke._elem_apply_report`, is not run: its line prints
nan).  `--factor` times the transient
driver's host factorizations (scipy splu of M and of A = M + dt^2 K, and
one solve) on the TEM line of `palace_torch.cases.write_tem_line_case`;
`--line LENGTH N_LEN N_CROSS MAX_TIME` runs phase 22 on another line
(mm, box_tet cells along and across, ns), to read its oracles at another
depth than the chip's; `--set NAME=V1,V2,...` (repeatable, first on the
command line) sets a chip_smoke constant to the tuple of those numbers, or
to one number, to read a phase's gates at another depth before cutting
it (e.g. `--set FLOQUET_BOX=6,3 --set FLOQUET_BOX_DOFS=25506`, phase
24 before its cut).  `--card` leaves the GPU in place and runs the
named phases alone on the card (after the card line), on
chip_smoke.THREADS threads as in the smoke run's processes: their times
are then those of the phases alone on the GPU.  Phase 30 (`phase_sharded`)
starts its ranks as processes of their own, on the CPU in a rehearsal
(gloo): rehearsed alone, it runs its single-rank references itself.

Run from the repository root:
    python scripts/rehearse_smoke_cpu.py phase_transient phase_transient_parity
    python scripts/rehearse_smoke_cpu.py --factor 40 24 8
    python scripts/rehearse_smoke_cpu.py --line 40 24 8 0.4 phase_transient
    python3 scripts/rehearse_smoke_cpu.py --card phase_floquet_eigen
    python scripts/rehearse_smoke_cpu.py phase_2d phase_boundarymode \
        phase_boundarymode_3d
    python scripts/rehearse_smoke_cpu.py --set DRIVEN_N=4 \
        --set SHARDED_EIGEN_N=3 --set RINGS_H=2.0 --set RINGS_ORDER=1 \
        phase_sharded
Torch runs on RT threads (default 4) without `--card`."""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())


def factorizations(length: float, n_len: int, n_cross: int):
    import numpy as np
    from scipy.sparse.linalg import splu

    from palace_torch.cases import write_tem_line_case
    from palace_torch.config import IoData
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.drivers.transient import TransientOperator
    from palace_torch.models.spaceoperator import SpaceOperator

    with tempfile.TemporaryDirectory() as d:
        iodata = IoData(write_tem_line_case(d, length, n_len, n_cross, 2,
                                            device="CPU", verbose=0))
        sop = SpaceOperator(iodata, prepare_mesh(iodata))
        t0 = time.perf_counter()
        op = TransientOperator(iodata, sop, lambda t: 1.0)
        t_m = time.perf_counter() - t0
        # The default step (0.002 ns) in the line's time unit L / c0.
        dt = 0.002 / (length * 1e-3 / 299792458.0 * 1e9)
        t0 = time.perf_counter()
        lu = splu((op.M + dt * dt * op.K).tocsc())
        t_a = time.perf_counter() - t0
        b = np.random.default_rng(0).standard_normal(op.M.shape[0])
        t0 = time.perf_counter()
        lu.solve(b)
        t_s = time.perf_counter() - t0
    print(f"TEM line {length:g} mm, box_tet {n_len}x{n_cross}x{n_cross} "
          f"p=2: {sop.space.num_dofs} dofs; splu(M) {t_m:.2f} s, splu(A) "
          f"{t_a:.2f} s ({lu.L.nnz + lu.U.nnz} factor entries), a solve "
          f"{t_s:.3f} s (CPU)", flush=True)


def line_dofs(length: float, n_len: int, n_cross: int) -> int:
    """ND dofs of the Order 2 TEM line on box_tet n_len x n_cross^2."""
    from palace_torch.cases import write_tem_line_case
    from palace_torch.config import IoData
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.models.spaceoperator import SpaceOperator

    with tempfile.TemporaryDirectory() as d:
        iodata = IoData(write_tem_line_case(d, length, n_len, n_cross, 2,
                                            device="CPU", verbose=0))
        return SpaceOperator(iodata, prepare_mesh(iodata)).space.num_dofs


def main(argv) -> int:
    torch.set_num_threads(int(os.environ.get("RT", "4")))
    if argv[:1] == ["--factor"]:
        factorizations(float(argv[1]), int(argv[2]), int(argv[3]))
        return 0
    import chip_smoke

    while argv[:1] == ["--set"]:
        name, _, vals = argv[1].partition("=")
        nums = tuple(float(v) if "." in v else int(v)
                     for v in vals.split(","))
        old = getattr(chip_smoke, name)  # an existing constant only
        setattr(chip_smoke, name, nums if isinstance(old, tuple) else nums[0])
        argv = argv[2:]
    if argv[:1] == ["--card"]:
        print(chip_smoke.phase_card(), flush=True)
        torch.set_num_threads(chip_smoke.THREADS)
        return run_phases(chip_smoke, argv[1:], "GPU")
    if argv[:1] == ["--line"]:
        length, n_len, n_cross = float(argv[1]), int(argv[2]), int(argv[3])
        chip_smoke.TEM_LINE = (length, n_len, n_cross, 2)
        chip_smoke.TEM_LINE_DOFS = line_dofs(length, n_len, n_cross)
        chip_smoke.TEM_MAX_T = float(argv[4])
        argv = argv[5:]
    import palace_torch.device as device

    device.resolve_device = lambda name: torch.device("cpu")
    chip_smoke.SHARDED_DEVICE = "CPU"  # phase 30's ranks run on the CPU
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    # The element fine level's timing needs CUDA events: no CPU stand-in.
    chip_smoke._elem_apply_report = lambda sop, omegas: dict.fromkeys(
        ("ms", "device_ms", "bound_ms", "bytes", "columns", "terms",
         "elements"), float("nan")) | {"bound_by": "not timed on the CPU"}
    return run_phases(chip_smoke, argv, "CPU")


#: Phases that take an earlier phase's result, as the smoke run passes it:
#: phase 29 holds its port face's TE10 against phase 28's.
CHAINED = {"phase_boundarymode_3d": "phase_boundarymode"}


def run_phases(chip_smoke, names, where: str) -> int:
    """Run the named chip_smoke phases in one work directory; print each
    one's wall time and their total."""
    t_all = time.perf_counter()
    results = {}
    with tempfile.TemporaryDirectory() as workdir:
        for name in names:
            t0 = time.perf_counter()
            args = [results[CHAINED[name]]] if CHAINED.get(name) in results \
                else []
            results[name] = getattr(chip_smoke, name)(workdir, *args)
            print(f"{name}: {time.perf_counter() - t0:.1f} s ({where})",
                  flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s ({where})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
