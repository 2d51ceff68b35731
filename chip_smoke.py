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
     card at small shapes and at p = 3, 16^3, 12^3, 10^3 and 8^3, B = 16
     (the driven and eigen paths' shapes), float64 and float32; the first kernel
     also at the adaptive path's p = 3, 10^3, B = 2, float64.  At those
     shapes: the CUDA-event
     medians of both kernels (one call each, host work included), both
     plain versions and the stencil F.conv3d that computes the same
     operator (library_ms), the card's least time for the work (bound_ms),
     each kernel's achieved TFLOP/s (useful operations over its median) and
     share of the bound, and its device time alone (device_ms: 50 launches
     queued behind a sleeping kernel);
  4. driven path: palace_torch.run on the driven slice case (10^3 hex box,
     Order 3, 86,490 dofs, 8 frequencies, GMG, Tol 1e-8) on the GPU; checks
     the structured fine level engaged, the first kernel launched (and the
     second did not), every column converged, the host-recomputed residual
     of every column, and the written tables;
  5. driven card against host: the 4^3, Order 2 case on the GPU and on the
     CPU; domain-E.csv must agree to 1e-8;
  6. eigenmode path: palace_torch.run on the eigenmode case (8^3 hex box,
     Order 3, 45,000 dofs, 4 modes near 5 GHz, Tol 1e-8) on the GPU; checks
     the device Lanczos branch and the structured fine level ran, the second
     kernel launched (and the first did not), the modes against the analytic
     cavity frequencies, every backward error, an independent host residual
     of every pair, and the written tables;
  7. eigenmode card against host: the 3^3, Order 2 case (Tol 1e-5) on the
     GPU and on the CPU; eig.csv Re{f} must agree to 1e-10;
  8. adaptive path: palace_torch.run on the adaptive PROM case (10^3 hex
     box, Order 3, 86,490 dofs, 2.0-7.0 GHz in 0.1 GHz steps across the
     first resonance, AdaptiveTol 1e-6, GMG Tol 1e-8) on the GPU; checks
     every greedy HDM solve ran on the device solver with the structured
     fine level (no sparse-direct fallback), the first kernel launched (and
     the second did not), the loop stopped by AdaptiveMemory, every HDM
     relres and its host residual, the PROM field against a fresh HDM solve
     at 3.0, 6.2 and 6.9 GHz (1e-4 relative), and the written tables;
  9. adaptive card against host: the 4^3, Order 2 case on the GPU and on
     the CPU; the same sample count, every omega* within one MRI grid step,
     and domain-E.csv within 1e-5;
 10. magnetostatic path: palace_torch.run on the rings case (two square
     ribbon loops in a graded 280 um box, h = 0.5 um, Nedelec Order 2,
     1,301,308 dofs, Tol 1e-8) on the GPU; checks both CG solves reached
     Tol (provenance), a host residual of one solve (scipy CSR of the
     eliminated K), M symmetric before symmetrization, M within 10% of the
     analytic ribbon inductances, and the written tables; prints the
     palace.json timers, the element apply's device time against its
     bound, the applies per solve, the device idle share of CG iterations
     and the peak device memory;
 11. magnetostatic against palace_tpu: the rings case at h = 1.0, Order 1
     on the GPU, M within 1e-6 of RINGS_VALIDATION.json's "solved" values;
     the current sheet of tests/test_drivers_e2e.py:49 on the GPU and on
     the CPU, terminal-M.csv within 1e-10;
 12. electrostatic path: the rings case with the rings as terminals
     (h = 0.5 um, H1 Order 2, 439,597 dofs, Tol 1e-10, grad-flux
     indicators on the 1,298,844-dof ND space) on the GPU; checks both
     solves, a host residual, C symmetric positive definite with C12 < 0,
     C within 1e-8 of palace_tpu's C for the same config and the
     error-indicator Norm within 1e-6 of palace_tpu's; the same report as
     phase 10;
 13. electrostatic and AMR, card against host: the rings case at h = 1.0,
     Order 1 (terminal-C.csv within 1e-9), the parallel plate of
     tests/test_drivers_e2e.py:25 on the GPU (C = eps A / d to 1e-9), and
     two tet AMR loops (MaxIts 2) on the GPU and on the CPU: the parallel
     plate of tests/test_amr.py:42 (terminal-C.csv within 1e-8) and the
     same box with terminal and ground on adjacent faces (the same element
     counts per iteration, terminal-C.csv within 1e-8);
 14. wave-port path: palace_torch.run on the WR-90 guide between two wave
     ports (24 x 8 x 6 hexes, Order 3, 100,338 dofs, 8 frequencies
     8.2-12.4 GHz, GMG, Tol 1e-8, port EigenTol 1e-12) on the GPU; checks
     the device solver ran every column (no direct re-solve) on the element
     fine level with the ports' gradient deflation and quadrant phase
     reference, every relres, the host residual of every column against
     scipy's A(omega) = K + i omega C - omega^2 M + i Re kn Mwp and
     b = i omega rhs1 + rhs2, and S and Re kn against the analytic TE10
     line, the port-2 Power flux (surface-F.csv) against |S21|^2 (1e-3,
     unit incident power) and the ParaView output at two of its
     frequencies (every field at every mesh node); prints the timers, the
     FGMRES iterations, the peak memory and the element fine level's apply
     (its device time at this shape, its bound and its calls in the run);
 15. wave-port adaptive path: the guide at 24 x 8 x 6 (100,338 dofs; its
     phase 14's depth) swept in 0.1 GHz steps (43 frequencies; 85 at 0.05
     GHz before the script needed the time), AdaptiveTol 1e-6,
     AdaptiveMemory 2; checks every greedy
     HDM solve ran on the device solver (no direct re-solve), the loop
     stopped by AdaptiveMemory, every HDM relres and host residual, the
     PROM's S against phase 14's at its 8 frequencies (1e-5) and the PROM
     field against a fresh HDM solve at 3 frequencies (1e-4 relative);
 16. frequency-dependent boundaries: (a) the guide shorted by a copper
     Conductivity wall at phase 14's depth, 4 frequencies, on the GPU
     (device solver with the conductivity0 term; relres, host residuals,
     1 - |S11| within 1% of the analytic TE10 short's 1 - |Gamma|);
     (b) the guide ended by a second-order Absorbing boundary at 9 x 4 x 3,
     Order 2, uniform (GMG, 8 frequencies) and adaptive (0.3 GHz steps,
     the slow-A2 path, sparse-direct HDM solves) on the GPU and on the
     CPU: port-S.csv GPU against CPU within 1e-8, adaptive against uniform
     within 5e-6;
 17. wave ports, card against host: the guide at 9 x 4 x 3, Order 2 (GMG)
     on the GPU and on the CPU; port-S.csv and domain-E.csv within 1e-8;
 18. damped eigenmode: palace_torch.run on the copper-walled WR-90
     cavity (22.86 x 10.16 x 30 mm, Impedance Rs 0.02369 Ohm on all six
     faces, 6 x 3 x 8 hexes, Order 3, 13,335 dofs, 2 modes near 8 GHz, Tol
     1e-8) on the GPU; checks the quadratic JD path with its strong-damping
     seed, TE101's Re f (1e-6) and Q (1e-4) against the analytic cavity and
     wall-loss Q_c (palace_torch/cases.py:te10l_qc), every backward error,
     an independent host residual of (K + lam C + lam^2 M) x, and the
     written tables;
 19. nonlinear eigenmode: the WR-90 guide shorted at x = L and opened
     through wave port 1 at x = 0 (18 x 4 x 3 hexes, Order 3, 20,055 dofs, 2
     modes near 9 GHz, Tol 1e-8) on the GPU; checks both modes against the
     1D fixed point k cot(k L) = -i beta(Re omega) (1e-4), the true
     nonlinear backward error with A2 at each pair's Re omega (1e-6), the
     port mode's gradient deflation and quadrant phase reference;
 20. AMR on tets with the device solvers (Linear Type GMG): the 1 x 0.8 x
     0.6 cm PEC box cavity (box_tet 6^3, Order 2, MaxIts 1; 2 until the
     script needed the time), its lowest mode's (TE110) error
     shrinking every pass (below 0.7 x the first pass's), every pass on
     block Lanczos with the element fine level, the adapted meshes (and,
     from a third pass on, the iteration archive) written; and the TEM box between two lumped ports
     (box_tet 6^3, Order 2, MaxIts 1), every pass's column at Tol on the
     device with no direct re-solve, iteration1/port-S.csv and the final
     tables written; prints each pass's dofs, setup and solve time;
 21. eigen branches, card against host: the cavity at 4 x 2 x 5, Order 2,
     the shorted guide at 9 x 4 x 3, Order 2, and the box's AMR at box_tet
     3^3 with its interior nodes jittered (untied indicators), Order 1,
     MaxIts 2, on the GPU and on the CPU: eig.csv Re f within
     1e-8 and Im f within 1e-6 (relative), equal element counts per pass;
     the cavity also carries an Electric and a Power SurfaceFlux, an MA
     Dielectric, a FarField and ParaView mode output: surface-F.csv,
     surface-Q.csv, farfield-rE.csv and the VTU arrays (every field at
     every node) within 1e-8;
 22. transient path: palace_torch.run on the parallel-plate TEM line
     between two matched 377 Ohm lumped ports (20 x 10 x 10 mm, box_tet 12
     x 6 x 6, Order 2, 18,264 dofs; GeneralizedAlpha, a 30 GHz
     ModulatedGaussian of width 0.02 ns, 126 steps of 0.002 ns) on the GPU,
     with a probe and a domain energy; checks peak |V2| within 8% of peak
     |V1|, the delay between the two ports' envelope peaks within 5% of
     L / c0, the energy at MaxTime below 1e-4 of its maximum, the host
     residual of three implicit solves (1e-10), every indicator mass
     solve on the device CG, and all five tables with a row a step;
     prints the time per step of the implicit solve, the energies and the
     indicators, the timers and the run's peak memory;
 23. transient and outputs, card against host: the four schemes on the
     10 mm line, Order 2 (13 steps): GeneralizedAlpha and RungeKutta at
     5^3 (5,530 dofs), ARKODE and CVODE at 4 x 3 x 3 (1,718 dofs) and at
     the default RelTol 1e-4, AbsTol 1e-9: port-V/I, domain-E and probe
     tables within 1e-10 and error-indicators.csv within 1e-8, the other
     schemes within 5e-2 of GeneralizedAlpha on the same line; the 6^3
     line driven at 15 GHz with a Power
     SurfaceFlux and a Dielectric on port 2 (flux within 0.05 of 1 W, Q =
     1 / (p tan delta) to 1e-9, surface-F/Q.csv within 1e-8); the short
     dipole in its ABC2 box (box_tet 7^3, Order 2, 14,546 dofs, sparse
     direct): the sin theta pattern
     (0.1 and 0.15) and polarization (0.1) on the GPU, farfield-rE.csv
     within 1e-8;
 24. Floquet eigenmode: the 1 cm cube periodic in x with PEC y and z faces
     at FloquetWaveVector [2, 0, 0] /cm (box_tet 5^3, Order 3, 14,940
     dofs, 2 modes at Target 17 GHz, Tol 1e-9) on the GPU; checks the host
     shift-invert path (ARPACK, which="LR") with every indicator mass
     solve (the Floquet RT projection of k x E included) on the device CG,
     the forward pair within 1e-4 of f1 = c0 sqrt(pi^2 + k^2) / (2 pi L) =
     17.76940 GHz with |Im f| < 1e-6 f1, the backward branch (2 pi - k;
     a second solve at Target 24.5 GHz, at box_tet 4^3) within 1e-3 of
     25.34446 GHz, and E_mag / E_elec within 1e-6 of 1 per mode (the
     Floquet magnetic energy included; 0.29 off without it, printed); the
     cube at box_tet 3^3, Order 2
     on the GPU and on the CPU: frequencies within 1e-9;
 25. Bloch-phase driven sweep: the same cube at box_tet 8^3, Order 3
     (59,544 dofs), tan delta 0.01, a z current dipole at (0.3, 0.45, 0.55)
     cm, 0.9 f1, f1 and 1.1 f1, GMG Tol 1e-8, on the GPU; checks the device
     solver on every column (no direct re-solve) on the element fine level
     with the Floquet tables, every relres and the host residual against
     scipy's A(omega) with the Floquet terms, every column's reactive power
     balance Re x^H b = 2 omega^2 (E_mag - E_elec) within 1e-6 (E_mag with
     the Floquet magnetic energy; E_elec / E_mag at the resonance f1 is
     printed, not gated: the point dipole's near field adds electric
     energy), every indicator mass solve on the device CG;
     prints the element fine level's apply (its device time at this shape,
     its bound and its calls); the cube at box_tet 4^3, Order 2 with
     FloquetReferenceFrequency 15 GHz: domain-E.csv GPU against CPU within
     1e-8, and its adaptive sweep (AdaptiveTol 1e-6, 14-17 GHz in 0.1 GHz
     steps) against the uniform one within 1e-4;
 26. Floquet ports: the 1 x 1 x 2 cm cell periodic in x and y between
     Floquet port 1 (z = 2 cm, excited, TE, MaxOrder 1) and port 2 (z = 0)
     at 12 GHz (box_tet 4 x 4 x 8, Order 3, 14,544 dofs; host sparse direct
     with the Woodbury correction of the diffraction orders) on the GPU,
     three runs: (a) empty, normal incidence: |T| within 1e-4 of 1, |R| <
     1e-3, the sum of |S|^2 over the propagating orders within 1e-4 of 1,
     arg T within 0.2 deg of -k0 d; (b) oblique, k_F (0.9, 0, 0) /cm with
     FloquetReferenceFrequency 12 GHz (sin theta 0.3579): |T| within 1e-3
     of 1, arg T within 0.5 deg of -k_z d; (c) an eps_r 4 slab over 0.75
     <= z <= 1.25 cm: |T|^2 within 2e-3 of the Airy value 0.83794, |R|^2 +
     |T|^2 within 1e-4 of 1; the empty cell at box_tet 3 x 3 x 6, Order 2
     on the GPU and on the CPU: port-floquet-S.csv within 1e-8;
 27. 2D meshes on the device solvers: the matched parallel-plate line (20
     x 2 mm, 140 x 14 cells of two triangles, Order 3, 41,622 dofs) between
     two lumped ports of R = eta0 d / Lc (unit depth) at 4, 8, 12 and 16
     GHz, GMG Tol 1e-8, on the GPU: the device solver on every column with
     the element fine level (the structured one refuses 2D meshes), every
     relres and host residual, |S11| and ||S21| - 1| below 1e-6, arg S21
     within 1e-6 rad of -k0 L, E_mag 0, every indicator mass solve on the
     device CG; prints the element fine level's apply (device time, bound,
     calls); the PEC WR-90 rectangle (12 x 6 cells, Order 3, 1,566 dofs,
     3 modes near 5 GHz, Tol 1e-9) on device Lanczos: the (1, 0), (2, 0)
     and (0, 1) modes within 1e-7 of the analytic ones, backward errors
     below 1e-9; both at small sizes on the GPU and on the CPU: the line's
     port-V/I and domain-E within 1e-8 (of each table's largest value),
     Re f within 1e-8;
 28. BoundaryMode on native 2D meshes: the PEC WR-90 cross-section (24 x
     12 cells, Order 3, 8,857 ND + H1 dofs) at 10 GHz on the GPU (host
     splu and ARPACK of the mode pencil, indicators' mass solves on the
     device CG): TE10's n_eff within 1e-7 of sqrt(1 - (c0 / (2 a f))^2)
     and the second mode evanescent; the parallel-plate TEM cross-section
     (10 x 2 mm, eps_r 2.25): n_eff = 1.5 and Z_PV = eta0 d / (w sqrt(eps_r))
     within 1e-8; the open, lossy cross-section (an Ls sheet, a first-order
     Absorbing wall, tan delta 0.01, an interface layer) at 6 x 3, Order 2
     on the GPU and on the CPU: mode-kn, |mode-V|, mode-Z, domain-E,
     surface-Q and error-indicators within 1e-8;
 29. BoundaryMode on a 3D mesh's port face: the x = 0 face of the box_tet
     WR-90 guide (2 x 24 x 12 cells, Order 3; the submesh extraction, the
     material rotation and the other wave port relabelled PEC) at 10 GHz
     on the GPU: TE10's n_eff within 1e-7 of the analytic value and within
     1e-8 of phase 28's; and the matched 2D line (20 mm, 40 x 4 cells,
     Order 2) in the time domain (GeneralizedAlpha, phase 22's pulse and
     steps): peak |V2| within 8% of peak |V1| and the envelope delay
     within 5% of L / c0;
 30. dof-sharded solves on SHARDED_RANKS = 2 ranks that share the card
     (gloo; `python3 chip_smoke.py --rank RANK WORLD DIR`, started by the
     script, a file store in DIR), through palace_torch.run: the driven
     slice of phase 4 on the sharded FGMRES + p-MG (ELL fine level; every
     column's relres <= Tol, the columns and domain-E.csv within 10 x Tol
     of phase 4's), the rings electrostatic case of phase 12 on the
     sharded CG (C within 1e-10 of phase 12's) and the eigen cavity at
     SHARDED_EIGEN_N^3, Order 3, on the sharded inner solver (Re f within
     1e-8 of a single-rank run); each part's backend, n_shards, interface
     size and largest interior block, wall time, peak memory and
     collectives by rank, 0 structured-kernel launches; then the qdata
     rows: nd_operator curl + mass on 10^3 hexes at Order 2 and 3, qdata
     against element mode on the card (1e-12), the CUDA-event medians,
     device times and bytes bounds of both.
Neither structured-apply kernel runs on phases 10-30 (element-mode
operators and the element fine level, plain torch; the transient step is
a host splu, the Floquet eigensolve ARPACK, the Floquet-port solves
sparse direct and the mode pencils host splu and ARPACK); the kernel
record counts their launches there (0).
Peak device memory is each run's own: its peak above what was allocated
when it started (`_memory_mark`).
Phases 1-3 and then 22 run alone; after them the phases run in three
processes on the one card: phases 4-9, 24 and 27 in this one, phases
14-16, 21 and 26 and phases 10-13, 17-20, 23, 25, 28 and 29 in two more
(`python3 chip_smoke.py --phases GROUP DIR`, which the script starts
itself and stops with it), so that
their lines interleave and their times include the other processes'
share of the card and of the host; each process counts its own kernel
launches.  Phase 30 runs last, alone on the card.
The line before the last is the kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import cmath
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
                (3, (8, 8, 8)), (3, (10, 10, 10)), (3, (12, 12, 12)),
                (3, (16, 16, 16))]
BATCH = 16  # B = 2F, F = 8 columns
#: Uniform driven phase depth (cut from 16^3 so that the adaptive phases
#: fit the time limit, and from 12^3 so that the damped, nonlinear and AMR
#: eigen phases do) and the dof counts at p = 3.
DRIVEN_N = 10
#: Eigenmode phase depth (cut from 12^3 so that the wave-port phases fit
#: the time limit, and from 10^3 for phases 18-21).
EIGEN_N = 8
P3_DOFS = {8: 45000, 10: 86490, 12: 147852, 16: 345744}
#: The main-path shape of each kernel: the driven path runs the first
#: kernel at DRIVEN_N^3, the eigenmode path the second at EIGEN_N^3.  Both
#: kernels are timed at 8^3, 10^3, 12^3 and 16^3.
DRIVEN_SHAPE, EIGEN_SHAPE = (DRIVEN_N,) * 3, (EIGEN_N,) * 3
TIMED_SHAPES = ((16, 16, 16), (12, 12, 12), (10, 10, 10), (8, 8, 8))
MAIN_P = 3
#: The adaptive path (its depth cut from 12^3 so that the wave-port phases
#: fit the time limit): one complex column per greedy HDM solve, so the
#: first kernel runs at B = 2 on the ADAPTIVE_N^3 lattice.
ADAPTIVE_N = 10
ADAPTIVE_SHAPE, ADAPTIVE_BATCH = (ADAPTIVE_N,) * 3, 2
TOL = {"float64": 1e-12, "float32": 1e-5}  # max abs err / max |y|
#: NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, and float64 FLOP/s on
#: the tensor cores (DMMA; 34 TFLOP/s on the FMA pipes) and float32 FLOP/s
#: outside them.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
C0 = 299792458.0  # m/s
CAVITY_L, CAVITY_EPS = 24e-3, 2.0  # palace_torch/cases.py
EPS0 = 8.8541878188e-12  # F/m
#: The static phases' rings cases: cell size (um) and order, and the CG cap
#: of the magnetostatic case (the curl-curl system needs more iterations
#: than palace_tpu's default cap of 1000 at this size).
RINGS_H, RINGS_ORDER, RINGS_MAG_MAX_ITS = 0.5, 2, 5000
#: ND dofs of the magnetostatic mesh (its PEC ring sheets cracked: 176
#: duplicated nodes) and H1 dofs of the electrostatic one (uncracked; its ND
#: indicator space has 1,298,844 dofs).
RINGS_DOFS = {"Magnetostatic": 1301308, "Electrostatic": 439597}
#: palace_tpu's rings electrostatic result at h = 0.5, Order 2, Tol 1e-10
#: (CG 959 and 957 iterations), computed on the CPU by
#:   d=$(mktemp -d); python -c "from palace_torch.cases import \
#:   write_rings_case as w; print(w('$d', 0.5, 2, problem='Electrostatic', \
#:   tol=1e-10, max_its=3000, device='CPU'))"
#: then, with "Device" removed from $d/case.json,
#:   JAX_PLATFORMS=cpu PALACE_TPU_MULTICHIP=0 python -m palace_tpu \
#:   $d/case.json
#: (the result's C in farads; Norm from its error-indicators.csv).
RINGS_ES_TPU_C = [[5.181174572026425e-16, -2.3796437526088713e-16],
                  [-2.3796437526088713e-16, 1.7534384774114701e-15]]
RINGS_ES_TPU_NORM = 1.906768991038e-01
#: The wave-port phases' WR-90 guide (palace_torch/cases.py): hexes along
#: the guide, its width and its height, the order, and its ND dofs (phases
#: 14-16a; cut from 36 cells along the guide, 150,054 dofs, so that the
#: script fits its time limit: on the CPU, with the 4 x 3, Order 3
#: cross-section, the S of 24 and 36 cells differ by 1.7e-6); the small
#: guide of phases 16b and 17 (hexes and order).
GUIDE_N, GUIDE_P, GUIDE_DOFS = (24, 8, 6), 3, 100338
SMALL_GUIDE = (9, 4, 3, 2)
#: Phase 15's guide (the depth of phase 14's, so its gate against phase
#: 14's S compares equal depths).
ADAPTIVE_GUIDE_N, ADAPTIVE_GUIDE_DOFS = GUIDE_N, GUIDE_DOFS
#: Phase 15's output grid (GHz; the greedy loop samples its own fine grid,
#: so the step sets only the online sweep and its postprocessing: 0.05
#: GHz, 85 frequencies, until the script needed the time) and the grid
#: frequencies where its PROM field is held against fresh HDM solves
#: (between samples).
ADAPTIVE_GUIDE_STEP, ADAPTIVE_GUIDE_CHECK = 0.1, (8.9, 10.6, 12.0)
GUIDE_A, GUIDE_L = 22.86e-3, 60e-3  # m
MU0, ETA0, COPPER_SIGMA = 1.25663706127e-6, 376.730313412, 5.8e7
#: Phase 14's gates against the analytic TE10 line: ||S21| - 1|, |S11|,
#: |arg S21 + beta L| (rad) and |Re kn / beta - 1|.  On the CPU both
#: packages gave at 36 x 4 x 3, Order 3: 3.3e-15 / 5.1e-15, 7.7e-9,
#: 1.25e-5 (set by the 4 x 3 cross-section's kn) and 2.0e-6, and Re kn on
#: the 8 x 6, Order 3 cross-section is within 3.2e-8
#: (scripts/waveguide_reference.py).
GUIDE_GATES = {"S21": 1e-6, "S11": 1e-6, "phase": 1e-4, "kn": 1e-6}
#: Phase 18's copper-walled WR-90 cavity (hexes along a, b, d, and the
#: order) and its ND dofs; phase 19's shorted guide (hexes along the guide,
#: a and b, and the order) and its ND dofs; phase 21's small versions.  The
#: cavity was cut from 8 x 4 x 10 (28,722 dofs) so that phases 27-29 fit:
#: TE101's Re f error 1.215e-8 -> 6.965e-8 (gate 1e-6) and Q's 2.584e-8 ->
#: 1.361e-7 (gate 1e-4); the host JD took 92.99 s of phase 18 on the H100
#: (shared) before the cut, 16.38 s on the CPU after it.
CAVITY_CU, CAVITY_CU_DOFS = (6, 3, 8, 3), 13335
GUIDE_EIGEN, GUIDE_EIGEN_DOFS = (18, 4, 3, 3), 20055
SMALL_CAVITY_CU, SMALL_GUIDE_EIGEN = (4, 2, 5, 2), (9, 4, 3, 2)
#: Phase 20's tet AMR cases (box_tet n^3, the order, and MaxIts of the
#: eigen cases: the eigen box's MaxIts cut from 2, whose third pass took
#: 35,148 dofs and a 65.02 s Lanczos, so that phases 22-23 fit; the driven
#: case's writer sets MaxIts 1) and phase 21's
#: small eigen AMR case; the eigen cases' PEC box (cm: three different
#: sides, so its lowest mode, TE110, is simple and the marking does not
#: follow round-off as in a cube's degenerate mode) and that mode (GHz).
AMR_EIGEN, AMR_DRIVEN, SMALL_AMR_EIGEN = (6, 2, 1), (6, 2), (3, 1, 2)
AMR_BOX = (1.0, 0.8, 0.6)
AMR_BOX_F = C0 / 2 * math.hypot(1 / AMR_BOX[0], 1 / AMR_BOX[1]) / 1e-2 / 1e9
#: Phase 14's driven outputs: the ParaView save frequencies (GHz, two of
#: the sweep's) and the gate of the port-2 Power flux against |S21|^2
#: (unit incident power; the flux's error falls as the fourth power of the
#: cells along the guide: on the CPU at 9 and 12 cells, Order 3, it is
#: 1.48e-2 and 4.95e-3 at 12.4 GHz).
GUIDE_SAVE, GUIDE_FLUX_GATE = (8.2, 12.4), 1e-3
#: Phase 22's TEM line (palace_torch/cases.py:write_tem_line_case): its
#: length (mm), box_tet cells along it and across its 10 x 10 mm section,
#: the order, its ND dofs, the time step and MaxTime (ns).  The cells are
#: those of tests/test_driven_transient.py:24 (1.67 mm); the line is 20 mm
#: long, not 40, because the host factorizations of the copied implicit
#: step (scipy splu, COLAMD) grow faster than the dofs: at 40 x 10 x 10 mm
#: on 24 x 8 x 8 cells (62,928 dofs) splu(M) took 82.7 s and splu(A) 44.9
#: s on the CPU, and each step's solve 0.19 s.  MaxTime covers the pulse's
#: delay of 4.5 widths (0.09 ns), the transit L / c0 (0.0667 ns) and a
#: tail of 4.5 widths.
TEM_LINE, TEM_LINE_DOFS = (20.0, 12, 6, 2), 18264
TEM_DT, TEM_MAX_T = 0.002, 0.25
#: Phase 23's lines, 10 mm long, Order 2, and the pulse of
#: tests/test_driven_transient.py:343 (a 10 GHz ModulatedGaussian of width
#: 0.08 ns, 13 steps of 0.005 ns).  GeneralizedAlpha and RungeKutta run on
#: a 5^3 line (5,530 dofs; cut from the 6^3 line of
#: tests/test_driven_transient.py:24, 9,324 dofs, so that phases 27-29 fit:
#: RungeKutta against GeneralizedAlpha 8.860e-3 -> 8.959e-3, gate 5e-2;
#: the surface line's Power flux 1.01260 -> 1.01795 W, gate 0.05), which
#: also carries the driven surface tables.  The adaptive schemes run on a
#: 4 x 3 x 3 line (1,718 dofs) at the reference's default RelTol 1e-4 and
#: AbsTol 1e-9, with GeneralizedAlpha beside them on the GPU as their
#: reference: each accepted dt change refactors A on the host, so that at
#: 6^3 one ARKODE run takes minutes, and at RelTol 1e-6 / AbsTol 1e-12
#: ARKODE takes 13,088 internal steps even at 4 x 3 x 3 (ROADMAP).
#: The dipole box is box_tet 7^3, Order 2 (14,546 dofs, sparse direct; cut
#: from tests/test_farfield_dipole.py's 8^3, 21,424 dofs, whose device
#: solves took 40 s a run on the CPU; on the CPU at 7^3 the |rE| ratios
#: are 1.6% and 7.4% from sin 45 and sin 30, at 8^3 0.8% and 0.7%).
LINE, ADAPTIVE_LINE = (10.0, 5, 5, 2), (10.0, 4, 3, 2)
#: Phases 24-26's Floquet cases (palace_torch/cases.py): the 1 cm cube
#: periodic in x with PEC y and z faces at Floquet wave number FLOQUET_K
#: (1/cm), box_tet n^3 and the order, and their ND dofs; the eigen case at
#: FLOQUET_BOX, the Bloch-phase dipole sweep at FLOQUET_DIPOLE; the small
#: GPU-against-CPU cases; and the Floquet-port cell (box_tet n x n x 2n
#: over 1 x 1 x 2 cm, periodic in x and y) at 12 GHz, its small case, and
#: the dielectric slab (z0, z1 in cm, eps_r) of run (c).
FLOQUET_K = 2.0
#: The forward pair's box, cut from box_tet 6^3 (25,506 dofs) so that
#: phases 27-29 fit: its error 1.360e-8 -> 3.988e-8 (gate 1e-4); its host
#: shift-invert took 166.19 s of phase 24 on the H100 (shared) before the
#: cut, 15.82 s on the CPU after it.
FLOQUET_BOX, FLOQUET_BOX_DOFS = (5, 3), 14940
#: The backward branch's solve, cut from FLOQUET_BOX so that phases 24-26
#: fit next to phases 4-23 (on the H100 the two host shift-invert solves
#: at 6^3 took 161.8 s of phase 24; the backward mode's error is 8.342e-6
#: at 6^3 and 8.843e-5 at 4^3, Order 3, on the CPU; gate 1e-3).
FLOQUET_BACK, FLOQUET_BACK_DOFS = (4, 3), 7788
FLOQUET_DIPOLE, FLOQUET_DIPOLE_DOFS = (8, 3), 59544
SMALL_FLOQUET_BOX, SMALL_FLOQUET_DIPOLE = (3, 2), (4, 2)
FLOQUET_CELL, FLOQUET_CELL_DOFS, SMALL_FLOQUET_CELL = (4, 3), 14544, (3, 2)
FLOQUET_CELL_F, FLOQUET_SLAB = 12.0, (0.75, 1.25, 4.0)
LINE_PULSE = dict(excitation_freq=10.0, excitation_width=0.08,
                  max_time=0.06, time_step=0.005)
DIPOLE = (7, 2)
#: Phases 27-29's 2D decks (palace_torch/cases.py, on `rect_mesh`): the
#: matched plate line (length mm, cells along it and across its 2 mm, the
#: order) and its ND dofs, swept at PLATE_FREQS (GHz); the PEC WR-90
#: rectangle's eigensolve (cells, order) and its dofs; the BoundaryMode
#: WR-90 cross-section at 10 GHz (cells, order); the TEM cross-section
#: (cells over its 10 x 2 mm, order; eps_r 2.25); the box_tet guide whose
#: x = 0 face carries phase 29's mode solve (cells along, across a and b,
#: order); the 2D transient line (length mm, cells, order); and the small
#: GPU-against-CPU cases.  Sized by the CPU rehearsal
#: (scripts/rehearse_smoke_cpu.py): the line's S and arg S21 are exact to
#: round-off at any depth (1e-11 deg at 100 and 140 cells), the
#: rectangle's modes are within 2.3e-8 of the analytic ones at 12 x 6,
#: Order 3 (3.7e-10 at 24 x 12) and TE10's kn within 2.8e-10 at 12 x 6,
#: Order 3 (4.4e-12 at 24 x 12; 2.8e-14 at 48 x 24, whose host pencil
#: solves took 22.3 and 27.3 s of phases 28 and 29 in a shared run on the
#: H100, against 1.64 and 2.26 s for the runs at 24 x 12 on the CPU).
PLATE_LINE, PLATE_LINE_DOFS = (20.0, 140, 14, 3), 41622
PLATE_FREQS = (4.0, 8.0, 12.0, 16.0)
RECT_EIGEN, RECT_EIGEN_DOFS = (12, 6, 3), 1566
BM_SECTION, TEM_SECTION, BM_FACE = (24, 12, 3), (20, 4, 2), (2, 24, 12, 3)
LINE_2D = (20.0, 40, 4, 2)
SMALL_PLATE_LINE, SMALL_RECT_EIGEN, SMALL_BM = (20.0, 10, 2, 2), (4, 2, 3), \
    (6, 3, 2)
#: After phases 3 and 22, which run alone (so that the kernels and the
#: transient step are timed alone), phases 4-9, 24 and 27 run in this
#: process and two groups of phases (`GROUPS`) in processes of their own
#: on the same card; each process counts its own kernel launches and runs
#: torch (the groups also their BLAS) on a third of the host's cores,
#: rounded up.
GROUP_FLAG, GROUP_RESULT = "--phases", "paths.json"
#: Phase 30: SHARDED_RANKS ranks started by `--rank RANK WORLD DIR` (gloo:
#: they share the card), the eigen cavity's depth there, the device of the
#: ranks' runs (a CPU rehearsal sets "CPU"), the orders of the qdata rows,
#: and the single-rank results that phases 4, 6 and 12 leave for its gates.
SHARDED_RANKS, RANK_FLAG = 2, "--rank"
#: Cut from EIGEN_N = 8 (321 s a rank, over the phase's ~180 s aim; its
#: modes 1.809e-8 from the analytic ones) to 5 (149 s, 3.010e-7): the
#: sharded eigensolve is bound by the latency of its all-reduces.
SHARDED_EIGEN_N = 5
SHARDED_DEVICE = "GPU"
QDATA_ORDERS = (2, 3)
SINGLE_RANK: dict = {}
ES_C_FILE = "electrostatic-C.json"
THREADS = -(-(os.cpu_count() or 3) // 3)
#: The whole run's time limit (s), less a margin for the last lines.
DEADLINE_S = 1150.0
T_START = time.perf_counter()


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
    greedy HDM solve, B = 2 (its real and imaginary parts), p = 3,
    ADAPTIVE_N^3, float64; the same timings as the main-path rows."""
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


def _vtu_arrays(path: str) -> dict:
    """{Name: (n, components) array} of a VTU file's float64 arrays (the
    points under "Points")."""
    import numpy as np

    with open(path) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r'<DataArray type="Float64" (?:Name="([^"]+)" )?'
                         r'NumberOfComponents="(\d)" format="ascii">\n'
                         r'(.*?)</DataArray>', text, re.S):
        vals = np.array(m.group(3).split(), float)
        out[m.group(1) or "Points"] = vals.reshape(-1, int(m.group(2)))
    return out


def _check_vtus(tag: str, directory: str, mesh, count: int, fields):
    """The collection `directory` holds `count` VTU files listed in its
    .pvd, each with the mesh's nodes and every field finite at every node;
    returns the arrays of the first."""
    import numpy as np

    name = os.path.basename(directory)
    pvd = os.path.join(directory, f"{name}.pvd")
    check(os.path.exists(pvd), f"{tag}: missing {pvd}")
    with open(pvd) as f:
        files = re.findall(r'file="([^"]+)"', f.read())
    check(len(files) == count, f"{tag}: {len(files)} ParaView files, "
                               f"expected {count}")
    first = None
    for fn in files:
        arrays = _vtu_arrays(os.path.join(directory, fn))
        check(sorted(arrays) == sorted(("Points",) + tuple(fields)),
              f"{tag}: {fn} holds {sorted(arrays)}")
        check(np.abs(arrays["Points"] - mesh.nodes).max()
              <= 1e-9 * np.abs(mesh.nodes).max(), f"{tag}: {fn} points")
        for key in fields:
            check(arrays[key].shape == (mesh.num_nodes, 3)
                  and np.isfinite(arrays[key]).all()
                  and np.abs(arrays[key]).max() > 0,
                  f"{tag}: {fn} field {key} {arrays[key].shape}")
        first = first or arrays
    return first


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


def _memory_mark() -> int:
    """Start a run's device-memory reading: resets the peak counter and
    returns the bytes still allocated (tensors of earlier phases), which a
    run's peak is read above, so that it does not depend on the phases
    before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


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
        "Meshpreprocessing", "Operatorconstruction", "Setup", "Linearsolve",
        "PROMconstruction", "Eigenvaluesolve", "Timestepping",
        "Estimatorsolve",
        "Adaptation", "Postprocessing") if k in dur)


def phase_driven(workdir: str):
    import numpy as np
    import torch

    import palace_torch
    from palace_torch.cases import write_slice_case

    t_phase = time.perf_counter()
    cfg = write_slice_case(os.path.join(workdir, "driven"), DRIVEN_N, 3,
                           tol=1e-8, max_its=200, device="GPU", verbose=0)
    base = _memory_mark()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = _counts()
    peak = torch.cuda.max_memory_allocated() - base
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
    KCM = (sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr())
    worst = max(_host_residual(sop, x, res["omegas"][i], ex, KCM)
                for (ex, i), x in res["solutions"].items())
    check(worst <= 1e-7, f"host residual {worst:.3e} > 1e-7")
    post = res["post_dir"]
    for name in ("domain-E.csv", "error-indicators.csv", "port-S.csv"):
        _table(os.path.join(post, name))
    SINGLE_RANK["driven"] = (_solution_matrix(res),
                             _table(os.path.join(post, "domain-E.csv")))
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
    cfg = write_eigen_case(os.path.join(workdir, "eigen"), EIGEN_N, 3,
                           tol=tol, device="GPU", verbose=0)
    base = _memory_mark()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    other, launches = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    prov = res["provenance"]
    check(res["num_dofs"] == P3_DOFS[EIGEN_N],
          f"unexpected dof count {res['num_dofs']}")
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
    if SHARDED_EIGEN_N == EIGEN_N:
        SINGLE_RANK["eigen"] = f
    print(f"[6 eigen] {EIGEN_N}^3 hex p=3: {res['num_dofs']} dofs, Re f "
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
    """||b - A(omega) E|| / ||b|| with scipy's CSRs (no torch): A = K +
    i omega C - omega^2 M plus the frequency-dependent boundary terms (wave
    ports i Re kn Mwp, Conductivity, second-order Absorbing) and the Floquet
    volume terms (in K, or omega^2 Fm + i omega Fc under
    FloquetReferenceFrequency), PEC rows and columns replaced by the
    identity as `system_csr` does, applied term by term; b = i omega rhs1
    plus the wave-port rhs2."""
    import numpy as np

    K, C, M = KCM
    ess = sop.ess_mask
    b = 1j * omega * sop.rhs1(ex)
    if sop.wave_ports:
        b = b + sop.waveport_rhs2(ex, omega)
    x = np.where(ess, 0.0, E)
    Ax = K @ x - (omega * omega) * (M @ x)
    if C is not None:
        Ax = Ax + 1j * omega * (C @ x)
    if sop.K_flo_mass is not None and sop.floquet_omega_ref > 0.0:
        Fm, Fc = sop.floquet_csrs()  # else in K
        Ax = Ax + (omega * omega) * (Fm @ x) + 1j * omega * (Fc @ x)
    A2 = sop.a2_csr(omega)
    if A2 is not None:
        Ax = Ax + A2 @ x
    r = b - np.where(ess, E, Ax)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _ghz(sop, omega) -> float:
    from palace_torch.config import ValueType

    return omega * sop.iodata.units.scale_factor(ValueType.FREQUENCY) / (
        2 * math.pi)


def phase_adaptive(workdir: str):
    """The adaptive PROM sweep on the ADAPTIVE_N^3, p = 3 cavity (2.0-7.0
    GHz, 51 online frequencies, across the 6.245676 GHz resonance)."""
    import numpy as np
    import torch

    import palace_torch
    from palace_torch.cases import write_adaptive_case

    t_phase = time.perf_counter()
    tol = 1e-6  # the case's AdaptiveTol
    cfg = write_adaptive_case(os.path.join(workdir, "adaptive"), ADAPTIVE_N, 3,
                              device="GPU", verbose=0)
    base = _memory_mark()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    prov, prom = res["provenance"], res["prom"]
    check(res["num_dofs"] == P3_DOFS[ADAPTIVE_N],
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
    print(f"[8 adaptive] {ADAPTIVE_N}^3 hex p=3: {res['num_dofs']} dofs, "
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


def _apply_report(op, x) -> dict:
    """Median time of one element-mode apply y = A x on the card (the
    PAOperator's gather, batched product and sorted scatter-add), its
    device time alone, and its bound: A_e, u and y moved once (bytes) over
    the memory rate, or 2 nd^2 per element over the float64 tensor-core
    rate, whichever is larger."""
    import torch

    x = torch.as_tensor(x, device=op.device)
    nbytes = 8 * (sum(t["A"].numel() for t in op._tables) + 2 * op.num_dofs)
    flops = 2.0 * sum(t["A"].numel() for t in op._tables)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float64"]
    return {"ms": _time_ms(lambda: op(x)), "device_ms": _device_ms(
        lambda: op(x)), "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "nd": int(op._tables[0]["A"].shape[1]),
        "elements": sum(int(t["A"].shape[0]) for t in op._tables)}


def _cg_idle_share(eliminated, raw, b, iters: int = 100):
    """(device busy seconds, wall seconds, idle share) of `iters` Jacobi-CG
    iterations (tol 0): the wall time of a plain run (host clock, ending in
    a synchronize), the busy time the sum of the device kernels' self time
    in a second run under torch.profiler (whose host overhead would inflate
    its own wall time); None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from palace_torch.linalg.iterative import cg
    from palace_torch.linalg.smoothers import jacobi

    M = jacobi(raw.diagonal(), eliminated.ess_mask)
    cg(eliminated, b, M=M, tol=0.0, max_its=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg(eliminated, b, M=M, tol=0.0, max_its=iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cg(eliminated, b, M=M, tol=0.0, max_its=iters)
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None and \
                "CUDA" not in str(e.device_type):
            continue
        busy += getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)) * 1e-6
    if busy <= 0:
        return None
    return busy, wall, max(0.0, 1.0 - busy / wall)


def _eliminated_csr(op, mask):
    """Host scipy CSR of the eliminated operator (rows and columns of the
    essential dofs replaced by the identity), built from the element tables
    kept on the host."""
    import numpy as np
    import scipy.sparse as sp

    K = op.assemble_csr()
    free = sp.diags((~np.asarray(mask, bool)).astype(float))
    return (free @ K @ free + sp.diags(np.asarray(mask, bool).astype(float))
            ).tocsr(), K


def _static_run(workdir: str, problem: str, tol: float, max_its: int):
    """One full-width rings run of `problem` on the GPU: returns the result,
    its wall time, peak memory and the kernels' launches during the run."""
    import torch

    import palace_torch
    from palace_torch.cases import write_rings_case

    cfg = write_rings_case(os.path.join(workdir, problem), RINGS_H,
                           RINGS_ORDER, problem=problem, tol=tol,
                           max_its=max_its, device="GPU", verbose=0)
    base = _memory_mark()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    check(launches == (0, 0), f"{problem}: structured kernels launched "
                              f"{launches} times on an element-mode path")
    check(res["num_dofs"] == RINGS_DOFS[problem],
          f"{problem}: unexpected dof count {res['num_dofs']}")
    prov = res["provenance"]
    check(prov.get("solver_path") == "device-cg", f"{problem}: {prov}")
    relres = prov.get("cg_relres", [])
    check(len(relres) == 2 and max(relres) <= tol,
          f"{problem}: CG relres {relres} (iterations "
          f"{prov.get('cg_iterations')}) above Tol {tol:.0e}")
    return res, wall, peak, sum(launches)


def _static_report(res, b, x, K_host, Keli_host):
    """Host residual of one solve, the apply's timings and bound, and the
    CG idle share (device `b` and the solution `x` of the first source)."""
    import numpy as np
    import torch

    op = res["operator"]
    bh = b.cpu().numpy()
    resid = float(np.linalg.norm(bh - Keli_host @ x) / np.linalg.norm(bh))
    rep = _apply_report(op.K, x)
    idle = _cg_idle_share(op.Keli, op.K, b)
    torch.cuda.synchronize()
    return resid, rep, idle


def _static_line(tag, res, wall, peak, resid, rep, idle, t_phase, extra,
                 rhs_applies):
    """The phase's line; a solve applies the operator once a CG iteration,
    plus `rhs_applies` times for its right-hand side (the diagonal sums the
    element diagonals: no product)."""
    prov = res["provenance"]
    its = prov["cg_iterations"]
    idle_s = ("not measured" if idle is None else
              f"{100 * idle[2]:.1f}% (busy {idle[0]:.3f} s of "
              f"{idle[1]:.3f} s, 100 iterations)")
    print(f"[{tag}] {res['num_dofs']} dofs; CG iterations {its}, relres "
          f"{', '.join(f'{r:.3e}' for r in prov['cg_relres'])}, host "
          f"residual {resid:.3e}; {extra}; element apply (E={rep['elements']},"
          f" nd={rep['nd']}, {rep['bytes'] / 1e9:.3f} GB) median "
          f"{rep['ms']:.4f} ms, device {rep['device_ms']:.4f} ms, bound "
          f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}), "
          f"{[i + rhs_applies for i in its]} applies a solve; CG "
          f"device idle {idle_s}; {_durations(res['post_dir'])}, run "
          f"{wall:.2f} s; peak device memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_magnetostatic(workdir: str):
    """The rings magnetostatic case at full width on the GPU."""
    import numpy as np

    from palace_torch.testing import rings

    t_phase = time.perf_counter()
    res, wall, peak, launches = _static_run(workdir, "Magnetostatic", 1e-8,
                                            RINGS_MAG_MAX_ITS)
    cc = res["operator"]
    Keli_host, K = _eliminated_csr(cc.K, cc.ess_mask)
    A = res["A"]
    # M before the driver's symmetrization, from the host operator.
    Mraw = np.array([[A[j] @ (K @ A[i]) for j in (1, 2)] for i in (1, 2)])
    asym = float(np.abs(Mraw - Mraw.T).max() / np.abs(Mraw).max())
    check(asym <= 1e-8, f"M not symmetric: {asym:.3e}")
    b = cc.excitation(1)
    resid, rep, idle = _static_report(res, b, A[1], K, Keli_host)
    check(resid <= 1e-7, f"magnetostatic host residual {resid:.3e} > 1e-7")
    um = 1e-6
    ana = np.array([rings.square_ribbon_self(6 * um, um, model="pec"),
                    rings.square_ribbon_self(24 * um, um, model="pec"),
                    rings.square_ribbon_mutual(6 * um, 24 * um, um)])
    M = res["M"]
    got = np.array([M[0, 0], M[1, 1], 0.5 * (M[0, 1] + M[1, 0])])
    err = np.abs(got - ana) / np.abs(ana)
    check(err.max() <= 0.10, f"M {got / 1e-12} pH against the analytic "
                             f"{ana / 1e-12} pH: {err}")
    # The same mesh's Order 1 element apply (nd = 12), timed beside it.
    from palace_torch.fem.nd import NDSpace
    from palace_torch.fem.nd_operators import nd_operator

    sp1 = NDSpace(cc.space.mesh, 1)
    K1 = nd_operator(sp1, curl_coef=cc.materials.inv_permeability,
                     device=cc.K.device)
    rep1 = _apply_report(K1, np.ones(sp1.num_dofs))
    del K1
    for name in ("terminal-M.csv", "terminal-Minv.csv", "terminal-Mm.csv",
                 "terminal-I.csv", "domain-E.csv", "error-indicators.csv"):
        _table(os.path.join(res["post_dir"], name))
    _static_line("10 magnetostatic", res, wall, peak, resid, rep, idle,
                 t_phase, f"M_aa/M_bb/M_ab {got[0] / 1e-12:.6f}/"
                 f"{got[1] / 1e-12:.6f}/{got[2] / 1e-12:.6f} pH (analytic "
                 f"{err[0] * 100:.2f}/{err[1] * 100:.2f}/{err[2] * 100:.2f}% "
                 f"off), asymmetry {asym:.3e}; Order 1 apply on the same "
                 f"mesh (nd={rep1['nd']}, {rep1['bytes'] / 1e9:.3f} GB) "
                 f"median {rep1['ms']:.4f} ms, device "
                 f"{rep1['device_ms']:.4f} ms, bound {rep1['bound_ms']:.4f} "
                 f"ms ({rep1['bound_by']})", rhs_applies=0)
    return launches


def _sheet_case(directory: str, device: str) -> str:
    """The current sheet of tests/test_drivers_e2e.py:49."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet

    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_tet(2, 2, 2, sheet_j=1),
                     os.path.join(directory, "box.msh"))
    cfg = {"Problem": {"Type": "Magnetostatic", "Verbose": 0,
                       "Output": "out"},
           "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
           "Domains": {"Materials": [{"Attributes": [1],
                                      "Permeability": 1.0}]},
           "Boundaries": {"PEC": {"Attributes": [1, 2, 3, 4]},
                          "SurfaceCurrent": [{"Index": 1, "Attributes": [7],
                                              "Direction": [1.0, 0.0, 0.0]}]},
           "Solver": {"Order": 1, "Device": device,
                      "Magnetostatic": {"Save": 0},
                      "Linear": {"Tol": 1e-12, "MaxIts": 2000}}}
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_magnetostatic_reference(workdir: str):
    """The rings case at h = 1.0, Order 1 against palace_tpu's solved M
    (RINGS_VALIDATION.json), and the current sheet, GPU against CPU."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import write_rings_case

    t0 = time.perf_counter()
    with open("RINGS_VALIDATION.json") as f:
        solved = json.load(f)["solved"]
    cfg = write_rings_case(os.path.join(workdir, "rings_h1"), 1.0, 1,
                           tol=1e-8, device="GPU", verbose=0)
    res = palace_torch.run(cfg)
    M = res["M"] / 1e-12
    got = {"M_aa_pH": M[0, 0], "M_bb_pH": M[1, 1],
           "M_ab_pH": 0.5 * (M[0, 1] + M[1, 0])}
    rel = {k: abs(got[k] - solved[k]) / abs(solved[k]) for k in got}
    check(max(rel.values()) <= 1e-6, f"rings h=1 M {got} pH against "
                                     f"RINGS_VALIDATION.json {solved}")
    tabs = {}
    for device in ("GPU", "CPU"):
        r = palace_torch.run(_sheet_case(os.path.join(workdir,
                                                      f"sheet_{device}"),
                                         device))
        tabs[device] = _table(os.path.join(r["post_dir"], "terminal-M.csv"))
    sheet = _rel_diff(tabs["GPU"], tabs["CPU"])
    check(sheet <= 1e-10, f"current sheet terminal-M.csv GPU vs CPU {sheet}")
    L = tabs["GPU"][0, 1]
    check(abs(L - 1.25663706127e-6 * 0.25e-3) <= 1e-8 * L,
          f"current sheet L {L} H")
    print(f"[11 magnetostatic reference] rings h=1 p=1 on the GPU: CG "
          f"{res['iterations']} iterations, M "
          f"{', '.join(f'{k} {v:.12f}' for k, v in got.items())} pH, max "
          f"relative difference from RINGS_VALIDATION.json "
          f"{max(rel.values()):.3e}; current sheet terminal-M.csv GPU vs CPU "
          f"{sheet:.3e}; phase {time.perf_counter() - t0:.1f} s", flush=True)


def phase_electrostatic(workdir: str):
    """The rings electrostatic case at full width on the GPU."""
    import numpy as np

    t_phase = time.perf_counter()
    res, wall, peak, launches = _static_run(workdir, "Electrostatic", 1e-10,
                                            3000)
    lap = res["operator"]
    Keli_host, K = _eliminated_csr(lap.K, lap.ess_mask)
    V = res["V"]
    Craw = np.array([[V[j] @ (K @ V[i]) for j in (1, 2)] for i in (1, 2)])
    asym = float(np.abs(Craw - Craw.T).max() / np.abs(Craw).max())
    check(asym <= 1e-8, f"C not symmetric: {asym:.3e}")
    C = res["C"]
    check(np.linalg.eigvalsh(C).min() > 0, f"C not positive definite: {C}")
    check(C[0, 1] < 0, f"C12 = {C[0, 1]} is not negative")
    ref = np.array(RINGS_ES_TPU_C)
    cerr = float((np.abs(C - ref) / np.abs(ref)).max())
    check(cerr <= 1e-8, f"C {C.tolist()} against palace_tpu's {ref.tolist()}"
                        f": {cerr:.3e}")
    norm = float(_table(os.path.join(res["post_dir"],
                                     "error-indicators.csv"))[0, 0])
    nerr = abs(norm - RINGS_ES_TPU_NORM) / RINGS_ES_TPU_NORM
    check(nerr <= 1e-6, f"error-indicator Norm {norm} against palace_tpu's "
                        f"{RINGS_ES_TPU_NORM}")
    _, b = lap.excitation(1)
    resid, rep, idle = _static_report(res, b, V[1], K, Keli_host)
    check(resid <= 1e-8, f"electrostatic host residual {resid:.3e} > 1e-8")
    for name in ("terminal-C.csv", "terminal-Cinv.csv", "terminal-Cm.csv",
                 "terminal-V.csv", "domain-E.csv"):
        _table(os.path.join(res["post_dir"], name))
    SINGLE_RANK["C"] = C.tolist()
    with open(os.path.join(workdir, ES_C_FILE), "w") as f:
        json.dump(SINGLE_RANK["C"], f)  # for phase 30 in the first process
    _static_line("12 electrostatic", res, wall, peak, resid, rep, idle,
                 t_phase, f"C11/C12/C22 {C[0, 0]:.12e}/{C[0, 1]:.12e}/"
                 f"{C[1, 1]:.12e} F (palace_tpu's within {cerr:.3e}), "
                 f"asymmetry {asym:.3e}, error-indicator Norm {norm:.12e} "
                 f"(within {nerr:.3e})", rhs_applies=1)
    return launches


def _plate_case(directory: str, device: str, terminal: int = 6,
                tets: bool = False, amr: bool = False) -> str:
    """The parallel plate of tests/test_drivers_e2e.py:25 (hexes, ground
    z = 0, terminal z = top) or of tests/test_amr.py:42 (tets, terminal
    z = 0 with `terminal` 5, ground z = top, AMR MaxIts 2); `terminal` 1
    puts terminal and ground on adjacent faces."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_hex, box_tet

    os.makedirs(directory, exist_ok=True)
    mesh = (box_tet(3, 3, 3, lx=2.0, ly=3.0, lz=0.5) if tets else
            box_hex(2, 2, 2, lx=2.0, ly=3.0, lz=0.5))
    gmsh_write.write(mesh, os.path.join(directory, "box.msh"))
    model = {"Mesh": "box.msh", "L0": 1.0e-3}
    if amr:
        model["Refinement"] = {"Tol": 1e-12, "MaxIts": 2,
                               "UpdateFraction": 0.5, "SaveAdaptMesh": True}
    ground = 6 if tets else 5  # the z faces: 5 at z = 0, 6 at the top
    cfg = {"Problem": {"Type": "Electrostatic", "Verbose": 0,
                       "Output": "out"},
           "Model": model,
           "Domains": {"Materials": [{"Attributes": [1],
                                      "Permittivity": 4.0}]},
           "Boundaries": {"Ground": {"Attributes": [ground]},
                          "Terminal": [{"Index": 1,
                                        "Attributes": [terminal]}]},
           "Solver": {"Order": 2, "Device": device,
                      "Electrostatic": {"Save": 0},
                      "Linear": {"Tol": 1e-12, "MaxIts": 2000}}}
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_electrostatic_parity(workdir: str):
    import palace_torch
    from palace_torch.cases import write_rings_case
    from palace_torch.mesh.mesh import load_mesh

    t0 = time.perf_counter()
    tabs = {}
    for device in ("GPU", "CPU"):
        cfg = write_rings_case(os.path.join(workdir, f"es_h1_{device}"), 1.0,
                               1, problem="Electrostatic", tol=1e-10,
                               max_its=3000, device=device, verbose=0)
        res = palace_torch.run(cfg)
        tabs[device] = _table(os.path.join(res["post_dir"], "terminal-C.csv"))
    rings_rel = _rel_diff(tabs["GPU"], tabs["CPU"])
    check(rings_rel <= 1e-9, f"rings h=1 terminal-C.csv GPU vs CPU "
                             f"{rings_rel:.3e}")
    res = palace_torch.run(_plate_case(os.path.join(workdir, "plate"), "GPU"))
    C_expect = 4.0 * EPS0 * (2e-3 * 3e-3) / 0.5e-3
    plate = abs(res["C"][0, 0] - C_expect) / C_expect
    check(plate <= 1e-9, f"parallel plate C {res['C'][0, 0]} against "
                         f"{C_expect}")
    loops = {}
    for kind, terminal in (("plate", 5), ("edge", 1)):
        out = {}
        for device in ("GPU", "CPU"):
            d = os.path.join(workdir, f"amr_{kind}_{device}")
            r = palace_torch.run(_plate_case(d, device, terminal, tets=True,
                                             amr=True))
            check(r["amr_iterations"] == 2, f"AMR {kind} {device}: "
                                            f"{r['amr_iterations']} passes")
            counts = [load_mesh(os.path.join(r["post_dir"],
                                             f"amr-mesh-{i}.msh")).num_elements
                      for i in (1, 2)]
            out[device] = (counts, _table(os.path.join(r["post_dir"],
                                                       "terminal-C.csv")))
        rel = _rel_diff(out["GPU"][1], out["CPU"][1])
        check(rel <= 1e-8, f"AMR {kind} terminal-C.csv GPU vs CPU {rel:.3e}")
        # The plate's field is exact on every mesh: its indicators are
        # round-off, so which elements they mark is not reproducible.
        if kind == "edge":
            check(out["GPU"][0] == out["CPU"][0],
                  f"AMR element counts GPU {out['GPU'][0]} CPU "
                  f"{out['CPU'][0]}")
        loops[kind] = (out["GPU"][0], out["CPU"][0], rel)
    print(f"[13 electrostatic parity] rings h=1 p=1 terminal-C.csv GPU vs "
          f"CPU {rings_rel:.3e}; parallel plate C {res['C'][0, 0]:.12e} F "
          f"(eps A/d within {plate:.3e}); tet AMR plate: elements GPU "
          f"{loops['plate'][0]} CPU {loops['plate'][1]}, terminal-C.csv "
          f"{loops['plate'][2]:.3e}; tet AMR singular edge: elements "
          f"{loops['edge'][0]} on both, terminal-C.csv {loops['edge'][2]:.3e};"
          f" phase {time.perf_counter() - t0:.1f} s", flush=True)


def _te10(f_ghz: float):
    """(k, beta) of the WR-90 guide's TE10 mode at f GHz, in 1/m."""
    k = 2 * math.pi * f_ghz * 1e9 / C0
    return k, math.sqrt(k * k - (math.pi / GUIDE_A) ** 2)


def _s_table_diff(a, b) -> float:
    """Max over entries of |a - b| / max(|b|, 1): the dB of |S| ~ 1 sits
    near 0, where a column-relative difference would measure round-off."""
    import numpy as np

    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


class _ElemApplies:
    """Counts the element fine level's applies (`ElemTermOperator.__call__`)
    while it is entered; the method is restored on exit."""

    def __enter__(self):
        from palace_torch.linalg import device_ksp

        self.cls, self.count = device_ksp.ElemTermOperator, 0
        self.orig = self.cls.__call__
        orig = self.orig

        def call(op, coefs, u):
            self.count += 1
            return orig(op, coefs, u)

        self.cls.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


def _elem_apply_report(sop, omegas) -> dict:
    """The element fine level (`ElemTermOperator`) at the sweep's block
    shape: y = sum_t c_t X_t u for F complex columns.  Median of single
    calls, device time (50 calls queued behind a sleeping kernel), and the
    bound: the A_e tables, the gathered u (nd values of 2F reals per
    element), the scattered products and y moved once over the memory rate,
    or 2 nd^2 2F operations per element over the float64 peak."""
    import numpy as np
    import torch

    from palace_torch.linalg.device_ksp import ElemTermOperator

    dev = torch.device("cuda:0")
    terms = sop.driven_terms(omegas)
    n, F = sop.space.num_dofs, len(omegas)
    op = ElemTermOperator(terms, n, dev)
    coefs = torch.as_tensor(np.array([[t.coef(w) for w in omegas]
                                      for t in terms]), device=dev)
    rng = np.random.default_rng(2)
    u = torch.as_tensor(rng.standard_normal((n, F))
                        + 1j * rng.standard_normal((n, F)), device=dev)
    a_bytes = sum(8 * A.numel() for _, _, A in op._entries)
    local = sum(8 * A.shape[0] * A.shape[1] * 2 * F for _, _, A in op._entries)
    nbytes = a_bytes + 2 * local + 8 * n * 2 * F
    flops = sum(2.0 * A.numel() * 2 * F for _, _, A in op._entries)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float64"]
    rep = {"ms": _time_ms(lambda: op(coefs, u)),
           "device_ms": _device_ms(lambda: op(coefs, u)),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "columns": F, "terms": len(terms),
           "elements": sum(int(A.shape[0]) for _, _, A in op._entries)}
    del op
    torch.cuda.empty_cache()
    return rep


def _guide_run(workdir: str, tag: str, n=None, dofs=None, **kw):
    """One run of the WR-90 guide (n hexes, GUIDE_N by default, Order
    GUIDE_P) on the GPU: (result, wall seconds, peak device memory, element
    fine-level applies); checks neither kernel launched."""
    import torch

    import palace_torch
    from palace_torch.cases import write_waveguide_case

    n, dofs = (GUIDE_N, GUIDE_DOFS) if n is None else (n, dofs)
    cfg = write_waveguide_case(os.path.join(workdir, tag), *n, GUIDE_P,
                               device="GPU", verbose=0, **kw)
    base = _memory_mark()
    _zero_counts()
    t0 = time.perf_counter()
    with _ElemApplies() as applies:
        res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    check(launches == (0, 0), f"{tag}: structured kernels launched "
                              f"{launches} times on the element fine level")
    check(res["num_dofs"] == dofs,
          f"{tag}: unexpected dof count {res['num_dofs']}")
    prov = res["provenance"]
    check(prov.get("fine_level") == "element",
          f"{tag}: fine level {prov.get('fine_level')}, not element")
    check(all(prov.get(f"waveport{i}_deflation") for i in res["sop"]
              .wave_ports), f"{tag}: a port mode ran without its gradient "
                            f"deflation ({prov})")
    for wp in res["sop"].wave_ports.values():
        phases = {sol.phase for sol in wp._mode_cache.values()}
        check(phases == {"quadrant"}, f"{tag}: port {wp.index} phase "
                                      f"references {phases}")
    return res, wall, torch.cuda.max_memory_allocated() - base, applies.count


def _uniform_checks(tag, res):
    """Device solver on every column (no direct re-solve), each column's
    relres and host residual; returns (max relres, max host residual)."""
    prov, info = res["provenance"], res["ksp"]
    check(prov.get("solver_path") == "device",
          f"{tag}: solver path {prov.get('solver_path')}")
    relres = info.get("col_relres", {})
    check(len(relres) == len(res["omegas"]) and max(relres.values()) <= 1e-8,
          f"{tag}: column relres {relres}")
    sop = res["sop"]
    KCM = (sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr())
    worst = max(_host_residual(sop, E, res["omegas"][i], ex, KCM)
                for (ex, i), E in res["solutions"].items())
    check(worst <= 1e-7, f"{tag}: host residual {worst:.3e} > 1e-7")
    return max(relres.values()), worst


def phase_waveport(workdir: str):
    """The WR-90 guide between two wave ports at full width on the GPU;
    returns (kernel launches, {f GHz: (S11, S21)}); `_guide_run` has
    checked that neither kernel launched."""
    t_phase = time.perf_counter()
    res, wall, peak, applies = _guide_run(
        workdir, "guide", save_freqs=GUIDE_SAVE, postprocessing={
            "SurfaceFlux": [{"Index": 1, "Attributes": [2],
                             "Type": "Power"}]})
    relres, resid = _uniform_checks("waveport", res)
    sop, meas = res["sop"], res["measurements"]
    S = {}
    worst = dict.fromkeys(("S21", "S11", "phase", "kn", "flux"), 0.0)
    for (ex, i), m in meas.items():
        f = res["freqs_ghz"][i]
        k, beta = _te10(f)
        S11, S21 = m.ports[1].S, m.ports[2].S
        worst["flux"] = max(worst["flux"], abs(m.surf_flux[1].real
                                               - abs(S21) ** 2))
        S[round(f, 9)] = (S11, S21)
        omega = res["omegas"][i]  # nondimensional, where c = 1
        kn = sop.wave_ports[1].solve_mode(omega).kn.real
        worst["S21"] = max(worst["S21"], abs(abs(S21) - 1.0))
        worst["S11"] = max(worst["S11"], abs(S11))
        worst["phase"] = max(worst["phase"], abs(cmath.phase(
            S21 * cmath.exp(1j * beta * GUIDE_L))))
        worst["kn"] = max(worst["kn"], abs(kn / omega * k / beta - 1.0))
    for key, gate in GUIDE_GATES.items():
        check(worst[key] <= gate, f"waveport: TE10 {key} error "
                                  f"{worst[key]:.3e} > {gate:.0e}")
    check(worst["flux"] <= GUIDE_FLUX_GATE, f"waveport: port-2 Power flux "
          f"against |S21|^2 {worst['flux']:.3e} > {GUIDE_FLUX_GATE:.0e}")
    for name in ("port-S.csv", "domain-E.csv", "error-indicators.csv",
                 "surface-F.csv"):
        _table(os.path.join(res["post_dir"], name))
    _check_vtus("waveport", os.path.join(res["post_dir"], "paraview",
                                         "driven"), sop.mesh,
                len(GUIDE_SAVE), ("E_real", "E_imag", "B_real", "B_imag"))
    rep = _elem_apply_report(sop, res["omegas"])
    prov = res["provenance"]
    print(f"[14 waveport] WR-90 {'x'.join(map(str, GUIDE_N))} hex p="
          f"{GUIDE_P}: {res['num_dofs']} dofs, {len(meas)} columns, FGMRES "
          f"iterations {res['ksp'].get('total_its')} total, max relres "
          f"{relres:.3e}, host residual {resid:.3e}; against the analytic "
          f"TE10 line: ||S21| - 1| {worst['S21']:.3e}, |S11| "
          f"{worst['S11']:.3e}, arg S21 + beta L {worst['phase']:.3e} rad, "
          f"Re kn / beta - 1 {worst['kn']:.3e}; port-2 Power flux against "
          f"|S21|^2 {worst['flux']:.3e}, ParaView at {len(GUIDE_SAVE)} "
          f"frequencies; port mode solves "
          f"{prov.get('waveport_mode_solves')} in "
          f"{prov.get('waveport_mode_seconds', 0.0):.2f} s (host); element "
          f"fine level (E={rep['elements']}, {rep['terms']} terms, F="
          f"{rep['columns']}, {rep['bytes'] / 1e9:.3f} GB) median "
          f"{rep['ms']:.4f} ms, device {rep['device_ms']:.4f} ms, bound "
          f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}), {applies} applies "
          f"in the run; {_durations(res['post_dir'])}, run {wall:.2f} s; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0, S


def phase_waveport_adaptive(workdir: str, S14):
    """The guide's adaptive PROM sweep (43 frequencies) on the GPU, at
    ADAPTIVE_GUIDE_N; its S is held against phase 14's (at GUIDE_N, the
    same depth)."""
    import numpy as np

    t_phase = time.perf_counter()
    tol = 1e-6  # the case's AdaptiveTol
    res, wall, peak, applies = _guide_run(
        workdir, "guide_adaptive", n=ADAPTIVE_GUIDE_N,
        dofs=ADAPTIVE_GUIDE_DOFS, adaptive=True,
        freq_step=ADAPTIVE_GUIDE_STEP)
    prov, prom, sop = res["provenance"], res["prom"], res["sop"]
    check(prov.get("solver_path") == "prom-adaptive"
          and prov.get("prom_hdm_path") == "device"
          and not prov.get("prom_hdm_direct_fallbacks"),
          f"waveport adaptive provenance {prov}")
    check(prom.stopped_by == {1: "memory"},
          f"greedy loop stopped by {prom.stopped_by}, not AdaptiveMemory")
    relres = prom.hdm_relres
    check(len(relres) == len(prom.samples) and max(relres.values()) <= 1e-8,
          f"HDM relres {relres}")
    KCM = (sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr())
    resid = max(_host_residual(sop, E, om, ex, KCM)
                for (ex, om), E in prom.hdm.items())
    check(resid <= 1e-7, f"HDM host residual {resid:.3e} > 1e-7")
    freqs = np.asarray(res["freqs_ghz"])
    sdiff = 0.0
    for f, (S11, S21) in S14.items():
        i = int(np.argmin(np.abs(freqs - f)))
        check(abs(freqs[i] - f) <= 1e-9, f"{f} GHz is not on the PROM grid")
        m = res["measurements"][(1, i)]
        sdiff = max(sdiff, abs(m.ports[1].S - S11), abs(m.ports[2].S - S21))
    check(sdiff <= 1e-5, f"PROM S against phase 14's: {sdiff:.3e} > 1e-5")
    solver, errs = prom.solver, []
    for f in ADAPTIVE_GUIDE_CHECK:
        i = int(np.argmin(np.abs(freqs - f)))
        check(abs(freqs[i] - f) <= 1e-9, f"{f} GHz is not on the PROM grid")
        om = res["omegas"][i]
        b = 1j * om * sop.rhs1(1) + sop.waveport_rhs2(1, om)
        X, info = solver.solve(b[:, None], omega_idx=[solver.add_omega(om)])
        check(float(info["relres"][0]) <= 1e-8,
              f"fresh HDM solve at {f} GHz: relres {info['relres']}")
        E = res["solutions"][(1, i)]
        errs.append(float(np.linalg.norm(E - X[:, 0])
                          / np.linalg.norm(X[:, 0])))
    check(max(errs) <= 100 * tol, f"PROM against HDM at "
                                  f"{ADAPTIVE_GUIDE_CHECK} GHz: {errs} > "
                                  f"{100 * tol:.0e}")
    for name in ("port-S.csv", "domain-E.csv", "error-indicators.csv"):
        _table(os.path.join(res["post_dir"], name))
    samples = ", ".join(f"{_ghz(sop, om):.6f} ({err:.2e})"
                        for _, om, err in prom.samples)
    print(f"[15 waveport adaptive] WR-90 "
          f"{'x'.join(map(str, ADAPTIVE_GUIDE_N))} hex p={GUIDE_P}: "
          f"{res['num_dofs']} "
          f"dofs, {len(freqs)} frequencies, {len(prom.samples)} HDM samples, "
          f"f* GHz (PROM error) {samples}; stopped by AdaptiveMemory; basis "
          f"{prom.basis_size}; HDM FGMRES iterations "
          f"{sum(prom.hdm_iterations.values())}, max relres "
          f"{max(relres.values()):.3e}, host residual {resid:.3e}; S against "
          f"phase 14's {'x'.join(map(str, GUIDE_N))} guide {sdiff:.3e}; "
          f"PROM vs fresh HDM at "
          f"{'/'.join(map(str, ADAPTIVE_GUIDE_CHECK))} GHz "
          f"{', '.join(f'{e:.3e}' for e in errs)}; port mode solves "
          f"{prov.get('waveport_mode_solves')} in "
          f"{prov.get('waveport_mode_seconds', 0.0):.2f} s (host); "
          f"{applies} element applies; {_durations(res['post_dir'])}, run "
          f"{wall:.2f} s; peak device memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def phase_boundaries(workdir: str):
    """(a) The copper-shorted guide at full width on the GPU; (b) the guide
    ended by a second-order absorbing boundary at a small depth, uniform
    and adaptive, GPU against CPU."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import write_waveguide_case

    t_phase = time.perf_counter()
    res, wall, peak, applies = _guide_run(workdir, "short",
                                          termination="conductivity",
                                          freq_step=1.4)
    names = [t.name for t in res["sop"].driven_terms()]
    check("conductivity0" in names, f"short: device terms {names}")
    relres, resid = _uniform_checks("short", res)
    worst = 0.0
    for (ex, i), m in res["measurements"].items():
        f = res["freqs_ghz"][i]
        k, beta = _te10(f)
        omega = 2 * math.pi * f * 1e9
        Zs = (1 + 1j) * math.sqrt(omega * MU0 / (2 * COPPER_SIGMA))
        Zte = ETA0 * k / beta
        gamma = (Zs - Zte) / (Zs + Zte)
        worst = max(worst, abs((1 - abs(m.ports[1].S)) / (1 - abs(gamma))
                               - 1))
    check(worst <= 1e-2, f"short: 1 - |S11| against 1 - |Gamma| {worst:.3e}"
                         " > 1e-2")
    line_a = (f"(a) copper short {'x'.join(map(str, GUIDE_N))} "
              f"p={GUIDE_P}, {len(res['omegas'])} "
              f"frequencies: terms {names}, max relres {relres:.3e}, host "
              f"residual {resid:.3e}, 1 - |S11| within {worst:.3e} of the "
              f"analytic 1 - |Gamma|, {applies} element applies, "
              f"{_durations(res['post_dir'])}, run {wall:.2f} s, peak "
              f"{peak / 2 ** 30:.3f} GiB")
    out = {}
    for device in ("GPU", "CPU"):
        for adaptive in (False, True):
            r = palace_torch.run(write_waveguide_case(
                os.path.join(workdir, f"abc2_{device}_{adaptive}"),
                *SMALL_GUIDE, termination="absorbing", adaptive=adaptive,
                freq_step=0.3 if adaptive else 0.6, device=device,
                verbose=0))
            prov = r["provenance"]
            want = "direct-slow-a2" if adaptive else "device"
            got = prov.get("prom_hdm_path" if adaptive else "solver_path")
            check(got == want, f"absorbing {device} adaptive={adaptive}: "
                               f"path {got}, not {want}")
            out[(device, adaptive)] = r
    gpu_cpu = max(_s_table_diff(
        _table(os.path.join(out[("GPU", a)]["post_dir"], "port-S.csv")),
        _table(os.path.join(out[("CPU", a)]["post_dir"], "port-S.csv")))
        for a in (False, True))
    check(gpu_cpu <= 1e-8, f"absorbing port-S.csv GPU vs CPU {gpu_cpu:.3e}")
    uni, ada = out[("GPU", False)], out[("GPU", True)]
    fa = np.asarray(ada["freqs_ghz"])
    ad_un = 0.0
    for (ex, i), m in uni["measurements"].items():
        j = int(np.argmin(np.abs(fa - uni["freqs_ghz"][i])))
        ad_un = max(ad_un, abs(ada["measurements"][(ex, j)].ports[1].S
                               - m.ports[1].S))
    check(ad_un <= 5e-6, f"absorbing adaptive vs uniform S {ad_un:.3e}")
    print(f"[16 boundaries] {line_a}; (b) second-order absorbing "
          f"{'x'.join(map(str, SMALL_GUIDE[:3]))} p={SMALL_GUIDE[3]}: "
          f"port-S.csv GPU vs CPU {gpu_cpu:.3e} (uniform GMG and slow-A2 "
          f"adaptive, {len(ada['prom'].samples)} direct HDM samples), "
          f"adaptive vs uniform S {ad_un:.3e}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def phase_waveport_parity(workdir: str):
    import palace_torch
    from palace_torch.cases import write_waveguide_case

    t0 = time.perf_counter()
    tabs = {}
    for device in ("GPU", "CPU"):
        r = palace_torch.run(write_waveguide_case(
            os.path.join(workdir, f"guide_{device}"), *SMALL_GUIDE,
            device=device, verbose=0))
        check(r["provenance"].get("solver_path") == "device",
              f"guide {device}: {r['provenance']}")
        tabs[device] = [_table(os.path.join(r["post_dir"], name))
                        for name in ("port-S.csv", "domain-E.csv")]
    s = _s_table_diff(tabs["GPU"][0], tabs["CPU"][0])
    e = _rel_diff(tabs["GPU"][1], tabs["CPU"][1])
    check(s <= 1e-8 and e <= 1e-8, f"guide GPU vs CPU: port-S.csv {s:.3e}, "
                                   f"domain-E.csv {e:.3e}")
    print(f"[17 waveport parity] WR-90 {'x'.join(map(str, SMALL_GUIDE[:3]))} "
          f"p={SMALL_GUIDE[3]}: port-S.csv GPU vs CPU {s:.3e}, domain-E.csv "
          f"{e:.3e}; phase {time.perf_counter() - t0:.1f} s", flush=True)


def _gpu_run(cfg: str, tag: str):
    """One run of `cfg` on the GPU: (result, wall seconds, peak device
    memory of the run, `_memory_mark`); checks neither structured kernel
    launched."""
    import torch

    import palace_torch

    base = _memory_mark()
    _zero_counts()
    t0 = time.perf_counter()
    res = palace_torch.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    check(launches == (0, 0), f"{tag}: structured kernels launched "
                              f"{launches} times")
    return res, wall, torch.cuda.max_memory_allocated() - base


def _pencil_bkwd(sop, x, omega, a2=None) -> float:
    """Backward error of (K + A2 + lam C + lam^2 M) x, lam = i omega, on the
    free rows, relative to (||K + A2|| + |lam| ||C|| + |lam|^2 ||M||) ||x||
    (1-norms), from scipy's CSRs of the run's SpaceOperator."""
    import numpy as np

    K, C, M = sop.stiffness_csr(), sop.damping_csr(), sop.mass_csr()
    if a2 is not None:
        K = (K + a2).tocsr()
    lam = 1j * omega
    r = K @ x + lam * lam * (M @ x)
    nrm = abs(K).sum(axis=0).max() + abs(lam) ** 2 * abs(M).sum(axis=0).max()
    if C is not None:
        r = r + lam * (C @ x)
        nrm += abs(lam) * abs(C).sum(axis=0).max()
    free = ~sop.ess_mask
    return float(np.linalg.norm(r[free]) / (nrm * np.linalg.norm(x)))


def _omega(sop, f_ghz: complex) -> complex:
    from palace_torch.config import ValueType

    return 2 * math.pi * complex(f_ghz) / sop.iodata.units.scale_factor(
        ValueType.FREQUENCY)


def phase_eigen_damped(workdir: str):
    """The copper-walled WR-90 cavity: the damped quadratic branch (host JD
    with the strong-damping seed) at full width on the GPU."""
    import numpy as np

    from palace_torch.cases import (CAVITY_D, COPPER_RS, WR90_A, WR90_B,
                                    te10l_qc, write_cavity_case)

    t_phase = time.perf_counter()
    q_c, f101 = te10l_qc(WR90_A * 1e-3, WR90_B * 1e-3, CAVITY_D * 1e-3,
                         COPPER_RS)
    f101 /= 1e9
    res, wall, peak = _gpu_run(write_cavity_case(
        os.path.join(workdir, "cavity_cu"), *CAVITY_CU, device="GPU",
        verbose=0), "eigen-damped")
    prov, sop = res["provenance"], res["sop"]
    tol = sop.iodata.solver.eigenmode.tol
    check(res["num_dofs"] == CAVITY_CU_DOFS,
          f"eigen-damped: unexpected dof count {res['num_dofs']}")
    check(prov.get("eigen_path") == "quadratic-jd"
          and prov.get("jd_strong_seed") is True,
          f"eigen-damped: path {prov.get('eigen_path')}, strong seed "
          f"{prov.get('jd_strong_seed')}")
    f = np.asarray(res["frequencies_ghz"])
    Q = abs(f[0]) / (2 * f[0].imag)
    ferr, qerr = abs(f[0].real / f101 - 1), abs(Q / q_c - 1)
    check(ferr <= 1e-6, f"eigen-damped: TE101 Re f {f[0].real:.9f} GHz vs "
                        f"{f101:.9f}: {ferr:.3e} > 1e-6")
    check(qerr <= 1e-4, f"eigen-damped: Q {Q:.6f} vs Q_c {q_c:.6f}: "
                        f"{qerr:.3e} > 1e-4")
    bkwd = np.asarray(res["backward_errors"])
    check(bkwd.max() <= tol, f"eigen-damped: backward errors {bkwd}")
    resid = max(_pencil_bkwd(sop, res["modes"][:, i], _omega(sop, f[i]))
                for i in range(len(f)))
    check(resid <= 10 * tol, f"eigen-damped: host residual {resid:.3e} > "
                             f"{10 * tol:.0e}")
    for name in ("eig.csv", "domain-E.csv"):
        _table(os.path.join(res["post_dir"], name))
    shape = "x".join(map(str, CAVITY_CU[:3]))
    print(f"[18 eigen damped] copper WR-90 cavity {shape} hex "
          f"p={CAVITY_CU[3]}: {res['num_dofs']} dofs, "
          f"f {', '.join(f'{v:.9f}' for v in f)} GHz; TE101 Re f error "
          f"{ferr:.3e} (analytic {f101:.9f}), Q {Q:.6f} against Q_c "
          f"{q_c:.6f} ({qerr:.3e}); max backward error {bkwd.max():.3e}, "
          f"host residual {resid:.3e}; path {prov.get('eigen_path')}, JD "
          f"attempts {prov.get('jd_attempts')}, strong seed "
          f"{prov.get('jd_strong_seed')}, div-free {prov.get('divfree')}; "
          f"{_durations(res['post_dir'])}, run {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def phase_eigen_nonlinear(workdir: str):
    """The WR-90 guide shorted at x = L and opened through wave port 1 at
    x = 0: the nonlinear branch (Newton-interpolated A2, fixed-point
    refinement) at full width on the GPU, against the 1D fixed point."""
    import numpy as np

    from palace_torch.cases import shorted_guide_mode, write_guide_eigen_case

    t_phase = time.perf_counter()
    roots = [shorted_guide_mode(g)[0] for g in (9.4, 11.4)]
    res, wall, peak = _gpu_run(write_guide_eigen_case(
        os.path.join(workdir, "guide_eigen"), *GUIDE_EIGEN, device="GPU",
        verbose=0), "eigen-nonlinear")
    prov, sop = res["provenance"], res["sop"]
    check(res["num_dofs"] == GUIDE_EIGEN_DOFS,
          f"eigen-nonlinear: unexpected dof count {res['num_dofs']}")
    check(prov.get("waveport1_deflation"), "eigen-nonlinear: the port mode "
                                           f"ran without its deflation {prov}")
    phases = {sol.phase for sol in sop.wave_ports[1]._mode_cache.values()}
    check(phases == {"quadrant"}, f"eigen-nonlinear: phase references "
                                  f"{phases}")
    f = np.asarray(res["frequencies_ghz"])
    check(len(f) == 2, f"eigen-nonlinear: {len(f)} modes")
    ferr = max(abs(x - r) / abs(r) for x, r in zip(f, roots))
    check(ferr <= 1e-4, f"eigen-nonlinear: modes {f} vs the 1D fixed point "
                        f"{roots}: {ferr:.3e} > 1e-4")
    bkwd = 0.0
    for i in range(len(f)):
        om = _omega(sop, f[i])
        bkwd = max(bkwd, _pencil_bkwd(sop, res["modes"][:, i], om,
                                      sop.waveport_a2_csr(om.real)))
    check(bkwd <= 1e-6, f"eigen-nonlinear: nonlinear backward error "
                        f"{bkwd:.3e} > 1e-6")
    for name in ("eig.csv", "domain-E.csv"):
        _table(os.path.join(res["post_dir"], name))
    print(f"[19 eigen nonlinear] shorted WR-90 guide "
          f"{'x'.join(map(str, GUIDE_EIGEN[:3]))} hex p={GUIDE_EIGEN[3]} "
          f"with wave port 1: {res['num_dofs']} dofs, f "
          f"{', '.join(f'{v:.9f}' for v in f)} GHz against the 1D fixed "
          f"point {', '.join(f'{v:.9f}' for v in roots)} (max |df| / |f| "
          f"{ferr:.3e}); nonlinear backward error {bkwd:.3e}; path "
          f"{prov.get('eigen_path')}, harvest rounds "
          f"{prov.get('nonlinear_harvest_rounds')}, fixed-point iterations "
          f"{prov.get('nonlinear_refine_iterations')}; port mode solves "
          f"{prov.get('waveport_mode_solves')} in "
          f"{prov.get('waveport_mode_seconds', 0.0):.2f} s (host); "
          f"{_durations(res['post_dir'])}, run {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def _passes(prov) -> str:
    return "; ".join(
        f"pass {i}: {p['elements']} elements, {p['dofs']} dofs, setup "
        f"{p['setup_s']:.2f} s, solve {p['solve_s']:.2f} s"
        for i, p in enumerate(prov["amr_passes"]))


def phase_amr(workdir: str):
    """Driven and eigenmode AMR on tets, every pass on the device solvers
    (Linear Type GMG)."""
    from palace_torch.cases import write_amr_driven_case, write_amr_eigen_case

    t_phase = time.perf_counter()
    n, p, its = AMR_EIGEN
    res, wall, _ = _gpu_run(write_amr_eigen_case(
        os.path.join(workdir, "amr_eigen"), n, p, size=AMR_BOX, max_its=its,
        device="GPU", verbose=0), "amr-eigen-tet")
    passes = res["provenance"]["amr_passes"]
    check(len(passes) == its + 1, f"amr-eigen-tet: {len(passes)} passes")
    check(all(q["eigen_path"] == "device-lanczos"
              and q["fine_level"] == "element" for q in passes),
          f"amr-eigen-tet: paths {passes}")
    err = [abs(q["re_f_ghz"][0] - AMR_BOX_F) for q in passes]
    check(all(b < a for a, b in zip(err, err[1:]))
          and err[-1] < 0.7 * err[0],
          f"amr-eigen-tet: errors against {AMR_BOX_F} GHz per pass {err}")
    post = res["post_dir"]
    # The eigen driver writes its tables after the loop, so a pass's
    # archive holds only the adapted meshes of the passes before it: the
    # first archive is iteration2.
    for name in [f"amr-mesh-{i}.msh" for i in range(1, its + 1)] + [
            f"iteration{i}" for i in range(2, its + 1)] + [
            "eig.csv", "error-indicators.csv"]:
        check(os.path.exists(os.path.join(post, name)),
              f"amr-eigen-tet: missing {name}")
    line_e = (f"amr-eigen-tet box_tet {n}^3 p={p}: f error per pass "
              f"{', '.join(f'{e:.3e}' for e in err)} GHz (analytic "
              f"{AMR_BOX_F:.6f}); {_passes(res['provenance'])}; run "
              f"{wall:.2f} s")

    n, p = AMR_DRIVEN
    res, wall, _ = _gpu_run(write_amr_driven_case(
        os.path.join(workdir, "amr_driven"), n, p, device="GPU", verbose=0),
        "amr-driven-tet")
    passes = res["provenance"]["amr_passes"]
    iodata = res["sop"].iodata
    tol, its = iodata.solver.linear.tol, iodata.model.refinement.max_it
    check(len(passes) == its + 1, f"amr-driven-tet: {len(passes)} passes")
    check(all(q["solver_path"] == "device" and q["max_relres"] <= tol
              for q in passes), f"amr-driven-tet: passes {passes}")
    post = res["post_dir"]
    for name in ("iteration1/port-S.csv", "port-S.csv", "domain-E.csv",
                 "error-indicators.csv"):
        _table(os.path.join(post, name))
    print(f"[20 amr] {line_e}; amr-driven-tet box_tet {n}^3 p={p}: max "
          f"relres {max(q['max_relres'] for q in passes):.3e}; "
          f"{_passes(res['provenance'])}; run {wall:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def phase_eigen_parity2(workdir: str):
    """The damped, nonlinear and AMR eigen branches on the GPU and on the
    CPU at small sizes: eig.csv Re f within 1e-8 and Im f within 1e-6
    (relative), the same element counts per AMR pass; the cavity's surface,
    far-field and ParaView outputs within 1e-8."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import (write_amr_eigen_case,
                                    write_guide_eigen_case)

    t0 = time.perf_counter()
    cases = {"cavity": _cavity_outputs_case,
             "guide": lambda d, dev: write_guide_eigen_case(
        d, *SMALL_GUIDE_EIGEN, device=dev, verbose=0),
             "amr": lambda d, dev: write_amr_eigen_case(
        d, *SMALL_AMR_EIGEN[:2], size=AMR_BOX, jitter=0.1,
        max_its=SMALL_AMR_EIGEN[2], device=dev, verbose=0)}
    worst, outputs = {}, {}
    for tag, write in cases.items():
        out = {}
        for dev in ("GPU", "CPU"):
            r = palace_torch.run(write(os.path.join(workdir, f"p21_{tag}_"
                                                              f"{dev}"), dev))
            passes = r["provenance"].get("amr_passes")
            out[dev] = (_table(os.path.join(r["post_dir"], "eig.csv")),
                        [q["elements"] for q in passes] if passes
                        else [r["sop"].mesh.num_elements])
            if tag == "cavity":
                outputs[dev] = _cavity_outputs(r, dev)
        (g, ge), (c, ce) = out["GPU"], out["CPU"]
        check(ge == ce, f"{tag}: elements per pass GPU {ge}, CPU {ce}")
        check(g.shape == c.shape, f"{tag}: eig.csv shapes {g.shape}, "
                                  f"{c.shape}")
        re = float((np.abs(g[:, 1] - c[:, 1]) / np.abs(c[:, 1])).max())
        im = float((np.abs(g[:, 2] - c[:, 2])
                    / np.maximum(np.abs(c[:, 2]), 1e-300)).max()) \
            if np.abs(c[:, 2]).max() > 0 else float(np.abs(g[:, 2]).max())
        check(re <= 1e-8 and im <= 1e-6,
              f"{tag}: eig.csv GPU vs CPU Re f {re:.3e}, Im f {im:.3e}")
        worst[tag] = (re, im, ge)
    outs = max(_rel_diff(outputs["GPU"][n], outputs["CPU"][n])
               for n in outputs["CPU"])
    check(outs <= 1e-8, f"cavity: outputs GPU vs CPU {outs:.3e}")
    print("[21 eigen parity] " + "; ".join(
        f"{tag}: Re f {re:.3e}, Im f {im:.3e}, elements {ge}"
        for tag, (re, im, ge) in worst.items())
        + f"; cavity surface-F/Q, farfield-rE and ParaView mode arrays GPU "
          f"vs CPU {outs:.3e}; phase {time.perf_counter() - t0:.1f} s",
        flush=True)


def _cavity_outputs_case(d: str, dev: str) -> str:
    """Phase 21's copper cavity with a SurfaceFlux (Electric on z = 0,
    Power on z = d), an MA Dielectric on the side walls, a FarField on z =
    0 and the first mode's ParaView fields."""
    from palace_torch.cases import write_cavity_case

    cfg = write_cavity_case(d, *SMALL_CAVITY_CU, device=dev, verbose=0)
    with open(cfg) as f:
        data = json.load(f)
    data["Boundaries"]["Postprocessing"] = {
        "SurfaceFlux": [{"Index": 1, "Attributes": [5], "Type": "Electric"},
                        {"Index": 2, "Attributes": [6], "Type": "Power"}],
        "Dielectric": [{"Index": 1, "Attributes": [1, 2, 3, 4],
                        "Type": "MA", "Thickness": 0.002,
                        "Permittivity": 10.0, "LossTan": 0.001}],
        "FarField": {"Attributes": [5], "NSample": 4}}
    data["Solver"]["Eigenmode"]["Save"] = 1
    with open(cfg, "w") as f:
        json.dump(data, f)
    return cfg


def _cavity_outputs(res, dev: str) -> dict:
    """{name: array} of the cavity run's surface-F/Q, farfield-rE tables and
    its ParaView mode arrays (checked for every field and node)."""
    post = res["post_dir"]
    out = {name: _table(os.path.join(post, name)) for name in (
        "surface-F.csv", "surface-Q.csv", "farfield-rE.csv")}
    out.update(_check_vtus(f"cavity ({dev})", os.path.join(
        post, "paraview", "eigenmode"), res["sop"].mesh, 1,
        ("E_real", "E_imag")))
    return out


class _StepResiduals:
    """Host residuals ||A k1 - r|| / ||r|| of the transient implicit solves
    numbered `calls` (from 1) while it is entered: A = M + dt^2 K + dt C and
    r = f(u, t) - dt K u1 from the TransientOperator's scipy CSRs; the
    method is restored on exit."""

    def __init__(self, calls):
        self.calls, self.count, self.resid = set(calls), 0, []

    def __enter__(self):
        import numpy as np

        from palace_torch.drivers import transient

        self.cls = transient.TransientOperator
        self.orig = self.cls.implicit_solve
        orig = self.orig

        def call(op, dt, u1, u2, t):
            k1, k2 = orig(op, dt, u1, u2, t)
            self.count += 1
            if self.count in self.calls:
                A = op.M + dt * dt * op.K
                if op.C is not None:
                    A = A + dt * op.C
                r = op.rhs(u1, u2, t) - dt * (op.K @ u1)
                self.resid.append(float(np.linalg.norm(A @ k1 - r)
                                        / np.linalg.norm(r)))
            return k1, k2

        self.cls.implicit_solve = call
        return self

    def __exit__(self, *exc):
        self.cls.implicit_solve = self.orig


def _envelope_peak(t, v) -> float:
    """Time of the peak of v's envelope, the modulus of its analytic signal
    (FFT Hilbert transform), refined by the parabola through the largest
    sample and its neighbours."""
    import numpy as np

    n = len(v)
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    env = np.abs(np.fft.ifft(np.fft.fft(v) * h))
    k = min(max(int(np.argmax(env)), 1), n - 2)
    a, b, c = env[k - 1:k + 2]
    return float(t[k] + 0.5 * (a - c) / (a - 2 * b + c) * (t[1] - t[0]))


def _line_post(length: float) -> dict:
    """A probe at the line's centre and a domain energy over it."""
    return {"Probe": [{"Index": 1, "Center": [0.5 * length, 5.0, 5.0]}],
            "Energy": [{"Index": 1, "Attributes": [1]}]}


TRANSIENT_TABLES = ("port-V.csv", "port-I.csv", "domain-E.csv",
                    "probe-E.csv", "probe-B.csv")


def phase_transient(workdir: str):
    """The transient TEM line (GeneralizedAlpha) at full width on the GPU:
    the matched line carries the pulse from port 1 to port 2 in L / c0 and
    the energy leaves through the ports; host residuals of three implicit
    solves; every indicator mass solve on the device CG."""
    import numpy as np

    from palace_torch.cases import write_tem_line_case

    t_phase = time.perf_counter()
    length = TEM_LINE[0]
    nstep = int(round(TEM_MAX_T / TEM_DT)) + 1
    cfg = write_tem_line_case(
        os.path.join(workdir, "tem_line"), *TEM_LINE, time_step=TEM_DT,
        max_time=TEM_MAX_T, domain_post=_line_post(length), device="GPU",
        verbose=0)
    with _StepResiduals((1, nstep // 2, nstep - 1)) as steps:
        res, wall, peak = _gpu_run(cfg, "transient")
    check(res["num_dofs"] == TEM_LINE_DOFS,
          f"transient: unexpected dof count {res['num_dofs']}")
    post, prov = res["post_dir"], res["provenance"]
    tabs = {name: _table(os.path.join(post, name))
            for name in TRANSIENT_TABLES}
    for name, tab in tabs.items():
        check(tab.shape[0] == nstep, f"transient: {name} has {tab.shape[0]} "
                                     f"rows, expected {nstep}")
    _table(os.path.join(post, "error-indicators.csv"))
    V = tabs["port-V.csv"]
    t_ns, V1, V2 = V[:, 0], V[:, 2], V[:, 3]
    ratio = float(np.abs(V2).max() / np.abs(V1).max())
    check(abs(ratio - 1.0) <= 0.08, f"transient: peak |V2| / peak |V1| "
                                    f"{ratio:.4f}, not within 8% of 1")
    transit = length * 1e-3 / C0 * 1e9
    delay = _envelope_peak(t_ns, V2) - _envelope_peak(t_ns, V1)
    check(abs(delay / transit - 1.0) <= 0.05,
          f"transient: envelope delay {delay:.5f} ns against L / c0 "
          f"{transit:.5f} ns")
    E = tabs["domain-E.csv"]
    Etot = E[:, 1] + E[:, 2]
    check(Etot[-1] < 1e-4 * Etot.max(), f"transient: energy at MaxTime "
          f"{Etot[-1]:.3e} J, maximum {Etot.max():.3e} J")
    check(len(steps.resid) == 3 and max(steps.resid) <= 1e-10,
          f"transient: host residuals {steps.resid}")
    route = prov.get("estimator_mass_route", {})
    check(route == {"device-cg": 2 * nstep},
          f"transient: estimator mass solves {route}")
    clock = prov["transient_seconds"]
    per = {k: 1e3 * clock[k] / nstep for k in ("implicit_solve", "energies",
                                               "indicators")}
    print(f"[22 transient] TEM line {length:g} mm, box_tet "
          f"{TEM_LINE[1]}x{TEM_LINE[2]}x{TEM_LINE[2]} p={TEM_LINE[3]}: "
          f"{res['num_dofs']} dofs, {nstep} steps of {TEM_DT} ns "
          f"(GeneralizedAlpha); peak |V2| / |V1| {ratio:.4f}, envelope delay "
          f"{delay:.5f} ns against L / c0 {transit:.5f} ns ("
          f"{delay / transit - 1.0:+.3e}), energy at MaxTime / maximum "
          f"{Etot[-1] / Etot.max():.3e}; host residuals "
          f"{', '.join(f'{r:.2e}' for r in steps.resid)}; estimator mass "
          f"solves {route}; per step: implicit solve {per['implicit_solve']:.2f}"
          f" ms, energies and port integrals {per['energies']:.2f} ms, "
          f"indicators {per['indicators']:.2f} ms; {_durations(post)}, run "
          f"{wall:.2f} s; peak device memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def _both(workdir: str, tag: str, write, names, vtu=None):
    """Run write(directory, device) on the GPU and on the CPU; returns
    ({device: {table: array}}, GPU result), with the VTU arrays of `vtu`
    (a path under paraview/) under its name.  Checks that no indicator
    mass solve left the device CG and that no structured kernel ran."""
    import palace_torch

    out, gpu = {}, None
    for dev in ("GPU", "CPU"):
        _zero_counts()
        res = palace_torch.run(write(os.path.join(workdir, f"p23_{tag}_"
                                                            f"{dev}"), dev))
        check(_counts() == (0, 0), f"{tag}: structured kernels launched")
        route = res["provenance"].get("estimator_mass_route", {})
        check("host-splu" not in route, f"{tag} ({dev}): estimator mass "
                                        f"solves {route}")
        post = res["post_dir"]
        out[dev] = {name: _table(os.path.join(post, name)) for name in names}
        if "eig.csv" in out[dev]:  # m, Re f, Im f, Q (not the solver's
            out[dev]["eig.csv"] = out[dev]["eig.csv"][:, :4]  # errors)
        if vtu is not None:
            out[dev].update(_vtu_arrays(os.path.join(post, "paraview", vtu)))
        gpu = gpu or res
    return out, gpu


def phase_transient_parity(workdir: str):
    """The four transient schemes and the driven surface and far-field
    tables on the GPU and on the CPU at small sizes (the eigenmode outputs
    ride on phase 21's cavity); the schemes' lines are LINE's docstring."""
    import numpy as np

    from palace_torch.cases import write_dipole_case, write_tem_line_case

    t0 = time.perf_counter()
    worst, v2 = {}, {}
    for scheme, line in (("GeneralizedAlpha", LINE), ("RungeKutta", LINE),
                         ("ARKODE", ADAPTIVE_LINE), ("CVODE", ADAPTIVE_LINE)):
        out, res = _both(workdir, scheme, lambda d, dev: write_tem_line_case(
            d, *line, scheme=scheme, **LINE_PULSE,
            domain_post=_line_post(line[0]), device=dev, verbose=0),
            TRANSIENT_TABLES + ("error-indicators.csv",))
        g, c = out["GPU"], out["CPU"]
        for name, gate in [(n, 1e-10) for n in TRANSIENT_TABLES] + [
                ("error-indicators.csv", 1e-8)]:
            check(g[name].shape == c[name].shape,
                  f"{scheme}: {name} shapes {g[name].shape}, {c[name].shape}")
            d = _rel_diff(g[name], c[name])
            check(d <= gate, f"{scheme}: {name} GPU vs CPU {d:.3e} > "
                             f"{gate:.0e}")
            worst[name] = max(worst.get(name, 0.0), d)
        v2[scheme, line] = g["port-V.csv"][:, 3]
    # The adaptive schemes' reference: GeneralizedAlpha on their line.
    res = _gpu_run(write_tem_line_case(
        os.path.join(workdir, "p23_ga_adaptive_line"), *ADAPTIVE_LINE,
        **LINE_PULSE, device="GPU", verbose=0), "GeneralizedAlpha")[0]
    v2["GeneralizedAlpha", ADAPTIVE_LINE] = _table(os.path.join(
        res["post_dir"], "port-V.csv"))[:, 3]
    track = {}
    for s, line in (("RungeKutta", LINE), ("ARKODE", ADAPTIVE_LINE),
                    ("CVODE", ADAPTIVE_LINE)):
        ref = v2["GeneralizedAlpha", line]
        scale = float(np.abs(ref).max())
        check(scale > 0, f"{s}: GeneralizedAlpha's V2 is zero")
        track[s] = float(np.abs(v2[s, line] - ref).max() / scale)
    check(max(track.values()) < 5e-2,
          f"schemes against GeneralizedAlpha {track}")
    parts = {"schemes": time.perf_counter() - t0}

    post = {"SurfaceFlux": [{"Index": 1, "Attributes": [2], "Type": "Power"}],
            "Dielectric": [{"Index": 1, "Attributes": [2], "Type": "Default",
                            "Thickness": 0.01, "Permittivity": 10.0,
                            "LossTan": 0.01}]}
    out, res = _both(workdir, "surface", lambda d, dev: write_tem_line_case(
        d, *LINE, problem="Driven", postprocessing=post, device=dev,
        verbose=0), ("surface-F.csv", "surface-Q.csv"))
    m = res["measurements"][(1, 0)]
    flux = m.surf_flux[1].real
    p, Q = m.surf_q[1]
    check(abs(flux - 1.0) <= 0.05, f"surface: Power flux {flux:.4f} W")
    check(abs(Q * 0.01 * p - 1.0) <= 1e-9, f"surface: Q {Q} against "
                                          f"1 / (p tan delta) {1 / (0.01 * p)}")
    surf = max(_rel_diff(out["GPU"][n], out["CPU"][n])
               for n in ("surface-F.csv", "surface-Q.csv"))
    check(surf <= 1e-8, f"surface: GPU vs CPU {surf:.3e}")
    parts["surface"] = time.perf_counter() - t0 - sum(parts.values())

    out, res = _both(workdir, "dipole", lambda d, dev: write_dipole_case(
        d, *DIPOLE, device=dev, verbose=0), ("farfield-rE.csv",))
    check(res["provenance"].get("solver_path") == "direct",
          f"dipole: solver path {res['provenance'].get('solver_path')}")
    rE = res["measurements"][(1, 0)].farfield  # (30, 45), (45, 0), (90, 0)
    mags = np.linalg.norm(np.abs(rE), axis=1)
    ratios = (mags[1] / mags[2], mags[0] / mags[2], abs(rE[2, 2]) / mags[2])
    check(abs(ratios[0] / math.sin(math.radians(45)) - 1) <= 0.1
          and abs(ratios[1] / math.sin(math.radians(30)) - 1) <= 0.15
          and abs(ratios[2] - 1) <= 0.1, f"dipole: pattern {ratios}")
    ff = _rel_diff(out["GPU"]["farfield-rE.csv"], out["CPU"]["farfield-rE.csv"])
    check(ff <= 1e-8, f"dipole: farfield-rE.csv GPU vs CPU {ff:.3e}")
    dipole_dofs = res["num_dofs"]
    parts["dipole"] = time.perf_counter() - t0 - sum(parts.values())

    print("[23 transient parity] " + ", ".join(
        f"{n} {d:.3e}" for n, d in worst.items())
        + f" (GPU vs CPU, 4 schemes; GeneralizedAlpha and RungeKutta at "
          f"{LINE[1]}^3, ARKODE and CVODE at {ADAPTIVE_LINE[1]} x "
          f"{ADAPTIVE_LINE[2]} x {ADAPTIVE_LINE[2]}); against "
          f"GeneralizedAlpha on the same line "
        + ", ".join(f"{s} {d:.3e}" for s, d in track.items())
        + f"; surface line: Power flux {flux:.5f} W, Q - 1 / (p tan delta) "
          f"{Q * 0.01 * p - 1.0:+.2e}, GPU vs CPU {surf:.3e}; dipole "
          f"{dipole_dofs} dofs: |rE| ratios {ratios[0]:.4f} (sin 45 "
          f"{math.sin(math.radians(45)):.4f}), {ratios[1]:.4f} (0.5), "
          f"polarization {ratios[2]:.4f}, GPU vs CPU {ff:.3e}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + f"; phase {time.perf_counter() - t0:.1f} s", flush=True)


def _nan_rel_diff(a, b, floor: float = 1.0) -> float:
    """Max over columns of max |a - b| / max(max |b|, floor), over the
    entries that are not NaN; a and b must be NaN in the same places (an
    evanescent diffraction order prints NaN)."""
    import numpy as np

    check(a.shape == b.shape and (np.isnan(a) == np.isnan(b)).all(),
          f"tables differ in shape or NaN pattern ({a.shape}, {b.shape})")
    worst = 0.0
    for j in range(b.shape[1]):
        ok = ~np.isnan(b[:, j])
        if ok.any():
            s = max(float(np.abs(b[ok, j]).max()), floor)
            worst = max(worst, float(np.abs(a[ok, j] - b[ok, j]).max()) / s)
    return worst


def _device_route(tag: str, prov) -> dict:
    """The indicators' mass solves, all on the device CG."""
    route = prov.get("estimator_mass_route", {})
    check(set(route) == {"device-cg"}, f"{tag}: estimator mass solves "
                                       f"{route}")
    return route


def phase_floquet_eigen(workdir: str):
    """The Floquet eigenproblem of tests/test_floquet.py on the x-periodic
    PEC cube at full depth: the forward pair and the backward branch
    against the analytic Bloch modes, E_elec = E_mag per mode (the Floquet
    magnetic energy included), host shift-invert with every indicator mass
    solve on the device CG; the small cube GPU against CPU."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import floquet_box_freq, write_floquet_box_case
    from palace_torch.drivers.driven import _energy

    t_phase = time.perf_counter()
    n, p = FLOQUET_BOX
    f1 = floquet_box_freq(FLOQUET_K)
    fb = floquet_box_freq(FLOQUET_K, -1)
    res, wall, peak = _gpu_run(write_floquet_box_case(
        os.path.join(workdir, "flo_eig"), n, p, kx=FLOQUET_K, device="GPU",
        verbose=0), "floquet-eigen")
    check(res["num_dofs"] == FLOQUET_BOX_DOFS,
          f"floquet-eigen: unexpected dof count {res['num_dofs']}")
    prov = res["provenance"]
    check(prov.get("eigen_path") == "host-arpack",
          f"floquet-eigen: eigen path {prov.get('eigen_path')}")
    route = _device_route("floquet-eigen", prov)
    f = np.asarray(res["frequencies_ghz"])
    check(len(f) == 2, f"floquet-eigen: {len(f)} modes")
    err = float(np.abs(f.real / f1 - 1.0).max())
    im = float(np.abs(f.imag).max() / f1)
    check(err <= 1e-4, f"floquet-eigen: forward pair {f.real} against f1 "
                       f"{f1:.6f} GHz, error {err:.3e} > 1e-4")
    check(im < 1e-6, f"floquet-eigen: |Im f| / f1 {im:.3e}")
    dom = _table(os.path.join(res["post_dir"], "domain-E.csv"))
    ratio = float(np.abs(dom[:, 2] / dom[:, 1] - 1.0).max())
    check(ratio <= 1e-6, f"floquet-eigen: E_mag / E_elec - 1 {ratio:.3e}")
    sop = res["sop"]
    bare = max(abs(_energy(sop.K_dom, x) / (abs(_omega(sop, fi)) ** 2
                                            * _energy(sop.M_re, x)) - 1.0)
               for x, fi in zip(res["modes"].T, f))
    back, _, _ = _gpu_run(write_floquet_box_case(
        os.path.join(workdir, "flo_eig_back"), *FLOQUET_BACK, kx=FLOQUET_K,
        target=24.5, modes=1, device="GPU", verbose=0), "floquet-backward")
    check(back["num_dofs"] == FLOQUET_BACK_DOFS,
          f"floquet-eigen: backward case dof count {back['num_dofs']}")
    fbk = float(np.real(back["frequencies_ghz"][0]))
    check(abs(fbk / fb - 1.0) <= 1e-3, f"floquet-eigen: backward mode "
          f"{fbk:.6f} GHz against {fb:.6f}")
    freqs = {}
    for dev in ("GPU", "CPU"):
        r = palace_torch.run(write_floquet_box_case(
            os.path.join(workdir, f"flo_eig_{dev}"), *SMALL_FLOQUET_BOX,
            kx=FLOQUET_K, device=dev, verbose=0))
        freqs[dev] = np.asarray(r["frequencies_ghz"])
    par = float(np.abs(freqs["GPU"] - freqs["CPU"]).max()
                / np.abs(freqs["CPU"]).max())
    check(par <= 1e-9, f"floquet-eigen: GPU vs CPU frequencies {par:.3e}")
    print(f"[24 floquet-eigen] x-periodic cube, k {FLOQUET_K:g} /cm, "
          f"box_tet {n}^3 p={p}: {res['num_dofs']} dofs; forward pair "
          f"{f.real[0]:.6f}, {f.real[1]:.6f} GHz against f1 {f1:.6f} "
          f"(error {err:.3e}, gate 1e-4; |Im f| / f1 {im:.1e}), backward "
          f"at box_tet {FLOQUET_BACK[0]}^3 p={FLOQUET_BACK[1]} {fbk:.6f} "
          f"against {fb:.6f} GHz ({fbk / fb - 1.0:+.3e}, gate 1e-3); E_mag / E_elec - 1 {ratio:.3e} (gate 1e-6; "
          f"{bare:.3f} without the Floquet energy); {prov['eigen_path']}, "
          f"estimator mass solves {route}; GPU vs CPU at box_tet "
          f"{SMALL_FLOQUET_BOX[0]}^3 p={SMALL_FLOQUET_BOX[1]} {par:.3e} "
          f"(palace_tpu: 1e-8, tests/port/test_torch_floquet.py); "
          f"{_durations(res['post_dir'])}, run {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def phase_floquet_driven(workdir: str):
    """The Bloch-phase dipole sweep of the x-periodic cube on the device
    FGMRES + p-MG (element fine level with the Floquet tables) at full
    depth, across the f1 resonance: relres and host residuals, the energy
    balance at resonance; the element fine level's apply; small runs with
    FloquetReferenceFrequency GPU against CPU and adaptive against
    uniform."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import floquet_box_freq, write_floquet_dipole_case
    from palace_torch.drivers.driven import _energy

    t_phase = time.perf_counter()
    n, p = FLOQUET_DIPOLE
    f1 = floquet_box_freq(FLOQUET_K)
    cfg = write_floquet_dipole_case(
        os.path.join(workdir, "flo_drv"), n, p,
        freqs=(0.9 * f1, f1, 1.1 * f1), tol=1e-8, device="GPU", verbose=0)
    with _ElemApplies() as applies:
        res, wall, peak = _gpu_run(cfg, "floquet-driven")
    check(res["num_dofs"] == FLOQUET_DIPOLE_DOFS,
          f"floquet-driven: unexpected dof count {res['num_dofs']}")
    prov = res["provenance"]
    check(prov.get("fine_level") == "element",
          f"floquet-driven: fine level {prov.get('fine_level')}")
    relres, resid = _uniform_checks("floquet-driven", res)
    route = _device_route("floquet-driven", prov)
    sop = res["sop"]
    names = [t.name for t in sop.driven_terms()]
    check({"floquet_mass", "floquet_cross"} <= set(names),
          f"floquet-driven: terms {names}")
    # The reactive power balance Re x^H b = 2 omega^2 (E_mag - E_elec) of
    # every column (Re x^H A x, A's Hermitian part K - omega^2 M_re, K with
    # the Floquet terms): it holds only with the Floquet magnetic energy.
    # E_elec = E_mag at the resonance f1 is not a gate: the point
    # dipole's near field adds electric energy that grows as the mesh
    # refines (E_elec / E_mag - 1 at f1 on the CPU: 8.9e-3 at box_tet 4^3,
    # Order 2; 3.7e-2 at 4^3, Order 3; 0.358 at 8^3, Order 3).
    rhs1 = sop.rhs1(1)
    bal = bare = 0.0
    for (ex, i), E in res["solutions"].items():
        w, m = res["omegas"][i], res["measurements"][(ex, i)]
        react = float(np.real(np.vdot(E, 1j * w * rhs1)))
        e_bare = 0.5 * _energy(sop.K_dom, E) / (w * w)
        bal = max(bal, abs(2 * w * w * (m.E_mag - m.E_elec) - react)
                  / (2 * w * w * (m.E_mag + m.E_elec)))
        bare = max(bare, abs(2 * w * w * (e_bare - m.E_elec) - react)
                   / (2 * w * w * (e_bare + m.E_elec)))
    check(bal <= 1e-6, f"floquet-driven: reactive power balance {bal:.3e} "
                       f"> 1e-6")
    m = res["measurements"][(1, 1)]
    ratio = m.E_elec / m.E_mag - 1.0
    rep = _elem_apply_report(sop, res["omegas"])
    small = dict(fref=15.0, tol=1e-10, verbose=0)
    tabs = {}
    for dev in ("GPU", "CPU"):
        r = palace_torch.run(write_floquet_dipole_case(
            os.path.join(workdir, f"flo_drv_{dev}"), *SMALL_FLOQUET_DIPOLE,
            freqs=(14.0, 15.5, 17.0), device=dev, **small))
        check(r["provenance"].get("solver_path") == "device",
              f"floquet-driven ({dev}): {r['provenance'].get('solver_path')}")
        tabs[dev] = _table(os.path.join(r["post_dir"], "domain-E.csv"))
    par = _rel_diff(tabs["GPU"], tabs["CPU"])
    check(par <= 1e-8, f"floquet-driven: domain-E GPU vs CPU {par:.3e}")
    grid = [round(14.0 + 0.1 * i, 9) for i in range(31)]
    ad = palace_torch.run(write_floquet_dipole_case(
        os.path.join(workdir, "flo_drv_adaptive"), *SMALL_FLOQUET_DIPOLE,
        adaptive_tol=1e-6, device="GPU", **small))
    check(ad["prom"].stopped_by == {1: "memory"},
          f"floquet-driven: PROM stopped by {ad['prom'].stopped_by}")
    un = palace_torch.run(write_floquet_dipole_case(
        os.path.join(workdir, "flo_drv_uniform"), *SMALL_FLOQUET_DIPOLE,
        freqs=grid, device="GPU", **small))
    prom = _rel_diff(_table(os.path.join(ad["post_dir"], "domain-E.csv")),
                     _table(os.path.join(un["post_dir"], "domain-E.csv")))
    check(prom <= 1e-4, f"floquet-driven: adaptive vs uniform domain-E "
                        f"{prom:.3e} > 1e-4")
    print(f"[25 floquet-driven] x-periodic cube, k {FLOQUET_K:g} /cm, tan "
          f"delta 0.01, box_tet {n}^3 p={p}: {res['num_dofs']} dofs, 3 "
          f"columns (0.9, 1, 1.1 f1), FGMRES iterations "
          f"{res['ksp'].get('total_its')} total, max relres {relres:.3e}, "
          f"host residual {resid:.3e}; reactive power balance {bal:.3e} "
          f"(gate 1e-6; {bare:.3e} without the Floquet energy), E_elec / "
          f"E_mag - 1 at f1 {ratio:+.3e} (0.358 on the CPU); estimator "
          f"mass solves {route}; element fine level (E={rep['elements']}, "
          f"{rep['terms']} terms, F={rep['columns']}, "
          f"{rep['bytes'] / 1e9:.3f} GB) median {rep['ms']:.4f} ms, device "
          f"{rep['device_ms']:.4f} ms, bound {rep['bound_ms']:.4f} ms "
          f"({rep['bound_by']}), {applies.count} applies in the run; "
          f"FloquetReferenceFrequency 15 GHz at box_tet "
          f"{SMALL_FLOQUET_DIPOLE[0]}^3 p={SMALL_FLOQUET_DIPOLE[1]}: "
          f"domain-E GPU vs CPU {par:.3e}, adaptive ({ad['prom'].basis_size}"
          f" basis vectors, {len(ad['prom'].samples)} samples) vs uniform "
          f"{prom:.3e} (palace_tpu's own PROM: 249x, ROADMAP); "
          f"{_durations(res['post_dir'])}, run {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def phase_floquet_cell(workdir: str):
    """Floquet ports on the 1 x 1 x 2 cm cell at 12 GHz (host sparse direct
    with the Woodbury correction): the empty cell at normal and oblique
    incidence against the plane wave, the dielectric slab against the Airy
    formula; the small empty cell GPU against CPU."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import slab_transmission, write_floquet_cell_case

    t_phase = time.perf_counter()
    n, p = FLOQUET_CELL
    f = FLOQUET_CELL_F
    k0 = 2 * math.pi * f * 1e9 / C0  # 1/m
    d = 0.02  # m, between the ports
    kt = 0.9 * 100.0  # 1/m, k_F at the reference frequency
    runs = {"empty": {}, "oblique": dict(kf=(0.9, 0.0, 0.0), fref=f),
            "slab": dict(slab=FLOQUET_SLAB)}
    out, parts = {}, []
    for tag, kw in runs.items():
        res, wall, peak = _gpu_run(write_floquet_cell_case(
            os.path.join(workdir, f"flo_cell_{tag}"), n, p, freqs=(f,),
            device="GPU", verbose=0, **kw), f"floquet-cell-{tag}")
        check(res["num_dofs"] == FLOQUET_CELL_DOFS,
              f"floquet-cell: unexpected dof count {res['num_dofs']}")
        check(res["provenance"].get("solver_path") == "direct",
              f"floquet-cell: {res['provenance'].get('solver_path')}")
        _device_route(f"floquet-cell-{tag}", res["provenance"])
        _table(os.path.join(res["post_dir"], "domain-E.csv"))
        S = res["measurements"][(1, 0)].floquet_s
        # Each port's TE vector is k_t x n over its outward normal n: at
        # oblique incidence the two ports' are opposite, and S21 carries
        # their dot product (+1 at normal incidence, where both take the
        # same fixed vector).
        te = [next(o.e_te for o in fp.orders if (o.m, o.n) == (0, 0))
              for fp in (res["sop"].floquet_ports[i] for i in (1, 2))]
        out[tag] = (S[2][(0, 0, True)] * float(te[0] @ te[1]),
                    S[1][(0, 0, True)],
                    sum(abs(v) ** 2 for s in S.values() for v in s.values()))
        parts.append(f"{tag} {wall:.1f} s, {peak / 2 ** 30:.3f} GiB")

    def arg_err(T, ref):
        return abs((math.degrees(cmath.phase(T)) - ref + 180.0) % 360.0
                   - 180.0)

    T, R, tot = out["empty"]
    ref_a = math.degrees(-k0 * d)
    ea = arg_err(T, ref_a)
    check(abs(abs(T) - 1.0) <= 1e-4 and abs(R) < 1e-3
          and abs(tot - 1.0) <= 1e-4 and ea <= 0.2,
          f"floquet-cell: empty |T| {abs(T):.6f}, |R| {abs(R):.3e}, sum "
          f"|S|^2 {tot:.6f}, arg T error {ea:.3f} deg")
    Tb, Rb, _ = out["oblique"]
    kz = math.sqrt(k0 * k0 - kt * kt)
    eb = arg_err(Tb, math.degrees(-kz * d))
    check(abs(abs(Tb) - 1.0) <= 1e-3 and eb <= 0.5,
          f"floquet-cell: oblique |T| {abs(Tb):.6f}, arg T error "
          f"{eb:.3f} deg")
    Tc, Rc, _ = out["slab"]
    airy = slab_transmission(f, math.sqrt(FLOQUET_SLAB[2]),
                             FLOQUET_SLAB[1] - FLOQUET_SLAB[0])
    ec = abs(abs(Tc) ** 2 - airy)
    cons = abs(abs(Rc) ** 2 + abs(Tc) ** 2 - 1.0)
    check(ec <= 2e-3 and cons <= 1e-4,
          f"floquet-cell: slab |T|^2 {abs(Tc) ** 2:.6f} against Airy "
          f"{airy:.6f}, |R|^2 + |T|^2 - 1 {cons:.3e}")
    tabs = {}
    for dev in ("GPU", "CPU"):
        r = palace_torch.run(write_floquet_cell_case(
            os.path.join(workdir, f"flo_cell_{dev}"), *SMALL_FLOQUET_CELL,
            freqs=(f,), device=dev, verbose=0))
        tabs[dev] = np.atleast_2d(np.loadtxt(
            os.path.join(r["post_dir"], "port-floquet-S.csv"),
            delimiter=",", skiprows=1))
    par = _nan_rel_diff(tabs["GPU"], tabs["CPU"])
    check(par <= 1e-8, f"floquet-cell: port-floquet-S GPU vs CPU "
                       f"{par:.3e}")
    print(f"[26 floquet-cell] 1 x 1 x 2 cm cell, box_tet {n}x{n}x{2 * n} "
          f"p={p}: {FLOQUET_CELL_DOFS} dofs, {f:g} GHz, host direct with "
          f"Woodbury; empty: |T| - 1 {abs(T) - 1.0:+.3e}, |R| {abs(R):.3e}, "
          f"sum |S|^2 - 1 {tot - 1.0:+.3e}, arg T {math.degrees(cmath.phase(T)):.3f}"
          f" deg against -k0 d {ref_a % 360.0 - 360.0:.3f} ({ea:.3f} deg); "
          f"oblique (sin theta {kt / k0:.4f}): |T| - 1 {abs(Tb) - 1.0:+.3e},"
          f" arg T error {eb:.3f} deg; slab: |T|^2 {abs(Tc) ** 2:.6f} "
          f"against Airy {airy:.6f} ({abs(Tc) ** 2 - airy:+.3e}), |R|^2 + "
          f"|T|^2 - 1 {cons:+.3e}; port-floquet-S.csv GPU vs CPU at box_tet "
          f"{SMALL_FLOQUET_CELL[0]}x{SMALL_FLOQUET_CELL[0]}x"
          f"{2 * SMALL_FLOQUET_CELL[0]} p={SMALL_FLOQUET_CELL[1]} {par:.3e} "
          f"(palace_tpu: 1e-8, tests/port/test_torch_floquet.py); runs "
          f"{'; '.join(parts)}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return 0


def _complex_cols(tab):
    """The complex values of a table whose columns after the first come
    in (Re, Im) pairs."""
    return tab[:, 1::2] + 1j * tab[:, 2::2]


def _abs_rel(a, b) -> float:
    """max |a - b| / max |b| over the whole table after its first column
    (a column that sits at round-off, such as Im V of a real port voltage,
    is measured against the table's scale)."""
    import numpy as np

    return float(np.abs(a[:, 1:] - b[:, 1:]).max() / np.abs(b[:, 1:]).max())


def phase_2d(workdir: str):
    """2D meshes on the device solvers: the matched plate line at full
    depth (device FGMRES + p-MG on the element fine level; the structured
    fine level refuses 2D), the PEC rectangle's modes on device Lanczos,
    and both at small sizes on the GPU and on the CPU."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import (rect_mode_freq, write_plate_line_case,
                                    write_rect_eigen_case)

    t_phase = time.perf_counter()
    length, n_len, n_h, p = PLATE_LINE
    cfg = write_plate_line_case(os.path.join(workdir, "plate"), *PLATE_LINE,
                                freqs=PLATE_FREQS, tol=1e-8, device="GPU",
                                verbose=0)
    with _ElemApplies() as applies:
        res, wall, peak = _gpu_run(cfg, "2d-driven")
    sop, prov = res["sop"], res["provenance"]
    check(sop.space.num_dofs == PLATE_LINE_DOFS,
          f"2d-driven: unexpected dof count {sop.space.num_dofs}")
    check(prov.get("fine_level") == "element",
          f"2d-driven: fine level {prov.get('fine_level')}")
    relres, resid = _uniform_checks("2d-driven", res)
    route = _device_route("2d-driven", prov)
    S = _table(os.path.join(res["post_dir"], "port-S.csv"))
    s11 = float((10.0 ** (S[:, 1] / 20.0)).max())
    s21 = float(np.abs(10.0 ** (S[:, 3] / 20.0) - 1.0).max())
    k0L = 2 * math.pi * S[:, 0] * 1e9 / C0 * length * 1e-3
    dphi = float(np.abs(np.angle(np.exp(1j * (np.radians(S[:, 4]) + k0L))))
                 .max())
    check(s11 <= 1e-6 and s21 <= 1e-6 and dphi <= 1e-6,
          f"2d-driven: |S11| {s11:.3e}, ||S21| - 1| {s21:.3e}, arg S21 + "
          f"k0 L {dphi:.3e} rad (gates 1e-6)")
    dom = _table(os.path.join(res["post_dir"], "domain-E.csv"))
    check(np.all(dom[:, 2] == 0.0), "2d-driven: E_mag not 0 on a 2D mesh")
    rep = _elem_apply_report(sop, res["omegas"])
    tabs = {}
    for dev in ("GPU", "CPU"):
        r = palace_torch.run(write_plate_line_case(
            os.path.join(workdir, f"plate_{dev}"), *SMALL_PLATE_LINE,
            freqs=PLATE_FREQS, tol=1e-12, device=dev, verbose=0))
        check(r["provenance"].get("solver_path") == "device",
              f"2d-driven ({dev}): {r['provenance'].get('solver_path')}")
        tabs[dev] = {name: _table(os.path.join(r["post_dir"], name))
                     for name in ("port-V.csv", "port-I.csv",
                                  "domain-E.csv")}
    par = max(_abs_rel(tabs["GPU"][n], tabs["CPU"][n]) for n in tabs["GPU"])
    check(par <= 1e-8, f"2d-driven: GPU vs CPU {par:.3e}")

    nx, ny, pe = RECT_EIGEN
    cfg = write_rect_eigen_case(os.path.join(workdir, "rect"), *RECT_EIGEN,
                                linear="GMG", device="GPU", verbose=0)
    eres, ewall, epeak = _gpu_run(cfg, "2d-eigen")
    eprov = eres["provenance"]
    check(eres["num_dofs"] == RECT_EIGEN_DOFS,
          f"2d-eigen: unexpected dof count {eres['num_dofs']}")
    check(eprov.get("eigen_path") == "device-lanczos"
          and eprov.get("fine_level") == "element",
          f"2d-eigen: {eprov.get('eigen_path')}, {eprov.get('fine_level')}")
    eroute = _device_route("2d-eigen", eprov)
    f = np.real(eres["frequencies_ghz"])
    ref = np.array([rect_mode_freq(*mn) for mn in ((1, 0), (2, 0), (0, 1))])
    ferr = float(np.abs(f / ref - 1.0).max())
    check(len(f) == 3 and ferr <= 1e-7, f"2d-eigen: modes {f} GHz against "
                                        f"{ref} ({ferr:.3e} > 1e-7)")
    bkwd = float(np.max(eres["backward_errors"]))
    check(bkwd <= 1e-9, f"2d-eigen: backward error {bkwd:.3e}")
    eig = {}
    for dev in ("GPU", "CPU"):
        r = palace_torch.run(write_rect_eigen_case(
            os.path.join(workdir, f"rect_{dev}"), *SMALL_RECT_EIGEN,
            modes=2, linear="GMG", device=dev, verbose=0))
        eig[dev] = _table(os.path.join(r["post_dir"], "eig.csv"))[:, 1]
    epar = float(np.abs(eig["GPU"] / eig["CPU"] - 1.0).max())
    check(epar <= 1e-8, f"2d-eigen: Re f GPU vs CPU {epar:.3e}")
    print(f"[27 2d] plate line {length:g} x 2 mm, {n_len}x{n_h} cells x 2 "
          f"tris p={p}: {PLATE_LINE_DOFS} dofs, {len(PLATE_FREQS)} columns, "
          f"FGMRES iterations {res['ksp'].get('total_its')}, max relres "
          f"{relres:.3e}, host residual {resid:.3e}; |S11| {s11:.3e}, "
          f"||S21| - 1| {s21:.3e}, |arg S21 + k0 L| {dphi:.3e} rad; "
          f"estimator mass solves {route}; element fine level "
          f"(E={rep['elements']}, {rep['terms']} terms, F={rep['columns']}, "
          f"{rep['bytes'] / 1e9:.4f} GB) median {rep['ms']:.4f} ms, device "
          f"{rep['device_ms']:.4f} ms, bound {rep['bound_ms']:.4f} ms "
          f"({rep['bound_by']}), {applies.count} applies in the run; "
          f"{_durations(res['post_dir'])}, run {wall:.2f} s, peak "
          f"{peak / 2 ** 30:.3f} GiB; GPU vs CPU at "
          f"{SMALL_PLATE_LINE[1]}x{SMALL_PLATE_LINE[2]} "
          f"p={SMALL_PLATE_LINE[3]} {par:.3e}; rectangle {nx}x{ny} p={pe}: "
          f"{eres['num_dofs']} dofs, device Lanczos, Re f "
          f"{', '.join(f'{v:.9f}' for v in f)} GHz (analytic "
          f"{', '.join(f'{v:.9f}' for v in ref)}; {ferr:.3e}), backward "
          f"error {bkwd:.3e}, FGMRES iterations "
          f"{eprov.get('ksp_iterations')}, estimator mass solves {eroute}; "
          f"{_durations(eres['post_dir'])}, run {ewall:.2f} s, peak "
          f"{epeak / 2 ** 30:.3f} GiB; Re f GPU vs CPU at "
          f"{SMALL_RECT_EIGEN[0]}x{SMALL_RECT_EIGEN[1]} "
          f"p={SMALL_RECT_EIGEN[2]} {epar:.3e}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


def _mode_run(cfg: str, tag: str):
    """One BoundaryMode run on the GPU: (result, mode-kn table, wall
    seconds, peak memory); checks the host pencil path, that no structured
    kernel ran and that every indicator mass solve stayed on the device
    CG."""
    res, wall, peak = _gpu_run(cfg, tag)
    prov = res["provenance"]
    check(prov.get("eigen_path") == "host-arpack",
          f"{tag}: mode path {prov.get('eigen_path')}")
    _device_route(tag, prov)
    return res, _table(os.path.join(res["post_dir"], "mode-kn.csv")), wall, \
        peak


#: The open, lossy WR-90 cross-section of phase 28's GPU-against-CPU run
#: (tests/port/test_torch_boundarymode.py's OPEN).
BM_OPEN = dict(sheet_ls=1e-12, absorbing=True, loss_tan=0.01, eps_r=2.0,
               dielectric=True)


def phase_boundarymode(workdir: str):
    """BoundaryMode on native 2D meshes: the WR-90 cross-section's TE10
    and the parallel-plate TEM cross-section against their analytic modes,
    and the open lossy cross-section on the GPU and on the CPU; returns
    TE10's n_eff, which phase 29 holds its port face's against."""
    import numpy as np

    import palace_torch
    from palace_torch.cases import (MODE_FREQ, TEM_D, TEM_EPS, TEM_W,
                                    te10_kn, tem_section_z,
                                    write_boundarymode_case,
                                    write_tem_section_case)

    t_phase = time.perf_counter()
    f_ghz = MODE_FREQ
    res, kn, wall, peak = _mode_run(write_boundarymode_case(
        os.path.join(workdir, "bm"), *BM_SECTION, device="GPU", verbose=0),
        "boundarymode")
    k0 = 2 * math.pi * f_ghz * 1e9 / C0
    neff, neff_ref = float(kn[0, 3]), te10_kn(f_ghz) / k0
    err = abs(neff / neff_ref - 1.0)
    check(err <= 1e-7 and abs(kn[0, 4]) <= 1e-9,
          f"boundarymode: TE10 n_eff {neff:.10f}{kn[0, 4]:+.2e}i against "
          f"{neff_ref:.10f} ({err:.3e} > 1e-7)")
    check(abs(kn[1, 1]) < 1e-6 * abs(kn[1, 2]),
          f"boundarymode: second mode kn {kn[1, 1]} + {kn[1, 2]}i is not "
          f"evanescent")
    dofs = res["problem"].nd.num_dofs + res["problem"].h1.num_dofs
    w, h, eps = TEM_W, TEM_D, TEM_EPS
    tres, tkn, twall, _ = _mode_run(write_tem_section_case(
        os.path.join(workdir, "tem"), *TEM_SECTION, device="GPU", verbose=0),
        "tem-section")
    z = _table(os.path.join(tres["post_dir"], "mode-Z.csv"))
    tn = abs(tkn[0, 3] / math.sqrt(eps) - 1.0)
    tz = abs(z[0, 1] / tem_section_z() - 1.0)
    check(tn <= 1e-8 and tz <= 1e-8, f"tem-section: n_eff error {tn:.3e}, "
                                     f"Z_PV error {tz:.3e} (gates 1e-8)")
    tabs = {}
    names = ("mode-kn.csv", "mode-V.csv", "mode-Z.csv", "domain-E.csv",
             "surface-Q.csv", "error-indicators.csv")
    for dev in ("GPU", "CPU"):
        r = palace_torch.run(write_boundarymode_case(
            os.path.join(workdir, f"bm_{dev}"), *SMALL_BM, **BM_OPEN,
            device=dev, verbose=0))
        tabs[dev] = {n: _table(os.path.join(r["post_dir"], n))
                     for n in names}
    par = 0.0
    for n in names:
        a, b = tabs["GPU"][n], tabs["CPU"][n]
        if n == "mode-V.csv":  # the phase ties on a symmetric mesh: |V|
            a, b = np.abs(_complex_cols(a)), np.abs(_complex_cols(b))
            par = max(par, float(np.abs(a - b).max() / np.abs(b).max()))
        else:
            par = max(par, _rel_diff(a, b))
    check(par <= 1e-8, f"boundarymode: open section GPU vs CPU {par:.3e}")
    print(f"[28 boundarymode] WR-90 cross-section {BM_SECTION[0]}x"
          f"{BM_SECTION[1]} cells x 2 tris p={BM_SECTION[2]}: {dofs} dofs "
          f"(ND + H1), {f_ghz:g} GHz: TE10 n_eff {neff:.10f} (analytic "
          f"{neff_ref:.10f}, {err:.3e}), mode 2 evanescent (Im kn "
          f"{kn[1, 2]:.4f} 1/m); {_durations(res['post_dir'])}, run "
          f"{wall:.2f} s, peak {peak / 2 ** 30:.3f} GiB; TEM section "
          f"{w:g} x {h:g} mm, eps_r {eps:g}, {TEM_SECTION[0]}x"
          f"{TEM_SECTION[1]} p={TEM_SECTION[2]}: n_eff error {tn:.3e}, Z_PV "
          f"{z[0, 1]:.6f} Ohm (error {tz:.3e}), run {twall:.2f} s; open "
          f"lossy section (Ls sheet, Absorbing, tan delta 0.01, interface) "
          f"at {SMALL_BM[0]}x{SMALL_BM[1]} p={SMALL_BM[2]}: GPU vs CPU "
          f"{par:.3e}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return neff


def phase_boundarymode_3d(workdir: str, neff28: float | None = None):
    """BoundaryMode on the port face of a 3D tet mesh against the analytic
    TE10 and phase 28's native cross-section, and the matched 2D line's
    transient: the pulse crosses it in L / c0."""
    import numpy as np

    from palace_torch.cases import (MODE_FREQ, te10_kn, write_plate_line_case,
                                    write_port_face_mode_case)

    t_phase = time.perf_counter()
    f_ghz = MODE_FREQ
    res, kn, wall, peak = _mode_run(write_port_face_mode_case(
        os.path.join(workdir, "bm_face"), *BM_FACE, device="GPU", verbose=0),
        "boundarymode-3d")
    sub = res["problem"].mesh
    check(sub.nodes.shape[1] == 2, "boundarymode-3d: the submesh is not 2D")
    k0 = 2 * math.pi * f_ghz * 1e9 / C0
    neff, neff_ref = float(kn[0, 3]), te10_kn(f_ghz) / k0
    err = abs(neff / neff_ref - 1.0)
    check(err <= 1e-7, f"boundarymode-3d: TE10 n_eff {neff:.10f} against "
                       f"{neff_ref:.10f} ({err:.3e} > 1e-7)")
    d28 = float("nan")
    if neff28 is not None:  # None: run without phase 28 (a rehearsal)
        d28 = abs(neff / neff28 - 1.0)
        check(d28 <= 1e-8, f"boundarymode-3d: n_eff {neff:.10f} against "
                           f"phase 28's {neff28:.10f} ({d28:.3e} > 1e-8)")

    length, n_len, n_h, p = LINE_2D
    nstep = int(round(TEM_MAX_T / TEM_DT)) + 1
    tres, twall, _ = _gpu_run(write_plate_line_case(
        os.path.join(workdir, "line2d"), *LINE_2D, problem="Transient",
        time_step=TEM_DT, max_time=TEM_MAX_T, device="GPU", verbose=0),
        "2d-transient")
    route = _device_route("2d-transient", tres["provenance"])
    V = _table(os.path.join(tres["post_dir"], "port-V.csv"))
    check(V.shape[0] == nstep, f"2d-transient: {V.shape[0]} rows, expected "
                               f"{nstep}")
    t_ns, V1, V2 = V[:, 0], V[:, 2], V[:, 3]
    ratio = float(np.abs(V2).max() / np.abs(V1).max())
    transit = length * 1e-3 / C0 * 1e9
    delay = _envelope_peak(t_ns, V2) - _envelope_peak(t_ns, V1)
    check(abs(ratio - 1.0) <= 0.08 and abs(delay / transit - 1.0) <= 0.05,
          f"2d-transient: peak |V2| / |V1| {ratio:.4f}, delay {delay:.5f} ns "
          f"against L / c0 {transit:.5f} ns")
    print(f"[29 boundarymode-3d] box_tet {BM_FACE[0]}x{BM_FACE[1]}x"
          f"{BM_FACE[2]} guide, x = 0 face p={BM_FACE[3]}: "
          f"{sub.num_elements} facets, TE10 n_eff {neff:.10f} (analytic "
          f"{neff_ref:.10f}, {err:.3e}; phase 28's native section "
          f"{d28:.3e}), run {wall:.2f} s, peak {peak / 2 ** 30:.3f} GiB; 2D "
          f"transient line {length:g} mm, {n_len}x{n_h} p={p}: "
          f"{tres['num_dofs']} dofs, {nstep} steps of {TEM_DT} ns; peak "
          f"|V2| / |V1| {ratio:.4f}, envelope delay {delay:.5f} ns against "
          f"L / c0 {transit:.5f} ns ({delay / transit - 1.0:+.3e}); "
          f"estimator mass solves {route}; run {twall:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 30: dof-sharded solves on two ranks that share the card


def _sharded_parts(workdir: str, device: str) -> list:
    """(part, config) of phase 30, written into `workdir`: phase 4's driven
    slice, phase 12's rings electrostatic case and the eigen cavity at
    SHARDED_EIGEN_N^3, Order 3 (phase 6's case unless cut)."""
    from palace_torch.cases import (write_eigen_case, write_rings_case,
                                    write_slice_case)

    return [
        ("driven", write_slice_case(os.path.join(workdir, "driven"),
                                    DRIVEN_N, 3, tol=1e-8, max_its=200,
                                    device=device, verbose=0)),
        ("electrostatic", write_rings_case(
            os.path.join(workdir, "electrostatic"), RINGS_H, RINGS_ORDER,
            problem="Electrostatic", tol=1e-10, max_its=3000, device=device,
            verbose=0)),
        ("eigen", write_eigen_case(os.path.join(workdir, "eigen"),
                                   SHARDED_EIGEN_N, 3, tol=1e-8,
                                   device=device, verbose=0)),
    ]


def _solution_matrix(res) -> "np.ndarray":
    import numpy as np

    sols = res["solutions"]
    return np.stack([sols[k] for k in sorted(sols)], axis=1)


def _collective_latency(parallel, device, n: int = 200) -> dict:
    """Milliseconds one all-reduce of 16 float64 takes (all ranks calling
    together): `parallel.psum` on the run's device (a CUDA tensor through a
    host copy) and on the host, and gloo's own CUDA path."""
    import torch
    import torch.distributed as dist

    calls = {"psum": parallel.psum,
             "gloo-cuda": lambda t: dist.all_reduce(t)}
    out = {}
    for name, where in (("psum", device.type), ("psum", "cpu"),
                        ("gloo-cuda", "cuda")):
        if where == "cuda" and device.type != "cuda":
            continue
        t = torch.zeros(16, dtype=torch.float64, device=where)
        for _ in range(10):
            calls[name](t)
        if where == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            calls[name](t)
        if where == "cuda":
            torch.cuda.synchronize()
        out[f"{name} {where}"] = 1e3 * (time.perf_counter() - t0) / n
    return out


def rank_main(rank: int, world: int, workdir: str) -> int:
    """One rank of phase 30: joins the gloo group through a file store in
    `workdir`, runs every part of `_sharded_parts` through palace_torch.run
    and writes rank<rank>.json (wall time, peak memory and kernel launches
    of each part; rank 0 also the results the phase gates, with its
    solutions in rank0.npz)."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    import numpy as np
    import torch

    import palace_torch
    from palace_torch import parallel

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    with open(os.path.join(workdir, "parts.json")) as f:
        spec = json.load(f)
    on_card = spec["device"] == "GPU"
    parallel.init(rank, world, f"file://{os.path.join(workdir, 'store')}",
                  device_type="cuda" if on_card else "cpu")
    out, arrays = {"latency_ms": _collective_latency(
        parallel, torch.device("cuda") if on_card else torch.device("cpu"))}, {}
    for part, cfg in spec["parts"]:
        base = _memory_mark() if on_card else 0
        _zero_counts()
        parallel.reset_stats()
        t0 = time.perf_counter()
        res = palace_torch.run(cfg)
        if on_card:
            torch.cuda.synchronize()
        rec = {"wall": time.perf_counter() - t0,
               "peak_gib": ((torch.cuda.max_memory_allocated() - base)
                            / 2 ** 30 if on_card else None),
               "launches": list(_counts()), "num_dofs": res["num_dofs"],
               "collectives": dict(parallel.STATS),
               "durations": (_durations(res["post_dir"]) if rank == 0
                             else "")}
        prov = res["provenance"]
        rec["parallel"] = prov.get("parallel")
        if part == "driven":
            rec["fine_level"] = prov.get("fine_level")
            rec["solver_path"] = prov.get("solver_path")
            rec["col_relres"] = sorted(res["ksp"]["col_relres"].values())
            rec["post_dir"] = res["post_dir"]
            arrays["driven"] = _solution_matrix(res)
        elif part == "electrostatic":
            rec["C"] = np.asarray(res["C"]).tolist()
            rec["cg_relres"] = prov.get("cg_relres")
            rec["cg_iterations"] = prov.get("cg_iterations")
        else:
            rec["eigen_path"] = prov.get("eigen_path")
            rec["fine_level"] = prov.get("fine_level")
            rec["f_ghz"] = np.real(res["frequencies_ghz"]).tolist()
            rec["bkwd"] = np.asarray(res["backward_errors"]).tolist()
            rec["ksp_iterations"] = prov.get("ksp_iterations")
        out[part] = rec
    if rank == 0:
        np.savez(os.path.join(workdir, "rank0.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    parallel.shutdown()
    return 0


def _run_ranks(workdir: str, world: int) -> list:
    """Starts the ranks of phase 30 (threads split between them), waits
    for them within the run's deadline and returns their records; fails with
    the end of a failed rank's log."""
    threads = str(max(1, (os.cpu_count() or world) // world))
    env = dict(os.environ, OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads,
               OPENBLAS_NUM_THREADS=threads)
    procs = []
    try:
        for r in range(world):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), RANK_FLAG,
                 str(r), str(world), workdir], env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        for r, (proc, log) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, DEADLINE_S - (
                    time.perf_counter() - T_START)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise SmokeFailure(f"phase 30 rank {r} failed ({rc}):\n"
                                   f"{tail}")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    recs = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _qdata_rows(device: str) -> list:
    """The qdata apply against the element-mode apply of nd_operator (curl
    and mass) on the slice's cavity mesh (DRIVEN_N^3 hexes) at each of
    QDATA_ORDERS: both held to 1e-12 of each other, their CUDA-event
    medians and device times, and each one's bound (its tables, u and y
    moved once over the memory rate, or its operations over the float64
    rate, whichever is larger)."""
    import numpy as np
    import torch

    from palace_torch.fem.nd import NDSpace
    from palace_torch.fem.nd_operators import nd_operator
    from palace_torch.mesh.generate import box_hex

    mesh = box_hex(DRIVEN_N, DRIVEN_N, DRIVEN_N, lx=24.0, ly=24.0, lz=24.0)
    coefs = dict(curl_coef={1: np.eye(3)}, mass_coef={1: 2.0 * np.eye(3)})
    rows = []
    for p in QDATA_ORDERS:
        space = NDSpace(mesh, p)
        ops = {mode: nd_operator(space, device=device, mode=mode, **coefs)
               for mode in ("element", "qdata")}
        u = torch.as_tensor(np.random.default_rng(p).standard_normal(
            space.num_dofs), device=device)
        y = {m: op(u) for m, op in ops.items()}
        err = float((y["qdata"] - y["element"]).abs().max()
                    / y["element"].abs().max())
        check(err <= 1e-12, f"qdata apply at p={p} against element mode: "
                            f"{err:.3e} > 1e-12")
        row = {"p": p, "nd": int(space.elem_dofs[0].shape[1]),
               "elements": mesh.num_elements, "dofs": space.num_dofs,
               "rel_err": err}
        for mode, op in ops.items():
            nbytes = 8 * 2 * op.num_dofs
            flops = 0.0
            for t in op._tables:
                E, nd = t["gidx"].shape
                nbytes += 8 * 2 * E * nd  # gather indices and signs
                if "A" in t:
                    nbytes += 8 * t["A"].numel()
                    flops += 2.0 * t["A"].numel()
                else:
                    for G, W in t["qd"]:
                        nq, _, d = G.shape
                        nbytes += 8 * (G.numel() + W.numel())
                        flops += E * (4.0 * nq * d * nd + 2.0 * nq * d * d)
            t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float64"]
            on_card = device == "cuda"
            row[mode] = {
                "ms": _time_ms(lambda: op(u)) if on_card else float("nan"),
                "device_ms": (_device_ms(lambda: op(u)) if on_card
                              else float("nan")),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "gb": nbytes / 1e9}
        rows.append(row)
    return rows


def _single_rank_reference(part: str, cfg: str, out_dir: str) -> None:
    """Phase 30's single-rank result of `part` (its config `cfg`, run on one
    rank into `out_dir`) into SINGLE_RANK, unless an earlier phase of the
    run left it there."""
    import numpy as np

    import palace_torch

    key = {"driven": "driven", "electrostatic": "C", "eigen": "eigen"}[part]
    if key in SINGLE_RANK:
        return
    res = palace_torch.run(cfg, output_dir=out_dir)
    SINGLE_RANK[key] = (
        (_solution_matrix(res), _table(os.path.join(
            res["post_dir"], "domain-E.csv"))) if part == "driven"
        else np.asarray(res["C"]).tolist() if part == "electrostatic"
        else np.real(res["frequencies_ghz"]))


def phase_sharded_eigen_reference(workdir: str) -> None:
    """Phase 30's cut cavity on one rank (SHARDED_EIGEN_N^3, Order 3), run
    in the first process beside the groups so that phase 30, alone on the
    card, holds only its ranks."""
    from palace_torch.cases import write_eigen_case

    t0 = time.perf_counter()
    d = os.path.join(workdir, "sharded_eigen_single")
    _single_rank_reference("eigen", write_eigen_case(
        d, SHARDED_EIGEN_N, 3, tol=1e-8, device=SHARDED_DEVICE, verbose=0),
        os.path.join(d, "out"))
    print(f"[30 reference] {SHARDED_EIGEN_N}^3 hex p=3 on one rank: Re f "
          f"{', '.join(f'{v:.9f}' for v in SINGLE_RANK['eigen'])} GHz; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)


def phase_sharded(workdir: str) -> int:
    """Phase 30: SHARDED_RANKS ranks (gloo) on the one card, alone on it,
    through palace_torch.run: the driven slice on the sharded FGMRES + p-MG
    (the ELL fine level; every column's relres <= Tol, the columns and
    domain-E.csv within 10 x Tol of phase 4's single-rank run), the rings
    electrostatic case on the sharded CG (C within 1e-10 of phase 12's)
    and the eigen cavity on the sharded inner solver (eigenvalues within
    1e-8 of phase 6's); no structured kernel launches; then the qdata rows.
    A single-rank reference that no earlier phase of the run left (every
    one when the phase is rehearsed alone; in the full run phase 4, phase
    12 and `phase_sharded_eigen_reference` leave them) is a single-rank run
    of the same config here, before the ranks start.  Returns the structured kernels' launches
    (0)."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    wd = os.path.join(workdir, "sharded")
    os.makedirs(wd)
    on_card = SHARDED_DEVICE == "GPU"
    parts = _sharded_parts(wd, SHARDED_DEVICE)
    with open(os.path.join(wd, "parts.json"), "w") as f:
        json.dump({"device": SHARDED_DEVICE, "parts": parts}, f)
    t0 = time.perf_counter()
    for part, cfg in parts:
        _single_rank_reference(part, cfg, os.path.join(wd, f"{part}_single"))
    t_ref = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = _run_ranks(wd, SHARDED_RANKS)
    t_ranks = time.perf_counter() - t0
    r0 = recs[0]
    with np.load(os.path.join(wd, "rank0.npz")) as d:
        X = d["driven"]
    tol = 1e-8
    d, e, g = r0["driven"], r0["electrostatic"], r0["eigen"]
    Xs, dom_s = SINGLE_RANK["driven"]
    col = max(float(np.linalg.norm(X[:, i] - Xs[:, i])
                    / np.linalg.norm(Xs[:, i])) for i in range(X.shape[1]))
    dom = _rel_diff(_table(os.path.join(d["post_dir"], "domain-E.csv")),
                    dom_s)
    C, Cs = np.asarray(e["C"]), np.asarray(SINGLE_RANK["C"])
    cerr = float((np.abs(C - Cs) / np.abs(Cs)).max())
    f, fs = np.asarray(g["f_ghz"]), np.asarray(SINGLE_RANK["eigen"])
    ferr = float((np.abs(f - fs) / fs).max())
    f101 = C0 / (2 * CAVITY_L * math.sqrt(CAVITY_EPS)) * math.sqrt(2) / 1e9
    f111 = C0 / (2 * CAVITY_L * math.sqrt(CAVITY_EPS)) * math.sqrt(3) / 1e9
    aerr = float((np.abs(f - [f101, f101, f101, f111])
                  / [f101, f101, f101, f111]).max())

    def line(part, extra):
        info = r0[part]["parallel"] or {}
        walls = ", ".join(f"{rec[part]['wall']:.2f}" for rec in recs)
        peaks = ", ".join("not measured" if rec[part]["peak_gib"] is None
                          else f"{rec[part]['peak_gib']:.3f}" for rec in recs)
        coll = ", ".join(f"{rec[part]['collectives']['calls']} in "
                         f"{rec[part]['collectives']['seconds']:.2f} s"
                         for rec in recs)
        print(f"[30 sharded {part}] {info.get('backend')}, n_shards "
              f"{info.get('n_shards')} ({', '.join(info.get('devices', []))})"
              f": {r0[part]['num_dofs']} dofs, interface {info.get('n_ifc')},"
              f" largest interior block {info.get('max_int')}; {extra}; wall "
              f"{walls} s, peak device memory {peaks} GiB and collectives "
              f"{coll} by rank; {r0[part]['durations']}; structured kernel "
              f"launches {[rec[part]['launches'] for rec in recs]}",
              flush=True)

    line("driven", f"{d['fine_level']} fine level, column relres max "
                   f"{max(d['col_relres']):.3e}, columns within {col:.3e} "
                   f"and domain-E within {dom:.3e} of the single rank's")
    line("electrostatic", f"CG iterations {e['cg_iterations']}, relres "
                          f"{e['cg_relres']}; C within {cerr:.3e} of the "
                          "single rank's")
    line("eigen", f"{SHARDED_EIGEN_N}^3 hex p=3, {g['fine_level']} fine "
                  f"level, Re f {', '.join(f'{v:.9f}' for v in f)} GHz, "
                  f"within {ferr:.3e} of the single rank's and "
                  f"{aerr:.3e} of the analytic modes, max backward "
                  f"error {max(g['bkwd']):.3e}, FGMRES iterations "
                  f"{g['ksp_iterations']}")
    total = 0
    for part in ("driven", "electrostatic", "eigen"):
        info = r0[part]["parallel"] or {}
        check(info.get("n_shards") == SHARDED_RANKS
              and info.get("backend") == "gloo" and info.get("n_ifc", 0) > 0,
              f"phase 30 {part}: not sharded over {SHARDED_RANKS} gloo ranks "
              f"({info})")
        for r, rec in enumerate(recs):
            check(rec[part]["launches"] == [0, 0],
                  f"phase 30 {part}: rank {r} launched the structured "
                  f"kernels {rec[part]['launches']} times")
            total += sum(rec[part]["launches"])
    check(d["fine_level"] == "sharded-ell" and d["solver_path"] == "device",
          f"phase 30 driven: {d['fine_level']}, {d['solver_path']}")
    check(len(d["col_relres"]) == 8 and max(d["col_relres"]) <= tol,
          f"phase 30 driven: column relres {d['col_relres']}")
    check(col <= 10 * tol and dom <= 10 * tol,
          f"phase 30 driven against the single rank: columns {col:.3e}, "
          f"domain-E {dom:.3e} (gate {10 * tol:.0e})")
    check(max(e["cg_relres"]) <= 1e-10, f"phase 30 electrostatic: CG relres "
                                        f"{e['cg_relres']}")
    check(cerr <= 1e-10, f"phase 30 electrostatic: C {C.tolist()} against "
                         f"the single rank's {Cs.tolist()}: {cerr:.3e}")
    check(g["eigen_path"] == "device-lanczos"
          and g["fine_level"] == "sharded-ell",
          f"phase 30 eigen: {g['eigen_path']}, {g['fine_level']}")
    check(max(g["bkwd"]) <= tol, f"phase 30 eigen: backward errors "
                                 f"{g['bkwd']}")
    check(ferr <= 1e-8, f"phase 30 eigen: f {f} against the single rank's "
                        f"{fs}: {ferr:.3e}")
    t0 = time.perf_counter()
    rows = _qdata_rows("cuda" if on_card else "cpu")
    for row in rows:
        el, qd = row["element"], row["qdata"]
        print(f"[30 qdata] nd_operator curl + mass on {DRIVEN_N}^3 hexes, "
              f"p={row['p']} (nd = {row['nd']}, {row['dofs']} dofs): qdata "
              f"within {row['rel_err']:.3e} of element mode; element "
              f"{el['ms']:.4f} ms (device {el['device_ms']:.4f} ms, "
              f"{el['gb']:.4f} GB, bound {el['bound_ms']:.4f} ms, "
              f"{el['bound_by']}), qdata {qd['ms']:.4f} ms (device "
              f"{qd['device_ms']:.4f} ms, {qd['gb']:.4f} GB, bound "
              f"{qd['bound_ms']:.4f} ms, {qd['bound_by']})", flush=True)
    lat = r0["latency_ms"]
    print(f"[30 sharded] one psum of 16 float64 over {SHARDED_RANKS} gloo "
          f"ranks: {', '.join(f'{v:.3f} ms ({k})' for k, v in lat.items())}"
          f"; {SHARDED_RANKS} ranks {t_ranks:.1f} s, "
          f"single-rank references run here {t_ref:.1f} s, qdata rows "
          f"{time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def _phases_waveport(workdir: str) -> dict:
    """Phases 14-16, 21 and 26; returns their kernel launches by path."""
    wp, S14 = phase_waveport(workdir)
    wpa = phase_waveport_adaptive(workdir, S14)
    bdr = phase_boundaries(workdir)
    phase_eigen_parity2(workdir)
    cell = phase_floquet_cell(workdir)
    return dict(waveport=wp, waveport_adaptive=wpa, boundaries=bdr,
                floquet_cell=cell)


def _phases_static_eigen(workdir: str) -> dict:
    """Phases 10-13, 17-20, 23, 25, 28 and 29; returns their kernel
    launches by path."""
    phase_waveport_parity(workdir)
    mag = phase_magnetostatic(workdir)
    phase_magnetostatic_reference(workdir)
    es = phase_electrostatic(workdir)
    phase_electrostatic_parity(workdir)
    damped = phase_eigen_damped(workdir)
    nonlinear = phase_eigen_nonlinear(workdir)
    amr = phase_amr(workdir)
    phase_transient_parity(workdir)
    drv = phase_floquet_driven(workdir)
    bm3 = phase_boundarymode_3d(workdir, phase_boundarymode(workdir))
    return dict(magnetostatic=mag, electrostatic=es, eigen_damped=damped,
                eigen_nonlinear=nonlinear, amr=amr, floquet_driven=drv,
                boundarymode=0, boundarymode_3d=bm3)


#: The phase groups that run in processes of their own, by name; phase 12
#: runs in STATIC_GROUP.
STATIC_GROUP = "10-13,17-20,23,25,28,29"
GROUPS = {"14-16,21,26": _phases_waveport,
          STATIC_GROUP: _phases_static_eigen}


def _start_group(name: str, directory: str):
    """Starts the phase group `name` in a process of its own on the same
    card, in `directory` (its output goes to this script's output);
    returns (process, directory)."""
    os.makedirs(directory)
    threads = str(THREADS)
    env = dict(os.environ, OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads,
               OPENBLAS_NUM_THREADS=threads)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             GROUP_FLAG, name, directory], env=env), directory


def _check_groups(groups: dict):
    for name, (proc, _) in groups.items():
        rc = proc.poll()
        check(rc in (None, 0), f"phases {name} failed (exit code {rc})")


def _join_groups(groups: dict) -> dict:
    """Waits for every group; returns their kernel launches by path."""
    paths = {}
    for name, (proc, directory) in groups.items():
        try:
            rc = proc.wait(timeout=max(1.0, DEADLINE_S - (
                time.perf_counter() - T_START)))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"phases {name} still running after "
                               f"{DEADLINE_S:.0f} s")
        check(rc == 0, f"phases {name} failed (exit code {rc})")
        with open(os.path.join(directory, GROUP_RESULT)) as f:
            paths.update(json.load(f))
    return paths


def group_main(name: str, workdir: str) -> int:
    """Entry point of a group's process: its phases in workdir."""
    import ctypes
    import signal

    # Die with the first process, whatever ends it.
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    try:
        import torch

        torch.set_num_threads(THREADS)
        by_path = GROUPS[name](workdir)
    except SmokeFailure as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    with open(os.path.join(workdir, GROUP_RESULT), "w") as f:
        json.dump(by_path, f)
    return 0


def main() -> int:
    try:
        import torch

        card = phase_card()
        phase_build()
        records = phase_kernels()
        with tempfile.TemporaryDirectory() as workdir:
            transient = phase_transient(workdir)
            torch.set_num_threads(THREADS)
            groups = {}
            try:
                for i, name in enumerate(GROUPS):
                    groups[name] = _start_group(
                        name, os.path.join(workdir, f"group{i}"))
                by_path = {"structured_apply_flat": {"eigen": 0},
                           "structured_apply_flat_v2": {"driven": 0,
                                                        "adaptive": 0}}
                by_path["structured_apply_flat"]["driven"] = phase_driven(
                    workdir)
                phase_driven_parity(workdir)
                _check_groups(groups)
                by_path["structured_apply_flat_v2"]["eigen"] = phase_eigen(
                    workdir)
                phase_eigen_parity(workdir)
                phase_sharded_eigen_reference(workdir)
                _check_groups(groups)
                by_path["structured_apply_flat"]["adaptive"] = (
                    phase_adaptive(workdir))
                phase_adaptive_parity(workdir)
                _check_groups(groups)
                floquet_eigen = phase_floquet_eigen(workdir)
                _check_groups(groups)
                two_d = phase_2d(workdir)
                other_paths = _join_groups(groups)
            finally:
                for proc, _ in groups.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            with open(os.path.join(groups[STATIC_GROUP][1], ES_C_FILE)) as f:
                SINGLE_RANK["C"] = json.load(f)
            sharded = phase_sharded(workdir)
            for name in by_path:
                by_path[name].update(transient=transient,
                                     floquet_eigen=floquet_eigen,
                                     two_d=two_d, sharded=sharded,
                                     **other_paths)
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
    if sys.argv[1:2] == [GROUP_FLAG]:
        sys.exit(group_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == [RANK_FLAG]:
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
