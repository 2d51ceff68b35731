"""One cell's run of palace_torch: set-up, the warm-up request, the window.

This is the program's contract with the benchmark, the steps of one block
of `drivers/driven.py` (`_solve_on_mesh` with `sweep_uniform_device`):

set-up: the benchmark writes the mesh and the config; `IoData`,
`prepare_mesh`, `SpaceOperator`, then `BlockedDeviceSolver` with the
arguments `sweep_uniform_device` passes (the block width `max_block` the
traffic's `freqs_per_request`, 8 as the uniform sweep; no frequency yet);

a request: `add_omega` for each of its frequencies; `sop.rhs1` and `_rhs`;
one `solve` over the block with its `omega_idx`; per column `measure_step`
(ports, energies) and the indicators (`curl_flux_indicators` /
omega^2 + `grad_flux_indicators`).  Nothing is written to disk.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from harness.meshgen import BoxMesh, box_hex, write_msh
from harness.spans import Spans


@dataclass
class Request:
    t0: float
    t1: float
    freqs_ghz: List[float]
    iterations: List[int] = field(default_factory=list)
    relres: List[float] = field(default_factory=list)
    columns: List[dict] = field(default_factory=list)
    error: Optional[str] = None


class Session:
    def __init__(self, config: dict, traffic: dict, workdir: str, device,
                 spans: Spans):
        self.config = config
        self.traffic = traffic
        self.workdir = workdir
        self.device = device
        self.spans = spans
        self.mesh: Optional[BoxMesh] = None

    # -- set-up ---------------------------------------------------------------

    def write_inputs(self) -> str:
        m = self.config["mesh"]
        self.mesh = box_hex(m["cells"], m["size"])
        pal = json.loads(json.dumps(self.config["palace"]))
        write_msh(self.mesh, os.path.join(self.workdir,
                                          pal["Model"]["Mesh"]))
        path = os.path.join(self.workdir, "config.json")
        with open(path, "w") as f:
            json.dump(pal, f)
        return path

    def setup(self) -> None:
        from palace_torch.config import IoData
        from palace_torch.drivers.common import prepare_mesh
        from palace_torch.fem.operators import QuadraturePolicy
        from palace_torch.linalg.device_ksp import BlockedDeviceSolver
        from palace_torch.models.spaceoperator import SpaceOperator
        from palace_torch.utils import provenance, timers

        sp = self.spans
        with sp("inputs"):
            path = self.write_inputs()
            iodata = IoData(path)
            QuadraturePolicy.set(iodata.solver.quadrature_order_jac,
                                 iodata.solver.quadrature_order_extra)
            timers.reset()
            provenance.reset()
            mesh = prepare_mesh(iodata)
        with sp("assembly"):
            sop = SpaceOperator(iodata, mesh, device=self.device)
        lin = iodata.solver.linear
        kw = dict(tol=lin.tol, max_its=lin.max_its,
                  restart=(lin.max_size if lin.max_size > 0 else 30),
                  smooth_order=(lin.mg_smooth_order
                                if lin.mg_smooth_order > 0 else 4),
                  smooth_its=lin.mg_smooth_its, use_aux=lin.mg_use_aux,
                  coarsening=lin.mg_coarsening, max_levels=lin.mg_max_levels,
                  max_block=int(self.traffic["freqs_per_request"]),
                  device=sop.device)
        with sp("hierarchy"):
            self.solver = BlockedDeviceSolver(
                sop.space, iodata.boundaries.pec, sop.driven_terms([]), [],
                sop.ess_mask, **kw)
        self.iodata, self.sop = iodata, sop
        self.excitation = next(iter(sop.excitations()))
        self.gate = 10.0 * max(lin.tol, 1e-12)
        self._port_fn: Dict = {}

    def omega(self, f_ghz: float) -> float:
        from palace_torch.config import ValueType

        return 2 * math.pi * f_ghz / self.iodata.units.scale_factor(
            ValueType.FREQUENCY)

    def port_fn(self, idx):
        if idx not in self._port_fn:
            self._port_fn[idx] = self.sop.port_functionals(idx)
        return self._port_fn[idx]

    # -- a request ------------------------------------------------------------

    def request(self, freqs_ghz: List[float], keep: bool) -> Request:
        from palace_torch.drivers.driven import _rhs, measure_step
        from palace_torch.fem.estimators import (curl_flux_indicators,
                                                 grad_flux_indicators)

        sp, sop, solver, ex = self.spans, self.sop, self.solver, \
            self.excitation
        req = Request(time.perf_counter(), 0.0, list(freqs_ghz))
        F = len(freqs_ghz)
        with sp("request", n=F):
            ws = [self.omega(f) for f in freqs_ghz]
            with sp("freq_setup", n=F):
                idx = [solver.add_omega(w) for w in ws]
            with sp("rhs", n=F):
                rhs1 = sop.rhs1(ex)
                rhs = np.stack([_rhs(sop, ex, w, rhs1) for w in ws], axis=1)
            with sp("krylov", n=F):
                X, info = solver.solve(rhs, omega_idx=idx)
            req.iterations = [int(i) for i in info["iterations"]]
            req.relres = [float(r) for r in info["relres"]]
            with sp("post", n=F):
                for c, (f, w) in enumerate(zip(freqs_ghz, ws)):
                    E = X[:, c]
                    m = measure_step(sop, E, w, ex, self.port_fn)
                    curl_flux_indicators(sop.space, sop.materials, E,
                                         device=self.device)
                    grad_flux_indicators(sop.space, sop.materials, E,
                                         device=self.device)
                    col = dict(f_ghz=f, energies=(m.E_elec, m.E_mag),
                               S={i: pm.S for i, pm in m.ports.items()})
                    if keep:
                        col["x"] = E
                    req.columns.append(col)
        req.t1 = time.perf_counter()
        return req

    def failed(self, req: Request) -> bool:
        return req.error is not None or any(r > self.gate for r in req.relres)

    # -- what the comparison reads --------------------------------------------

    def program_outputs(self, requests: List[Request]) -> dict:
        """The operators the program assembled, its load and port terms at
        the window's first frequency, and the window's solution columns
        with the energies and S-parameters it measured."""
        from palace_torch.drivers.driven import _rhs

        sop = self.sop
        cols = [c for r in requests for c in r.columns]
        f0 = cols[0]["f_ghz"] if cols else requests[0].freqs_ghz[0]
        w0 = self.omega(f0)
        return dict(K=sop.stiffness_csr(), M=sop.mass_csr(), f_ghz=f0,
                    b=_rhs(sop, self.excitation, w0), A2=sop.a2_csr(w0),
                    columns=cols)

    def close(self) -> None:
        for name in ("solver", "sop", "iodata"):
            if hasattr(self, name):
                delattr(self, name)
