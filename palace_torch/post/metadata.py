"""palace.json machine-readable run metadata (counterpart of
palace_tpu/post/metadata.py; reference: palace/drivers/basesolver.cpp:290-375
SaveMetadata overloads).  The writers are copied from the JAX package;
`save_timing` records the port's memory snapshot.  Only rank 0 writes."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from palace_torch import __version__ as VERSION
from palace_torch import parallel
from palace_torch.utils import timers


def _load(post_dir: str) -> dict:
    p = os.path.join(post_dir, "palace.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def _write(post_dir: str, meta: dict):
    if not parallel.is_root():
        return
    with open(os.path.join(post_dir, "palace.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
        f.write("\n")


def save_problem(post_dir: str, problem_type: str, mesh_elements: int,
                 dofs: int, mg_dofs: Optional[List[int]] = None):
    meta = _load(post_dir)
    meta.setdefault("Problem", {})
    meta["Problem"]["Version"] = VERSION
    meta["Problem"]["Type"] = problem_type
    meta["Problem"]["MeshElements"] = int(mesh_elements)
    meta["Problem"]["DegreesOfFreedom"] = int(dofs)
    if mg_dofs is not None:
        meta["Problem"]["MultigridDegreesOfFreedom"] = [int(n) for n in mg_dofs]
    _write(post_dir, meta)


def save_solver(post_dir: str, total_solves: int, total_its: int):
    meta = _load(post_dir)
    meta.setdefault("LinearSolver", {})
    meta["LinearSolver"]["TotalSolves"] = int(total_solves)
    meta["LinearSolver"]["TotalIts"] = int(total_its)
    _write(post_dir, meta)


def save_excitations(post_dir: str, excitations: Dict[int, List[int]]):
    meta = _load(post_dir)
    meta["Excitations"] = {str(k): {"LumpedPort": v}
                           for k, v in excitations.items()}
    _write(post_dir, meta)


def save_timing(post_dir: str):
    meta = _load(post_dir)
    rep = timers.GLOBAL.report()
    meta["ElapsedTime"] = {
        "Durations": {k.replace(" ", ""): v["DurationSeconds"]
                      for k, v in rep.items()},
    }
    meta["PeakMemoryGrowthMegabytes"] = {
        k.replace(" ", ""): v.get("MemoryGrowthMB", 0.0)
        for k, v in rep.items() if "MemoryGrowthMB" in v
    }
    meta["MemoryMegabytes"] = timers.memory_stats()
    _write(post_dir, meta)
