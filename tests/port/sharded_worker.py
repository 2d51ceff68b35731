"""One rank of the dof-sharded CPU checks of tests/port/test_torch_sharded.py
(imports torch and palace_torch, never jax).

    python tests/port/sharded_worker.py RANK WORLD STORE CASES OUT STEPS

joins a gloo world of WORLD ranks through the file store STORE and runs the
comma-separated STEPS on the CPU: "applies" and "cg" (the partition's apply
and CG), "tem2" and "tem1" (the sharded solver on the TEM boxes of CASES,
Order 2 and Order 1), "eigen"
(the block-Lanczos eigensolve) and "electrostatic" (`palace_torch.run` into
OUT/es_rank<RANK>).  Rank 0 saves the results and each step's seconds to
OUT/results.npz.  Every rank computes the same global results; rank 0's are
the ones saved.
"""

import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

from palace_torch import parallel  # noqa: E402


def h1_problem(n=5, order=2):
    from palace_torch.fem.h1 import H1Space
    from palace_torch.fem.operators import h1_operator
    from palace_torch.mesh.generate import box_tet
    from palace_torch.mesh.mesh import canonicalize_simplices

    mesh = box_tet(n, n, n)
    canonicalize_simplices(mesh)
    space = H1Space(mesh, order)
    K = h1_operator(space, diffusion_coef={1: np.eye(3)})
    ess = np.zeros(space.num_dofs, bool)
    ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
    return space, K, ess


def nd_problem(n=4, order=2):
    from palace_torch.fem.nd import NDSpace
    from palace_torch.fem.nd_operators import nd_operator
    from palace_torch.mesh.generate import box_tet
    from palace_torch.mesh.mesh import canonicalize_simplices

    mesh = box_tet(n, n, n)
    canonicalize_simplices(mesh)
    space = NDSpace(mesh, order)
    eye = {1: np.eye(3)}
    K = nd_operator(space, curl_coef=eye)
    M = nd_operator(space, mass_coef=eye)
    ess = np.zeros(space.num_dofs, bool)
    ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
    return space, K, M, ess


def _tables(op):
    return ([np.asarray(b.gidx) for b in op.buckets],
            [np.asarray(b.A) for b in op.buckets],
            [b.signs for b in op.buckets])


def sharded_applies(out, **_):
    from palace_torch.parallel import dofsharded as ds

    S, r = parallel.n_shards(), parallel.current().rank
    space, K, ess = h1_problem()
    part = ds.partition_for_space(space, S)
    shop = ds.shard_pa_operator(K, part)
    x = np.random.default_rng(0).standard_normal(space.num_dofs)
    y = shop.apply(torch.ones(1, dtype=torch.float64),
                   torch.as_tensor(part.to_local(x, r)))
    out["h1_apply"] = part.to_global(y, r).numpy()

    space, K, M, _ = nd_problem()
    part = ds.partition_for_space(space, S)
    terms = [part.shard_term(*_tables(op)) for op in (K, M)]
    shop = ds.DofShardedOperator(part, terms, torch.device("cpu"))
    x = np.random.default_rng(1).standard_normal(space.num_dofs)
    y = shop.apply(torch.tensor([1.0, 3.5], dtype=torch.float64),
                   torch.as_tensor(part.to_local(x, r)))
    out["nd_apply"] = part.to_global(y, r).numpy()


def sharded_cg(out, **_):
    from palace_torch.parallel import dofsharded as ds

    space, K, ess = h1_problem()
    b = np.where(ess, 0.0, np.random.default_rng(2).standard_normal(
        space.num_dofs))
    part = ds.partition_for_space(space, parallel.n_shards())
    x, its, relres, _ = ds.solve_spd_sharded(K, b, ess, part=part,
                                             tol=1e-13, max_its=2000)
    out["cg_x"] = x.numpy()
    out["cg_its"] = its
    out["cg_relres"] = relres


def sharded_driven(out, cases, tag, **_):
    from palace_torch.config import IoData, ValueType
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.drivers.driven import driven_samples_ghz
    from palace_torch.linalg.device_ksp_sharded import (
        ShardedBlockedDeviceSolver)
    from palace_torch.models.spaceoperator import SpaceOperator

    iodata = IoData(os.path.join(cases, tag, "case.json"))
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    fs = iodata.units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fs for f in driven_samples_ghz(iodata)]
    lin = iodata.solver.linear
    solver = ShardedBlockedDeviceSolver(
        sop.space, iodata.boundaries.pec, sop.driven_terms(omegas), omegas,
        sop.ess_mask, tol=lin.tol, max_its=lin.max_its)
    ex = next(iter(sop.excitations()))
    rhs = np.stack([1j * w * sop.rhs1(ex) for w in omegas], axis=1)
    X, info = solver.solve(rhs)
    out[f"{tag}_X"] = X
    out[f"{tag}_relres"] = info["relres"]
    out[f"{tag}_its"] = info["iterations"]
    out[f"{tag}_n_ifc"] = solver.part.n_ifc


def sharded_eigen(out, **_):
    from palace_torch.linalg.device_eig import device_shift_invert_eigs

    space, K, M, ess = nd_problem(3, 1)
    res = device_shift_invert_eigs(
        space, [1, 2, 3, 4, 5, 6],
        [(np.asarray(b.gidx), np.asarray(b.A)) for b in K.buckets],
        [(np.asarray(b.gidx), np.asarray(b.A)) for b in M.buckets],
        ess, 25.0, 4, tol=1e-9, n_blocks=4, max_restart=6)
    out["eig_lam"] = np.asarray(res.eigenvalues)
    out["eig_bkwd"] = np.asarray(res.backward_errors)
    out["eig_fine_level"] = device_shift_invert_eigs.last_info["fine_level"]


def electrostatic_run(out, cases, out_dir, rank, **_):
    import palace_torch

    res = palace_torch.run(os.path.join(cases, "es", "case.json"),
                           output_dir=os.path.join(out_dir,
                                                   f"es_rank{rank}"))
    out["es_parallel"] = str(res["provenance"].get("parallel")
                             if isinstance(res, dict) else None)


STEPS = {"applies": sharded_applies, "cg": sharded_cg,
         "tem2": lambda out, **kw: sharded_driven(out, tag="tem2", **kw),
         "tem1": lambda out, **kw: sharded_driven(out, tag="tem1", **kw),
         "eigen": sharded_eigen, "electrostatic": electrostatic_run}


def main(argv):
    rank, world, store, cases, out_dir, steps = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4],
        argv[5].split(","))
    torch.set_num_threads(1)
    parallel.init(rank, world, f"file://{store}", device_type="cpu")
    out = {}
    for name in steps:
        t0 = time.perf_counter()
        STEPS[name](out, cases=cases, out_dir=out_dir, rank=rank)
        out[f"seconds_{name}"] = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **out)
    parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
