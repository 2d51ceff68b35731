"""Dof-sharded solves on torch.distributed ranks (palace_torch/parallel,
palace_torch/linalg/device_ksp_sharded.py) against palace_tpu's sharded
layer on the CPU.

One module fixture starts a 2-rank and a 4-rank gloo world, and a second
2-rank world for the eigensolve, all at once (tests/port/sharded_worker.py,
which imports no jax; each world with a `file://` store of its own), once
per test session even under xdist; the ranks save their results to .npz
files and the tests below assert on them, each after computing its
reference side while the ranks run.
The reference side runs here: palace_tpu's sharded functions on
`make_cells_mesh(S)` over tests/conftest.py's virtual CPU devices, its
sparse-direct sweep and host ARPACK, and the port's single-device
functions.  Case sizes are those of tests/test_dofsharded.py,
tests/test_sharded_driven.py and tests/test_sharded_eigen.py.

Tolerances: partitions and per-shard tables exact; applies and CG solutions
1e-10 x max|x|; driven columns 1e-8 against sparse direct and 1e-10 between
2 and 4 ranks; eigenvalues 1e-8 against ARPACK; terminal-C.csv 1e-11
against a 1-rank run."""

import json
import math
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from palace_tpu.config import IoData, ValueType
from palace_tpu.drivers.common import prepare_mesh
from palace_tpu.drivers.driven import driven_samples_ghz, sweep_uniform_direct
from palace_tpu.fem.h1 import H1Space as JaxH1Space
from palace_tpu.fem.nd import NDSpace as JaxNDSpace
from palace_tpu.fem.nd_operators import nd_operator as jax_nd_operator
from palace_tpu.fem.operators import h1_operator as jax_h1_operator
from palace_tpu.linalg import device_ksp_sharded as jks
from palace_tpu.mesh.generate import box_tet
from palace_tpu.mesh.mesh import canonicalize_simplices
from palace_tpu.models.spaceoperator import SpaceOperator
from palace_tpu.parallel import dofsharded as jds
from palace_torch import parallel
from palace_torch.linalg import device_ksp_sharded as tks
from palace_torch.parallel import dofsharded as tds

HERE = os.path.dirname(os.path.abspath(__file__))
SHARDS = (2, 4)
ETA0 = 376.730313412
WORLD_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# Cases and the worlds
# ---------------------------------------------------------------------------


def _write_cases(root):
    """tests/test_device_ksp.py:_tem_case at Order 2 (3 lossy frequencies)
    and Order 1 (2 frequencies), and tests/test_dofsharded.py's
    electrostatic box, written with the port's jax-free mesh writer."""
    from palace_torch.mesh import gmsh_write
    from palace_torch.mesh.generate import box_tet as t_box_tet

    def write(tag, mesh, cfg):
        d = os.path.join(root, tag)
        os.makedirs(d)
        gmsh_write.write(mesh, os.path.join(d, "box.msh"))
        with open(os.path.join(d, "case.json"), "w") as f:
            json.dump(cfg, f)

    for tag, order, nfreq, lossy in (("tem2", 2, 3, True),
                                     ("tem1", 1, 2, False)):
        mat = {"Attributes": [1], "Permeability": 1.0, "Permittivity": 2.0}
        if lossy:
            mat["LossTan"] = 0.01
        write(tag, t_box_tet(4, 4, 4, lx=10.0, ly=10.0, lz=10.0), {
            "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
            "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
            "Domains": {"Materials": [mat]},
            "Boundaries": {"PEC": {"Attributes": [5, 6]}, "LumpedPort": [
                {"Index": 1, "Attributes": [1], "R": ETA0,
                 "Direction": "+Z", "Excitation": True},
                {"Index": 2, "Attributes": [2], "R": ETA0,
                 "Direction": "+Z"}]},
            "Solver": {"Order": order, "Device": "CPU",
                       "Driven": {"MinFreq": 8.0, "MaxFreq": 8.0 + nfreq - 1,
                                  "FreqStep": 1.0},
                       "Linear": {"Type": "GMG", "Tol": 1e-10,
                                  "MaxIts": 200}}})
    write("es", t_box_tet(4, 4, 4), {
        "Problem": {"Type": "Electrostatic", "Verbose": 0,
                    "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                                   "Permittivity": 2.0}]},
        "Boundaries": {"Ground": {"Attributes": [2]},
                       "Terminal": [{"Index": 1, "Attributes": [1]}]},
        "Solver": {"Order": 2, "Device": "CPU",
                   "Electrostatic": {"Save": 0},
                   "Linear": {"Tol": 1e-13, "MaxIts": 2000}}})


#: name -> (ranks, worker steps); the eigensolve has a world of its own so
#: that it runs beside the others, and the Order 2 driven case runs on 2
#: ranks only (the 4-rank world holds the Order 1 case, as palace_tpu's
#: shard-count test does).
WORLDS = {"w2": (2, "applies,cg,tem1,tem2,electrostatic"),
          "w4": (4, "applies,cg,tem1"),
          "eig": (2, "eigen")}


def _start_worlds(root):
    """Starts every world; returns [(process, log, out dir, rank)]."""
    cases = os.path.join(root, "cases")
    _write_cases(cases)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    procs = []
    for name, (S, steps) in WORLDS.items():
        out = os.path.join(root, name)
        os.makedirs(out)
        for r in range(S):
            log = open(os.path.join(out, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.join(HERE, "sharded_worker.py"),
                 str(r), str(S), os.path.join(out, "store"), cases, out,
                 steps], env=env, stdout=log, stderr=subprocess.STDOUT),
                log, out, r))
    return procs


def _join_worlds(procs):
    """Waits for every rank; raises with the logs of those that failed."""
    failed = []
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for proc, log, out, r in procs:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        log.close()
        if rc != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                failed.append(f"{out} rank {r}: {rc}\n{f.read()[-3000:]}")
    for proc, *_ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


class Worlds:
    """The worlds' results, waited for on first use, so that the reference
    side of a test runs while the ranks do.  Under xdist the first worker to
    start them runs them in a directory all workers of the session share;
    the others wait for its marker."""

    def __init__(self, tmp_path_factory):
        uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
        if uid:
            self.root = str(tmp_path_factory.getbasetemp().parent
                            / f"sharded-{uid}")
            os.makedirs(self.root, exist_ok=True)
        else:
            self.root = str(tmp_path_factory.mktemp("sharded"))
        self._done = os.path.join(self.root, "done")
        self._fail = os.path.join(self.root, "failed")
        self._procs = None
        self._results = None
        try:
            os.mkdir(os.path.join(self.root, "lock"))
        except FileExistsError:
            return
        self._procs = _start_worlds(self.root)

    def _wait(self):
        if self._procs is not None:
            procs, self._procs = self._procs, None
            try:
                _join_worlds(procs)
            except Exception as e:
                with open(self._fail, "w") as f:
                    f.write(str(e))
                raise
            open(self._done, "w").close()
        deadline = time.monotonic() + 2 * WORLD_TIMEOUT_S
        while not (os.path.exists(self._done) or os.path.exists(self._fail)):
            if time.monotonic() > deadline:
                raise RuntimeError("the sharded worlds did not finish")
            time.sleep(0.5)
        if os.path.exists(self._fail):
            with open(self._fail) as f:
                raise RuntimeError(f.read())

    def __getitem__(self, name: str) -> dict:
        if self._results is None:
            self._wait()
            self._results = {}
            for n in WORLDS:
                with np.load(os.path.join(self.root, n, "results.npz")) as d:
                    self._results[n] = {k: d[k] for k in d.files}
        return self._results[name]

    def close(self):
        """Stops ranks that no test waited for."""
        if self._procs is not None:
            for proc, log, *_ in self._procs:
                proc.kill()
                proc.wait()
                log.close()


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """Started before the module's first test, waited for on first use."""
    w = Worlds(tmp_path_factory)
    yield w
    w.close()


# ---------------------------------------------------------------------------
# Reference problems (palace_tpu and the port's single device)
# ---------------------------------------------------------------------------


def _jax_h1():
    mesh = box_tet(5, 5, 5)
    canonicalize_simplices(mesh)
    space = JaxH1Space(mesh, 2)
    K = jax_h1_operator(space, diffusion_coef={1: np.eye(3)})
    ess = np.zeros(space.num_dofs, bool)
    ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
    return space, K, ess


def _jax_nd(n=4, order=2):
    mesh = box_tet(n, n, n)
    canonicalize_simplices(mesh)
    space = JaxNDSpace(mesh, order)
    eye = {1: np.eye(3)}
    K = jax_nd_operator(space, curl_coef=eye)
    M = jax_nd_operator(space, mass_coef=eye)
    ess = np.zeros(space.num_dofs, bool)
    ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
    return space, K, M, ess


def _torch_problems():
    sys.path.insert(0, HERE)
    try:
        import sharded_worker
    finally:
        sys.path.remove(HERE)
    return sharded_worker


def _local(part, x, r):
    """palace_tpu's partition, rank r's local rows of global x."""
    rows = np.concatenate([part.int_global[r], part.ifc_global])
    out = x[np.clip(rows, 0, None)]
    out[rows < 0] = 0
    return out


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


# ---------------------------------------------------------------------------
# The layer's pieces, no ranks needed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("kind", ["h1", "nd"])
def test_partition_matches_jax(kind, S):
    """DofPartition.build and shard_term give palace_tpu's arrays exactly."""
    w = _torch_problems()
    if kind == "h1":
        tspace, tK, _ = w.h1_problem()
        jspace, jK, _ = _jax_h1()
    else:
        tspace, tK, _, _ = w.nd_problem()
        jspace, jK, _, _ = _jax_nd()
    tp = tds.partition_for_space(tspace, S)
    jp = jds.partition_for_space(jspace, S)
    assert (tp.max_int, tp.n_ifc) == (jp.max_int, jp.n_ifc)
    for name in ("int_global", "int_valid", "ifc_global", "local_maps"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    for a, b in zip(tp.shard_of, jp.shard_of):
        assert np.array_equal(a, b)
    tt = tp.shard_term(*w._tables(tK))
    jt = jp.shard_term([np.asarray(b.gidx) for b in jK.buckets],
                       [np.asarray(b.A) for b in jK.buckets],
                       [b.signs for b in jK.buckets])
    for a, b in zip(tt.gidx + tt.A, jt.gidx + jt.A):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("S", SHARDS)
def test_shard_ell_matches_jax(tmp_path, S):
    """Every nonzero of the driven fine term, the discrete gradient and the
    level-1 transfer goes to palace_tpu's shard and slot; the union-pattern
    tables of the term apply reproduce each term's."""
    from palace_tpu.fem.h1 import H1Space
    from palace_tpu.fem.nd import NDSpace
    from palace_tpu.fem.nd_operators import nd_h1_gradient
    from palace_tpu.linalg.ndmg import nd_prolongation

    _write_cases(str(tmp_path))
    iodata = IoData(str(tmp_path / "tem2" / "case.json"))
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    space = sop.space
    terms = sop.driven_terms([1.0])
    csrs = [t.csr(space.num_dofs) for t in terms]
    part = jks.partition_from_space(space, S)
    h1 = H1Space(space.mesh, space.order)
    ph = jks.partition_from_space(h1, S)
    maps = [(csrs[0], part, part), (nd_h1_gradient(space, h1), part, ph),
            (nd_prolongation(NDSpace(space.mesh, 1), space), part, None)]
    for A, rp, cp in maps:
        jc, jv, R, C = jks._shard_ell(A, rp, cp, S)
        tc, tv, tR, tC = tks._shard_ell(A, rp, cp, S)
        assert (tR, tC) == (R, C)
        assert np.array_equal(tc, np.asarray(jc))
        assert np.array_equal(tv, np.asarray(jv))
        c1, v1, _, _ = tks._shard_ell(A, rp, cp, S, shard=S - 1)
        k = c1.shape[1]
        assert np.array_equal(c1, tc[S - 1][:, :k])
        assert not np.asarray(jv)[S - 1][:, k:].any()
    x = np.random.default_rng(5).standard_normal(space.num_dofs)
    for r in range(S):
        cols, vals = tks._union_ell(csrs, part, S, r)
        for t, A in enumerate(csrs):
            c, v, _, _ = tks._shard_ell(A, part, part, S, shard=r)
            xl = _local(part, x, r)
            y_union = np.einsum("rk,rk->r", vals[t], xl[cols])
            y_term = np.einsum("rk,rk->r", v, xl[c])
            assert _close(y_union, y_term, 1e-13)


@pytest.mark.parametrize("S", SHARDS)
def test_local_layout_matches_jax_scatter(S):
    """A rank's local rows ([interior | interface], zero padding) are
    palace_tpu's scattered layout of that shard, through the port's copies
    of `scatter_cols` / `gather_cols` and `scatter_vector`."""
    w = _torch_problems()
    space, _, _ = w.h1_problem()
    part = tds.partition_for_space(space, S)
    x = np.random.default_rng(6).standard_normal((space.num_dofs, 3))
    xi, xf = tks.scatter_cols(part, x)
    ji, jf = jks.scatter_cols(jds.partition_for_space(_jax_h1()[0], S), x)
    assert np.array_equal(xi, ji) and np.array_equal(xf, jf)
    assert np.array_equal(tks.gather_cols(part, xi, xf), x)
    vi, vf = part.scatter_vector(x[:, 0])
    for r in range(S):
        loc = part.to_local(x, r)
        assert np.array_equal(loc, np.concatenate([xi[r], xf]))
        assert np.array_equal(loc[:, 0], np.concatenate([vi[r], vf]))


def test_backend_rule():
    """nccl only when every rank has a card of its own; gloo on the CPU or
    when ranks share a card; ranks take cards round-robin."""
    assert parallel.backend_for("cuda", 4, 4) == "nccl"
    assert parallel.backend_for("cuda", 2, 1) == "gloo"
    assert parallel.backend_for("cpu", 2, 8) == "gloo"
    assert str(parallel.device_for("cuda", 3, 4)) == "cuda:3"
    assert str(parallel.device_for("cuda", 1, 1)) == "cuda:0"
    assert str(parallel.device_for("cpu", 1, 0)) == "cpu"
    assert parallel.n_shards() == 1 and parallel.is_root()
    t = np.arange(3.0)
    assert parallel.psum(t) is t


# ---------------------------------------------------------------------------
# The ranks' results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_applies(worlds, S):
    """The sharded H1 apply and the two-term ND apply K + 3.5 M against
    palace_tpu's sharded operators and the port's single-device ones."""
    w = _torch_problems()
    dmesh = jds.make_cells_mesh(S)
    jspace, jK, _ = _jax_h1()
    part = jds.partition_for_space(jspace, S)
    shop = jds.shard_pa_operator(jK, part, dmesh)
    x = np.random.default_rng(0).standard_normal(jspace.num_dofs)
    yi, yf = shop.apply(jnp.ones((1,)), *shop.put_vector(
        *part.scatter_vector(x)))
    y_jax = part.gather_vector(np.asarray(yi), np.asarray(yf))
    y_port = w.h1_problem()[1](x).numpy()
    h1 = (y_jax, y_port)

    jspace, jK, jM, _ = _jax_nd()
    part = jds.partition_for_space(jspace, S)
    terms = [part.shard_term([np.asarray(b.gidx) for b in op.buckets],
                             [np.asarray(b.A) for b in op.buckets],
                             [b.signs for b in op.buckets])
             for op in (jK, jM)]
    shop = jds.DofShardedOperator(part, terms, dmesh).device_put_tables()
    x = np.random.default_rng(1).standard_normal(jspace.num_dofs)
    yi, yf = shop.apply(jnp.asarray([1.0, 3.5]), *shop.put_vector(
        *part.scatter_vector(x)))
    y_jax = part.gather_vector(np.asarray(yi), np.asarray(yf))
    _, tK, tM, _ = w.nd_problem()
    y_port = tK(x).numpy() + 3.5 * tM(x).numpy()
    res = worlds[f"w{S}"]
    for y_ref in h1:
        assert _close(res["h1_apply"], y_ref, 1e-10)
    assert _close(res["nd_apply"], y_jax, 1e-10)
    assert _close(res["nd_apply"], y_port, 1e-10)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_cg(worlds, S):
    """The sharded Jacobi-CG against palace_tpu's `solve_spd_sharded` (the
    same iteration count) and the port's single-device CG."""
    import torch

    from palace_torch.linalg.iterative import cg
    from palace_torch.linalg.smoothers import jacobi
    from palace_torch.ops.partial import EliminatedOperator

    jspace, jK, ess = _jax_h1()
    b = np.where(ess, 0.0, np.random.default_rng(2).standard_normal(
        jspace.num_dofs))
    x_jax, its, relres, _ = jds.solve_spd_sharded(
        jK, b, ess, part=jds.partition_for_space(jspace, S),
        mesh=jds.make_cells_mesh(S), tol=1e-13, max_its=2000)
    _, tK, _ = _torch_problems().h1_problem()
    mask = torch.as_tensor(ess)
    ref = cg(EliminatedOperator(tK, ess), torch.as_tensor(b),
             M=jacobi(tK.diagonal(), mask), tol=1e-13, max_its=2000)
    res = worlds[f"w{S}"]
    assert res["cg_relres"] < 1e-12
    assert int(res["cg_its"]) == its
    scale = np.abs(x_jax).max()
    assert np.abs(res["cg_x"] - x_jax).max() < 1e-10 * scale
    assert np.abs(res["cg_x"] - ref.x.numpy()).max() < 1e-10 * scale


def _direct(root, tag):
    iodata = IoData(os.path.join(root, "cases", tag, "case.json"))
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    fs = iodata.units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fs for f in driven_samples_ghz(iodata)]
    ex = next(iter(sop.excitations()))
    sols = sweep_uniform_direct(iodata, sop, omegas, sop.excitations())
    return np.stack([sols[(ex, i)] for i in range(len(omegas))], axis=1)


@pytest.mark.parametrize("tag,S", [("tem2", 2), ("tem1", 2), ("tem1", 4)])
def test_sharded_driven_matches_direct(worlds, tag, S):
    """The sharded FGMRES + p-MG sweep (Order 2: two levels; Order 1: the
    one-level cycle around a direct correction) against palace_tpu's
    sparse-direct sweep, column by column."""
    X_d = _direct(worlds.root, tag)
    res = worlds[f"w{S}"]
    X = res[f"{tag}_X"]
    assert (res[f"{tag}_relres"] < 1e-9).all()
    assert int(res[f"{tag}_n_ifc"]) > 0
    for i in range(X.shape[1]):
        rel = np.linalg.norm(X[:, i] - X_d[:, i]) / np.linalg.norm(X_d[:, i])
        assert rel < 1e-8, (i, rel)


def test_shard_count_invariance(worlds):
    """2 and 4 ranks take the same Krylov iterations and agree to 1e-10 on
    the Order 1 box (tests/test_sharded_driven.py:67)."""
    tag = "tem1"
    a, b = worlds["w2"], worlds["w4"]
    assert np.array_equal(a[f"{tag}_its"], b[f"{tag}_its"])
    rel = (np.linalg.norm(a[f"{tag}_X"] - b[f"{tag}_X"])
           / np.linalg.norm(a[f"{tag}_X"]))
    assert rel < 1e-10, rel


def test_sharded_eigen_matches_arpack(worlds):
    """Block Lanczos on the sharded inner solver against host ARPACK: the
    4 eigenvalues nearest sigma to 1e-8 (tests/test_sharded_eigen.py)."""
    from palace_tpu.linalg.eig import shift_invert_eigs

    _, K, M, ess = _jax_nd(3, 1)
    sigma = 25.0
    host = shift_invert_eigs(K.assemble_csr().tocsr(),
                             M.assemble_csr().tocsr(), np.where(ess)[0],
                             sigma, 8, tol=1e-10)
    res = worlds["eig"]
    lam_d = np.real(res["eig_lam"])
    lam_d = np.sort(lam_d[np.argsort(np.abs(lam_d - sigma))[:4]])
    lam_h = np.real(host.eigenvalues)
    lam_h = np.sort(lam_h[np.argsort(np.abs(lam_h - sigma))[:4]])
    assert (np.abs(lam_d - lam_h) / np.abs(lam_h) < 1e-8).all()
    assert (res["eig_bkwd"][:4] < 1e-8).all()
    assert str(res["eig_fine_level"]) == "sharded-ell"


def test_two_rank_electrostatic_run(worlds, tmp_path):
    """`palace_torch.run` on 2 ranks: the sharded CG's terminal-C.csv
    against a 1-rank run to 1e-11, written by rank 0 alone."""
    import palace_torch

    root = worlds.root
    palace_torch.run(os.path.join(root, "cases", "es", "case.json"),
                     output_dir=str(tmp_path / "one"))
    info = str(worlds["w2"]["es_parallel"])
    assert not os.path.exists(os.path.join(root, "w2", "es_rank1"))

    def values(path):
        with open(os.path.join(path, "terminal-C.csv")) as f:
            return [float(v) for v in f.read().splitlines()[1].split(",")[1:]]

    np.testing.assert_allclose(values(os.path.join(root, "w2", "es_rank0")),
                               values(str(tmp_path / "one")), rtol=1e-11)
    assert "'backend': 'gloo'" in info and "'n_shards': 2" in info
    assert "'max_int'" in info  # the static solve took the sharded CG
