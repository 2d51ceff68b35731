"""The tables of the shared structured-apply kernel core
(csrc/structured_apply_core.cuh, read through `core_tables`) on the CPU:
the offset groups and windows, the channels of the y tile, and a numpy walk
of exactly the tables the wrapper passes to the kernel, tile by tile, pass
by pass and n-tile by n-tile in the kernel's order, against both plain
versions
(float64, 1e-13 relative to max |y|) and against palace_tpu's
StructuredNDOperator.__call__ (1e-12).  Also the kernel build cache: a
library's path follows the shared header's text."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.ops.structured import StructuredNDOperator as JaxSOp
from palace_torch.interop import structured_from_numpy
from palace_torch.ops import structured_kernel as sk
from palace_torch.ops.structured import hex_local_map

#: (3, 5, 6) has sx + sy > _MAX_SHIFT: two windows, as the main paths have.
#: p = 4 has 39 n-tiles: the kernel takes them in two passes.
CASES = [(p, shape) for p in (1, 2, 3)
         for shape in ((3, 2, 4), (4, 4, 4), (3, 5, 6))] + [(4, (3, 2, 4))]
LAYOUTS = ("natural", "class")
#: Rows per offset group (offsets 0, 1, sy, sy+1, sx, sx+1, sx+sy).
GROUP_SIZES = {1: [3, 2, 2, 1, 2, 1, 1], 2: [24, 8, 8, 2, 8, 2, 2],
               3: [81, 18, 18, 3, 18, 3, 3], 4: [192, 32, 32, 4, 32, 4, 4]}


def _unpack(p, shape, layout):
    """The kernel's int32 table block split into its named arrays."""
    tables, (nr, ng, nw) = sk.core_tables(p, shape, layout)
    nd, nt = 3 * p * (p + 1) ** 2, nr // 8
    sizes = [("src", nd), ("rowmap", nr), ("ntgroup", nt), ("goff", ng),
             ("gwin", ng), ("gshift", ng), ("woff", nw), ("wspan", nw),
             ("chanrows", sk._MAX_A * 3 * p ** 3)]
    out, i = {}, 0
    for name, n in sizes:
        out[name] = tables[i:i + n].astype(np.int64)
        i += n
    assert i == len(tables)
    out["chanrows"] = out["chanrows"].reshape(-1, sk._MAX_A)
    return out


def _passes(nt):
    """The kernel's passes over nt n-tiles: ceil(nt / _PASS_NT) ranges
    [n0, n1) of equal size."""
    npass = -(-nt // sk._PASS_NT)
    return [(i * nt // npass, (i + 1) * nt // npass) for i in range(npass)]


def _walk(Af, u, p, shape, layout):
    """y = A u as the kernel computes it, in numpy, from its tables: per
    output tile of _TILE columns the active groups' windows; per pass and
    per n-tile of 8 padded rows the product D over the shifted window; then
    each output adds its channel's rows (chanrows, in order) of the pass's
    active groups, each masked by its group's column mask, to what the
    earlier passes wrote.  A tile no group reaches is zeros."""
    tb = _unpack(p, shape, layout)
    _, _, mask, _, Lp, Lu, _ = sk._flat_tables(p, shape)
    B, C, _ = u.shape
    T, nd = sk._TILE, Af.shape[0]
    rowmap = tb["rowmap"]
    Afp = np.zeros((len(rowmap), nd))
    Afp[rowmap >= 0] = Af[rowmap[rowmap >= 0]]
    uf = u.reshape(B, C * Lu)
    y = np.empty_like(u)
    for m0 in range(0, Lu, T):
        q0 = m0 - tb["goff"]
        active = (q0 < Lp) & (q0 + T > 0)
        win = {}
        for w in set(tb["gwin"][active].tolist()):
            q = m0 - tb["woff"][w] + np.arange(T + tb["wspan"][w])
            ok = (q >= 0) & (q < Lp)
            W = np.zeros((B, nd, len(q)))
            W[:, :, ok] = uf[:, tb["src"][:, None] + q[None, ok]]
            win[w] = W
        y[:, :, m0:m0 + T] = 0.0
        if not active.any():
            continue
        q = q0[:, None] + np.arange(T)[None, :]
        msk = np.where((q >= 0) & (q < Lp), mask[np.clip(q, 0, Lp - 1)], 0.0)
        for n0, n1 in _passes(len(tb["ntgroup"])):
            D = np.zeros((B, len(rowmap), T))
            for j in range(n0, n1):
                g = tb["ntgroup"][j]
                if active[g]:
                    s = tb["gshift"][g]
                    D[:, 8 * j:8 * j + 8] = np.einsum(
                        "bkt,nk->bnt", win[tb["gwin"][g]][:, :, s:s + T],
                        Afp[8 * j:8 * j + 8])
            for ch in range(C):
                for r in tb["chanrows"][ch]:
                    if r < 0 or r >= 8 * n1:
                        break
                    g = tb["ntgroup"][r // 8]
                    if r >= 8 * n0 and active[g]:
                        y[:, ch, m0:m0 + T] += msk[g] * D[:, r]
    return y


def _operator(p, shape, layout, seed=0):
    sop = structured_from_numpy(JaxSOp.build_uniform(
        p, shape, 0.25, dtype=jnp.float64, mass=0.7))
    Af = sop.Af if layout == "natural" else sk.v2_tables(sop)[0]
    u = np.random.default_rng(seed).standard_normal(
        (3, 3 * p ** 3, sk.flat_size(p, shape)))
    return np.asarray(Af, np.float64), u


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("p,shape", CASES)
def test_offset_groups_and_windows(p, shape, layout):
    tb = _unpack(p, shape, layout)
    nd = 3 * p * (p + 1) ** 2
    chan, offs = sk._row_geometry(p, shape, layout)
    rowmap = tb["rowmap"]
    # Every local dof lies in exactly one group.
    assert sorted(rowmap[rowmap >= 0].tolist()) == list(range(nd))
    sizes = [int(((tb["ntgroup"] == g)[:, None]
                  & (rowmap.reshape(-1, 8) >= 0)).sum())
             for g in range(len(tb["goff"]))]
    assert sizes == GROUP_SIZES[p]
    assert len(rowmap) % 8 == 0
    nx, ny, nz = shape
    sx, sy = (ny + 1) * (nz + 1), nz + 1
    assert tb["goff"].tolist() == [0, 1, sy, sy + 1, sx, sx + 1, sx + sy]
    for j, g in enumerate(tb["ntgroup"]):
        rows = rowmap[8 * j:8 * j + 8]
        assert (offs[rows[rows >= 0]] == tb["goff"][g]).all()
    # Windows: (0, 1, sy, sy+1) and (sx, sx+1, sx+sy) while the shifts fit.
    assert tb["gwin"].tolist() == ([0] * 7 if sx + sy <= sk._MAX_SHIFT
                                   else [0, 0, 0, 0, 1, 1, 1])
    assert (tb["woff"][tb["gwin"]] - tb["goff"] == tb["gshift"]).all()
    assert tb["gshift"].min() == 0 and tb["gshift"].max() <= sk._MAX_SHIFT
    for w in range(len(tb["woff"])):
        assert tb["wspan"][w] == tb["gshift"][tb["gwin"] == w].max()
    _, _, _, _, _, Lu, _ = sk._flat_tables(p, shape)
    assert (tb["src"] == chan * Lu + offs).all()


@pytest.mark.parametrize("p,passes", [(1, 1), (2, 1), (3, 1), (4, 2),
                                      (6, 5)])
def test_passes_cover_every_n_tile(p, passes):
    """Every order builds its tables; the kernel's passes of at most
    _PASS_NT n-tiles split them into consecutive ranges of equal size."""
    for layout in LAYOUTS:
        _, (nr, _, _) = sk.core_tables(p, (3, 2, 4), layout)
        ranges = _passes(nr // 8)
        assert len(ranges) == passes
        assert ranges[0][0] == 0 and ranges[-1][1] == nr // 8
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [n1 - n0 for n0, n1 in ranges]
        assert max(sizes) <= sk._PASS_NT and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_channels_of_the_y_tile(p, layout):
    shape = (3, 2, 4)
    tb = _unpack(p, shape, layout)
    chan, _ = sk._row_geometry(p, shape, layout)
    rows = tb["chanrows"]
    counts = (rows >= 0).sum(axis=1)
    # Every channel sums between one and _MAX_A rows, listed first, in
    # group order; every padded row of a local dof is listed once, under
    # its own channel.
    assert counts.min() >= 1 and counts.max() == sk._MAX_A
    assert ((rows >= 0) == (np.arange(sk._MAX_A) < counts[:, None])).all()
    groups = np.where(rows >= 0, tb["ntgroup"][rows // 8], -1)
    for c in range(len(rows)):
        assert (np.diff(groups[c, :counts[c]]) > 0).all()
        assert (chan[tb["rowmap"][rows[c, :counts[c]]]] == c).all()
    listed = np.sort(rows[rows >= 0])
    assert np.array_equal(listed, np.flatnonzero(tb["rowmap"] >= 0))
    # The channels are the local dofs' (in the layout's order).
    _, nat = hex_local_map(p)
    if layout == "class":
        nat = np.argsort(sk._class_tables(p, shape)[0])[nat]
    assert np.array_equal(np.sort(chan), np.sort(nat))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("p,shape", CASES)
def test_walk_of_the_tables_equals_plain(p, shape, layout):
    Af, u = _operator(p, shape, layout, seed=p)
    ref = (sk.structured_apply_flat_ref if layout == "natural"
           else sk.structured_apply_flat_v2_ref)
    y_ref = ref(torch.as_tensor(Af), torch.as_tensor(u), p=p,
                shape=shape).numpy()
    y = _walk(Af, u, p, shape, layout)
    assert np.abs(y - y_ref).max() <= 1e-13 * np.abs(y_ref).max()


@pytest.mark.parametrize("p,shape", CASES)
def test_walk_of_the_tables_equals_jax_operator(p, shape):
    jsop = JaxSOp.build_uniform(p, shape, 0.25, dtype=jnp.float64, mass=0.7)
    lat = np.random.default_rng(20 + p).standard_normal(
        (2,) + jsop.lat_gdof.shape)
    y_j = np.asarray(jsop(jnp.asarray(lat)))
    sop = structured_from_numpy(jsop)
    ess = np.asarray(sop.ess_lat)
    free = torch.as_tensor(np.where(ess[None], 0.0, lat))
    Af_perm, perm_c = sk.v2_tables(sop)
    for layout, Af, perm in (
            ("natural", np.asarray(sop.Af), np.arange(len(perm_c))),
            ("class", Af_perm, perm_c)):
        u = sk.to_flat(free[:, perm], p, shape).numpy()
        y = sk.from_flat(torch.as_tensor(_walk(Af, u, p, shape, layout)), p,
                         shape).numpy()[:, np.argsort(perm)]
        y = np.where(ess[None], 0.0, y)
        assert np.abs(y - y_j).max() <= 1e-12 * np.abs(y_j).max(), layout


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(sk.CSRC_DIR, csrc)
    monkeypatch.setattr(sk, "CSRC_DIR", str(csrc))
    sources = sk._sources()
    headers = sk._sources(".cuh")
    assert headers and len(sources) == 2
    before = [sk._library_path(s) for s in sources]
    assert before == [sk._library_path(s) for s in sources]
    with open(headers[0], "a") as f:
        f.write("// edited\n")
    after = [sk._library_path(s) for s in sources]
    assert all(a != b for a, b in zip(after, before))
    assert [os.path.basename(a).split("_")[:-1] for a in after] == [
        os.path.basename(b).split("_")[:-1] for b in before]
    monkeypatch.setattr(sk, "NVCC_FLAGS", sk.NVCC_FLAGS + ["-lineinfo"])
    assert all(sk._library_path(s) != a for s, a in zip(sources, after))
