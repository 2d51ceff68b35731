"""Uniform box-hex ND apply on the flattened padded lattice: the two
hand-written Hopper kernels (csrc/structured_apply.cu, natural channel
order; csrc/structured_apply_v2.cu, carry-class channel order; both thin
entry points of the shared float64 tensor-core core
csrc/structured_apply_core.cuh), their tables (`core_tables`), their plain
PyTorch versions, and the flat layout helpers.

The counterpart of palace_tpu/ops/pallas_structured.py (`_flat_tables`,
`_class_tables`, `structured_apply_flat`, `structured_apply_flat_v2`,
`v2_tables`, `to_flat`, `from_flat`, `structured_apply_lattice`,
`structured_apply_lattice_v2`).  On the flattened padded lattice
(C, (nx+1)(ny+1)(nz+1)) a cell shift by delta in {0,1}^3 is a constant flat
offset, so "u at (chan_b, n + delta_b) for all cells n" is one contiguous
slice u_flat[chan_b, off_b : off_b + Lp]; a per-column mask kills the
pad-plane columns, which are not real cells.

`structured_apply_flat` and `structured_apply_flat_v2` are the wrappers: a
CPU tensor goes to the plain version (`*_ref`); a CUDA tensor launches the
kernel (built with nvcc on first use into build/palace_torch_kernels/ and
bound through ctypes) or raises.  Each wrapper's `launches` attribute counts
its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "palace_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_A = 4  # local dofs per channel: contributions an output sums (kMaxA)
_TILE = 64  # output columns per CTA (kTile in the core)
_PASS_NT = 24  # n-tiles of 8 rows in one pass (kPassNt in the core)
_MAX_SHIFT = 32  # a window's largest shift (kMaxShift in the core)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=None)
def _flat_tables(p: int, shape: Tuple[int, int, int]):
    """Static tables: per local dof the (channel, flat offset), plus the
    real-cell column mask and layout sizes (same layout as the TPU kernel)."""
    from palace_torch.ops.structured import hex_local_map

    nx, ny, nz = shape
    sx, sy, sz = (ny + 1) * (nz + 1), nz + 1, 1
    deltas, chan = hex_local_map(p)
    offs = deltas[:, 0] * sx + deltas[:, 1] * sy + deltas[:, 2] * sz
    # Columns [0, L0) cover all cells (plus interleaved pad-plane columns).
    L0 = (nx - 1) * sx + (ny - 1) * sy + (nz - 1) + 1
    Lp = _round_up(L0, 128)
    Lu = _round_up(Lp + int(offs.max()), 128) + 128
    m = np.arange(Lp)
    x, r = np.divmod(m, sx)
    y, z = np.divmod(r, sy)
    mask = ((m < L0) & (x < nx) & (y < ny) & (z < nz)).astype(np.float64)
    return chan, offs, mask, L0, Lp, Lu, (sx, sy, sz)


def flat_size(p: int, shape: Tuple[int, int, int]) -> int:
    """Lu, the padded flat length of one channel."""
    return _flat_tables(p, tuple(shape))[5]


def to_flat(lat: torch.Tensor, p: int, shape) -> torch.Tensor:
    """(B, C, nx, ny, nz) lattice -> (B, C, Lu) flat padded layout."""
    Lu = flat_size(p, shape)
    pad = F.pad(lat, (0, 1, 0, 1, 0, 1))
    B, C = lat.shape[:2]
    flat = pad.reshape(B, C, -1)
    return F.pad(flat, (0, Lu - flat.shape[2])).contiguous()


def from_flat(flat: torch.Tensor, p: int, shape) -> torch.Tensor:
    """(B, C, Lu) flat padded layout -> (B, C, nx, ny, nz) lattice."""
    nx, ny, nz = shape
    B, C = flat.shape[:2]
    full = (nx + 1) * (ny + 1) * (nz + 1)
    pad = flat[:, :, :full].reshape(B, C, nx + 1, ny + 1, nz + 1)
    return pad[:, :, :nx, :ny, :nz]


def _check(Af: torch.Tensor, u_flat: torch.Tensor, p: int, shape) -> None:
    _, _, _, _, _, Lu, _ = _flat_tables(p, tuple(shape))
    nd = 3 * p * (p + 1) ** 2
    C = 3 * p ** 3
    if u_flat.dim() != 3 or u_flat.shape[1:] != (C, Lu):
        raise ValueError(f"u_flat must be (B, {C}, {Lu}) for p={p}, "
                         f"shape={tuple(shape)}; got {tuple(u_flat.shape)}")
    if Af.shape != (nd, nd):
        raise ValueError(f"Af must be ({nd}, {nd}); got {tuple(Af.shape)}")
    if Af.dtype != u_flat.dtype or Af.device != u_flat.device:
        raise ValueError("Af and u_flat must share dtype and device")


@functools.lru_cache(maxsize=None)
def _gather_index(p: int, shape: Tuple[int, int, int],
                  device: torch.device) -> torch.Tensor:
    """Flat (nd * Lp) index into a (C * Lu) row of u_flat: local dof n,
    column m reads u[chan[n], offs[n] + m]."""
    chan, offs, _, _, Lp, Lu, _ = _flat_tables(p, shape)
    src = np.asarray(chan, np.int64) * Lu + np.asarray(offs, np.int64)
    return torch.as_tensor((src[:, None] + np.arange(Lp)[None, :]).ravel(),
                           device=device)


def structured_apply_flat_ref(Af: torch.Tensor, u_flat: torch.Tensor, *,
                              p: int, shape) -> torch.Tensor:
    """Plain PyTorch version: gather by local dof, Af @ ul, mask,
    scatter-add in local-dof order (the arithmetic of the TPU kernel body,
    in any dtype and device)."""
    shape = tuple(shape)
    _check(Af, u_flat, p, shape)
    _, _, mask, _, Lp, _, _ = _flat_tables(p, shape)
    idx = _gather_index(p, shape, u_flat.device)
    B, C, Lu = u_flat.shape
    nd = Af.shape[0]
    ul = u_flat.reshape(B, C * Lu).index_select(1, idx).reshape(B, nd, Lp)
    vl = torch.matmul(Af, ul) * torch.as_tensor(mask, dtype=u_flat.dtype,
                                               device=u_flat.device)
    y = torch.zeros((B, C * Lu), dtype=u_flat.dtype, device=u_flat.device)
    y.index_add_(1, idx, vl.reshape(B, nd * Lp))
    return y.reshape(B, C, Lu)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(ext: str = ".cu"):
    return sorted(os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR)
                  if n.endswith(ext))


def _library_path(source: str) -> str:
    """build/.../lib<stem>_<hash>.so, the hash taken over the source, every
    csrc/*.cuh header and the compiler flags, so that editing a shared
    header rebuilds every library."""
    digest = hashlib.sha256()
    for path in [source, *_sources(".cuh")]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build_kernels() -> List[Tuple[str, str]]:
    """Compile every csrc/*.cu into its own shared library under
    build/palace_torch_kernels/ (once per source content), one nvcc process
    per source, all started together.  Returns [(library path, compiler log;
    empty when the library was already built)] in source order."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in _sources():
        out = _library_path(src)
        if os.path.exists(out):
            jobs.append((out, None, None))
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((out, tmp, proc))
    built, failed = [], []
    for out, tmp, proc in jobs:
        if proc is None:
            built.append((out, ""))
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for "
                          f"{os.path.basename(out)}:\n{log}")
            continue
        os.replace(tmp, out)
        built.append((out, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


#: The source of each layout's entry points palace_<stem>_{f64,f32}, which
#: take (Af, u, mask, y, tables, B, C, nd, Lp, Lu, nr, ng, nw, stream).
_STEM = {"natural": "structured_apply", "class": "structured_apply_v2"}
_ENTRY_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library(stem: str) -> ctypes.CDLL:
    """The built library of csrc/<stem>.cu (every source is built on the
    first call), with its entry points' ctypes signatures set."""
    build_kernels()
    lib = ctypes.CDLL(_library_path(os.path.join(CSRC_DIR, f"{stem}.cu")))
    for dtype in ("f64", "f32"):
        fn = getattr(lib, f"palace_{stem}_{dtype}")
        fn.argtypes = _ENTRY_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_launchable(Af: torch.Tensor, u_flat: torch.Tensor, p: int,
                      shape) -> None:
    """Raise unless a kernel can take these tensors: CUDA, float64 or
    float32, contiguous, of the layout's shapes."""
    if u_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {u_flat.device}")
    _check(Af, u_flat, p, shape)
    if u_flat.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"kernel takes float64 or float32, not {u_flat.dtype}")
    if not (Af.is_contiguous() and u_flat.is_contiguous()):
        raise ValueError("Af and u_flat must be contiguous")


def _on_device(device: torch.device, *pairs):
    return tuple(torch.as_tensor(a, dtype=dt, device=device).contiguous()
                 for a, dt in pairs)


def _row_geometry(p: int, shape: Tuple[int, int, int], layout: str):
    """(chan, off): per row of the layout's element matrix (Af for
    "natural", Af_perm for "class"), its lattice channel and flat offset."""
    if layout == "natural":
        chan, offs, _, _, _, _, _ = _flat_tables(p, shape)
        return np.asarray(chan, np.int64), np.asarray(offs, np.int64)
    _, _, slices = _class_tables(p, shape)
    chan = [c0 + i for (_, nr, c0, _) in slices for i in range(nr)]
    offs = [off for (_, nr, _, off) in slices for _ in range(nr)]
    return np.asarray(chan, np.int64), np.asarray(offs, np.int64)


@functools.lru_cache(maxsize=None)
def core_tables(p: int, shape: Tuple[int, int, int], layout: str):
    """The tables of the shared kernel core (csrc/structured_apply_core.cuh)
    for one layout, as it reads them.  Returns (tables, (nr, ng, nw)):
    `tables` is the int32 block [src | rowmap | ntgroup | goff | gwin |
    gshift | woff | wspan | chanrows] (see the core's `Params`):

    - groups: the rows' distinct flat offsets, ascending; each group's rows
      in Af's row order, padded with -1 to a multiple of 8 (nr rows in
      all), in n-tiles of 8 rows;
    - windows: consecutive groups whose offsets lie within _MAX_SHIFT of
      the first share one window at the last one's offset e (offsets 0, 1,
      sy, sy + 1 and sx, sx + 1, sx + sy while nz <= 30); a group
      reads it shifted by e - offset;
    - passes: the kernel takes the nr / 8 n-tiles in ceil(nr / 8 /
      _PASS_NT) passes of equal size (one at p <= 3, two at p = 4);
    - src[k] = chan[k] Lu + off[k], where E-vector row k starts in u[b];
    - chanrows[c]: the padded rows of channel c in group order, -1 padded
      to _MAX_A: the contributions the kernel sums into one output."""
    shape = tuple(shape)
    chan, offs = _row_geometry(p, shape, layout)
    Lu = _flat_tables(p, shape)[5]
    C = 3 * p ** 3
    if np.bincount(chan, minlength=C).max() > _MAX_A:
        raise ValueError(f"a channel has more than {_MAX_A} local dofs")
    goff = np.unique(offs)
    group = np.searchsorted(goff, offs)
    first, gwin = [], []
    for o in goff.tolist():
        if not first or o - first[-1] > _MAX_SHIFT:
            first.append(o)
        gwin.append(len(first) - 1)
    gwin = np.asarray(gwin, np.int64)
    woff = np.asarray([goff[gwin == w].max() for w in range(len(first))])
    gshift = woff[gwin] - goff
    wspan = woff - np.asarray(first)
    rowmap = []
    for g in range(len(goff)):
        rows = np.flatnonzero(group == g).tolist()
        if len(set(chan[rows].tolist())) != len(rows):
            raise ValueError(f"group {g} holds a channel twice")
        rowmap += rows + [-1] * (-len(rows) % 8)
    rowmap = np.asarray(rowmap, np.int64)
    nr = len(rowmap)
    chanrows = np.full((C, _MAX_A), -1, np.int64)
    fill = np.zeros(C, np.int64)
    for r in np.flatnonzero(rowmap >= 0):
        c = chan[rowmap[r]]
        chanrows[c, fill[c]] = r
        fill[c] += 1
    ntgroup = group[rowmap[::8]]
    tables = np.concatenate([chan * Lu + offs, rowmap, ntgroup, goff, gwin,
                             gshift, woff, wspan, chanrows.ravel()])
    tables = tables.astype(np.int32)
    return tables, (nr, len(goff), len(woff))


@functools.lru_cache(maxsize=None)
def _device_core_tables(p: int, shape: Tuple[int, int, int], layout: str,
                        dtype: torch.dtype, device: torch.device):
    """(mask, tables) on the device and (nr, ng, nw) of `core_tables`."""
    _, _, mask, _, _, _, _ = _flat_tables(p, shape)
    tables, counts = core_tables(p, shape, layout)
    return _on_device(device, (mask, dtype), (tables, torch.int32)) + (
        counts,)


def _launch(layout: str, Af: torch.Tensor, u_flat: torch.Tensor, p: int,
            shape) -> torch.Tensor:
    """Launch the layout's kernel on the current stream (the caller counts
    the launch); raises on a CUDA error."""
    _check_launchable(Af, u_flat, p, shape)
    _, _, _, _, Lp, Lu, _ = _flat_tables(p, shape)
    B, C, _ = u_flat.shape
    nd = Af.shape[0]
    if B > 65535 or B * C * Lu >= 2 ** 31 or Lu % _TILE:
        raise ValueError(f"batch or layout too large for the kernel grid "
                         f"(B={B}, Lu={Lu})")
    if Af.data_ptr() % 16 or u_flat.data_ptr() % 16:
        raise ValueError("Af and u_flat must be 16-byte aligned")
    mask, tables, (nr, ng, nw) = _device_core_tables(
        p, shape, layout, u_flat.dtype, u_flat.device)
    stem = _STEM[layout]
    fn = getattr(_library(stem), f"palace_{stem}_"
                      f"{'f64' if u_flat.dtype == torch.float64 else 'f32'}")
    y = torch.empty_like(u_flat)
    stream = torch.cuda.current_stream(u_flat.device).cuda_stream
    err = fn(Af.data_ptr(), u_flat.data_ptr(), mask.data_ptr(), y.data_ptr(),
             tables.data_ptr(), B, C, nd, Lp, Lu, nr, ng, nw, stream)
    if err != 0:
        raise RuntimeError(f"{stem} kernel launch failed: CUDA error {err}")
    return y


def structured_apply_flat(Af: torch.Tensor, u_flat: torch.Tensor, *, p: int,
                          shape) -> torch.Tensor:
    """y_flat = A @ u_flat on the flattened padded lattice.

    Af: (nd, nd) signed element matrix; u_flat: (B, C, Lu) (see `to_flat`).
    Essential-dof masking is the caller's business.  CPU tensors take the
    plain version; CUDA tensors (float32 or float64, contiguous) launch the
    hand-written kernel."""
    shape = tuple(int(s) for s in shape)
    if u_flat.device.type == "cpu":
        return structured_apply_flat_ref(Af, u_flat, p=p, shape=shape)
    y = _launch("natural", Af, u_flat, p, shape)
    structured_apply_flat.launches += 1
    return y


structured_apply_flat.launches = 0


def structured_apply_lattice(sop, lat: torch.Tensor) -> torch.Tensor:
    """Masked apply on the (B, C, nx, ny, nz) lattice layout through the flat
    kernel (same contract as StructuredNDOperator's convolution apply)."""
    ess = torch.as_tensor(sop.ess_lat, device=lat.device)
    Af = torch.as_tensor(sop.Af, dtype=lat.dtype, device=lat.device)
    free = torch.where(ess[None], 0, lat)
    u_flat = to_flat(free, sop.p, sop.shape)
    y_flat = structured_apply_flat(Af.contiguous(), u_flat, p=sop.p,
                                   shape=sop.shape)
    y = from_flat(y_flat, sop.p, sop.shape)
    return torch.where(ess[None], 0, y)


# ---------------------------------------------------------------------------
# Carry-class channel order: the layout of the second kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _class_tables(p: int, shape: Tuple[int, int, int]):
    """Carry-class-ordered tables (same tables as the TPU kernel's).

    Per edge family d the channels (d, i, j, k) fall into four carry
    classes by (j == 0, k == 0): A = (0,0), B = (0,>0), C = (>0,0),
    D = (>0,>0).  Ordering channels [A, B, C, D] per family makes every
    delta-group's channel set a union of <= 2 contiguous ranges, so the
    E-vector gather (and the transposed scatter) is ~15 block copies of
    consecutive rows instead of nd single-row copies.  Returns (perm_c
    channel permutation, perm_l local-dof permutation, slices =
    [(row0, nrows, chan0, flat_offset)]); permuting Af's rows and columns
    by perm_l is the caller's job (`v2_tables`)."""
    from palace_torch.ops.structured import hex_local_map

    nx, ny, nz = shape
    sx, sy = (ny + 1) * (nz + 1), nz + 1
    deltas, chan = hex_local_map(p)
    C = 3 * p ** 3

    # Channel class order per family: A, B, C, D.
    def chan_key(c):
        d, r = divmod(c, p ** 3)
        i, r2 = divmod(r, p * p)
        j, k = divmod(r2, p)
        cls = 0 if (j == 0 and k == 0) else (1 if j == 0 else
                                             (2 if k == 0 else 3))
        return (d, cls, i, j, k)

    perm_c = np.asarray(sorted(range(C), key=chan_key), np.int64)
    rank_c = np.empty(C, np.int64)
    rank_c[perm_c] = np.arange(C)

    # Local dofs ordered by (family, delta group, new channel rank).
    def loc_key(n):
        d = chan[n] // p ** 3
        dj = tuple(deltas[n])
        return (d, dj, rank_c[chan[n]])

    perm_l = np.asarray(sorted(range(len(chan)), key=loc_key), np.int64)

    # Contiguous (row-range, channel-range, offset) slices.
    slices = []
    r = 0
    while r < len(perm_l):
        n = perm_l[r]
        off = int(deltas[n, 0] * sx + deltas[n, 1] * sy + deltas[n, 2])
        c0 = int(rank_c[chan[n]])
        ln = 1
        while (r + ln < len(perm_l)):
            n2 = perm_l[r + ln]
            off2 = int(deltas[n2, 0] * sx + deltas[n2, 1] * sy
                       + deltas[n2, 2])
            if off2 != off or int(rank_c[chan[n2]]) != c0 + ln:
                break
            ln += 1
        slices.append((r, ln, c0, off))
        r += ln
    return perm_c, perm_l, slices


def v2_tables(sop) -> Tuple[np.ndarray, np.ndarray]:
    """(Af_perm, perm_c) for the second kernel from a StructuredNDOperator:
    the element matrix with rows and columns in carry-class local order, and
    the channel permutation of the lattice."""
    perm_c, perm_l, _ = _class_tables(sop.p, tuple(sop.shape))
    Af = np.asarray(sop.Af)
    return Af[np.ix_(perm_l, perm_l)], perm_c


def structured_apply_flat_v2_ref(Af_perm: torch.Tensor,
                                 u_flat_perm: torch.Tensor, *, p: int,
                                 shape) -> torch.Tensor:
    """Plain PyTorch version of the second kernel: gather the E-vector by
    class slices, Af_perm @ ul, mask, slice-add (the arithmetic of the TPU
    kernel body `_kernel_v2`, in any dtype and device)."""
    shape = tuple(shape)
    _check(Af_perm, u_flat_perm, p, shape)
    _, _, mask, _, Lp, _, _ = _flat_tables(p, shape)
    _, _, slices = _class_tables(p, shape)
    ul = torch.cat([u_flat_perm[:, c0:c0 + nr, off:off + Lp]
                    for (_, nr, c0, off) in slices], dim=1)  # (B, nd, Lp)
    vl = torch.matmul(Af_perm, ul) * torch.as_tensor(
        mask, dtype=u_flat_perm.dtype, device=u_flat_perm.device)
    y = torch.zeros_like(u_flat_perm)
    for (r0, nr, c0, off) in slices:
        y[:, c0:c0 + nr, off:off + Lp] += vl[:, r0:r0 + nr]
    return y


def structured_apply_flat_v2(Af_perm: torch.Tensor, u_flat_perm: torch.Tensor,
                             *, p: int, shape) -> torch.Tensor:
    """y_flat = A @ u_flat on the flattened padded lattice with channels in
    carry-class order (`_class_tables`) and Af_perm = Af[perm_l][:, perm_l]
    (`v2_tables`).  Essential-dof masking is the caller's business.  CPU
    tensors take the plain version; CUDA tensors (float32 or float64,
    contiguous) launch the hand-written kernel."""
    shape = tuple(int(s) for s in shape)
    if u_flat_perm.device.type == "cpu":
        return structured_apply_flat_v2_ref(Af_perm, u_flat_perm, p=p,
                                            shape=shape)
    y = _launch("class", Af_perm, u_flat_perm, p, shape)
    structured_apply_flat_v2.launches += 1
    return y


structured_apply_flat_v2.launches = 0


def structured_apply_lattice_v2(sop, lat: torch.Tensor) -> torch.Tensor:
    """Masked apply on the (B, C, nx, ny, nz) lattice layout (natural
    channel order in and out) through the second kernel: permute channels
    into carry-class order, apply, permute back."""
    Af_perm, perm_c = v2_tables(sop)
    ess = torch.as_tensor(sop.ess_lat, device=lat.device)
    free = torch.where(ess[None], 0, lat)
    u_flat = to_flat(free[:, torch.as_tensor(perm_c, device=lat.device)],
                     sop.p, sop.shape)
    y_flat = structured_apply_flat_v2(
        torch.as_tensor(Af_perm, dtype=lat.dtype,
                        device=lat.device).contiguous(),
        u_flat, p=sop.p, shape=sop.shape)
    y = from_flat(y_flat, sop.p, sop.shape)
    inv = torch.as_tensor(np.argsort(perm_c), device=lat.device)
    return torch.where(ess[None], 0, y[:, inv])
