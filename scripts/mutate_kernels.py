#!/usr/bin/env python3
"""Mutation check of the hand-written structured-apply kernels, on one
CUDA GPU.

Run from the repository root:  python scripts/mutate_kernels.py

Each mutant is a copy of palace_torch/csrc with one deliberate fault in the
shared core (structured_apply_core.cuh), which both kernels' entry points
(structured_apply.cu, structured_apply_v2.cu) compile.  The script builds
the copy with the port's own nvcc route into a temporary directory,
launches both faulty kernels through their wrappers and holds each against
its plain PyTorch version, as chip_smoke.py's kernel phase does (max abs err
<= 1e-12 x max |y| in float64).  The unaltered copy must pass for both;
every mutant must fail for both.  Exits nonzero when the control fails or a
mutant survives, and when CUDA is not available.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

STEMS = ("structured_apply", "structured_apply_v2")
#: (file in csrc, mutant name, [(text in the file, its replacement)]).
MUTANTS = [
    ("structured_apply_core.cuh", "one k-chunk dropped from the product",
     [("ks < kChunk; ks += kStep", "ks < kChunk * (c != 1); ks += kStep")]),
    ("structured_apply_core.cuh", "a group's window shifted by one column",
     [("gshift[cur],", "gshift[cur] + (cur == 2),")]),
    ("structured_apply_core.cuh", "no pad-column mask",
     [("v += msk[g * kTile + t] * Ds[", "v += Ds[")]),
    ("structured_apply_core.cuh", "one offset group skipped",
     [("gact |= 1u << g;", "gact |= unsigned(g != 3) << g;")]),
    ("structured_apply_core.cuh", "one of a channel's contributions dropped",
     [("a < kMaxA; ++a", "a < kMaxA - 1; ++a")]),
    ("structured_apply_core.cuh", "a later pass drops the earlier passes' sum",
     [("v = *yo;", "v = T(0);")]),
]
#: p = 4 runs the core's two passes, p <= 3 one.
CASES = [(2, (3, 2, 4)), (3, (6, 5, 4)), (4, (3, 2, 4))]
BATCH = 4
TOL = 1e-12


def _max_rel_err(stem: str) -> float:
    """Worst max |kernel - plain| / max |plain| of one kernel over CASES."""
    import numpy as np
    import torch

    from palace_torch.ops import structured_kernel as sk
    from palace_torch.ops.structured import StructuredNDOperator

    fn, ref = {"structured_apply": (sk.structured_apply_flat,
                                    sk.structured_apply_flat_ref),
               "structured_apply_v2": (sk.structured_apply_flat_v2,
                                       sk.structured_apply_flat_v2_ref)}[stem]
    rng = np.random.default_rng(0)
    worst = 0.0
    for p, shape in CASES:
        sop = StructuredNDOperator.build_uniform(p, shape, 1.5, curl=1.0,
                                                 mass=-0.3)
        A = sop.Af if stem == "structured_apply" else sk.v2_tables(sop)[0]
        A = torch.as_tensor(A, device="cuda").contiguous()
        u = torch.as_tensor(rng.standard_normal(
            (BATCH, 3 * p ** 3, sk.flat_size(p, shape))), device="cuda")
        y = fn(A, u, p=p, shape=shape)
        y_ref = ref(A, u, p=p, shape=shape)
        worst = max(worst, float((y - y_ref).abs().max())
                    / float(y_ref.abs().max()))
    return worst


def _run(name: str, edits) -> dict:
    """Build a copy of csrc (with `edits` = [(old, new)] applied to csrc/
    <name>) into a fresh directory; {stem: max rel err} of both kernels."""
    from palace_torch.ops import structured_kernel as sk

    saved = sk.CSRC_DIR, sk.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(saved[0], csrc)
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs "
                                 f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        sk.CSRC_DIR, sk.BUILD_DIR = csrc, os.path.join(tmp, "build")
        sk._library.cache_clear()
        try:
            return {stem: _max_rel_err(stem) for stem in STEMS}
        finally:
            sk.CSRC_DIR, sk.BUILD_DIR = saved
            sk._library.cache_clear()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", flush=True)
        return 1
    errs = _run("structured_apply_core.cuh", [])
    ok = True
    for stem, err in errs.items():
        passed = err <= TOL
        ok &= passed
        print(f"{stem} unaltered: max rel err {err:.3e} "
              f"({'agrees' if passed else 'DISAGREES'})", flush=True)
    for name, mutant, edits in MUTANTS:
        for stem, err in _run(name, edits).items():
            caught = err > TOL
            ok &= caught
            print(f"{stem} mutant '{mutant}': max rel err {err:.3e} "
                  f"({'caught' if caught else 'SURVIVED'})", flush=True)
    print("mutation check " + ("passed" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
