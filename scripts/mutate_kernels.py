#!/usr/bin/env python3
"""Mutation check of the hand-written structured-apply kernels, on one
CUDA GPU.

Run from the repository root:  python scripts/mutate_kernels.py

Each mutant is a copy of palace_torch/csrc with one deliberate fault in one
kernel.  The script builds the copy with the port's own nvcc route into a
temporary directory, launches the faulty kernel through its wrapper and
holds it against the plain PyTorch version, as chip_smoke.py's kernel phase
does (max abs err <= 1e-12 x max |y| in float64).  The unaltered copy must
pass; every mutant must fail.  Exits nonzero when the control fails or a
mutant survives, and when CUDA is not available.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

#: (kernel stem, mutant name, [(text in the source, its replacement)]).
MUTANTS = [
    ("structured_apply", "pull drops a local dof",
     [("acc += w * s;", "if (k > 0) acc += w * s;")]),
    ("structured_apply", "no pad-column mask",
     [("if (w == T(0)) continue;", ""), ("acc += w * s;", "acc += s;")]),
    ("structured_apply", "product skips a term",
     [("for (int j = 0; j < nd; ++j) {", "for (int j = 1; j < nd; ++j) {")]),
    ("structured_apply_v2", "pull drops a local dof",
     [("acc += vb[", "if (k > 0) acc += vb[")]),
    ("structured_apply_v2", "no pad-column mask",
     [("= wm * acc[j];", "= acc[j];")]),
    ("structured_apply_v2", "product skips a term",
     [("for (int k = 0; k < nd; ++k) {", "for (int k = 1; k < nd; ++k) {")]),
]
CASES = [(2, (3, 2, 4)), (3, (6, 5, 4))]
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


def _run(stem: str, edits) -> float:
    """Build a copy of csrc (with `edits` = [(old, new)] applied to
    <stem>.cu) into a fresh directory and check <stem>."""
    from palace_torch.ops import structured_kernel as sk

    saved = sk.CSRC_DIR, sk.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(saved[0], csrc)
        path = os.path.join(csrc, f"{stem}.cu")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{stem}.cu: {old!r} occurs "
                                 f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        sk.CSRC_DIR, sk.BUILD_DIR = csrc, os.path.join(tmp, "build")
        sk._library.cache_clear()
        try:
            return _max_rel_err(stem)
        finally:
            sk.CSRC_DIR, sk.BUILD_DIR = saved
            sk._library.cache_clear()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", flush=True)
        return 1
    ok = True
    for stem in ("structured_apply", "structured_apply_v2"):
        err = _run(stem, [])
        passed = err <= TOL
        ok &= passed
        print(f"{stem} unaltered: max rel err {err:.3e} "
              f"({'agrees' if passed else 'DISAGREES'})", flush=True)
    for stem, name, edits in MUTANTS:
        err = _run(stem, edits)
        caught = err > TOL
        ok &= caught
        print(f"{stem} mutant '{name}': max rel err {err:.3e} "
              f"({'caught' if caught else 'SURVIVED'})", flush=True)
    print("mutation check " + ("passed" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
