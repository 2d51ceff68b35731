#!/usr/bin/env python3
"""A/B timing of versions of the shared structured-apply kernel core on
one CUDA GPU, in one process.

Run from the repository root:

    python scripts/ab_kernel_core.py OLD.cuh NEW.cuh NEW.cuh OLD.cuh

Each argument is a version of palace_torch/csrc/structured_apply_core.cuh
(for example the parent commit's, from `git show HEAD~1:<path> > OLD.cuh`).
Every distinct file is built with the port's own nvcc route, beside the
entry points of this checkout, into build/ab_kernel_core/<n>/. In the order
given, both kernels (natural layout, kernel #1; carry-class layout, kernel
#2) are checked against their plain versions (float64, 1e-12 relative to
max |y|) and timed at the two main-path shapes (p = 3, 12^3 and 16^3,
B = 16): the CUDA-event median of single calls and the device time of 50
queued launches, as chip_smoke.py phase 3 times them. Repeat a file (old,
new, new, old) to see the drift of the card. The last lines give each
file's mean over its runs. Exits nonzero when a version disagrees with the
plain version or CUDA is not available.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys

SHAPES = ((12, 12, 12), (16, 16, 16))
P, BATCH, TOL = 3, 16, 1e-12


def main(headers) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from palace_torch.ops import structured_kernel as sk
    from palace_torch.ops.structured import StructuredNDOperator

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", flush=True)
        return 1
    if not headers:
        print(__doc__, flush=True)
        return 2
    dev = torch.device("cuda:0")
    inputs = {}
    for shape in SHAPES:
        sop = StructuredNDOperator.build_uniform(P, shape, 1.5, curl=1.0,
                                                 mass=-0.3)
        u = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (BATCH, 3 * P ** 3, sk.flat_size(P, shape))), device=dev)
        inputs[shape] = (
            torch.as_tensor(sop.Af, device=dev).contiguous(),
            torch.as_tensor(sk.v2_tables(sop)[0], device=dev).contiguous(), u)
    kernels = (("#1", sk.structured_apply_flat, sk.structured_apply_flat_ref),
               ("#2", sk.structured_apply_flat_v2,
                sk.structured_apply_flat_v2_ref))
    csrc0 = sk.CSRC_DIR
    root = os.path.join(os.path.dirname(sk.BUILD_DIR), "ab_kernel_core")
    index = {h: i for i, h in enumerate(dict.fromkeys(headers))}
    times, ok = {}, True
    for header in headers:
        tag = f"{index[header]}:{os.path.basename(header)}"
        csrc = os.path.join(root, str(index[header]), "csrc")
        if not os.path.exists(csrc):
            shutil.copytree(csrc0, csrc)
            shutil.copy(header, os.path.join(
                csrc, "structured_apply_core.cuh"))
        sk.CSRC_DIR = csrc
        sk.BUILD_DIR = os.path.join(root, str(index[header]), "build")
        sk._library.cache_clear()
        for shape, (A1, A2, u) in inputs.items():
            for (kname, fn, ref), A in zip(kernels, (A1, A2)):
                y = fn(A, u, p=P, shape=shape)
                y_ref = ref(A, u, p=P, shape=shape)
                err = float((y - y_ref).abs().max() / y_ref.abs().max())
                ok &= err <= TOL
                ms = cs._time_ms(lambda: fn(A, u, p=P, shape=shape))
                dev_ms = cs._device_ms(lambda: fn(A, u, p=P, shape=shape))
                times.setdefault((tag, kname, shape[0]), []).append(
                    (ms, dev_ms))
                print(f"{tag} kernel {kname} {shape[0]}^3: rel err "
                      f"{err:.1e}, single {ms:.4f} ms, device "
                      f"{dev_ms:.4f} ms", flush=True)
    sk.CSRC_DIR = csrc0
    for (tag, kname, n), runs in sorted(times.items()):
        print(f"mean {tag} kernel {kname} {n}^3 ({len(runs)} runs): single "
              f"{statistics.mean(r[0] for r in runs):.4f} ms, device "
              f"{statistics.mean(r[1] for r in runs):.4f} ms", flush=True)
    if not ok:
        print(f"FAILED: a version disagrees with the plain version "
              f"(> {TOL:.0e})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
