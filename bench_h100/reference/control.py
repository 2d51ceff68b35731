"""The lower-precision control: the reference, computed in float32, put in
the program's place and judged by the comparison that decides `correct`.

    python3 bench_h100/reference/control.py --workload <cell> \
        --seeds <n> [<n> ...] [--columns <k>]

For each seed the control takes the frequencies of the seed's first
request (the first `--columns` of them), produces what the comparison
reads of a program (operators, load, solution columns by a float32
sparse direct solve, their energies) in float32 at the cell's own size,
and prints the numbers beside their limits.  The benchmark's own runs do
not run it; it has to come out as not correct on every seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)


def control_numbers(cell, seed: int, columns: int, ref64=None):
    import numpy as np

    from harness.meshgen import box_hex
    from harness.traffic import FrequencyStream
    from reference import check
    from reference.driven import DrivenReference

    mesh = box_hex(cell.config["mesh"]["cells"], cell.config["mesh"]["size"])
    freqs = FrequencyStream(seed, cell.config["band_ghz"],
                            cell.traffic).next_request()[:columns]
    out = DrivenReference(cell.config, mesh, dtype=np.float32).outputs(freqs)
    nums = check.judge(cell.config, mesh, out, ref=ref64)
    return nums, check.verdict(nums, cell.config["check"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--columns", type=int, default=2)
    args = ap.parse_args(argv)
    from harness import cells
    from harness.meshgen import box_hex
    from reference.driven import DrivenReference

    cell = cells.find_cell(args.workload)
    mesh = box_hex(cell.config["mesh"]["cells"], cell.config["mesh"]["size"])
    ref64 = DrivenReference(cell.config, mesh)
    ok = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums, correct = control_numbers(cell, seed, args.columns, ref64)
        ok &= not correct
        print(json.dumps({"seed": seed, "correct": correct, "numbers": nums,
                          "limits": cell.config["check"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
