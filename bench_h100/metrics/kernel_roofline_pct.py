"""kernel_roofline_pct: kernel #1's share of its roofline over the window:
the launches' least time (bytes or operations over the card's peaks,
harness/counts.py, at the cell's shape and its B = 2 x block real columns,
the block being the traffic's `freqs_per_request`)
over their device time in the trace, by the kernel's name
(structured_apply_core, launched from the natural-layout library); nothing
where the trace shows no launch of it."""

from harness import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    n, secs = t.op_time("structured_apply_core")
    if n == 0 or secs <= 0:
        return None
    cfg = run.cell.config
    p = int(cfg["palace"]["Solver"]["Order"])
    batch = 2 * int(run.cell.traffic["freqs_per_request"])
    return 100.0 * n * counts.kernel1_bound_s(p, cfg["mesh"]["cells"],
                                              batch) / secs
