"""device_idle_pct: the share of the traced window in which no operation
ran on the card (100 - the union of device intervals over the window, in
%), from torch.profiler's device trace."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
