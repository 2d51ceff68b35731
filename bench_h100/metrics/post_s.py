"""post_s: seconds of measure_step plus the error indicators per frequency
in the window (host clock; both end in host values)."""


def read(run):
    t = run.window_totals().get("post")
    return t[0] / t[1] if t and t[1] else None
