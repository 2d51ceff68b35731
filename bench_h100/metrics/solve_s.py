"""solve_s: the window's wall seconds over the requests completed in it
(host clock; the window ends when its last request has finished)."""


def read(run):
    done = [r for r in run.requests if r.error is None]
    return run.window_s / len(done) if done else None
