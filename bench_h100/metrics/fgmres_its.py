"""fgmres_its: FGMRES iterations per block, the program's own count
(info["iterations"], which counts whole restart cycles): the largest
column count of each request, averaged over the window's requests."""


def read(run):
    its = [max(r.iterations) for r in run.requests if r.iterations]
    return sum(its) / len(its) if its else None
