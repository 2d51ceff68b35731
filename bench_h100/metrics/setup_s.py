"""setup_s: host seconds from the start of the process to the start of
the window: imports, mesh, assembly, solver hierarchy, the kernel build of
a first run, and the warm-up request."""


def read(run):
    return run.setup_s
