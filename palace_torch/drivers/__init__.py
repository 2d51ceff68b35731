"""Problem drivers of the port (driven sweep, eigenmode, electrostatic,
magnetostatic, transient and boundary mode)."""

from __future__ import annotations

#: ROADMAP.md port-queue item of each problem type not ported yet.
_QUEUE = {}


def get_driver(problem_type):
    from palace_torch.config import ProblemType
    from palace_torch.utils import unported

    if problem_type is ProblemType.DRIVEN:
        from palace_torch.drivers.driven import solve
        return solve
    if problem_type is ProblemType.EIGENMODE:
        from palace_torch.drivers.eigenmode import solve
        return solve
    if problem_type is ProblemType.ELECTROSTATIC:
        from palace_torch.drivers.electrostatic import solve
        return solve
    if problem_type is ProblemType.MAGNETOSTATIC:
        from palace_torch.drivers.magnetostatic import solve
        return solve
    if problem_type is ProblemType.TRANSIENT:
        from palace_torch.drivers.transient import solve
        return solve
    if problem_type is ProblemType.BOUNDARY_MODE:
        from palace_torch.drivers.boundarymode import solve
        return solve
    unported(f"The {problem_type.value} driver",
             _QUEUE.get(problem_type.value, "Modules to port"))
