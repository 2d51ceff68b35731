"""Library entry point (counterpart of palace_tpu/api.py)."""

from __future__ import annotations


def run(config_path: str, output_dir: str | None = None, dry_run: bool = False):
    """Load a configuration file and run the requested problem type on the
    device named by config["Solver"]["Device"] ("CPU" or "GPU").

    Returns the driver's result object (driver-specific measurements; the
    driven driver's dict also carries the solve provenance)."""
    from palace_torch.config import IoData
    from palace_torch.utils import provenance, timers
    from palace_torch.device import resolve_device
    from palace_torch.drivers import get_driver
    from palace_torch.fem.operators import QuadraturePolicy, _env_policy

    iodata = IoData(config_path)
    if dry_run:
        return iodata
    device = resolve_device(iodata.solver.device)
    QuadraturePolicy.set(iodata.solver.quadrature_order_jac,
                         iodata.solver.quadrature_order_extra)
    _env_policy()  # PALACE_TPU_QORDER_* env vars win over config
    timers.reset()
    provenance.reset()
    driver = get_driver(iodata.problem.type)
    return driver(iodata, output_dir=output_dir, device=device)
