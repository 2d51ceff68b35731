"""Library entry point (counterpart of palace_tpu/api.py)."""

from __future__ import annotations


def run(config_path: str, output_dir: str | None = None, dry_run: bool = False):
    """Load a configuration file and run the requested problem type on the
    device named by config["Solver"]["Device"] ("CPU" or "GPU").

    Under `torchrun --nproc_per_node=N` (WORLD_SIZE > 1 in the environment)
    every rank calls this: the first call initializes the process group
    (`palace_torch.parallel`), the element-mode static CG, the driven device
    sweep and the eigensolver's inner solves run dof-sharded over the ranks,
    every other path runs the same code on every rank, and only rank 0 logs
    and writes files.

    Returns the driver's result object (driver-specific measurements; the
    driven driver's dict also carries the solve provenance)."""
    from palace_torch import parallel
    from palace_torch.config import IoData
    from palace_torch.utils import provenance, timers
    from palace_torch.device import device_type, resolve_device
    from palace_torch.drivers import get_driver
    from palace_torch.drivers.common import print_log
    from palace_torch.fem.operators import QuadraturePolicy, _env_policy

    iodata = IoData(config_path)
    if dry_run:
        return iodata
    parallel.init_from_env(device_type(iodata.solver.device))
    device = resolve_device(iodata.solver.device)
    QuadraturePolicy.set(iodata.solver.quadrature_order_jac,
                         iodata.solver.quadrature_order_extra)
    _env_policy()  # PALACE_TPU_QORDER_* env vars win over config
    timers.reset()
    provenance.reset()
    if parallel.n_shards() > 1:
        info = parallel.describe()
        provenance.record("parallel", info)
        print_log(iodata, f"Ranks: {info['n_shards']} ({info['backend']}), "
                          f"devices {info['devices']}")
    driver = get_driver(iodata.problem.type)
    return driver(iodata, output_dir=output_dir, device=device)
