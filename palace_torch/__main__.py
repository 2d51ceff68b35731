"""Command-line interface: ``python -m palace_torch [options] CONFIG.json``,
or ``torchrun --nproc_per_node=N -m palace_torch [options] CONFIG.json`` for
N ranks (see palace_torch.parallel)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="palace_torch",
        description="PyTorch/CUDA finite element solver for computational "
        "electromagnetics (driven frequency sweep, eigenmode, "
        "electrostatic, magnetostatic)",
    )
    ap.add_argument("config", help="JSON configuration file")
    ap.add_argument("--dry-run", "-dry-run", action="store_true",
                    help="parse and validate the configuration, then exit")
    ap.add_argument("--output", "-o", default=None,
                    help="override output directory")
    ap.add_argument("--version", action="version", version="palace-torch 0.1.0")
    args = ap.parse_args(argv)

    import palace_torch

    if args.dry_run:
        import json

        iodata = palace_torch.run(args.config, dry_run=True)
        print(json.dumps(iodata.config.resolved_dict(), indent=2, default=str))
        return 0
    from palace_torch import parallel

    try:
        palace_torch.run(args.config, output_dir=args.output)
    finally:
        parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
