"""Device selection from config["Solver"]["Device"] (counterpart of
palace_tpu/api.py `configure_platform`)."""

from __future__ import annotations

import torch

from palace_torch import parallel


def device_type(name: str) -> str:
    """"CPU" (or "Debug") -> "cpu"; "GPU" -> "cuda"."""
    key = name.strip().upper()
    if key in ("CPU", "DEBUG"):
        return "cpu"
    if key in ("GPU", "CUDA"):
        return "cuda"
    raise ValueError(f"unsupported Solver.Device {name!r} (CPU or GPU)")


def resolve_device(name: str) -> torch.device:
    """"CPU" (or "Debug") -> cpu; "GPU" -> the rank's card (cuda:0 in a
    single-rank run), which must exist."""
    if device_type(name) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError('Solver.Device "GPU" requested but CUDA is not '
                           "available")
    ranks = parallel.current()
    if ranks.n_shards > 1 and ranks.device.type == "cuda":
        return ranks.device
    return torch.device("cuda:0")
