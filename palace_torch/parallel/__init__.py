"""The ranks of a multi-GPU run: the counterpart of palace_tpu's
`make_cells_mesh` (palace_tpu/parallel/dofsharded.py:48), its 1-D ("cells",)
device mesh.

One process per rank, as upstream Palace runs one MPI rank per process; a
rank is one device of that mesh.  Under `torchrun --nproc_per_node=N -m
palace_torch cfg.json` the run initializes the process group from the
environment (`init_from_env`); a program that starts its own ranks calls
`init` with an init method (a `file://` store, or `tcp://host:port`).

The backend is a fixed rule, not a fallback:

- "nccl" when every rank has its own card;
- "gloo" on the CPU, or when ranks share a card, which is the case only when
  the ranks of a host outnumber its visible cards.  Ranks that share a card
  cannot use NCCL (it refuses two ranks on one device); gloo reduces in host
  memory, and the sharded solvers need only `all_reduce` and `broadcast`.

Without an initialized group the run is one rank: `n_shards()` is 1, `psum`
returns its argument, and every solve takes the single-device path.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

#: A lost rank fails a collective after this long instead of hanging the run.
TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True)
class Ranks:
    """The process group of a run and this process's place in it."""

    rank: int
    n_shards: int
    device: torch.device
    backend: Optional[str]  # None for a single rank
    devices: List[str]  # every rank's device, by rank


_RANKS: Optional[Ranks] = None

#: This process's collectives (`psum`, `broadcast`) since the last
#: `reset_stats()`: calls, host seconds inside them (waiting for the other
#: ranks included) and bytes sent.
STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes=0)


def _collective(fn, t: torch.Tensor) -> None:
    """fn on `t`'s real view; under gloo a CUDA tensor goes through a host
    copy (gloo reduces in host memory: the blocking copy waits for the work
    that produces t, and one copy back replaces gloo's own staging)."""
    x = torch.view_as_real(t) if t.is_complex() else t
    t0 = time.perf_counter()
    if x.is_cuda and current().backend == "gloo":
        h = x.cpu()
        fn(h)
        x.copy_(h)
    else:
        fn(x)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += x.numel() * x.element_size()


def backend_for(device_type: str, local_world_size: int,
                cuda_count: int) -> str:
    """The backend rule of the module docstring."""
    if device_type == "cpu" or local_world_size > cuda_count:
        return "gloo"
    return "nccl"


def device_for(device_type: str, local_rank: int, cuda_count: int
               ) -> torch.device:
    """cuda:{LOCAL_RANK} where there are enough cards (ranks share them
    round-robin otherwise), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if cuda_count < 1:
        raise RuntimeError("a CUDA rank needs a visible card")
    return torch.device(f"cuda:{local_rank % cuda_count}")


def init(rank: int, world_size: int, init_method: str, *,
         device_type: str = "cuda", local_rank: Optional[int] = None,
         local_world_size: Optional[int] = None,
         timeout: datetime.timedelta = TIMEOUT) -> Ranks:
    """Initialize the process group (once per process) and return it."""
    global _RANKS
    if _RANKS is not None:
        return _RANKS
    local_rank = rank if local_rank is None else local_rank
    local_world_size = (world_size if local_world_size is None
                        else local_world_size)
    count = torch.cuda.device_count() if device_type != "cpu" else 0
    backend = backend_for(device_type, local_world_size, count)
    device = device_for(device_type, local_rank, count)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    devices: List[Optional[str]] = [None] * world_size
    dist.all_gather_object(devices, str(device))
    _RANKS = Ranks(rank, world_size, device, backend, list(devices))
    return _RANKS


def init_from_env(device_type: str) -> Ranks:
    """Under torchrun (WORLD_SIZE > 1 in the environment): initialize the
    group from RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR
    and MASTER_PORT.  Otherwise the current group (one rank if none)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if _RANKS is None and world > 1:
        return init(int(os.environ["RANK"]), world, "env://",
                    device_type=device_type,
                    local_rank=int(os.environ.get("LOCAL_RANK",
                                                  os.environ["RANK"])),
                    local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE",
                                                        world)))
    return current()


def current() -> Ranks:
    """The initialized group, or a single rank on cuda:0."""
    if _RANKS is not None:
        return _RANKS
    return Ranks(0, 1, torch.device("cuda:0"), None, ["cuda:0"])


def n_shards() -> int:
    return current().n_shards


def is_root() -> bool:
    """True on rank 0 (and in a single-rank run): the rank that logs and
    writes files."""
    return current().rank == 0


def psum(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place (complex tensors through their real
    view: NCCL has no complex types) and return it."""
    if current().n_shards > 1:
        _collective(lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM), t)
    return t


def broadcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's `t` on every rank, in place."""
    if current().n_shards > 1:
        _collective(lambda x: dist.broadcast(x, src=0), t)
    return t


def describe() -> dict:
    """Backend, shard count and device map, for the provenance."""
    r = current()
    return {"backend": r.backend, "n_shards": r.n_shards,
            "devices": list(r.devices)}


def shutdown() -> None:
    """Destroy the process group (the end of a torchrun run)."""
    global _RANKS
    if _RANKS is not None:
        dist.destroy_process_group()
        _RANKS = None
