"""The port's tests run torch on two threads and the BLAS under numpy and
scipy on one: next to them JAX already keeps a thread per core busy, and
under pytest-xdist every worker does.  On the port's CPU solves two torch
threads come close to a thread per core in wall time for a fraction of its
CPU time.  SuperLU's BLAS calls on the default thread count spin a thread
per core for no gain (the TEM-line adaptive test: 7 min 41 s of CPU time in
74 s on eight BLAS threads, 63 s in 66 s on one)."""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)
