"""palace-torch: the PyTorch/CUDA port of palace_tpu.

Runs the driven frequency sweep (config -> mesh -> Nedelec space ->
term-structured system -> blocked FGMRES + p-multigrid -> port, energy and
error-indicator tables), the eigenmode solve (block Lanczos over the same
solver, or host ARPACK -> eig, energy and error-indicator tables) and the
electrostatic and magnetostatic solves (Jacobi-CG over element-mode
operators -> capacitance or inductance matrices, inside the AMR loop) on one
NVIDIA GPU or on the CPU, with the same JSON configuration as palace_tpu.  On
uniform PEC box hex meshes the fine-level operator runs through hand-written
CUDA kernels (csrc/structured_apply.cu for the driven sweep,
csrc/structured_apply_v2.cu for the eigensolver, both entry points of the
float64 tensor-core core csrc/structured_apply_core.cuh).  Imports torch,
never jax,
and nothing of palace_tpu: the jax-free host modules it needs (config, mesh,
finite-element spaces, materials, lumped ports, tables) are copies kept in
this package.

    import palace_torch
    palace_torch.run("config.json")
"""

__version__ = "0.1.0"

from palace_torch.api import run  # noqa: F401,E402
