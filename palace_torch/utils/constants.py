"""Physical constants for nondimensionalization.

CODATA 2022 values, matching the reference solver's conventions
(reference: palace/utils/constants.hpp:20-36) so that dimensionalized
outputs agree.

Copied from palace_tpu/utils/constants.py, imports pointed at palace_torch.
"""

# Speed of light in free space [m/s] (exact).
C0 = 299_792_458.0

# Permeability of free space [H/m].
MU0 = 1.256_637_061_27e-6

# Permittivity of free space [F/m].
EPSILON0 = 1.0 / (MU0 * C0 * C0)

# Impedance of free space [Ohm].
Z0 = MU0 * C0
