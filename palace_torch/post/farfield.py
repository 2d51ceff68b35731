"""Far-field radiation pattern via the Stratton-Chu transformation
(reference: palace/models/strattonchu.cpp):

  r E_inf(r0) = (i k / 4 pi) r0 x ∫_S [n x E - Z r0 x (n x H)] e^{i k r0.r'} dS

with Z H = c B (nondimensional c of the surface material), k = omega / c,
evaluated for a set of observation directions r0(theta, phi).  The
observation grid replicates the reference's NSample ring sampling
(palace/utils/configfile.cpp:669-760) plus explicit ThetaPhis.

Copied from palace_tpu/post/farfield.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def sample_sphere(n_sample: int, theta_phis_deg) -> np.ndarray:
    """(n, 2) array of (theta, phi) in radians, sorted (reference ordering)."""
    pts: List[Tuple[float, float]] = []
    if n_sample > 0:
        pts.append((0.0, 0.0))
        pts.append((math.pi, 0.0))
        if n_sample > 2:
            remaining = n_sample - 2
            n_theta = max(1, int(math.sqrt(remaining)))
            n_theta = min(n_theta, remaining)
            sin_vals = []
            for i in range(n_theta):
                theta = math.acos(1.0 - 2.0 * (i + 1) / (n_theta + 1.0))
                sin_vals.append(math.sin(theta))
            total = sum(sin_vals)
            per = []
            assigned = 0
            for i in range(n_theta - 1):
                k = int(remaining * sin_vals[i] / total + 0.5)
                per.append(k)
                assigned += k
            per.append(remaining - assigned)
            for i in range(1, n_theta + 1):
                is_eq = (i == (n_theta + 1) // 2)
                theta = (math.pi / 2 if is_eq
                         else math.acos(1.0 - 2.0 * i / (n_theta + 1.0)))
                m = per[i - 1]
                for j in range(m):
                    phi = 2.0 * math.pi * j / m
                    if j == 0:
                        phi = 0.0
                    elif j == m // 2:
                        phi = math.pi
                    pts.append((theta, phi))
    for (t, p) in theta_phis_deg:
        pts.append((math.radians(t), math.radians(p)))
    pts.sort()
    return np.array(pts) if pts else np.zeros((0, 2))


def stratton_chu(sop, tb, E: np.ndarray, omega: "float | complex",
                 theta_phis: np.ndarray) -> np.ndarray:
    """r E_inf at the observation directions: (npts, 3) complex.

    tb: NDTraceBasis of the farfield surface (outward normals); E complex
    ND dof vector; B = -curl E/(i omega).

    omega may be complex (eigenmode farfield): k = omega/c is then complex
    and the e^{ik r0.r'} factor carries the exp(-Im k . r0.r') amplitude
    (reference: strattonchu.cpp:101-140 k_re/k_im paths).
    """
    from palace_torch.fem.evaluation import trace_nd

    tr = tb.tr
    mesh = sop.mesh
    attrs = np.empty(len(tr.elem), np.int32)
    for bi, b in enumerate(mesh.buckets):
        s = tr.bucket == bi
        attrs[s] = b.attr[tr.elem[s]]
    # Scalar light speed of the adjacent material (isotropic assumption,
    # strattonchu.cpp:100-101).
    cspeed = np.empty(len(tr.elem))
    for k, a in enumerate(attrs):
        mi = sop.materials.inv_permeability[int(a)]
        eps = sop.materials.permittivity[int(a)]
        w = np.linalg.eigvalsh(np.linalg.inv(mi) @ eps)
        cspeed[k] = 1.0 / math.sqrt(max(w.min(), 1e-300))
    kwave = omega / cspeed  # (n,)

    Ev = trace_nd(sop.space, np.real(E).copy(), tr, "value") \
        + 1j * trace_nd(sop.space, np.imag(E).copy(), tr, "value")
    Cv = trace_nd(sop.space, np.real(E).copy(), tr, "curl") \
        + 1j * trace_nd(sop.space, np.imag(E).copy(), tr, "curl")
    Bv = Cv * (-1.0 / (1j * omega))
    ZH = cspeed[:, None, None] * Bv  # Z H = c B

    n = tr.normal
    nxE = np.cross(n, Ev)
    nxZH = np.cross(n, ZH)

    ct, st = np.cos(theta_phis[:, 0]), np.sin(theta_phis[:, 0])
    cp, sp_ = np.cos(theta_phis[:, 1]), np.sin(theta_phis[:, 1])
    r0 = np.stack([st * cp, st * sp_, ct], axis=1)  # (P, 3)

    # Phase e^{i k r0 . r'} and prefactor (i k w / 4 pi).
    dot = np.einsum("ps,fqs->pfq", r0, tr.xq)
    phase = np.exp(1j * kwave[None, :, None] * dot)
    pref = (1j * kwave[None, :, None] / (4.0 * math.pi)
            * tr.wdetJ[None, :, :] * phase)
    r0xnxZH = np.cross(r0[:, None, None, :], nxZH[None, :, :, :])
    integrand = nxE[None, :, :, :] - r0xnxZH
    I = np.einsum("pfq,pfqs->ps", pref, integrand)
    rE = np.cross(r0, I)
    return rE
