"""Magnetostatics: curl-curl operator with surface-current excitations
(counterpart of palace_tpu/models/curlcurl.py).

Reference: palace/models/curlcurloperator.hpp:35-37,
palace/models/surfacecurrentoperator.cpp (unit-current excitation through a
uniform lumped element), palace/fem/lumpedelement.hpp (element geometry).
The operator's element tables live on `device`; the excitation is
integrated on the host and copied there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from palace_torch.config import IoData
from palace_torch.fem import evaluation
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.mesh.mesh import Mesh
from palace_torch.models.materials import MaterialOperator
from palace_torch.ops.partial import (EliminatedOperator, PAOperator,
                                      make_ess_mask)


def uniform_element_geometry(mesh: Mesh, attrs, direction: np.ndarray):
    """(length along direction, width = area / length) of a planar uniform
    lumped element (reference: palace/fem/lumpedelement.hpp uniform element).
    """
    from palace_torch.mesh import geometry as geom_mod

    pts = []
    area = 0.0
    for b in mesh.bdr_buckets:
        sel = np.isin(b.attr, list(attrs))
        if not sel.any():
            continue
        pts.append(mesh.nodes[np.unique(b.conn[sel].ravel())])
        gf = geom_mod.compute(mesh.nodes, b, 2)
        area += float(gf.wdetJ[sel].sum())
    allp = np.concatenate(pts)
    sdim = mesh.nodes.shape[1]
    d = np.asarray(direction, float)[:sdim]
    d = d / np.linalg.norm(d)
    proj = allp @ d
    length = float(proj.max() - proj.min())
    if sdim == 2:
        # 2D: unit out-of-plane depth (reference: lumpedelement.cpp:123-128).
        return length, 1.0
    return length, area / length


@dataclass
class SurfaceCurrentSource:
    index: int
    elements: List[dict]  # attrs, direction (unit), width


@dataclass
class CurlCurlOperator:
    space: NDSpace
    materials: MaterialOperator
    K: PAOperator  # (mu^-1 curl u, curl v)
    Keli: EliminatedOperator
    ess_mask: np.ndarray
    sources: Dict[int, SurfaceCurrentSource]

    @staticmethod
    def build(iodata: IoData, mesh: Mesh,
              device: torch.device = torch.device("cpu")
              ) -> "CurlCurlOperator":
        from palace_torch.models.lumpedport import direction_vector

        space = NDSpace(mesh, iodata.solver.order)
        materials = MaterialOperator.build(iodata)
        K = nd_operator(space, curl_coef=materials.inv_permeability,
                        device=device)
        ess = space.boundary_dofs(
            list(iodata.boundaries.pec) + list(iodata.boundaries.ground))
        mask = make_ess_mask(space.num_dofs, ess)
        sources: Dict[int, SurfaceCurrentSource] = {}
        for sc in sorted(iodata.boundaries.surface_currents,
                         key=lambda s: s.index):
            entries = sc.elements or [dict(attributes=sc.attributes,
                                           direction=sc.direction)]
            elems = []
            for e in entries:
                d = direction_vector(e["direction"], mesh.nodes.shape[1])
                _, w = uniform_element_geometry(mesh, e["attributes"], d)
                elems.append(dict(attributes=e["attributes"], direction=d,
                                  width=w))
            sources[sc.index] = SurfaceCurrentSource(sc.index, elems)
        return CurlCurlOperator(
            space, materials, K, EliminatedOperator(K, mask), mask, sources)

    def excitation(self, idx: int) -> torch.Tensor:
        """RHS for a unit total current through source `idx` (zero on the
        essential dofs): b_j = sum_elements int_S (1/w) d . v_j dS."""
        from palace_torch.fem import reference as refmod
        from palace_torch.utils import smallmat

        space = self.space
        mesh = space.mesh
        q = 2 * space.order + 2
        rhs = np.zeros(space.num_dofs)
        for e in self.sources[idx].elements:
            tr = evaluation.boundary_trace(mesh, e["attributes"], q)
            d = e["direction"] / e["width"]
            # b_j += sum_{facets,q} wdetJ * d . (J^-T v_ref_j)
            for bi, b in enumerate(mesh.buckets):
                sel = np.where(tr.bucket == bi)[0]
                if len(sel) == 0:
                    continue
                nq = tr.wdetJ.shape[1]
                xis = tr.xi[sel].reshape(-1, tr.xi.shape[-1])
                V, _ = space.basis_tables(b.geom, xis)
                V = V.reshape(len(sel), nq, -1, V.shape[-1])
                gb = refmod.gmsh_geometry_basis(b.etype)
                Gg = gb.eval_grad(xis).reshape(len(sel), nq, -1,
                                               xis.shape[-1])
                X = mesh.nodes[b.conn[tr.elem[sel]]]
                J = np.einsum("ens,enqr->eqsr", X, Gg.transpose(0, 2, 1, 3))
                Jinv = smallmat.inv(J)
                # d^T J^{-T} v_ref = (J^{-1} d) . v_ref (in-plane direction
                # truncated to the mesh's space dimension for 2D problems)
                ds = np.asarray(d, float)[: J.shape[-1]]
                Jd = np.einsum("eqrs,s->eqr", Jinv, ds)
                contrib = np.einsum("eqr,eqnr,eq->en", Jd, V, tr.wdetJ[sel])
                np.add.at(rhs, space.elem_dofs[bi][tr.elem[sel]].ravel(),
                          contrib.ravel())
        rhs[np.asarray(self.ess_mask, bool)] = 0.0
        return torch.as_tensor(rhs, device=self.K.device)
