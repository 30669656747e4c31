"""Boundary-facet quadrature data for ds integrals.

The reference gets facet integrals (natural BCs, Nitsche terms, backflow
stabilization, WSS, drag/lift) from UFL `ds` measures compiled by ffcx
(e.g. /root/reference/src/solvers/stabilized_schur.py:79,
/root/reference/src/solverBase.py:171-172). Here each boundary facet is
integrated with a reference-facet quadrature rule; cell basis functions are
tabulated at the facet quadrature points mapped into the cell reference
frame. Because the mapped points depend on which local facet the boundary
facet is (and on its stored orientation), facets are grouped by the tuple of
cell-local vertex indices; each group has one static table and facets index
into the stacked tables with a group id — keeping everything static-shaped
and gather-friendly for the compiled kernels.
"""

from __future__ import annotations

import numpy as np

from ..elements import LagrangeElement, quadrature
from ..elements.cells import cell_vertices, facet_cell_type
from ..mesh import Mesh


class FacetQuadrature:
    """Quadrature + tabulation data over a set of boundary facets.

    Attributes (numpy, to be wrapped in jnp by the consumer):
        facet_indices: (nf,) the boundary facet subset
        cells: (nf,) adjacent cell of each facet
        group: (nf,) table-group id of each facet
        weights: (nq,) reference facet quadrature weights
        fphi: (nq, nfv) facet P1 geometry shape functions
        fdphi: (nq, nfv, fdim) their reference gradients
        tables: dict space-key -> (phi (ng, nq, nb), dphi (ng, nq, nb, dim))
    """

    def __init__(self, mesh: Mesh, facet_indices: np.ndarray, quad_degree: int):
        self.mesh = mesh
        self.facet_indices = np.asarray(facet_indices, dtype=np.int32)
        ftype = facet_cell_type(mesh.cell_type)
        xi, w = quadrature(ftype, quad_degree)
        self.qpoints = xi
        self.weights = w
        fgeom = LagrangeElement.create(ftype, 1)
        self.fphi, self.fdphi = fgeom.tabulate(xi, nderiv=1)

        self.cells = mesh.facet_cells[self.facet_indices].astype(np.int32)
        fverts = mesh.facets[self.facet_indices]  # (nf, nfv) global ids

        # cell-local index of each facet vertex, in stored (outward) order
        cell_verts = mesh.cells[self.cells]  # (nf, nv)
        local = np.argmax(
            cell_verts[:, None, :] == fverts[:, :, None], axis=2
        )  # (nf, nfv)
        self._local = local

        # group facets by their local-index tuple
        keys, group = np.unique(local, axis=0, return_inverse=True)
        self.group = group.astype(np.int32)
        # mapped cell-reference coordinates of the facet quad points
        ref = cell_vertices(mesh.cell_type)
        # X_cell(xi_q) for group g: sum_i fphi[q, i] * ref[keys[g, i]]
        self.mapped_points = np.einsum(
            "qi,gid->gqd", self.fphi, ref[keys]
        )  # (ng, nq, dim)
        self.num_groups = keys.shape[0]
        self._tables: dict = {}

    @property
    def num_facets(self) -> int:
        return len(self.facet_indices)

    @property
    def num_qpoints(self) -> int:
        return len(self.weights)

    def tabulate(self, element: LagrangeElement):
        """Grouped tables (phi (ng, nq, nb), dphi (ng, nq, nb, dim)) of a
        cell element at the facet quadrature points."""
        key = (element.cell, element.degree)
        if key not in self._tables:
            ng, nq, dim = self.mapped_points.shape
            phi = np.empty((ng, nq, element.ndofs))
            dphi = np.empty((ng, nq, element.ndofs, dim))
            for g in range(ng):
                p, dp = element.tabulate(self.mapped_points[g], nderiv=1)
                phi[g], dphi[g] = p, dp
            self._tables[key] = (phi, dphi)
        return self._tables[key]

    def facet_coords(self) -> np.ndarray:
        """(nf, nfv, gdim) physical facet vertex coordinates."""
        return self.mesh.points[self.mesh.facets[self.facet_indices]]

    def geometry(self):
        """Per-facet per-qp geometry as numpy:

        Returns (x (nf, nq, gdim), normal (nf, nq, gdim), dS (nf, nq)) where
        dS already includes the quadrature weight (integrate by summing).
        """
        coords = self.facet_coords()  # (nf, nfv, gdim)
        x = np.einsum("qi,fig->fqg", self.fphi, coords)
        t = np.einsum("qid,fig->fqgd", self.fdphi, coords)  # dX/dxi
        if self.mesh.dim == 2:
            tv = t[..., 0]  # (nf, nq, 2)
            norm = np.linalg.norm(tv, axis=-1)
            normal = np.stack([tv[..., 1], -tv[..., 0]], axis=-1) / norm[..., None]
            dS = norm * self.weights[None, :]
        else:
            t1, t2 = t[..., 0], t[..., 1]
            cr = np.cross(t1, t2)
            norm = np.linalg.norm(cr, axis=-1)
            normal = cr / norm[..., None]
            dS = norm * self.weights[None, :]
        return x, normal, dS

    def facet_measure(self) -> np.ndarray:
        """(nf,) facet length/area (UFL FacetArea equivalent, used by the
        WSS forms at /root/reference/src/solverBase.py:171-172)."""
        _, _, dS = self.geometry()
        return dS.sum(axis=1)
