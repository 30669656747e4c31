"""Unstructured mesh with boundary-facet topology.

Replaces the dolfinx Mesh + its parallel index maps (reference uses
dolfinx.mesh everywhere, e.g. /root/reference/src/scenario.py:25,
/root/reference/src/scenarios/lid_driven2D.py:30). Topology is built once in
numpy; the hot-path arrays (points, cell connectivity, facet data) are handed
to JAX kernels as static-shaped int32/float arrays.

Boundary facets are stored with outward-oriented vertex ordering so facet
normals computed from the stored geometry always point out of the domain.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..elements.cells import (
    CellType,
    as_cell_type,
    cell_dim,
    cell_facets,
    facet_cell_type,
    num_cell_vertices,
)


def _sfc_key(points: np.ndarray) -> np.ndarray:
    """Space-filling-curve key per point: 2D Hilbert (best locality for
    the supernode grouping) or 3D Morton."""
    n, gdim = points.shape
    bits = 14 if gdim == 2 else 10
    q = np.empty((gdim, n), dtype=np.int64)
    for d in range(gdim):
        x = points[:, d]
        r = np.ptp(x)
        r = r if r > 0 else 1.0
        q[d] = np.clip(
            ((x - x.min()) / r * (2 ** bits - 1)).astype(np.int64),
            0, 2 ** bits - 1,
        )
    if gdim == 3:
        z = np.zeros(n, dtype=np.int64)
        for b in range(bits):
            for d in range(3):
                z |= ((q[d] >> b) & 1) << (3 * b + d)
        return z
    # 2D Hilbert (vectorized d2xy-inverse)
    X, Y = q[0].copy(), q[1].copy()
    d = np.zeros(n, dtype=np.int64)
    s = 2 ** (bits - 1)
    while s > 0:
        rx = ((X & s) > 0).astype(np.int64)
        ry = ((Y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        X2 = np.where(flip, s - 1 - X, X)
        Y2 = np.where(flip, s - 1 - Y, Y)
        X, Y = np.where(swap, Y2, X2), np.where(swap, X2, Y2)
        s //= 2
    return d


@dataclass
class Mesh:
    points: np.ndarray  # (n_points, gdim) float
    cells: np.ndarray  # (n_cells, n_cell_vertices) int32
    cell_type: CellType
    # Boundary facet topology (filled by _build_topology):
    facets: np.ndarray = field(default=None, repr=False)  # (nf, nfv) int32, outward-oriented
    facet_cells: np.ndarray = field(default=None, repr=False)  # (nf,) adjacent cell
    facet_local_index: np.ndarray = field(default=None, repr=False)  # (nf,) local facet id in cell
    facet_tags: np.ndarray = field(default=None, repr=False)  # (nf,) int32 markers (0 = untagged)
    dtype: np.dtype = np.float64

    def __post_init__(self):
        self.cell_type = as_cell_type(self.cell_type)
        self.points = np.ascontiguousarray(self.points, dtype=self.dtype)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        self._reorder_locality()
        if self.facets is None:
            self._build_topology()
        if self.facet_tags is None:
            self.facet_tags = np.zeros(len(self.facets), dtype=np.int32)

    def _reorder_locality(self) -> None:
        """Renumber vertices along a space-filling curve (Hilbert in 2D,
        Morton in 3D). Spatially-near nodes get near indices, which is
        what the supernode-blocked sparse layouts (la/superell.py) need:
        grouping g consecutive node ids into one gathered row only pays
        off when consecutive ids are mesh neighbours. Deterministic;
        disable with CFDTPU_NO_REORDER=1."""
        import os

        if os.environ.get("CFDTPU_NO_REORDER") or len(self.points) < 64:
            return
        key = _sfc_key(self.points)
        perm = np.argsort(key, kind="stable").astype(np.int64)
        inv = np.empty(len(perm), dtype=np.int64)
        inv[perm] = np.arange(len(perm))
        self.points = np.ascontiguousarray(self.points[perm])
        self.cells = np.ascontiguousarray(
            inv[self.cells].astype(np.int32)
        )
        if self.facets is not None:
            self.facets = np.ascontiguousarray(
                inv[self.facets].astype(np.int32)
            )

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        """Topological dimension."""
        return cell_dim(self.cell_type)

    @property
    def gdim(self) -> int:
        return self.points.shape[1]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def facet_type(self) -> CellType:
        return facet_cell_type(self.cell_type)

    def h(self) -> np.ndarray:
        """Per-cell diameter (max vertex distance), like dolfinx mesh.h
        (reference: /root/reference/src/solvers/stabilized_schur.py:85-88)."""
        pts = self.points[self.cells]  # (nc, nv, gdim)
        d = np.linalg.norm(pts[:, :, None, :] - pts[:, None, :, :], axis=-1)
        return d.max(axis=(1, 2))

    # ------------------------------------------------------------------
    def _build_topology(self) -> None:
        local_facets = cell_facets(self.cell_type)
        nfv = len(local_facets[0])
        nc = self.num_cells

        from ..native import boundary_facets as native_bf

        native = native_bf(self.cells, np.asarray(local_facets))
        if native is not None:
            fverts, cells_of, lf_of = native
        else:
            # numpy fallback: all (cell, local facet) facets keyed by
            # sorted vertex tuple; boundary = count 1
            all_f = np.concatenate(
                [self.cells[:, list(f)] for f in local_facets], axis=0
            )  # (nc * nlf, nfv), block i holds local facet i of all cells
            keys = np.sort(all_f, axis=1)
            _, first_idx, inverse, counts = np.unique(
                keys, axis=0, return_index=True, return_inverse=True,
                return_counts=True,
            )
            boundary_unique = np.where(counts == 1)[0]
            rows = first_idx[boundary_unique]
            cells_of = (rows % nc).astype(np.int32)
            lf_of = (rows // nc).astype(np.int32)
            fverts = all_f[rows].astype(np.int32)

        # Orient outward.
        fverts = self._orient_outward(fverts, cells_of)

        order = np.lexsort(fverts.T[::-1])  # deterministic ordering
        self.facets = fverts[order]
        self.facet_cells = cells_of[order]
        self.facet_local_index = lf_of[order]

    def _orient_outward(self, fverts: np.ndarray, fcells: np.ndarray):
        """Reorder facet vertices so the natural normal points outward.

        2D: edge (a, b) with normal (t_y, -t_x), t = b - a.
        3D: normal (v1 - v0) x (v2 - v0).
        """
        pts = self.points
        cell_centroid = pts[self.cells[fcells]].mean(axis=1)
        facet_centroid = pts[fverts].mean(axis=1)
        outward = facet_centroid - cell_centroid

        if self.dim == 2:
            t = pts[fverts[:, 1]] - pts[fverts[:, 0]]
            n = np.stack([t[:, 1], -t[:, 0]], axis=-1)
            flip = (n * outward[:, : 2]).sum(axis=1) < 0
            fverts = fverts.copy()
            fverts[flip] = fverts[flip][:, ::-1]
        elif self.dim == 3:
            v0 = pts[fverts[:, 0]]
            n = np.cross(pts[fverts[:, 1]] - v0, pts[fverts[:, 2]] - v0)
            flip = (n * outward).sum(axis=1) < 0
            fverts = fverts.copy()
            # Swap vertices 1 and 2 (works for tri and tensor-quad facets:
            # for quads stored (00,10,01,11) swapping 1<->2 mirrors s<->t).
            fverts[flip, 1], fverts[flip, 2] = (
                fverts[flip, 2].copy(),
                fverts[flip, 1].copy(),
            )
        return fverts

    # ------------------------------------------------------------------
    def locate_boundary_facets(self, marker) -> np.ndarray:
        """Indices of boundary facets all of whose vertices satisfy marker.

        `marker` takes x of shape (gdim, n) and returns a boolean (n,)
        array — same convention as dolfinx locate_entities_boundary
        (reference: /root/reference/src/scenarios/lid_driven2D.py:40).
        """
        on = np.asarray(marker(self.points.T))
        return np.where(on[self.facets].all(axis=1))[0].astype(np.int32)

    def mark_boundary_facets(self, marker, tag: int) -> None:
        """Set facet_tags to `tag` on facets selected by `marker`."""
        idx = self.locate_boundary_facets(marker)
        self.facet_tags[idx] = tag

    def tagged_facets(self, tag) -> np.ndarray:
        """Boundary facet indices with one of the given tag value(s)."""
        tags = np.atleast_1d(np.asarray(tag, dtype=np.int32))
        return np.where(np.isin(self.facet_tags, tags))[0].astype(np.int32)

    def midpoints_of_facets(self, facet_idx) -> np.ndarray:
        return self.points[self.facets[facet_idx]].mean(axis=1)
