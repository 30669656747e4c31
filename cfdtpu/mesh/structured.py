"""Structured mesh generators.

JAX-side replacements for dolfinx create_unit_square / create_rectangle /
create_box / create_unit_cube (reference usage:
/root/reference/src/scenarios/lid_driven2D.py:30,
/root/reference/src/scenarios/taylor_green.py,
/root/reference/src/scenarios/unit_square_pipe.py,
/root/reference/src/scenarios/unit_cube_pipe.py). Pure numpy; produces
cfdtpu Mesh objects with boundary facets already extracted.
"""

from __future__ import annotations

import numpy as np

from ..elements.cells import CellType
from .mesh import Mesh


def _grid_points(p0, p1, n, dtype):
    axes = [
        np.linspace(p0[d], p1[d], n[d] + 1, dtype=np.float64)
        for d in range(len(n))
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(dtype)


def create_rectangle(
    p0, p1, n, cell_type=CellType.triangle, dtype=np.float64, diagonal="right"
) -> Mesh:
    """Rectangle [p0, p1] with n = (nx, ny) subdivisions."""
    nx, ny = int(n[0]), int(n[1])
    pts = _grid_points(p0, p1, (nx, ny), dtype)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = i.ravel(), j.ravel()
    v00, v10 = vid(i, j), vid(i + 1, j)
    v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)

    cell_type = CellType(str(cell_type))
    if cell_type == CellType.quadrilateral:
        cells = np.stack([v00, v10, v01, v11], axis=-1)
    elif cell_type == CellType.triangle:
        if diagonal == "right":
            t1 = np.stack([v00, v10, v11], axis=-1)
            t2 = np.stack([v00, v11, v01], axis=-1)
        elif diagonal == "left":
            t1 = np.stack([v00, v10, v01], axis=-1)
            t2 = np.stack([v10, v11, v01], axis=-1)
        elif diagonal == "crossed":
            # alternate diagonals for isotropy
            use_right = ((i + j) % 2 == 0)
            t1 = np.where(
                use_right[:, None],
                np.stack([v00, v10, v11], axis=-1),
                np.stack([v00, v10, v01], axis=-1),
            )
            t2 = np.where(
                use_right[:, None],
                np.stack([v00, v11, v01], axis=-1),
                np.stack([v10, v11, v01], axis=-1),
            )
        else:
            raise ValueError(f"unknown diagonal {diagonal!r}")
        cells = np.concatenate([t1, t2], axis=0)
    else:
        raise ValueError(f"unsupported 2D cell type {cell_type}")

    return Mesh(points=pts, cells=cells.astype(np.int32),
                cell_type=cell_type, dtype=np.dtype(dtype))


def create_unit_square(
    nx: int, ny: int | None = None, cell_type=CellType.triangle,
    dtype=np.float64,
) -> Mesh:
    ny = nx if ny is None else ny
    return create_rectangle((0.0, 0.0), (1.0, 1.0), (nx, ny), cell_type,
                            dtype=dtype)


# Kuhn subdivision of a cube into 6 tetrahedra sharing the main diagonal
# (v0, v7); all tets have positive orientation and the triangulation is
# consistent across neighbouring cubes.
_KUHN_TETS = [
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
]


def create_box(
    p0, p1, n, cell_type=CellType.tetrahedron, dtype=np.float64
) -> Mesh:
    nx, ny, nz = int(n[0]), int(n[1]), int(n[2])
    pts = _grid_points(p0, p1, (nx, ny, nz), dtype)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    corners = [  # tensor ordering (x fastest bit)
        vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k), vid(i + 1, j + 1, k),
        vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i, j + 1, k + 1),
        vid(i + 1, j + 1, k + 1),
    ]

    cell_type = CellType(str(cell_type))
    if cell_type == CellType.hexahedron:
        cells = np.stack(corners, axis=-1)
    elif cell_type == CellType.tetrahedron:
        tets = [
            np.stack([corners[a], corners[b], corners[c], corners[d]], axis=-1)
            for (a, b, c, d) in _KUHN_TETS
        ]
        cells = np.concatenate(tets, axis=0)
    else:
        raise ValueError(f"unsupported 3D cell type {cell_type}")

    return Mesh(points=pts, cells=cells.astype(np.int32),
                cell_type=cell_type, dtype=np.dtype(dtype))


def create_unit_cube(
    nx: int, ny: int | None = None, nz: int | None = None,
    cell_type=CellType.tetrahedron, dtype=np.float64,
) -> Mesh:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    return create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (nx, ny, nz),
                      cell_type, dtype=dtype)
