"""DFG channel-with-cylinder geometry (shared by dfg_1 / dfg_2d_1 /
pipe_cylinder scenarios; reference geometry at
/root/reference/src/scenarios/dfg_1.py:97-171)."""

from __future__ import annotations

import numpy as np

from ..mesh import Mesh
from ..mesh.cache import cache_path, load_mesh, save_mesh
from .delaunay2d import generate_mesh_2d, polyline_loop

L = 2.2
H = 0.41
CX = CY = 0.2
R = 0.05


def generate_dfg_mesh(
    res_min: float | None = None,
    res_max: float | None = None,
    res_scale: float = 1.0,
    dtype=np.float64,
    inlet_marker=2,
    outlet_marker=3,
    wall_marker=4,
    obstacle_marker=5,
) -> Mesh:
    """Distance-graded mesh of the 2.2 x 0.41 channel with the r = 0.05
    cylinder at (0.2, 0.2); refinement res_min = r/6 near the obstacle
    growing to H/13 within 2H (the reference's gmsh Threshold field)."""
    res_min = (R / 6 if res_min is None else res_min) * res_scale
    res_max = (H / 13 if res_max is None else res_max) * res_scale

    # disk cache (mesh/cache.py): keyed by the full sizing tuple, so a
    # repeated run skips the host build at large res_scale
    ckey = cache_path("dfg2d", (
        float(res_min), float(res_max), np.dtype(dtype).name,
        int(inlet_marker), int(outlet_marker), int(wall_marker),
        int(obstacle_marker),
    ))
    cached = load_mesh(ckey)
    if cached is not None:
        return cached

    def size_fn(x):  # batched: points along the LAST axis
        x = np.asarray(x)
        d = np.hypot(x[..., 0] - CX, x[..., 1] - CY) - R
        t = np.clip((d - R) / (2 * H - R), 0.0, 1.0)
        return res_min + (res_max - res_min) * t

    outer = polyline_loop([(0, 0), (L, 0), (L, H), (0, H)], size_fn)
    nth = max(12, int(round(2 * np.pi * R / res_min)))
    th = np.linspace(0, 2 * np.pi, nth, endpoint=False)
    hole = np.stack([CX + R * np.cos(th), CY + R * np.sin(th)], axis=-1)
    m = generate_mesh_2d(
        outer, [hole], size_fn, dtype=dtype,
        # exact membership predicates (rectangle / disc) replace the
        # even-odd polygon sweeps — the large-mesh host-setup hotspot
        inside_fn=lambda P: (
            (P[:, 0] > 0) & (P[:, 0] < L) & (P[:, 1] > 0) & (P[:, 1] < H)
        ),
        hole_fns=[
            lambda P: np.hypot(P[:, 0] - CX, P[:, 1] - CY) < R
        ],
    )

    m.mark_boundary_facets(lambda x: np.isclose(x[0], 0.0), inlet_marker)
    m.mark_boundary_facets(lambda x: np.isclose(x[0], L), outlet_marker)
    m.mark_boundary_facets(
        lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], H), wall_marker
    )
    m.mark_boundary_facets(
        lambda x: np.hypot(x[0] - CX, x[1] - CY) < R + res_min,
        obstacle_marker,
    )
    save_mesh(ckey, m)
    return m
