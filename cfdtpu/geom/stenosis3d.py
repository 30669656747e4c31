"""3D stenosed-vessel geometry pipeline (consumed surface).

Rebuild of /root/reference/src/geom/stenosis/stenosis.py: a lofted OCC
solid from start/end points with radius_in/out, severity
(R_min = (1 - severity) R), slope and position; physical tags INLET=1 /
OUTLET=2 / WALL=3 / FLUID=4 (:12-15); curvature-based mesh sizing.

The reference builds the solid with CadQuery and meshes it with gmsh —
offline preprocessing tools absent from this runtime image. Here the
same API surface runs fully natively: `generate_stenosis_geometry`
returns the axis + radius-law description (all the information the
lofted solid carries) and `mesh_and_export` tet-meshes it with the
implicit-union cleaver (geom/implicit3d.py) and writes the tagged .msh
via cfdtpu.mesh.write_msh, honoring the reference's curvature-based
sizing rule. The radial-scale affine transform (reference :323-335) and
.msh ingestion (cfdtpu.mesh.read_msh) are kept for offline-mesh interop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INLET_TAG = 1
OUTLET_TAG = 2
WALL_TAG = 3
FLUID_TAG = 4


def get_radial_scale_matrix(start_pt, end_pt, scale=0.8):
    """4x4 affine (row-major flattened) scaling radially about the vessel
    axis: eigenvalue 1 along the axis, `scale` transversally
    (reference :323-335)."""
    vec = np.array(end_pt, dtype=float) - np.array(start_pt, dtype=float)
    length = np.linalg.norm(vec)
    direction = vec / length if length > 0 else np.array([1.0, 0.0, 0.0])
    S = np.eye(3) * scale + (1 - scale) * np.outer(direction, direction)
    offset = np.array(start_pt, dtype=float) - S @ np.array(
        start_pt, dtype=float
    )
    M = np.eye(4)
    M[:3, :3] = S
    M[:3, 3] = offset
    return M.flatten().tolist()


def stenosis_radius_law(
    s, length, radius_in, radius_out, severity, slope, position
):
    """Axial radius law r(s), s in [0, L]: linear taper with the stenosis
    reduction R_min = (1 - severity) r_taper(position) over a region of
    half-width h/slope (matching the 2D profile in geom/stenosis2d.py and
    the 3D radial scaling of the reference)."""
    s = np.asarray(s, dtype=float)
    r_taper = radius_in + (radius_out - radius_in) * (s / length)
    r_mid = radius_in + (radius_out - radius_in) * (position / length)
    h = severity * r_mid
    dist = h / slope if slope > 0 else length / 4
    dist = min(dist, min(position, length - position) * 0.95)
    dx = np.abs(s - position)
    bump = np.where(
        dx < dist, h * 0.5 * (1.0 + np.cos(np.pi * dx / dist)), 0.0
    )
    return np.maximum(r_taper - bump, 1e-9)


@dataclasses.dataclass
class StenosisGeometry:
    """Native stand-in for the reference's CadQuery lofted solid
    (src/geom/stenosis/stenosis.py:81-274): the full geometry is the
    axis line plus the axial radius law, which is everything the
    implicit-union mesher needs. `radius_at(s)` evaluates the law at
    arc length s in [0, length]."""

    start: np.ndarray
    end: np.ndarray
    radius_in: float
    radius_out: float
    min_radius: float
    slope: float
    position: float  # relative [0, 1] along the axis

    @property
    def length(self) -> float:
        return float(np.linalg.norm(self.end - self.start))

    @property
    def severity(self) -> float:
        # taper radius at the stenosis centre; min_radius = (1-sev)*r
        r_mid = self.radius_in + (
            self.radius_out - self.radius_in
        ) * self.position
        return max(0.0, 1.0 - self.min_radius / r_mid)

    def radius_at(self, s):
        return stenosis_radius_law(
            s, self.length, self.radius_in, self.radius_out,
            self.severity, self.slope, self.position * self.length,
        )


def generate_stenosis_geometry(
    start, end, radius_in, radius_out, min_radius, slope, position=0.5
) -> StenosisGeometry:
    """Reference-parity entry point (src/geom/stenosis/stenosis.py:81):
    validates the parameters exactly like the reference and returns the
    geometry description. The reference returns a CadQuery solid for
    gmsh to mesh offline; here the returned StenosisGeometry feeds the
    native implicit-union tet mesher in mesh_and_export, so the whole
    pipeline runs with no CAD dependencies."""
    if slope >= 0.85:
        raise ValueError(
            "slope >= 0.85 produces a throat too steep to mesh at "
            "usable quality"
        )
    if radius_out > radius_in:
        raise ValueError(
            f"radius_out ({radius_out}) must be <= radius_in "
            f"({radius_in})"
        )
    if not (0.0 <= position <= 1.0):
        raise ValueError(f"Position must be in [0, 1], got {position}")
    start_v = np.asarray(start, dtype=float)
    end_v = np.asarray(end, dtype=float)
    if np.linalg.norm(end_v - start_v) <= 0:
        raise ValueError("start and end must be distinct points")
    if not (0.0 < min_radius <= radius_out):
        raise ValueError(
            f"min_radius ({min_radius}) must be in (0, radius_out]"
        )
    return StenosisGeometry(
        start=start_v, end=end_v, radius_in=float(radius_in),
        radius_out=float(radius_out), min_radius=float(min_radius),
        slope=float(slope), position=float(position),
    )


def mesh_and_export(
    solid: StenosisGeometry,
    filename_brep,
    filename_msh,
    start_pt=None,
    end_pt=None,
    artery_mesh_size_from_curvature: int = 20,
    radius_in: float | None = None,
    radius_out: float | None = None,
):
    """Reference-parity entry point (src/geom/stenosis/stenosis.py:337):
    mesh the vessel and write the tagged .msh. The reference exports a
    BREP and runs gmsh offline; here the implicit-union cleaver
    (geom/implicit3d.py) produces the tet mesh natively and
    cfdtpu.mesh.write_msh writes a gmsh-v2-compatible file with the
    same physical tags (INLET=1/OUTLET=2/WALL=3/FLUID=4). The
    curvature-based target size matches the reference's rule
    (:357): h = 2*pi*r_out / artery_mesh_size_from_curvature. In place
    of the BREP, the geometry spec is written to `filename_brep` as
    JSON so the two-artifact file contract of the reference pipeline
    still holds. Returns the Mesh."""
    import json as _json

    from ..mesh.msh import write_msh
    from .implicit3d import mesh_implicit_union

    r_out = float(radius_out if radius_out is not None
                  else solid.radius_out)
    h = 2.0 * np.pi * r_out / float(artery_mesh_size_from_curvature)
    # resolve the throat: at least ~2.5 cells across the min radius
    h = min(h, solid.min_radius / 2.5)
    length = solid.length
    axis = (solid.end - solid.start) / length
    n_axial = int(np.clip(np.ceil(length / max(h, 1e-12)), 32, 256))
    s = np.linspace(0.0, length, n_axial + 1)
    r = solid.radius_at(s)
    segments = [
        (solid.start + s[i] * axis, solid.start + s[i + 1] * axis,
         float(r[i]), float(r[i + 1]))
        for i in range(n_axial)
    ]
    mesh = mesh_implicit_union(
        segments, float(h),
        inlet_end=(solid.start.copy(), -axis),
        outlet_ends=[(solid.end.copy(), axis)],
    )
    if filename_brep:
        spec = dataclasses.asdict(solid)
        spec = {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in spec.items()
        }
        with open(filename_brep, "w") as f:
            _json.dump({"cfdtpu_stenosis_geometry": spec}, f, indent=1)
        print(f"[INFO] geometry spec exported to {filename_brep}")
    if filename_msh:
        write_msh(mesh, filename_msh, fluid_tag=FLUID_TAG)
        print(f"[INFO] mesh exported to {filename_msh}")
    return mesh


def native_stenosis_mesh(
    length: float = 10.0,
    radius_in: float = 1.0,
    radius_out: float = 0.8,
    severity: float = 0.5,
    slope: float = 0.3,
    position: float = 5.0,
    h: float | None = None,
    n_axial: int = 48,
    dtype=np.float64,
):
    """Native 3D stenosed-vessel tet mesh — no CadQuery/gmsh.

    The axial radius law r(s) (stenosis_radius_law) is sampled into
    n_axial short tapered capsules and meshed by the implicit-union
    lattice cleaver (geom/implicit3d.py), with the reference tag
    convention INLET=1 / OUTLET=2 / WALL=3. Cell size defaults to
    0.35x the throat radius so the constriction is resolved."""
    from .implicit3d import mesh_implicit_union

    s = np.linspace(0.0, length, n_axial + 1)
    r = stenosis_radius_law(
        s, length, radius_in, radius_out, severity, slope, position
    )
    if h is None:
        h = 0.35 * float(r.min())
    segments = []
    for i in range(n_axial):
        p0 = np.array([s[i], 0.0, 0.0])
        p1 = np.array([s[i + 1], 0.0, 0.0])
        segments.append((p0, p1, float(r[i]), float(r[i + 1])))
    return mesh_implicit_union(
        segments, h,
        inlet_end=(np.array([0.0, 0.0, 0.0]),
                   np.array([-1.0, 0.0, 0.0])),
        outlet_ends=[(np.array([length, 0.0, 0.0]),
                      np.array([1.0, 0.0, 0.0]))],
        dtype=dtype,
    )
