"""On-disk mesh cache (npz).

The reference caches generated meshes and reuses them across runs
(/root/reference/src/scenarios/dfg_1.py:43-51 reloads
meshes/pipe_cylinder.xdmf when present). Here the same idea spares
repeated runs the host mesh build at large sizes: generators key their
output by their full parameter tuple and reload the exact arrays
instead.

Exactness matters: cached executables in JAX_COMPILATION_CACHE_DIR were
compiled against the generated mesh's shapes and index maps, so the
cache must reproduce the generator's output bit-for-bit. Mesh
generation is deterministic host numpy and the npz roundtrip preserves
arrays exactly; reconstruction passes the stored topology back in, so
__post_init__ skips _build_topology, and _reorder_locality is an
identity on already-SFC-ordered points (stable argsort of a sorted
key).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from .mesh import Mesh

# bump when any mesh generator's output could change for the same key
_CACHE_VERSION = 1


def cache_path(family: str, params: tuple) -> str | None:
    """Resolve the cache file for a generator invocation, or None when
    caching is disabled (CFDTPU_MESH_CACHE=''). Default dir is under
    the temporary directory (TMPDIR): big meshes don't belong in the
    repo."""
    root = os.environ.get(
        "CFDTPU_MESH_CACHE",
        os.path.join(tempfile.gettempdir(), "cfdtpu_mesh_cache"),
    )
    if not root:
        return None
    reorder = os.environ.get("CFDTPU_NO_REORDER", "")
    key = hashlib.sha1(
        repr((_CACHE_VERSION, family, reorder) + params).encode()
    ).hexdigest()[:20]
    return os.path.join(root, f"{family}_{key}.npz")


def load_mesh(path: str | None) -> Mesh | None:
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return Mesh(
                points=z["points"],
                cells=z["cells"],
                cell_type=str(z["cell_type"]),
                facets=z["facets"],
                facet_cells=z["facet_cells"],
                facet_local_index=z["facet_local_index"],
                facet_tags=z["facet_tags"],
                dtype=np.dtype(str(z["dtype"])),
            )
    except Exception:
        return None  # stale/corrupt entry: fall through to regeneration


def save_mesh(path: str | None, m: Mesh) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path), suffix=".npz.tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                points=m.points,
                cells=m.cells,
                cell_type=str(m.cell_type),
                facets=m.facets,
                facet_cells=m.facet_cells,
                facet_local_index=m.facet_local_index,
                facet_tags=m.facet_tags,
                dtype=np.dtype(m.dtype).name,
            )
        os.replace(tmp, path)  # atomic: concurrent retries never see a torn file
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
