"""Content-addressed disk cache for symbolic-setup numpy products.

The big-mesh host setup is dominated by deterministic index-map
construction — scatter layouts (utils/geometry.SortedScatter), the RAS
window maps (la/ras.py), the distance-2 Schur graph (la/nodebsr.py
sp_structure) — ~160 of 190 profiled seconds at 949,929 DOF. Every
product is a pure function of exact input arrays plus a few scalars, so
they are cached the same way meshes are (mesh/cache.py): keyed by a
digest of the inputs' raw bytes, stored as npz, reloaded bit-for-bit.
Bit-exactness matters for the same reason as the mesh cache: the
persistent-compile-cache executables were traced against these maps.

The reference leans on PETSc's C symbolic phases for the analogous maps
(ILU/ASM structures, MatPtAP symbolic); here the maps are numpy and the
cache removes their rebuild cost from repeated runs and restarts.

Disable with CFDTPU_SYM_CACHE='' (default dir cfdtpu_sym_cache under
the temporary directory, TMPDIR).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

# bump when any cached builder's output could change for the same key
_CACHE_VERSION = 1


def _digest(parts) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(_CACHE_VERSION).encode())
    for p in parts:
        if isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(f"A{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
        else:
            h.update(f"S{p!r}".encode())
    return h.hexdigest()


def cached_arrays(family: str, key_parts, build):
    """Return build()'s dict of numpy arrays, disk-cached.

    key_parts: iterable of numpy arrays and scalars that fully
        determine the output (hashed by exact bytes — no false hits).
    build: () -> dict[str, np.ndarray | int | float]; scalars are
        stored as 0-d arrays and returned as python ints/floats.
    """
    root = os.environ.get(
        "CFDTPU_SYM_CACHE",
        os.path.join(tempfile.gettempdir(), "cfdtpu_sym_cache"),
    )
    if not root:
        return build()
    path = os.path.join(root, f"{family}_{_digest(key_parts)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                return {
                    k: (v.item() if v.ndim == 0 else v)
                    for k, v in z.items()
                }
        except Exception:
            pass  # stale/torn entry: rebuild below
    out = build()
    try:
        os.makedirs(root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **out)
            os.replace(tmp, path)  # atomic for concurrent retries
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    except OSError:
        pass
    return out
