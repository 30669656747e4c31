"""Dirichlet boundary conditions.

Mirrors the reference BoundaryCondition API
(/root/reference/src/boundaryCondition.py:14-55): wrap a prescribed value,
bind it to dofs either topologically (boundary facet indices) or
geometrically (coordinate marker), and support per-step re-evaluation for
time-dependent values. Here a DirichletBC is just (dof indices,
value array); values are recomputed on the host per step (tiny boundary
data) and fed to the jitted solve as inputs, so time-varying BCs never
trigger recompilation.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .space import FunctionSpace


class DirichletBC:
    """Bound boundary condition: scalar-dof indices + current values."""

    def __init__(self, space: FunctionSpace, dofs: np.ndarray, value):
        self.space = space
        self.dofs = np.asarray(dofs, dtype=np.int32)
        self._value = value  # callable f(x) or array
        self.values = self._eval()

    def _eval(self) -> np.ndarray:
        v = self._value
        if callable(v):
            x = self.space.dof_coords[self.dofs].T  # (gdim, k)
            vals = np.asarray(v(x), dtype=self.space.mesh.points.dtype)
            if self.space.num_components == 1:
                return vals.reshape(len(self.dofs))
            return np.ascontiguousarray(vals.T)
        vals = np.asarray(v, dtype=self.space.mesh.points.dtype)
        if vals.ndim == 0 or vals.shape[0] != len(self.dofs):
            # constant value broadcast over dofs
            shape = (
                (len(self.dofs),)
                if self.space.num_components == 1
                else (len(self.dofs), self.space.num_components)
            )
            return np.broadcast_to(vals, shape).copy()
        return vals

    def update(self) -> None:
        """Re-evaluate the prescribed value (for time-varying BCs); mirrors
        the monkey-patched bc.update() in the reference
        (/root/reference/src/boundaryCondition.py:48-52)."""
        self.values = self._eval()

    def set_value(self, value) -> None:
        self._value = value
        self.update()


class BoundaryCondition:
    """Unbound boundary condition, reference-compatible construction API.

    `f` is a callable x -> values (x of shape (gdim, n)), an array over the
    target space, or a constant. Bind dofs with initTopological (boundary
    facet indices) or initGeometrical (marker), then getBC(V).
    """

    def __init__(self, f):
        self.f = f
        self._topological = False
        self._geometrical = False
        self.entities = None
        self.marker = None

    def initTopological(self, entity_dim: int, entities: np.ndarray) -> None:
        assert not (self._topological or self._geometrical)
        self.entity_dim = entity_dim
        self.entities = np.asarray(entities, dtype=np.int64)
        self._topological = True

    def initGeometrical(self, marker: Callable) -> None:
        assert not (self._topological or self._geometrical)
        self.marker = marker
        self._geometrical = True

    def getBC(self, V: FunctionSpace) -> DirichletBC:
        assert self._topological or self._geometrical
        if self._topological:
            dofs = V.facet_closure_dofs(self.entities)
        else:
            dofs = V.locate_dofs_geometrical(self.marker)
        value = self.f
        if isinstance(value, np.ndarray) and value.shape[0] == V.num_dofs:
            # array over the whole space: restrict to the BC dofs, but keep
            # it live so update() re-reads mutations (reference scenarios
            # mutate the wrapped Function then call bc.update()).
            full = value

            def _restrict(x, _full=full, _dofs=dofs):
                return np.asarray(_full)[_dofs].T

            value = _restrict
        return DirichletBC(V, dofs, value)


def combine_bcs(bcs: list[DirichletBC], num_components: int):
    """Concatenate BC dof/value arrays, deduplicating so that the LAST bc
    in the list wins on overlapping dofs. Returns (dofs (k,), index map)
    where values must be re-gathered each step via `gather_values`."""
    if not bcs:
        dofs = np.empty(0, dtype=np.int32)
        return dofs, []
    all_dofs = np.concatenate([bc.dofs for bc in bcs])
    # keep last occurrence
    _, last_idx = np.unique(all_dofs[::-1], return_index=True)
    keep = len(all_dofs) - 1 - last_idx  # indices into concatenated arrays
    keep.sort()
    return all_dofs[keep].astype(np.int32), keep


def gather_values(bcs: list[DirichletBC], keep) -> np.ndarray:
    vals = np.concatenate([np.atleast_1d(bc.values) for bc in bcs], axis=0)
    return vals[keep]
