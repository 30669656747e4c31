"""Supernode-blocked ELL sparse layout (the gather-amortizing format).

Premise: a gather whose cost is per ROW more than per byte is served
best by FEWER, WIDER gathered rows. This module groups g consecutive
node ids into one supernode; coupled supernode pairs own dense
(g*bs, g*bs) blocks in an ELL layout, and the matvec gathers
(g*bs)-wide rows of the supernode-major x — g*bs = 12 at g=4 in 2D,
against the node-row width of 3. The premise was measured on earlier
hardware; on the GPU the matvec is bandwidth-bound, and whether the
layout still pays is open (ROADMAP A3, scripts/gather_shapes.py).

The grouping only works on a locality-ordered mesh (consecutive ids =
spatial neighbours): Mesh renumbers vertices along a Hilbert curve at
construction (mesh/mesh.py _reorder_locality). Measured fill on the DFG
mesh at g=4: 4.7x denser value storage than node-BSR — values are
streamed, gathers are not.

Replaces what PETSc gets from its AIJ/BAIJ formats + cache locality on
CPUs (reference relies on PETSc MatMult inside every Krylov iteration,
/root/reference/src/solvers/stabilized_schur.py:226-229).

Row layout inside a superblock (matching the solver's flat dof layout
[u.reshape(-1), p]): local node a in [0, g), velocity component i in
[0, d) sits at row a*d + i; the pressure dof of node a at row g*d + a.
The gathered x rows are then built by PURE RESHAPES of u (n, d) and p —
no index shuffle at matvec time.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


class SuperMaps:
    """Static supernode maps for a node-pair COO graph (row, col, n)."""

    __slots__ = ("g", "ns", "Kg", "sup_cols", "pair_slot", "n")

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int, g: int):
        self.g = int(g)
        self.n = int(n)
        ns = -(-n // g)
        self.ns = ns
        srow = (row // g).astype(np.int64)
        scol = (col // g).astype(np.int64)
        keys = srow * ns + scol
        uniq, inv = np.unique(keys, return_inverse=True)
        urow = uniq // ns
        ucol = uniq % ns
        cnt = np.bincount(urow, minlength=ns)
        Kg = int(cnt.max()) if len(uniq) else 1
        starts = np.cumsum(cnt) - cnt
        slot_of_pair = np.arange(len(uniq)) - starts[urow]
        cols = np.full(ns * Kg, ns, dtype=np.int64)
        cols[urow * Kg + slot_of_pair] = ucol
        self.Kg = Kg
        self.sup_cols = jnp.asarray(
            cols.reshape(ns, Kg).astype(np.int32)
        )
        # per-COO-entry (pair) slot id in [0, ns*Kg)
        self.pair_slot = (urow * Kg + slot_of_pair)[inv]

    def row_offsets(self, row_in_group: np.ndarray, comp: np.ndarray,
                    d: int) -> np.ndarray:
        """Row index inside the (g*(d+1)) superblock for (local node a,
        component c): u components first (a*d+c), p dofs after (g*d+a)."""
        a = row_in_group
        return np.where(comp < d, a * d + comp, self.g * d + a)

    def scalar_positions(self, row: np.ndarray, col: np.ndarray
                         ) -> np.ndarray:
        """Flat positions of scalar COO entries in (ns*Kg, g, g)."""
        g = self.g
        return (self.pair_slot * g + row % g) * g + col % g

    def block_positions_uniform(self, row: np.ndarray, col: np.ndarray,
                                d: int) -> np.ndarray:
        """Flat positions for pure (d x d) blocks (all rows are
        components of the same field): local node a, component i sits at
        superblock row a*d + i. Returns (nnz, d, d) int64."""
        g = self.g
        gd = g * d
        a = (row % g)[:, None]
        b = (col % g)[:, None]
        comp = np.arange(d)[None, :]
        roff = a * d + comp
        coff = b * d + comp
        return (
            (self.pair_slot[:, None, None] * gd + roff[:, :, None]) * gd
            + coff[:, None, :]
        )

    def block_positions(self, row: np.ndarray, col: np.ndarray, d: int
                        ) -> np.ndarray:
        """Flat positions of all (d+1)x(d+1) node-block scalar entries in
        (ns*Kg, gbs, gbs): returns (nnz, bs, bs) int64."""
        g = self.g
        bs = d + 1
        gbs = g * bs
        a = (row % g)[:, None]
        b = (col % g)[:, None]
        comp = np.arange(bs)[None, :]
        roff = np.where(comp < d, a * d + comp, g * d + a)  # (nnz, bs)
        coff = np.where(comp < d, b * d + comp, g * d + b)
        return (
            (self.pair_slot[:, None, None] * gbs + roff[:, :, None]) * gbs
            + coff[:, None, :]
        )


def place_scalar(maps: SuperMaps, row, col, vals):
    """Scatter scalar COO values into the (ns, Kg, g, g) layout
    (unique positions; jittable)."""
    pos = jnp.asarray(
        maps.scalar_positions(np.asarray(row), np.asarray(col))
        .astype(np.int32)
    )
    g = maps.g
    out = jnp.zeros((maps.ns * maps.Kg * g * g,), vals.dtype)
    out = out.at[pos].set(vals, unique_indices=True,
                          mode="promise_in_bounds")
    return out.reshape(maps.ns, maps.Kg, g, g)


def sup_matvec(maps: SuperMaps, vals_sup, x):
    """y = A x for scalar x (n,), vals_sup (ns, Kg, g, g)."""
    g, ns, n = maps.g, maps.ns, maps.n
    xp = jnp.zeros((ns * g,), x.dtype).at[:n].set(x)
    x_sup = jnp.concatenate(
        [xp.reshape(ns, g), jnp.zeros((1, g), x.dtype)], axis=0
    )
    xg = x_sup[maps.sup_cols]  # (ns, Kg, g)
    y = jnp.einsum(
        "skab,skb->sa", vals_sup, xg, preferred_element_type=x.dtype
    )
    return y.reshape(-1)[:n]
