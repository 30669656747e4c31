"""Restricted additive Schwarz (RAS) with batched dense subdomain solves.

The reference preconditions its velocity block with GMRES+ASM sub-KSPs
whose per-process subsolves are ILU factorizations
(/root/reference/src/solvers/stabilized_schur.py:261-264, PETSc default
sub_pc_type ilu). ILU's sequential triangular sweeps do not map onto
wide batched hardware; this module delivers the same "strong local
solve" ingredient in batched form: the Hilbert-ordered node axis
(mesh/mesh.py _reorder_locality) is tiled into contiguous windows of
`s` nodes extended by `overlap` nodes on each side, every window's
velocity submatrix is inverted as one batched `jnp.linalg.inv` (once per
preconditioner build — the lagged-PC default makes that once per time
step), and the application is a single row gather + one batched matmul.
Restricted means each window writes back only its owned center (Cai &
Sarkis RAS) — measured better than full ASM averaging as a Krylov
preconditioner and free of the 2x overlap-count scaling.

Because consecutive Hilbert ids are spatial neighbours, an index-window
IS a geometric subdomain; couplings whose endpoints lie in no common
window are dropped from the local solves exactly as ASM drops
off-process couplings.

Cost model: the apply streams n_sub * (w*d)^2 values — ~5x the
node-BSR A_uu bytes at (s=16, o=4, d=2) — as a batched dense matvec,
and the gather is n/s rows of width w*d.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


class RASPrecond:
    """Static maps for RAS over contiguous node windows.

    Args:
        row, col: node-pair COO graph of the (masked) velocity block,
            row-sorted (NodeBSR.block_row/block_col).
        n: number of nodes.
        d: velocity components per node (block size).
        s: owned nodes per window.
        overlap: extra nodes on each side of the window.
    """

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int, d: int,
                 s: int = 16, overlap: int = 4):
        self.n = int(n)
        self.d = int(d)
        self.s = s = int(s)
        self.o = o = int(overlap)
        self.w = w = s + 2 * o
        self.m = m = w * d
        n_sub = -(-n // s)
        self.n_sub = n_sub

        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        total = n_sub * m * m

        def _build():
            # window k holds nodes [k*s - o, k*s + s + o); node x is in
            # window k iff floor((x - s - o)/s) < k <= floor((x + o)/s)
            lo = np.maximum(
                np.maximum((row - s - o) // s + 1,
                           (col - s - o) // s + 1), 0
            )
            up = np.minimum(
                np.minimum((row + o) // s, (col + o) // s), n_sub - 1
            )
            n_cand = (
                int(np.maximum(up - lo + 1, 0).max()) if len(row) else 1
            )
            # scatter positions: entry (r, c) lands in window k at local
            # block (r - (k*s - o), c - (k*s - o)); each (k, r, c)
            # triple is unique so one concatenated unique-index scatter
            # suffices, out-of-range candidates get an OOB sentinel
            # (mode="drop")
            pos_slots = []
            ij = np.arange(d)
            for t in range(max(n_cand, 1)):
                k = lo + t
                ok = k <= up
                base = k * s - o
                lr = (row - base) * d
                lc = (col - base) * d
                p = (
                    (k[:, None] * m + lr[:, None] + ij[None, :])[:, :, None]
                    * m + (lc[:, None] + ij[None, :])[:, None, :]
                )
                p = np.where(ok[:, None, None], p, total)
                pos_slots.append(p)
            pos = np.concatenate(pos_slots, axis=0)
            return {
                "n_cand": np.int64(max(n_cand, 1)),
                "pos": pos.astype(
                    np.int64 if total >= 2**31 else np.int32
                ),
            }

        # the window-position map is a big-mesh setup hotspot (38 s of
        # the 190 s host setup at 950k DOF) and a pure function of the
        # graph + (n, d, s, o) — disk-cached for large graphs
        if len(row) >= (1 << 20):
            from ..utils.symcache import cached_arrays

            got = cached_arrays(
                "ras_pos", (row, col, n, d, s, o), _build
            )
        else:
            got = _build()
        self._n_cand = int(got["n_cand"])
        self._pos = jnp.asarray(got["pos"])
        self._total = total

        # gather index (n_sub, w) with an n-sentinel for padding nodes,
        # and the per-row validity (padding rows become identity)
        win = (np.arange(n_sub)[:, None] * s - o + np.arange(w)[None, :])
        invalid = (win < 0) | (win >= n)
        win = np.where(invalid, n, win)
        self._win = jnp.asarray(win.astype(np.int32))
        inv_rows = np.repeat(invalid, d, axis=1)  # (n_sub, m)
        self._eye_add = jnp.asarray(inv_rows.astype(np.float32))

    # -- per-PC-build (jittable) -----------------------------------------
    def build(self, uu_vals, dtype=None):
        """uu_vals: (nnz, d, d) masked velocity blocks aligned with the
        (row, col) graph (NodeBSR.uu_vals — Dirichlet rows/cols zeroed,
        identity diagonal). Returns batched inverses (n_sub, m, m)."""
        m = self.m
        v = jnp.broadcast_to(
            uu_vals[None], (self._n_cand,) + uu_vals.shape
        ).reshape(-1, self.d, self.d)
        flat = jnp.zeros((self._total,), uu_vals.dtype)
        flat = flat.at[self._pos.reshape(-1)].set(
            v.reshape(-1), unique_indices=True, mode="drop"
        )
        A = flat.reshape(self.n_sub, m, m)
        # identity rows for window padding (nodes outside [0, n))
        eye = self._eye_add.astype(A.dtype)
        A = A + eye[:, :, None] * jnp.eye(m, dtype=A.dtype)[None]
        inv = jnp.linalg.inv(A)
        if dtype is not None:
            inv = inv.astype(dtype)
        return inv

    # -- apply (jittable) --------------------------------------------------
    def apply(self, inv, x):
        """x: (n*d,) flat velocity vector -> RAS-preconditioned vector."""
        n, d, o, s = self.n, self.d, self.o, self.s
        xn = jnp.concatenate(
            [x.reshape(n, d), jnp.zeros((1, d), x.dtype)], axis=0
        )
        xw = xn[self._win].reshape(self.n_sub, self.m)
        z = jnp.einsum(
            "kab,kb->ka", inv, xw.astype(inv.dtype),
            preferred_element_type=x.dtype,
        )
        zc = z.reshape(self.n_sub, self.w, d)[:, o:o + s, :]
        return zc.reshape(-1)[: n * d].astype(x.dtype)
