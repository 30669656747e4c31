"""Small-matrix geometry helpers.

Explicit cofactor formulas for the 1x1/2x2/3x3 element Jacobians instead of
jnp.linalg.inv/det: LU decomposition is overkill for these tiny batched
matrices — cofactors are pure elementwise math that XLA fuses into the
surrounding kernel.
"""

from __future__ import annotations

import jax.numpy as jnp


def det_and_inv(J):
    """Determinant and inverse of batched small square matrices.

    J has shape (..., d, d) with d in {1, 2, 3}. Returns (det (...,),
    inv (..., d, d)).
    """
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = (1.0 / det)[..., None, None]
        return det, inv
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        idet = 1.0 / det
        inv = jnp.stack(
            [
                jnp.stack([e * idet, -b * idet], axis=-1),
                jnp.stack([-c * idet, a * idet], axis=-1),
            ],
            axis=-2,
        )
        return det, inv
    if d == 3:
        a = J
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = (
            a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        )
        idet = 1.0 / det
        inv = jnp.stack(
            [
                jnp.stack([c00, c10, c20], axis=-1),
                jnp.stack([c01, c11, c21], axis=-1),
                jnp.stack([c02, c12, c22], axis=-1),
            ],
            axis=-2,
        ) * idet[..., None, None]
        return det, inv
    raise ValueError(f"det_and_inv supports d <= 3, got {d}")


class SortedScatter:
    """Scatter-add via sorted segment_sum.

    jnp's .at[].add lowers to an XLA scatter with colliding indices;
    pre-sorting the contributions by destination dof and using
    segment_sum(indices_are_sorted=True) turns global FEM assembly into a
    sorted reduction (SURVEY.md 7: "assembly = vmapped quadrature +
    segment_sum").

    When the max contributions per destination K is small — always true
    for FEM valences — the scatter is instead laid out as an ELL gather
    (n_out, K) into the padded source and reduced densely over K, which
    XLA executes as vector loads + adds with no scatter at all, and with
    a fixed summation order. Falls back to segment_sum for pathological
    K.
    """

    ELL_MAX_K = 32

    def __init__(self, index_array, n_out: int):
        import numpy as np

        from .symcache import cached_arrays

        flat = np.asarray(index_array).reshape(-1)
        self.n_in = len(flat)
        self.n_out = int(n_out)

        def _build():
            perm = np.argsort(flat, kind="stable")
            cnt = np.bincount(flat, minlength=n_out)
            K = int(cnt.max()) if len(cnt) else 1
            if K <= self.ELL_MAX_K:
                starts = np.cumsum(cnt) - cnt
                slot = np.empty(self.n_in, dtype=np.int64)
                slot[perm] = (
                    flat[perm] * K
                    + (np.arange(self.n_in) - np.repeat(starts, cnt))
                )
                idx = np.full(n_out * K, self.n_in, dtype=np.int64)
                idx[slot] = np.arange(self.n_in)
                return {
                    "K": np.int64(K),
                    "ell_idx": idx.reshape(n_out, K).astype(np.int32),
                }
            return {
                "K": np.int64(K),
                "perm": perm.astype(np.int32),
                "sorted_ids": flat[perm].astype(np.int32),
            }

        # the sort/slot construction is a big-mesh setup hotspot (72 s
        # of the 190 s host setup at 950k DOF across the assembly/Schur
        # scatters) and a pure function of (flat, n_out) — disk-cached
        # for large maps (small ones rebuild faster than they hash)
        if flat.size >= (1 << 20):
            got = cached_arrays("scatter", (flat, n_out), _build)
        else:
            got = _build()
        self.K = int(got["K"])
        if "ell_idx" in got:
            self.ell_idx = jnp.asarray(got["ell_idx"])
            self.perm = None
        else:
            self.ell_idx = None
            self.perm = jnp.asarray(got["perm"])
            self.sorted_ids = jnp.asarray(got["sorted_ids"])

    def __call__(self, vals_flat):
        """vals_flat: (N, ...) contributions in the index array's
        flattened order; returns (n_out, ...) sums."""
        import jax

        if self.ell_idx is not None:
            pad = jnp.zeros((1,) + vals_flat.shape[1:], vals_flat.dtype)
            src = jnp.concatenate([vals_flat, pad], axis=0)
            return src[self.ell_idx].sum(axis=1)
        v = vals_flat[self.perm]
        return jax.ops.segment_sum(
            v, self.sorted_ids, num_segments=self.n_out,
            indices_are_sorted=True,
        )
