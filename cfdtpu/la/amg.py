"""Aggregation multigrid for the pressure Schur stage.

The reference's pressure-block inner PCs are ASM/ILU/AMG under PETSc
(hypre BoomerAMG at /root/reference/src/solvers/ipcs_midpoint.py:102-110
and stabilized_pcd.py:268-276; ASM at stabilized_schur.py:261-264).
Jacobi-preconditioned inner sweeps (la/schur.py) are not h-robust: the
outer iteration count grows with refinement, which is what caps the
1M-DOF throughput target (PERF.md). This module is the JAX AMG
substitute: plain (unsmoothed) aggregation on the pressure node graph
with piecewise-constant transfer, Galerkin coarse operators via sorted
segment-sums, weighted-Jacobi smoothing, and a dense coarsest solve.

Everything structural (aggregates, coarse sparsity, Galerkin entry maps)
is built once in numpy from the static node-BSR block graph
(la/nodebsr.py); per-Newton-iteration value coarsening and the V-cycle
itself are jit-compiled index arithmetic (segment_sum / gather), which
is exactly the shape XLA compiles into a few fused kernels.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import ops as jox


def _gcr2(matvec, precond, b):
    """Two GCR iterations on A x = b from x0 = 0, preconditioner M.

    The Krylov acceleration of Notay's K-cycle: at coarse levels the
    single recursive cycle is replaced by two M-preconditioned minimal-
    residual steps, which restores (near) h-independent convergence for
    plain-aggregation hierarchies whose V-cycle factor degrades with
    depth. All dot products stay on device — no host sync under jit.

    NONLINEAR in b (coefficients depend on the rhs): only valid where
    the surrounding iteration is flexible (fgmres / gmres_fixed store Z)
    or preonly — never inside a linear operator such as the *_sup
    near-true Schur product (la/schur.py keeps that call plain-V).
    """
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny ** 0.5, b.dtype)
    z1 = precond(b)
    q1 = matvec(z1)
    q1q1 = jnp.maximum(jnp.vdot(q1, q1), tiny)
    a1 = jnp.vdot(q1, b) / q1q1
    x = a1 * z1
    r = b - a1 * q1
    z2 = precond(r)
    q2 = matvec(z2)
    beta = jnp.vdot(q1, q2) / q1q1
    z2 = z2 - beta * z1
    q2 = q2 - beta * q1
    a2 = jnp.vdot(q2, r) / jnp.maximum(jnp.vdot(q2, q2), tiny)
    return x + a2 * z2


def build_aggregates(row, col, n: int, pairwise: bool = False
                     ) -> np.ndarray:
    """Aggregation over the graph (row, col) -> agg id per node.

    Default (root-based): roots swallow their whole neighbourhood
    (aggregates of ~valence+1, aggressive ~7x coarsening). pairwise:
    greedy graph matching into aggregates of <= 2 (plus a second pass
    merging leftover singletons) — slower coarsening (~2x/level, more
    levels) but much better piecewise-constant interpolation quality,
    the AGMG-style trade."""
    order = np.argsort(row, kind="stable")
    row_s, col_s = row[order], col[order]
    ptr = np.searchsorted(row_s, np.arange(n + 1))
    agg = -np.ones(n, dtype=np.int64)
    n_agg = 0
    if pairwise:
        for i in range(n):
            if agg[i] >= 0:
                continue
            nbrs = col_s[ptr[i]:ptr[i + 1]]
            free = nbrs[(agg[nbrs] < 0) & (nbrs != i)]
            agg[i] = n_agg
            if len(free):
                agg[free[0]] = n_agg
            n_agg += 1
        # merge leftover singletons (matched nothing) into a neighbour
        sizes = np.bincount(agg, minlength=n_agg)
        for i in range(n):
            if sizes[agg[i]] > 1:
                continue
            nbrs = col_s[ptr[i]:ptr[i + 1]]
            others = nbrs[nbrs != i]
            if len(others):
                agg[i] = agg[others[0]]
        _, agg = np.unique(agg, return_inverse=True)
        return agg
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = col_s[ptr[i]:ptr[i + 1]]
        if (agg[nbrs] >= 0).any() and len(nbrs) > 1:
            continue  # near an aggregate: leave for phase 2
        agg[i] = n_agg
        agg[nbrs] = n_agg
        n_agg += 1
    for i in range(n):  # phase 2: attach leftovers to a neighbour's agg
        if agg[i] >= 0:
            continue
        nbrs = col_s[ptr[i]:ptr[i + 1]]
        owned = nbrs[agg[nbrs] >= 0]
        if len(owned):
            agg[i] = agg[owned[0]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg


class AMGLevel:
    __slots__ = ("agg", "n_coarse", "entry_map", "entry_order",
                 "row", "col", "diag_pos", "n", "_coarse_coo")

    # transfer protocol shared with PLevel: restrict/prolong (scalar and
    # node-block) + coarsen_vals/coarsen_block_vals. v_cycle and build
    # only touch this protocol, so weighted levels drop in transparently.

    def __init__(self, row, col, n, agg_row=None, agg_col=None,
                 pairwise=False):
        self.row, self.col, self.n = row, col, n
        if agg_row is None:
            agg_row, agg_col = row, col
        agg = build_aggregates(agg_row, agg_col, n, pairwise=pairwise)
        self.n_coarse = int(agg.max()) + 1
        self.agg = jnp.asarray(agg.astype(np.int32))
        # Galerkin P0^T A P0: fine entry (i, j) accumulates into coarse
        # entry (agg i, agg j); precompute the coarse COO + sorted map
        ckeys = agg[row].astype(np.int64) * self.n_coarse + agg[col]
        cuniq, cinv = np.unique(ckeys, return_inverse=True)
        order = np.argsort(cinv, kind="stable")
        self.entry_order = jnp.asarray(order.astype(np.int32))
        self.entry_map = jnp.asarray(cinv[order].astype(np.int32))
        crow = (cuniq // self.n_coarse).astype(np.int32)
        ccol = (cuniq % self.n_coarse).astype(np.int32)
        self._coarse_coo = (crow, ccol)
        dpos = np.searchsorted(
            cuniq,
            np.arange(self.n_coarse, dtype=np.int64) * self.n_coarse
            + np.arange(self.n_coarse),
        )
        self.diag_pos = jnp.asarray(dpos.astype(np.int32))

    @property
    def coarse_coo(self):
        return self._coarse_coo

    def coarsen_vals(self, vals):
        v = vals[self.entry_order]
        return jox.segment_sum(
            v, self.entry_map,
            num_segments=self._coarse_coo[0].shape[0],
            indices_are_sorted=True,
        )

    coarsen_block_vals = coarsen_vals  # blocks sum wholesale (leading axis)

    def restrict(self, r):
        return jox.segment_sum(r, self.agg, num_segments=self.n_coarse)

    def prolong(self, xc):
        return xc[self.agg]

    def restrict_block(self, r, d):
        return jox.segment_sum(
            r.reshape(-1, d), self.agg, num_segments=self.n_coarse
        ).reshape(-1)

    def prolong_block(self, xc, d):
        return xc.reshape(-1, d)[self.agg].reshape(-1)


class PLevel:
    """p-multigrid transfer level: degree-k Lagrange nodes -> the mesh
    vertex (degree-1) space, with embedded-interpolation weights.

    Plain aggregation with piecewise-constant transfer is h-robust for
    P1 node graphs but badly h-DEGRADING for higher-order spaces: the
    constant-per-aggregate coarse space cannot represent the smooth
    error of a P2 operator (measured: ~300 KSP/Newton at 153k DOF P2 vs
    ~17 for P1 — scripts/diag_pc.py). The classical cure (what hypre/
    PETSc users get from p-MG or smoothed aggregation; the reference
    leans on BoomerAMG's distance-2 C/F interpolation) is one WEIGHTED
    first level: restrict to the linear-in-each-cell subspace exactly,
    then run the existing piecewise-constant hierarchy on the vertex
    graph where it is known-good.

    Transfer: fine dof i has parents par[i, :] (vertex ids, padded) with
    weights w[i, :] (the degree-1 basis at dof i's reference node —
    e.g. 0.5/0.5 for P2 edge midpoints; rows sum to 1, so constants are
    reproduced exactly and linears by construction). Restriction is the
    transpose. The Galerkin coarse operator P^T A P expands each fine
    entry (i, j) into <= P*P weighted coarse contributions; the static
    expansion maps are numpy-built once, the per-build value pass is one
    gather + segment_sum like every other level.
    """

    __slots__ = ("n", "n_coarse", "par", "w", "_par_flat", "_w_flat",
                 "_rep_fine", "entry_src", "entry_w", "entry_map",
                 "diag_pos", "_coarse_coo", "coarse_agg_coo")

    def __init__(self, row, col, n, parents, weights, n_coarse,
                 agg_row=None, agg_col=None):
        self.n, self.n_coarse = int(n), int(n_coarse)
        parents = np.asarray(parents, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        fi, a = np.nonzero(weights != 0.0)
        self._rep_fine = jnp.asarray(fi.astype(np.int32))
        self._par_flat = jnp.asarray(parents[fi, a].astype(np.int32))
        self._w_flat = jnp.asarray(weights[fi, a])
        self.par = jnp.asarray(parents.astype(np.int32))
        self.w = jnp.asarray(weights)

        # Galerkin expansion: entry (i, j) with value v contributes
        # w[i, a] * w[j, b] * v into coarse entry (par[i, a], par[j, b])
        P = parents.shape[1]
        wprod = (weights[row][:, :, None]
                 * weights[col][:, None, :]).reshape(-1)
        keys = (parents[row][:, :, None] * self.n_coarse
                + parents[col][:, None, :]).reshape(-1)
        src = np.repeat(np.arange(len(row), dtype=np.int64), P * P)
        keep = wprod != 0.0
        src, keys, wprod = src[keep], keys[keep], wprod[keep]
        cuniq, cinv = np.unique(keys, return_inverse=True)
        order = np.argsort(cinv, kind="stable")
        self.entry_src = jnp.asarray(src[order].astype(np.int32))
        self.entry_w = jnp.asarray(wprod[order])
        self.entry_map = jnp.asarray(cinv[order].astype(np.int32))
        crow = (cuniq // self.n_coarse).astype(np.int32)
        ccol = (cuniq % self.n_coarse).astype(np.int32)
        self._coarse_coo = (crow, ccol)
        dpos = np.searchsorted(
            cuniq,
            np.arange(self.n_coarse, dtype=np.int64) * self.n_coarse
            + np.arange(self.n_coarse),
        )
        self.diag_pos = jnp.asarray(dpos.astype(np.int32))

        # structure-only image of the (sparser) aggregation graph, so
        # the next level keeps aggregating on distance-1 connectivity
        if agg_row is not None:
            akeys = np.unique(
                (parents[agg_row][:, :, None] * self.n_coarse
                 + parents[agg_col][:, None, :])[
                    (weights[agg_row][:, :, None]
                     * weights[agg_col][:, None, :]) != 0.0
                ]
            )
            self.coarse_agg_coo = (
                (akeys // self.n_coarse).astype(np.int64),
                (akeys % self.n_coarse).astype(np.int64),
            )
        else:
            self.coarse_agg_coo = (crow.astype(np.int64),
                                   ccol.astype(np.int64))

    @property
    def coarse_coo(self):
        return self._coarse_coo

    def coarsen_vals(self, vals):
        v = vals[self.entry_src] * self.entry_w.astype(vals.dtype)
        return jox.segment_sum(
            v, self.entry_map,
            num_segments=self._coarse_coo[0].shape[0],
            indices_are_sorted=True,
        )

    def coarsen_block_vals(self, vals):
        v = vals[self.entry_src] * self.entry_w.astype(vals.dtype)[
            :, None, None
        ]
        return jox.segment_sum(
            v, self.entry_map,
            num_segments=self._coarse_coo[0].shape[0],
            indices_are_sorted=True,
        )

    def restrict(self, r):
        return jox.segment_sum(
            r[self._rep_fine] * self._w_flat.astype(r.dtype),
            self._par_flat, num_segments=self.n_coarse,
        )

    def prolong(self, xc):
        return (self.w.astype(xc.dtype) * xc[self.par]).sum(axis=1)

    def restrict_block(self, r, d):
        rn = r.reshape(-1, d)
        return jox.segment_sum(
            rn[self._rep_fine] * self._w_flat.astype(r.dtype)[:, None],
            self._par_flat, num_segments=self.n_coarse,
        ).reshape(-1)

    def prolong_block(self, xc, d):
        xn = xc.reshape(-1, d)
        return (self.w.astype(xc.dtype)[:, :, None]
                * xn[self.par]).sum(axis=1).reshape(-1)


class AMG:
    """Multilevel hierarchy on a scalar COO operator (sorted by row).

    build(vals) -> per-level values (jittable); v_cycle(levels, r) -> z.
    """

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int,
                 coarse_size: int = 800, max_levels: int = 6,
                 omega: float = 0.67, n_smooth: int = 1,
                 agg_row: np.ndarray | None = None,
                 agg_col: np.ndarray | None = None,
                 pairwise: bool = False, kcycle: bool = False,
                 cheby_degree: int = 0, wcycle: bool = False,
                 linear_parents=None):
        """row/col: COO graph of the operator. agg_row/agg_col: optional
        SPARSER graph to aggregate on — for the SELFP matrix (distance-2
        sparsity, ~19 neighbours) aggregating on the distance-1 node
        graph keeps aggregates at ~7 nodes instead of ~20, which
        piecewise-constant transfer needs to stay accurate under
        refinement.

        linear_parents: optional (parents, weights, n_vertices) from
        FunctionSpace.linear_parents() — inserts a weighted p-multigrid
        first level (PLevel) mapping degree-k nodes to the vertex space
        before aggregation takes over. Required for h-robustness on
        higher-order (P2+) node graphs; a no-op worth skipping for P1
        (where nodes == vertices)."""
        self.omega = omega
        self.n_smooth = n_smooth
        # kcycle: accelerate coarse corrections with _gcr2 (Notay
        # K-cycle). Mutable — factories flip it on cached hierarchies;
        # v_cycle(kcycle=False) forces a plain (LINEAR) cycle per call.
        self.kcycle = bool(kcycle)
        # wcycle: visit each coarse level TWICE per cycle (gamma = 2)
        # with a residual correction between visits. Unlike the K-cycle
        # this stays LINEAR in b, so it is legal inside the *_sup
        # near-true Schur operator and under gmres_fixed sweeps where
        # kcycle is forced off. Plain-aggregation V-cycles degrade with
        # depth (the 15 -> 21 -> 38 outer-iteration growth over
        # 78k -> 330k DOF, PERF.md); the W-cycle compounds the coarse
        # correction instead. With ~7x coarsening the extra coarse
        # visits cost ~20% per cycle. Mutable like kcycle.
        self.wcycle = bool(wcycle)
        # cheby_degree > 0: replace the l1-Jacobi pre/post smoothers
        # with degree-k Chebyshev polynomial smoothing on the interval
        # [0.25, 1.05] * lambda_max(D_l1^-1 A) — the standard
        # accelerator-era AMG smoother (hypre's GPU default): LINEAR,
        # reduction-free, and much stronger per cycle than one Jacobi
        # sweep. Per-level lambda_max is power-iterated at build() time
        # (amortized by pc_lag_steps). Mutable like kcycle.
        self.cheby_degree = int(cheby_degree)
        self.levels: list[AMGLevel] = []
        self.coo = []  # (row, col, n) per level, jnp row/col
        self.sup = []  # (SuperMaps, positions) per level — matvec layout
        self.g = 8  # scalar supernode width: gathered rows of 8
        r, c, m = row, col, n
        ar, ac = (agg_row, agg_col) if agg_row is not None else (r, c)
        if linear_parents is not None:
            parents, weights, n_vert = linear_parents
            if int(n_vert) < m:
                self.coo.append((jnp.asarray(r.astype(np.int32)),
                                 jnp.asarray(c.astype(np.int32)), m))
                self.sup.append(self._build_sup(r, c, m))
                plvl = PLevel(r, c, m, parents, weights, n_vert,
                              agg_row=None if ar is r else ar,
                              agg_col=None if ac is c else ac)
                self.levels.append(plvl)
                r, c = (np.asarray(plvl.coarse_coo[0], dtype=np.int64),
                        np.asarray(plvl.coarse_coo[1], dtype=np.int64))
                m = plvl.n_coarse
                ar, ac = plvl.coarse_agg_coo
        for _ in range(max_levels):
            self.coo.append((jnp.asarray(r.astype(np.int32)),
                             jnp.asarray(c.astype(np.int32)), m))
            self.sup.append(self._build_sup(r, c, m))
            if m <= coarse_size:
                break
            lvl = AMGLevel(r, c, m, agg_row=ar, agg_col=ac,
                           pairwise=pairwise)
            if lvl.n_coarse >= m:  # no coarsening progress
                break
            self.levels.append(lvl)
            r, c = lvl.coarse_coo
            r, c = np.asarray(r), np.asarray(c)
            m = lvl.n_coarse
            ar, ac = r, c  # coarser levels aggregate on their own graph
        self.n_coarsest = self.coo[len(self.levels)][2]

    # -- per-PC-build value pass (jittable) -----------------------------
    def _build_sup(self, r, c, m):
        """Supernode maps + scalar placement positions for one level
        (la/superell.py: level matvecs gather g-wide supernode rows
        instead of scalars)."""
        from .superell import SuperMaps

        maps = SuperMaps(r.astype(np.int64), c.astype(np.int64), m,
                         self.g)
        pos = jnp.asarray(
            maps.scalar_positions(
                r.astype(np.int64), c.astype(np.int64)
            ).astype(np.int32)
        )
        return maps, pos

    def _place(self, k, vals):
        """COO values -> (ns, Kg, g, g) supernode values of level k."""
        maps, pos = self.sup[k]
        g = maps.g
        out = jnp.zeros((maps.ns * maps.Kg * g * g,), vals.dtype)
        out = out.at[pos].set(vals, unique_indices=True,
                              mode="promise_in_bounds")
        return out.reshape(maps.ns, maps.Kg, g, g)

    def build(self, vals):
        """Galerkin-coarsen the values, precompute the l1 smoothing
        diagonals and the dense inverse of the coarsest level; the
        returned pytree is everything v_cycle touches per application.
        Level matvec values are stored in the supernode layout (the COO
        segment_sum matvec measured 17.9 ms per V-cycle at 78k DOF and
        the scalar-gather ELL 11.8 ms, dominating the whole Schur PC)."""
        out = []
        for k, lvl in enumerate(self.levels):
            ev = self._place(k, vals)
            d = self._l1_diag_sup(k, ev)
            lam = None
            if self.cheby_degree > 0:
                from .chebyshev import estimate_lambda_max

                lam = estimate_lambda_max(
                    lambda v, _k=k, _ev=ev: self._matvec(_k, _ev, v),
                    1.0 / d, self.coo[k][2], ev.dtype,
                )
            out.append((ev, d, lam))
            vals = lvl.coarsen_vals(vals)
        row, col, m = self.coo[len(self.levels)]
        A = jnp.zeros((m, m), vals.dtype).at[row, col].set(vals)
        A = A + 1e-12 * jnp.max(jnp.abs(vals)) * jnp.eye(m, dtype=vals.dtype)
        # dense INVERSE, not LU: the coarsest solve then is one dense
        # matmul per V-cycle instead of two sequential triangular
        # solves; inverting once per PC build is cheap at m<=300
        return out, jnp.linalg.inv(A)

    def _matvec(self, k, sup_vals, x):
        maps, _ = self.sup[k]
        g, ns = maps.g, maps.ns
        m = maps.n
        xp = jnp.zeros((ns * g,), x.dtype).at[:m].set(x)
        x_sup = jnp.concatenate(
            [xp.reshape(ns, g), jnp.zeros((1, g), x.dtype)]
        )
        xg = x_sup[maps.sup_cols]  # (ns, Kg, g)
        y = jnp.einsum("skab,skb->sa", sup_vals, xg,
                       preferred_element_type=x.dtype)
        return y.reshape(-1)[:m]

    def _l1_diag_sup(self, k, sup_vals):
        """l1-Jacobi smoothing diagonal d_i = sum_j |A_ij|: a convergent
        smoother for SPD operators and robust under the mild asymmetry
        of the SELFP Schur matrix (plain diag-Jacobi measured
        rho = 1.54 on DFG — divergent)."""
        maps, _ = self.sup[k]
        d = jnp.sum(jnp.abs(sup_vals), axis=(1, 3)).reshape(-1)
        return jnp.maximum(d[: maps.n], 1e-30)

    def v_cycle(self, built, b, diag0=None, kcycle: bool | None = None):
        """One V(n_smooth, n_smooth) cycle for A x = b, x0 = 0.
        `built` is the (levels, coarse_inv) pytree from build().
        kcycle=True upgrades coarse corrections to the _gcr2-accelerated
        K-cycle (see class doc; default: the hierarchy's setting).
        Pass kcycle=False wherever the result must be LINEAR in b."""
        level_vals, coarse_inv = built
        nl = len(self.levels)
        kc = self.kcycle if kcycle is None else kcycle

        def smooth(k, vals, d, x, b, iters):
            for _ in range(iters):
                r = b - self._matvec(k, vals, x)
                x = x + self.omega * r / d
            return x

        def cheb(k, vals, d, lam, b):
            """Degree-k Chebyshev smoothing step from x0 = 0 (LINEAR)."""
            from .chebyshev import chebyshev_fixed

            return chebyshev_fixed(
                lambda v: self._matvec(k, vals, v), b, 1.0 / d, lam,
                m=self.cheby_degree, lam_min_frac=0.25,
            )

        def csolve(k, rc):
            """Coarse-level solve at level k (the correction step)."""
            if k == nl:
                return descend(k, rc)
            if kc:
                return _gcr2(
                    lambda v: self._matvec(k, level_vals[k][0], v),
                    lambda v: descend(k, v), rc,
                )
            if self.wcycle:
                # gamma = 2: second cycle on the residual — LINEAR
                # (composition of linear cycles), unlike the K-cycle
                x1 = descend(k, rc)
                return x1 + descend(
                    k, rc - self._matvec(k, level_vals[k][0], x1)
                )
            return descend(k, rc)

        def descend(k, b):
            if k == nl:
                return coarse_inv @ b
            vals, d, lam = level_vals[k]
            if lam is not None:
                x = cheb(k, vals, d, lam, b)
            else:
                # first pre-smooth from x0 = 0 needs no matvec: x = w b/d
                x = self.omega * b / d
                x = smooth(k, vals, d, x, b, self.n_smooth - 1)
            r = b - self._matvec(k, vals, x)
            rc = self.levels[k].restrict(r)
            xc = csolve(k + 1, rc)
            x = x + self.levels[k].prolong(xc)
            if lam is not None:
                return x + cheb(k, vals, d, lam,
                                b - self._matvec(k, vals, x))
            return smooth(k, vals, d, x, b, self.n_smooth)

        return descend(0, b)


class BlockAMG(AMG):
    """Node-block (d x d) aggregation AMG — for the velocity block A_uu.

    The reference runs its u-block sub-solves under ASM/ILU or hypre
    BoomerAMG (/root/reference/src/solvers/stabilized_schur.py:261-264,
    stabilized_pcd.py:268); the round-1 node-block-Jacobi GMRES sweeps
    are not h-robust in the convection-dominated steady-march regime
    (outer iterations 95-150 at 40k DOF, PERF.md). This is the same
    plain-aggregation hierarchy as the scalar AMG — the aggregates and
    Galerkin entry maps come from the node graph and are built ONCE —
    with (d x d) block values: block Galerkin coarsening by segment-sum
    over blocks, block l1-Jacobi smoothing (row sums of |A_ij|_1 per
    component row — convergent for the convective operator where plain
    block-Jacobi is not), and a dense coarsest inverse over node blocks.

    Vectors are (n*d,) flat, component-major per node (matching the
    solver's u layout).
    """

    def __init__(self, row, col, n, d: int, coarse_size: int = 400,
                 fine_smoother=None, **kw):
        # fine_smoother: optional la/ras.RASPrecond applied as the
        # finest-level smoother (coarser levels keep l1-Jacobi) — the
        # ASM/ILU-strength smoothing the reference's u-block sub-PCs get
        # from PETSc (stabilized_schur.py:261-264), as batched dense solves
        self.d = int(d)
        self.fine_smoother = fine_smoother
        super().__init__(row, col, n, coarse_size=coarse_size, **kw)
        # EAGER precompute of every level's block positions: build()
        # runs inside jit, and under the const-args path the level
        # row/col attributes are swapped for tracers during tracing —
        # a lazy np.asarray there raises TracerArrayConversionError
        # (surfaced at 153k DOF where the maps cross the 1 MB
        # const-extraction threshold).
        for k in range(len(self.levels)):
            self._block_pos(k)

    def _block_pos(self, k):
        """Per-level block placement positions (eager, cached)."""
        if not hasattr(self, "_bpos"):
            self._bpos = {}
        if k not in self._bpos:
            maps, _ = self.sup[k]
            row, col, _ = self.coo[k]
            self._bpos[k] = jnp.asarray(
                maps.block_positions_uniform(
                    np.asarray(row).astype(np.int64),
                    np.asarray(col).astype(np.int64), self.d,
                ).astype(np.int32)
            )
        return self._bpos[k]

    def _place_block(self, k, vals):
        maps, _ = self.sup[k]
        gd = maps.g * self.d
        out = jnp.zeros((maps.ns * maps.Kg * gd * gd,), vals.dtype)
        out = out.at[self._block_pos(k).reshape(-1)].set(
            vals.reshape(-1), unique_indices=True,
            mode="promise_in_bounds",
        )
        return out.reshape(maps.ns, maps.Kg, gd, gd)

    def build(self, vals):
        """vals: (nnz, d, d) block values on the finest graph."""
        d = self.d
        ras_inv = (
            self.fine_smoother.build(vals)
            if self.fine_smoother is not None else None
        )
        out = []
        for k, lvl in enumerate(self.levels):
            ev = self._place_block(k, vals)
            dg = self._l1_diag_block(k, ev)
            lam = None
            if self.cheby_degree > 0 and not (
                k == 0 and ras_inv is not None
            ):
                from .chebyshev import estimate_lambda_max

                lam = estimate_lambda_max(
                    lambda v, _k=k, _ev=ev: self._matvec_block(
                        _k, _ev, v
                    ),
                    1.0 / dg, self.coo[k][2] * d, ev.dtype,
                )
            out.append((ev, dg, lam))
            vals = lvl.coarsen_block_vals(vals)
        row, col, m = self.coo[len(self.levels)]
        A = jnp.zeros((m, m, d, d), vals.dtype).at[row, col].set(vals)
        A = jnp.transpose(A, (0, 2, 1, 3)).reshape(m * d, m * d)
        A = A + 1e-12 * jnp.max(jnp.abs(vals)) * jnp.eye(
            m * d, dtype=vals.dtype
        )
        return out, jnp.linalg.inv(A), ras_inv

    def _matvec_block(self, k, sup_vals, x):
        """x: (m*d,) flat -> (m*d,) flat."""
        maps, _ = self.sup[k]
        g, ns, m, d = maps.g, maps.ns, maps.n, self.d
        xp = jnp.zeros((ns * g * d,), x.dtype).at[: m * d].set(x)
        x_sup = jnp.concatenate(
            [xp.reshape(ns, g * d), jnp.zeros((1, g * d), x.dtype)]
        )
        xg = x_sup[maps.sup_cols]  # (ns, Kg, g*d)
        y = jnp.einsum(
            "skab,skb->sa", sup_vals, xg,
            preferred_element_type=x.dtype,
        )
        return y.reshape(-1)[: m * d]

    def _l1_diag_block(self, k, sup_vals):
        maps, _ = self.sup[k]
        dsum = jnp.sum(jnp.abs(sup_vals), axis=(1, 3)).reshape(-1)
        return jnp.maximum(dsum[: maps.n * self.d], 1e-30)

    def v_cycle(self, built, b, diag0=None, kcycle: bool | None = None):
        level_vals, coarse_inv, ras_inv = built
        nl = len(self.levels)
        d = self.d
        ras = self.fine_smoother
        kc = self.kcycle if kcycle is None else kcycle

        def smooth(k, vals, dg, x, b, iters):
            if k == 0 and ras_inv is not None:
                for _ in range(iters):
                    r = b - self._matvec_block(k, vals, x)
                    x = x + ras.apply(ras_inv, r)
                return x
            for _ in range(iters):
                r = b - self._matvec_block(k, vals, x)
                x = x + self.omega * r / dg
            return x

        def cheb(k, vals, dg, lam, b):
            from .chebyshev import chebyshev_fixed

            return chebyshev_fixed(
                lambda v: self._matvec_block(k, vals, v), b, 1.0 / dg,
                lam, m=self.cheby_degree, lam_min_frac=0.25,
            )

        def csolve(k, rc):
            if k == nl:
                return descend(k, rc)
            if kc:
                return _gcr2(
                    lambda v: self._matvec_block(k, level_vals[k][0], v),
                    lambda v: descend(k, v), rc,
                )
            if self.wcycle:
                # gamma = 2 (see AMG.v_cycle): linear, S-operator-safe
                x1 = descend(k, rc)
                return x1 + descend(
                    k, rc - self._matvec_block(k, level_vals[k][0], x1)
                )
            return descend(k, rc)

        def descend(k, b):
            if k == nl:
                return coarse_inv @ b
            vals, dg, lam = level_vals[k]
            if k == 0 and ras_inv is not None:
                x = ras.apply(ras_inv, b)  # pre-smooth from x0 = 0
                x = smooth(k, vals, dg, x, b, self.n_smooth - 1)
            elif lam is not None:
                x = cheb(k, vals, dg, lam, b)
            else:
                x = self.omega * b / dg  # first pre-smooth from x0 = 0
                x = smooth(k, vals, dg, x, b, self.n_smooth - 1)
            r = b - self._matvec_block(k, vals, x)
            rc = self.levels[k].restrict_block(r, d)
            xc = csolve(k + 1, rc)
            x = x + self.levels[k].prolong_block(xc, d)
            if lam is not None and not (k == 0 and ras_inv is not None):
                return x + cheb(k, vals, dg, lam,
                                b - self._matvec_block(k, vals, x))
            return smooth(k, vals, dg, x, b, self.n_smooth)

        return descend(0, b)
