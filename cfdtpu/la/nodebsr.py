"""Assembled node-blocked sparse operator (BSR) for equal-order forms.

The element-block operator (forms/navier_stokes.py apply_element_matrices)
re-reads every shared matrix entry once per adjacent cell: for P1
triangles each vertex entry is touched ~6x, so a matvec streams ~2.2x
more matrix bytes from HBM than the assembled sparsity holds, and the
fieldsplit sub-block applies (the Schur PC inner loops, la/schur.py)
stream the FULL element blocks to use one quarter of each.

This module assembles the exact same Jacobian into node-pair blocks:
for equal-order P1-P1 (velocity and pressure sharing vertex nodes) each
coupled node pair (r, c) owns one dense (dim+1)x(dim+1) block
[[A_uu (dim x dim), A_up (dim x 1)], [A_pu (1 x dim), A_pp (1 x 1)]].
One static structure (built once from the mesh), four addressable
sub-couplings. On the DFG 2D-1 mesh this cuts matrix bytes per full
matvec from 2.1 MB to 0.95 MB and the Schur-block apply (m_p = 30 inner
sweeps per outer iteration) reads only the 1/9 slice it needs.

It duck-types the form operator API (apply_element_matrices /
apply_sub_block / jacobian_diagonal / n_u_flat) with the assembled
`vals` passed where the PC passes A_cells, so make_schur_precond works
unchanged. This is the PETSc "assembled AIJ vs matrix-free" switch
(reference assembles: src/solvers/stabilized_schur.py:154,191) done the
accelerator way: block-regular, sorted segment reductions, no atomics.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import ops as jox


class NodeBSR:
    def __init__(self, form, supernode_g: int = 4):
        V, Q = form.V, form.Q
        if not np.array_equal(np.asarray(V.dofmap), np.asarray(Q.dofmap)):
            raise ValueError(
                "NodeBSR requires equal-order V/Q sharing node ids "
                "(P1-P1 / Pk-Pk stabilized forms)"
            )
        self.form = form
        self.dim = d = form.dim
        self.bs = d + 1
        cells = np.asarray(V.dofmap)
        self.n_nodes = n_nodes = V.num_dofs
        self.dtype = form.dtype
        nbn = cells.shape[1]
        nud_loc = nbn * d

        # local row index of (node a, sub s): u comps first (a*d+i),
        # then the p dof at nud_loc + a — matches form._dmf_np layout
        self._ridx = np.concatenate(
            [
                (np.arange(nbn)[:, None] * d + np.arange(d)[None, :]),
                (nud_loc + np.arange(nbn))[:, None],
            ],
            axis=1,
        ).astype(np.int32)  # (nbn, bs)

        # global block keys per element entry, plus facet-term entries
        def pair_keys(nodes):  # nodes (m, nbn) -> (m*nbn*nbn,)
            r = np.repeat(nodes, nbn, axis=1).reshape(-1).astype(np.int64)
            c = np.tile(nodes, (1, nbn)).reshape(-1).astype(np.int64)
            return r * n_nodes + c

        keys = [pair_keys(cells)]
        self._facet_nodes = []
        nud_flat = form.n_u_flat
        for block in form._facet_blocks:
            dmf = np.asarray(block["dofmap_flat"])
            nodes_f = dmf[:, nbn * d:] - nud_flat  # p dofs are node ids
            self._facet_nodes.append(nodes_f)
            keys.append(pair_keys(nodes_f))
        all_keys = np.concatenate(keys)

        uniq, inv = np.unique(all_keys, return_inverse=True)
        self.n_blocks = len(uniq)
        self.block_row = jnp.asarray((uniq // n_nodes).astype(np.int32))
        self.block_col = jnp.asarray((uniq % n_nodes).astype(np.int32))
        from ..utils.geometry import SortedScatter

        self._assemble_scatter = SortedScatter(inv, self.n_blocks)

        # positions of the diagonal blocks (every node couples to itself)
        diag_pos = np.searchsorted(uniq, np.arange(n_nodes, dtype=np.int64)
                                   * n_nodes + np.arange(n_nodes))
        self._diag_pos = jnp.asarray(diag_pos.astype(np.int32))
        self._pp_amg = None

        row_np = (uniq // n_nodes).astype(np.int64)
        col_np = (uniq % n_nodes).astype(np.int64)
        cnt = np.bincount(row_np, minlength=n_nodes)
        self.K = K = int(cnt.max())

        # supernode layout (la/superell.py): g consecutive (Hilbert-
        # ordered) nodes per gathered row — the gather then moves
        # g*bs-wide rows. Whether the fill overhead is repaid on the GPU
        # is open (ROADMAP A3).
        # g == 1 falls back to the round-1 per-node ELL layout (rows are
        # sorted, so each row's entries are contiguous; padding to
        # K = max blocks/row turns the matvec scatter into a dense
        # reduction over K).
        self.g = int(supernode_g) if supernode_g else 1
        if self.g == 1:
            starts = np.cumsum(cnt) - cnt
            pos_in_row = (
                np.arange(self.n_blocks) - np.repeat(starts, cnt)
            )
            slot = row_np * K + pos_in_row
            perm = np.full(n_nodes * K, self.n_blocks, dtype=np.int64)
            perm[slot] = np.arange(self.n_blocks)
            cols_ell = np.full(n_nodes * K, n_nodes, dtype=np.int64)
            cols_ell[slot] = col_np
            self._ell_perm = jnp.asarray(perm.astype(np.int32))
            self._ell_cols = jnp.asarray(
                cols_ell.reshape(n_nodes, K).astype(np.int32)
            )
        if self.g > 1:
            from .superell import SuperMaps

            self._sup = SuperMaps(row_np, col_np, n_nodes, self.g)
            gbs = self.g * self.bs
            if self._sup.ns * self._sup.Kg * gbs * gbs >= 2 ** 31:
                raise ValueError("supernode layout exceeds int32 range")
            self._sup_pos = jnp.asarray(
                self._sup.block_positions(row_np, col_np, d)
                .astype(np.int32)
            )
        else:
            self._sup = None

    # -- assembly (runs per Newton iteration, jittable) -----------------
    def assemble(self, A_cells, A_blocks):
        """Element blocks -> assembled (n_blocks, bs, bs) values."""
        r = self._ridx
        ent = [
            A_cells[:, r[:, None, :, None], r[None, :, None, :]]
            .reshape(-1, self.bs, self.bs)
        ]
        for (_, A_f) in A_blocks:
            ent.append(
                A_f[:, r[:, None, :, None], r[None, :, None, :]]
                .reshape(-1, self.bs, self.bs)
            )
        entries = jnp.concatenate(ent, axis=0)
        vals = self._assemble_scatter(entries)
        if self._sup is not None:
            # supernode placement: unique-index scatter of the block
            # entries into the (ns, Kg, gbs, gbs) layout
            gbs = self.g * self.bs
            flat = jnp.zeros(
                (self._sup.ns * self._sup.Kg * gbs * gbs,), vals.dtype
            )
            flat = flat.at[self._sup_pos.reshape(-1)].set(
                vals.reshape(-1), unique_indices=True,
                mode="promise_in_bounds",
            )
            vals_sup = flat.reshape(self._sup.ns, self._sup.Kg, gbs, gbs)
            return {"coo": vals, "sup": vals_sup}
        # pack COO (diagonal/SELFP paths) + ELL (scatter-free applies)
        vals_ext = jnp.concatenate(
            [vals, jnp.zeros((1, self.bs, self.bs), vals.dtype)], axis=0
        )
        vals_ell = vals_ext[self._ell_perm].reshape(
            self.n_nodes, self.K, self.bs, self.bs
        )
        return {"coo": vals, "ell": vals_ell}

    def uu_block_jacobi(self, vals, bc_mask_u):
        """Exact inverse of the (dim x dim) diagonal velocity blocks —
        a node-block Jacobi PC for the A_uu inner sweeps, strictly
        stronger than the scalar diagonal when the velocity components
        couple (convection at larger dt). BC rows become identity."""
        from ..utils.geometry import det_and_inv

        d = self.dim
        db = vals["coo"][self._diag_pos][:, :d, :d]  # (n_nodes, d, d)
        mask = bc_mask_u.reshape(self.n_nodes, d)
        eye = jnp.eye(d, dtype=db.dtype)
        # identity rows/cols at Dirichlet components
        db = jnp.where(mask[:, :, None], eye[None], db)
        db = jnp.where(mask[:, None, :], eye[None], db)
        _, inv = det_and_inv(db)

        def apply(v):
            vn = v.reshape(self.n_nodes, d)
            return jnp.einsum("nab,nb->na", inv, vn).reshape(-1)

        return apply

    def pc_cast(self, vals, dtype=jnp.bfloat16):
        """A preconditioner-side view of the pack with the streamed
        apply-path values in bf16 (half the PC matrix traffic; the
        flexible outer GMRES absorbs the inexactness — applies
        accumulate in f32 via preferred_element_type). COO values stay
        full precision: the SELFP assembly and diagonals feed AMG."""
        if "sup" in vals:
            return {"coo": vals["coo"], "sup": vals["sup"].astype(dtype)}
        return {"coo": vals["coo"], "ell": vals["ell"].astype(dtype)}

    # -- form-operator API (vals passed where the form takes A_cells) ---
    @property
    def n_u_flat(self):
        return self.form.n_u_flat

    def _to_nodes(self, v):
        d = self.dim
        return jnp.concatenate(
            [v[: self.n_u_flat].reshape(self.n_nodes, d),
             v[self.n_u_flat:, None]],
            axis=1,
        )

    def _from_nodes(self, yn):
        d = self.dim
        return jnp.concatenate([yn[:, :d].reshape(-1), yn[:, d]])

    def _ell_gather(self, xn):
        """x (n_nodes, c) -> padded neighbour gather (n_nodes, K, c)."""
        x_ext = jnp.concatenate(
            [xn, jnp.zeros((1, xn.shape[1]), xn.dtype)], axis=0
        )
        return x_ext[self._ell_cols]

    # -- supernode-row construction (pure reshapes + one pad) ------------
    def _sup_rows_u(self, v_u):
        """u flat (n*d,) -> (ns+1, g*d) supernode rows (+ zero sentinel)."""
        g, ns, n, d = self.g, self._sup.ns, self.n_nodes, self.dim
        up = jnp.zeros((ns * g * d,), v_u.dtype).at[: n * d].set(v_u)
        return jnp.concatenate(
            [up.reshape(ns, g * d), jnp.zeros((1, g * d), v_u.dtype)]
        )

    def _sup_rows_p(self, v_p):
        g, ns, n = self.g, self._sup.ns, self.n_nodes
        pp = jnp.zeros((ns * g,), v_p.dtype).at[:n].set(v_p)
        return jnp.concatenate(
            [pp.reshape(ns, g), jnp.zeros((1, g), v_p.dtype)]
        )

    def _sup_rows(self, v_flat):
        return jnp.concatenate(
            [self._sup_rows_u(v_flat[: self.n_u_flat])[:, :],
             self._sup_rows_p(v_flat[self.n_u_flat:])], axis=1
        )

    def _sup_gather(self, rows):
        return rows[self._sup.sup_cols]  # (ns, Kg, width)

    def _from_sup_u(self, y_u):
        """(ns, g*d) -> u flat (n*d,)."""
        n, d = self.n_nodes, self.dim
        return y_u.reshape(-1)[: n * d]

    def _from_sup_p(self, y_p):
        return y_p.reshape(-1)[: self.n_nodes]

    def apply_element_matrices(self, vals, _A_blocks, v_flat):
        if "sup" in vals:
            gd = self.g * self.dim
            xg = self._sup_gather(self._sup_rows(v_flat))
            y = jnp.einsum(
                "skrc,skc->sr", vals["sup"], xg,
                preferred_element_type=v_flat.dtype,
            )
            return jnp.concatenate(
                [self._from_sup_u(y[:, :gd]),
                 self._from_sup_p(y[:, gd:])]
            )
        xn = self._to_nodes(v_flat)
        yn = jnp.einsum(
            "nkab,nkb->na", vals["ell"], self._ell_gather(xn),
            preferred_element_type=xn.dtype,
        )
        return self._from_nodes(yn)

    def apply_sub_block(self, vals, _A_blocks, v, which: str):
        d = self.dim
        if "sup" in vals:
            gd = self.g * d
            rs = slice(0, gd) if which[0] == "u" else slice(gd, None)
            cs = slice(0, gd) if which[1] == "u" else slice(gd, None)
            rows = (
                self._sup_rows_u(v) if which[1] == "u"
                else self._sup_rows_p(v)
            )
            y = jnp.einsum(
                "skrc,skc->sr", vals["sup"][:, :, rs, cs],
                self._sup_gather(rows),
                preferred_element_type=v.dtype,
            )
            return (
                self._from_sup_u(y) if which[0] == "u"
                else self._from_sup_p(y)
            )
        rs = slice(0, d) if which[0] == "u" else slice(d, d + 1)
        cs = slice(0, d) if which[1] == "u" else slice(d, d + 1)
        xn = (
            v.reshape(self.n_nodes, d) if which[1] == "u" else v[:, None]
        )
        yn = jnp.einsum(
            "nkab,nkb->na", vals["ell"][:, :, rs, cs],
            self._ell_gather(xn), preferred_element_type=xn.dtype,
        )
        return yn.reshape(-1) if which[0] == "u" else yn[:, 0]

    # -- explicit SELFP Schur matrix -------------------------------------
    def sp_structure(self):
        """Static structure of Sp = App - Apu diag(Auu)^-1 Aup — the
        matrix PETSc's SchurPreType.SELFP assembles (reference
        stabilized_schur.py:234-235). The product term couples node
        pairs sharing a middle node (distance-2 graph); all index maps
        are precomputed here once.

        Returns (sp_row, sp_col, n_sp) jnp arrays; caches everything
        needed by sp_vals()."""
        if getattr(self, "_sp", None) is not None:
            return self._sp
        row = np.asarray(self.block_row, dtype=np.int64)
        col = np.asarray(self.block_col, dtype=np.int64)
        n = self.n_nodes
        ne = len(row)

        def _build():
            # group entry ids by middle node: e1 by col (I--K), e2 by
            # row (K--J)
            by_col = np.argsort(col, kind="stable")
            col_s = col[by_col]
            rptr = np.searchsorted(row, np.arange(n + 1))  # row sorted
            # segmented cartesian product, fully vectorized (a per-node
            # Python loop here cost ~100 s at ~1M DOF): for each middle
            # node K, pair every entry with col==K (a block per such
            # entry, in by_col order) against the contiguous row-range
            # rptr[K]:rptr[K+1]
            cb = np.diff(rptr)              # entries with row == K
            blk_len = cb[col_s]             # block length per sorted entry
            tot = int(blk_len.sum())
            block_id = np.repeat(np.arange(ne, dtype=np.int64), blk_len)
            starts = np.concatenate(([0], np.cumsum(blk_len)[:-1]))
            within = np.arange(tot, dtype=np.int64) - starts[block_id]
            e1 = by_col[block_id]
            e2 = rptr[col_s][block_id] + within
            prod_keys = row[e1] * n + col[e2]
            app_keys = row * n + col
            uniq = np.unique(np.concatenate([prod_keys, app_keys]))
            pk = np.searchsorted(uniq, prod_keys)
            return {
                "e1": e1.astype(np.int32),
                "e2": e2.astype(np.int32),
                "kcol": col[e1].astype(np.int32),
                "pk": pk,
                "app_pos": np.searchsorted(uniq, app_keys).astype(
                    np.int32
                ),
                "uniq": uniq,
                "diag_pos": np.searchsorted(
                    uniq,
                    np.arange(n, dtype=np.int64) * n + np.arange(n),
                ).astype(np.int32),
            }

        # the distance-2 pairing is a big-mesh setup hotspot (with its
        # scatter, ~90 s of the 190 s host setup at 950k DOF) and a pure
        # function of the node graph — disk-cached for large graphs
        if ne >= (1 << 20):
            from ..utils.symcache import cached_arrays

            got = cached_arrays("sp_struct", (row, col, n), _build)
        else:
            got = _build()
        uniq = got["uniq"]
        n_sp = len(uniq)
        from ..utils.geometry import SortedScatter

        self._sp_e1 = jnp.asarray(got["e1"])
        self._sp_e2 = jnp.asarray(got["e2"])
        self._sp_K = jnp.asarray(got["kcol"])
        self._sp_scatter = SortedScatter(got["pk"], n_sp)
        self._sp_app_pos = jnp.asarray(got["app_pos"])
        sp_row = jnp.asarray((uniq // n).astype(np.int32))
        sp_col = jnp.asarray((uniq % n).astype(np.int32))
        self._sp_diag_pos = jnp.asarray(got["diag_pos"])
        self._sp = (sp_row, sp_col, n_sp)
        return self._sp

    def sp_vals(self, vals, inv_duu_flat=None):
        if isinstance(vals, dict):
            vals = vals["coo"]
        """Assemble the explicit SELFP values on sp_structure()
        (jittable; runs once per preconditioner build).

        inv_duu_flat: optional (n_u_flat,) inverse velocity diagonal,
        ZERO at Dirichlet rows — this makes Sp match the matrix-free S
        of make_schur_precond exactly (there the Aup rows at velocity
        BCs are masked to zero). Without it the raw diagonal is used.
        """
        sp_row, sp_col, n_sp = self.sp_structure()
        d = self.dim
        if inv_duu_flat is None:
            diag_uu = vals[self._diag_pos][:, :d, :d]
            idx = jnp.arange(d)
            inv_duu = 1.0 / diag_uu[:, idx, idx]  # (n_nodes, d)
        else:
            inv_duu = inv_duu_flat.reshape(self.n_nodes, d)
        apu = vals[self._sp_e1][:, d, :d]     # (nt, d) block (I,K) pu
        aup = vals[self._sp_e2][:, :d, d]     # (nt, d) block (K,J) up
        contrib = -jnp.sum(apu * inv_duu[self._sp_K] * aup, axis=1)
        sp = self._sp_scatter(contrib)
        return sp.at[self._sp_app_pos].add(vals[:, d, d])

    def bbt_vals(self, vals, inv_q_flat):
        """Assemble the explicit LSC commutator operator
        BBt = A_pu diag(Q)^-1 A_up on the distance-2 sp_structure()
        graph (Q the velocity mass diagonal, Elman et al. scaled LSC) —
        jittable, runs once per preconditioner build. Unlike SELFP this
        is a pure product: no App term, positive (Poisson-like) sign.
        The same sp_amg() hierarchy preconditions solves with it (the
        hierarchy depends only on the graph, values are passed at
        build)."""
        if isinstance(vals, dict):
            vals = vals["coo"]
        self.sp_structure()
        d = self.dim
        inv_q = inv_q_flat.reshape(self.n_nodes, d)
        apu = vals[self._sp_e1][:, d, :d]
        aup = vals[self._sp_e2][:, :d, d]
        contrib = jnp.sum(apu * inv_q[self._sp_K] * aup, axis=1)
        return self._sp_scatter(contrib)

    def p_scatter_structure(self):
        """Static cell-entry -> node-COO map for assemble_p_scalar.
        Must be built eagerly (numpy over the static dofmap; under the
        const-args jit path the device-array attributes are tracers at
        trace time)."""
        if getattr(self, "_p_scatter", None) is None:
            cells = np.asarray(self.form.V.dofmap)
            nbn = cells.shape[1]
            n = self.n_nodes
            r = np.repeat(cells, nbn, axis=1).reshape(-1).astype(np.int64)
            c = np.tile(cells, (1, nbn)).reshape(-1).astype(np.int64)
            row = np.asarray(self.block_row, dtype=np.int64)
            col = np.asarray(self.block_col, dtype=np.int64)
            keys = np.searchsorted(row * n + col, r * n + c)
            from ..utils.geometry import SortedScatter

            self._p_scatter = SortedScatter(keys, self.n_blocks)
        return self._p_scatter

    def assemble_p_scalar(self, P_e):
        """Scatter element pressure matrices (nc, nbp, nbp) — e.g. the
        PCD Ap/Mp/Fp operators from form.pressure_matrices — into the
        scalar node COO aligned with block_row/block_col (jittable).
        Cell-interior entries only; the facet-term keys of the mixed
        assembly don't apply to these pure-Q operators."""
        return self.p_scatter_structure()(P_e.reshape(-1))

    def linear_parents(self):
        """Vertex-embedding transfer data of the shared node space for
        the weighted p-multigrid level (la/amg.PLevel) when the degree
        is > 1 — higher-order node graphs are where piecewise-constant
        aggregation loses h-robustness. None for P1 (nodes == vertices)."""
        V = self.form.V
        if V.degree <= 1:
            return None
        return V.linear_parents()

    def sp_amg(self, pairwise=False, n_smooth=1, kcycle=None,
               cheby=None, wcycle=None):
        """Aggregation-MG hierarchy on the explicit SELFP graph
        (aggregates formed on the distance-1 node graph, see la/amg.py).
        kcycle / cheby / wcycle: None leaves the cached hierarchy's
        setting untouched; a value sets it (structure is independent)."""
        if getattr(self, "_sp_amg_h", None) is None:
            from .amg import AMG

            # NO p-level here: the SELFP matrix is INDEFINITE (~10% of
            # its symmetric-part spectrum is negative, measured on DFG/
            # cavity at P1 and P2 alike). Piecewise-constant coarsening
            # averages those oscillatory negative modes away; the
            # weighted vertex-space Galerkin represents them faithfully
            # and the cycle then amplifies them (diverged 1e7x in
            # test_amg_plevel_*). The h-robust p-level belongs on the
            # (definite) momentum block — uu_amg — which is also where
            # the measured P2 bottleneck is (scripts/diag_pc.py).
            sp_row, sp_col, _ = self.sp_structure()
            self._sp_amg_h = AMG(
                np.asarray(sp_row), np.asarray(sp_col), self.n_nodes,
                agg_row=np.asarray(self.block_row),
                agg_col=np.asarray(self.block_col),
                pairwise=pairwise, n_smooth=int(n_smooth),
            )
        if kcycle is not None:
            self._sp_amg_h.kcycle = bool(kcycle)
        if cheby is not None:
            self._sp_amg_h.cheby_degree = int(cheby)
        if wcycle is not None:
            self._sp_amg_h.wcycle = bool(wcycle)
        return self._sp_amg_h

    # -- velocity-block AMG hooks (see la/amg.py BlockAMG) ---------------
    def uu_vals(self, vals, bc_mask_u):
        """BC-consistent (n_blocks, d, d) velocity coupling blocks:
        Dirichlet component rows/columns zeroed, identity on the masked
        diagonal — the assembled twin of the PC-side Auu operator
        (la/schur.py masks the matvec the same way)."""
        if isinstance(vals, dict):
            vals = vals["coo"]
        d = self.dim
        v = vals[:, :d, :d]
        mask = bc_mask_u.reshape(self.n_nodes, d)
        v = jnp.where(mask[self.block_row][:, :, None], 0.0, v)
        v = jnp.where(mask[self.block_col][:, None, :], 0.0, v)
        dv = v[self._diag_pos]
        add = mask[:, :, None] * jnp.eye(d, dtype=v.dtype)[None]
        return v.at[self._diag_pos].set(dv + add)

    def uu_amg(self, fine_smoother=None, kcycle=None, cheby=None,
               wcycle=None):
        """Block-aggregation-MG hierarchy on the velocity node graph
        (static structure, built once and cached) — the h-robust inner
        PC for the convection-dominated A_uu sweeps. fine_smoother: an
        optional RASPrecond used as the finest-level smoother (the
        ASM+ILU-strength analogue, la/ras.py). kcycle: None keeps the
        cached setting; a bool sets it (only honored where the caller
        is flexible — la/schur.py forces kcycle=False inside the *_sup
        linear S operator)."""
        cached = getattr(self, "_uu_amg_h", None)
        if cached is None or cached.fine_smoother is not fine_smoother:
            from .amg import BlockAMG

            self._uu_amg_h = BlockAMG(
                np.asarray(self.block_row), np.asarray(self.block_col),
                self.n_nodes, d=self.dim, fine_smoother=fine_smoother,
                linear_parents=self.linear_parents(),
            )
        if kcycle is not None:
            self._uu_amg_h.kcycle = bool(kcycle)
        if cheby is not None:
            self._uu_amg_h.cheby_degree = int(cheby)
        if wcycle is not None:
            self._uu_amg_h.wcycle = bool(wcycle)
        return self._uu_amg_h

    def uu_ras(self, s: int = 16, overlap: int = 4):
        """RAS preconditioner over contiguous Hilbert node windows for
        the velocity block (static maps cached per (s, overlap)).

        The key and the object are separate attributes on purpose:
        utils/constargs.py rewrites tuple attributes to lists while
        collecting const slots, so a (key, obj) tuple cache would fail
        its own key comparison at trace time and rebuild — with traced
        arrays (the round-3 rasamg_up tracer bug)."""
        key = (int(s), int(overlap))
        if getattr(self, "_uu_ras_key", None) != key:
            from .ras import RASPrecond

            self._uu_ras_obj = RASPrecond(
                np.asarray(self.block_row), np.asarray(self.block_col),
                self.n_nodes, d=self.dim, s=key[0], overlap=key[1],
            )
            self._uu_ras_key = key
        return self._uu_ras_obj

    # -- pressure-block AMG hooks (see la/amg.py) ------------------------
    def pp_vals(self, vals):
        if isinstance(vals, dict):
            vals = vals["coo"]
        """The assembled A_pp scalar COO values (row-sorted, aligned
        with block_row/block_col)."""
        return vals[:, self.dim, self.dim]

    def pp_amg(self):
        """Aggregation-MG hierarchy on the pressure node graph (static
        structure, built once and cached)."""
        if self._pp_amg is None:
            from .amg import AMG

            # no p-level: App carries the same stabilization-induced
            # indefiniteness as SELFP (see sp_amg)
            self._pp_amg = AMG(
                np.asarray(self.block_row), np.asarray(self.block_col),
                self.n_nodes,
            )
        return self._pp_amg

    def apply_p_coupled(self, vals, v_p):
        """One fused pass for the SELFP Schur action: returns
        (Aup v_p, App v_p) from a single gather over the whole p
        block column, instead of two separate sub-block applies."""
        d = self.dim
        if "sup" in vals:
            gd = self.g * d
            xg = self._sup_gather(self._sup_rows_p(v_p))  # (ns, Kg, g)
            y = jnp.einsum(
                "skrc,skc->sr", vals["sup"][:, :, :, gd:], xg,
                preferred_element_type=v_p.dtype,
            )
            return (
                self._from_sup_u(y[:, :gd]), self._from_sup_p(y[:, gd:])
            )
        xg = self._ell_gather(v_p[:, None])[:, :, 0]  # (n, K)
        yn = jnp.einsum(
            "nka,nk->na", vals["ell"][:, :, :, d], xg,
            preferred_element_type=xg.dtype,
        )
        return yn[:, :d].reshape(-1), yn[:, d]

    def jacobian_diagonal(self, vals, _A_blocks):
        if isinstance(vals, dict):
            vals = vals["coo"]
        db = vals[self._diag_pos]  # (n_nodes, bs, bs)
        idx = jnp.arange(self.bs)
        dn = db[:, idx, idx]  # (n_nodes, bs)
        return self._from_nodes(dn)
