"""Dof-partitioned distribution with halo exchange (round-2 dist layer).

Replaces the round-1 dof-replicated psum design (dist/partition.py) for
the stabilized node-BSR family. The reference's model is dolfinx's
parallel index maps: every space has owned + ghost dofs, FORWARD ghost
updates broadcast owner values before reads and REVERSE updates
accumulate ghost contributions after assembly
(/root/reference/src/solvers/stabilized_schur.py:137-142,168,175,237-252).

Realization on the supernode layout (la/superell.py):

- The Hilbert-ordered supernodes are partitioned into n_shards CONTIGUOUS
  ranges — the Hilbert order makes contiguous index ranges compact
  spatial subdomains, so this IS a geometric partition and halos are
  O(boundary).
- FORWARD ghost update = each shard packs the owned supernode rows any
  neighbour needs (static pack lists) and an all_gather over the shard
  axis distributes them; every shard then assembles its halo rows from
  the gathered buffer with static local indices. Collective volume is
  O(n_shards * max_boundary * g * bs), not O(n_dofs).
- REVERSE does not exist: the operator is row-partitioned, each shard
  computes its owned rows completely (owner-computes).
- The Krylov loop (the hot path) runs entirely on sharded vectors:
  fgmres/newton take a `reduce` hook (la/gmres.py, la/newton.py) that
  psums local dot products — the analogue of the reference's
  comm.allreduce in every norm (/root/reference/src/scenario.py:272-281).
- The preconditioner is per-shard additive Schwarz: every shard runs the
  SELFP Schur fieldsplit on its LOCAL owned block (halo couplings
  dropped), with local inner sweeps — the analogue of the reference's
  ASM sub-PCs (stabilized_schur.py:261-264).

Phase-2 (round 3): residual evaluation and Jacobian assembly run
SHARDED — each shard sweeps only the cells touching its owned rows
(ghosted cells) and assembles exactly its owned supernode rows via the
static maps in dist/shard_assembly.py; boundary cells are swept by each
neighbouring shard (owner-computes, no REVERSE accumulation). The
global COO view needed by the SELFP/coarse-grid/diagonal builds is
reconstructed transiently with one all_gather per preconditioner build
(lagged PC => once per step). CFDTPU_SHARD_ASSEMBLY=off reverts to the
round-2 replicated assembly.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import ops as jox
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .partition import make_device_mesh


def _u_mask(solver, n, d):
    m = np.zeros(n * d, dtype=bool)
    for d0 in range(d):
        m[solver.bc_dofs_u.astype(np.int64) * d + d0] = True
    return m


class HaloMaps:
    """Static partition + halo-exchange maps over the supernode graph."""

    def __init__(self, bsr, n_shards: int):
        sup = bsr._sup
        self.g, self.bs = bsr.g, bsr.bs
        self.gbs = self.g * self.bs
        self.S = S = int(n_shards)
        ns = sup.ns
        L = -(-ns // S)
        self.L = L
        self.ns_pad = L * S
        Kg = sup.Kg
        self.Kg = Kg

        cols = np.asarray(sup.sup_cols, dtype=np.int64)  # (ns, Kg)
        cols_pad = np.full((self.ns_pad, Kg), ns, dtype=np.int64)
        cols_pad[:ns] = cols

        halo_lists = []
        for s in range(S):
            block = cols_pad[s * L:(s + 1) * L]
            ref = np.unique(block[block < ns])
            halo_lists.append(ref[(ref < s * L) | (ref >= (s + 1) * L)])
        H = max((len(h) for h in halo_lists), default=0)
        H = max(H, 1)
        self.H = H

        # send packs: owned local ids each shard must contribute
        need_from = [[] for _ in range(S)]
        for s in range(S):
            for j in halo_lists[s]:
                need_from[int(j // L)].append(int(j))
        pack_lists = [np.unique(np.asarray(n_, dtype=np.int64))
                      for n_ in need_from]
        B = max((len(p_) for p_ in pack_lists), default=0)
        B = max(B, 1)
        self.B = B
        pack_idx = np.zeros((S, B), dtype=np.int64)
        for s, p_ in enumerate(pack_lists):
            pack_idx[s, :len(p_)] = p_ - s * L
        self.pack_idx = jnp.asarray(pack_idx.astype(np.int32))

        # halo sources: flat index into the all-gathered (S*B) buffer
        halo_src = np.full((S, H), S * B, dtype=np.int64)  # sentinel
        for s, hl in enumerate(halo_lists):
            for hi, j in enumerate(hl):
                o = int(j // L)
                pos = int(np.searchsorted(pack_lists[o], j))
                halo_src[s, hi] = o * B + pos
        self.halo_src = jnp.asarray(halo_src.astype(np.int32))

        # local ELL columns: own -> [0, L); halo -> L + rank; pad -> L+H
        lc = np.full((S, L, Kg), L + H, dtype=np.int64)
        for s in range(S):
            block = cols_pad[s * L:(s + 1) * L]
            own = (block >= s * L) & (block < (s + 1) * L)
            lc[s][own] = block[own] - s * L
            hl = halo_lists[s]
            ext = (block < ns) & ~own
            if len(hl):
                lc[s][ext] = L + np.searchsorted(hl, block[ext])
        self.local_cols = jnp.asarray(lc.astype(np.int32))
        # PC variant: halo columns dropped (additive Schwarz, no overlap)
        lc_pc = np.where(lc < L, lc, L + H)
        self.local_cols_pc = jnp.asarray(lc_pc.astype(np.int32))

        # diagonal slot per owned supernode (for local PC diagonals).
        # Padding rows (index >= ns) must NOT match: the column sentinel
        # is ns itself, so padding row ns would otherwise "find" a
        # diagonal slot holding zero values (-> singular PC blocks).
        dslot = np.zeros((S, L), dtype=np.int64)
        hasd = np.zeros((S, L), dtype=bool)
        for s in range(S):
            block = cols_pad[s * L:(s + 1) * L]
            tgt = np.arange(s * L, (s + 1) * L)
            hit = (block == tgt[:, None]) & (tgt[:, None] < ns)
            has = hit.any(axis=1)
            dslot[s][has] = np.argmax(hit, axis=1)[has]
            hasd[s] = has
        self.diag_slot = jnp.asarray(dslot.astype(np.int32))
        self.has_diag = jnp.asarray(hasd)

    # -- jittable pieces (run INSIDE shard_map; arrays are local) -------
    def exchange(self, x_own, pack_idx, halo_src):
        """FORWARD ghost update: x_own (L, w) -> halo rows (H, w)."""
        pack = x_own[pack_idx]  # (B, w)
        allp = jax.lax.all_gather(pack, "shards")  # (S, B, w)
        flat = jnp.concatenate(
            [allp.reshape(-1, x_own.shape[1]),
             jnp.zeros((1, x_own.shape[1]), x_own.dtype)]
        )
        return flat[halo_src]

    def matvec_rows(self, vals_loc, x_own, lc, pack_idx, halo_src):
        """Owned rows of A x: vals_loc (L, Kg, gbs, gbs),
        x_own (L, gbs) -> y (L, gbs)."""
        halo = self.exchange(x_own, pack_idx, halo_src)
        x_ext = jnp.concatenate(
            [x_own, halo, jnp.zeros((1, x_own.shape[1]), x_own.dtype)]
        )
        xg = x_ext[lc]  # (L, Kg, gbs)
        return jnp.einsum(
            "lkrc,lkc->lr", vals_loc, xg,
            preferred_element_type=x_own.dtype,
        )

    def matvec_rows_local(self, vals_loc, x_own, lc_pc):
        """Owned rows of the LOCAL (halo-dropped) block A_ss x."""
        x_ext = jnp.concatenate(
            [x_own,
             jnp.zeros((self.H + 1, x_own.shape[1]), x_own.dtype)]
        )
        xg = x_ext[lc_pc]
        return jnp.einsum(
            "lkrc,lkc->lr", vals_loc, xg,
            preferred_element_type=x_own.dtype,
        )


def build_halo_step(solver):
    """Build the sharded whole-step function for a stabilized_schur-family
    solver with a NodeBSR operator. Mirrors the serial step in
    solvers/stabilized_schur.py _build_step; returns step(u, p, aux,
    bc_u_vals, bc_p_vals, prm) operating on replicated inputs/outputs
    with a fully sharded Krylov loop inside."""
    from ..la import newton_solve
    from ..la.gmres import gmres_fixed

    form = solver.form
    bsr = solver._nodebsr
    maps = HaloMaps(bsr, int(solver.n_shards))
    device_mesh = make_device_mesh(int(solver.n_shards), "shards")
    S, L, Kg, gbs = maps.S, maps.L, maps.Kg, maps.gbs
    g, bs = maps.g, maps.bs

    # phase-2 sharded (ghosted-cell) assembly: per-shard element sweeps
    # over owned+ghost cells, owner-computes row assembly
    # (dist/shard_assembly.py). CFDTPU_SHARD_ASSEMBLY=off reverts to the
    # round-2 replicated assembly for debugging.
    use_shard_asm = os.environ.get("CFDTPU_SHARD_ASSEMBLY") != "off"
    sam = None
    if use_shard_asm:
        from .shard_assembly import ShardAssemblyMaps

        sam = ShardAssemblyMaps(bsr, S, L)
    d = bsr.dim
    gd = g * d
    n = bsr.n_nodes
    ns = bsr._sup.ns
    n_u_flat = form.n_u_flat
    n_flat = form.n_flat
    newton_params = solver.newton_params
    pin_pressure = solver.pin_pressure
    m_u, m_p = solver.pc_inner_u, (solver.pc_inner_p or 30)

    bc_dofs_u = jnp.asarray(solver.bc_dofs_u)
    bc_dofs_p = jnp.asarray(solver.bc_dofs_p)
    has_bc_u = len(solver.bc_dofs_u) > 0
    has_bc_p = len(solver.bc_dofs_p) > 0

    # Two-level additive Schwarz: the per-shard S solves get a GLOBAL
    # coarse-grid correction (Hilbert-contiguous chunks of c_sup
    # supernodes per coarse dof, piecewise-constant transfer) — the
    # textbook cure for one-level ASM iteration growth with shard count.
    # The only extra collective is the psum of the (n_c,) coarse
    # residual. Coarse operator = aggregated global SELFP matrix,
    # inverted densely once per PC build.
    c_sup = max(4, -(-maps.ns_pad // 2500))
    n_c = -(-maps.ns_pad // c_sup)
    bsr.sp_structure()
    sp_row_np = np.asarray(bsr.sp_structure()[0], dtype=np.int64)
    sp_col_np = np.asarray(bsr.sp_structure()[1], dtype=np.int64)
    sp_aggr = jnp.asarray((sp_row_np // (g * c_sup)).astype(np.int32))
    sp_aggc = jnp.asarray((sp_col_np // (g * c_sup)).astype(np.int32))
    bc_mask_u_flat = jnp.asarray(
        np.zeros(n_u_flat, dtype=bool) if solver.bc_dofs_u is None
        else _u_mask(solver, n, d)
    )

    # flat-layout BC mask -> supernode-row layout (ns_pad, gbs) -> local
    bc_mask_np = np.zeros(n_flat, dtype=bool)
    for d0 in range(d):
        bc_mask_np[solver.bc_dofs_u.astype(np.int64) * d + d0] = True
    bc_mask_np[n_u_flat + solver.bc_dofs_p.astype(np.int64)] = True

    def flat_to_sup_np(x_flat, fill=0):
        out = np.full((maps.ns_pad, gbs), fill, dtype=x_flat.dtype)
        u = x_flat[:n_u_flat].reshape(n, d)
        p = x_flat[n_u_flat:]
        upad = np.zeros((maps.ns_pad * g, d), x_flat.dtype)
        upad[:n] = u
        ppad = np.zeros((maps.ns_pad * g,), x_flat.dtype)
        ppad[:n] = p
        out[:, :gd] = upad.reshape(maps.ns_pad, gd)
        out[:, gd:] = ppad.reshape(maps.ns_pad, g)
        return out

    bc_mask_sup = jnp.asarray(flat_to_sup_np(bc_mask_np))  # (ns_pad,gbs)
    # valid p-entry mask (excludes padding nodes) for global means
    pvalid_np = np.zeros(n_flat, dtype=bool)
    pvalid_np[n_u_flat:] = True
    pvalid_sup = jnp.asarray(flat_to_sup_np(pvalid_np).astype(np.float64))
    # real-node mask in sup layout: padding nodes (>= n, inside the last
    # real supernode and the padding supernodes) have all-zero operator
    # rows — their PC diagonal blocks must be treated as identity or
    # det_and_inv sees singular blocks (NaN).
    uvalid_np = np.zeros(n_flat, dtype=bool)
    uvalid_np[:n_u_flat] = True
    valid_sup = jnp.asarray(
        flat_to_sup_np((uvalid_np | pvalid_np)).astype(np.float64)
    )

    def reduce(x):
        return jax.lax.psum(x, "shards")

    # jittable flat <-> sup conversions (replicated full vectors)
    def flat_to_sup(x):
        u = x[:n_u_flat]
        p = x[n_u_flat:]
        upad = jnp.zeros((maps.ns_pad * g * d,), x.dtype).at[
            : n * d].set(u)
        ppad = jnp.zeros((maps.ns_pad * g,), x.dtype).at[:n].set(p)
        return jnp.concatenate(
            [upad.reshape(maps.ns_pad, gd),
             ppad.reshape(maps.ns_pad, g)], axis=1,
        )

    def sup_to_flat(xs):  # (ns_pad, gbs) -> (n_flat,)
        u = xs[:, :gd].reshape(-1)[: n * d]
        p = xs[:, gd:].reshape(-1)[:n]
        return jnp.concatenate([u, p])

    def local_slice(xs_full):  # (ns_pad, gbs) -> (L, gbs) of this shard
        s = jax.lax.axis_index("shards")
        return jax.lax.dynamic_slice(
            xs_full, (s * L, jnp.zeros((), s.dtype)), (L, gbs)
        )

    def step(u_guess, p_guess, aux, bc_u_vals, bc_p_vals, prm):
        def ravel(u, p):
            return jnp.concatenate([u.reshape(-1), p])

        def unravel(x):
            return x[: n * d].reshape(n, d), x[n * d:]

        def F(x):
            u, p = unravel(x)
            ru, rp = form.residual(u, p, aux, prm)
            if has_bc_u:
                ru = ru.at[bc_dofs_u].set(u[bc_dofs_u] - bc_u_vals)
            if has_bc_p:
                rp = rp.at[bc_dofs_p].set(p[bc_dofs_p] - bc_p_vals)
            if pin_pressure:
                rp = rp - jnp.mean(rp)
            return ravel(ru, rp)

        def sharded_body(pack_idx, halo_src, lc, lc_pc, dslot, has_diag,
                         bc_loc, pval_loc, valid_loc, sam_ops=()):
            """Closure factory: everything below runs inside shard_map
            with the maps as per-shard local arrays."""
            if sam_ops:
                (cells_loc, ell_jac, blk_ids,
                 sup_pos_loc, ell_res) = sam_ops

            def local_jacobian(u, p):
                """Per-shard ghosted-cell Jacobian assembly: sweep only
                this shard's cells, assemble exactly its owned sup rows
                (dist/shard_assembly.py maps), and reconstruct the
                global COO transiently (one all_gather per PC build,
                lagged => once per step) for the SELFP/coarse/diagonal
                builds that operate on the global graph."""
                dm_u = form.dofmap_u[cells_loc]
                xe = jnp.concatenate(
                    [u[dm_u].reshape(sam.Lc, -1),
                     p[form.dofmap_p[cells_loc]]], axis=1,
                )
                aux_e = tuple(a[dm_u] for a in aux)
                fk = form._flat_cell_kernel()
                A_loc = jax.vmap(
                    jax.jacfwd(fk), in_axes=(0, 0, 0, 0, None)
                )(xe, aux_e, form.cell_coords[cells_loc],
                  form.cell_h[cells_loc], prm)
                r = bsr._ridx
                ent = [
                    A_loc[:, r[:, None, :, None], r[None, :, None, :]]
                    .reshape(-1, bs, bs)
                ]
                # facet jacobians: boundary-only, O(sqrt(n)) elements —
                # swept replicated; the ELL maps route owned rows only
                for block in form._facet_blocks:
                    dm_uf = block["dofmap_u"]
                    xef = jnp.concatenate(
                        [u[dm_uf].reshape(len(dm_uf), -1),
                         p[block["dofmap_p"]]], axis=1,
                    )
                    aux_ef = tuple(a[dm_uf] for a in aux)
                    ffk = form._flat_facet_kernel(block["kernel"])
                    A_f = jax.vmap(
                        jax.jacfwd(ffk), in_axes=(0, 0, 0, 0, None)
                    )(xef, aux_ef, block["coords"], block["tabs"], prm)
                    ent.append(
                        A_f[:, r[:, None, :, None], r[None, :, None, :]]
                        .reshape(-1, bs, bs)
                    )
                ent = jnp.concatenate(ent, axis=0)
                src = jnp.concatenate(
                    [ent, jnp.zeros((1, bs, bs), ent.dtype)], axis=0
                )
                blocks_loc = src[ell_jac].sum(axis=1)  # (NB, bs, bs)
                flat = jnp.zeros(
                    (sam.sup_flat_len,), blocks_loc.dtype
                ).at[sup_pos_loc.reshape(-1)].set(
                    blocks_loc.reshape(-1), unique_indices=True,
                    mode="promise_in_bounds",
                )
                vloc = flat[: L * Kg * gbs * gbs].reshape(
                    L, Kg, gbs, gbs
                )
                coo_all = jax.lax.all_gather(blocks_loc, "shards")
                ids_all = jax.lax.all_gather(blk_ids, "shards")
                coo = jnp.zeros(
                    (sam.nb_glob + 1, bs, bs), blocks_loc.dtype
                ).at[ids_all.reshape(-1)].set(
                    coo_all.reshape(-1, bs, bs)
                )
                return vloc, {"coo": coo[: sam.nb_glob]}

            def F_sharded(x):
                """Owned-row residual from this shard's cells, gathered
                to the replicated full vector Newton needs for line
                search/norms (O(n) collective; the element sweep — the
                cost — is 1/S per shard)."""
                u, p = unravel(x)
                dm_u = form.dofmap_u[cells_loc]
                u_e = u[dm_u]
                p_e = p[form.dofmap_p[cells_loc]]
                aux_e = tuple(a[dm_u] for a in aux)
                kernel = jax.vmap(
                    form._kernel, in_axes=(0, 0, 0, 0, 0, None)
                )
                ru_e, rp_e = kernel(
                    u_e, p_e, aux_e, form.cell_coords[cells_loc],
                    form.cell_h[cells_loc], prm,
                )
                stream = [ru_e.reshape(-1), rp_e.reshape(-1)]
                for block in form._facet_blocks:
                    _, ru_f = form._block_residual(
                        block, u, p, aux, prm
                    )
                    stream.append(ru_f.reshape(-1))
                stream.append(jnp.zeros((1,), ru_e.dtype))
                src = jnp.concatenate(stream)
                r_loc = src[ell_res].sum(axis=1)  # (L*gbs,)
                full = jax.lax.all_gather(
                    r_loc.reshape(L, gbs), "shards"
                ).reshape(maps.ns_pad, gbs)
                rf = sup_to_flat(full)
                ru = rf[:n_u_flat].reshape(n, d)
                rp = rf[n_u_flat:]
                if has_bc_u:
                    ru = ru.at[bc_dofs_u].set(u[bc_dofs_u] - bc_u_vals)
                if has_bc_p:
                    rp = rp.at[bc_dofs_p].set(p[bc_dofs_p] - bc_p_vals)
                if pin_pressure:
                    rp = rp - jnp.mean(rp)
                return ravel(ru, rp)

            F_use = F_sharded if sam_ops else F

            def solve_newton(x0):
                def make_operator(x):
                    u, p = unravel(x)
                    if sam_ops:
                        vloc, vals = local_jacobian(u, p)
                    else:
                        A_cells, A_blocks = form.element_jacobians(
                            u, p, aux, prm
                        )
                        vals = bsr.assemble(A_cells, A_blocks)
                        sup = vals["sup"]  # (ns,Kg,gbs,gbs) replicated
                        sup_pad = jnp.zeros(
                            (maps.ns_pad, Kg, gbs, gbs), sup.dtype
                        ).at[:ns].set(sup)
                        s_idx0 = jax.lax.axis_index("shards")
                        zero = jnp.zeros((), s_idx0.dtype)
                        vloc = jax.lax.dynamic_slice(
                            sup_pad, (s_idx0 * L, zero, zero, zero),
                            (L, Kg, gbs, gbs),
                        )
                    s_idx = jax.lax.axis_index("shards")

                    bc_m = bc_loc.reshape(L, gbs)
                    pv = pval_loc.reshape(L, gbs)
                    n_p_glob = reduce(jnp.sum(pv))

                    def matvec(v_loc):  # (L*gbs,) local flat
                        xo = v_loc.reshape(L, gbs)
                        y = maps.matvec_rows(
                            vloc, xo, lc, pack_idx, halo_src
                        )
                        y = jnp.where(bc_m, xo, y)
                        if pin_pressure:
                            mean = reduce(jnp.sum(y * pv)) / n_p_glob
                            y = y - mean * pv
                        return y.reshape(-1)

                    # ---- local additive-Schwarz Schur PC ----
                    dblk = vloc[jnp.arange(L), dslot]  # (L, gbs, gbs)
                    dblk = jnp.where(
                        has_diag[:, None, None], dblk, jnp.eye(
                            gbs, dtype=dblk.dtype)[None],
                    )

                    def Auu_loc(v):  # (L*gd,)
                        xo = jnp.concatenate(
                            [v.reshape(L, gd),
                             jnp.zeros((L, g), v.dtype)], axis=1,
                        )
                        y = maps.matvec_rows_local(vloc, xo, lc_pc)
                        y = jnp.where(bc_m, xo, y)
                        return y[:, :gd].reshape(-1)

                    # node-block Jacobi from the supernode diagonal
                    from ..utils.geometry import det_and_inv

                    dnb = dblk[:, :gd, :gd].reshape(L, g, d, g, d)
                    dnb = dnb[
                        :, jnp.arange(g), :, jnp.arange(g), :
                    ]  # (g, L, d, d)
                    dnb = jnp.swapaxes(dnb, 0, 1).reshape(L * g, d, d)
                    # BC rows AND padding-node rows become identity
                    inval = ~valid_loc.reshape(L, gbs)
                    mask_u = (
                        bc_m[:, :gd] | inval[:, :gd]
                    ).reshape(L * g, d)
                    eye = jnp.eye(d, dtype=dnb.dtype)
                    dnb = jnp.where(mask_u[:, :, None], eye[None], dnb)
                    dnb = jnp.where(mask_u[:, None, :], eye[None], dnb)
                    _, dnb_inv = det_and_inv(dnb)

                    def Mu(v):
                        vn = v.reshape(L * g, d)
                        return jnp.einsum(
                            "nab,nb->na", dnb_inv, vn
                        ).reshape(-1)

                    def solve_Auu(r):
                        return gmres_fixed(
                            Auu_loc, r, precond=Mu, m=m_u, reorth=False
                        )

                    # SELFP Schur action, local
                    duu_d = dblk[:, jnp.arange(gd), jnp.arange(gd)]
                    duu_d = jnp.where(jnp.abs(duu_d) < 1e-30, 1.0, duu_d)
                    iduu = jnp.where(
                        bc_m[:, :gd], 0.0, 1.0 / duu_d
                    )  # (L, gd)

                    dpp = dblk[:, gd:, gd:][
                        :, jnp.arange(g), jnp.arange(g)
                    ]  # (L, g)
                    dpp = jnp.where(jnp.abs(dpp) < 1e-30, 1.0, dpp)

                    # ---- global coarse level for the S stage ----
                    d_full = bsr.jacobian_diagonal(vals, ())
                    d_u_g = d_full[:n_u_flat]
                    inv_duu_g = jnp.where(
                        bc_mask_u_flat, 0.0,
                        1.0 / jnp.where(
                            jnp.abs(d_u_g) < 1e-30, 1.0, d_u_g
                        ),
                    )
                    sp_g = bsr.sp_vals(vals, inv_duu_g)  # replicated
                    # The coarse operator is assembled, inverted and
                    # applied in float64 whatever the solver's dtype:
                    # its conditioning and its 1e-8 regularisation lie
                    # below float32's resolution, and a float32 inverse
                    # left every float32 Krylov solve at ksp_max_it.
                    A_c = jnp.zeros(
                        (n_c, n_c), jnp.float64
                    ).at[sp_aggr, sp_aggc].add(sp_g.astype(jnp.float64))
                    scale_c = jnp.max(jnp.abs(A_c))
                    # aggregates of padding-only supernodes have zero
                    # rows -> identity (their restricted residual is 0)
                    dc = jnp.abs(jnp.diagonal(A_c))
                    A_c = A_c + jnp.diag(
                        jnp.where(dc < 1e-12 * scale_c, scale_c, 0.0)
                    )
                    if pin_pressure:
                        # penalize the constant mode (A_c inherits the
                        # pressure nullspace)
                        A_c = A_c + (scale_c / n_c) * jnp.ones(
                            (n_c, n_c), A_c.dtype
                        )
                    A_c = A_c + 1e-8 * scale_c * jnp.eye(
                        n_c, dtype=A_c.dtype
                    )
                    A_c_inv = jnp.linalg.inv(A_c)
                    agg_local = (
                        s_idx * (L * g)
                        + jnp.arange(L * g, dtype=s_idx.dtype)
                    ) // (g * c_sup)
                    pv_nodes = pval_loc.reshape(L, gbs)[:, gd:].reshape(
                        -1
                    )

                    dpp_flat = dpp.reshape(-1)

                    def coarse_correct(r_p):
                        """Global coarse correction applied to the
                        OUTER residual's pressure part — the vector is
                        a consistent distributed field, so the psum'd
                        restriction is the true coarse residual. (A
                        coarse term inside the per-shard S sweeps would
                        psum UNRELATED local Krylov vectors — measured:
                        Newton diverges.)"""
                        rc = jox.segment_sum(
                            r_p * pv_nodes, agg_local, num_segments=n_c
                        )
                        rc = reduce(rc).astype(A_c_inv.dtype)
                        zc = (A_c_inv @ rc).astype(r_p.dtype)
                        return zc[agg_local] * pv_nodes

                    def S_loc(v_p):  # (L*g,)
                        xo = jnp.concatenate(
                            [jnp.zeros((L, gd), v_p.dtype),
                             v_p.reshape(L, g)], axis=1,
                        )
                        y = maps.matvec_rows_local(vloc, xo, lc_pc)
                        w = jnp.where(bc_m[:, :gd], 0.0, y[:, :gd])
                        y_pp = y[:, gd:]
                        xo2 = jnp.concatenate(
                            [iduu * w, jnp.zeros((L, g), v_p.dtype)],
                            axis=1,
                        )
                        y2 = maps.matvec_rows_local(vloc, xo2, lc_pc)
                        return (y_pp - y2[:, gd:]).reshape(-1)

                    def solve_S(r):
                        return gmres_fixed(
                            S_loc, r,
                            precond=lambda v: v / dpp_flat,
                            m=m_p, reorth=False,
                        )

                    use_coarse = (
                        os.environ.get("CFDTPU_HALO_COARSE") != "off"
                    )

                    def precond(v_loc):
                        vv = v_loc.reshape(L, gbs)
                        r_u = vv[:, :gd].reshape(-1)
                        r_p = vv[:, gd:].reshape(-1)
                        z_u = solve_Auu(r_u)
                        xo = jnp.concatenate(
                            [z_u.reshape(L, gd),
                             jnp.zeros((L, g), v_loc.dtype)], axis=1,
                        )
                        a_zu = maps.matvec_rows_local(vloc, xo, lc_pc)
                        r_s = r_p - a_zu[:, gd:].reshape(-1)
                        z_p = solve_S(r_s)
                        if use_coarse:
                            z_p = z_p + coarse_correct(r_s)
                        xo2 = jnp.concatenate(
                            [jnp.zeros((L, gd), v_loc.dtype),
                             z_p.reshape(L, g)], axis=1,
                        )
                        a_zp = maps.matvec_rows_local(vloc, xo2, lc_pc)
                        z_u = z_u - solve_Auu(
                            a_zp[:, :gd].reshape(-1)
                        )
                        z = jnp.concatenate(
                            [z_u.reshape(L, gd), z_p.reshape(L, g)],
                            axis=1,
                        )
                        return z.reshape(-1)

                    if os.environ.get("CFDTPU_HALO_PC") == "off":
                        return matvec, None
                    return matvec, precond

                # Newton state is replicated; the linear solve runs on
                # LOCAL shard vectors (newton_solve's `shard` hooks):
                # to_local slices this shard's rows, from_local
                # all_gathers the update, psum for Krylov dots.
                def to_local(v_full):
                    return local_slice(flat_to_sup(v_full)).reshape(-1)

                def from_local(v_loc):
                    full = jax.lax.all_gather(
                        v_loc.reshape(L, gbs), "shards"
                    ).reshape(maps.ns_pad, gbs)
                    return sup_to_flat(full)

                def project(dx):
                    du, dp = unravel(dx)
                    return ravel(du, dp - jnp.mean(dp))

                return newton_solve(
                    F_use, x0, newton_params,
                    make_operator=make_operator,
                    project=project if pin_pressure else None,
                    shard=(to_local, from_local, reduce),
                )

            return solve_newton

        def run(pack_idx, halo_src, lc, lc_pc, dslot, has_diag,
                bc_loc, pval_loc, valid_loc, u0, p0, *sam_stacked):
            # P("shards") operands arrive with a leading local axis of 1
            solve_newton = sharded_body(
                pack_idx[0], halo_src[0], lc[0], lc_pc[0], dslot[0],
                has_diag[0], bc_loc[0], pval_loc[0], valid_loc[0],
                sam_ops=tuple(e[0] for e in sam_stacked),
            )
            x0 = ravel(u0, p0)
            if pin_pressure:
                u_, p_ = unravel(x0)
                x0 = ravel(u_, p_ - jnp.mean(p_))
            x, stats = solve_newton(x0)
            u, p = unravel(x)
            r_u, r_p = unravel(stats.pop("final_residual"))
            return u, p, r_u, r_p, stats

        bc_mask_sh = bc_mask_sup.reshape(S, L * gbs)
        pval_sh = pvalid_sup.astype(u_guess.dtype).reshape(S, L * gbs)
        valid_sh = (valid_sup > 0).reshape(S, L * gbs)

        sam_operands = () if sam is None else (
            sam.local_cells, sam.ell_jac, sam.blk_ids,
            sam.sup_pos_loc, sam.ell_res,
        )
        sharded = shard_map(
            run,
            mesh=device_mesh,
            in_specs=(
                P("shards"), P("shards"), P("shards"), P("shards"),
                P("shards"), P("shards"), P("shards"), P("shards"),
                P("shards"), P(), P(),
            ) + (P("shards"),) * len(sam_operands),
            out_specs=(P(), P(), P(), P(), P()),
            check_vma=False,
        )
        return sharded(
            maps.pack_idx, maps.halo_src, maps.local_cols,
            maps.local_cols_pc, maps.diag_slot, maps.has_diag,
            bc_mask_sh, pval_sh, valid_sh, u_guess, p_guess,
            *sam_operands,
        )

    return step
