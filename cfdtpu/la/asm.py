"""Additive-Schwarz (ASM) preconditioner over supernode subdomains.

The single-chip analogue of the halo layer's per-shard PC
(dist/halo.py): the Hilbert-contiguous supernode ranges are geometric
subdomains; each owns a local SELFP Schur fieldsplit solve on its
owned block (halo couplings dropped, zero overlap), applied additively
and in parallel via vmap over the subdomain axis.

This is the PC behind the ASPIN solver rebuild
(solvers/stabilized_schur_aspin.py). Reference: `snes.setType("aspin")`
(/root/reference/src/solvers/stabilized_schur_aspin.py:196) — PETSc's
ASPIN is Newton on the nonlinear additively-Schwarz-preconditioned
residual; here the same subdomain structure preconditions both the
Newton linear solves (this module) and optional nonlinear Richardson
pre-sweeps (the linearized one-local-Newton-step collapse of ASPIN's
local solves).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .gmres import gmres_fixed


def make_asm_precond(bsr, vals, bc_mask_flat, n_sub: int,
                     m_u: int = 6, m_p: int = 20):
    """Build v_flat -> M v_flat (flat global dof layout), where M is the
    nonoverlapping ASM sum of local Schur-fieldsplit solves.

    Static maps (partition, local columns, diagonal slots) come from
    dist.halo.HaloMaps on the supernode graph; all subdomain solves are
    batched with vmap — the device executes n_sub local sweeps as one
    batched kernel, the moral equivalent of PETSc ASM's per-process
    subsolves (/root/reference/src/solvers/stabilized_schur.py:261-264).
    """
    from ..dist.halo import HaloMaps
    from ..utils.geometry import det_and_inv

    # static maps cached on the operator (built once per mesh)
    cache = getattr(bsr, "_asm_maps", None)
    if cache is None or cache[0] != int(n_sub):
        bsr._asm_maps = (int(n_sub), HaloMaps(bsr, int(n_sub)))
    maps = bsr._asm_maps[1]
    S, L, Kg, gbs = maps.S, maps.L, maps.Kg, maps.gbs
    g, bs, d = maps.g, bsr.bs, bsr.dim
    gd = g * d
    ns, n = bsr._sup.ns, bsr.n_nodes
    n_u_flat = bsr.n_u_flat

    sup = vals["sup"] if isinstance(vals, dict) else vals
    sup_pad = jnp.zeros((maps.ns_pad, Kg, gbs, gbs), sup.dtype).at[
        :ns].set(sup)
    v_sub = sup_pad.reshape(S, L, Kg, gbs, gbs)
    lc_pc = maps.local_cols_pc  # (S, L, Kg) halo cols -> zero sentinel

    # masks in the sup layout
    def flat_to_sup_np(x):
        up = np.zeros((maps.ns_pad * g, d), x.dtype)
        up[:n] = x[:n_u_flat].reshape(n, d)
        pp = np.zeros((maps.ns_pad * g,), x.dtype)
        pp[:n] = x[n_u_flat:]
        return np.concatenate(
            [up.reshape(maps.ns_pad, gd), pp.reshape(maps.ns_pad, g)],
            axis=1,
        )

    full_bc = np.asarray(bc_mask_flat)  # full flat mask (n_flat,)
    assert full_bc.shape[0] == bsr.form.n_flat
    bc_sub = jnp.asarray(flat_to_sup_np(full_bc)).reshape(S, L, gbs)
    valid_np = np.ones(bsr.form.n_flat, dtype=bool)
    valid_sub = jnp.asarray(flat_to_sup_np(valid_np)).reshape(S, L, gbs)

    H = maps.H

    def local_mv(vloc, lc, xo):
        x_ext = jnp.concatenate(
            [xo, jnp.zeros((H + 1, gbs), xo.dtype)]
        )
        return jnp.einsum(
            "lkrc,lkc->lr", vloc, x_ext[lc],
            preferred_element_type=xo.dtype,
        )

    def local_solve(vloc, lc, dslot, hasd, bc_m, valid_m, r_loc):
        """One subdomain: LDU Schur solve of the local block."""
        dblk = vloc[jnp.arange(L), dslot]
        dblk = jnp.where(
            hasd[:, None, None], dblk,
            jnp.eye(gbs, dtype=dblk.dtype)[None],
        )
        inval = ~valid_m

        def Auu(v):
            xo = jnp.concatenate(
                [v.reshape(L, gd), jnp.zeros((L, g), v.dtype)], axis=1
            )
            y = local_mv(vloc, lc, xo)
            y = jnp.where(bc_m, xo, y)
            return y[:, :gd].reshape(-1)

        mask_u = (bc_m[:, :gd] | inval[:, :gd]).reshape(L * g, d)
        dnb = dblk[:, :gd, :gd].reshape(L, g, d, g, d)
        dnb = dnb[:, jnp.arange(g), :, jnp.arange(g), :]
        dnb = jnp.swapaxes(dnb, 0, 1).reshape(L * g, d, d)
        eye = jnp.eye(d, dtype=dnb.dtype)
        dnb = jnp.where(mask_u[:, :, None], eye[None], dnb)
        dnb = jnp.where(mask_u[:, None, :], eye[None], dnb)
        _, dnb_inv = det_and_inv(dnb)

        def Mu(v):
            vn = v.reshape(L * g, d)
            return jnp.einsum("nab,nb->na", dnb_inv, vn).reshape(-1)

        def solve_Auu(r):
            return gmres_fixed(Auu, r, precond=Mu, m=m_u, reorth=False)

        duu_d = dblk[:, jnp.arange(gd), jnp.arange(gd)]
        duu_d = jnp.where(jnp.abs(duu_d) < 1e-30, 1.0, duu_d)
        iduu = jnp.where(bc_m[:, :gd], 0.0, 1.0 / duu_d)
        dpp = dblk[:, gd:, gd:][:, jnp.arange(g), jnp.arange(g)]
        dpp = jnp.where(jnp.abs(dpp) < 1e-30, 1.0, dpp)

        def S_op(v_p):
            xo = jnp.concatenate(
                [jnp.zeros((L, gd), v_p.dtype), v_p.reshape(L, g)],
                axis=1,
            )
            y = local_mv(vloc, lc, xo)
            w = jnp.where(bc_m[:, :gd], 0.0, y[:, :gd])
            xo2 = jnp.concatenate(
                [iduu * w, jnp.zeros((L, g), v_p.dtype)], axis=1
            )
            y2 = local_mv(vloc, lc, xo2)
            return (y[:, gd:] - y2[:, gd:]).reshape(-1)

        def solve_S(r):
            return gmres_fixed(
                S_op, r, precond=lambda v: v / dpp.reshape(-1),
                m=m_p, reorth=False,
            )

        r_u = r_loc[:, :gd].reshape(-1)
        r_p = r_loc[:, gd:].reshape(-1)
        z_u = solve_Auu(r_u)
        xo = jnp.concatenate(
            [z_u.reshape(L, gd), jnp.zeros((L, g), r_loc.dtype)], axis=1
        )
        r_s = r_p - local_mv(vloc, lc, xo)[:, gd:].reshape(-1)
        z_p = solve_S(r_s)
        xo2 = jnp.concatenate(
            [jnp.zeros((L, gd), r_loc.dtype), z_p.reshape(L, g)], axis=1
        )
        z_u = z_u - solve_Auu(
            local_mv(vloc, lc, xo2)[:, :gd].reshape(-1)
        )
        return jnp.concatenate(
            [z_u.reshape(L, gd), z_p.reshape(L, g)], axis=1
        )

    batched = jax.vmap(local_solve)

    def flat_to_sup(x):
        up = jnp.zeros((maps.ns_pad * g * d,), x.dtype).at[
            : n * d].set(x[:n_u_flat])
        pp = jnp.zeros((maps.ns_pad * g,), x.dtype).at[:n].set(
            x[n_u_flat:]
        )
        return jnp.concatenate(
            [up.reshape(maps.ns_pad, gd), pp.reshape(maps.ns_pad, g)],
            axis=1,
        )

    def sup_to_flat(xs):
        return jnp.concatenate(
            [xs[:, :gd].reshape(-1)[: n * d],
             xs[:, gd:].reshape(-1)[:n]]
        )

    def precond(v_flat):
        r_sub = flat_to_sup(v_flat).reshape(S, L, gbs)
        z = batched(
            v_sub, lc_pc, maps.diag_slot, maps.has_diag, bc_sub,
            valid_sub, r_sub,
        )
        return sup_to_flat(z.reshape(maps.ns_pad, gbs))

    return precond
