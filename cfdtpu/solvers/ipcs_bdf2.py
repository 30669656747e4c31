"""IPCS with BDF2-extrapolated convection and incremental pressure phi.

Rebuild of /root/reference/src/solvers/ipcs_bdf2.py: Taylor-Hood P2/P1;

1. tentative velocity (:66-82) —
   rho/dt (u - u_prev)·v + ((1.5 u_prev - 0.5 u_n1)·grad(0.5 (u+u_prev)))·v
   + 0.5 mu grad(u+u_prev):grad(v) - p_sol div(v) + f·v = 0
   (the convection operator depends on u_prev, so this element operator is
   rebuilt every step — the reference reassembles A1 per step)
2. pressure correction phi — grad phi·grad q = -rho/dt div(u*) q (:84-85);
   then p_sol += phi (:157)
3. correction — rho u·v = rho u*·v - dt grad(phi)·v (:87-91)

State u_n1 (velocity at n-1) updated after each step (:170-172).

Distribution (`n_shards`): cell-sharded like ipcs_midpoint; here the
step-1 operator depends on u_prev, so its jacfwd element-Jacobian build
runs sharded every step and the blocks never exist unsharded anywhere.

NOTE: unlike ipcs_midpoint, this scheme (like the reference, which has no
`ds` boundary terms in F1) imposes pure natural conditions on any boundary
facet not covered by a Dirichlet BC. On scenarios whose markers leave
facets untagged (e.g. the lid-driven cavity's corner-adjacent facets,
excluded by the lid marker) it is unstable — use ipcs_midpoint there or
cover the whole boundary with Dirichlet data.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..la.gmres import fgmres
from ..utils import det_and_inv
from .ipcs_midpoint import Solver as IPCSSolver


class Solver(IPCSSolver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.u_n1 = self.u_prev

    # kernels -----------------------------------------------------------
    def _r1_kernel(self, u_e, up_e, un1_e, ps_e, coords_e, prm):
        rho, mu, dt, f = prm["rho"], prm["mu"], prm["dt"], prm["f"]
        wdet, invJ = self._geom(coords_e)
        gu = jnp.einsum("qbd,qdg->qbg", self.dphi_u, invJ)
        u_q = self.phi_u @ u_e
        up_q = self.phi_u @ up_e
        un1_q = self.phi_u @ un1_e
        adv = 1.5 * up_q - 0.5 * un1_q
        grad_sum = jnp.einsum("bi,qbg->qig", 0.5 * (u_e + up_e), gu)
        ps_q = self.phi_p @ ps_e
        conv = jnp.einsum("qig,qg->qi", grad_sum, adv)
        mass = rho * (u_q - up_q) / dt + conv + f
        r = jnp.einsum("q,qb,qi->bi", wdet, self.phi_u, mass)
        r += 0.5 * mu * jnp.einsum(
            "q,qig,qbg->bi", wdet, 2.0 * grad_sum, gu
        )
        # - p_sol div(v)
        r += jnp.einsum("q,qbi->bi", -wdet * ps_q, gu)
        return r

    def _r2_kernel(self, phi_e, us_e, coords_e, prm):
        rho, dt = prm["rho"], prm["dt"]
        wdet, invJ = self._geom(coords_e)
        gp = jnp.einsum("qbd,qdg->qbg", self.dphi_p, invJ)
        gu = jnp.einsum("qbd,qdg->qbg", self.dphi_u, invJ)
        grad_phi = jnp.einsum("b,qbg->qg", phi_e, gp)
        div_us = jnp.einsum("bi,qbi->q", us_e, gu)
        r = jnp.einsum("q,qg,qbg->b", wdet, grad_phi, gp)
        r += (rho / dt) * jnp.einsum("q,q,qb->b", wdet, div_us, self.phi_p)
        return r

    def _r3_kernel(self, u_e, us_e, phi_e, coords_e, prm):
        rho, dt = prm["rho"], prm["dt"]
        wdet, invJ = self._geom(coords_e)
        gp = jnp.einsum("qbd,qdg->qbg", self.dphi_p, invJ)
        du_q = self.phi_u @ (u_e - us_e)
        grad_phi = jnp.einsum("b,qbg->qg", phi_e, gp)
        r = rho * jnp.einsum("q,qb,qi->bi", wdet, self.phi_u, du_q)
        r += dt * jnp.einsum("q,qb,qi->bi", wdet, self.phi_u, grad_phi)
        return r

    # ------------------------------------------------------------------
    def _build_step(self):
        mesh = self.mesh
        dim = mesh.gdim
        n_u, n_p = self.V.num_dofs, self.Q.num_dofs
        nbu, nbp = self.V.element.ndofs, self.Q.element.ndofs
        dm_u, dm_p = self.dofmap_u, self.dofmap_p
        dtype = self.dtype
        prm0 = self.base_params()

        bc_dofs_u = jnp.asarray(self.bc_dofs_u)
        bc_dofs_p = jnp.asarray(self.bc_dofs_p)
        has_bc_p = len(self.bc_dofs_p) > 0
        pin_pressure = self.pin_pressure
        rtol, maxiter = self.ksp_rtol, self.ksp_max_it

        bc_mask_u = jnp.zeros((n_u, dim), bool)
        if len(self.bc_dofs_u):
            bc_mask_u = bc_mask_u.at[bc_dofs_u].set(True)
        bc_mask_u_flat = bc_mask_u.reshape(-1)
        bc_mask_p = jnp.zeros((n_p,), bool)
        if has_bc_p:
            bc_mask_p = bc_mask_p.at[bc_dofs_p].set(True)

        zeros_u = jnp.zeros((nbu, dim), dtype)
        zeros_p = jnp.zeros((nbp,), dtype)
        cc = self.cell_coords

        dm_u_flat = (
            np.asarray(self.V.dofmap)[:, :, None] * dim
            + np.arange(dim)[None, None, :]
        ).reshape(-1, nbu * dim)
        dm_u_flat = jnp.asarray(dm_u_flat.astype(np.int32))
        idx_u = jnp.arange(nbu * dim)
        idx_p = jnp.arange(nbp)

        # constant operators A2 (Laplacian), A3 (mass)
        def flat2(pe, coords_e):
            return self._r2_kernel(pe, zeros_u, coords_e, prm0)

        A2 = jax.vmap(jax.jacfwd(flat2))(
            jnp.zeros((mesh.num_cells, nbp), dtype), cc
        )

        def flat3(xe, coords_e):
            return self._r3_kernel(
                xe.reshape(nbu, dim), zeros_u, zeros_p, coords_e, prm0
            ).reshape(-1)

        A3 = jax.vmap(jax.jacfwd(flat3))(
            jnp.zeros((mesh.num_cells, nbu * dim), dtype), cc
        )
        d2 = jnp.zeros((n_p,), dtype).at[dm_p].add(A2[:, idx_p, idx_p])
        d2 = jnp.where(bc_mask_p, 1.0, d2)
        d3 = jnp.zeros((n_u * dim,), dtype).at[dm_u_flat].add(
            A3[:, idx_u, idx_u]
        )

        def apply_u(A, v_flat):
            ve = v_flat[dm_u_flat]
            ye = jnp.einsum("cab,cb->ca", A, ve)
            return jnp.zeros((n_u * dim,), dtype).at[dm_u_flat].add(ye)

        def apply_p(A, v):
            ve = v[dm_p]
            ye = jnp.einsum("cab,cb->ca", A, ve)
            return jnp.zeros((n_p,), dtype).at[dm_p].add(ye)

        # -- cell sweeps: serial or cell-sharded (n_shards) ---------------
        # Same design as ipcs_midpoint: element blocks + every cell sweep
        # partitioned over a "cells" device-mesh axis, one psum per sweep,
        # replicated Krylov algebra. Step-1's operator depends on u_prev,
        # so its jacfwd build sweep runs sharded EVERY step (the element
        # Jacobian blocks never exist unsharded anywhere).
        if self.n_shards:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from jax import shard_map
            from ..dist.partition import make_device_mesh, _pad_to

            S = self.n_shards
            dmesh = make_device_mesh(S, "cells")
            nc_pad = ((mesh.num_cells + S - 1) // S) * S
            mask_np = np.zeros(nc_pad, dtype)
            mask_np[: mesh.num_cells] = 1.0
            shspec = NamedSharding(dmesh, P("cells"))

            def padsh(a):
                return jax.device_put(
                    jnp.asarray(_pad_to(np.asarray(a), nc_pad)), shspec
                )

            mask_c = jax.device_put(jnp.asarray(mask_np), shspec)
            dm_u_s, dm_p_s, cc_s = padsh(dm_u), padsh(dm_p), padsh(cc)
            dmf_s = padsh(dm_u_flat)
            A2, A3 = padsh(A2), padsh(A3)

            def apply_u(A, v_flat):  # noqa: F811 — sharded override
                def local(A, dmf, m, v):
                    ye = jnp.einsum("cab,cb->ca", A, v[dmf]) * m[:, None]
                    y = jnp.zeros((n_u * dim,), dtype).at[dmf].add(ye)
                    return jax.lax.psum(y, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"), P("cells"), P("cells"), P()),
                    out_specs=P(),
                )(A, dmf_s, mask_c, v_flat)

            def apply_p(A, v):  # noqa: F811 — sharded override
                def local(A, dmp, m, v):
                    ye = jnp.einsum("cab,cb->ca", A, v[dmp]) * m[:, None]
                    y = jnp.zeros((n_p,), dtype).at[dmp].add(ye)
                    return jax.lax.psum(y, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"), P("cells"), P("cells"), P()),
                    out_specs=P(),
                )(A, dm_p_s, mask_c, v)

            def build1(u_prev, p_prev, u_n1, prm):
                def local(dm_u, dm_p, dmf, cc, m, u_prev, p_prev, u_n1,
                          prm):
                    up_e = u_prev[dm_u]
                    un1_e = u_n1[dm_u]
                    ps_e = p_prev[dm_p]

                    def flat1(xe, upe, un1e, pse, coords_e):
                        return self._r1_kernel(
                            xe.reshape(nbu, dim), upe, un1e, pse,
                            coords_e, prm,
                        ).reshape(-1)

                    A1 = jax.vmap(jax.jacfwd(flat1))(
                        jnp.zeros((cc.shape[0], nbu * dim), dtype),
                        up_e, un1_e, ps_e, cc,
                    )
                    d1 = jnp.zeros((n_u * dim,), dtype).at[dmf].add(
                        A1[:, idx_u, idx_u] * m[:, None]
                    )
                    r0 = jax.vmap(
                        self._r1_kernel, in_axes=(None, 0, 0, 0, 0, None)
                    )(jnp.zeros((nbu, dim), dtype), up_e, un1_e, ps_e,
                      cc, prm)
                    b1 = jnp.zeros((n_u, dim), dtype).at[dm_u].add(
                        -r0 * m[:, None, None]
                    ).reshape(-1)
                    return (
                        A1,
                        jax.lax.psum(d1, "cells"),
                        jax.lax.psum(b1, "cells"),
                    )

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"),) * 5 + (P(), P(), P(), P()),
                    out_specs=(P("cells"), P(), P()),
                )(dm_u_s, dm_p_s, dmf_s, cc_s, mask_c, u_prev, p_prev,
                  u_n1, prm)

            def rhs2(u_star, prm):
                def local(dm_u, dm_p, cc, m, u_star, prm):
                    r2 = jax.vmap(
                        self._r2_kernel, in_axes=(None, 0, 0, None)
                    )(jnp.zeros((nbp,), dtype), u_star[dm_u], cc, prm)
                    b = jnp.zeros((n_p,), dtype).at[dm_p].add(
                        -r2 * m[:, None]
                    )
                    return jax.lax.psum(b, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"),) * 4 + (P(), P()),
                    out_specs=P(),
                )(dm_u_s, dm_p_s, cc_s, mask_c, u_star, prm)

            def rhs3(u_star, phi, prm):
                def local(dm_u, dm_p, cc, m, u_star, phi, prm):
                    r3 = jax.vmap(
                        self._r3_kernel, in_axes=(None, 0, 0, 0, None)
                    )(jnp.zeros((nbu, dim), dtype), u_star[dm_u],
                      phi[dm_p], cc, prm)
                    b = jnp.zeros((n_u, dim), dtype).at[dm_u].add(
                        -r3 * m[:, None, None]
                    ).reshape(-1)
                    return jax.lax.psum(b, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"),) * 4 + (P(), P(), P()),
                    out_specs=P(),
                )(dm_u_s, dm_p_s, cc_s, mask_c, u_star, phi, prm)
        else:
            def build1(u_prev, p_prev, u_n1, prm):
                up_e = u_prev[dm_u]
                un1_e = u_n1[dm_u]
                ps_e = p_prev[dm_p]

                def flat1(xe, upe, un1e, pse, coords_e):
                    return self._r1_kernel(
                        xe.reshape(nbu, dim), upe, un1e, pse, coords_e,
                        prm,
                    ).reshape(-1)

                A1 = jax.vmap(
                    jax.jacfwd(flat1), in_axes=(0, 0, 0, 0, 0)
                )(
                    jnp.zeros((mesh.num_cells, nbu * dim), dtype),
                    up_e, un1_e, ps_e, cc,
                )
                d1 = jnp.zeros((n_u * dim,), dtype).at[dm_u_flat].add(
                    A1[:, idx_u, idx_u]
                )
                r0 = jax.vmap(
                    self._r1_kernel, in_axes=(None, 0, 0, 0, 0, None)
                )(zeros_u, up_e, un1_e, ps_e, cc, prm)
                b1 = jnp.zeros((n_u, dim), dtype).at[dm_u].add(
                    -r0
                ).reshape(-1)
                return A1, d1, b1

            def rhs2(u_star, prm):
                r2 = jax.vmap(
                    self._r2_kernel, in_axes=(None, 0, 0, None)
                )(zeros_p, u_star[dm_u], cc, prm)
                return jnp.zeros((n_p,), dtype).at[dm_p].add(-r2)

            def rhs3(u_star, phi, prm):
                r3 = jax.vmap(
                    self._r3_kernel, in_axes=(None, 0, 0, 0, None)
                )(zeros_u, u_star[dm_u], phi[dm_p], cc, prm)
                return jnp.zeros((n_u, dim), dtype).at[dm_u].add(
                    -r3
                ).reshape(-1)

        def step(u_prev, p_prev, u_n1, bc_u_vals, bc_p_vals, prm):
            # step 1: operator depends on u_prev -> rebuild per step
            A1, d1, b1 = build1(u_prev, p_prev, u_n1, prm)
            d1 = jnp.where(bc_mask_u_flat, 1.0, d1)

            def mv1(v):
                y = apply_u(A1, v)
                return jnp.where(bc_mask_u_flat, v, y)

            b1 = jnp.where(
                bc_mask_u_flat,
                jnp.zeros((n_u, dim), dtype).at[bc_dofs_u].set(
                    bc_u_vals
                ).reshape(-1),
                b1,
            )
            us, info1 = fgmres(
                mv1, b1, x0=u_prev.reshape(-1),
                precond=lambda v: v / d1, restart=30, maxiter=maxiter,
                rtol=rtol,
            )
            u_star = us.reshape(n_u, dim)

            # step 2: phi
            b2 = rhs2(u_star, prm)

            def mv2(v):
                y = apply_p(A2, v)
                y = jnp.where(bc_mask_p, v, y)
                if pin_pressure:
                    y = y - jnp.mean(y)
                return y

            if has_bc_p:
                b2 = jnp.where(
                    bc_mask_p,
                    jnp.zeros((n_p,), dtype).at[bc_dofs_p].set(bc_p_vals),
                    b2,
                )
            if pin_pressure:
                b2 = b2 - jnp.mean(b2)
            phi, info2 = fgmres(
                mv2, b2, precond=lambda v: v / d2, restart=30,
                maxiter=maxiter, rtol=rtol,
            )
            p_new = p_prev + phi
            if pin_pressure:
                p_new = p_new - jnp.mean(p_new)

            # step 3
            b3 = rhs3(u_star, phi, prm)

            def mv3(v):
                return apply_u(A3, v)

            uc, info3 = fgmres(
                mv3, b3, x0=us, precond=lambda v: v / d3, restart=30,
                maxiter=maxiter, rtol=rtol,
            )
            u_new = uc.reshape(n_u, dim)

            iters = info1["iters"] + info2["iters"] + info3["iters"]
            ok = (
                info1["converged"] & info2["converged"] & info3["converged"]
            )
            res_u = (mv1(us) - b1).reshape(n_u, dim)
            res_p = mv2(phi) - b2
            return u_new, p_new, res_u, res_p, {
                "ksp_iters": iters, "converged": ok,
            }

        self._step_fn = step
        self._step = jax.jit(step)

    def solveStep(self) -> None:
        bc_u_vals, bc_p_vals = self._bc_values()
        u, p, r_u, r_p, stats = self._step(
            self.u_prev, self.p_prev, self.u_n1, bc_u_vals, bc_p_vals,
            self.base_params(),
        )
        stats = jax.device_get(stats)  # one batched host transfer
        self.last_stats = {
            k: (v.item() if hasattr(v, "item") else v)
            for k, v in stats.items()
        }
        if not bool(stats["converged"]):
            raise RuntimeError(
                f"IPCS-BDF2 linear solve did not converge "
                f"(total iters {self.last_stats['ksp_iters']})."
            )
        # u_n1 <- u_prev for the next step (reference :170-172)
        self.u_n1 = self.u_prev
        self.u_sol, self.p_sol = u, p
        self.u_residual, self.p_residual = r_u, r_p
        print(
            f"IPCS-BDF2 step: {self.last_stats['ksp_iters']} total linear "
            f"iterations"
        )
        self.step_count += 1
