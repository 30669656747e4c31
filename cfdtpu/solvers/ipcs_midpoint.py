"""IPCS (incremental pressure-correction / Chorin) solver, midpoint scheme.

Rebuild of /root/reference/src/solvers/ipcs_midpoint.py: Taylor-Hood
P2/P1 spaces (:45-48), three linear sub-steps per time step (:118-153):

1. tentative velocity — rho (u - u_prev)/dt·v + rho (u_prev·grad u_prev)·v
   + sigma(u_mid, p_prev):eps(v) + [p_prev n·v - mu grad^T(u_mid) n·v] ds
   - f·v = 0, u_mid = (u + u_prev)/2 (:63-67)
2. pressure Poisson — grad p·grad q = grad p_prev·grad q
   - (rho/dt) div(u*) q (:71-73)
3. velocity correction — rho (u - u*)·v + dt grad(p - p_prev)·v = 0 (:77-78)

All three operators are CONSTANT (assembled once as element
blocks at setup — the reference assembles PETSc matrices once, :86-96);
each step builds the right-hand sides with vmapped kernels and runs
jitted Krylov solves (the analogue of BCGS/CG + hypre/SOR, :98-116).
The entire 3-solve step is one jitted function.

Distribution (`n_shards`): cell-sharded, dof-replicated — the element
operators and every cell sweep (RHS assembly, operator application) are
partitioned over a `jax.sharding.Mesh` "cells" axis via shard_map; one
psum per sweep replaces the dolfinx REVERSE+FORWARD ghost updates while
Krylov vector algebra runs replicated (dist/partition.py design). Per-
chip element-operator memory and sweep FLOPs drop ~n_shards-fold.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..elements import LagrangeElement, quadrature
from ..la.gmres import fgmres
from ..mesh import Mesh
from ..spaces.dirichlet import combine_bcs, gather_values
from ..utils import det_and_inv
from .base import SolverBase


class Solver(SolverBase):
    V_DEGREE = 2
    Q_DEGREE = 1

    def __init__(
        self,
        mesh: Mesh,
        dt: float,
        rho: float,
        mu: float,
        f,
        initial_velocity: Callable | None = None,
        ksp_rtol: float | None = None,
        ksp_max_it: int = 500,
        n_shards: int | None = None,
        **kwargs,
    ):
        super().__init__(mesh, dt, rho, mu, f, initial_velocity)
        self.n_shards = int(n_shards) if n_shards else None
        from ..utils.dtypes import default_tolerances

        self.ksp_rtol = (
            default_tolerances(self.dtype)["ksp_rtol"]
            if ksp_rtol is None
            else float(ksp_rtol)
        )
        self.ksp_max_it = int(ksp_max_it)

        self.initVelocitySpace(self.V_DEGREE)
        self.initPressureSpace(self.Q_DEGREE)
        if initial_velocity is not None:
            self.u_prev = jnp.asarray(self.V.interpolate(initial_velocity))

        self._build_tables()
        self.last_stats = {}
        self.step_count = 0

    # ------------------------------------------------------------------
    def _build_tables(self):
        mesh = self.mesh
        dt = self.dtype
        qd = 2 * self.V_DEGREE + 1
        xi, w = quadrature(mesh.cell_type, qd)
        phi_u, dphi_u = self.V.element.tabulate(xi, nderiv=1)[:2]
        phi_p, dphi_p = self.Q.element.tabulate(xi, nderiv=1)[:2]
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = geom.tabulate(xi, nderiv=1)

        j = jnp.asarray
        self.qw = j(w, dtype=dt)
        self.phi_u = j(phi_u, dtype=dt)
        self.dphi_u = j(dphi_u, dtype=dt)
        self.phi_p = j(phi_p, dtype=dt)
        self.dphi_p = j(dphi_p, dtype=dt)
        self.gdphi = j(gdphi, dtype=dt)
        self.dofmap_u = j(self.V.dofmap)
        self.dofmap_p = j(self.Q.dofmap)
        self.cell_coords = j(mesh.points[mesh.cells], dtype=dt)

        # boundary facet tables for the ds terms in step 1
        from ..assembly import FacetQuadrature

        all_f = np.arange(len(mesh.facets), dtype=np.int32)
        fq = FacetQuadrature(mesh, all_f, qd)
        bphi_u, bdphi_u = fq.tabulate(self.V.element)
        bphi_p, _ = fq.tabulate(self.Q.element)
        _, bgdphi = fq.tabulate(geom)
        _, normal, dS = fq.geometry()
        g = fq.group
        self.b_cells = j(fq.cells)
        self.b_phi_u = j(bphi_u, dtype=dt)[g]
        self.b_dphi_u = j(bdphi_u, dtype=dt)[g]
        self.b_phi_p = j(bphi_p, dtype=dt)[g]
        self.b_gdphi = j(bgdphi, dtype=dt)[g]
        self.b_normal = j(normal, dtype=dt)
        self.b_dS = j(dS, dtype=dt)

    def _geom(self, coords_e):
        J = jnp.einsum("vg,qvd->qgd", coords_e, self.gdphi)
        detJ, invJ = det_and_inv(J)
        return jnp.abs(detJ) * self.qw, invJ

    # element kernels ---------------------------------------------------
    def _r1_kernel(self, u_e, up_e, pp_e, coords_e, prm):
        """Step-1 residual for element dofs u_e (nbu, d)."""
        rho, mu, dt, f = prm["rho"], prm["mu"], prm["dt"], prm["f"]
        wdet, invJ = self._geom(coords_e)
        gu = jnp.einsum("qbd,qdg->qbg", self.dphi_u, invJ)
        gp = jnp.einsum("qbd,qdg->qbg", self.dphi_p, invJ)
        u_q = self.phi_u @ u_e
        up_q = self.phi_u @ up_e
        um_e = 0.5 * (u_e + up_e)
        grad_um = jnp.einsum("bi,qbg->qig", um_e, gu)
        grad_up = jnp.einsum("bi,qbg->qig", up_e, gu)
        pp_q = self.phi_p @ pp_e
        conv = jnp.einsum("qig,qg->qi", grad_up, up_q)
        dim = u_e.shape[1]
        sig = (
            mu * (grad_um + jnp.swapaxes(grad_um, 1, 2))
            - pp_q[:, None, None] * jnp.eye(dim, dtype=wdet.dtype)
        )
        mass = rho * ((u_q - up_q) / dt + conv) - f
        r = jnp.einsum("q,qb,qi->bi", wdet, self.phi_u, mass)
        r += jnp.einsum("q,qij,qbj->bi", wdet, sig, gu)
        return r

    def _r1_boundary_kernel(self, u_e, up_e, pp_e, coords_e, phi_u,
                            dphi_u, phi_p, gdphi, normal, dS, prm):
        """+ p_prev n·v - mu grad^T(u_mid) n·v over exterior facets."""
        mu = prm["mu"]
        J = jnp.einsum("vg,qvd->qgd", coords_e, gdphi)
        _, invJ = det_and_inv(J)
        gu = jnp.einsum("qbd,qdg->qbg", dphi_u, invJ)
        um_e = 0.5 * (u_e + up_e)
        grad_um = jnp.einsum("bi,qbg->qig", um_e, gu)
        pp_q = phi_p @ pp_e  # (q,)
        gtn = jnp.einsum("qjg,qj->qg", grad_um, normal)
        term = pp_q[:, None] * normal - mu * gtn
        return jnp.einsum("q,qb,qi->bi", dS, phi_u, term)

    def _r2_kernel(self, p_e, pp_e, us_e, coords_e, prm):
        """Step-2 residual: grad p·grad q - grad p_prev·grad q
        + (rho/dt) div(u*) q."""
        rho, dt = prm["rho"], prm["dt"]
        wdet, invJ = self._geom(coords_e)
        gp = jnp.einsum("qbd,qdg->qbg", self.dphi_p, invJ)
        gu = jnp.einsum("qbd,qdg->qbg", self.dphi_u, invJ)
        grad_dp = jnp.einsum("b,qbg->qg", p_e - pp_e, gp)
        div_us = jnp.einsum("bi,qbi->q", us_e, gu)
        r = jnp.einsum("q,qg,qbg->b", wdet, grad_dp, gp)
        r += (rho / dt) * jnp.einsum("q,q,qb->b", wdet, div_us, self.phi_p)
        return r

    def _r3_kernel(self, u_e, us_e, ps_e, pp_e, coords_e, prm):
        """Step-3 residual: rho (u - u*)·v + dt grad(p - p_prev)·v."""
        rho, dt = prm["rho"], prm["dt"]
        wdet, invJ = self._geom(coords_e)
        gp = jnp.einsum("qbd,qdg->qbg", self.dphi_p, invJ)
        du_q = self.phi_u @ (u_e - us_e)
        grad_dp = jnp.einsum("b,qbg->qg", ps_e - pp_e, gp)
        r = rho * jnp.einsum("q,qb,qi->bi", wdet, self.phi_u, du_q)
        r += dt * jnp.einsum("q,qb,qi->bi", wdet, self.phi_u, grad_dp)
        return r

    # ------------------------------------------------------------------
    def setup(self, bcu, bcp, facet_tags=None, tags=None) -> None:
        self.bcu_d = [bc.getBC(self.V) for bc in bcu]
        self.bcp_d = [bc.getBC(self.Q) for bc in bcp]
        self.bc_dofs_u, self._keep_u = combine_bcs(self.bcu_d, self.mesh.gdim)
        self.bc_dofs_p, self._keep_p = combine_bcs(self.bcp_d, 1)
        self.pin_pressure = len(self.bc_dofs_p) == 0
        self._build_step()

    def _build_step(self):
        mesh = self.mesh
        dim = mesh.gdim
        n_u, n_p = self.V.num_dofs, self.Q.num_dofs
        nbu = self.V.element.ndofs
        nbp = self.Q.element.ndofs
        dm_u, dm_p = self.dofmap_u, self.dofmap_p
        dtype = self.dtype
        prm0 = self.base_params()

        bc_dofs_u = jnp.asarray(self.bc_dofs_u)
        bc_dofs_p = jnp.asarray(self.bc_dofs_p)
        has_bc_u = len(self.bc_dofs_u) > 0
        has_bc_p = len(self.bc_dofs_p) > 0
        pin_pressure = self.pin_pressure
        rtol, maxiter = self.ksp_rtol, self.ksp_max_it

        bc_mask_u = jnp.zeros((n_u, dim), bool)
        if has_bc_u:
            bc_mask_u = bc_mask_u.at[bc_dofs_u].set(True)
        bc_mask_p = jnp.zeros((n_p,), bool)
        if has_bc_p:
            bc_mask_p = bc_mask_p.at[bc_dofs_p].set(True)

        zeros_u = jnp.zeros((nbu, dim), dtype)
        zeros_p = jnp.zeros((nbp,), dtype)
        cc = self.cell_coords

        # constant element operators (dr/dx; affine forms -> exact)
        def flat1(xe, coords_e):
            return self._r1_kernel(
                xe.reshape(nbu, dim), zeros_u, zeros_p, coords_e, prm0
            ).reshape(-1) - self._r1_kernel(
                zeros_u, zeros_u, zeros_p, coords_e, prm0
            ).reshape(-1)

        A1 = jax.vmap(jax.jacfwd(flat1))(
            jnp.zeros((mesh.num_cells, nbu * dim), dtype), cc
        )

        # boundary contribution to A1 (depends on u through grad term)
        bargs = (
            self.cell_coords[self.b_cells], self.b_phi_u, self.b_dphi_u,
            self.b_phi_p, self.b_gdphi, self.b_normal, self.b_dS,
        )

        def bflat1(xe, coords_e, phi_u, dphi_u, phi_p, gdphi, normal, dS):
            return self._r1_boundary_kernel(
                xe.reshape(nbu, dim), zeros_u, zeros_p, coords_e,
                phi_u, dphi_u, phi_p, gdphi, normal, dS, prm0,
            ).reshape(-1)

        A1b = jax.vmap(jax.jacfwd(bflat1))(
            jnp.zeros((len(self.b_cells), nbu * dim), dtype), *bargs
        )

        def flat2(pe, coords_e):
            return self._r2_kernel(pe, zeros_p, zeros_u, coords_e, prm0)

        A2 = jax.vmap(jax.jacfwd(flat2))(
            jnp.zeros((mesh.num_cells, nbp), dtype), cc
        )

        def flat3(xe, coords_e):
            return self._r3_kernel(
                xe.reshape(nbu, dim), zeros_u, zeros_p, zeros_p, coords_e,
                prm0,
            ).reshape(-1)

        A3 = jax.vmap(jax.jacfwd(flat3))(
            jnp.zeros((mesh.num_cells, nbu * dim), dtype), cc
        )

        dm_u_flat = (
            np.asarray(self.V.dofmap)[:, :, None] * dim
            + np.arange(dim)[None, None, :]
        ).reshape(-1, nbu * dim)
        dm_u_flat = jnp.asarray(dm_u_flat.astype(np.int32))
        dm_u_flat_b = dm_u_flat[self.b_cells]
        bc_mask_u_flat = bc_mask_u.reshape(-1)

        def apply_u(A, Ab, v_flat):
            ve = v_flat[dm_u_flat]
            ye = jnp.einsum("cab,cb->ca", A, ve)
            y = jnp.zeros((n_u * dim,), dtype).at[dm_u_flat].add(ye)
            if Ab is not None:
                vb = v_flat[dm_u_flat_b]
                yb = jnp.einsum("fab,fb->fa", Ab, vb)
                y = y.at[dm_u_flat_b].add(yb)
            return y

        def apply_p(A, v):
            ve = v[dm_p]
            ye = jnp.einsum("cab,cb->ca", A, ve)
            return jnp.zeros((n_p,), dtype).at[dm_p].add(ye)

        idx_u = jnp.arange(nbu * dim)
        d1 = jnp.zeros((n_u * dim,), dtype).at[dm_u_flat].add(
            A1[:, idx_u, idx_u]
        ).at[dm_u_flat_b].add(A1b[:, idx_u, idx_u])
        idx_p = jnp.arange(nbp)
        d2 = jnp.zeros((n_p,), dtype).at[dm_p].add(A2[:, idx_p, idx_p])
        d3 = jnp.zeros((n_u * dim,), dtype).at[dm_u_flat].add(
            A3[:, idx_u, idx_u]
        )
        d1 = jnp.where(bc_mask_u_flat, 1.0, d1)
        d2 = jnp.where(bc_mask_p, 1.0, d2)

        # AMG on the (constant) pressure Poisson operator — the analogue
        # of the reference's CG + BoomerAMG step-2 KSP (reference
        # ipcs_midpoint.py:102-110). The operator never changes, so the
        # hierarchy AND its values are built once here, eagerly.
        from ..la.amg import AMG

        dm_p_np = np.asarray(self.Q.dofmap)
        prow = np.repeat(dm_p_np, nbp, axis=1).reshape(-1).astype(np.int64)
        pcol = np.tile(dm_p_np, (1, nbp)).reshape(-1).astype(np.int64)
        pkeys = prow * n_p + pcol
        puniq, pinv = np.unique(pkeys, return_inverse=True)
        porder = np.argsort(pinv, kind="stable")
        a2_coo = jax.ops.segment_sum(
            A2.reshape(-1)[jnp.asarray(porder.astype(np.int32))],
            jnp.asarray(pinv[porder].astype(np.int32)),
            num_segments=len(puniq), indices_are_sorted=True,
        )
        a2_row = (puniq // n_p).astype(np.int64)
        if has_bc_p:
            # identity rows at pressure-Dirichlet dofs, mirroring mv2
            bcp_np = np.asarray(bc_mask_p)
            a2_coo = jnp.where(jnp.asarray(bcp_np[a2_row]), 0.0, a2_coo)
            diag_pos = np.searchsorted(puniq, np.arange(n_p) * n_p
                                       + np.arange(n_p))
            a2_coo = a2_coo.at[jnp.asarray(diag_pos)].set(
                jnp.where(jnp.asarray(bcp_np), 1.0,
                          a2_coo[jnp.asarray(diag_pos)])
            )
        p_amg = AMG(a2_row.astype(np.int32),
                    (puniq % n_p).astype(np.int32), n_p,
                    linear_parents=(
                        self.Q.linear_parents()
                        if self.Q.degree > 1 else None
                    ))
        p_built = p_amg.build(a2_coo)

        def precond_p(v):
            return p_amg.v_cycle(p_built, v)

        def mv1_raw(v):
            return apply_u(A1, A1b, v)

        def mv3_raw(v):
            return apply_u(A3, None, v)

        def mv2_raw(v):
            return apply_p(A2, v)

        def pc1(v):
            return v / d1

        # -- cell sweeps: serial or cell-sharded (n_shards) ---------------
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

            def padsh(a):  # pad cell axis to nc_pad, shard over devices
                return jax.device_put(
                    jnp.asarray(_pad_to(np.asarray(a), nc_pad)), shspec
                )

            mask_c = jax.device_put(jnp.asarray(mask_np), shspec)
            dm_u_s, dm_p_s, cc_s = padsh(dm_u), padsh(dm_p), padsh(cc)
            dmf_s = padsh(dm_u_flat)
            # element operators live sharded for their whole lifetime
            A1, A2, A3 = padsh(A1), padsh(A2), padsh(A3)

            def apply_u(A, Ab, v_flat):
                def local(A, dmf, m, v):
                    ye = jnp.einsum("cab,cb->ca", A, v[dmf]) * m[:, None]
                    y = jnp.zeros((n_u * dim,), dtype).at[dmf].add(ye)
                    return jax.lax.psum(y, "cells")

                y = shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"), P("cells"), P("cells"), P()),
                    out_specs=P(),
                )(A, dmf_s, mask_c, v_flat)
                if Ab is not None:  # boundary block: small, replicated
                    vb = v_flat[dm_u_flat_b]
                    yb = jnp.einsum("fab,fb->fa", Ab, vb)
                    y = y.at[dm_u_flat_b].add(yb)
                return y

            def apply_p(A, v):
                def local(A, dmp, m, v):
                    ye = jnp.einsum("cab,cb->ca", A, v[dmp]) * m[:, None]
                    y = jnp.zeros((n_p,), dtype).at[dmp].add(ye)
                    return jax.lax.psum(y, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"), P("cells"), P("cells"), P()),
                    out_specs=P(),
                )(A, dm_p_s, mask_c, v)

            def rhs1(u_prev, p_prev, prm):
                def local(dm_u, dm_p, cc, m, u_prev, p_prev, prm):
                    r0 = jax.vmap(
                        self._r1_kernel, in_axes=(None, 0, 0, 0, None)
                    )(jnp.zeros((nbu, dim), dtype), u_prev[dm_u],
                      p_prev[dm_p], cc, prm)
                    b = jnp.zeros((n_u, dim), dtype).at[dm_u].add(
                        -r0 * m[:, None, None]
                    )
                    return jax.lax.psum(b, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"),) * 4 + (P(), P(), P()),
                    out_specs=P(),
                )(dm_u_s, dm_p_s, cc_s, mask_c, u_prev, p_prev, prm)

            def rhs2(p_prev, u_star, prm):
                def local(dm_u, dm_p, cc, m, p_prev, u_star, prm):
                    r2 = jax.vmap(
                        self._r2_kernel, in_axes=(None, 0, 0, 0, None)
                    )(jnp.zeros((nbp,), dtype), p_prev[dm_p],
                      u_star[dm_u], cc, prm)
                    b = jnp.zeros((n_p,), dtype).at[dm_p].add(
                        -r2 * m[:, None]
                    )
                    return jax.lax.psum(b, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"),) * 4 + (P(), P(), P()),
                    out_specs=P(),
                )(dm_u_s, dm_p_s, cc_s, mask_c, p_prev, u_star, prm)

            def rhs3(u_star, p_new, p_prev, prm):
                def local(dm_u, dm_p, cc, m, u_star, p_new, p_prev, prm):
                    r3 = jax.vmap(
                        self._r3_kernel, in_axes=(None, 0, 0, 0, 0, None)
                    )(jnp.zeros((nbu, dim), dtype), u_star[dm_u],
                      p_new[dm_p], p_prev[dm_p], cc, prm)
                    b = jnp.zeros((n_u, dim), dtype).at[dm_u].add(
                        -r3 * m[:, None, None]
                    )
                    return jax.lax.psum(b, "cells")

                return shard_map(
                    local, mesh=dmesh,
                    in_specs=(P("cells"),) * 4 + (P(), P(), P(), P()),
                    out_specs=P(),
                )(dm_u_s, dm_p_s, cc_s, mask_c, u_star, p_new, p_prev,
                  prm)
        else:
            # the dofmap/coordinate reads go through `self` so the
            # const-args wrapper can swap them for tracers (big-mesh
            # remote compiles)
            def rhs1(u_prev, p_prev, prm):
                du, dp = self.dofmap_u, self.dofmap_p
                r0 = jax.vmap(
                    self._r1_kernel, in_axes=(None, 0, 0, 0, None)
                )(zeros_u, u_prev[du], p_prev[dp], self.cell_coords, prm)
                return jnp.zeros((n_u, dim), dtype).at[du].add(-r0)

            def rhs2(p_prev, u_star, prm):
                du, dp = self.dofmap_u, self.dofmap_p
                r2 = jax.vmap(
                    self._r2_kernel, in_axes=(None, 0, 0, 0, None)
                )(zeros_p, p_prev[dp], u_star[du], self.cell_coords, prm)
                return jnp.zeros((n_p,), dtype).at[dp].add(-r2)

            def rhs3(u_star, p_new, p_prev, prm):
                du, dp = self.dofmap_u, self.dofmap_p
                r3 = jax.vmap(
                    self._r3_kernel, in_axes=(None, 0, 0, 0, 0, None)
                )(zeros_u, u_star[du], p_new[dp], p_prev[dp],
                  self.cell_coords, prm)
                return jnp.zeros((n_u, dim), dtype).at[du].add(-r3)

        def step(u_prev, p_prev, bc_u_vals, bc_p_vals, prm):
            # -- step 1: tentative velocity -------------------------------
            b1 = rhs1(u_prev, p_prev, prm)
            # the ds-term RHS only needs the boundary cells' dofs
            rb0 = jax.vmap(
                self._r1_boundary_kernel,
                in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None),
            )(zeros_u, u_prev[self._dm_u_b], p_prev[self._dm_p_b],
              *self._bargs_closure, prm)
            b1 = b1.at[self._dm_u_b].add(-rb0)
            b1f = b1.reshape(-1)

            def mv1(v):
                y = mv1_raw(v)
                return jnp.where(bc_mask_u_flat, v, y)

            if has_bc_u:
                b1f = jnp.where(
                    bc_mask_u_flat,
                    jnp.zeros((n_u, dim), dtype).at[bc_dofs_u]
                    .set(bc_u_vals).reshape(-1),
                    b1f,
                )
            us, info1 = fgmres(
                mv1, b1f, x0=u_prev.reshape(-1),
                precond=pc1, restart=30, maxiter=maxiter,
                rtol=rtol,
            )
            u_star = us.reshape(n_u, dim)

            # -- step 2: pressure Poisson --------------------------------
            b2 = rhs2(p_prev, u_star, prm)

            def mv2(v):
                y = mv2_raw(v)
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
            p_new, info2 = fgmres(
                mv2, b2, x0=p_prev, precond=precond_p,
                restart=30, maxiter=maxiter, rtol=rtol,
            )
            if pin_pressure:
                p_new = p_new - jnp.mean(p_new)

            # -- step 3: velocity correction -----------------------------
            b3 = rhs3(u_star, p_new, p_prev, prm).reshape(-1)

            uc, info3 = fgmres(
                mv3_raw, b3, x0=us, precond=lambda v: v / d3,
                restart=30, maxiter=maxiter, rtol=rtol,
            )
            u_new = uc.reshape(n_u, dim)

            iters = info1["iters"] + info2["iters"] + info3["iters"]
            ok = (
                info1["converged"] & info2["converged"] & info3["converged"]
            )
            res_u = (mv1(us) - b1f).reshape(n_u, dim)
            res_p = mv2(p_new) - b2
            return u_new, p_new, res_u, res_p, {
                "ksp_iters": iters, "converged": ok,
                "ksp_momentum": info1["iters"],
                "ksp_poisson": info2["iters"],
                "ksp_correct": info3["iters"],
            }

        # per-facet gathered operands for the boundary rhs kernel
        self._dm_u_b = dm_u[self.b_cells]
        self._dm_p_b = dm_p[self.b_cells]
        self._bargs_closure = bargs

        self._step_fn = step
        self._step = jax.jit(step)

    # ------------------------------------------------------------------
    def l2_norm_sq(self, fn):
        fn = jnp.asarray(fn)
        if fn.ndim == 1 and fn.shape[0] == self.Q.num_dofs:
            f_e = fn[self.dofmap_p]
            vals = jnp.einsum("qb,cb->cq", self.phi_p, f_e) ** 2
        else:
            f_e = fn[self.dofmap_u]
            v = jnp.einsum("qb,cbi->cqi", self.phi_u, f_e)
            vals = jnp.sum(v * v, axis=-1)
        J = jnp.einsum("cvg,qvd->cqgd", self.cell_coords, self.gdphi)
        detJ, _ = det_and_inv(J)
        return jnp.sum(vals * jnp.abs(detJ) * self.qw[None, :])

    # ------------------------------------------------------------------
    def _bc_values(self):
        for bc in self.bcu_d + self.bcp_d:
            bc.update()
        dt = self.dtype
        bc_u_vals = (
            jnp.asarray(gather_values(self.bcu_d, self._keep_u), dtype=dt)
            if self.bcu_d else jnp.zeros((0, self.mesh.gdim), dt)
        )
        bc_p_vals = (
            jnp.asarray(gather_values(self.bcp_d, self._keep_p), dtype=dt)
            if self.bcp_d else jnp.zeros((0,), dt)
        )
        return bc_u_vals, bc_p_vals

    def solveStep(self) -> None:
        bc_u_vals, bc_p_vals = self._bc_values()
        u, p, r_u, r_p, stats = self._step(
            self.u_prev, self.p_prev, bc_u_vals, bc_p_vals,
            self.base_params(),
        )
        stats = jax.device_get(stats)  # one batched host transfer
        self.last_stats = {
            k: (v.item() if hasattr(v, "item") else v)
            for k, v in stats.items()
        }
        if not bool(stats["converged"]):
            raise RuntimeError(
                f"IPCS linear solve did not converge "
                f"(total iters {self.last_stats['ksp_iters']})."
            )
        self.u_sol, self.p_sol = u, p
        self.u_residual, self.p_residual = r_u, r_p
        print(
            f"IPCS step: {self.last_stats['ksp_iters']} total linear "
            f"iterations"
        )
        self.step_count += 1
