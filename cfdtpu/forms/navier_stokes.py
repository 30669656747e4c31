"""SUPG/PSPG/LSIC-stabilized incompressible Navier-Stokes residual.

JAX equivalent of the reference's UFL weak forms
(/root/reference/src/solvers/stabilized_schur.py:67-123 for the
Crank-Nicolson base form; stabilized_schur_bdf2.py:75-110 for BDF2):
equal-order Pk-Pk velocity/pressure, SUPG + PSPG + LSIC stabilization with
the tau definitions of stabilized_schur.py:100-119. Instead of
ffcx-generated C kernels + PETSc assembly, the residual is a vmapped
per-element JAX kernel scattered with jnp scatter-add; the exact element
Jacobian blocks come from jacfwd of the element kernel (the analogue of
UFL `derivative` at :187) and the global operator is applied as gather ->
batched (nloc x nloc) matmul -> scatter, keeping the Krylov hot loop on
dense batched matmuls.

Boundary physics (weak pressure, Nitsche, backflow, resistance tractions —
the reference's `ds` terms, see forms/facet_terms.py) attach as facet-term
blocks over tagged facet subsets.

State layout: `aux` is a tuple of velocity history fields — (u_prev,) for
Crank-Nicolson, (u_prev, u_prev2) for BDF2 — so one residual/Jacobian
pipeline serves every time scheme.

Conventions: velocity u is (n_u, d); grad_u[i, j] = du_i/dx_j.
UFL's nabla_grad(u)[i, j] = du_j/dx_i is the transpose; the boundary term
dot(nabla_grad(u)*n, v) therefore reads sum_j grad_u[j, i] n_j here.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..assembly import FacetQuadrature
from ..elements import LagrangeElement, quadrature
from ..spaces import FunctionSpace
from ..utils import det_and_inv, SortedScatter
from .facet_terms import natural_correction


def _asm_chunk(nc: int) -> int:
    """Element chunk size for assembly maps, 0 = no chunking.

    A full-mesh vmap of the element kernel materializes rank-5 jvp temps
    like f32[nc, nbu, nq, d, d], whose two tiny minor dims a tiled
    memory layout may pad many-fold; at 631k cells (the ~950k-DOF DFG
    mesh) those temps dominate the Jacobian build's memory. Chunking the
    map (lax.map over chunks, vmap inside) bounds the temps by the chunk
    size. The chunk size was chosen on earlier hardware; sizing it from
    the GPU's compiled.memory_analysis() is open (ROADMAP A5). Meshes at
    or below 2 chunks keep the single-vmap HLO.
    """
    c = int(os.environ.get("CFDTPU_ASM_CHUNK", "65536"))
    if c <= 0 or nc <= 2 * c:
        return 0
    return c


def _map_in_chunks(fn, mapped_args, chunk: int):
    """lax.map(fn-over-chunks) with edge padding: `mapped_args` is a
    pytree of arrays sharing leading dim nc; fn maps a chunk pytree
    (leading dim `chunk`) to a pytree of arrays with leading dim
    `chunk`. Returns outputs with leading dim nc."""
    nc = jax.tree_util.tree_leaves(mapped_args)[0].shape[0]
    k = -(-nc // chunk)
    pad = k * chunk - nc

    def prep(a):
        if pad:
            a = jnp.concatenate([a, jnp.repeat(a[:1], pad, axis=0)])
        return a.reshape((k, chunk) + a.shape[1:])

    out = lax.map(fn, jax.tree_util.tree_map(prep, mapped_args))
    return jax.tree_util.tree_map(
        lambda o: o.reshape((k * chunk,) + o.shape[2:])[:nc], out
    )


def _eps_for(dtype) -> float:
    """Division guard matching PETSc ScalarType resolution semantics
    (reference stabilized_schur.py:100)."""
    return float(np.finfo(np.dtype(dtype)).resolution)


class StabilizedNSForm:
    """Residual of the stabilized NS equations (CN-midpoint stepping).

    params dict keys (all jnp scalars/arrays, so changing them never
    recompiles — the analogue of PETSc Constants):
        dt, rho, mu: scalars; f: body force (d,)
        plus whatever keys the attached facet terms consume
        (p_inlet, p_c, beta_nitsche, beta_backflow, ...).

    aux: tuple of velocity history arrays; (u_prev,) here.
    """

    N_AUX = 1

    def __init__(
        self,
        V: FunctionSpace,
        Q: FunctionSpace,
        quad_degree: int | None = None,
        boundary_correction: bool = True,
        stabilization: bool = True,
    ):
        # stabilization=False gives the plain Galerkin form (no
        # SUPG/PSPG/LSIC) — used where the reference uses unstabilized
        # mixed elements (solvers_aux, /root/reference/src/solvers_aux/
        # pressure.py:46-52): the strong residual of a P1 interpolant
        # drops mu lap u entirely, so SUPG/PSPG are inconsistent for
        # given-velocity least-squares problems.
        self.stabilization = bool(stabilization)
        assert V.mesh is Q.mesh
        mesh = V.mesh
        self.V, self.Q = V, Q
        self.mesh = mesh
        self.dim = mesh.dim
        dt = mesh.points.dtype
        self.dtype = dt
        self.eps = _eps_for(dt)

        qd = quad_degree if quad_degree is not None else 2 * V.degree + 1
        self.quad_degree = qd
        xi, w = quadrature(mesh.cell_type, qd)

        nderiv = 2 if V.degree > 1 else 1
        tabs_u = V.element.tabulate(xi, nderiv=nderiv)
        tabs_p = Q.element.tabulate(xi, nderiv=1)
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = geom.tabulate(xi, nderiv=1)

        j = jnp.asarray
        self.qw = j(w, dtype=dt)
        self.phi_u = j(tabs_u[0], dtype=dt)
        self.dphi_u = j(tabs_u[1], dtype=dt)
        self.d2phi_u = j(tabs_u[2], dtype=dt) if nderiv == 2 else None
        self.phi_p = j(tabs_p[0], dtype=dt)
        self.dphi_p = j(tabs_p[1], dtype=dt)
        self.gdphi = j(gdphi, dtype=dt)

        self.dofmap_u = j(V.dofmap)
        self.dofmap_p = j(Q.dofmap)
        self.cell_coords = j(mesh.points[mesh.cells], dtype=dt)
        self.cell_h = j(mesh.h(), dtype=dt)

        # flat per-element dof layout [u(b,i) row-major, then p(b)] matching
        # the solver's ravel convention (u.reshape(-1) ++ p)
        nbu, nbp = V.element.ndofs, Q.element.ndofs
        dim = self.dim
        dmf = (
            np.asarray(V.dofmap)[:, :, None] * dim
            + np.arange(dim)[None, None, :]
        ).reshape(-1, nbu * dim)
        self._dmf_np = np.concatenate(
            [dmf, V.num_dofs * dim + np.asarray(Q.dofmap)], axis=1
        ).astype(np.int32)
        self.dofmap_flat = j(self._dmf_np)
        self.nloc = nbu * dim + nbp
        self.n_flat = V.num_dofs * dim + Q.num_dofs

        # sorted-segment scatters for the hot assembly/matvec paths
        self._scatter_u = SortedScatter(np.asarray(V.dofmap), V.num_dofs)
        self._scatter_p = SortedScatter(np.asarray(Q.dofmap), Q.num_dofs)
        self._scatter_flat = SortedScatter(self._dmf_np, self.n_flat)

        self._kernel = self._make_cell_kernel()

        self._facet_blocks: list[dict] = []
        if boundary_correction and len(mesh.facets):
            self.add_facet_term(
                "natural_correction",
                np.arange(len(mesh.facets), dtype=np.int32),
                natural_correction(),
            )

    # ------------------------------------------------------------------
    # time-scheme hooks (overridden by the BDF2 variant)
    # ------------------------------------------------------------------
    def _velocity_states(self, u_e, aux_e, prm):
        """Returns (u_adv, u_visc_weight fields) for the scheme; CN uses
        the midpoint everywhere."""
        um = 0.5 * (u_e + aux_e[0])
        return um

    def _make_cell_kernel(self):
        dim = self.dim
        phi_u, dphi_u = self.phi_u, self.dphi_u
        phi_p, dphi_p = self.phi_p, self.dphi_p
        d2phi_u = self.d2phi_u
        gdphi, qw = self.gdphi, self.qw
        eps_default = self.eps
        eye = jnp.eye(dim, dtype=self.dtype)
        stab = getattr(self, "stabilization", True)

        def kernel(u_e, p_e, aux_e, coords_e, h_e, prm):
            (uprev_e,) = aux_e
            rho, mu, dt = prm["rho"], prm["mu"], prm["dt"]
            f = prm["f"]
            nu = mu / rho

            # geometry (general isoparametric-P1/Q1; affine for simplices)
            J = jnp.einsum("vg,qvd->qgd", coords_e, gdphi)
            detJ, invJ = det_and_inv(J)  # invJ (q, d, g): dxi_d/dx_g
            detJ = jnp.abs(detJ)
            wdet = qw * detJ

            gu = jnp.einsum("qbd,qdg->qbg", dphi_u, invJ)
            gp = jnp.einsum("qbd,qdg->qbg", dphi_p, invJ)

            u_q = phi_u @ u_e  # (q, i)
            up_q = phi_u @ uprev_e
            um_q = 0.5 * (u_q + up_q)
            grad_u = jnp.einsum("bi,qbg->qig", u_e, gu)
            grad_up = jnp.einsum("bi,qbg->qig", uprev_e, gu)
            grad_um = 0.5 * (grad_u + grad_up)
            p_q = phi_p @ p_e
            grad_p = jnp.einsum("b,qbg->qg", p_e, gp)

            div_um = jnp.trace(grad_um, axis1=1, axis2=2)
            conv = jnp.einsum("qig,qg->qi", grad_um, um_q)
            sig = (
                mu * (grad_um + jnp.swapaxes(grad_um, 1, 2))
                - p_q[:, None, None] * eye
            )

            # strong residual R = rho(du/dt + conv) - div sigma - rho f
            # (stabilized_schur.py:95-97); div(2 mu eps(u)) = mu(lap u +
            # grad div u) vanishes for degree-1 elements.
            R = rho * ((u_q - up_q) / dt + conv) + grad_p - rho * f
            if d2phi_u is not None:
                Hb = jnp.einsum("qbde,qdg,qeh->qbgh", d2phi_u, invJ, invJ)
                hess = jnp.einsum(
                    "bi,qbgh->qigh", 0.5 * (u_e + uprev_e), Hb
                )
                lap = jnp.einsum("qigg->qi", hess)
                graddiv = jnp.einsum("qjij->qi", hess)
                R = R - mu * (lap + graddiv)

            # tau_SUPG = (tau1^-2 + tau2^-2 + tau3^-2)^{-1/2}
            # (stabilized_schur.py:100-108); vnorm uses u_prev so tau stays
            # constant through the Newton linearization (:91-93).
            vn = jnp.sqrt(jnp.sum(up_q * up_q, axis=-1))
            eps = jnp.asarray(eps_default, wdet.dtype)
            t1 = h_e / jnp.maximum(2.0 * vn, eps)
            t2 = dt / 2.0
            t3 = (h_e * h_e) / (4.0 * nu)
            tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
            Re_h = vn * h_e / (2.0 * nu)
            z = jnp.minimum(Re_h / 3.0, 1.0)
            tau_lsic = vn * h_e * z / 2.0

            # Galerkin momentum
            mass = rho * ((u_q - up_q) / dt + conv - f)
            ru = jnp.einsum("q,qb,qi->bi", wdet, phi_u, mass)
            ru += jnp.einsum("q,qij,qbj->bi", wdet, sig, gu)
            rp = jnp.einsum("q,qb->b", wdet * div_um, phi_p)
            if stab:
                # SUPG: tau R · (u_mid·grad) v
                adv_v = jnp.einsum("qbg,qg->qb", gu, um_q)
                ru += jnp.einsum("q,qi,qb->bi", wdet * tau, R, adv_v)
                # LSIC: tau_lsic div(u_mid) rho div(v)
                ru += jnp.einsum(
                    "q,qbi->bi", wdet * tau_lsic * rho * div_um, gu
                )
                # PSPG
                rp += jnp.einsum("q,qi,qbi->b", wdet * tau / rho, R, gp)
            return ru, rp

        return kernel

    # ------------------------------------------------------------------
    # facet-term blocks
    # ------------------------------------------------------------------
    def add_facet_term(self, name: str, facet_indices, kernel) -> None:
        """Attach a boundary term over a facet subset.

        kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim);
        tabs = dict(phi_u (nq, nbu), dphi_u (nq, nbu, d), phi_p (nq, nbp),
        gdphi (nq, nvg, d), normal (nq, d), dS (nq,), h scalar).
        """
        mesh = self.mesh
        facet_indices = np.asarray(facet_indices, dtype=np.int32)
        if facet_indices.size == 0:
            return
        fq = FacetQuadrature(mesh, facet_indices, self.quad_degree)
        phi_u, dphi_u = fq.tabulate(self.V.element)
        phi_p, _ = fq.tabulate(self.Q.element)
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = fq.tabulate(geom)
        _, normal, dS = fq.geometry()

        dt = self.dtype
        j = jnp.asarray
        g = fq.group
        cells = fq.cells
        block = {
            "name": name,
            "kernel": kernel,
            "cells": j(cells),
            "dofmap_u": j(np.asarray(self.V.dofmap)[cells]),
            "dofmap_p": j(np.asarray(self.Q.dofmap)[cells]),
            "dofmap_flat": j(self._dmf_np[cells]),
            "tabs": {
                "phi_u": j(phi_u, dtype=dt)[g],
                "dphi_u": j(dphi_u, dtype=dt)[g],
                "phi_p": j(phi_p, dtype=dt)[g],
                "gdphi": j(gdphi, dtype=dt)[g],
                "normal": j(normal, dtype=dt),
                "dS": j(dS, dtype=dt),
                "h": self.cell_h[j(cells)],
            },
            "coords": self.cell_coords[j(cells)],
        }
        self._facet_blocks.append(block)

    def _block_residual(self, block, u, p, aux, prm):
        dm_u = block["dofmap_u"]
        dm_p = block["dofmap_p"]
        aux_e = tuple(a[dm_u] for a in aux)
        ru_f = jax.vmap(
            block["kernel"], in_axes=(0, 0, 0, 0, 0, None)
        )(u[dm_u], p[dm_p], aux_e, block["coords"], block["tabs"], prm)
        return dm_u, ru_f

    # ------------------------------------------------------------------
    def residual(self, u, p, aux, prm):
        """Assembled residual (r_u (n_u, d), r_p (n_p,)) — jittable."""
        kernel = jax.vmap(self._kernel, in_axes=(0, 0, 0, 0, 0, None))
        u_e = u[self.dofmap_u]
        p_e = p[self.dofmap_p]
        aux_e = tuple(a[self.dofmap_u] for a in aux)
        chunk = _asm_chunk(self.mesh.num_cells)
        if chunk:
            ru_e, rp_e = _map_in_chunks(
                lambda t: kernel(t[0], t[1], t[2], t[3], t[4], prm),
                (u_e, p_e, aux_e, self.cell_coords, self.cell_h),
                chunk,
            )
        else:
            ru_e, rp_e = kernel(
                u_e, p_e, aux_e, self.cell_coords, self.cell_h, prm
            )
        nbu = self.V.element.ndofs
        ru = self._scatter_u(ru_e.reshape(-1, self.dim))
        rp = self._scatter_p(rp_e.reshape(-1))
        for block in self._facet_blocks:
            dm_u, ru_f = self._block_residual(block, u, p, aux, prm)
            ru = ru.at[dm_u].add(ru_f)
        return ru, rp

    # ------------------------------------------------------------------
    def _flat_cell_kernel(self):
        nbu = self.V.element.ndofs
        dim = self.dim

        def fk(xe, aux_e, coords_e, h_e, prm):
            u_e = xe[: nbu * dim].reshape(nbu, dim)
            p_e = xe[nbu * dim:]
            ru, rp = self._kernel(u_e, p_e, aux_e, coords_e, h_e, prm)
            return jnp.concatenate([ru.reshape(-1), rp])

        return fk

    def _flat_facet_kernel(self, kernel):
        nbu = self.V.element.ndofs
        nbp = self.Q.element.ndofs
        dim = self.dim

        def fk(xe, aux_e, coords_e, tabs, prm):
            u_e = xe[: nbu * dim].reshape(nbu, dim)
            p_e = xe[nbu * dim:]
            ru = kernel(u_e, p_e, aux_e, coords_e, tabs, prm)
            return jnp.concatenate(
                [ru.reshape(-1), jnp.zeros((nbp,), ru.dtype)]
            )

        return fk

    def element_jacobians(self, u, p, aux, prm):
        """Exact element Jacobian blocks: (A_cells (nc, nloc, nloc),
        [(dofmap_flat, A_block) per facet term])."""
        xe = jnp.concatenate(
            [
                u[self.dofmap_u].reshape(self.mesh.num_cells, -1),
                p[self.dofmap_p],
            ],
            axis=1,
        )
        aux_e = tuple(a[self.dofmap_u] for a in aux)
        fk = self._flat_cell_kernel()
        jac = jax.vmap(jax.jacfwd(fk), in_axes=(0, 0, 0, 0, None))
        chunk = _asm_chunk(self.mesh.num_cells)
        if chunk:
            A_cells = _map_in_chunks(
                lambda t: jac(t[0], t[1], t[2], t[3], prm),
                (xe, aux_e, self.cell_coords, self.cell_h),
                chunk,
            )
        else:
            A_cells = jac(xe, aux_e, self.cell_coords, self.cell_h, prm)

        A_blocks = []
        for block in self._facet_blocks:
            dm_u = block["dofmap_u"]
            dm_p = block["dofmap_p"]
            xef = jnp.concatenate(
                [u[dm_u].reshape(len(dm_u), -1), p[dm_p]], axis=1
            )
            aux_ef = tuple(a[dm_u] for a in aux)
            ffk = self._flat_facet_kernel(block["kernel"])
            A_f = jax.vmap(
                jax.jacfwd(ffk), in_axes=(0, 0, 0, 0, None)
            )(xef, aux_ef, block["coords"], block["tabs"], prm)
            A_blocks.append((block["dofmap_flat"], A_f))
        return A_cells, A_blocks

    def apply_element_matrices(self, A_cells, A_blocks, v_flat):
        """y = A v with A given as element blocks; flat dof layout. The
        cell scatter uses the sorted segment_sum path (Krylov hot loop)."""
        ve = v_flat[self.dofmap_flat]  # (nc, nloc)
        ye = jnp.einsum("cab,cb->ca", A_cells, ve)
        y = self._scatter_flat(ye.reshape(-1))
        for dmf, A_f in A_blocks:
            vf = v_flat[dmf]
            yf = jnp.einsum("fab,fb->fa", A_f, vf)
            y = y.at[dmf].add(yf)
        return y

    @property
    def n_u_flat(self):
        return self.V.num_dofs * self.dim

    def apply_sub_block(self, A_cells, A_blocks, v, which: str):
        """Apply one of the 2x2 fieldsplit sub-blocks of the element-block
        operator: which in {"uu", "up", "pu", "pp"}. Input/output are the
        u-part (n_u*dim,) or p-part (n_p,) vectors. Used by the Schur
        preconditioner (the analogue of PETSc fieldsplit sub-matrices,
        reference stabilized_schur.py:231-267)."""
        nud = self.V.element.ndofs * self.dim
        row_u = which[0] == "u"
        col_u = which[1] == "u"
        rs = slice(0, nud) if row_u else slice(nud, self.nloc)
        cs = slice(0, nud) if col_u else slice(nud, self.nloc)
        n_u_flat = self.n_u_flat
        n_out = n_u_flat if row_u else self.Q.num_dofs

        dm_col = (
            self.dofmap_flat[:, cs]
            if col_u
            else self.dofmap_flat[:, cs] - n_u_flat
        )
        dm_row = (
            self.dofmap_flat[:, rs]
            if row_u
            else self.dofmap_flat[:, rs] - n_u_flat
        )
        ve = v[dm_col]
        ye = jnp.einsum("cab,cb->ca", A_cells[:, rs, cs], ve)
        y = jnp.zeros((n_out,), self.dtype).at[dm_row].add(ye)
        for dmf, A_f in A_blocks:
            dmf_col = dmf[:, cs] if col_u else dmf[:, cs] - n_u_flat
            dmf_row = dmf[:, rs] if row_u else dmf[:, rs] - n_u_flat
            vf = v[dmf_col]
            yf = jnp.einsum("fab,fb->fa", A_f[:, rs, cs], vf)
            y = y.at[dmf_row].add(yf)
        return y

    def jacobian_diagonal(self, A_cells, A_blocks):
        """Assembled diagonal of the element-block operator (flat layout) —
        the Jacobi PC (stand-in for the reference's ASM sub-PCs)."""
        idx = jnp.arange(self.nloc)
        d = self._scatter_flat(A_cells[:, idx, idx].reshape(-1))
        for dmf, A_f in A_blocks:
            d = d.at[dmf].add(A_f[:, idx, idx])
        return d

    # ------------------------------------------------------------------
    def pressure_matrices(self, u_prev, prm):
        """Element matrices on Q for PCD preconditioning
        (the Ap/Mp/Kp operators the reference gets from fenicsx-pctools,
        SURVEY.md 2.4): pressure Laplacian Ap, pressure mass Mp, and the
        pressure-space mirror of the momentum Jacobian
        Fp = (rho a0/dt) Mp + theta (mu Ap + rho N(u_prev)).
        Returns (Ap_e, Mp_e, Fp_e) each (nc, nbp, nbp).

        The reaction term (rho/dt) Mp is essential: without it the
        Stokes/small-dt limit of Mp^{-1} Fp Ap^{-1} loses its
        Cahouet-Chabard (rho/dt) Ap^{-1} component and the PC mismodels
        the time-dependent Schur complement (the round-2 "near-Stokes
        mismodel"). a0/theta mirror the time integrator: Crank-Nicolson
        differentiates u_mid = (u+u_prev)/2, so the convective/viscous
        Jacobian carries theta = 1/2 while the mass term is full
        (fenicsx-pctools PCDPC_vY builds Kp from the same form,
        /root/reference/src/solvers/stabilized_pcd.py:206-240)."""
        rho = prm["rho"]
        mu = prm["mu"]
        a0 = prm.get("bdf_a0", 1.0)
        theta = prm.get("pcd_theta", 0.5)
        J = jnp.einsum("cvg,qvd->cqgd", self.cell_coords, self.gdphi)
        detJ, invJ = det_and_inv(J)
        wdet = jnp.abs(detJ) * self.qw[None, :]
        gp = jnp.einsum("qbd,cqdg->cqbg", self.dphi_p, invJ)
        Ap = jnp.einsum("cq,cqag,cqbg->cab", wdet, gp, gp)
        Mp = jnp.einsum(
            "cq,qa,qb->cab", wdet, self.phi_p, self.phi_p
        )
        up_q = jnp.einsum("qb,cbi->cqi", self.phi_u,
                          u_prev[self.dofmap_u])
        conv = jnp.einsum("cq,qa,cqbg,cqg->cab", wdet, self.phi_p, gp,
                          up_q)
        Fp = (rho * a0 / prm["dt"]) * Mp + theta * (
            mu * Ap + rho * conv
        )
        return Ap, Mp, Fp

    def velocity_mass_diagonal(self):
        """Diagonal of the velocity mass matrix in the flat u layout —
        the Q scaling of the LSC commutator (Elman et al.)."""
        J = jnp.einsum("cvg,qvd->cqgd", self.cell_coords, self.gdphi)
        detJ, _ = det_and_inv(J)
        wdet = jnp.abs(detJ) * self.qw[None, :]
        md = jnp.einsum("cq,qb,qb->cb", wdet, self.phi_u, self.phi_u)
        d = jnp.zeros((self.V.num_dofs,), self.dtype).at[
            self.dofmap_u
        ].add(md)
        return jnp.repeat(d, self.dim)

    def p_mass_lumped(self):
        """Diagonal of the pressure mass matrix (n_p,) — the Mp/mu Schur
        approximation of the Stokes block-diagonal PC (Silvester-Wathen;
        the reference's p-block mass-matrix Jacobi,
        /root/reference/src/solvers_aux/stokes.py:52-75). Diagonal
        (not row-sum) lumping: Pk>=2 vertex basis functions integrate
        to zero on simplices, so row sums are singular there."""
        J = jnp.einsum("cvg,qvd->cqgd", self.cell_coords, self.gdphi)
        detJ, _ = det_and_inv(J)
        wdet = jnp.abs(detJ) * self.qw[None, :]
        md = jnp.einsum("cq,qb,qb->cb", wdet, self.phi_p, self.phi_p)
        d = jnp.zeros((self.Q.num_dofs,), self.dtype).at[
            self.dofmap_p
        ].add(md)
        return jnp.maximum(d, 1e-30)

    def apply_p_matrix(self, A_e, v):
        """Apply an element matrix on Q: y = A v."""
        ve = v[self.dofmap_p]
        ye = jnp.einsum("cab,cb->ca", A_e, ve)
        return jnp.zeros((self.Q.num_dofs,), self.dtype).at[
            self.dofmap_p
        ].add(ye)

    def p_matrix_diagonal(self, A_e):
        idx = jnp.arange(self.Q.element.ndofs)
        return jnp.zeros((self.Q.num_dofs,), self.dtype).at[
            self.dofmap_p
        ].add(A_e[:, idx, idx])

    # ------------------------------------------------------------------
    def facet_flux(self, u, name: str):
        """Q = int u·n dS over the named facet block (the resistance-BC
        flux, reference stabilized_schur_pressure_backflow.py:383-385)."""
        for block in self._facet_blocks:
            if block["name"] == name:
                u_e = u[block["dofmap_u"]]  # (nf, nbu, d)
                u_q = jnp.einsum(
                    "fqb,fbi->fqi", block["tabs"]["phi_u"], u_e
                )
                un = jnp.einsum("fqi,fqi->fq", u_q, block["tabs"]["normal"])
                return jnp.sum(un * block["tabs"]["dS"])
        raise KeyError(f"no facet block named {name!r}")

    # ------------------------------------------------------------------
    def l2_norm_sq(self, fn, num_components: int | None = None):
        """Integral of |fn|^2 over the domain (for norms.txt / error logs,
        reference /root/reference/src/scenario.py:315-323)."""
        if fn.ndim == 1:
            phi = self.phi_p if fn.shape[0] == self.Q.num_dofs else self.phi_u
            dm = (
                self.dofmap_p
                if fn.shape[0] == self.Q.num_dofs
                else self.dofmap_u
            )
            f_e = fn[dm]
            vals = jnp.einsum("qb,cb->cq", phi, f_e) ** 2
        else:
            f_e = fn[self.dofmap_u]
            v = jnp.einsum("qb,cbi->cqi", self.phi_u, f_e)
            vals = jnp.sum(v * v, axis=-1)
        J = jnp.einsum("cvg,qvd->cqgd", self.cell_coords, self.gdphi)
        detJ, _ = det_and_inv(J)
        detJ = jnp.abs(detJ)
        return jnp.sum(vals * detJ * self.qw[None, :])


class StabilizedNSFormBDF2(StabilizedNSForm):
    """BDF2 variant (reference stabilized_schur_bdf2.py:75-110): time term
    rho (a0 u + a1 u_prev + a2 u_prev2)/dt with updatable coefficients
    (BDF1 on the first step), convection/stress/continuity fully implicit
    at u_sol; tau still frozen at u_prev.

    aux = (u_prev, u_prev2); prm additionally carries bdf_a0/a1/a2.
    """

    N_AUX = 2

    def _make_cell_kernel(self):
        dim = self.dim
        phi_u, dphi_u = self.phi_u, self.dphi_u
        phi_p, dphi_p = self.phi_p, self.dphi_p
        d2phi_u = self.d2phi_u
        gdphi, qw = self.gdphi, self.qw
        eps_default = self.eps
        eye = jnp.eye(dim, dtype=self.dtype)

        def kernel(u_e, p_e, aux_e, coords_e, h_e, prm):
            uprev_e, uprev2_e = aux_e
            rho, mu, dt = prm["rho"], prm["mu"], prm["dt"]
            a0, a1, a2 = prm["bdf_a0"], prm["bdf_a1"], prm["bdf_a2"]
            f = prm["f"]
            nu = mu / rho

            J = jnp.einsum("vg,qvd->qgd", coords_e, gdphi)
            detJ, invJ = det_and_inv(J)
            detJ = jnp.abs(detJ)
            wdet = qw * detJ

            gu = jnp.einsum("qbd,qdg->qbg", dphi_u, invJ)
            gp = jnp.einsum("qbd,qdg->qbg", dphi_p, invJ)

            u_q = phi_u @ u_e
            up_q = phi_u @ uprev_e
            up2_q = phi_u @ uprev2_e
            dudt = (a0 * u_q + a1 * up_q + a2 * up2_q) / dt
            grad_u = jnp.einsum("bi,qbg->qig", u_e, gu)
            p_q = phi_p @ p_e
            grad_p = jnp.einsum("b,qbg->qg", p_e, gp)

            div_u = jnp.trace(grad_u, axis1=1, axis2=2)
            conv = jnp.einsum("qig,qg->qi", grad_u, u_q)
            sig = (
                mu * (grad_u + jnp.swapaxes(grad_u, 1, 2))
                - p_q[:, None, None] * eye
            )

            R = rho * (dudt + conv) + grad_p - rho * f
            if d2phi_u is not None:
                Hb = jnp.einsum("qbde,qdg,qeh->qbgh", d2phi_u, invJ, invJ)
                hess = jnp.einsum("bi,qbgh->qigh", u_e, Hb)
                lap = jnp.einsum("qigg->qi", hess)
                graddiv = jnp.einsum("qjij->qi", hess)
                R = R - mu * (lap + graddiv)

            vn = jnp.sqrt(jnp.sum(up_q * up_q, axis=-1))
            eps = jnp.asarray(eps_default, wdet.dtype)
            t1 = h_e / jnp.maximum(2.0 * vn, eps)
            t2 = dt / 2.0
            t3 = (h_e * h_e) / (4.0 * nu)
            tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
            Re_h = vn * h_e / (2.0 * nu)
            z = jnp.minimum(Re_h / 3.0, 1.0)
            tau_lsic = vn * h_e * z / 2.0

            mass = rho * (dudt + conv - f)
            ru = jnp.einsum("q,qb,qi->bi", wdet, phi_u, mass)
            ru += jnp.einsum("q,qij,qbj->bi", wdet, sig, gu)
            adv_v = jnp.einsum("qbg,qg->qb", gu, u_q)
            ru += jnp.einsum("q,qi,qb->bi", wdet * tau, R, adv_v)
            ru += jnp.einsum("q,qbi->bi", wdet * tau_lsic * rho * div_u, gu)

            rp = jnp.einsum("q,qb->b", wdet * div_u, phi_p)
            rp += jnp.einsum("q,qi,qbi->b", wdet * tau / rho, R, gp)
            return ru, rp

        return kernel


class StabilizedNSFormCurlCurl(StabilizedNSForm):
    """Curl-curl (rotational) formulation (reference
    stabilized_schur_pressurebc.py:90-160): viscous term
    mu curl(u_mid)·curl(v), Lamb-form skew convection
    rho (curl(u_mid) x u_mid)·v - rho/2 |u_mid|^2 div(v), pressure
    -p div(v), continuity q div(u_mid); SUPG/PSPG/LSIC with the strong
    residual R = rho(du/dt + curl(u_mid) x u_mid) + grad p - rho f
    (viscous part omitted per standard SUPG practice, :148-150).

    2D uses the scalar rotation omega = du_y/dx - du_x/dy with
    curl x w = (-omega w_y, omega w_x) (:95-110).
    """

    def _make_cell_kernel(self):
        dim = self.dim
        phi_u, dphi_u = self.phi_u, self.dphi_u
        phi_p, dphi_p = self.phi_p, self.dphi_p
        gdphi, qw = self.gdphi, self.qw
        eps_default = self.eps

        def kernel(u_e, p_e, aux_e, coords_e, h_e, prm):
            (uprev_e,) = aux_e
            rho, mu, dt = prm["rho"], prm["mu"], prm["dt"]
            f = prm["f"]
            nu = mu / rho

            J = jnp.einsum("vg,qvd->qgd", coords_e, gdphi)
            detJ, invJ = det_and_inv(J)
            detJ = jnp.abs(detJ)
            wdet = qw * detJ

            gu = jnp.einsum("qbd,qdg->qbg", dphi_u, invJ)
            gp = jnp.einsum("qbd,qdg->qbg", dphi_p, invJ)

            u_q = phi_u @ u_e
            up_q = phi_u @ uprev_e
            um_q = 0.5 * (u_q + up_q)
            grad_um = 0.5 * jnp.einsum(
                "bi,qbg->qig", u_e + uprev_e, gu
            )
            p_q = phi_p @ p_e
            grad_p = jnp.einsum("b,qbg->qg", p_e, gp)
            div_um = jnp.trace(grad_um, axis1=1, axis2=2)

            if dim == 2:
                omega = grad_um[:, 1, 0] - grad_um[:, 0, 1]  # (q,)
                cross = jnp.stack(
                    [-omega * um_q[:, 1], omega * um_q[:, 0]], axis=-1
                )
                # rot of test fn phi_b e_i: i=0 -> -dphi_b/dy, i=1 -> +dphi_b/dx
                rot_v = jnp.stack([-gu[:, :, 1], gu[:, :, 0]], axis=-1)
                visc = jnp.einsum(
                    "q,qbi->bi", wdet * mu * omega, rot_v
                )
            else:
                curl_um = jnp.stack(
                    [
                        grad_um[:, 2, 1] - grad_um[:, 1, 2],
                        grad_um[:, 0, 2] - grad_um[:, 2, 0],
                        grad_um[:, 1, 0] - grad_um[:, 0, 1],
                    ],
                    axis=-1,
                )  # (q, 3)
                cross = jnp.cross(curl_um, um_q)
                # curl(phi_b e_i) = grad(phi_b) x e_i -> (q, b, i, 3)
                eye3 = jnp.eye(3, dtype=wdet.dtype)
                curl_v = jnp.cross(
                    gu[:, :, None, :], eye3[None, None, :, :]
                )
                visc = jnp.einsum(
                    "q,qk,qbik->bi", wdet * mu, curl_um, curl_v
                )

            umag2 = jnp.sum(um_q * um_q, axis=-1)

            R = rho * ((u_q - up_q) / dt + cross) + grad_p - rho * f

            vn = jnp.sqrt(jnp.sum(up_q * up_q, axis=-1))
            eps = jnp.asarray(eps_default, wdet.dtype)
            t1 = h_e / jnp.maximum(2.0 * vn, eps)
            t2 = dt / 2.0
            t3 = (h_e * h_e) / (4.0 * nu)
            tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
            Re_h = vn * h_e / (2.0 * nu)
            z = jnp.minimum(Re_h / 3.0, 1.0)
            tau_lsic = vn * h_e * z / 2.0

            mass = rho * ((u_q - up_q) / dt + cross - f)
            ru = jnp.einsum("q,qb,qi->bi", wdet, phi_u, mass)
            ru += visc
            # -(p + rho/2 |u_mid|^2) div(v)
            ru += jnp.einsum(
                "q,qbi->bi", -wdet * (p_q + 0.5 * rho * umag2), gu
            )
            adv_v = jnp.einsum("qbg,qg->qb", gu, um_q)
            ru += jnp.einsum("q,qi,qb->bi", wdet * tau, R, adv_v)
            ru += jnp.einsum("q,qbi->bi", wdet * tau_lsic * rho * div_um, gu)

            rp = jnp.einsum("q,qb->b", wdet * div_um, phi_p)
            rp += jnp.einsum("q,qi,qbi->b", wdet * tau / rho, R, gp)
            return ru, rp

        return kernel
