"""SUPG/PSPG/LSIC-stabilized Newton-Krylov solver (Crank-Nicolson midpoint).

JAX rebuild of the reference stabilized_schur solver
(/root/reference/src/solvers/stabilized_schur.py): equal-order Pk-Pk
spaces (:55-58), the stabilized weak form (:67-123), Newton with line
search (:202-214, SNES newtonls) and FGMRES (:226-229). Where the reference
assembles block matrices for a PETSc fieldsplit-Schur preconditioner
(:231-267), this solver applies exact element-Jacobian blocks as
gather -> batched matmul -> scatter and preconditions with the assembled
Jacobian diagonal (Schur-complement preconditioning builds on the same
blocks). The constant-pressure nullspace (:283-293) is handled by
mean-projection of the pressure block.

The whole time step — Newton loop, Krylov iterations, line search, BC
application — is one jitted function; time-varying BC values and physical
constants (including fixed-point boundary pressures) are traced inputs, so
nothing recompiles across steps.

Variant hooks for subclasses:
    _make_form()            — time scheme / boundary-correction choice
    _setup_boundary_terms() — attach tagged facet terms (weak pressure,
                              Nitsche, backflow, resistance, ...)
    _aux()                  — velocity history tuple
    extra_params()          — solver-specific prm entries
    _post_step()            — fixed-point updates (resistance pressure)
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..forms import StabilizedNSForm
from ..la import NewtonParams, newton_solve
from ..mesh import Mesh
from ..spaces.dirichlet import combine_bcs, gather_values
from .base import SolverBase


class Solver(SolverBase):
    MAX_ITER = 20
    BOUNDARY_CORRECTION = True
    # Subclasses whose _build_step bypasses the node-BSR halo machinery
    # (e.g. stabilized_staggered's form-API segregated loop) set this
    # False so n_shards routes them to the cell-sharded ShardedNSForm.
    HALO_DISTRIBUTION = True

    def __init__(
        self,
        mesh: Mesh,
        dt: float,
        rho: float,
        mu: float,
        f,
        initial_velocity: Callable | None = None,
        p_grade: int = 1,
        snes_rtol: float | None = None,
        snes_atol: float | None = None,
        snes_stol: float | None = None,
        snes_max_it: int = 100,
        ksp_rtol: float | None = None,
        ksp_restart: int = 60,
        ksp_ortho_chunk: int = 0,
        ksp_max_it: int = 1000,
        quad_degree: int | None = None,
        n_shards: int | None = None,
        pc_type: str = "schur",
        pc_inner_u: int = 6,
        pc_inner_p: int | None = None,
        pc_schur_fact: str = "full",
        pc_inner_method: str = "amg_p",
        operator_format: str = "node_bsr",
        snes_ksp_ew: bool = False,
        snes_lag_preconditioner: bool = True,
        snes_lag_jacobian: bool = False,
        predictor: str = "previous",
        pc_dtype: str = "same",
        pc_amg_pairwise: bool = False,
        pc_amg_smooth: int = 1,
        pc_amg_kcycle: bool = False,
        pc_amg_wcycle: bool = False,
        pc_amg_cheby: int = 0,
        pc_ras_size: int = 16,
        pc_ras_overlap: int = 4,
        pc_lag_steps: int = 1,
        stats_every: int = 1,
        supernode_g: int = 4,
        jit_const_args: bool | None = None,
        **kwargs,
    ):
        # jit_const_args: pass the static index maps to the jitted step
        # as arguments instead of closure constants, which beyond ~400k
        # DOF embed hundreds of MB in the compiled program
        # (utils/constargs.py). Default ON; CFDTPU_CONST_ARGS=0
        # disables it.
        import os as _os

        env = _os.environ.get("CFDTPU_CONST_ARGS")
        if jit_const_args is None:
            jit_const_args = env != "0"
        self.jit_const_args = bool(jit_const_args) or env == "1"
        self.pc_ras_size = int(pc_ras_size)
        self.pc_ras_overlap = int(pc_ras_overlap)
        # pc_lag_steps > 1: rebuild the operator + PC numeric state every
        # K time steps and REUSE it in between (the cross-step analogue
        # of PETSc -snes_lag_preconditioner_persists). The residual stays
        # exact — Newton still converges to snes_rtol on fresh physics —
        # only the Jacobian action / PC go K-1 steps stale, which the
        # line search + flexible GMRES absorb in a transient. Skips the
        # per-step element-Jacobian sweep, supernode assembly, SELFP
        # product and AMG/RAS builds on the reuse steps (~20% of the
        # 106k-DOF step, PERF.md round-3 profile).
        self.pc_lag_steps = int(pc_lag_steps)
        self._op_state = None
        # stats_every > 1: fetch the step's stat scalars (and check
        # convergence) only every N-th step. Between checks the host
        # never blocks on the device, so consecutive jitted steps
        # PIPELINE on the async dispatch queue. Divergence still
        # raises, at most N-1 steps late.
        self.stats_every = max(1, int(stats_every))
        # node-BSR supernode width: g Hilbert-consecutive nodes per
        # gathered row — wider rows mean fewer, longer gathers at the
        # price of more zero fill (g=8 halves the gather count for
        # ~1.8x the value bytes)
        self.supernode_g = int(supernode_g)
        self.pc_amg_pairwise = bool(pc_amg_pairwise)
        self.pc_amg_smooth = int(pc_amg_smooth)
        # K-cycle (Notay): GCR(2)-accelerated coarse corrections in both
        # AMG hierarchies — restores h-independence of plain aggregation
        # at ~1.4x cycle cost. Applied only at flexible call sites
        # (la/schur.py forces plain-V inside the *_sup linear S op).
        self.pc_amg_kcycle = bool(pc_amg_kcycle)
        # W-cycle (gamma = 2): compounds the coarse correction with two
        # recursive visits per level. LINEAR, unlike the K-cycle, so it
        # also strengthens the V-cycles inside the *_sup S operator and
        # under gmres_fixed — the call sites where kcycle is forced off.
        self.pc_amg_wcycle = bool(pc_amg_wcycle)
        # Degree-k Chebyshev polynomial smoothing inside the AMG cycles
        # (0 = l1-Jacobi). LINEAR (safe inside the *_sup S operator);
        # per-level lambda_max power-iterated at PC build, amortized by
        # pc_lag_steps.
        self.pc_amg_cheby = int(pc_amg_cheby)
        # "bf16": half the PC matrix traffic at +35% outer iterations
        # (iteration count on DFG 10k DOF). Worth revisiting only for
        # large, bandwidth-bound meshes; "same" (full precision) is the
        # default.
        self.pc_dtype = pc_dtype
        # "extrapolate" warm-starts Newton from 2 u_prev - u_older; under
        # the relative snes_rtol it does not reduce iteration counts in
        # transients (measured: same 3 Newton, slightly more KSP on DFG
        # startup) so "previous" stays the default
        self.predictor = predictor
        self.pc_type = pc_type
        self.pc_inner_u = int(pc_inner_u)
        # S-sweep length: the AMG-preconditioned sweeps need far fewer
        # iterations than the Jacobi ones (measured 10 vs 30 optimal)
        self.pc_inner_p = None if pc_inner_p is None else int(pc_inner_p)
        self.pc_schur_fact = pc_schur_fact
        self.pc_inner_method = pc_inner_method
        self.operator_format = operator_format
        self._pcd_bc_mask = None  # set by PCD solvers (outlet p dofs)
        super().__init__(mesh, dt, rho, mu, f, initial_velocity)
        from ..utils.dtypes import default_tolerances

        tols = default_tolerances(self.dtype)
        snes_rtol = tols["snes_rtol"] if snes_rtol is None else snes_rtol
        snes_atol = tols["snes_atol"] if snes_atol is None else snes_atol
        snes_stol = tols["snes_stol"] if snes_stol is None else snes_stol
        ksp_rtol = tols["ksp_rtol"] if ksp_rtol is None else ksp_rtol

        self.initVelocitySpace(int(p_grade))
        self.initPressureSpace(int(p_grade))

        if initial_velocity is not None:
            self.u_prev = jnp.asarray(self.V.interpolate(initial_velocity))

        self.quad_degree = quad_degree
        self.form = self._make_form(quad_degree)
        self.n_shards = n_shards
        self.newton_params = NewtonParams(
            max_it=int(snes_max_it),
            rtol=float(snes_rtol),
            atol=float(snes_atol),
            stol=float(snes_stol),
            ksp_rtol=float(ksp_rtol),
            ksp_restart=int(ksp_restart),
            ksp_ortho_chunk=int(ksp_ortho_chunk),
            ksp_maxiter=int(ksp_max_it),
            ew=bool(snes_ksp_ew),
            pc_lag=bool(snes_lag_preconditioner),
            jac_lag=bool(snes_lag_jacobian),
        )
        self.last_stats: dict = {}
        self.step_count = 0

    # -- variant hooks --------------------------------------------------
    def _make_form(self, quad_degree):
        return StabilizedNSForm(
            self.V, self.Q, quad_degree=quad_degree,
            boundary_correction=self.BOUNDARY_CORRECTION,
        )

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        pass

    def _aux(self) -> tuple:
        return (self.u_prev,)

    def extra_params(self) -> dict:
        return {}

    def _post_step(self) -> None:
        pass

    def params(self) -> dict:
        prm = self.base_params()
        prm.update(self.extra_params())
        return prm

    # ------------------------------------------------------------------
    def setup(self, bcu, bcp, facet_tags=None, tags=None) -> None:
        self._setup_boundary_terms(facet_tags, tags)
        # Distribution: the stabilized node-BSR family uses the
        # dof-partitioned halo design (dist/halo.py — supernode rows
        # sharded, FORWARD ghost exchange via boundary-pack all_gather,
        # per-shard additive-Schwarz Schur PC). Non-BSR configurations
        # (PCD, non-equal-order) fall back to the cell-sharded
        # dof-replicated psum form.
        self._use_halo = False
        if self.n_shards:
            halo_able = (
                type(self).HALO_DISTRIBUTION
                and self.operator_format == "node_bsr"
                and self.pc_type == "schur"
                and np.array_equal(
                    np.asarray(self.V.dofmap), np.asarray(self.Q.dofmap)
                )
            )
            if halo_able:
                self._use_halo = True
            else:
                from ..dist import ShardedNSForm, make_device_mesh

                self.form = ShardedNSForm(
                    self.form, make_device_mesh(int(self.n_shards))
                )

        self.bcu_d = [bc.getBC(self.V) for bc in bcu]
        self.bcp_d = [bc.getBC(self.Q) for bc in bcp]
        self.bc_dofs_u, self._keep_u = combine_bcs(self.bcu_d, self.mesh.gdim)
        self.bc_dofs_p, self._keep_p = combine_bcs(self.bcp_d, 1)

        # The constant-pressure nullspace is tested NUMERICALLY on the
        # initial-state Jacobian, exactly like the reference's
        # nullsp.test(A) (stabilized_schur.py:313-316). A static
        # boundary-coverage heuristic is not enough: the do-nothing
        # correction term +p n·v on ds restores the pure-gradient
        # pressure coupling, so the constant mode survives even with
        # free-outflow boundaries (measured: singular J, sigma_min
        # ~1e-17, Newton stalls at fnorm ~1e-2 on the channel fixture).
        self.pin_pressure = (
            len(self.bc_dofs_p) == 0 and self._test_pressure_nullspace()
        )

        self._build_step()

    def _test_pressure_nullspace(self) -> bool:
        """True if J e_p ~ 0 for the constant-pressure vector e_p, with
        Dirichlet-velocity rows masked (they are identity rows in the
        solve and see no pressure)."""
        form = self.form
        n_u, n_p = self.V.num_dofs, self.Q.num_dofs
        dim = self.mesh.gdim
        try:
            A_cells, A_blocks = form.element_jacobians(
                self.u_prev, self.p_prev, self._aux(), self.params()
            )
            e = jnp.concatenate([
                jnp.zeros((n_u * dim,), self.dtype),
                jnp.full((n_p,), 1.0, self.dtype),
            ])
            y = form.apply_element_matrices(A_cells, A_blocks, e)
            mask = np.zeros(n_u * dim + n_p, dtype=bool)
            for d0 in range(dim):
                mask[self.bc_dofs_u.astype(np.int64) * dim + d0] = True
            y = jnp.where(jnp.asarray(mask), 0.0, y)
            # scale: the operator's response to a unit random vector
            rng = np.random.default_rng(0)
            v = jnp.asarray(
                rng.standard_normal(n_u * dim + n_p), self.dtype
            )
            v = v / jnp.linalg.norm(v)
            yv = form.apply_element_matrices(A_cells, A_blocks, v)
            scale = jnp.linalg.norm(yv)
            rel = float(
                jnp.linalg.norm(y) / jnp.sqrt(n_p)
                / jnp.maximum(scale, 1e-30)
            )
        except Exception:
            return False  # non-monolithic forms: no pinning
        tol = 1e-6 if self.dtype == np.float64 else 1e-3
        return rel < tol

    # ------------------------------------------------------------------
    def _build_step(self) -> None:
        form = self.form
        n_u = self.V.num_dofs
        n_p = self.Q.num_dofs
        dim = self.mesh.gdim
        bc_dofs_u = jnp.asarray(self.bc_dofs_u)
        bc_dofs_p = jnp.asarray(self.bc_dofs_p)
        has_bc_u = len(self.bc_dofs_u) > 0
        has_bc_p = len(self.bc_dofs_p) > 0
        pin_pressure = self.pin_pressure
        newton_params = self.newton_params

        def ravel(u, p):
            return jnp.concatenate([u.reshape(-1), p])

        def unravel(x):
            return x[: n_u * dim].reshape(n_u, dim), x[n_u * dim:]

        self._ravel, self._unravel = ravel, unravel

        # flat-layout BC mask: True at constrained rows
        bc_mask_np = np.zeros(n_u * dim + n_p, dtype=bool)
        for d0 in range(dim):
            bc_mask_np[self.bc_dofs_u.astype(np.int64) * dim + d0] = True
        bc_mask_np[n_u * dim + self.bc_dofs_p.astype(np.int64)] = True
        bc_mask = jnp.asarray(bc_mask_np)
        bc_mask_u = jnp.asarray(bc_mask_np[: n_u * dim])
        bc_mask_p = (
            jnp.asarray(bc_mask_np[n_u * dim:]) if has_bc_p else None
        )
        pc_type = self.pc_type
        pc_inner_u = self.pc_inner_u

        # assembled node-BSR operator: less HBM traffic per matvec and
        # per PC sub-block apply than element blocks (la/nodebsr.py);
        # element path remains for sharded forms and non-equal-order
        # variants
        nodebsr = None
        if (
            self.operator_format == "node_bsr"
            and (self.n_shards is None or self._use_halo)
            and pc_type in ("schur", "jacobi", "asm", "lsc", "pcd")
        ):
            from ..la.nodebsr import NodeBSR

            try:
                nodebsr = NodeBSR(form, supernode_g=self.supernode_g)
            except ValueError:
                nodebsr = None  # non-equal-order spaces: element path
            amg_methods = (
                "amg_p", "amg_up", "ras_up", "rasamg_up", "amg_sup",
                "rasamg_sup",
            )
            need_sp = pc_type == "lsc" or (
                pc_type == "schur"
                and self.pc_inner_method in amg_methods
            )
            if nodebsr is not None and need_sp:
                # static SELFP/BBt sparsity + MG hierarchy must be built
                # eagerly (numpy) — inside jit they would trace (and
                # under const-args the swapped attributes are tracers,
                # so any np.asarray on them raises)
                nodebsr.sp_structure()
                nodebsr.sp_amg(pairwise=self.pc_amg_pairwise,
                               n_smooth=self.pc_amg_smooth,
                               kcycle=self.pc_amg_kcycle,
                               cheby=self.pc_amg_cheby,
                               wcycle=self.pc_amg_wcycle)
                if self.pc_inner_method in ("amg_up", "amg_sup"):
                    nodebsr.uu_amg(kcycle=self.pc_amg_kcycle,
                                   cheby=self.pc_amg_cheby,
                                   wcycle=self.pc_amg_wcycle)
                elif self.pc_inner_method == "ras_up":
                    nodebsr.uu_ras(self.pc_ras_size, self.pc_ras_overlap)
                elif self.pc_inner_method in ("rasamg_up", "rasamg_sup"):
                    ras = nodebsr.uu_ras(
                        self.pc_ras_size, self.pc_ras_overlap
                    )
                    nodebsr.uu_amg(fine_smoother=ras,
                                   kcycle=self.pc_amg_kcycle,
                                   cheby=self.pc_amg_cheby,
                                   wcycle=self.pc_amg_wcycle)
            if nodebsr is not None and pc_type == "pcd":
                # eager static maps for the PCD Ap assembly + AMG
                nodebsr.p_scatter_structure()
                nodebsr.pp_amg()
                if self.pc_inner_method in (
                    "amg_up", "amg_sup", "rasamg_up", "rasamg_sup"
                ):
                    ras = (
                        nodebsr.uu_ras(self.pc_ras_size,
                                       self.pc_ras_overlap)
                        if self.pc_inner_method.startswith("rasamg")
                        else None
                    )
                    nodebsr.uu_amg(fine_smoother=ras)
        self._nodebsr = nodebsr
        amg_active = nodebsr is not None and (
            self.pc_inner_method in (
                "amg_p", "amg_up", "ras_up", "rasamg_up", "amg_sup",
                "rasamg_sup",
            )
            or pc_type in ("lsc", "pcd")
        )
        pc_bf16 = (
            self.pc_dtype == "bf16"
            or (self.pc_dtype == "auto" and self.dtype == np.float32)
        )
        pc_inner_p = (
            self.pc_inner_p
            if self.pc_inner_p is not None
            else (10 if amg_active else 30)
        )

        def step(u_guess, p_guess, aux, bc_u_vals, bc_p_vals, prm):
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

            def make_operator(x):
                u, p = unravel(x)
                A_cells, A_blocks = form.element_jacobians(u, p, aux, prm)
                if nodebsr is not None:
                    # assemble once per Newton iteration; the Krylov loop
                    # then streams the deduplicated block values
                    ops = nodebsr
                    A_cells = nodebsr.assemble(A_cells, A_blocks)
                    A_blocks = ()
                    # bf16 block values in the PC path only (half the
                    # inner-sweep matrix traffic; f32 accumulation)
                    A_pc = (
                        nodebsr.pc_cast(A_cells)
                        if pc_bf16 else A_cells
                    )
                else:
                    ops = form
                    A_pc = A_cells

                def matvec(v):
                    y = ops.apply_element_matrices(A_cells, A_blocks, v)
                    y = jnp.where(bc_mask, v, y)
                    if pin_pressure:
                        du, dp = unravel(y)
                        y = ravel(du, dp - jnp.mean(dp))
                    return y

                if pc_type == "schur":
                    from ..la.schur import make_schur_precond

                    precond = make_schur_precond(
                        ops, A_pc, A_blocks, bc_mask_u,
                        pin_pressure and not has_bc_p,
                        m_u=pc_inner_u, m_p=pc_inner_p,
                        bc_mask_p=bc_mask_p,
                        full=self.pc_schur_fact == "full",
                        inner_method=self.pc_inner_method,
                        ras_opts=(self.pc_ras_size, self.pc_ras_overlap),
                    )
                    return matvec, precond
                if pc_type == "asm" and nodebsr is not None:
                    from ..la.asm import make_asm_precond

                    precond = make_asm_precond(
                        nodebsr, A_pc, bc_mask_np,
                        n_sub=getattr(self, "asm_subdomains", 8),
                        m_u=pc_inner_u, m_p=pc_inner_p,
                    )
                    return matvec, precond
                if pc_type == "lsc":
                    from ..la.lsc import make_lsc_precond

                    precond = make_lsc_precond(
                        ops, A_pc, A_blocks, bc_mask_u,
                        pin_pressure and not has_bc_p,
                        m_u=pc_inner_u, m_p=pc_inner_p,
                        bc_mask_p=bc_mask_p,
                        inner_method=self.pc_inner_method,
                        ras_opts=(self.pc_ras_size, self.pc_ras_overlap),
                        mass_diag=form.velocity_mass_diagonal(),
                    )
                    return matvec, precond
                if pc_type == "pcd":
                    from ..la.pcd import make_pcd_precond

                    Ap_e, Mp_e, Fp_e = form.pressure_matrices(aux[0], prm)
                    pcd_mask = bc_mask_p
                    if self._pcd_bc_mask is not None:
                        pcd_mask = (
                            self._pcd_bc_mask
                            if pcd_mask is None
                            else (pcd_mask | self._pcd_bc_mask)
                        )
                    precond = make_pcd_precond(
                        ops, A_pc, A_blocks, Ap_e, Mp_e, Fp_e,
                        bc_mask_u, pin_pressure and not has_bc_p,
                        m_u=pc_inner_u, m_p=pc_inner_p,
                        bc_mask_p=pcd_mask,
                        p_form=form,
                        inner_method=self.pc_inner_method,
                        ras_opts=(self.pc_ras_size, self.pc_ras_overlap),
                    )
                    return matvec, precond

                d = ops.jacobian_diagonal(A_cells, A_blocks)
                d = jnp.where(bc_mask, 1.0, d)
                scale = jnp.max(jnp.abs(d))
                floor = 1e-12 * scale
                d = jnp.where(
                    jnp.abs(d) < floor, jnp.where(d < 0, -floor, floor), d
                )
                return matvec, (lambda v: v / d)

            def project(dx):
                du, dp = unravel(dx)
                return ravel(du, dp - jnp.mean(dp))

            x0 = ravel(u_guess, p_guess)
            if pin_pressure:
                x0 = project(x0)
            x, stats = newton_solve(
                F, x0, newton_params,
                make_operator=make_operator,
                project=project if pin_pressure else None,
            )
            u, p = unravel(x)
            r_u, r_p = unravel(stats.pop("final_residual"))
            return u, p, r_u, r_p, stats

        # -- cross-step operator/PC reuse (pc_lag_steps > 1) -----------
        # Split the step into build_op_state (element Jacobians +
        # supernode assembly + PC numeric state, every K-th step) and
        # step_reuse (Newton over a fresh residual with the carried
        # operator state). Schur/node-BSR path only.
        self._reuse_step = None
        self._op_state = None
        reuse_able = (
            nodebsr is not None
            and pc_type == "schur"
            and not getattr(self, "_use_halo", False)
            and self.pc_lag_steps > 1
        )
        if reuse_able:
            import dataclasses

            from ..la.schur import (
                build_schur_state, make_schur_precond_from_state,
            )

            pc_kw = dict(
                m_u=pc_inner_u, m_p=pc_inner_p,
                full=self.pc_schur_fact == "full",
                bc_mask_p=bc_mask_p,
                inner_method=self.pc_inner_method,
                ras_opts=(self.pc_ras_size, self.pc_ras_overlap),
            )
            reuse_params = dataclasses.replace(
                newton_params, jac_lag=True
            )

            def build_op_state(u, p, aux, prm):
                A_cells, A_blocks = form.element_jacobians(
                    u, p, aux, prm
                )
                vals = nodebsr.assemble(A_cells, A_blocks)
                A_pc = nodebsr.pc_cast(vals) if pc_bf16 else vals
                pc_state = build_schur_state(
                    nodebsr, A_pc, (), bc_mask_u,
                    pin_pressure and not has_bc_p, **pc_kw,
                )
                return {"vals": vals, "pc": pc_state}

            def step_reuse(u_guess, p_guess, aux, bc_u_vals,
                           bc_p_vals, prm, op_state):
                def F(x):
                    u, p = unravel(x)
                    ru, rp = form.residual(u, p, aux, prm)
                    if has_bc_u:
                        ru = ru.at[bc_dofs_u].set(
                            u[bc_dofs_u] - bc_u_vals
                        )
                    if has_bc_p:
                        rp = rp.at[bc_dofs_p].set(
                            p[bc_dofs_p] - bc_p_vals
                        )
                    if pin_pressure:
                        rp = rp - jnp.mean(rp)
                    return ravel(ru, rp)

                vals = op_state["vals"]

                def matvec(v):
                    y = nodebsr.apply_element_matrices(vals, (), v)
                    y = jnp.where(bc_mask, v, y)
                    if pin_pressure:
                        du, dp = unravel(y)
                        y = ravel(du, dp - jnp.mean(dp))
                    return y

                precond = make_schur_precond_from_state(
                    nodebsr, op_state["pc"], bc_mask_u,
                    pin_pressure and not has_bc_p, **pc_kw,
                )

                def make_operator(x):
                    return matvec, precond

                def project(dx):
                    du, dp = unravel(dx)
                    return ravel(du, dp - jnp.mean(dp))

                x0 = ravel(u_guess, p_guess)
                if pin_pressure:
                    x0 = project(x0)
                x, stats = newton_solve(
                    F, x0, reuse_params,
                    make_operator=make_operator,
                    project=project if pin_pressure else None,
                )
                u, p = unravel(x)
                r_u, r_p = unravel(stats.pop("final_residual"))
                return u, p, r_u, r_p, stats

            if self.jit_const_args:
                from ..utils.constargs import make_const_wrapped

                wrapped_b, consts_b = make_const_wrapped(
                    build_op_state, [form, nodebsr]
                )
                wrapped_r, consts_r = make_const_wrapped(
                    step_reuse, [form, nodebsr]
                )
                self._reuse_consts = consts_b
                jit_b = jax.jit(wrapped_b)
                jit_r = jax.jit(wrapped_r)

                def build_with_consts(*args):
                    return jit_b(*args, self._reuse_consts)

                def reuse_with_consts(*args):
                    return jit_r(*args, self._reuse_consts)

                self._build_op_state = build_with_consts
                self._reuse_step = reuse_with_consts
            else:
                self._build_op_state = jax.jit(build_op_state)
                self._reuse_step = jax.jit(step_reuse)

        self._step_fn = step  # unjitted, for driver compile checks
        if getattr(self, "_use_halo", False):
            from ..dist.halo import build_halo_step

            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..dist import make_device_mesh

            halo_step = build_halo_step(self)
            self._step_fn = halo_step
            jit_halo = jax.jit(halo_step)
            replicated = NamedSharding(
                make_device_mesh(int(self.n_shards), "shards"), P()
            )

            def halo_step_replicated(*args):
                # the step returns arrays replicated over the shards;
                # placing every input so too keeps the second step from
                # compiling the program again for new input shardings
                return jit_halo(*jax.device_put(args, replicated))

            self._step = halo_step_replicated
        elif self.jit_const_args and nodebsr is not None:
            from ..utils.constargs import make_const_wrapped

            wrapped, consts = make_const_wrapped(
                step, [form, nodebsr]
            )
            self._jit_consts = consts
            jit_step = jax.jit(wrapped)

            def step_with_consts(*args):
                return jit_step(*args, self._jit_consts)

            self._step = step_with_consts
        else:
            self._step = jax.jit(step)

    # ------------------------------------------------------------------
    def _bc_values(self):
        for bc in self.bcu_d:
            bc.update()
        for bc in self.bcp_d:
            bc.update()
        dt = self.dtype
        if self.bcu_d:
            bc_u_vals = jnp.asarray(
                gather_values(self.bcu_d, self._keep_u), dtype=dt
            )
        else:
            bc_u_vals = jnp.zeros((0, self.mesh.gdim), dt)
        if self.bcp_d:
            bc_p_vals = jnp.asarray(
                gather_values(self.bcp_d, self._keep_p), dtype=dt
            )
        else:
            bc_p_vals = jnp.zeros((0,), dt)
        return bc_u_vals, bc_p_vals

    def _run_step(self, bc_u_vals, bc_p_vals):
        # Newton warm start: second-order extrapolation from the two
        # previous solutions (the Dirichlet rows of the residual pin the
        # BC values regardless of the guess). Falls back to u_prev on
        # the first step. PETSc analogue: SNES initial guess from the
        # previous step, which the reference uses implicitly; the
        # extrapolated predictor typically saves one Newton iteration.
        u_old = getattr(self, "_u_extrap_old", None)
        if self.predictor == "extrapolate" and u_old is not None and (
            u_old.shape == self.u_prev.shape
        ):
            u_guess = 2.0 * self.u_prev - u_old
            p_guess = 2.0 * self.p_prev - self._p_extrap_old
        else:
            u_guess, p_guess = self.u_prev, self.p_prev
        self._u_extrap_old = self.u_prev
        self._p_extrap_old = self.p_prev
        prm = self.params()
        # getattr: variant solvers that override _build_step (e.g. the
        # staggered scheme) never define the reuse machinery
        if getattr(self, "_reuse_step", None) is not None:
            # rebuild the carried operator/PC state every pc_lag_steps
            # steps — and whenever dt changed (adaptive solvers: the
            # mass/dt Jacobian scaling would otherwise be wrong)
            dt_now = prm.get("dt")
            self._op_state_fresh = False
            if (
                self._op_state is None
                or self.step_count % self.pc_lag_steps == 0
                or getattr(self, "_op_state_dt", None) != dt_now
                or getattr(self, "_rebuild_hint", False)
            ):
                self._rebuild_hint = False
                self._op_state = self._build_op_state(
                    u_guess, p_guess, self._aux(), prm
                )
                self._op_state_dt = dt_now
                self._op_state_fresh = True
            return self._reuse_step(
                u_guess, p_guess, self._aux(), bc_u_vals, bc_p_vals,
                prm, self._op_state,
            )
        return self._step(
            u_guess, p_guess, self._aux(), bc_u_vals, bc_p_vals, prm,
        )

    def _note_newton_iters(self, iters: int) -> None:
        # Convergence-aware PC lag: track Newton iteration counts on
        # checked steps and request an early operator/PC rebuild when
        # the count spikes above 2x the rolling median (min +2 so tiny
        # medians like 1 don't trip on 1->3 noise). A spike means the
        # carried K-stale Jacobian/PC has drifted too far from the
        # current state (typical on steady marches, where the chord
        # Newton otherwise stalls — PERF.md round-3: "100 its, rtol
        # never hit"), so rebuilding NOW is cheaper than waiting for
        # the fixed pc_lag_steps period or the self-heal retry.
        if getattr(self, "_reuse_step", None) is None:
            return
        hist = getattr(self, "_newton_hist", None)
        if hist is None:
            hist = self._newton_hist = []
        if len(hist) >= 3:
            med = sorted(hist)[len(hist) // 2]
            if iters > max(2 * med, med + 2):
                self._rebuild_hint = True
                # don't let the spike poison the median window
                hist.clear()
                return
        hist.append(iters)
        if len(hist) > 8:
            hist.pop(0)

    def solveStep(self) -> None:
        bc_u_vals, bc_p_vals = self._bc_values()
        u, p, r_u, r_p, stats = self._run_step(bc_u_vals, bc_p_vals)
        if (self.step_count + 1) % self.stats_every == 0:
            # one batched device->host transfer for all stat scalars;
            # between fetches the host never blocks, so steps pipeline
            # on the dispatch queue
            win_conv = getattr(self, "_win_converged", None)
            self._win_converged = None
            stats = jax.device_get(stats)
            converged = bool(stats["converged"])
            if not converged and not getattr(
                self, "_op_state_fresh", True
            ):
                # self-healing reuse: the K-stale operator/PC was too
                # stale for this step (large state motion — e.g. a
                # steady march). Rebuild at the current guess and retry
                # once; only a fresh-state failure is a real divergence.
                self._op_state = None
                u, p, r_u, r_p, stats = self._run_step(
                    bc_u_vals, bc_p_vals
                )
                stats = jax.device_get(stats)
                converged = bool(stats["converged"])
            self.last_stats = {
                k: (v.item() if hasattr(v, "item") else v)
                for k, v in stats.items()
            }
            # AND-reduction of the skipped steps' converged flags
            # (accumulated on device, fetched only now): an unconverged
            # step inside the window committed a bad state to
            # u_prev/p_prev, and the next checked step can re-converge
            # from it — without this check the failure would be silently
            # absorbed into the trajectory.
            if win_conv is not None and not bool(
                jax.device_get(win_conv)
            ):
                raise RuntimeError(
                    "An unfetched step inside the last stats_every="
                    f"{self.stats_every} window did not converge "
                    "(detected at the window fetch; rerun with "
                    "stats_every=1 to locate the step)."
                )
            if not converged:
                raise RuntimeError(
                    f"Did not converge, reason: newton_iters="
                    f"{self.last_stats['newton_iters']}, "
                    f"fnorm={self.last_stats['fnorm']:.3e} "
                    f"(f0norm={self.last_stats['f0norm']:.3e})."
                )
            print(
                f"Solver converged in"
                f" {self.last_stats['newton_iters']} nonlinear"
                f" iterations (with total number of"
                f" {self.last_stats['ksp_iters']} linear iterations)"
            )
            self._note_newton_iters(
                int(self.last_stats.get("newton_iters", 0))
            )
        else:
            # stay async: accumulate the converged flag on device; the
            # host fetches the AND at the next checked step
            acc = getattr(self, "_win_converged", None)
            flag = stats["converged"]
            self._win_converged = (
                flag if acc is None else jnp.logical_and(acc, flag)
            )
            self.last_stats = {"skipped": True}
        # this step's own Newton statistics; still on the device when
        # the host skipped the fetch above
        self.step_stats = stats
        self.u_sol, self.p_sol = u, p
        self.u_residual, self.p_residual = r_u, r_p
        self._post_step()
        self.step_count += 1
