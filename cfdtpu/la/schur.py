"""Schur-complement fieldsplit preconditioner (SELFP-style), matrix-free
over element blocks.

Replaces the PETSc fieldsplit PC the reference configures at
/root/reference/src/solvers/stabilized_schur.py:231-267:
SchurFactType.FULL with SchurPreType.SELFP — i.e. the Schur complement is
preconditioned by S_p = A_pp - A_pu diag(A_uu)^{-1} A_up — with inner
GMRES+ASM on the u-block and preonly+ASM on the pressure block.

Realization: all four sub-blocks act through the element
Jacobian blocks (gather -> batched matmul -> scatter); inner solves are
fixed-iteration GMRES sweeps (flexible outer FGMRES absorbs their
variability); the ASM sub-PCs become Jacobi diagonals of the sub-blocks.

Full (LDU) application for rhs (r_u, r_p):
    z_u1 = Auu^-1 r_u
    r_s  = r_p - A_pu z_u1
    z_p  = S^-1 r_s            (S applied matrix-free via SELFP blocks)
    z_u  = z_u1 - Auu^-1 (A_up z_p)

The build/apply split (build_schur_state / make_schur_precond_from_state)
exists so the EXPENSIVE numeric state — SELFP assembly, AMG hierarchy
values, RAS factorizations, diagonals — can be computed once and carried
across TIME STEPS as a pytree (the cross-step analogue of PETSc
-snes_lag_preconditioner_persists; solver kwarg pc_lag_steps). The
closures themselves are rebuilt per jitted call, which costs nothing
under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from .gmres import gmres_fixed


def _safe(d):
    scale = jnp.max(jnp.abs(d))
    floor = 1e-12 * scale
    return jnp.where(
        jnp.abs(d) < floor, jnp.where(d < 0, -floor, floor), d
    )


def _sub_ops(form, A_cells, A_blocks, bc_mask_u, bc_mask_p,
             pin_pressure, inv_d_u):
    """The four sub-block actions + the SELFP Schur action S."""

    def Auu(v):
        y = form.apply_sub_block(A_cells, A_blocks, v, "uu")
        return jnp.where(bc_mask_u, v, y)

    def Aup(v_p):
        y = form.apply_sub_block(A_cells, A_blocks, v_p, "up")
        return jnp.where(bc_mask_u, 0.0, y)

    def Apu(v_u):
        # BC velocity columns of the true Jacobian are retained in the
        # residual rows; for the PC the masked variant suffices
        return form.apply_sub_block(A_cells, A_blocks, v_u, "pu")

    def App(v_p):
        return form.apply_sub_block(A_cells, A_blocks, v_p, "pp")

    if hasattr(form, "apply_p_coupled"):
        def S(v_p):
            """SELFP Schur action, fused: (Aup v, App v) in one pass."""
            w, y_pp = form.apply_p_coupled(A_cells, v_p)
            w = jnp.where(bc_mask_u, 0.0, w)
            y = y_pp - Apu(inv_d_u * w)
            if bc_mask_p is not None:
                y = jnp.where(bc_mask_p, v_p, y)
            if pin_pressure:
                y = y - jnp.mean(y)
            return y
    else:
        def S(v_p):
            """SELFP Schur action: App v - Apu diag(Auu)^-1 Aup v."""
            w = Aup(v_p)
            y = App(v_p) - Apu(inv_d_u * w)
            if bc_mask_p is not None:
                y = jnp.where(bc_mask_p, v_p, y)
            if pin_pressure:
                y = y - jnp.mean(y)
            return y

    return Auu, Aup, Apu, App, S


# inner_method: "gmres" (both blocks), "chebyshev" (both),
# "chebyshev_p" (GMRES on the convective u-block, reduction-free
# Chebyshev on the near-SPD SELFP Schur block — see la/chebyshev.py),
# "amg_p" (AMG inner PC on the SELFP Schur stage), "amg_up"
# (additionally block-AMG on the A_uu stage), "ras_up" (RAS batched
# dense subdomain solves on A_uu, la/ras.py — the ASM+ILU analogue of
# /root/reference/src/solvers/stabilized_schur.py:261-264), or
# "rasamg_up" (block-AMG on A_uu with RAS fine-level smoothing —
# h-robust AND convection-robust). All *_up methods keep AMG on the
# SELFP Schur stage.
# "amg_sup": amg_up PLUS the S stage operates on a near-true Schur
# complement — the diag(Auu)^-1 inside the SELFP product is replaced
# by one u-block AMG V-cycle (a LINEAR operator, so the fixed-GMRES
# S sweeps remain valid; a nested GMRES would not be). diag(Auu) is
# an O(1)-bad stand-in for Auu^-1 once convection dominates (large
# dt / steady marches), and that gap — not the u-solve quality — is
# what drives the 550-700 ksp/step steady-march counts (round-3
# m_u/m_p split experiments, PERF.md). The SELFP-matrix AMG stays as
# the PC of the S sweeps.
_UU_AMG_METHODS = ("amg_up", "amg_sup", "rasamg_up", "rasamg_sup")
_AMG_P_METHODS = (
    "amg_p", "amg_up", "ras_up", "rasamg_up", "amg_sup", "rasamg_sup",
)


def build_schur_state(
    form,
    A_cells,
    A_blocks,
    bc_mask_u,
    pin_pressure: bool,
    m_u: int = 8,
    m_p: int = 10,
    full: bool = True,
    bc_mask_p=None,
    inner_method: str = "gmres",
    ras_opts: tuple[int, int] = (16, 4),
):
    """Numeric preconditioner state as a pytree (jittable).

    Contains the operator values plus every expensive derived array:
    sub-block diagonals, u-block AMG/RAS hierarchy values, the explicit
    SELFP matrix's AMG level values, Chebyshev eigenvalue estimates.
    Reusable across time steps (pc_lag_steps)."""
    n_u_flat = form.n_u_flat
    d_full = form.jacobian_diagonal(A_cells, A_blocks)
    d_u = _safe(jnp.where(bc_mask_u, 1.0, d_full[:n_u_flat]))
    d_p = _safe(d_full[n_u_flat:])
    inv_d_u = 1.0 / d_u
    state = {"A": A_cells, "Ab": A_blocks, "d_u": d_u, "d_p": d_p}

    cheb_u = inner_method == "chebyshev"
    cheb_p = inner_method in ("chebyshev", "chebyshev_p")

    if inner_method in _UU_AMG_METHODS and hasattr(form, "uu_amg"):
        ras = (
            form.uu_ras(*ras_opts)
            if inner_method.startswith("rasamg") and hasattr(
                form, "uu_ras"
            ) else None
        )
        uu_amg = form.uu_amg(fine_smoother=ras)
        state["uu_built"] = uu_amg.build(
            form.uu_vals(A_cells, bc_mask_u)
        )
    if inner_method == "ras_up" and hasattr(form, "uu_ras"):
        state["ras_inv"] = form.uu_ras(*ras_opts).build(
            form.uu_vals(A_cells, bc_mask_u)
        )
    if cheb_u:
        from .chebyshev import estimate_lambda_max

        Auu, *_ = _sub_ops(form, A_cells, A_blocks, bc_mask_u,
                           bc_mask_p, pin_pressure, inv_d_u)
        state["lam_u"] = estimate_lambda_max(
            Auu, inv_d_u, n_u_flat, d_u.dtype
        )

    if inner_method in _AMG_P_METHODS and hasattr(form, "sp_amg"):
        # aggregation-MG V-cycle on the EXPLICIT SELFP matrix
        # Sp = App - Apu diag(Auu)^-1 Aup as the inner PC of the S
        # sweeps (la/amg.py, la/nodebsr.py sp_vals) — the h-robust
        # substitute for the reference's AMG/ASM pressure sub-PCs. AMG
        # on App alone fails here: in stabilized P1-P1 the pressure
        # Laplacian lives in the product term, App is only the small
        # tau-scaled PSPG block (measured: 380 vs 22 outer iterations).
        amg = form.sp_amg()
        sp = form.sp_vals(
            A_cells, jnp.where(bc_mask_u, 0.0, inv_d_u)
        )
        if bc_mask_p is not None:
            # identity rows at pressure-Dirichlet dofs, matching the
            # matrix-free S
            sp_row = form.sp_structure()[0]
            sp = jnp.where(bc_mask_p[sp_row], 0.0, sp)
            sp = sp.at[form._sp_diag_pos].set(
                jnp.where(bc_mask_p, 1.0, sp[form._sp_diag_pos])
            )
        state["sp_built"] = amg.build(sp)
    elif cheb_p:
        from .chebyshev import estimate_lambda_max

        *_, S = _sub_ops(form, A_cells, A_blocks, bc_mask_u,
                         bc_mask_p, pin_pressure, inv_d_u)
        state["lam_p"] = estimate_lambda_max(
            S, 1.0 / d_p, d_p.shape[0], d_p.dtype
        )
    return state


def make_schur_precond_from_state(
    form,
    state,
    bc_mask_u,
    pin_pressure: bool,
    m_u: int = 8,
    m_p: int = 10,
    full: bool = True,
    bc_mask_p=None,
    inner_method: str = "gmres",
    ras_opts: tuple[int, int] = (16, 4),
):
    """Build v -> M v approximating J^{-1} v from a prebuilt numeric
    state (build_schur_state). Closure construction only — no numeric
    builds happen here, so the state can be stale-reused across steps."""
    n_u_flat = form.n_u_flat
    A_cells, A_blocks = state["A"], state["Ab"]
    d_u, d_p = state["d_u"], state["d_p"]
    inv_d_u = 1.0 / d_u
    Auu, Aup, Apu, App, S = _sub_ops(
        form, A_cells, A_blocks, bc_mask_u, bc_mask_p, pin_pressure,
        inv_d_u,
    )

    cheb_u = inner_method == "chebyshev"
    cheb_p = inner_method in ("chebyshev", "chebyshev_p")
    amg_on_p = "sp_built" in state
    sup_schur = inner_method in ("amg_sup", "rasamg_sup")

    uu_vcycle = None
    if "uu_built" in state:
        ras = (
            form.uu_ras(*ras_opts)
            if inner_method.startswith("rasamg") and hasattr(
                form, "uu_ras"
            ) else None
        )
        uu_amg = form.uu_amg(fine_smoother=ras)
        uu_built = state["uu_built"]

        def uu_vcycle(r):  # noqa: F811
            return uu_amg.v_cycle(uu_built, r)

    if "ras_inv" in state:
        ras_only = form.uu_ras(*ras_opts)
        ras_inv = state["ras_inv"]

        def Mu_ras(r):
            return ras_only.apply(ras_inv, r)

        def solve_Auu(r):
            return gmres_fixed(Auu, r, precond=Mu_ras, m=m_u,
                               reorth=False)
    elif uu_vcycle is not None:
        def solve_Auu(r):
            return gmres_fixed(Auu, r, precond=uu_vcycle, m=m_u,
                               reorth=False)
    elif cheb_u:
        from .chebyshev import chebyshev_fixed

        lam_u = state["lam_u"]

        def solve_Auu(r):
            return chebyshev_fixed(Auu, r, inv_d_u, lam_u, m=m_u)
    else:
        if hasattr(form, "uu_block_jacobi"):
            # exact (dim x dim) node-block Jacobi: strictly stronger
            # than the scalar diagonal once convection couples the
            # velocity components (large dt)
            Mu = form.uu_block_jacobi(A_cells, bc_mask_u)
        else:
            Mu = lambda v: v / d_u  # noqa: E731

        def solve_Auu(r):
            # single-orthogonalization sweeps: the PC only needs an
            # approximate inverse; halves the non-matvec cost/iteration
            return gmres_fixed(Auu, r, precond=Mu, m=m_u,
                               reorth=False)

    if m_u == 0 and uu_vcycle is not None:
        # preonly u-stage (the PETSc fieldsplit_u preonly idiom): one
        # V-cycle application, no Krylov wrap — skips the Auu matvec
        # per sweep entirely; the outer FGMRES corrects the error
        def solve_Auu(r):  # noqa: F811
            return uu_vcycle(r)

    if sup_schur and uu_vcycle is not None:
        def S(v_p):  # noqa: F811
            """Near-true Schur action: App v - Apu Vcycle_uu(Aup v).
            kcycle=False: this V-cycle is part of a LINEAR operator
            swept by fixed GMRES — the K-cycle's rhs-dependent
            coefficients would silently break the Krylov recurrence."""
            w = Aup(v_p)
            z = uu_amg.v_cycle(uu_built, w, kcycle=False)
            z = jnp.where(bc_mask_u, 0.0, z)
            y = App(v_p) - Apu(z)
            if bc_mask_p is not None:
                y = jnp.where(bc_mask_p, v_p, y)
            if pin_pressure:
                y = y - jnp.mean(y)
            return y

    if amg_on_p:
        amg = form.sp_amg()
        level_vals = state["sp_built"]

        def Mp_vcycle(v):
            return amg.v_cycle(level_vals, v)

        if m_p == 0:
            # preonly S-stage: one SELFP-AMG V-cycle
            def solve_S(r):
                if pin_pressure:
                    r = r - jnp.mean(r)
                z = Mp_vcycle(r)
                if pin_pressure:
                    z = z - jnp.mean(z)
                return z
        else:
            def solve_S(r):
                if pin_pressure:
                    r = r - jnp.mean(r)
                z = gmres_fixed(S, r, precond=Mp_vcycle, m=m_p,
                                reorth=False)
                if pin_pressure:
                    z = z - jnp.mean(z)
                return z
    elif cheb_p:
        from .chebyshev import chebyshev_fixed

        inv_d_p = 1.0 / d_p
        lam_p = state["lam_p"]

        def solve_S(r):
            if pin_pressure:
                r = r - jnp.mean(r)
            z = chebyshev_fixed(S, r, inv_d_p, lam_p, m=m_p)
            if pin_pressure:
                z = z - jnp.mean(z)
            return z
    else:
        def solve_S(r):
            if pin_pressure:
                r = r - jnp.mean(r)
            z = gmres_fixed(S, r, precond=lambda v: v / d_p, m=m_p,
                            reorth=False)
            if pin_pressure:
                z = z - jnp.mean(z)
            return z

    def precond(v):
        r_u, r_p = v[:n_u_flat], v[n_u_flat:]
        z_u = solve_Auu(r_u)
        r_s = r_p - Apu(z_u)
        z_p = solve_S(r_s)
        if full:
            z_u = z_u - solve_Auu(Aup(z_p))
        return jnp.concatenate([z_u, z_p])

    return precond


def make_schur_precond(
    form,
    A_cells,
    A_blocks,
    bc_mask_u,
    pin_pressure: bool,
    m_u: int = 8,
    m_p: int = 10,
    full: bool = True,
    bc_mask_p=None,
    inner_method: str = "gmres",
    ras_opts: tuple[int, int] = (16, 4),
):
    """Build v -> M v approximating J^{-1} v.

    Args:
        form: StabilizedNSForm (provides apply_sub_block / layout)
        A_cells, A_blocks: current element Jacobian blocks
        bc_mask_u: (n_u*dim,) bool mask of Dirichlet velocity rows (these
            rows of the operator are identity)
        pin_pressure: project the constant pressure mode inside S solves
        m_u / m_p: inner GMRES sweep lengths for Auu / Schur solves
        full: apply the full LDU factorization (vs lower-triangular)
    """
    state = build_schur_state(
        form, A_cells, A_blocks, bc_mask_u, pin_pressure,
        m_u=m_u, m_p=m_p, full=full, bc_mask_p=bc_mask_p,
        inner_method=inner_method, ras_opts=ras_opts,
    )
    return make_schur_precond_from_state(
        form, state, bc_mask_u, pin_pressure,
        m_u=m_u, m_p=m_p, full=full, bc_mask_p=bc_mask_p,
        inner_method=inner_method, ras_opts=ras_opts,
    )
