"""ASPIN-flavoured stabilized solver (Additive Schwarz Preconditioned
Inexact Newton).

The reference variant (/root/reference/src/solvers/stabilized_schur_aspin.py)
is identical to stabilized_schur except `snes.setType("aspin")` (:196):
PETSc's ASPIN solves the nonlinearly-preconditioned system whose residual
is the sum of per-subdomain local corrections (Cai & Keyes 2002), with
inexact global Newton on top.

Rebuild over the supernode subdomain machinery (la/asm.py):

1. Nonlinear additive-Schwarz pre-sweeps: x <- x - M_ASM(x) F(x),
   `aspin_sweeps` times per step, where M_ASM is the sum of local
   Schur-fieldsplit solves over `aspin_subdomains` Hilbert-contiguous
   subdomains. Each sweep is the one-local-Newton-step collapse of
   ASPIN's exact local solves (the "inexact" in ASPIN taken to its
   cheapest member), evaluated at the CURRENT state — this is the
   nonlinear preconditioning.
2. The global inexact Newton then runs with the SAME additive-Schwarz
   preconditioner on its linear solves (pc_type="asm"), mirroring
   ASPIN's use of the Schwarz Jacobian.

Matches the base solver's solutions (tests/test_variants.py) while using
the subdomain-decomposed preconditioning structure throughout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    def __init__(self, *args, aspin_subdomains: int = 8,
                 aspin_sweeps: int = 1, pc_type: str = "asm", **kwargs):
        self.asm_subdomains = int(aspin_subdomains)
        self.aspin_sweeps = int(aspin_sweeps)
        super().__init__(*args, pc_type=pc_type, **kwargs)

    def _build_step(self) -> None:
        super()._build_step()
        if self.aspin_sweeps <= 0 or self._nodebsr is None:
            return
        base_step = self._step_fn
        form = self.form
        bsr = self._nodebsr
        n_u = self.V.num_dofs
        dim = self.mesh.gdim
        bc_dofs_u = jnp.asarray(self.bc_dofs_u)
        bc_dofs_p = jnp.asarray(self.bc_dofs_p)
        has_bc_u = len(self.bc_dofs_u) > 0
        has_bc_p = len(self.bc_dofs_p) > 0
        pin = self.pin_pressure
        sweeps = self.aspin_sweeps
        n_sub = self.asm_subdomains
        m_u, m_p = self.pc_inner_u, (self.pc_inner_p or 20)

        import numpy as np

        bc_mask_np = np.zeros(form.n_flat, dtype=bool)
        for d0 in range(dim):
            bc_mask_np[self.bc_dofs_u.astype(np.int64) * dim + d0] = True
        bc_mask_np[n_u * dim + self.bc_dofs_p.astype(np.int64)] = True

        def step(u_guess, p_guess, aux, bc_u_vals, bc_p_vals, prm):
            from ..la.asm import make_asm_precond

            def F(x):
                u, p = x[: n_u * dim].reshape(n_u, dim), x[n_u * dim:]
                ru, rp = form.residual(u, p, aux, prm)
                if has_bc_u:
                    ru = ru.at[bc_dofs_u].set(u[bc_dofs_u] - bc_u_vals)
                if has_bc_p:
                    rp = rp.at[bc_dofs_p].set(p[bc_dofs_p] - bc_p_vals)
                if pin:
                    rp = rp - jnp.mean(rp)
                return jnp.concatenate([ru.reshape(-1), rp])

            x = jnp.concatenate([u_guess.reshape(-1), p_guess])
            for _ in range(sweeps):
                u, p = x[: n_u * dim].reshape(n_u, dim), x[n_u * dim:]
                A_cells, A_blocks = form.element_jacobians(
                    u, p, aux, prm
                )
                vals = bsr.assemble(A_cells, A_blocks)
                M = make_asm_precond(
                    bsr, vals, bc_mask_np, n_sub=n_sub,
                    m_u=m_u, m_p=m_p,
                )
                x = x - M(F(x))
                if pin:
                    u_, p_ = (
                        x[: n_u * dim].reshape(n_u, dim), x[n_u * dim:]
                    )
                    x = jnp.concatenate(
                        [u_.reshape(-1), p_ - jnp.mean(p_)]
                    )
            u1 = x[: n_u * dim].reshape(n_u, dim)
            p1 = x[n_u * dim:]
            return base_step(u1, p1, aux, bc_u_vals, bc_p_vals, prm)

        self._step_fn = step
        self._step = jax.jit(step)
