"""Chebyshev polynomial smoother for preconditioner inner solves.

The reference's inner sub-PCs are ASM/ILU/AMG under PETSc
(/root/reference/src/solvers/stabilized_schur.py:261-264,
ipcs_midpoint.py:102-110 BoomerAMG). On an accelerator the equivalent latency
killer is the *reduction* inside every inner GMRES iteration: each
orthogonalization is a sequential all-reduce. A Chebyshev sweep needs
NO dot products at run time — only matvecs and AXPYs, which pipeline on
the device — the same reason hypre switches its smoothers to Chebyshev
on accelerators. Spectrum bounds come from a short power iteration at
preconditioner-build time (once per Newton step).

Only safe for blocks with (near-)real positive spectra: the SELFP Schur
block (pressure-Laplacian-like) and diffusion/mass-dominated velocity
blocks. Keep GMRES sweeps for strongly convective u-blocks.

Measured (DFG 2D-1 coarse, CN dt=0.05): outer FGMRES iterations per
step with m_u=6/m_p=30 inner sweeps — gmres/gmres 22, chebyshev on S
only 140, chebyshev on both 149. The SELFP Schur block carries enough
convective coupling (A_pu diag^-1 A_up) that a 30-step Chebyshev sweep
with power-iteration bounds is far weaker than 30 GMRES steps, and the
7x outer-iteration hit cannot be recouped by removing inner reductions.
Chebyshev therefore stays opt-in (pc_inner_method=chebyshev[_p]); a
competitive reduction-free inner solve needs a real AMG-style hierarchy,
not a flat polynomial sweep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def estimate_lambda_max(matvec, inv_diag, n, dtype, iters: int = 10):
    """Largest eigenvalue of D^-1 A by power iteration (deterministic
    start), jittable. Returns a slight overestimate (x1.05 safety)."""
    # alternating-sign start excites high-frequency modes, which carry
    # the largest eigenvalues for Jacobi-preconditioned elliptic blocks
    v0 = jnp.where(jnp.arange(n) % 2 == 0, 1.0, -1.0).astype(dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, carry):
        v, lam = carry
        w = inv_diag * matvec(v)
        nw = jnp.linalg.norm(w)
        lam = nw
        v = w / jnp.maximum(nw, 1e-300)
        return (v, lam)

    _, lam = jax.lax.fori_loop(0, iters, body, (v0, jnp.asarray(1.0, dtype)))
    return 1.05 * lam


def chebyshev_fixed(matvec, b, inv_diag, lam_max, m: int = 10,
                    lam_min_frac: float = 0.06):
    """m Chebyshev iterations for A x = b with Jacobi scaling, targeting
    the interval [lam_min_frac*lam_max, lam_max] of D^-1 A. x0 = 0.

    Reduction-free per iteration (matvec + AXPYs only), unlike the
    gmres_fixed sweeps whose CGS2 needs two reductions per iteration.
    """
    lam_min = lam_min_frac * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    r = b
    d = (inv_diag * r) / theta
    x = d
    rho = 1.0 / sigma1

    def body(_, carry):
        x, d, rho = carry
        r = b - matvec(x)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (inv_diag * r)
        return (x + d, d, rho_new)

    x, _, _ = jax.lax.fori_loop(0, m - 1, body, (x, d, rho))
    return x
