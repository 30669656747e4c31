"""Matrix-free flexible GMRES under jit.

Replaces the PETSc KSP FGMRES the reference drives at
/root/reference/src/solvers/stabilized_schur.py:226-229 (fgmres, restart
200, max_it 1000). Accelerator design choices:

- Right-preconditioned *flexible* GMRES: the preconditioner may change
  between iterations (needed for inner-iterative Schur preconditioners).
- Orthogonalization is CGS2 (classical Gram-Schmidt with one
  reorthogonalization): two (m+1, n) matvecs per iteration instead of a
  sequential modified-GS chain — the dominant work becomes large matmuls
  that map onto dense matrix hardware, and it is as robust as MGS in practice.
- Fixed-size Krylov buffers + lax.while_loop: static shapes, early exit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _identity_precond(v):
    return v


def gmres_fixed(matvec, b, precond=None, m: int = 10,
                reorth: bool = True, reduce=None):
    """Fixed-iteration right-preconditioned GMRES (no convergence test, no
    restart) — the inner solver for fieldsplit sub-blocks, where PETSc
    would run a tolerance-free inner KSP (reference uses inner GMRES+ASM
    sub-solves, stabilized_schur.py:261-264). Unrolled over m (static), so
    XLA fuses the whole sweep; safe inside outer flexible GMRES.
    """
    M = precond if precond is not None else _identity_precond
    R = reduce if reduce is not None else (lambda x: x)
    if m <= 0:
        # preonly semantics (PETSc ksp_type preonly): one application of
        # the preconditioner — keeps m=0 configs from allocating
        # zero-size Krylov buffers (indexing error under jit)
        return M(b)
    n = b.shape[0]
    dt = b.dtype
    tiny = jnp.asarray(jnp.finfo(dt).tiny ** 0.5, dt)

    beta = jnp.sqrt(R(jnp.vdot(b, b)))
    V = jnp.zeros((m + 1, n), dt).at[0].set(b / jnp.maximum(beta, tiny))
    Z = jnp.zeros((m, n), dt)
    H = jnp.zeros((m + 1, m), dt)

    def body(j, state):
        V, Z, H = state
        z = M(V[j])
        w = matvec(z)
        Z = Z.at[j].set(z)
        mask = (jnp.arange(m + 1) <= j).astype(dt)
        h1 = R(V @ w) * mask
        w = w - V.T @ h1
        if reorth:
            h2 = R(V @ w) * mask
            w = w - V.T @ h2
            h = h1 + h2
        else:
            h = h1
        wnorm = jnp.sqrt(R(jnp.vdot(w, w)))
        h = h.at[j + 1].set(wnorm)
        V = V.at[j + 1].set(w / jnp.maximum(wnorm, tiny))
        H = H.at[:, j].set(h)
        return (V, Z, H)

    V, Z, H = jax.lax.fori_loop(0, m, body, (V, Z, H))

    # least squares min ||beta e1 - H y|| via normal equations (m is
    # small). Regularize relative to the spectrum so an exactly-zero rhs
    # (H = 0 -> singular normal equations) yields y = 0, not NaN.
    g = jnp.zeros(m + 1, dt).at[0].set(beta)
    HtH = H.T @ H
    reg = jnp.maximum(jnp.trace(HtH) / m, tiny) * jnp.asarray(1e-12, dt)
    y = jnp.linalg.solve(HtH + reg * jnp.eye(m, dtype=dt), H.T @ g)
    y = jnp.where(beta > tiny, y, 0.0)
    return Z.T @ y


def _chunked_cgs(V, w, j, m, C, red, dt):
    """One classical-Gram-Schmidt sweep reading only the ACTIVE basis:
    h = V[0..j] . w and w <- w - V[0..j]^T h, processed in C-row chunks
    via dynamic_slice so per-iteration memory traffic tracks ~j (rounded
    up to C), not the full restart buffer m. The fixed-shape sweep reads
    all m+1 rows every iteration — measured 12x slower at restart 60
    than 10 for identical iterations (PERF.md round-5 H4 note); at
    950k DOF the (61, n) basis is ~550 MB, so full-buffer sweeps are
    the dominant per-iteration cost at scale. Returns (h, w_new) with h
    zero beyond row j (same contract as the masked full sweep)."""
    n = V.shape[1]
    nch = j // C + 1  # chunks covering rows 0..j (j traced is fine)

    def dots(c, h):
        Vc = jax.lax.dynamic_slice(V, (c * C, 0), (C, n))
        mask = (c * C + jnp.arange(C) <= j).astype(dt)
        return jax.lax.dynamic_update_slice(
            h, red(Vc @ w) * mask, (c * C,)
        )

    h = jax.lax.fori_loop(0, nch, dots, jnp.zeros(m + 1, dt))

    def correct(c, acc):
        Vc = jax.lax.dynamic_slice(V, (c * C, 0), (C, n))
        hc = jax.lax.dynamic_slice(h, (c * C,), (C,))
        return acc + Vc.T @ hc

    w = w - jax.lax.fori_loop(0, nch, correct, jnp.zeros(n, dt))
    return h, w


def fgmres(
    matvec,
    b,
    x0=None,
    precond=None,
    restart: int = 30,
    maxiter: int = 1000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    reduce=None,
    ortho_chunk: int = 0,
):
    """Solve A x = b with flexible right-preconditioned GMRES.

    Args:
        matvec: v -> A v (jittable)
        b: right-hand side (n,)
        x0: initial guess (defaults to 0)
        precond: v -> M v (approximation of A^-1 v); may be flexible
        restart: Krylov dimension m
        maxiter: total iteration cap
        rtol/atol: stop when ||b - A x|| <= max(rtol*||b||, atol)
        ortho_chunk: 0 = fixed-shape CGS2 sweeps over the full (m+1, n)
            basis (the original HLO — cached executables depend on it);
            C > 0 = chunked sweeps reading only the active basis rows
            (ceil((j+1)/C) C-row chunks), cutting per-iteration traffic
            when the solve converges well before the restart length.

    Returns:
        (x, info) with info = {iters, resnorm, converged}.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = precond if precond is not None else _identity_precond
    _red = reduce if reduce is not None else (lambda x: x)

    def _norm(v):
        return jnp.sqrt(_red(jnp.vdot(v, v)))

    m = int(restart)
    n = b.shape[0]
    dt = b.dtype

    bnorm = _norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)
    tiny = jnp.asarray(jnp.finfo(dt).tiny ** 0.5, dt)

    def cycle(x):
        """One restart cycle; returns (x_new, resnorm, inner_iters)."""
        r = b - matvec(x)
        beta = _norm(r)

        V = jnp.zeros((m + 1, n), dt).at[0].set(r / jnp.maximum(beta, tiny))
        Z = jnp.zeros((m, n), dt)
        R = jnp.zeros((m + 1, m), dt)  # Hessenberg, rotated in place
        g = jnp.zeros(m + 1, dt).at[0].set(beta)
        cs = jnp.zeros(m, dt)
        sn = jnp.zeros(m, dt)

        def inner_cond(state):
            j, res, *_ = state
            return jnp.logical_and(j < m, res > tol)

        def inner_body(state):
            j, _, V, Z, R, g, cs, sn = state
            z = M(V[j])
            w = matvec(z)
            Z = Z.at[j].set(z)

            # CGS2: project against V[0..j] (mask rows > j)
            if ortho_chunk > 0:
                C = min(int(ortho_chunk), m + 1)
                h1, w = _chunked_cgs(V, w, j, m, C, _red, dt)
                h2, w = _chunked_cgs(V, w, j, m, C, _red, dt)
            else:
                mask = (jnp.arange(m + 1) <= j).astype(dt)
                h1 = _red(V @ w) * mask
                w = w - V.T @ h1
                h2 = _red(V @ w) * mask
                w = w - V.T @ h2
            h = h1 + h2
            wnorm = _norm(w)
            h = h.at[j + 1].set(wnorm)
            V = V.at[j + 1].set(w / jnp.maximum(wnorm, tiny))

            # apply previous Givens rotations to the new column
            def rot(i, hcol):
                t0 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                return hcol.at[i].set(t0).at[i + 1].set(t1)

            h = jax.lax.fori_loop(0, j, rot, h)

            # new rotation annihilating h[j+1]
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c = h[j] / jnp.maximum(denom, tiny)
            s = h[j + 1] / jnp.maximum(denom, tiny)
            h = h.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            g1 = -s * g[j]
            g = g.at[j + 1].set(g1).at[j].set(c * g[j])

            R = R.at[:, j].set(h[: m + 1])
            return (j + 1, jnp.abs(g1), V, Z, R, g, cs, sn)

        j, res, V, Z, R, g, cs, sn = jax.lax.while_loop(
            inner_cond, inner_body, (0, beta, V, Z, R, g, cs, sn)
        )

        # back-substitution on the leading j x j block (mask unused cols)
        idx = jnp.arange(m)
        used = idx < j
        Rm = R[:m, :m]
        # make the unused part of the triangle an identity so the solve is
        # well-posed, and zero the corresponding rhs entries
        Rm = jnp.where(
            (used[None, :] & used[:, None]),
            Rm,
            jnp.eye(m, dtype=dt),
        )
        gm = jnp.where(used, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        x_new = x + Z.T @ y
        return x_new, res, j

    def outer_cond(state):
        x, res, it, _ = state
        return jnp.logical_and(res > tol, it < maxiter)

    def outer_body(state):
        x, _, it, _ = state
        x, res, j = cycle(x)
        return (x, res, it + j, j)

    r0 = _norm(b - matvec(x0))
    x, res, iters, _ = jax.lax.while_loop(
        outer_cond, outer_body, (x0, r0, jnp.array(0), jnp.array(0))
    )
    info = {
        "iters": iters,
        "resnorm": res,
        "converged": res <= tol,
    }
    return x, info
