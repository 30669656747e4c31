"""Matrix-free Newton-Krylov with backtracking line search, under jit.

Replaces PETSc SNES "newtonls" (reference setup at
/root/reference/src/solvers/stabilized_schur.py:202-275: newtonls + FGMRES,
snes_max_it=100, ksp_max_it=1000, gmres_restart=200). The Jacobian action
is exact via jax.jvp of the residual — the analogue of the reference's
symbolic UFL `derivative` (stabilized_schur.py:187), with no assembled
matrix on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp

from .gmres import fgmres


@dataclass(frozen=True)
class NewtonParams:
    max_it: int = 100
    rtol: float = 1e-8
    atol: float = 1e-10
    stol: float = 1e-8
    ksp_rtol: float = 1e-5
    ksp_atol: float = 0.0
    ksp_restart: int = 60
    ksp_maxiter: int = 1000
    # chunked CGS2 sweeps in fgmres (0 = full-buffer fixed-shape sweeps;
    # cached executables depend on 0 -- see la/gmres.py::_chunked_cgs)
    ksp_ortho_chunk: int = 0
    ls_max_halvings: int = 6
    ls_alpha: float = 1e-4
    # Eisenstat-Walker adaptive forcing (PETSc -snes_ksp_ew, used by the
    # reference LSC family at src/solvers/stabilized_lsc.py:220-266):
    # eta_k = gamma*(||F_k||/||F_{k-1}||)^alpha, safeguarded, so early
    # Newton steps get loose linear solves and late ones tight.
    ew: bool = False
    ew_eta0: float = 0.1
    ew_eta_max: float = 0.9
    ew_gamma: float = 0.9
    ew_alpha: float = 2.0
    # Lag the preconditioner: build it once from the initial state and
    # reuse it for every Newton iteration of the step (PETSc
    # -snes_lag_preconditioner). The Jacobian ACTION stays exact per
    # iteration; only the PC (SELFP assembly + AMG hierarchies — the
    # dominant per-iteration build cost) goes stale, which flexible
    # GMRES absorbs. Within one transient time step the state moves
    # little, so iteration counts barely change.
    pc_lag: bool = False
    # Lag the JACOBIAN too (PETSc -snes_lag_jacobian -1: chord Newton):
    # assemble the operator once from the initial state and reuse its
    # action AND preconditioner for every Newton iteration of the step.
    # Saves the per-iteration element sweep + assembly (the dominant
    # fixed cost once iteration counts are low); convergence degrades
    # from quadratic to linear, which the extrapolated warm start keeps
    # cheap within a transient step. The line search safeguards.
    jac_lag: bool = False


def newton_solve(
    F: Callable,
    x0,
    params: NewtonParams = NewtonParams(),
    make_precond: Callable | None = None,
    project: Callable | None = None,
    make_operator: Callable | None = None,
    reduce: Callable | None = None,
    shard: tuple | None = None,
):
    """Solve F(x) = 0 by Newton-Krylov.

    Args:
        F: residual function (n,) -> (n,), jittable.
        x0: initial guess.
        make_precond: x -> (v -> M v) preconditioner factory, rebuilt at
            every Newton iteration (like PETSc reassembling the PC matrix
            per SNES iteration).
        project: optional nullspace projector applied to the Newton update
            (e.g. remove the constant-pressure mode, mirroring the PETSc
            NullSpace at /root/reference/src/solvers/stabilized_schur.py:283-293).
        make_operator: x -> (matvec, precond | None). When given, supplies
            the Jacobian action (e.g. assembled element blocks) and
            overrides make_precond. When absent, the Jacobian action is
            jax.linearize of F. NOTE: do NOT swap this default to jax.jvp —
            re-running the jvp primal inside the Krylov while_loop
            has miscompiled (silently producing a zero-progress solve);
            linearize replays only the linear part and is also cheaper.

    Returns:
        (x, stats) with stats = {newton_iters, ksp_iters (total over the
        Newton iterations), ksp_max_iters (the longest linear solve),
        fnorm, f0norm,
        converged, ls_failures}.
    """
    p = params
    R = reduce if reduce is not None else (lambda x: x)

    def _norm(v):
        return jnp.sqrt(R(jnp.vdot(v, v)))

    f0 = F(x0)
    f0norm = _norm(f0)
    ftol = jnp.maximum(p.atol, p.rtol * f0norm)

    M_lagged = None
    OP_lagged = None
    if p.jac_lag and make_operator is not None:
        OP_lagged = make_operator(x0)
    elif p.pc_lag and make_operator is not None:
        _, M_lagged = make_operator(x0)

    def cond(state):
        x, f, fnorm, it, ksp_total, ksp_max, done, lsfail, eta = state
        return jnp.logical_and(jnp.logical_not(done), it < p.max_it)

    def body(state):
        x, f, fnorm, it, ksp_total, ksp_max, done, lsfail, eta = state

        if OP_lagged is not None:
            matvec, M = OP_lagged
        elif make_operator is not None:
            matvec, M = make_operator(x)
            if M_lagged is not None:
                M = M_lagged
        else:
            _, matvec = jax.linearize(F, x)
            M = make_precond(x) if make_precond is not None else None
        ksp_rtol = eta if p.ew else p.ksp_rtol
        if shard is not None:
            # distributed linear solve: the Newton state x/F stays
            # replicated, but the Krylov loop (basis storage, matvec,
            # PC, dots) runs on per-shard local vectors — to_local
            # slices this shard's rows, from_local all_gathers the
            # result, and shard_reduce psums scalar products. The
            # matvec/precond from make_operator must be LOCAL operators.
            to_local, from_local, shard_reduce = shard
            dx_loc, info = fgmres(
                matvec,
                to_local(-f),
                precond=M,
                restart=p.ksp_restart,
                maxiter=p.ksp_maxiter,
                rtol=ksp_rtol,
                atol=p.ksp_atol,
                reduce=shard_reduce,
                ortho_chunk=p.ksp_ortho_chunk,
            )
            dx = from_local(dx_loc)
        else:
            dx, info = fgmres(
                matvec,
                -f,
                precond=M,
                restart=p.ksp_restart,
                maxiter=p.ksp_maxiter,
                rtol=ksp_rtol,
                atol=p.ksp_atol,
                reduce=reduce,
                ortho_chunk=p.ksp_ortho_chunk,
            )
        if project is not None:
            dx = project(dx)

        # backtracking line search on ||F||
        def ls_cond(ls):
            lam, fnew, nnew, tries = ls
            ok = nnew <= (1.0 - p.ls_alpha * lam) * fnorm
            return jnp.logical_and(
                jnp.logical_not(ok), tries < p.ls_max_halvings
            )

        def ls_body(ls):
            lam, _, _, tries = ls
            lam = lam * 0.5
            fnew = F(x + lam * dx)
            return (lam, fnew, _norm(fnew), tries + 1)

        f1 = F(x + dx)
        lam, fnew, nnew, tries = jax.lax.while_loop(
            ls_cond, ls_body, (jnp.asarray(1.0, x.dtype), f1,
                               _norm(f1), 0)
        )
        ls_failed = nnew > (1.0 - p.ls_alpha * lam) * fnorm

        x_new = x + lam * dx
        step_small = lam * _norm(dx) <= p.stol * jnp.maximum(
            _norm(x_new), 1e-30
        )
        # stol-based convergence only counts when the step also decreased
        # ||F|| — a tiny update out of a stagnated linear solve is
        # divergence, not convergence.
        converged = jnp.logical_or(
            nnew <= ftol, jnp.logical_and(step_small, nnew <= fnorm)
        )
        # Eisenstat-Walker choice 2 with the safeguard eta >= g*eta_prev^a
        # when that term is still large (Eisenstat & Walker 1996, eq. 2.6)
        eta_cand = p.ew_gamma * (nnew / jnp.maximum(fnorm, 1e-300)) ** (
            p.ew_alpha
        )
        guard = p.ew_gamma * eta ** p.ew_alpha
        eta_cand = jnp.where(guard > 0.1, jnp.maximum(eta_cand, guard),
                             eta_cand)
        eta_new = jnp.clip(eta_cand, 1e-6, p.ew_eta_max).astype(eta.dtype)
        return (
            x_new,
            fnew,
            nnew,
            it + 1,
            ksp_total + info["iters"],
            jnp.maximum(ksp_max, info["iters"]),
            converged,
            lsfail + ls_failed.astype(jnp.int32),
            eta_new,
        )

    init = (
        x0,
        f0,
        f0norm,
        jnp.array(0),
        jnp.array(0),
        jnp.array(0),
        f0norm <= ftol,
        jnp.array(0, jnp.int32),
        jnp.asarray(p.ew_eta0, f0norm.dtype),
    )
    (x, f, fnorm, iters, ksp_iters, ksp_max, done, lsfail,
     _eta) = jax.lax.while_loop(cond, body, init)
    stats = {
        "newton_iters": iters,
        "ksp_iters": ksp_iters,
        "ksp_max_iters": ksp_max,
        "fnorm": fnorm,
        "f0norm": f0norm,
        "converged": done,
        "ls_failures": lsfail,
        "final_residual": f,
    }
    return x, stats
