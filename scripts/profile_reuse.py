"""Where does the time of the 106k reuse step go beyond its components?

Component timings (profile_step.py) time every piece as a
CLOSURE-CONSTANT jit, while the production step passes all static index
maps as jit ARGUMENTS (utils/constargs.py). On earlier hardware most of
the reuse step was unaccounted for by its components. Hypotheses, each
timed here on the real backend:

  H1 dispatch: per-call marshaling of the large const-args tuple
     (no-op jit over the same args)
  H2 const-folding: XLA specializes gathers/segment-sums when index
     maps are HLO constants and picks slower generic paths when they
     are arguments (fgmres / PC apply / residual, const-args vs
     closure-const A/B)
  H3 newton machinery: line search + norms + while_loop overhead
     (standalone newton_solve vs its fgmres content)

Usage: python scripts/profile_reuse.py [res_scale] [warmup_steps]
(BENCH_* env knobs honoured via bench._dfg_scenario)
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp


def _fence(y):
    jax.block_until_ready(y)


def make_bench():
    def bench(fn, *args, reps=5):
        y = fn(*args)
        _fence(y)
        t0 = time.perf_counter()
        for _ in range(reps):
            y = fn(*args)
        _fence(y)
        return (time.perf_counter() - t0) / reps

    return bench


def main():
    if len(sys.argv) > 1:
        os.environ["BENCH_RES_SCALE"] = sys.argv[1]
    warm = int(sys.argv[2]) if len(sys.argv) > 2 else 6

    from bench import _dfg_scenario
    from cfdtpu.utils.constargs import make_const_wrapped

    bench = make_bench()
    sc = _dfg_scenario()
    s = sc.solver
    form = s.form
    bsr = s._nodebsr
    print(f"dofs={s.V.num_global_dofs + s.Q.num_global_dofs} "
          f"const_args={s.jit_const_args}", flush=True)

    for i in range(warm):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    _fence(s.u_sol)

    prm = s.params()
    u, p, aux = s.u_prev, s.p_prev, s._aux()
    bc_u_vals, bc_p_vals = s._bc_values()
    op = s._op_state

    # baseline: the production reuse step
    t = bench(lambda: s._reuse_step(u, p, aux, bc_u_vals, bc_p_vals,
                                    prm, op), reps=4)
    print(f"reuse_step (production): {t*1e3:9.1f} ms", flush=True)

    # -- H1: dispatch/marshal overhead of the const tuple --------------
    consts = getattr(s, "_reuse_consts", ())
    nbytes = sum(int(np.prod(c.shape)) * c.dtype.itemsize
                 for c in consts if hasattr(c, "shape"))
    print(f"const args: {len(consts)} arrays, {nbytes/1e6:.0f} MB",
          flush=True)
    noop = jax.jit(lambda *a: jnp.float32(0.0))
    t = bench(lambda: noop(u, p, bc_u_vals, bc_p_vals, *consts), reps=10)
    print(f"H1 no-op jit over consts: {t*1e3:9.1f} ms", flush=True)

    # -- H2: const-args vs closure-const, piece by piece ----------------
    def F(uu, pp):
        return form.residual(uu, pp, aux, prm)

    t_cc = bench(jax.jit(F), u, p)
    Fw, Fc = make_const_wrapped(F, [form, bsr])
    jF = jax.jit(Fw)
    t_ca = bench(lambda: jF(u, p, Fc))
    print(f"H2 residual: closure {t_cc*1e3:8.1f} ms | "
          f"const-args {t_ca*1e3:8.1f} ms", flush=True)

    vals = op["vals"]

    def mv_fn(v):
        return bsr.apply_element_matrices(vals, (), v)

    v = jnp.ones((form.n_flat,), form.dtype)
    t_cc = bench(jax.jit(mv_fn), v, reps=20)
    mvw, mvc = make_const_wrapped(mv_fn, [form, bsr])
    jmv = jax.jit(mvw)
    t_ca = bench(lambda: jmv(v, mvc), reps=20)
    print(f"H2 matvec:   closure {t_cc*1e3:8.1f} ms | "
          f"const-args {t_ca*1e3:8.1f} ms", flush=True)

    from cfdtpu.la.schur import make_schur_precond_from_state

    dim = s.mesh.gdim
    n_u = form.n_u_flat
    bc_mask_np = np.zeros(form.n_flat, dtype=bool)
    bc_mask_np[np.asarray(s.bc_dofs_u, dtype=np.int64)[:, None] * dim
               + np.arange(dim)] = True
    bc_mask_u = jnp.asarray(bc_mask_np[:n_u])
    pc_kw = dict(
        m_u=s.pc_inner_u, m_p=s.pc_inner_p,
        full=s.pc_schur_fact == "full",
        bc_mask_p=None,
        inner_method=s.pc_inner_method,
        ras_opts=(s.pc_ras_size, s.pc_ras_overlap),
    )

    def pc_fn(w):
        pc = make_schur_precond_from_state(
            bsr, op["pc"], bc_mask_u, True, **pc_kw)
        return pc(w)

    t_cc = bench(jax.jit(pc_fn), v, reps=10)
    pcw, pcc = make_const_wrapped(pc_fn, [form, bsr])
    jpc = jax.jit(pcw)
    t_ca = bench(lambda: jpc(v, pcc), reps=10)
    print(f"H2 PC apply: closure {t_cc*1e3:8.1f} ms | "
          f"const-args {t_ca*1e3:8.1f} ms", flush=True)

    from cfdtpu.la.gmres import fgmres

    def sol10(b, restart):
        x, _ = fgmres(mv_fn, b, precond=None, restart=restart,
                      maxiter=10, rtol=1e-12)
        return x

    for m in (10, 60):
        fn = jax.jit(lambda b, m=m: sol10(b, m))
        t_cc = bench(fn, v, reps=5)
        w_, c_ = make_const_wrapped(lambda b, m=m: sol10(b, m),
                                    [form, bsr])
        jf = jax.jit(w_)
        t_ca = bench(lambda: jf(v, c_), reps=5)
        print(f"H2 10 plain-gmres its (restart {m:>2}): closure "
              f"{t_cc*1e3:8.1f} ms | const-args {t_ca*1e3:8.1f} ms",
              flush=True)

    # -- H3/H4: the production linear solve (true matvec: BC rows
    #    masked, pressure mean pinned — without these the system is
    #    singular and its pins at maxiter) at production restart=60 vs
    #    smaller Krylov buffers. The CPU validation run measured 10
    #    identical plain-gmres its 12x slower at restart 60 than at 10:
    #    per-iteration cost tracks the BUFFER size, not j.
    bc_mask = jnp.asarray(bc_mask_np)
    n_p = form.n_flat - n_u

    def prod_mv(w):
        y = mv_fn(w)
        y = jnp.where(bc_mask, w, y)
        yp = y[n_u:]
        return jnp.concatenate([y[:n_u], yp - jnp.mean(yp)])

    ru, rp = form.residual(u, p, aux, prm)
    b_phys = -jnp.concatenate([ru.reshape(-1), rp]).astype(form.dtype)
    b_phys = b_phys.at[n_u:].add(-jnp.mean(b_phys[n_u:]))

    def prod_solve(b, restart):
        pc = make_schur_precond_from_state(
            bsr, op["pc"], bc_mask_u, True, **pc_kw)
        x, info = fgmres(prod_mv, b, precond=pc, restart=restart,
                         maxiter=120, rtol=1e-5)
        return x, info["iters"]

    for m in (60, 30, 20, 10):
        fn = jax.jit(lambda b, m=m: prod_solve(b, m))
        x_, its_ = fn(b_phys)
        t = bench(fn, b_phys, reps=5)
        print(f"H4 tuned solve restart {m:>2}: {t*1e3:9.1f} ms "
              f"(its={int(its_)})", flush=True)

    # production restart, const-args (the H2 A/B at full solve grain)
    w_, c_ = make_const_wrapped(
        lambda b: prod_solve(b, 60), [form, bsr])
    jf = jax.jit(w_)
    jf(b_phys, c_)
    t = bench(lambda: jf(b_phys, c_), reps=5)
    print(f"H4 tuned solve restart 60 const-args: {t*1e3:9.1f} ms",
          flush=True)


if __name__ == "__main__":
    main()
