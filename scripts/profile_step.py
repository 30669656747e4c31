"""Component-level timing of one stabilized_schur DFG step on the current
backend, in the TUNED bench configuration (bench._dfg_scenario honours
all BENCH_* env knobs). Times each hot-path piece warm, every timing
loop fenced with block_until_ready.

Usage: python scripts/profile_step.py [res_scale] [warmup_steps]
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
    def bench(fn, *args, reps=10):
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
    warm = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    from bench import _dfg_scenario

    bench = make_bench()
    sc = _dfg_scenario()
    s = sc.solver
    form = s.form
    print(f"dofs={s.V.num_global_dofs + s.Q.num_global_dofs} "
          f"pc={s.pc_inner_method} m_u={s.pc_inner_u} m_p={s.pc_inner_p} "
          f"lag={s.pc_lag_steps}", flush=True)

    # march into the developed regime so the profiled state is the one
    # the production steps/s number is about
    t0 = time.perf_counter()
    s.solveStep()
    _fence(s.u_sol)
    print(f"step 1 (compile+exec): {time.perf_counter()-t0:8.1f} s",
          flush=True)
    for _ in range(warm - 1):
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
        s.solveStep()
    _fence(s.u_sol)

    prm = s.params()
    u, p, aux = s.u_prev, s.p_prev, s._aux()
    bc_u_vals, bc_p_vals = s._bc_values()

    # -- the two production executables, end to end -------------------
    if getattr(s, "_reuse_step", None) is not None:
        t = bench(s._build_op_state, u, p, aux, prm, reps=3)
        print(f"build_op_state:      {t*1e3:9.2f} ms", flush=True)
        op = s._op_state
        t = bench(
            lambda: s._reuse_step(u, p, aux, bc_u_vals, bc_p_vals,
                                  prm, op),
            reps=3,
        )
        print(f"reuse_step (full):   {t*1e3:9.2f} ms "
              f"(stats: {jax.device_get(s.last_stats) if s.last_stats else None})",
              flush=True)

    # -- pieces ---------------------------------------------------------
    t = bench(jax.jit(lambda u, p: form.residual(u, p, aux, prm)), u, p)
    print(f"residual:            {t*1e3:9.2f} ms", flush=True)

    jac = jax.jit(lambda u, p: form.element_jacobians(u, p, aux, prm))
    A_cells, A_blocks = jac(u, p)
    t = bench(jac, u, p)
    print(f"element_jacobians:   {t*1e3:9.2f} ms", flush=True)

    bsr = s._nodebsr
    if bsr is None:
        from cfdtpu.la.nodebsr import NodeBSR

        bsr = NodeBSR(form)
    asm = jax.jit(bsr.assemble)
    vals = asm(A_cells, A_blocks)
    t = bench(asm, A_cells, A_blocks)
    print(f"bsr.assemble:        {t*1e3:9.2f} ms", flush=True)

    v = jnp.ones((form.n_flat,), form.dtype)
    mv = jax.jit(lambda v: bsr.apply_element_matrices(vals, (), v))
    t = bench(mv, v, reps=30)
    print(f"matvec (full):       {t*1e3:9.2f} ms", flush=True)

    # -- the tuned PC apply, exactly as the solver builds it ----------
    from cfdtpu.la.gmres import fgmres
    from cfdtpu.la.schur import (
        build_schur_state, make_schur_precond_from_state,
    )

    n_u = form.n_u_flat
    dim = s.mesh.gdim
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
    bld = jax.jit(lambda vals: build_schur_state(
        bsr, vals, (), bc_mask_u, True, **pc_kw))
    pc_state = bld(vals)
    t = bench(bld, vals, reps=3)
    print(f"schur pc build:      {t*1e3:9.2f} ms", flush=True)
    pc = make_schur_precond_from_state(bsr, pc_state, bc_mask_u, True,
                                       **pc_kw)
    pc_j = jax.jit(pc)
    t = bench(pc_j, v, reps=10)
    print(f"tuned PC apply:      {t*1e3:9.2f} ms", flush=True)

    def outer(b):
        x, info = fgmres(mv, b, precond=pc, restart=10, maxiter=10,
                         rtol=1e-12)
        return x

    t = bench(jax.jit(outer), v, reps=3)
    print(f"10 outer fgmres its: {t*1e3:9.2f} ms", flush=True)

    # -- sustained multi-step wall (the bench.py measurement itself) --
    t0 = time.perf_counter()
    for _ in range(4):
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
        s.solveStep()
    _fence(s.u_sol)
    wall = time.perf_counter() - t0
    print(f"4 production steps:  {wall:9.2f} s "
          f"({4/wall:.3f} steps/s)", flush=True)


if __name__ == "__main__":
    main()
