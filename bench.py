"""Benchmark: time-steps/sec of stabilized_schur on the DFG 2D-1 config.

    python bench.py

Runs one measurement in this process on the GPU and prints one JSON
line {"metric", "value", "unit", "vs_baseline", "device"}. BASELINE.json
north star: DFG 2D-1 at ~1M DOF >= 5 time-steps/sec/chip. A run that
finds no GPU fails; it does not fall back to the CPU.

Env knobs:
    BENCH_SCENARIO   dfg (default) | lid | spmv
    BENCH_RES_SCALE  DFG mesh scale; dofs ~ 9.8k / scale^2 (default 0.3
                     ~ 106k DOF)
    BENCH_NX         lid mesh size (default 64)
    BENCH_STEPS      timed steps (default 4)
    BENCH_WARMUP     un-timed steps before the window (default 6: the
                     measurement is the developed regime, not the
                     impulsive-start transient)
    BENCH_PC_*       solver PC overrides (see _dfg_scenario)
"""

import json
import os
import sys
import time

import numpy as np


def _dfg_scenario():
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

    res_scale = float(os.environ.get("BENCH_RES_SCALE", "0.3"))
    # Tuned configuration (PERF.md): near-true-Schur S-stage with
    # RAS-smoothed block-AMG on A_uu, preonly u-stage, chord Newton
    # within the step, operator/PC carried across steps.
    kw = {
        "pc_inner_method": "rasamg_sup",
        "pc_inner_u": 0,
        "pc_inner_p": int(os.environ.get("BENCH_PC_INNER_P", "5")),
        "snes_lag_jacobian": True,
        "pc_ras_size": 32,
        "pc_lag_steps": int(os.environ.get("BENCH_PC_LAG_STEPS", "4")),
        # fetch/check convergence once per rebuild period: the reuse
        # steps stay on the async dispatch queue in between
        "stats_every": int(os.environ.get("BENCH_STATS_EVERY", "4")),
    }
    if os.environ.get("BENCH_PC_METHOD"):
        kw["pc_inner_method"] = os.environ["BENCH_PC_METHOD"]
    if os.environ.get("BENCH_PC_INNER_U"):
        kw["pc_inner_u"] = int(os.environ["BENCH_PC_INNER_U"])
    if os.environ.get("BENCH_RAS_SIZE"):
        kw["pc_ras_size"] = int(os.environ["BENCH_RAS_SIZE"])
    if os.environ.get("BENCH_JAC_LAG"):
        kw["snes_lag_jacobian"] = os.environ["BENCH_JAC_LAG"] != "0"
    if os.environ.get("BENCH_AMG_KCYCLE"):
        kw["pc_amg_kcycle"] = os.environ["BENCH_AMG_KCYCLE"] != "0"
    if os.environ.get("BENCH_AMG_WCYCLE"):
        kw["pc_amg_wcycle"] = os.environ["BENCH_AMG_WCYCLE"] != "0"
    if os.environ.get("BENCH_AMG_CHEBY"):
        kw["pc_amg_cheby"] = int(os.environ["BENCH_AMG_CHEBY"])
    if os.environ.get("BENCH_SUPERNODE_G"):
        kw["supernode_g"] = int(os.environ["BENCH_SUPERNODE_G"])
    if os.environ.get("BENCH_PC_DTYPE"):
        kw["pc_dtype"] = os.environ["BENCH_PC_DTYPE"]
    if os.environ.get("BENCH_SCHUR_FACT"):
        kw["pc_schur_fact"] = os.environ["BENCH_SCHUR_FACT"]
    if os.environ.get("BENCH_EW"):
        kw["snes_ksp_ew"] = os.environ["BENCH_EW"] != "0"
    if os.environ.get("BENCH_AMG_SMOOTH"):
        kw["pc_amg_smooth"] = int(os.environ["BENCH_AMG_SMOOTH"])
    if os.environ.get("BENCH_KSP_RESTART"):
        kw["ksp_restart"] = int(os.environ["BENCH_KSP_RESTART"])
    if os.environ.get("BENCH_SNES_MAX_IT"):
        # pathology bound for huge meshes: a stalled solve otherwise
        # runs the in-jit while_loops toward snes_max*ksp_max (100x1000)
        # iterations in one device op
        kw["snes_max_it"] = int(os.environ["BENCH_SNES_MAX_IT"])
    if os.environ.get("BENCH_KSP_MAX_IT"):
        kw["ksp_max_it"] = int(os.environ["BENCH_KSP_MAX_IT"])
    if os.environ.get("BENCH_KSP_ORTHO_CHUNK"):
        kw["ksp_ortho_chunk"] = int(os.environ["BENCH_KSP_ORTHO_CHUNK"])
    elif res_scale >= 0.3:
        # restart 20 at the official 106k-and-smaller sizes: the
        # developed regime runs ~9.5 ksp per solve (CPU count, PERF.md),
        # so nothing truncates. Larger meshes keep the solver default,
        # since their iteration counts can exceed 20 per solve.
        kw["ksp_restart"] = 20
    return DFG1Benchmark(
        "stabilized_schur", dt=0.05, T=1e9, res_scale=res_scale,
        dtype="auto", **kw,
    )


def _bench_dfg(steps: int):
    sc = _dfg_scenario()
    s = sc.solver
    # warmup: step 1 pays the compile; the remaining warmup steps
    # (BENCH_WARMUP, default 6) move the measurement window out of the
    # impulsive-start transient (~4-5 Newton its/step there) into the
    # developed regime (1 Newton, ~9 ksp/step at 106k)
    for _ in range(int(os.environ.get("BENCH_WARMUP", "6"))):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    s.u_sol.block_until_ready()

    ndofs = s.V.num_global_dofs + s.Q.num_global_dofs
    t0 = time.perf_counter()
    checked = {}
    for _ in range(steps):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
        if "ksp_iters" in (s.last_stats or {}):
            checked = s.last_stats
    s.u_sol.block_until_ready()
    elapsed = time.perf_counter() - t0
    # iteration counts of the last checked step: they say whether a slow
    # window came from PC iteration growth or per-iteration cost
    extra = {
        k: int(v) for k, v in checked.items()
        if k in ("newton_iters", "ksp_iters")
    }
    return f"dfg_2d1_{ndofs}dof", steps / elapsed, "steps/sec/chip", extra


def _bench_lid(steps: int):
    from __graft_entry__ import _build

    nx = int(os.environ.get("BENCH_NX", "64"))
    solver, args = _build(nx=nx, dtype=np.float32)
    u_prev, p_prev, aux, bc_u, bc_p, prm = args
    u, p, *_ = solver._step(u_prev, p_prev, aux, bc_u, bc_p, prm)
    u.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(steps):
        u, p, *_ = solver._step(u, p, (u,), bc_u, bc_p, prm)
    u.block_until_ready()
    elapsed = time.perf_counter() - t0
    ndofs = solver.V.num_global_dofs + solver.Q.num_global_dofs
    return f"lid_driven2D_{ndofs}dof", steps / elapsed, "steps/sec/chip"


def _bench_spmv(reps: int):
    """Element-block operator application bandwidth (the BASELINE 'SpMV
    GB/s' metric): gather -> batched (nloc x nloc) matmul -> sorted
    segment-sum scatter."""
    import jax
    import jax.numpy as jnp

    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

    res_scale = float(os.environ.get("BENCH_RES_SCALE", "0.3"))
    sc = DFG1Benchmark(
        "stabilized_schur", dt=0.05, T=1e9, res_scale=res_scale,
        dtype="auto",
    )
    s = sc.solver
    form = s.form
    prm = s.params()
    A_cells, A_blocks = jax.jit(
        lambda u, p: form.element_jacobians(u, p, (u,), prm)
    )(s.u_prev, s.p_prev)
    v = jnp.ones((form.n_flat,), form.dtype)
    itemsize = np.dtype(form.dtype).itemsize
    fmt = os.environ.get("BENCH_SPMV_FORMAT", "node_bsr")
    if fmt == "node_bsr":
        # production matvec: assembled node-block BSR (la/nodebsr.py)
        from cfdtpu.la.nodebsr import NodeBSR

        bsr = NodeBSR(form)
        vals = jax.jit(bsr.assemble)(A_cells, A_blocks)
        mv = jax.jit(lambda v: bsr.apply_element_matrices(vals, (), v))
        if "sup" in vals:  # supernode layout (la/superell.py)
            key = "sup"
            n_rows = bsr._sup.ns * bsr._sup.Kg
            row_w = bsr.g * bsr.bs
            label = f"spmv_sup_{bsr.n_blocks}blk"
        else:
            key = "ell"
            n_rows = bsr.n_nodes * bsr.K
            row_w = bsr.bs
            label = f"spmv_bsr_{bsr.n_blocks}blk"
        nbytes = vals[key].size * itemsize      # block values (dominant)
        nbytes += n_rows * 4                    # column indices
        nbytes += 2 * n_rows * row_w * itemsize  # gather-in + row out
    else:
        mv = jax.jit(
            lambda v: form.apply_element_matrices(A_cells, A_blocks, v)
        )
        nc = form.mesh.num_cells
        nloc = form.nloc
        nbytes = nc * nloc * nloc * itemsize  # A stream (dominant)
        nbytes += 3 * nc * nloc * itemsize    # gather-in, out, scatter
        label = f"spmv_{nc}cells"
    mv(v).block_until_ready()  # compile
    reps = max(reps, 50)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = mv(v)
    y.block_until_ready()
    elapsed = (time.perf_counter() - t0) / reps
    return label, nbytes / elapsed / 1e9, "GB/s"


def main():
    from cfdtpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX runs on {devices[0].platform}"
        )
    steps = int(os.environ.get("BENCH_STEPS", "4"))
    scenario = os.environ.get("BENCH_SCENARIO", "dfg")
    extra = {}
    if scenario == "lid":
        name, val, unit = _bench_lid(steps)
    elif scenario == "spmv":
        name, val, unit = _bench_spmv(steps)
    else:
        name, val, unit, extra = _bench_dfg(steps)
    vs = val / 5.0 if unit.startswith("steps") else val / 100.0
    print(json.dumps({
        "metric": f"{name}_{unit.split('/')[0]}",
        "value": float(val),
        "unit": unit,
        "vs_baseline": float(vs),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        **extra,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
