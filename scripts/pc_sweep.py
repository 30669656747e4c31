"""PC-configuration sweep on the DFG bench at a given size.

Usage: python scripts/pc_sweep.py [res_scale]
Each config rebuilds the scenario (mesh is regenerated; compile is the
dominant cost). Prints steps/s + iteration counts per config.
"""

import sys
import time

import jax


def run(res_scale, steps=3, dt=0.05, **kw):
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

    sc = DFG1Benchmark(
        "stabilized_schur", dt=dt, T=1e9, res_scale=res_scale,
        dtype="auto", **kw,
    )
    s = sc.solver
    s.solveStep()
    s.u_prev, s.p_prev = s.u_sol, s.p_sol
    t0 = time.perf_counter()
    ksp = 0
    for _ in range(steps):
        s.solveStep()
        ksp += s.last_stats["ksp_iters"]
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    jax.block_until_ready(s.u_sol)
    el = time.perf_counter() - t0
    print(f"CONFIG {kw}: {steps/el:.4f} steps/s  ksp/step={ksp/steps:.0f}",
          flush=True)


def main():
    res_scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
    import json, os
    dt = float(os.environ.get("SWEEP_DT", "0.05"))
    cfgs = os.environ.get("SWEEP_CONFIGS")
    cfgs = (json.loads(cfgs) if cfgs else [
        {"pc_schur_fact": "lower"},
        {"snes_ksp_ew": True},
        {"pc_amg_smooth": 2},
    ])
    for kw in cfgs:
        try:
            run(res_scale, dt=dt, **kw)
        except Exception as e:
            print(f"CONFIG {kw} FAILED: {type(e).__name__}: {e}",
                  flush=True)


if __name__ == "__main__":
    main()
