"""DFG 2D-1 (steady, Re = 20) accuracy campaign driver.

Marches the dfg_1 scenario to steady state and reports c_D, c_L
(reaction-force evaluation) and dp against the published
Schaefer-Turek intervals (cfdtpu/validation/dfg.py). Round-1 landed
c_D inside the interval at 78k DOF with c_L +3.3% / dp -2.4% outside;
this campaign pushes resolution.

Usage: python scripts/validate_dfg2d1.py [res_scale] [dt] [tol] [T]
T caps the march (default 60 = 300 steps at dt 0.2: the Re=20 steady
state is reached by t ~ 15; float32 runs may never hit a tight relative
early-stop, so the cap bounds the campaign).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    res_scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
    dt = float(sys.argv[2]) if len(sys.argv) > 2 else 0.2
    tol = float(sys.argv[3]) if len(sys.argv) > 3 else 2e-6
    T = float(sys.argv[4]) if len(sys.argv) > 4 else 18.0
    extra = json.loads(sys.argv[5]) if len(sys.argv) > 5 else {}

    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark
    from cfdtpu.validation.dfg import check_dfg_2d1

    # "solver" in the extra JSON picks the variant — e.g.
    # stabilized_schur_ramping: the impulsive dt=0.2 start is Newton-
    # hostile for P2 (measured: ~100 chord-slow iterations on the first
    # steps); ramping the lid/inflow over 10 steps reaches the same
    # steady state with ordinary per-step Newton counts.
    solver_name = extra.pop("solver", "stabilized_schur")
    # deterministic per-config output dir + periodic checkpoints,
    # auto-resumed: a long march interrupted by a timeout continues from
    # the last checkpoint when rerun
    import os

    tag = extra.pop("tag", "")
    outdir = f"results_dfg2d1_{res_scale}{'_' + tag if tag else ''}"
    extra.setdefault("checkpoint_every", 50)
    ckpt = os.path.join(outdir, "checkpoint.npz")
    if os.path.exists(ckpt):
        extra["resume_from"] = ckpt

    t0 = time.time()
    sc = DFG1Benchmark(
        solver_name, dt=dt, T=T, res_scale=res_scale,
        dtype="auto", early_stop_tolerance=tol, **extra,
    )
    out = sc.solve(outdir)
    wall = time.time() - t0

    fdr, flr = sc.compute_drag_lift(method="reaction")
    fdl, fll = sc.compute_drag_lift(method="line")
    dp = sc.compute_pressure_diff()
    res = check_dfg_2d1(500 * fdr, 500 * flr, dp)
    ndofs = sc.solver.V.num_global_dofs + sc.solver.Q.num_global_dofs
    print(json.dumps({
        "dofs": ndofs, "res_scale": res_scale, "dt": dt,
        "steps": sc.solver.step_count, "wall_s": round(wall, 1),
        "cd_reaction": 500 * fdr, "cl_reaction": 500 * flr,
        "cd_line": 500 * fdl, "cl_line": 500 * fll, "dp": dp,
        "check": {k: {"inside": v["inside"],
                      "rel_err": round(v["rel_err"], 5)}
                  for k, v in res.items()},
    }, indent=1))
    print(f"outputs in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
