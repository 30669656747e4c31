"""Offline DFG 2D-2 (unsteady, Re = 100) validation campaign.

Runs the pipe_cylinder_2d2 scenario until the vortex shedding is
developed, then compares c_Dmax / c_Lmax / Strouhal against the shipped
FEATFLOW reference series and the published intervals
(cfdtpu/validation/dfg.py DFG_2D2_INTERVALS).

Resumable: the run checkpoints every 200 steps into a DETERMINISTIC
per-resolution output dir and auto-resumes from it, and the force
series is flushed incrementally (bdforces_partial.txt), so an
interrupted campaign loses at most ~64 steps of series and a rerun
finishes it. Exit code is nonzero until the march actually reaches T.

Usage: python scripts/validate_dfg2d2.py [res_scale] [T] [dt]
Defaults: res_scale 0.5, T 12, dt 0.0025 — several hours on CPU; raise
res_scale for a smoke run.
"""

import sys

import numpy as np


def main():
    res_scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.5
    T = float(sys.argv[2]) if len(sys.argv) > 2 else 12.0
    dt = float(sys.argv[3]) if len(sys.argv) > 3 else 0.0025

    from cfdtpu.scenarios.pipe_cylinder import PipeCylinder2D2Simulation
    from cfdtpu.validation.dfg import (
        DFG_2D2_INTERVALS, dfg_2d2_series_stats, featflow_reference_stats,
    )

    import json
    import os

    # tuned transient config (round-3): the shedding march moves little
    # per step at dt ~ 0.0025, so cross-step operator/PC reuse and
    # batched stats are safe and ~2x wall-clock; override/extend with
    # DFG2D2_KW='{"...": ...}'.
    kw = {
        "pc_inner_method": "rasamg_sup", "pc_inner_u": 0,
        "pc_inner_p": 3, "pc_ras_size": 32,
        "snes_lag_jacobian": True, "pc_lag_steps": 4, "stats_every": 5,
        "checkpoint_every": 200,
    }
    kw.update(json.loads(os.environ.get("DFG2D2_KW", "{}")))
    out = f"results_dfg2d2_{res_scale}"
    ckpt = os.path.join(out, "checkpoint.npz")
    if os.path.exists(ckpt):
        kw["resume_from"] = ckpt
    sc = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=dt, T=T, res_scale=res_scale, **kw,
    )
    complete = True
    try:
        sc.solve(out)
    except Exception as e:  # noqa: BLE001 — report partial series anyway
        complete = False
        print(f"[validate_dfg2d2] solve raised {type(e).__name__}: {e}; "
              "reporting the flushed partial series")

    src = os.path.join(out, "bdforces.txt")
    if not complete or not os.path.exists(src):
        src = os.path.join(out, "bdforces_partial.txt")
    rows = np.loadtxt(src, ndmin=2)
    if rows.size == 0:
        print("[validate_dfg2d2] no force rows flushed yet")
        return 1
    t, cd, cl = rows[:, 1], rows[:, 2], rows[:, 3]
    t_end = float(t[-1])
    complete = complete and t_end >= T - 2 * dt
    stats = dfg_2d2_series_stats(t, cd, cl, n_periods=3)
    print(f"computed:  cd_max={stats['cd_max']:.4f} "
          f"cl_max={stats['cl_max']:.4f} St={stats['strouhal']:.4f} "
          f"(t_end={t_end:.3f}, complete={complete})")
    ref = featflow_reference_stats(4, 3)
    print(f"featflow:  cd_max={ref['cd_max']:.4f} "
          f"cl_max={ref['cl_max']:.4f} St={ref['strouhal']:.4f}")
    print(f"published: {DFG_2D2_INTERVALS}")
    print(f"series in {src}")
    return 0 if complete else 1


if __name__ == "__main__":
    sys.exit(main())
