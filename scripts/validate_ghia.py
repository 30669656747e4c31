"""Ghia lid-driven-cavity validation at Re = 100 / 400 / 1000.

Marches the cavity to steady state with BDF2 pseudo-time stepping and
compares the vertical-centerline u(y) profile against the published
Ghia, Ghia & Shin (1982) Table I values shipped in
cfdtpu/validation/ghia.py (the reference frameworks ships the same data
as CSVs, /root/reference/src/benchmark_data/lid_driven2D/). Prints one
line per Re with the max/rms profile deviation for VALIDATION.md.

Usage: python scripts/validate_ghia.py [Re ...]   (default: 100 400 1000)
Grid/march defaults scale with Re.
"""

import sys
import time

import numpy as np


CASES = {
    # Re: (nx, dt, n_steps)  -- dt in convective units, BDF2 march
    100: (64, 0.5, 40),
    400: (96, 0.5, 80),
    1000: (128, 0.5, 160),
}


def run(re, nx=None, dt=None, n_steps=None, quiet=False):
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation
    from cfdtpu.postprocess import eval_at_points
    from cfdtpu.validation import GHIA_U_CENTERLINE

    nx0, dt0, ns0 = CASES[re]
    nx, dt = nx or nx0, dt or dt0
    n_steps = n_steps or ns0
    sc = LidDriven2DSimulation(
        "stabilized_schur_bdf2", dt=dt, T=1e9, mu=1.0 / re, nx=nx,
        dtype="auto",
    )
    s = sc.solver
    t0 = time.perf_counter()
    prev = None
    for i in range(n_steps):
        s.t = (i + 1) * dt
        s.solveStep()
        u = np.asarray(s.u_sol)
        if prev is not None:
            rel = np.abs(u - prev).max() / max(np.abs(u).max(), 1e-12)
            if rel < 1e-6:
                if not quiet:
                    print(f"  steady at step {i + 1} (rel du {rel:.1e})")
                break
            prev = u
        else:
            prev = u
        # BDF2's u_prev2 <- u_prev rotation happens in _post_step
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    el = time.perf_counter() - t0

    y, u_bench = GHIA_U_CENTERLINE[re]
    pts = np.stack([np.full_like(y, 0.5), y], axis=-1)
    u_sol = eval_at_points(sc.solver.V, np.asarray(s.u_sol), pts)[:, 0]
    err = u_sol - u_bench
    print(
        f"Re={re} nx={nx}: max|err|={np.abs(err).max():.4f} "
        f"rms={np.sqrt(np.mean(err ** 2)):.4f}  ({el:.0f}s)",
        flush=True,
    )
    return np.abs(err).max()


def main():
    res = [int(a) for a in sys.argv[1:]] or [100, 400, 1000]
    for re in res:
        run(re)


if __name__ == "__main__":
    main()
