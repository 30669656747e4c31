"""DFG 2D-1 benchmark smoke test + mesh generator quality checks.

The full benchmark (steady state, c_D in [5.57, 5.59], c_L in
[0.0104, 0.0110], dp in [0.1172, 0.1176] per the DFG reference intervals)
runs too long for CI; scripts/run_dfg_benchmark.py runs it to convergence.
Here: a few coarse steps must converge and produce plausible functionals.
"""

import numpy as np
import pytest

from cfdtpu.geom.delaunay2d import generate_mesh_2d, polyline_loop


def test_mesh_generator_quality():
    L, H, cx, cy, r = 2.2, 0.41, 0.2, 0.2, 0.05
    res_min, res_max = r / 3, H / 8  # coarse for speed

    def size_fn(x):
        d = np.hypot(x[0] - cx, x[1] - cy) - r
        t = np.clip((d - r) / (2 * H - r), 0, 1)
        return res_min + (res_max - res_min) * t

    outer = polyline_loop([(0, 0), (L, 0), (L, H), (0, H)], size_fn)
    nth = max(8, int(round(2 * np.pi * r / res_min)))
    th = np.linspace(0, 2 * np.pi, nth, endpoint=False)
    hole = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], -1)
    m = generate_mesh_2d(outer, [hole], size_fn)

    P = m.points[m.cells]
    a = P[:, 1] - P[:, 0]
    b = P[:, 2] - P[:, 0]
    c = P[:, 2] - P[:, 1]
    la, lb, lc = [np.linalg.norm(v, axis=1) for v in (a, b, c)]
    area = 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    q = 4 * np.sqrt(3) * area / (la ** 2 + lb ** 2 + lc ** 2)
    assert q.min() > 0.2, f"degenerate triangle, q_min={q.min()}"
    assert q.mean() > 0.8
    assert abs(area.sum() - (L * H - np.pi * r * r)) < 2e-3


@pytest.fixture(scope="module")
def dfg():
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

    sc = DFG1Benchmark(
        "stabilized_schur", dt=0.05, T=0.5, res_scale=2.5,
        early_stop_tolerance=1e-8, output_every=100,
    )
    s = sc.solver
    for _ in range(6):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return sc


def test_dfg_converges(dfg):
    assert dfg.solver.last_stats["converged"]
    u = np.asarray(dfg.solver.u_sol)
    assert u[:, 0].max() < 0.6  # bounded by ~1.5x inlet max


def test_dfg_functionals_plausible(dfg):
    fd, fl = dfg.compute_drag_lift()
    cd, cl = 500 * fd, 500 * fl
    fdr, flr = dfg.compute_drag_lift(method="reaction")
    assert 2.0 < 500 * fdr < 12.0
    # coarse mesh + short horizon: order-of-magnitude window around the
    # reference interval c_D ~ 5.58
    assert 2.0 < cd < 12.0, cd
    assert abs(cl) < 1.0, cl
    dp = dfg.compute_pressure_diff()
    assert 0.05 < dp < 0.3, dp


def test_featflow_reference_data():
    """The shipped FEATFLOW DFG 2D-2 series (reference repo oracle,
    /root/reference/src/benchmark_data/pipe_cylinder) loads and its
    statistics are consistent with the published intervals."""
    from cfdtpu.validation.dfg import (
        DFG_2D2_INTERVALS, featflow_reference_stats,
    )

    st3 = featflow_reference_stats(3, 3)
    st4 = featflow_reference_stats(4, 3)
    lo, hi = DFG_2D2_INTERVALS["strouhal"]
    assert lo <= st3["strouhal"] <= hi
    assert lo <= st4["strouhal"] <= hi
    # cd_max converges toward the published interval with level
    cd_lo = DFG_2D2_INTERVALS["cd_max"][0]
    assert abs(st4["cd_max"] - cd_lo) < abs(st3["cd_max"] - cd_lo)
    assert 0.9 < st4["cl_max"] < 1.1


def test_pipe_cylinder_2d2_records_forces(tmp_path):
    """Two coarse steps of the unsteady 2D-2 scenario produce a finite
    bdforces series with the FEATFLOW column convention."""
    import numpy as np

    from cfdtpu.scenarios.pipe_cylinder import PipeCylinder2D2Simulation

    sc = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=0.01, T=0.02, res_scale=3.0,
    )
    out = sc.solve(str(tmp_path))
    rows = np.asarray(sc._force_rows)
    assert rows.shape[0] == 2 and rows.shape[1] == 4
    assert np.isfinite(rows).all()
    data = np.loadtxt(f"{out}/bdforces.txt")
    assert data.shape == rows.shape


def test_dfg_2d2_series_stats_reproduces_featflow():
    """The series-stats helper must reproduce the known quantities of
    the shipped FEATFLOW oracles (reference consumes the same files:
    src/benchmark_data/pipe_cylinder/bdforces_q2_lv*_dt3). Facts pinned:
    St is inside the published [0.295, 0.305] from level 3 up; cd_max /
    cl_max increase monotonically with mesh level toward the published
    intervals (established at finer levels than the shipped subset)."""
    from cfdtpu.validation.dfg import (
        DFG_2D2_INTERVALS, check_dfg_2d2, featflow_reference_stats,
    )

    stats = {lv: featflow_reference_stats(level=lv, n_periods=5)
             for lv in (2, 3, 4)}
    # developed-regime window: last 5 shedding periods, all late-time
    for lv in (2, 3, 4):
        assert stats[lv]["t_range"][0] > 5.0
        assert stats[lv]["n_crossings"] == 6
    # pinned values for the lv3 series (regression anchors)
    assert abs(stats[3]["strouhal"] - 0.3021) < 5e-4
    assert abs(stats[3]["cd_max"] - 3.1625) < 2e-3
    assert abs(stats[3]["cl_max"] - 0.9795) < 2e-3
    for lv in (3, 4):
        chk = check_dfg_2d2(stats[lv])
        assert chk["strouhal"]["inside"], stats[lv]
    # mesh convergence toward the published intervals
    assert stats[2]["cd_max"] < stats[3]["cd_max"] < stats[4]["cd_max"]
    assert stats[2]["cl_max"] < stats[3]["cl_max"] < stats[4]["cl_max"]
    lo, _ = DFG_2D2_INTERVALS["cd_max"]
    assert stats[4]["cd_max"] < lo + 0.03  # lv4 approaches the band


def test_pipe_cylinder_2d2_resume_appends_series(tmp_path):
    """A checkpointed 2D-2 run resumed mid-march must append to the
    incrementally-flushed force series (bdforces_partial.txt) so a
    interrupted campaign keeps a contiguous series across
    legs (scripts/validate_dfg2d2.py resumability)."""
    import numpy as np

    from cfdtpu.scenarios.pipe_cylinder import PipeCylinder2D2Simulation

    out = str(tmp_path / "run")
    sc = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=0.01, T=0.02, res_scale=3.0,
        checkpoint_every=2,
    )
    sc.solve(out)
    ck = tmp_path / "run" / "checkpoint.npz"
    assert ck.exists()
    part1 = np.loadtxt(tmp_path / "run" / "bdforces_partial.txt", ndmin=2)
    assert part1.shape[0] == 2

    sc2 = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=0.01, T=0.04, res_scale=3.0,
        checkpoint_every=2, resume_from=str(ck),
    )
    sc2.solve(out)
    part2 = np.loadtxt(tmp_path / "run" / "bdforces_partial.txt", ndmin=2)
    full = np.loadtxt(tmp_path / "run" / "bdforces.txt", ndmin=2)
    assert part2.shape[0] == 4 and full.shape[0] == 4
    # contiguous indices and times across the resume boundary
    assert list(full[:, 0]) == [0, 1, 2, 3]
    assert np.all(np.diff(full[:, 1]) > 0)
    # leg-1 rows unchanged by the resumed leg
    np.testing.assert_allclose(full[:2], part1, rtol=1e-12)
    assert np.isfinite(full).all()


def test_pipe_cylinder_2d2_resume_reconciles_misaligned_series(tmp_path):
    """Resuming from a checkpoint OLDER than the last series flush must
    truncate the partial force series back to the checkpoint step —
    otherwise the resumed leg re-records duplicate rows with time
    jumping backward, which breaks the zero-crossing Strouhal stats
    (flush cadence and checkpoint cadence are independent in a
    killed campaign leg)."""
    import shutil

    import numpy as np

    from cfdtpu.scenarios.pipe_cylinder import PipeCylinder2D2Simulation

    out = str(tmp_path / "run")
    ck = tmp_path / "run" / "checkpoint.npz"
    ck_old = tmp_path / "ck_step2.npz"

    def grab_old_checkpoint(t):
        # after step 3's callback the newest checkpoint on disk is the
        # step-2 one (base.solve saves AFTER the callback)
        if abs(t - 0.03) < 1e-9 and ck.exists() and not ck_old.exists():
            shutil.copy(ck, ck_old)

    sc = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=0.01, T=0.04, res_scale=3.0,
        checkpoint_every=2,
    )
    sc.solve(out, afterStepCallback=grab_old_checkpoint)
    assert int(np.load(ck_old)["step"]) == 2
    part1 = np.loadtxt(tmp_path / "run" / "bdforces_partial.txt", ndmin=2)
    assert part1.shape[0] == 4  # flushed past the old checkpoint

    sc2 = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=0.01, T=0.05, res_scale=3.0,
        checkpoint_every=2, resume_from=str(ck_old),
    )
    sc2.solve(out)
    full = np.loadtxt(tmp_path / "run" / "bdforces.txt", ndmin=2)
    # steps 3-4 re-run from the step-2 checkpoint, then step 5: exactly
    # one row per step, contiguous indices, strictly monotonic time
    assert full.shape[0] == 5
    assert list(full[:, 0]) == [0, 1, 2, 3, 4]
    assert np.all(np.diff(full[:, 1]) > 0)
    np.testing.assert_allclose(full[:2], part1[:2], rtol=1e-12)
