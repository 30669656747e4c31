"""Hemodynamic BC suite tests: curl-curl solvers, stenosis scenario, IPCS."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.test_variants import ChannelScenario, _parabolic


def test_pressurebc_channel(tmp_path):
    sc = ChannelScenario(
        "stabilized_schur_pressurebc", dt=0.05, T=0.15,
        p_inlet=1.0, p_outlet=0.0,
    )
    sc.solve(str(tmp_path))
    u = np.asarray(sc.solver.u_sol)
    assert sc.solver.last_stats["converged"]
    assert u[:, 0].max() > 0.03  # pressure-driven flow develops
    # Nitsche keeps tangential velocity small at both ends
    for xval in (0.0, 2.0):
        dofs = sc.solver.V.locate_dofs_geometrical(
            lambda x, xv=xval: np.isclose(x[0], xv)
        )
        assert abs(u[dofs, 1]).max() < 0.15 * abs(u[:, 0]).max()


def test_vascularbc_fixed_point(tmp_path):
    sc = ChannelScenario(
        "stabilized_schur_vascularbc", dt=0.05, T=0.2,
        p_inlet=1.0, R_resistance=1.0,
    )
    sc.solve(str(tmp_path))
    s = sc.solver
    assert s.last_stats["converged"]
    # resistance fixed point tracked a positive outlet pressure
    assert s.p_outlet_w > 0
    Q = s.outlet_flux()
    assert abs(s.p_outlet_w * 2 - s.R_resistance * abs(Q)) < 0.5


def test_vascularbc_weak_and_backflow(tmp_path):
    for solver in (
        "stabilized_schur_vascularbc_weak",
        "stabilized_schur_vascularbc_backflow",
    ):
        sc = ChannelScenario(
            solver, dt=0.05, T=0.1, p_inlet=1.0, R_resistance=1.0,
        )
        sc.solve(str(tmp_path / solver.split("_")[-1]))
        assert sc.solver.last_stats["converged"], solver


def test_cbc_and_ddn(tmp_path):
    for solver in (
        "stabilized_schur_vascularbc_cbc",
        "stabilized_schur_vascularbc_ddn",
    ):
        sc = ChannelScenario(
            solver, dt=0.05, T=0.1,
            inlet_velocity=_parabolic, v_max=1.0,
        )
        sc.solve(str(tmp_path / solver.split("_")[-1]))
        assert sc.solver.last_stats["converged"], solver
        u = np.asarray(sc.solver.u_sol)
        assert u[:, 0].max() > 0.3, solver


def test_velocity_vascular_backflow(tmp_path):
    sc = ChannelScenario(
        "stabilized_schur_velocity_vascular_backflow", dt=0.05, T=0.15,
        inlet_velocity=_parabolic, v_max=1.0, R_resistance=1.0,
    )
    sc.solve(str(tmp_path))
    s = sc.solver
    assert s.last_stats["converged"]
    assert s.p_c > 0  # damped resistance pressure developed


def test_hex_q2_ipcs_channel():
    """Q2/Q1 Taylor-Hood IPCS on hexahedra marches a pressure-driven
    duct to a physical mean flow. Exercises the hex k=2 face-center
    dofs (spaces/space.py: the face block starts at k=2 on quad faces;
    before that fix any hex k=2 space crashed on uninitialized dofmap
    entries)."""
    from cfdtpu.scenarios.unit_cube_pipe import UnitCubePipeSimulation

    sc = UnitCubePipeSimulation(
        "ipcs_midpoint", dt=0.05, T=0.5,
        p_inlet=7.47, p_outlet=0.0, nx=6, ny=3, nz=3,
    )
    s = sc.solver
    # Q2 vector (13*7*7 = 637 scalar) + Q1 pressure (7*4*4 = 112)
    assert s.V.num_global_dofs + s.Q.num_global_dofs == 2023
    for _ in range(8):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    u = np.asarray(s.u_sol)
    assert np.isfinite(u).all()
    # dP = 7.47 Pa over 20 mm drives +x flow; measured settles ~5.8 mm/s
    assert 2.0 < u[:, 0].mean() < 20.0


def test_hex_p3_pressure_channel():
    """Degree-3 equal-order spaces on a hexahedral mesh solve a full
    Newton-Krylov step to convergence (the last element parity gap vs
    the reference's basix-arbitrary-degree support: hex k >= 3
    face-interior dofs)."""
    from cfdtpu.scenarios.unit_cube_pipe import UnitCubePipeSimulation

    sc = UnitCubePipeSimulation(
        "stabilized_schur_pressurebc", dt=0.05, T=0.05,
        p_inlet=7.47e-3, p_outlet=0.0, nx=6, ny=3, nz=3, p_grade=3,
    )
    s = sc.solver
    assert s.V.num_global_dofs + s.Q.num_global_dofs == 7600
    s.solveStep()
    assert s.last_stats["converged"]
    u = np.asarray(s.u_sol)
    assert np.isfinite(u).all()
    # the weak pressure gradient sets the impulsive-start transient in
    # motion (one dt is far from developed Poiseuille flow on this
    # short duct, so no direction assertion — measured |u|max ~ 0.64)
    assert np.abs(u).max() > 1e-2


def test_stenosis_scenario(tmp_path):
    from cfdtpu.scenarios.stenosis import StenosisSimulation

    sc = StenosisSimulation(
        "stabilized_schur_pressurebc", dt=0.005, T=0.01,
        res=0.6, output_every=10,
    )
    out = sc.solve(str(tmp_path))
    assert (tmp_path / "ffr.txt").exists()
    txt = (tmp_path / "ffr.txt").read_text()
    assert "FFR" in txt
    u = np.asarray(sc.solver.u_sol)
    assert np.isfinite(u).all()
    # blood flows towards the outlet under the 65 mmHg gradient
    assert u[:, 0].mean() > 0


def test_ipcs_midpoint_lid(tmp_path):
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation

    sc = LidDriven2DSimulation(
        "ipcs_midpoint", dt=0.005, T=0.03, mu=0.01, nx=10
    )
    sc.solve(str(tmp_path))
    u = np.asarray(sc.solver.u_sol)
    assert abs(u).max() < 1.2
    assert abs(u).max() > 0.5


def test_ipcs_bdf2_unit_square():
    from cfdtpu.scenarios.unit_square import UnitSquareSimulation

    sc = UnitSquareSimulation(
        "ipcs_bdf2", dt=0.005, T=0.04, mu=0.05, nx=8
    )
    s = sc.solver
    for _ in range(8):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    assert float(jnp.abs(s.u_sol).max()) < 1.2


def test_wss_poiseuille():
    """Wall shear stress against the plane-Poiseuille analytic value:
    tau_wall = 6 mu U_mean / H (equivalently 4 mu u_max / H). The WSS
    form mirrors solverBase.initStressForm (reference
    src/solverBase.py:120-178)."""
    import jax.numpy as jnp

    from cfdtpu.scenarios.unit_square_pipe import UnitSquarePipeSimulation

    sc = UnitSquarePipeSimulation(
        "stabilized_schur", dt=0.05, T=0.5, p_inlet=7.47, p_outlet=0.0,
        ny=10, early_stop_tolerance=1e-6, output_every=1000,
    )
    s = sc.solver
    s.initStressForm()
    for _ in range(10):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    s.assemble_wss()
    tau = np.asarray(s.shear_stress)
    # wall dofs: y = 0 or y = H
    X = np.asarray(s.V.dof_coords)
    H = X[:, 1].max()
    wall = (np.abs(X[:, 1]) < 1e-9) | (np.abs(X[:, 1] - H) < 1e-9)
    interior_x = (X[:, 0] > 0.2 * X[:, 0].max()) & (
        X[:, 0] < 0.8 * X[:, 0].max()
    )
    tw = np.linalg.norm(tau[wall & interior_x], axis=1)
    u_max = float(jnp.abs(s.u_sol[:, 0]).max())
    mu = float(s.mu)
    tau_exact = 4 * mu * u_max / H
    rel = abs(np.median(tw) - tau_exact) / tau_exact
    assert rel < 0.15, (np.median(tw), tau_exact)
