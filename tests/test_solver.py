"""Solver integration tests: lid-driven cavity smoke + convergence checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation
from cfdtpu.simulation import Simulation


@pytest.fixture(scope="module")
def lid_scenario(tmp_path_factory):
    # solved HERE so every dependent test is order-independent (the
    # solve used to live in test_lid_driven_steps, silently making the
    # BC/divergence checks depend on it having run first)
    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.05, mu=0.01, nx=12
    )
    sc._test_out = tmp_path_factory.mktemp("lid")
    sc.solve(str(sc._test_out))
    return sc


def test_lid_driven_steps(lid_scenario):
    out = lid_scenario._test_out
    u = lid_scenario.solver.u_sol
    assert float(jnp.abs(u).max()) <= 1.0 + 1e-8  # max principle-ish
    assert float(jnp.abs(u).max()) > 0.5  # lid moves the fluid
    stats = lid_scenario.solver.last_stats
    assert stats["converged"]
    assert stats["newton_iters"] <= 10
    # outputs exist
    assert (out / "norms.txt").exists()
    assert (out / "v.pvd").exists()
    assert (out / "wss.pvd").exists()


def test_ten_step_march(tmp_path):
    """>= 10 steps crosses the every-10-steps norm/early-stop fetch in
    Scenario.solve — a path no other test reached (a shadowed-import
    bug there survived a full green suite and broke every long run)."""
    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.1, mu=0.01, nx=8
    )
    sc.solve(str(tmp_path))
    assert sc.solver.step_count >= 10
    assert sc.solver.last_stats["converged"]


def test_lid_bc_enforced(lid_scenario):
    sc = lid_scenario
    V = sc.solver.V
    u = np.asarray(sc.solver.u_sol)
    lid_dofs = V.locate_dofs_geometrical(sc.lid)
    wall_dofs = V.locate_dofs_geometrical(sc.walls)
    assert np.allclose(u[lid_dofs, 0], 1.0, atol=1e-10)
    assert np.allclose(u[lid_dofs, 1], 0.0, atol=1e-10)
    assert np.allclose(u[wall_dofs], 0.0, atol=1e-10)


def test_divergence_small(lid_scenario):
    """The stabilized solution should be nearly divergence-free away from
    the lid-corner singularities (where the discontinuous BC makes the
    local divergence O(1) on any mesh)."""
    sc = lid_scenario
    form = sc.solver.form
    u = sc.solver.u_sol
    from cfdtpu.utils import det_and_inv

    u_e = u[form.dofmap_u]
    J = jnp.einsum("cvg,qvd->cqgd", form.cell_coords, form.gdphi)
    detJ, invJ = det_and_inv(J)
    gu = jnp.einsum("qbd,cqdg->cqbg", form.dphi_u, invJ)
    div = jnp.einsum("cbi,cqbi->cq", u_e, gu)
    # restrict to cells whose centroid is below y = 0.75
    centroid_y = np.asarray(form.cell_coords).mean(axis=1)[:, 1]
    mask = jnp.asarray((centroid_y < 0.75).astype(float))
    div_l2 = float(
        jnp.sqrt(
            jnp.sum(div ** 2 * jnp.abs(detJ) * form.qw[None] * mask[:, None])
        )
    )
    assert div_l2 < 0.15  # O(h) for P1-P1 PSPG at nx=12


def test_scenario_name_resolution():
    """The CLI name must resolve to the class DEFINED for that module —
    alphabetical inspect.getmembers picked PipeCylinder2D2Simulation for
    'pipe_cylinder' and an imported base for 'stenosis_with_tree_2d'."""
    from importlib import import_module

    from cfdtpu.simulation import resolve_scenario_class

    def resolve(name):
        module = import_module(f"cfdtpu.scenarios.{name}")
        cls = resolve_scenario_class(module, name)
        return cls.__name__ if cls else None

    assert resolve("pipe_cylinder") == "PipeCylinderSimulation"
    assert resolve("pipe_cylinder_2d2") == "PipeCylinder2D2"
    assert resolve("stenosis_with_tree_2d") == (
        "StenosisWithTree2DSimulation"
    )
    assert resolve("dfg_1") == "DFG1Benchmark"
    assert resolve("vascular_tree") == "MicrovasculatureSimulation"


def test_simulation_orchestrator(tmp_path):
    sim = Simulation(
        name="t",
        simulation="lid_driven2D",
        solver="stabilized_schur",
        T=0.02,
        dt=0.01,
        output_dir=str(tmp_path),
        mu=0.1,
        nx=8,
    )
    out = sim.run()
    import os

    assert os.path.exists(os.path.join(out, "simulation_params.txt"))
    params = open(os.path.join(out, "simulation_params.txt")).read()
    assert "lid_driven2D" in params
    assert "stabilized_schur" in params


def test_simulation_validation():
    with pytest.raises(ValueError):
        Simulation(name="", simulation="lid_driven2D",
                   solver="stabilized_schur", T=1, dt=0.1)
    with pytest.raises(ValueError):
        Simulation(name="x", simulation="lid_driven2D",
                   solver="stabilized_schur", T=-1, dt=0.1)
    with pytest.raises(ValueError):
        Simulation(name="x", simulation="lid_driven2D",
                   solver="stabilized_schur", T=0.01, dt=0.1)


def test_nodebsr_matches_element_operator():
    """Assembled node-BSR operator (la/nodebsr.py) must agree with the
    element-block operator to machine precision, including facet terms."""
    import jax.numpy as jnp

    from cfdtpu.forms import StabilizedNSForm
    from cfdtpu.forms.facet_terms import weak_pressure
    from cfdtpu.la.nodebsr import NodeBSR
    from cfdtpu.mesh import create_unit_square
    from cfdtpu.spaces import FunctionSpace

    mesh = create_unit_square(6, 6)
    V = FunctionSpace(mesh, 1, 2)
    Q = FunctionSpace(mesh, 1)
    form = StabilizedNSForm(V, Q)
    tags = np.arange(len(mesh.facets), dtype=np.int32)
    form.add_facet_term("weak_pressure", tags[:8], weak_pressure("p_in", 1.0))
    bsr = NodeBSR(form)

    rng = np.random.RandomState(3)
    u = jnp.asarray(rng.randn(V.num_dofs, 2))
    p = jnp.asarray(rng.randn(Q.num_dofs))
    prm = {
        "dt": jnp.asarray(0.01), "rho": jnp.asarray(1.0),
        "mu": jnp.asarray(0.01), "f": jnp.zeros(2),
        "p_in": jnp.asarray(2.0),
    }
    A, B = form.element_jacobians(u, p, (u,), prm)
    vals = bsr.assemble(A, B)
    v = jnp.asarray(rng.randn(form.n_flat))
    assert np.allclose(
        form.apply_element_matrices(A, B, v),
        bsr.apply_element_matrices(vals, (), v), atol=1e-13,
    )
    assert np.allclose(
        form.jacobian_diagonal(A, B),
        bsr.jacobian_diagonal(vals, ()), atol=1e-13,
    )
    for w in ("uu", "up", "pu", "pp"):
        nin = form.n_u_flat if w[1] == "u" else Q.num_dofs
        vv = v[:nin]
        assert np.allclose(
            form.apply_sub_block(A, B, vv, w),
            bsr.apply_sub_block(vals, (), vv, w), atol=1e-13,
        ), w


def test_amg_selfp_vcycle_contracts():
    """The aggregation-MG V-cycle on the explicit SELFP matrix must be a
    contraction (la/amg.py); plain Jacobi smoothing diverges there."""
    import jax
    import jax.numpy as jnp
    from jax import ops as jox

    from cfdtpu.forms import StabilizedNSForm
    from cfdtpu.la.nodebsr import NodeBSR
    from cfdtpu.mesh import create_unit_square
    from cfdtpu.spaces import FunctionSpace

    mesh = create_unit_square(16, 16)
    V = FunctionSpace(mesh, 1, 2)
    Q = FunctionSpace(mesh, 1)
    form = StabilizedNSForm(V, Q)
    bsr = NodeBSR(form)
    prm = {
        "dt": jnp.asarray(0.01), "rho": jnp.asarray(1.0),
        "mu": jnp.asarray(0.01), "f": jnp.zeros(2),
    }
    u = jnp.zeros((V.num_dofs, 2))
    A, B = form.element_jacobians(u, jnp.zeros(Q.num_dofs), (u,), prm)
    vals = bsr.assemble(A, B)
    sp = bsr.sp_vals(vals)
    amg = bsr.sp_amg()
    built = jax.jit(amg.build)(sp)
    row, col, _ = amg.coo[0]

    def mv(x):
        return jox.segment_sum(
            sp * x[col], row, num_segments=bsr.n_nodes,
            indices_are_sorted=True,
        )

    rng = np.random.RandomState(0)
    b = jnp.asarray(rng.randn(bsr.n_nodes))
    b = b - b.mean()
    x = jnp.zeros_like(b)
    r = b
    for _ in range(6):
        z = amg.v_cycle(built, r)
        x = x + z
        x = x - x.mean()
        r = b - mv(x)
        r = r - r.mean()
    rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
    assert rel < 0.05, rel

    # W-cycle (gamma=2, linear): same 6 iterations must contract at
    # least as hard as the V-cycle — it compounds the coarse correction
    amg.wcycle = True
    xw = jnp.zeros_like(b)
    rw = b
    for _ in range(6):
        z = amg.v_cycle(built, rw)
        xw = xw + z
        xw = xw - xw.mean()
        rw = b - mv(xw)
        rw = rw - rw.mean()
    amg.wcycle = False
    rel_w = float(jnp.linalg.norm(rw) / jnp.linalg.norm(b))
    assert rel_w <= rel * 1.05, (rel_w, rel)


def test_linear_parents_reproduce_coords():
    """FunctionSpace.linear_parents() must reproduce every nodal
    coordinate from the vertex coordinates (exact linear embedding) —
    the property the p-multigrid transfer level (la/amg.PLevel) needs
    to restrict degree-k operators onto the vertex space."""
    from cfdtpu.mesh import create_unit_square
    from cfdtpu.mesh.structured import create_unit_cube
    from cfdtpu.spaces import FunctionSpace

    for mesh in (create_unit_square(5, 4), create_unit_cube(3, 3, 2)):
        for k in (2, 3):
            V = FunctionSpace(mesh, k)
            par, w, nvert = V.linear_parents()
            assert nvert == mesh.num_points
            rec = (w[:, :, None] * mesh.points[par]).sum(axis=1)
            assert np.abs(rec - V.dof_coords).max() < 1e-12
            assert np.abs(w.sum(axis=1) - 1.0).max() < 1e-12


def test_amg_plevel_p2_galerkin_and_contraction():
    """The weighted p-multigrid level on a P2 equal-order node graph:
    (a) its Galerkin coarse values satisfy C xc == R A P xc exactly,
    (b) the momentum-block hierarchy (p-level + aggregation) contracts
    at least as well as the piecewise-constant-only one (the P2
    h-degradation lever, scripts/diag_pc.py),
    (c) the SELFP hierarchy deliberately has NO p-level — the weighted
    vertex Galerkin of the indefinite SELFP matrix diverges (see
    nodebsr.sp_amg)."""
    import jax.numpy as jnp
    from jax import ops as jox

    from cfdtpu.forms import StabilizedNSForm
    from cfdtpu.la.amg import BlockAMG, PLevel
    from cfdtpu.la.nodebsr import NodeBSR
    from cfdtpu.mesh import create_unit_square
    from cfdtpu.spaces import FunctionSpace

    mesh = create_unit_square(12, 12)
    V = FunctionSpace(mesh, 2, 2)
    Q = FunctionSpace(mesh, 2)
    form = StabilizedNSForm(V, Q)
    bsr = NodeBSR(form)
    prm = {
        "dt": jnp.asarray(0.01), "rho": jnp.asarray(1.0),
        "mu": jnp.asarray(0.01), "f": jnp.zeros(2),
    }
    rng = np.random.RandomState(0)
    u = jnp.asarray(0.1 * rng.randn(V.num_dofs, 2))
    A, B = form.element_jacobians(u, jnp.zeros(Q.num_dofs), (u,), prm)
    vals = bsr.assemble(A, B)
    uu = bsr.uu_vals(vals, jnp.zeros(form.n_u_flat, dtype=bool))

    # (c) SELFP stays piecewise-constant-only
    assert not any(isinstance(l, PLevel) for l in bsr.sp_amg().levels)
    # default uu hierarchy carries the p-level for degree > 1
    amg = bsr.uu_amg()
    plvl = amg.levels[0]
    assert isinstance(plvl, PLevel)
    built = amg.build(uu)

    def mv(x):
        return amg._matvec_block(0, built[0][0][0], x)

    # (a) Galerkin exactness of the weighted block transfer
    cvals = plvl.coarsen_block_vals(uu)
    crow, ccol = plvl.coarse_coo
    xc = jnp.asarray(rng.randn(plvl.n_coarse * 2))
    lhs = jox.segment_sum(
        jnp.einsum("eab,eb->ea", cvals,
                   xc.reshape(-1, 2)[jnp.asarray(ccol)]),
        jnp.asarray(crow), num_segments=plvl.n_coarse,
    ).reshape(-1)
    rhs = plvl.restrict_block(mv(plvl.prolong_block(xc, 2)), 2)
    assert np.allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-10)

    # (b) contraction, p-level vs piecewise-constant-only
    def run(hier, built_h):
        b = jnp.asarray(np.random.RandomState(1).randn(form.n_u_flat))
        x = jnp.zeros_like(b)
        r = b
        for _ in range(6):
            z = hier.v_cycle(built_h, r)
            x = x + z
            r = b - mv(x)
        return float(jnp.linalg.norm(r) / jnp.linalg.norm(b))

    rel = run(amg, built)
    amg_pc = BlockAMG(np.asarray(bsr.block_row),
                      np.asarray(bsr.block_col), bsr.n_nodes, d=2)
    rel_pc = run(amg_pc, amg_pc.build(uu))
    assert rel < 0.05, rel
    assert rel <= rel_pc * 1.05, (rel, rel_pc)


def test_amg_default_solver_converges():
    """stabilized_schur with the amg_p default must converge on the lid
    cavity with few outer iterations."""
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation

    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.02, mu=0.01, nx=12,
        output_every=100,
    )
    s = sc.solver
    assert s._nodebsr is not None
    s.solveStep()
    assert s.last_stats["converged"]
    assert int(s.last_stats["ksp_iters"]) < 30


def test_ghia_re400_profile():
    """Ghia et al. Re=400 centerline validation (Re=100 alone would
    leave two of the three published profiles unchecked). A
    coarse nx=32 BDF2 march to steady state must track the published
    profile within discretization error (~0.045 measured; the full-
    resolution campaign lives in scripts/validate_ghia.py)."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from validate_ghia import run

    err = run(400, nx=32, dt=0.5, n_steps=60, quiet=True)
    # measured 0.0446 on CPU f64; 0.055 keeps ~20% headroom for backend
    # noise while catching a moderate regression (0.07 was 1.6x, loose
    # enough to miss one)
    assert err < 0.055


def test_stats_window_catches_skipped_nonconvergence(tmp_path):
    """With stats_every > 1 an unconverged step inside the unfetched
    window must still raise at the next fetch — otherwise the bad state
    is committed to u_prev and silently absorbed into the trajectory
    (the next checked step can re-converge from it)."""
    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.05, mu=0.01, nx=8,
        stats_every=2, snes_rtol=1e-14, snes_atol=1e-30, snes_max_it=1,
    )
    with pytest.raises(RuntimeError, match="unfetched|converge"):
        sc.solve(str(tmp_path))


def test_stats_skipped_marker(tmp_path):
    """Unfetched steps must expose a 'skipped' marker (not fabricated
    zero/NaN stats) so solver_stats.txt rows stay truthful."""
    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.04, mu=0.01, nx=8,
        stats_every=2,
    )
    sc.solve(str(tmp_path))
    # 4 steps, stats fetched on even steps only
    assert sc.solver.last_stats["converged"]
    rows = [
        l for l in (tmp_path / "solver_stats.txt").read_text().splitlines()
        if l and not l.startswith("#")
    ]
    steps = [int(r.split()[0]) for r in rows]
    assert steps == [2, 4]  # skipped steps write no row
