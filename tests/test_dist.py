"""Distribution tests: sharded residual/Jacobian/matvec equivalence with
the serial form, and the full sharded time step, on an 8-device CPU mesh
(the analogue of the reference's `mpirun -n 4` local MPI testing)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cfdtpu.dist import ShardedNSForm, make_device_mesh
from cfdtpu.forms import StabilizedNSForm
from cfdtpu.mesh import create_unit_square
from cfdtpu.spaces import FunctionSpace


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) >= 8, "conftest should provide 8 devices"
    mesh = create_unit_square(9, 9)  # 162 cells: not divisible by 8
    V = FunctionSpace(mesh, 1, 2)
    Q = FunctionSpace(mesh, 1)
    serial = StabilizedNSForm(V, Q)
    sharded = ShardedNSForm(
        StabilizedNSForm(V, Q), make_device_mesh(8)
    )
    rng = np.random.RandomState(0)
    u = jnp.asarray(rng.randn(V.num_dofs, 2))
    p = jnp.asarray(rng.randn(Q.num_dofs))
    up = jnp.asarray(rng.randn(V.num_dofs, 2))
    prm = {
        "dt": jnp.asarray(0.01), "rho": jnp.asarray(1.0),
        "mu": jnp.asarray(0.01), "f": jnp.zeros(2),
    }
    return serial, sharded, u, p, up, prm


def test_sharded_residual_matches(setup):
    serial, sharded, u, p, up, prm = setup
    ru_s, rp_s = serial.residual(u, p, (up,), prm)
    ru_d, rp_d = sharded.residual(u, p, (up,), prm)
    assert np.allclose(ru_s, ru_d, atol=1e-11)
    assert np.allclose(rp_s, rp_d, atol=1e-11)


def test_sharded_jacobian_matvec_matches(setup):
    serial, sharded, u, p, up, prm = setup
    A_s, B_s = serial.element_jacobians(u, p, (up,), prm)
    A_d, B_d = sharded.element_jacobians(u, p, (up,), prm)
    v = jnp.asarray(
        np.random.RandomState(1).randn(serial.n_flat)
    )
    y_s = serial.apply_element_matrices(A_s, B_s, v)
    y_d = sharded.apply_element_matrices(A_d, B_d, v)
    assert np.allclose(y_s, y_d, atol=1e-10)
    d_s = serial.jacobian_diagonal(A_s, B_s)
    d_d = sharded.jacobian_diagonal(A_d, B_d)
    assert np.allclose(d_s, d_d, atol=1e-10)
    for which in ("uu", "up", "pu", "pp"):
        nin = serial.n_u_flat if which[1] == "u" else Q_dofs(serial)
        vv = v[:nin]
        z_s = serial.apply_sub_block(A_s, B_s, vv, which)
        z_d = sharded.apply_sub_block(A_d, B_d, vv, which)
        assert np.allclose(z_s, z_d, atol=1e-10), which


def Q_dofs(form):
    return form.Q.num_dofs


def test_sharded_full_step():
    from __graft_entry__ import _build

    solver, args = _build(nx=8, dtype=np.float64, n_shards=8)
    u, p, ru, rp, stats = solver._step(*args)
    assert bool(stats["converged"])
    # compare against the serial solve
    solver_s, args_s = _build(nx=8, dtype=np.float64)
    u_s, p_s, *_ = solver_s._step(*args_s)
    assert np.allclose(u, u_s, atol=1e-6)


def test_halo_step_matches_serial():
    """The round-2 dof-partitioned halo path (dist/halo.py): the full
    sharded Newton step must reproduce the serial solution, and the
    additive-Schwarz PC must keep the iteration count within a small
    factor of the serial Schur PC (multi-chip convergence quality must
    be measured, not just correctness)."""
    from __graft_entry__ import _build

    solver, args = _build(nx=12, dtype=np.float64, n_shards=8)
    assert solver._use_halo
    u, p, ru, rp, stats = solver._step(*args)
    assert bool(stats["converged"])

    solver_s, args_s = _build(nx=12, dtype=np.float64)
    u_s, p_s, ru_s, rp_s, stats_s = solver_s._step(*args_s)
    assert np.allclose(u, u_s, atol=1e-6)
    assert np.allclose(
        np.asarray(p) - np.mean(p), np.asarray(p_s) - np.mean(p_s),
        atol=1e-5,
    )
    # ASM(8 subdomains, no overlap) vs global AMG-SELFP: allow growth
    # but fail on collapse to unpreconditioned behaviour
    assert int(stats["newton_iters"]) <= int(stats_s["newton_iters"]) + 2
    assert int(stats["ksp_iters"]) <= 12 * max(int(stats_s["ksp_iters"]), 1)


def test_halo_maps_exchange_consistency():
    """Static-map sanity: every halo source resolves to the right owned
    supernode (exchange = FORWARD ghost update)."""
    from __graft_entry__ import _build
    from cfdtpu.dist.halo import HaloMaps

    solver, _ = _build(nx=12, dtype=np.float64)
    bsr = solver._nodebsr
    maps = HaloMaps(bsr, 8)
    S, L, B, H = maps.S, maps.L, maps.B, maps.H
    pack = np.asarray(maps.pack_idx)
    src = np.asarray(maps.halo_src)
    # reconstruct: gathering global supernode ids through the exchange
    ids = np.arange(maps.ns_pad, dtype=np.int64).reshape(S, L)
    buf = np.concatenate([
        np.concatenate([ids[s][pack[s]] for s in range(S)]),
        [-1],
    ])
    got = buf[src]  # (S, H) global supernode ids (or -1 padding)
    cols = np.asarray(bsr._sup.sup_cols)
    ns = bsr._sup.ns
    for s in range(S):
        block_rows = slice(s * L, min((s + 1) * L, ns))
        block = cols[block_rows]
        ref = np.unique(block[block < ns])
        halo = ref[(ref < s * L) | (ref >= (s + 1) * L)]
        assert np.array_equal(got[s][: len(halo)], halo)


def test_distributed_two_process_launch(tmp_path):
    """`--distributed` 2-process CPU launch: both ranks run the solve,
    only process 0 writes output (the reference's mpirun -n N + rank-0
    guards, simulation_hpc.sh:14-19)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [str(tmp_path / f"rank{i}") for i in range(2)]
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "main.py", "simulate",
             "--simulation", "lid_driven2D", "--solver",
             "stabilized_schur", "--T", "0.02", "--dt", "0.01",
             "--name", "dist", "--mu", "0.01", "--nx", "6",
             "--output_dir", outs[i], "--distributed",
             "--coordinator", f"localhost:{port}",
             "--num_processes", "2", "--process_id", str(i)],
            cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i][-2000:]}"
    # rank 0 wrote results; rank 1 wrote nothing
    import glob

    assert glob.glob(outs[0] + "/lid_driven2D/*/norms.txt")
    assert not glob.glob(outs[1] + "/**/norms.txt", recursive=True)


def test_halo_step_on_channel():
    """Halo path on a free-outflow channel (inlet Dirichlet, do-nothing
    outlet, pressure nullspace from the numeric test) matches the serial
    solve — the non-cavity BC configuration."""
    import sys as _sys

    _sys.path.insert(0, "tests")
    from test_variants import ChannelScenario, _parabolic

    sc8 = ChannelScenario(
        "stabilized_schur", dt=0.05, T=0.05,
        inlet_velocity=_parabolic, n_shards=8,
    )
    assert sc8.solver._use_halo
    sc0 = ChannelScenario(
        "stabilized_schur", dt=0.05, T=0.05,
        inlet_velocity=_parabolic,
    )
    sc8.solver.solveStep()
    sc0.solver.solveStep()
    assert sc8.solver.last_stats["converged"]
    assert np.allclose(
        np.asarray(sc8.solver.u_sol), np.asarray(sc0.solver.u_sol),
        atol=5e-6,
    )


def test_const_args_step_matches():
    """jit_const_args (utils/constargs.py) extracts the static maps as
    jit arguments and reproduces the standard step bit-for-bit-ish —
    the huge-mesh compile path (PERF.md 1M-DOF blocker)."""
    import os

    from __graft_entry__ import _build

    s0, a0 = _build(nx=14, dtype=np.float64)
    u0, *_ = s0._step(*a0)
    os.environ["CFDTPU_CONST_ARGS"] = "1"
    try:
        s1, a1 = _build(nx=14, dtype=np.float64)
        assert s1.jit_const_args
        u1, p1, ru, rp, st = s1._step(*a1)
    finally:
        os.environ.pop("CFDTPU_CONST_ARGS", None)
    assert bool(st["converged"])
    assert np.allclose(np.asarray(u1), np.asarray(u0), atol=1e-9)


def test_const_args_collects_slotted_hierarchy_maps():
    """collect_const_slots must reach arrays held by __slots__ classes
    (AMGLevel / PLevel / SuperMaps): the AMG transfer maps are some of
    the largest static arrays in a hierarchy and would otherwise be
    embedded in the compiled program as HLO constants."""
    from cfdtpu.la.amg import AMG, AMGLevel
    from cfdtpu.utils.constargs import collect_const_slots
    from __graft_entry__ import _build

    s, _ = _build(nx=14, dtype=np.float64)
    nodebsr = s._nodebsr
    srow, scol, _ = nodebsr.sp_structure()
    # small coarse_size forces real aggregation levels at this size
    nodebsr._sp_amg_h = AMG(np.asarray(srow), np.asarray(scol),
                            nodebsr.n_nodes, coarse_size=50)
    assert len(nodebsr._sp_amg_h.levels) > 0
    slots = collect_const_slots([s.form, nodebsr], min_bytes=1 << 10)
    assert any(isinstance(c, AMGLevel) for c, _ in slots), (
        "slotted AMG level arrays were not collected"
    )


def test_halo_scenario_end_to_end(tmp_path):
    """Scenario-level halo run (the CLI --n_shards path: time loop,
    outputs, norms) matches the serial scenario bit-for-bit-ish."""
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation

    sc8 = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.02, mu=0.01, nx=10, n_shards=8
    )
    sc8.solve(str(tmp_path / "halo"))
    sc0 = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.02, mu=0.01, nx=10
    )
    sc0.solve(str(tmp_path / "serial"))
    assert np.allclose(
        np.asarray(sc8.solver.u_sol), np.asarray(sc0.solver.u_sol),
        atol=1e-10,
    )


def test_halo_float32_first_step_converges():
    """The halo path in float32 at the impulsive start of DFG 2D-1: its
    coarse level is solved in float64, without which every linear solve
    of the first step stopped at ksp_max_it and Newton did not
    converge."""
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

    sc = DFG1Benchmark("stabilized_schur", dt=0.05, T=0.05, res_scale=2.0,
                       dtype=np.float32, n_shards=4, ksp_restart=20,
                       snes_max_it=6)
    s = sc.solver
    assert s._use_halo and s.dtype == np.float32
    s.solveStep()
    stats = s.last_stats
    assert stats["converged"] and stats["newton_iters"] <= 3, stats
    assert stats["ksp_max_iters"] < s.newton_params.ksp_maxiter, stats


def test_shard_assembly_matches_serial():
    """Phase-2 sharded (ghosted-cell) assembly (dist/shard_assembly.py):
    each shard's locally-assembled supernode rows and owned COO blocks
    must equal the corresponding rows of the serial global assembly —
    and the union of the per-shard cell lists must cover every cell
    while each shard holds only ~nc/S + boundary of them (i.e. the
    assembly is genuinely partitioned, not replicated)."""
    from __graft_entry__ import _build
    from cfdtpu.dist.halo import HaloMaps
    from cfdtpu.dist.shard_assembly import ShardAssemblyMaps

    solver, args = _build(nx=12, dtype=np.float64)
    form, bsr = solver.form, solver._nodebsr
    S = 8
    maps = HaloMaps(bsr, S)
    sam = ShardAssemblyMaps(bsr, S, maps.L)
    u0, p0, aux, bc_u_vals, bc_p_vals, prm = args
    rng = np.random.RandomState(1)
    u = u0 + 0.1 * jnp.asarray(rng.randn(*u0.shape))
    p = p0 + 0.1 * jnp.asarray(rng.randn(*p0.shape))

    # serial global assembly (the oracle)
    A_cells, A_blocks = form.element_jacobians(u, p, aux, prm)
    vals = bsr.assemble(A_cells, A_blocks)
    sup = np.asarray(vals["sup"])
    coo = np.asarray(vals["coo"])
    ru_s, rp_s = form.residual(u, p, aux, prm)

    nc = form.mesh.num_cells
    L, Kg = maps.L, maps.Kg
    g, bs = bsr.g, bsr.bs
    gbs = g * bs
    ns = bsr._sup.ns
    covered = set()
    r = np.asarray(bsr._ridx)
    for s in range(S):
        cls = np.asarray(sam.local_cells[s])
        n_real = len(
            set(int(c) for c in cls)
        )
        covered.update(int(c) for c in cls)
        # partitioned, not replicated: no shard holds all cells
        assert sam.Lc < nc

        # per-shard Jacobian path (the same ops halo.py runs)
        A_loc = np.asarray(A_cells)[cls]
        ent = [
            A_loc[:, r[:, None, :, None], r[None, :, None, :]]
            .reshape(-1, bs, bs)
        ]
        for (dmf, A_f) in A_blocks:
            ent.append(
                np.asarray(A_f)[
                    :, r[:, None, :, None], r[None, :, None, :]
                ].reshape(-1, bs, bs)
            )
        ent = np.concatenate(ent, axis=0)
        src = np.concatenate(
            [ent, np.zeros((1, bs, bs), ent.dtype)], axis=0
        )
        blocks_loc = src[np.asarray(sam.ell_jac[s])].sum(axis=1)
        flat = np.zeros((sam.sup_flat_len,), blocks_loc.dtype)
        flat[np.asarray(sam.sup_pos_loc[s]).reshape(-1)] = (
            blocks_loc.reshape(-1)
        )
        vloc = flat[: L * Kg * gbs * gbs].reshape(L, Kg, gbs, gbs)
        sup_pad = np.zeros((maps.ns_pad, Kg, gbs, gbs), sup.dtype)
        sup_pad[:ns] = sup
        assert np.allclose(vloc, sup_pad[s * L:(s + 1) * L], atol=1e-12)

        # owned COO blocks match the serial assembly
        blk = np.asarray(sam.blk_ids[s])
        real = blk < sam.nb_glob
        assert np.allclose(blocks_loc[real], coo[blk[real]], atol=1e-12)

        # per-shard residual rows match the serial residual
        u_e = np.asarray(u)[np.asarray(form.dofmap_u)[cls]]
        p_e = np.asarray(p)[np.asarray(form.dofmap_p)[cls]]
        aux_e = tuple(np.asarray(a)[np.asarray(form.dofmap_u)[cls]]
                      for a in aux)
        kernel = jax.vmap(form._kernel, in_axes=(0, 0, 0, 0, 0, None))
        ru_e, rp_e = kernel(
            jnp.asarray(u_e), jnp.asarray(p_e),
            tuple(jnp.asarray(a) for a in aux_e),
            form.cell_coords[jnp.asarray(cls)],
            form.cell_h[jnp.asarray(cls)], prm,
        )
        stream = [np.asarray(ru_e).reshape(-1),
                  np.asarray(rp_e).reshape(-1)]
        for block in form._facet_blocks:
            _, ru_f = form._block_residual(block, u, p, aux, prm)
            stream.append(np.asarray(ru_f).reshape(-1))
        stream.append(np.zeros((1,)))
        rsrc = np.concatenate(stream)
        r_loc = rsrc[np.asarray(sam.ell_res[s])].sum(axis=1)
        # owned rows of the serial residual, in sup layout
        n = bsr.n_nodes
        d = bsr.dim
        rflat = np.concatenate(
            [np.asarray(ru_s).reshape(-1), np.asarray(rp_s)]
        )
        usup = np.zeros((maps.ns_pad * g, d))
        usup[:n] = rflat[: n * d].reshape(n, d)
        psup = np.zeros((maps.ns_pad * g,))
        psup[:n] = rflat[n * d:]
        ref_full = np.concatenate(
            [usup.reshape(maps.ns_pad, g * d),
             psup.reshape(maps.ns_pad, g)], axis=1,
        )
        assert np.allclose(
            r_loc.reshape(L, gbs), ref_full[s * L:(s + 1) * L],
            atol=1e-10,
        )
    assert covered == set(range(nc))


# -- segregated-family distribution (cell-sharded, dof-replicated) -------

def _march(solver, steps):
    for _ in range(steps):
        solver.solveStep()
        solver.u_prev, solver.p_prev = solver.u_sol, solver.p_sol
    return np.asarray(solver.u_sol), np.asarray(solver.p_sol)


def test_ipcs_midpoint_sharded_matches_serial():
    """ipcs_midpoint with n_shards: element operators + RHS sweeps cell-
    sharded over 8 devices must reproduce the serial march."""
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation

    kw = dict(dt=0.005, T=1.0, mu=0.01, nx=10)
    ser = LidDriven2DSimulation("ipcs_midpoint", **kw).solver
    sh = LidDriven2DSimulation("ipcs_midpoint", n_shards=8, **kw).solver
    u_s, p_s = _march(ser, 3)
    u_d, p_d = _march(sh, 3)
    # psum reduction order differs from the serial scatter order, and the
    # Krylov solves stop at rtol — agreement is tolerance-level, not bitwise
    assert np.allclose(u_d, u_s, atol=3e-6)
    assert np.allclose(p_d, p_s, atol=3e-5)


def test_ipcs_bdf2_sharded_matches_serial():
    """ipcs_bdf2: the per-step sharded jacfwd operator build (the element
    blocks never exist unsharded) must reproduce the serial march."""
    from cfdtpu.scenarios.unit_square import UnitSquareSimulation

    kw = dict(dt=0.005, T=1.0, mu=0.05, nx=8)
    ser = UnitSquareSimulation("ipcs_bdf2", **kw).solver
    sh = UnitSquareSimulation("ipcs_bdf2", n_shards=8, **kw).solver
    u_s, p_s = _march(ser, 3)
    u_d, p_d = _march(sh, 3)
    # psum reduction order differs from the serial scatter order, and the
    # Krylov solves stop at rtol — agreement is tolerance-level, not bitwise
    assert np.allclose(u_d, u_s, atol=3e-6)
    assert np.allclose(p_d, p_s, atol=3e-5)


def test_staggered_sharded_matches_serial():
    """stabilized_staggered consumes the form API, so n_shards routes it
    through ShardedNSForm (HALO_DISTRIBUTION = False) — equivalence with
    the serial segregated Newton loop."""
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation

    kw = dict(dt=0.01, T=1.0, mu=0.01, nx=8)
    ser = LidDriven2DSimulation("stabilized_staggered", **kw).solver
    sh = LidDriven2DSimulation(
        "stabilized_staggered", n_shards=8, **kw
    ).solver
    assert not getattr(sh, "_use_halo", False)
    from cfdtpu.dist import ShardedNSForm

    assert isinstance(sh.form, ShardedNSForm)
    u_s, p_s = _march(ser, 2)
    u_d, p_d = _march(sh, 2)
    assert np.allclose(u_d, u_s, atol=3e-6)
    assert np.allclose(p_d, p_s, atol=3e-5)
