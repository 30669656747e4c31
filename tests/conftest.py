"""Test configuration: force CPU with 8 virtual devices.

Runs before jax is imported (conftest import precedes test modules), so
JAX_PLATFORMS/XLA_FLAGS take effect at first jax import: 8 host-platform
devices let sharding tests exercise multi-chip layouts without hardware
(the analogue of the reference testing MPI with `mpirun -n 4` locally,
README.md:58-69).
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

# ---------------------------------------------------------------------
# Tiered suite: the full run takes ~55 min on one core, which stops it
# being run before commits. Tests below are marked `slow` (everything
# measured >= ~20 s per call), EXCEPT one kept representative per
# solver/subsystem family, so `pytest -m "not slow"` (the `make test`
# default) still touches every family in < 5 min. `make test-full`
# runs everything. Re-measure durations (pytest --durations=0) before
# moving tests between tiers.
#
# Kept fast-tier representatives (near the 20 s line, deliberately in):
#   dist      -> test_shard_assembly_matches_serial
#   variants  -> test_bdf2_lid
#   pcd       -> test_pcd_lid
#   lsc       -> test_lsc_bdf2_lid
#   schur pc  -> test_pc_options_converge[kw0]
#   dfg       -> test_dfg_functionals_plausible
#   segregated-> test_ipcs_bdf2_unit_square, test_staggered_lid
_SLOW = {
    # test_hemodynamic.py
    "test_wss_poiseuille",
    "test_stenosis_scenario",
    "test_vascularbc_weak_and_backflow",
    "test_pressurebc_channel",
    "test_cbc_and_ddn",
    "test_velocity_vascular_backflow",
    "test_vascularbc_fixed_point",
    "test_ipcs_midpoint_lid",
    "test_hex_p3_pressure_channel",
    "test_hex_q2_ipcs_channel",
    # test_solver.py
    "test_ghia_re400_profile",
    "test_nodebsr_matches_element_operator",
    "test_ten_step_march",
    "test_amg_selfp_vcycle_contracts",
    "test_simulation_orchestrator",
    "test_amg_default_solver_converges",
    "test_stats_skipped_marker",
    "test_stats_window_catches_skipped_nonconvergence",
    # test_dist.py (keeps test_shard_assembly_matches_serial)
    "test_halo_scenario_end_to_end",
    "test_distributed_two_process_launch",
    "test_staggered_sharded_matches_serial",
    "test_halo_step_on_channel",
    "test_sharded_jacobian_matvec_matches",
    "test_sharded_residual_matches",
    "test_halo_step_matches_serial",
    "test_ipcs_midpoint_sharded_matches_serial",
    "test_const_args_step_matches",
    "test_ipcs_bdf2_sharded_matches_serial",
    "test_sharded_full_step",
    # test_aux.py
    "test_simple_bifurcation_native_mesh",
    "test_checkpoint_resume",
    "test_checkpoint_restores_bdf2_history",
    # test_dfg.py (keeps test_dfg_functionals_plausible)
    "test_pipe_cylinder_2d2_records_forces",
    "test_pipe_cylinder_2d2_resume_appends_series",
    "test_pipe_cylinder_2d2_resume_reconciles_misaligned_series",
    # test_variants.py (keeps test_bdf2_lid)
    "test_aspin_matches_base",
    "test_pressure_backflow_channel",
    "test_taylor_green_error",
    "test_backflow_channel",
    "test_adaptive_runs",
    "test_ramping_scales_bc",
    # test_solver_families.py (keeps pcd_lid, lsc_bdf2_lid, kw0)
    "test_pc_lag_steps_matches_default",
    "test_lsc_lid",
    "test_schur_stokes_channel",
    "test_pc_options_converge[kw1]",
    "test_pc_options_converge[kw2]",
    "test_pc_options_converge[kw3]",
    "test_pc_options_converge[kw4]",
    "test_pc_options_converge[kw5]",
    "test_pc_options_converge[kw6]",
    "test_pc_options_converge[kw7]",
    "test_pc_options_converge[kw8]",
    "test_pc_lag_self_heal",
    "test_pc_lag_spike_rebuild",
    "test_lsc_pressurebc_channel",
    "test_pcd_pressurebc_channel",
    "test_pcd_bdf2_lid",
    "test_vascularbc_strong_channel",
    # test_full3d.py
    "test_full3d_solves",
    # test_experiments.py (cheap factory/matrix tests remain)
    "test_mesh_and_solve_pipeline",
    "test_factory_bc_modes",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name in _SLOW:
            item.add_marker(pytest.mark.slow)
