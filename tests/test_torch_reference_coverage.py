"""Every test of the reference's own suite has its counterpart among the
port's tests.

Both sets are read as source with ``ast``; neither package is imported.
The reference's tests are the top-level ``test_*`` functions of
``tests/test_*.py`` but the port's own ``tests/test_torch_*.py``. Each
must be a key of exactly one table:

* ``MIRRORED``: the port test (``test_torch_*.py::function``) that holds
  the port to what the reference test checks, under the reference's
  bounds or by parity with the reference on the same function;
* ``NOT_MIRRORED``: why none does yet, a reason that names its ROADMAP
  entry ("ROADMAP A, Do not port: ...", "ROADMAP Open items: ...");
  ROADMAP.md must name the test (``file.py::function``).

The test fails on a reference test in neither table, on a mapped port
test that does not exist, and on a table entry whose reference test is
gone. Run alone: ``pytest tests/test_torch_reference_coverage.py -q``.
"""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
ROADMAP = ROOT / "ROADMAP.md"
PORT_PREFIX = "test_torch_"


def _same(ref_file, names, port_file):
    """Each of ``names`` of ``ref_file`` mirrored under its own name in
    ``port_file``."""
    return {f"{ref_file}::{n}": f"{port_file}::{n}" for n in names}


#: ``reference_file::test`` -> ``port_file::test`` that mirrors it
MIRRORED = {
    **_same("test_3d.py", [
        "test_volume_and_mass", "test_gradients_3d", "test_vertical_integral",
        "test_2d3d_copies", "test_eos_values", "test_baroclinic_head",
        "test_vertical_velocity", "test_vertical_velocity_flux_consistency",
        "test_tracer3d_consistency", "test_tracer3d_advection",
        "test_timeseries_callback_3d", "test_tracer3d_value_bc_inflow"],
        "test_torch_reference_suites_fem.py"),
    "test_adjoint_swe.py::test_gradient_from_adjoint":
        "test_torch_adjoint_swe.py::"
        "test_cn_gradient_from_adjoint_matches_reference",
    "test_adjoint_swe.py::test_gradient_wrt_initial_elevation":
        "test_torch_adjoint_swe.py::"
        "test_gradient_wrt_initial_elevation_matches_reference",
    "test_assembled_pc.py::test_coloring_is_distance2_proper":
        "test_torch_solvers2d.py::test_coloring_and_probed_blocks",
    "test_assembled_pc.py::test_assembled_matches_linearized":
        "test_torch_solvers2d.py::test_assemble_affine_operator",
    "test_assembled_pc.py::test_assembled_with_open_boundaries":
        "test_torch_swe.py::test_assemble_swe_blocks",
    "test_assembled_pc.py::test_assembled_cn_matches_matrixfree_cn":
        "test_torch_cn_slice.py::test_cn_steps_match_reference",
    "test_assembled_pc.py::test_pc_is_near_inverse":
        "test_torch_solvers2d.py::test_assembled_wave_pc",
    "test_assembled_pc.py::test_analytic_blocks_match_probing":
        "test_torch_solvers2d.py::test_assemble_affine_operator",
    "test_assembled_pc.py::test_fieldsplit_pc_high_cfl_convergence":
        "test_torch_solvers2d.py::test_schur_fieldsplit_pc",
    "test_assembled_pc.py::test_fieldsplit_cn_step_and_gradient":
        "test_torch_solvers2d.py::"
        "test_assembled_cn_schur_gradient_matches_reference",
    "test_assembled_pc.py::test_shift_stencil_matches_gather":
        "test_torch_ringmv.py::test_reference_matches_shift_stencil",
    "test_assembled_pc.py::test_assembly_shared_residual_matches":
        "test_torch_swe.py::test_assemble_swe_blocks",
    "test_baroclinic_mms.py::test_baroclinic_mms_convergence":
        "test_torch_3d_bcs.py::test_baroclinic_mms_convergence_port",
    "test_barotropic_mes3d.py::test_barotropic_standing_wave_mes":
        "test_torch_convergence3d.py::test_barotropic_standing_wave_mes",
    "test_checkpoint.py::test_checkpoint_restart":
        "test_torch_io_restart.py::test_port_restart_is_bit_exact",
    "test_checkpoint.py::test_checkpoint_restart_3d":
        "test_torch_io_restart3d.py::test_port_3d_restart_is_bit_exact",
    "test_checkpoint.py::test_vtk_exporter":
        "test_torch_io_exporter.py::test_vtk_files_are_byte_equal",
    "test_checkpointing.py::test_checkpointed_scan_matches_plain_scan":
        "test_torch_adjoint_api.py::test_checkpointed_scan_matches_plain_scan",
    "test_convergence_ode.py::test_ode_convergence":
        "test_torch_steppers2d.py::test_ode_order_and_reference",
    "test_convergence_ode.py::test_butcher_to_shuosher":
        "test_torch_reference_suites_model.py::test_butcher_to_shuosher",
    **{f"test_demos.py::{n}":
       "test_torch_demos.py::test_demo_runs_through_the_port"
       for n in ("test_demo_2d_tracer", "test_demo_2d_channel_bnd",
                 "test_demo_3d_channel")},
    "test_dgcg.py::test_dgcg_standing_wave":
        "test_torch_dgcg.py::test_port_dgcg_standing_wave",
    "test_dgcg.py::test_dgcg_mass_conservation":
        "test_torch_dgcg.py::test_port_dgcg_mass_conservation",
    "test_dgcg.py::test_ppp_schur_bounded_iterations":
        "test_torch_dgcg.py::test_port_ppp_schur_bounded_iterations",
    "test_ekman.py::test_ekman_bottom_spiral":
        "test_torch_reference_suites3d.py::test_ekman_spiral",
    "test_ekman.py::test_ekman_surface_spiral":
        "test_torch_reference_suites3d.py::test_ekman_spiral",
    "test_examples.py::test_example_runs":
        "test_torch_examples_2d.py::test_example_runs_through_the_port",
    "test_examples.py::test_columbia_plume_file_driven_forcing":
        "test_torch_examples_3d.py::"
        "test_columbia_plume_file_driven_forcing",
    **_same("test_fem_core.py", [
        "test_mesh_area_and_boundary", "test_outward_normals_closed",
        "test_integration_exact_linear", "test_integration_exact_cubic",
        "test_gradients", "test_trace_continuity", "test_mass_roundtrip",
        "test_l2_projection", "test_cg_space", "test_form2indicator_and_dwr",
        "test_timed_stage_profiling"],
        "test_torch_reference_suites_fem.py"),
    **_same("test_fixed_mesh.py", [
        "test_fixed_mesh_barotropic_wave",
        "test_tracer_conservative_form_trait"],
        "test_torch_reference_suites3d.py"),
    "test_forcing_files.py::test_constituent_speeds":
        "test_torch_forcing.py::test_constituent_tables_and_nodal_corrections",
    "test_forcing_files.py::test_nodal_corrections_ranges":
        "test_torch_forcing.py::test_constituent_tables_and_nodal_corrections",
    "test_forcing_files.py::test_tides_prediction_consistency":
        "test_torch_forcing.py::test_tides_prediction",
    **_same("test_forcing_files.py", [
        "test_tpxo_tidal_boundary_forcing", "test_atm_netcdf_interpolator",
        "test_fes2004_tidal_boundary_forcing",
        "test_generic_2d_and_ocean_3d_interpolators",
        "test_era5_interpolator", "test_tchazards_interpolator",
        "test_ncom_interpolator", "test_liveocean_interpolator"],
        "test_torch_forcing.py"),
    **_same("test_int_pg_mes.py", [
        "test_int_pg_mes", "test_int_pg_quadratic_pressure"],
        "test_torch_convergence3d.py"),
    "test_katophillips.py::test_katophillips_mixed_layer_depth":
        "test_torch_3d_gls.py::test_kato_phillips_mixed_layer_depth",
    "test_kernels.py::test_tridiag_matches_dense":
        "test_torch_tridiag.py::test_matches_reference_and_dense",
    "test_kernels.py::test_tridiag_broadcasts_batch_axes":
        "test_torch_tridiag.py::test_broadcast_batch_axes",
    "test_kernels.py::test_ring_mv_pallas_matches_einsum_and_grads":
        "test_torch_adjoint_kernels.py::test_ring_mv_vjp_matches_reference",
    **_same("test_modesplit_dt.py", [
        "test_modesplit_ratio", "test_dt_mode_2d",
        "test_split_matches_implicit_barotropic"],
        "test_torch_reference_suites_model.py"),
    "test_momentum3d.py::test_hviscosity_mes":
        "test_torch_convergence3d.py::test_hviscosity_mes",
    **_same("test_momentum3d.py", [
        "test_momentum_rest_state", "test_lock_exchange_direction",
        "test_vertical_viscosity_implicit",
        "test_hadv_open_boundary_uniform_flow",
        "test_law_of_wall_bottom_friction", "test_smagorinsky_wired"],
        "test_torch_reference_suites3d.py"),
    "test_multiple_tracers.py::test_multiple_tracers_demo":
        "test_torch_reference_suites.py::test_multiple_tracers_demo",
    "test_native.py::test_native_facets_match_numpy":
        "test_torch_reference_suites.py::test_native_facets_match_numpy",
    **_same("test_netcdf_io.py", [
        "test_parse_time_units", "test_ncfile_and_varname"],
        "test_torch_forcing.py"),
    "test_netcdf_io.py::test_time_parser_and_search":
        "test_torch_forcing.py::test_time_parser_search_and_interpolator",
    "test_netcdf_io.py::test_timeseries_interpolator":
        "test_torch_forcing.py::test_time_parser_search_and_interpolator",
    "test_nh.py::test_nh_lake_at_rest":
        "test_torch_nh.py::test_port_nh_lake_at_rest",
    "test_nh.py::test_nh_standing_wave":
        "test_torch_nh.py::test_port_nh_standing_wave",
    "test_north_sea.py::test_north_sea_demo":
        "test_torch_north_sea.py::test_demo_bounds_hold_for_the_port",
    **_same("test_optimisation.py", [
        "test_optimisation_callbacks", "test_user_export_manager",
        "test_minimize_bounds_pairs_two_controls"],
        "test_torch_io_optimisation.py"),
    **_same("test_options_wiring.py", [
        "test_simulation_end_date_overrides_end_time",
        "test_log_output_and_export_diagnostics",
        "test_no_exports_suppresses_diagnostics",
        "test_tracer_picard_iterations_run_and_converge"],
        "test_torch_reference_suites.py"),
    "test_parallel.py::test_partition_roundtrip":
        "test_torch_parallel_partition.py::test_scatter_gather_round_trip",
    "test_parallel.py::test_sharded_tracer_advection_matches_serial":
        "test_torch_parallel.py::"
        "test_sharded_tracer_advection_matches_reference",
    "test_parallel.py::test_gspmd_swe_step_matches_serial":
        "test_torch_parallel.py::test_sharded_swe_steps_match_serial",
    **_same("test_parallel.py", [
        "test_sharded_swe_residual_bit_exact",
        "test_sharded_swe_mass_ops_bit_exact",
        "test_sharded_swe_steps_match_serial",
        "test_sharded_assembled_cn_matches_serial",
        "test_sharded_3d_step_matches_serial"],
        "test_torch_parallel.py"),
    "test_parallel.py::test_sharded_assembled_cn_with_coarse":
        "test_torch_parallel.py::test_sharded_assembled_cn_matches_serial",
    "test_parallel.py::test_submesh_weak_w_matches_serial":
        "test_torch_parallel.py::test_sharded_3d_step_matches_serial",
    **_same("test_periodic.py", [
        "test_periodic_geometry", "test_periodic_full_circuit_advection",
        "test_periodic_swe_uniform_forcing"],
        "test_torch_reference_suites.py"),
    **{f"test_rt2.py::{n}": f"test_torch_hdiv_cases.py::test_port_{n[5:]}"
       for n in ("test_rt2_exactness", "test_rt2_standing_wave_order",
                 "test_rt2_beats_rt1", "test_bdm2_exactness",
                 "test_rt2_facade", "test_rt2_mass_conservation")},
    **{f"test_rtdg.py::{n}": f"test_torch_hdiv_cases.py::test_port_{n[5:]}"
       for n in ("test_rt_exactness", "test_rtdg_standing_wave",
                 "test_rtdg_forced_channel", "test_bdm_exactness")},
    "test_rtdg.py::test_rtdg_flowsolver":
        "test_torch_hdiv_cases.py::test_port_hdiv_p0_flowsolver",
    "test_rtdg.py::test_bdmdg_flowsolver_standing_wave":
        "test_torch_hdiv_cases.py::test_port_hdiv_p0_flowsolver",
    **{f"test_sediment.py::{n}": f"test_torch_sediment.py::test_port_{n[5:]}"
       for n in ("test_suspended_sediment_equilibrium",
                 "test_exner_bed_evolution",
                 "test_sediment_slide_relaxes_steep_slope",
                 "test_sediment_slide_inactive_below_max_angle")},
    "test_solver3d.py::test_3d_callbacks":
        "test_torch_io_callbacks.py::test_3d_callbacks_through_iterate",
    "test_solver3d.py::test_ssprk22_ale_two_stage":
        "test_torch_reference_suites_model.py::"
        "test_ale_integrator_consistency_and_lock_exchange",
    "test_solver3d.py::test_leapfrog_am3":
        "test_torch_reference_suites_model.py::"
        "test_ale_integrator_consistency_and_lock_exchange",
    **_same("test_solver3d.py", [
        "test_barotropic_consistency", "test_tracer_consistency_coupled",
        "test_lock_exchange", "test_hcc_metric",
        "test_density_weak_and_velocity_magnitude",
        "test_3d_time_step_control", "test_limiter3d"],
        "test_torch_reference_suites_model.py"),
    "test_standing_wave.py::test_standing_wave_channel":
        "test_torch_reference_suites.py::test_standing_wave_channel",
    **_same("test_swe_channel.py", [
        "test_initial_norm_matches_reference",
        "test_crank_nicolson_demo_trace",
        "test_ssprk33_stability_and_conservation", "test_create_iterator"],
        "test_torch_reference_suites.py"),
    "test_swe_mms.py::test_swe_steady_mms_convergence":
        "test_torch_convergence2d.py::test_swe_steady_mms_convergence",
    **_same("test_swe_p2.py", [
        "test_standing_wave_p2_order", "test_p2_beats_p1",
        "test_tracer_p2_order"], "test_torch_convergence2d.py"),
    "test_thacker.py::test_thacker":
        "test_torch_wetting_drying.py::test_thacker_12h_error_bounds",
    **_same("test_tracer_cg.py", [
        "test_cg_tracer_advection_convergence", "test_supg_bounded_front"],
        "test_torch_reference_suites.py"),
    **_same("test_tracer_mes.py", [
        "test_advection_mes", "test_diffusion_mes"],
        "test_torch_convergence2d.py"),
    **{f"test_turbines.py::{n}": f"test_torch_turbines.py::test_port_{n[5:]}"
       for n in ("test_farm_drag_creates_head_difference",
                 "test_power_callback", "test_discrete_farm_density_integral",
                 "test_rotor_shear_averaging",
                 "test_minimum_distance_constraints",
                 "test_load_turbine_file")},
    "test_turbines.py::test_farm_power_gradient":
        "test_torch_turbines.py::test_farm_density_gradient",
    **_same("test_turbulence.py", [
        "test_stability_function_parameters",
        "test_stability_function_limiters", "test_gls_column_spinup",
        "test_stratification_suppresses_mixing", "test_pacanowski_philander",
        "test_stability_function_variants"],
        "test_torch_reference_suites_model.py"),
    "test_williamson.py::test_williamson2_steady_state":
        "test_torch_sphere.py::test_port_williamson2_steady_state",
    "test_williamson.py::test_williamson2_flowsolver_facade":
        "test_torch_sphere.py::test_port_williamson2_facade",
    **_same("test_checkpointing.py", [
        "test_forward_gradient_checkpoint_consistency",
        "test_long_inversion_gradient_bounded_memory"],
        "test_torch_adjoint_api.py"),
    **_same("test_inversion.py", [
        "test_inversion_recovers_manning", "test_inversion_taylor"],
        "test_torch_adjoint_api.py"),
    **_same("test_williamson.py", [
        "test_lauter3_unsteady", "test_williamson5_facade"],
        "test_torch_sphere.py"),
}

#: ``reference_file::test`` -> why no port test mirrors it (its ROADMAP
#: entry names it)
NOT_MIRRORED = {
    "test_fem_core.py::test_docs_generator": (
        "ROADMAP A, Do not port: docs/generate_docs.py writes the "
        "reference's own pages from thetis_tpu's modules; the port's names "
        "are held by test_torch_api_coverage.py"),
    "test_gmsh.py::test_read_north_sea": (
        "ROADMAP Open items: north_sea.msh is not in the repo (the "
        "reference's test skips too); test_torch_sphere.py reads .msh "
        "files the tests write"),
}


def _tests_of(path):
    """The top-level ``test_*`` functions of a test file."""
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.startswith("test_")]


@functools.lru_cache(maxsize=None)
def reference_files():
    return tuple(sorted(p.name for p in TESTS.glob("test_*.py")
                        if not p.name.startswith(PORT_PREFIX)))


@functools.lru_cache(maxsize=None)
def reference_tests():
    return frozenset(f"{f}::{t}" for f in reference_files()
                     for t in _tests_of(TESTS / f))


@functools.lru_cache(maxsize=None)
def port_tests():
    return frozenset(f"{p.name}::{t}"
                     for p in TESTS.glob(PORT_PREFIX + "*.py")
                     for t in _tests_of(p))


def gaps(ref_file, mirrored, not_mirrored, port):
    """What ``ref_file``'s tests lack against the tables: unmapped tests,
    tests in both tables, and mapped port tests that do not exist."""
    out = []
    for t in _tests_of(TESTS / ref_file):
        key = f"{ref_file}::{t}"
        if key in mirrored and key in not_mirrored:
            out.append(f"{key}: in both tables")
        elif key in mirrored:
            if mirrored[key] not in port:
                out.append(f"{key}: its port test {mirrored[key]} does not "
                           f"exist")
        elif key not in not_mirrored:
            out.append(f"{key}: no port test and no reason")
    return out


def test_there_are_reference_tests():
    assert len(reference_files()) >= 45 and len(reference_tests()) >= 174


@pytest.mark.parametrize("ref_file", reference_files())
def test_every_reference_test_is_mirrored(ref_file):
    assert gaps(ref_file, MIRRORED, NOT_MIRRORED, port_tests()) == []


def test_every_entry_names_a_live_reference_test():
    stale = sorted((set(MIRRORED) | set(NOT_MIRRORED)) - reference_tests())
    assert stale == []


def test_not_mirrored_entries_are_on_the_roadmap():
    roadmap = ROADMAP.read_text()
    for key, reason in NOT_MIRRORED.items():
        assert reason.startswith("ROADMAP "), key
        assert key in roadmap, f"ROADMAP.md does not name {key}"


#: the scan's failure cases, each against a copy of the tables:
#: (name, change to the copies) -> the message expected for
#: ``test_swe_p2.py``
CASES = {
    "an unmapped test": (
        lambda m, n, p: m.pop("test_swe_p2.py::test_p2_beats_p1"),
        "test_swe_p2.py::test_p2_beats_p1: no port test and no reason"),
    "a port test that is gone": (
        lambda m, n, p: p.discard(
            "test_torch_convergence2d.py::test_p2_beats_p1"),
        "test_swe_p2.py::test_p2_beats_p1: its port test "
        "test_torch_convergence2d.py::test_p2_beats_p1 does not exist"),
    "a test in both tables": (
        lambda m, n, p: n.update({"test_swe_p2.py::test_p2_beats_p1":
                                  "ROADMAP A"}),
        "test_swe_p2.py::test_p2_beats_p1: in both tables"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_gap_is_reported(case):
    """The scan reports each kind of gap, here made in copies of the
    tables and of the port's test names."""
    change, message = CASES[case]
    m, n, p = dict(MIRRORED), dict(NOT_MIRRORED), set(port_tests())
    assert gaps("test_swe_p2.py", m, n, p) == []
    change(m, n, p)
    assert gaps("test_swe_p2.py", m, n, p) == [message]
