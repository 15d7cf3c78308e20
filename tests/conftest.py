"""Test configuration: an 8-virtual-device CPU backend.

The suite runs on the CPU, where every hot path takes its plain
reference (statmc_tpu/core/backend.py) and multi-device sharding is
validated on a virtual CPU mesh.  The platform is selected, and any
backend already initialized is cleared, before tests import JAX-using
modules.

`python chip_smoke.py` runs the card-only tests (marker `card`) inside
its own GPU process and sets STATMC_TEST_ON_CARD=1, which leaves that
process's platform alone.
"""
import os

import pytest

if not os.environ.get("STATMC_TEST_ON_CARD"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    from jax._src import xla_bridge as _xb

    if _xb.backends_are_initialized():
        from jax.extend.backend import clear_backends

        clear_backends()

    jax.config.update("jax_threefry_partitionable", True)
    assert jax.device_count() >= 8, (
        f"expected 8 virtual CPU devices, got {jax.device_count()}"
    )


@pytest.fixture
def gpu():
    """Skips a card-only test unless JAX's backend is the GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py`")


# ---------------------------------------------------------------------------
# Fast tier: the default developer loop is `pytest tests/ -m "not slow"`
# (~10-14 min measured); the full suite is ~40-60 min run in parts (the
# transport/analytic slow tier dominates -- see CLAUDE.md "Commands" for
# the recommended split) and runs before commits that touch the
# integrator.  Centralized here instead of per-file decorators so the
# tier can be retuned from one list (durations from
# `pytest --durations=40`).
# ---------------------------------------------------------------------------
_SLOW_TESTS = {
    "test_analytic_volpath",
    "test_mlt_bdpt_beats_pt_mutation_on_caustics",
    "test_analytic_bdpt",
    "test_analytic_bdpt_arealight",
    "test_analytic_sppm",
    "test_analytic_mlt",
    "test_fourier_material_renders_like_matte",
    "test_ld_render_matches_random_mean",
    "test_scene_with_marble_kd_renders",
    "test_checkpoint_resume_bitexact",
    "test_mesh_render_matches_single_device",
    "test_product_mesh_full_pipeline_matches_single_device",
    "test_driver_picks_fused_and_renders",
    "test_nee_vs_bsdf_only_materials",
    "test_scene_with_tessellated_shapes_renders",
    "test_directlighting_darker_than_path",
    "test_textured_render",
    "test_path_name_renders",
    "test_scene_with_new_materials_renders",
    "test_whitted_darker_than_path",
    "test_nee_matches_bsdf_only_ground_truth",
    "test_denoise_from_disk_roundtrip",
    "test_goniometric_light_no_map_equals_point",
    "test_whitted_and_volpath_accepted",
    "test_stats_continue_across_iterations",
    "test_cone_lod_smooths_distant_checker",
    "test_halton_mode_low_discrepancy",
    "test_regen_matches_with_acrr_smis",
    "test_acrr_converges_to_plain_rr_mean",
    "test_smis_converges_to_full_mis_mean",
    "test_absorption_only_camera_fog_beer_lambert",
    "test_scattering_fog_nee_matches_phase_only",
    "test_grid_constant_density_matches_homogeneous",
    "test_null_boundary_fog_region",
    "test_regen_matches_per_sample_ld",
    "test_regen_matches_pixelbounds_crop",
    "test_bdpt_matches_path_mean",
    "test_bdpt_beats_path_on_caustics",
    "test_sppm_matches_path_mean",
    "test_mlt_matches_path_mean",
    "test_mlt_bootstrap_normalization",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
