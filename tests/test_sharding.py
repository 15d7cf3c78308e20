"""Shard-invariance: N-device mesh render equals 1-device render.

The reference never needed this test (single-host pthread pool); for a
mesh-sharded renderer it is the core correctness property (SURVEY.md §4
"Implication for the wavefront build").
"""
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from statmc_tpu.driver import load
from statmc_tpu.parallel.shard import (
    make_mesh, make_sharded_chunk_fn, replicate_scene,
)

SCENE = """
Integrator "statpath" "integer maxdepth" [3] "integer iterations" [1]
  "bool calcstats" ["true"] "float rrthreshold" [0]
Sampler "random" "integer pixelsamples" [4]
Film "image" "integer xresolution" [8] "integer yresolution" [8] "string filename" ["t.pfm"]
Camera "perspective" "float fov" [60]
WorldBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "sphere" "float radius" [1.0]
  LightSource "point" "rgb I" [3.14159265 3.14159265 3.14159265]
WorldEnd
"""


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_product_mesh_full_pipeline_matches_single_device():
    """The PRODUCT multi-device path (Renderer(mesh=...)): two feedback
    iterations with ACRR + SMIS + sharded halo-exchange denoise on a 2x4
    mesh must reproduce the single-device render (film, filtered film,
    and the ACRR feedback buffer).  This is the full-pipeline extension
    of the chunk-level test below (VERDICT r1 weak #3/#4)."""
    from statmc_tpu.testscenes import scene_text, staircase_proxy

    text = scene_text(
        width=16, height=16, spp=2, iterations=2, maxdepth=4,
        denoise=True, filtersd=1.5, filterradius=2,
        body=staircase_proxy(n_steps=4, clutter=4),
        extra_integrator='"bool acrr" ["true"] '
                         '"integer trackedbounces" [3] '
                         '"bool smis" ["true"] ',
    )
    tmp = tempfile.mkdtemp()
    p = tmp + "/s.pbrt"
    with open(p, "w") as f:
        f.write(text)

    r1 = load(p)
    r1.render(iterations=2, verbose=False)

    rm = load(p, mesh=make_mesh(2, 4))
    assert rm.mesh is not None
    rm.render(iterations=2, verbose=False)

    np.testing.assert_allclose(
        np.asarray(rm.film_mean), np.asarray(r1.film_mean),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(rm.film_f), np.asarray(r1.film_f),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(rm.avg_ls), np.asarray(r1.avg_ls[: r1.P]),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(rm.win_b), np.asarray(r1.win_b[: r1.P]),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 devices")
def test_mesh_render_matches_single_device():
    tmp = tempfile.mkdtemp()
    p = tmp + "/s.pbrt"
    with open(p, "w") as f:
        f.write(SCENE)

    # Single-device reference.
    r = load(p)
    r.render(iterations=1, verbose=False)
    film_ref = np.asarray(r.film_mean)
    n_ref = np.asarray(r.states[0]["n"])
    mean_ref = np.asarray(r.states[0]["mean"])

    # 2x2 mesh: 2-way sample sharding x 2-way pixel sharding.
    r2 = load(p)
    mesh = make_mesh(2, 2)
    setup = replicate_scene(r2.s, mesh)
    fn = make_sharded_chunk_fn(setup, mesh)
    P = r2.P
    pixel_ids = jnp.arange(P, dtype=jnp.int32)
    states, film_sum, film_w, rays, stats = fn(
        r2.states, r2.film_sum, r2.film_w, r2.ray_total, r2.base_key,
        jnp.asarray(0, jnp.int32), pixel_ids,
        jnp.ones((P,), bool), r2.avg_ls, r2.win_b, r2.win_l,
        jnp.asarray(False), n_samples=4,
    )
    # STAT counters are psum'd across the mesh: 4 samples x 64 pixels.
    assert float(stats["n_camera_rays"]) == 4 * r2.P
    film = np.asarray(film_sum) / np.asarray(film_w)[:, None]
    np.testing.assert_allclose(film, film_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(states[0]["n"]), n_ref)
    # Chan-combined moments match serial Meng within f32 tolerance.
    np.testing.assert_allclose(
        np.asarray(states[0]["mean"]), mean_ref, rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(states[0]["m2"]),
        np.asarray(r.states[0]["m2"]), rtol=1e-3, atol=1e-4,
    )
