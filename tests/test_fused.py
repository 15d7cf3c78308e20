"""Fused dense-intersection kernel (accel/fused.py) vs the plain
Moller-Trumbore dense path (render/intersect.py) as ground truth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from statmc_tpu.accel import fused as F
from statmc_tpu.core import math as cm
from statmc_tpu.render import intersect as I


def _random_tris(n, rng, scale=4.0):
    p0 = (rng.random((n, 3)) * 2 - 1) * scale
    e1 = (rng.random((n, 3)) * 2 - 1) * 0.8
    e2 = (rng.random((n, 3)) * 2 - 1) * 0.8
    return (p0.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32))


def _random_rays(r, rng, scale=6.0):
    o = ((rng.random((r, 3)) * 2 - 1) * scale).astype(np.float32)
    d = (rng.random((r, 3)) * 2 - 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _dense_truth(p0, e1, e2, o, d, t_max):
    t, _, _, hit = I.ray_triangles(o, d, jnp.asarray(p0), jnp.asarray(e1),
                                   jnp.asarray(e2), t_max)
    t = jnp.where(hit, t, cm.INF)
    j = jnp.argmin(t, axis=-1)
    tj = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
    found = tj < t_max
    return tj, jnp.where(found, j, -1), found


@pytest.mark.parametrize("n_tris", [7, 300, 600])
def test_fused_matches_dense(n_tris):
    rng = np.random.default_rng(3 + n_tris)
    p0, e1, e2 = _random_tris(n_tris, rng)
    o, d = _random_rays(400, rng)
    t_max = jnp.full((400,), cm.INF)

    ft = F.FusedTris.from_tris(p0, e1, e2)
    t_f, id_f, hit_f = F.intersect_fused(ft, o, d, t_max)
    t_t, id_t, hit_t = _dense_truth(p0, e1, e2, o, d, t_max)

    hit_f = np.asarray(hit_f)
    hit_t = np.asarray(hit_t)
    # Plucker vs MT may disagree on razor-edge grazing hits; demand
    # near-total agreement, and exact t agreement where both hit.
    agree = hit_f == hit_t
    assert agree.mean() > 0.995, f"hit disagreement {1 - agree.mean():.4f}"
    both = hit_f & hit_t
    np.testing.assert_allclose(
        np.asarray(t_f)[both], np.asarray(t_t)[both], rtol=2e-4, atol=2e-4
    )
    same_id = np.asarray(id_f)[both] == np.asarray(id_t)[both]
    assert same_id.mean() > 0.99


def test_fused_tmax_cut():
    rng = np.random.default_rng(11)
    p0, e1, e2 = _random_tris(64, rng)
    o, d = _random_rays(256, rng)
    inf = jnp.full((256,), cm.INF)
    ft = F.FusedTris.from_tris(p0, e1, e2)
    t_all, _, hit_all = F.intersect_fused(ft, o, d, inf)
    # Cut t_max just below each first hit: those rays must now miss.
    cut = jnp.where(hit_all, t_all * 0.5, 1e-3)
    _, _, hit_cut = F.intersect_fused(ft, o, d, cut)
    assert not bool(jnp.any(hit_cut & hit_all))


def test_pallas_kernel_interpret_matches_ref():
    """The Pallas kernel body (interpret mode) vs the pure-jnp reference."""
    rng = np.random.default_rng(5)
    p0, e1, e2 = _random_tris(500, rng)
    ft = F.FusedTris.from_tris(p0, e1, e2)
    R = 8 * F.RAY_BLOCK
    o, d = _random_rays(R, rng)
    t_max = jnp.full((R,), cm.INF)
    t_ref, id_ref = F._intersect_ref(ft, o, d, t_max)
    t_p, id_p = F._intersect_pallas(
        ft.edge_table, ft.plane_table, ft.tile_bounds,
        F.kernel_rays(o, d, R), t_max, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_ref),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(id_p), np.asarray(id_ref))


def test_driver_picks_fused_and_renders():
    """End-to-end: a small scene renders identically (statistically) via
    the fused path and the dense path."""
    import tempfile

    from statmc_tpu.driver import load
    from statmc_tpu.testscenes import scene_text

    text = scene_text(width=8, height=8, spp=4, iterations=1, maxdepth=3,
                      denoise=False)
    with tempfile.NamedTemporaryFile("w", suffix=".pbrt", delete=False) as f:
        f.write(text)
        path = f.name

    r_fused = load(path)
    assert hasattr(r_fused.s.bvh, "edge_table")
    r_fused.render(iterations=1, verbose=False)
    img_fused = np.asarray(r_fused.film_mean)

    r_dense = load(path, force_dense=True)
    r_dense.render(iterations=1, verbose=False)
    img_dense = np.asarray(r_dense.film_mean)

    assert np.isfinite(img_fused).all()
    # Identical sample streams -> images should agree almost everywhere
    # (razor-edge Plucker/MT disagreements move individual samples).
    close = np.isclose(img_fused, img_dense, rtol=1e-3, atol=1e-3)
    assert close.mean() > 0.97


def test_fused_compact_partition_matches():
    """Live-first lane compaction (dead-lane recovery) must be an exact
    no-op on results: partition + unsort round-trips every lane."""
    rng = np.random.default_rng(17)
    p0, e1, e2 = _random_tris(400, rng)
    ft = F.FusedTris.from_tris(p0, e1, e2)
    o, d = _random_rays(2048, rng)
    t_max = jnp.where(jnp.arange(2048) % 3 == 0, 0.0,
                      jnp.full((2048,), 50.0))
    t1, id1, h1 = F.intersect_fused(ft, o, d, t_max, compact=False)
    t2, id2, h2 = F.intersect_fused(ft, o, d, t_max, compact=True)
    np.testing.assert_array_equal(np.asarray(id1), np.asarray(id2))
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    assert not np.asarray(h2)[::3].any()  # dead lanes stay dead
