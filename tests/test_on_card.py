"""The GPU kernels, compiled for the card, against their plain references.

Every test here needs an NVIDIA GPU and skips elsewhere; `python
chip_smoke.py` runs them on the card (marker `card`).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from statmc_tpu.core.backend import reference_on_gpu

pytestmark = pytest.mark.card


def _filter_fields(seed, H, W, C=3, G=6, N=16):
    rng = np.random.default_rng(seed)
    xs = rng.gamma(4.0, 0.25, size=(N, H, W, C)).astype(np.float32)
    ys = 2.0 * (np.sqrt(xs) - 1.0)
    d = ys - ys.mean(0)
    return (jnp.full((H, W), float(N)), jnp.asarray(ys.mean(0)),
            jnp.asarray((d**2).sum(0)), jnp.asarray((d**3).sum(0)),
            jnp.asarray(xs.mean(0)),
            jnp.asarray(rng.random((H, W, G)), jnp.float32))


def test_filter_kernel_matches_stat_filter(gpu):
    from statmc_tpu.denoise.filter_jax import corrected_stats, stat_filter
    from statmc_tpu.denoise.filter_pallas import _run_filter
    from statmc_tpu.denoise.ttest import quantile_table

    H, W, r = 45, 70, 6  # neither a multiple of the tile
    n, mean, m2, m3, fm, gb = _filter_fields(0, H, W)
    tq = jnp.asarray(quantile_table(0.005))
    gf = -0.5 / 0.1**2
    ref = stat_filter(n, mean, m2, m3, fm,
                      jnp.stack([gb[..., 0:3], gb[..., 3:6]]),
                      jnp.asarray([gf, gf]), jnp.float32(-0.5 / 4.0), tq, r)
    mc, disc = corrected_stats(n, mean, m2, m3, tq)
    out, wsum = _run_filter(mc, disc * disc, fm, gb, jnp.ones((H, W)), r,
                            -0.5 / 4.0, (gf,) * 6)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(ref["film_mean_f"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wsum),
                               np.asarray(ref["weight_sum"]), rtol=1e-4)


def test_filter_vjp_matches_autodiff_twin(gpu):
    from statmc_tpu.denoise import filter_pallas as FP

    rng = np.random.default_rng(1)
    H, W = 40, 50
    fm, mc = (jnp.asarray(rng.random((H, W, 3)), jnp.float32)
              for _ in range(2))
    d2 = jnp.asarray(0.5 + rng.random((H, W, 3)), jnp.float32)
    gb = jnp.asarray(rng.random((H, W, 4)), jnp.float32)
    valid = jnp.ones((H, W))
    gbf = (-0.5 / 0.3**2,) * 4

    def loss(f, x):
        return jnp.sum(jnp.sin(f(x, mc, d2, gb, valid, 3, -0.125, gbf)))

    g_k = jax.grad(lambda x: loss(FP.filter_apply, x))(fm)
    g_r = jax.grad(lambda x: loss(FP.filter_apply_diff, x))(fm)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_r),
                               rtol=1e-3, atol=1e-5)


def _tris(T, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((T, 3)) * 20 - 10).astype(np.float32),
            (rng.random((T, 3)) - 0.5).astype(np.float32),
            (rng.random((T, 3)) - 0.5).astype(np.float32))


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    o = (rng.random((R, 3)) * 24 - 12).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(R) % 5 == 0, 0.0, 1e30).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)


def _assert_same_hits(k, ref):
    tk, ik, _ = (np.asarray(x) for x in k)
    tr, ir, _ = (np.asarray(x) for x in ref)
    assert (ik != ir).mean() <= 1e-3
    m = (ik == ir) & (ir >= 0)
    # t = num/den carries an absolute rounding error near the origin.
    np.testing.assert_allclose(tk[m], tr[m], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["fused", "walk"])
def test_intersector_kernel_matches_reference(gpu, path):
    from statmc_tpu.accel.fused import FusedTris, intersect_fused
    from statmc_tpu.accel.twolevel import TwoLevelTris, intersect_twolevel

    build, fn = ((FusedTris, intersect_fused) if path == "fused"
                 else (TwoLevelTris, intersect_twolevel))
    acc = build.from_tris(*_tris(5000, 3))
    o, d, t_max = _rays(3000, 4)  # not a multiple of the ray block
    k = jax.jit(lambda o, d, t: fn(acc, o, d, t))(o, d, t_max)
    with reference_on_gpu(path):
        ref = jax.jit(lambda o, d, t: fn(acc, o, d, t))(o, d, t_max)
    _assert_same_hits(k, ref)
    assert not np.asarray(k[2])[::5].any()  # dead lanes never hit


def test_driver_renders_with_kernels(gpu, tmp_path):
    from statmc_tpu.accel.fused import FusedTris
    from statmc_tpu.driver import load
    from statmc_tpu.testscenes import scene_text

    p = tmp_path / "scene.pbrt"
    p.write_text(scene_text(width=96, height=64, spp=4, iterations=2,
                            maxdepth=4, denoise=True, filtersd=2.0,
                            filterradius=4))
    r = load(str(p))
    assert isinstance(r.s.bvh, FusedTris)
    r.render(iterations=2, verbose=False)
    film_f = np.asarray(r.film_f)
    assert np.isfinite(film_f).all() and film_f.mean() > 0
