"""Pallas filter kernel vs XLA reference + VJP finite-difference checks.

Runs in Pallas interpreter mode on the CPU test backend; the same kernel
compiles for the GPU through Triton (tests/test_on_card.py, chip_smoke.py).
"""
import numpy as np
import jax
import jax.numpy as jnp

from statmc_tpu.denoise.filter_jax import stat_filter, corrected_stats
from statmc_tpu.denoise.filter_pallas import _run_filter, filter_apply
from statmc_tpu.denoise.ttest import quantile_table


def _fields(seed=0, H=24, W=40, C=3, N=16):
    rng = np.random.default_rng(seed)
    xs = rng.gamma(4.0, 0.25, size=(N, H, W, C)).astype(np.float32)
    ys = 2.0 * (np.sqrt(xs) - 1.0)
    n = np.full((H, W), N, np.float32)
    mean = ys.mean(0)
    d = ys - mean
    m2 = (d**2).sum(0)
    m3 = (d**3).sum(0)
    fm = xs.mean(0)
    gb = rng.random((H, W, 3)).astype(np.float32)
    return n, mean, m2, m3, fm, gb


def test_pallas_matches_xla_reference():
    n, mean, m2, m3, fm, gb = _fields()
    H, W, C = mean.shape
    radius, sd = 3, 2.0
    tq = jnp.asarray(quantile_table(0.005))
    ref = stat_filter(
        jnp.asarray(n), jnp.asarray(mean), jnp.asarray(m2),
        jnp.asarray(m3), jnp.asarray(fm), jnp.asarray(gb)[None],
        jnp.asarray([-0.5 / 0.1**2]), jnp.asarray(-0.5 / sd**2), tq, radius,
    )
    mc, disc = corrected_stats(
        jnp.asarray(n), jnp.asarray(mean), jnp.asarray(m2),
        jnp.asarray(m3), tq,
    )
    out, wsum = _run_filter(
        mc, disc * disc, jnp.asarray(fm), jnp.asarray(gb),
        jnp.ones((H, W)), radius, -0.5 / sd**2,
        tuple([-0.5 / 0.1**2] * 3), interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref["film_mean_f"]), rtol=1e-5,
        atol=1e-6,
    )
    np.testing.assert_allclose(np.asarray(mc), np.asarray(ref["mean_corr"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(disc), np.asarray(ref["discriminator"]), rtol=1e-5
    )
    # Self weight always present.
    assert float(jnp.min(wsum)) >= 1.0 - 1e-5


def test_vjp_matches_finite_difference():
    n, mean, m2, m3, fm, gb = _fields(seed=1, H=16, W=16, N=32)
    H, W, C = mean.shape
    radius, sd = 2, 1.5
    tq = jnp.asarray(quantile_table(0.005))
    mc, disc = corrected_stats(
        jnp.asarray(n), jnp.asarray(mean), jnp.asarray(m2),
        jnp.asarray(m3), tq,
    )
    args = (mc, disc * disc, jnp.asarray(gb), jnp.ones((H, W)),
            radius, -0.5 / sd**2, tuple([-0.5 / 0.1**2] * 3), True)

    # Weighted loss so the gradient isn't spatially uniform.
    wloss = jnp.asarray(
        np.random.default_rng(2).random((H, W, 1)).astype(np.float32)
    )

    def loss(fmx):
        return jnp.sum(wloss * filter_apply(fmx, *args))

    g = jax.grad(loss)(jnp.asarray(fm))
    eps = 1e-2
    rng = np.random.default_rng(3)
    for _ in range(4):
        i, j, c = rng.integers(0, H), rng.integers(0, W), rng.integers(0, C)
        fm2 = fm.copy()
        fm2[i, j, c] += eps
        fd = (float(loss(jnp.asarray(fm2))) - float(loss(jnp.asarray(fm)))) / eps
        assert abs(float(g[i, j, c]) - fd) < 5e-3 + 0.05 * abs(fd), (
            f"grad mismatch at {(i, j, c)}: {float(g[i, j, c])} vs {fd}"
        )


def test_valid_mask_matches_reference_and_odd_sizes():
    """Neighbour validity (the sharded halo mask) and an image that is
    not a multiple of the kernel tile in either axis."""
    n, mean, m2, m3, fm, gb = _fields(seed=4, H=19, W=37)
    H, W, C = mean.shape
    radius, sd = 3, 2.0
    tq = jnp.asarray(quantile_table(0.005))
    valid = jnp.ones((H, W)).at[:4].set(0.0).at[:, -3:].set(0.0)
    ref = stat_filter(
        jnp.asarray(n), jnp.asarray(mean), jnp.asarray(m2),
        jnp.asarray(m3), jnp.asarray(fm), jnp.asarray(gb)[None],
        jnp.asarray([-0.5 / 0.1**2]), jnp.asarray(-0.5 / sd**2), tq, radius,
        valid=valid,
    )
    mc, disc = corrected_stats(
        jnp.asarray(n), jnp.asarray(mean), jnp.asarray(m2),
        jnp.asarray(m3), tq,
    )
    out, wsum = _run_filter(
        mc, disc * disc, jnp.asarray(fm), jnp.asarray(gb), valid, radius,
        -0.5 / sd**2, tuple([-0.5 / 0.1**2] * 3), interpret=True,
    )
    assert out.shape == (H, W, C) and wsum.shape == (H, W)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref["film_mean_f"]), rtol=1e-5,
        atol=1e-6,
    )
    np.testing.assert_allclose(np.asarray(wsum),
                               np.asarray(ref["weight_sum"]), rtol=1e-5)
