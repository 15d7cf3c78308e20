"""Differentiable filter paths: Pallas film-VJP vs the autodiff twin,
plus finite-difference G-buffer gradient checks (north star)."""
import jax
import jax.numpy as jnp
import numpy as np

from statmc_tpu.denoise import filter_pallas as FP


def _setup(seed=0, H=10, W=12, C=3, G=4):
    rng = np.random.default_rng(seed)
    fm = jnp.asarray(rng.random((H, W, C)), jnp.float32)
    mc = jnp.asarray(rng.random((H, W, C)), jnp.float32)
    # Wide CIs so the acceptance gate is mostly open (and not on the
    # measure-zero boundary where finite differences break).
    d2 = jnp.asarray(0.5 + rng.random((H, W, C)), jnp.float32)
    gb = jnp.asarray(rng.random((H, W, G)), jnp.float32)
    valid = jnp.ones((H, W), jnp.float32)
    gbf = tuple(-0.5 / (0.3**2) for _ in range(G))
    return fm, mc, d2, gb, valid, gbf


def test_diff_twin_matches_pallas_forward():
    fm, mc, d2, gb, valid, gbf = _setup()
    r, dsf = 2, -0.5 / 4.0
    out_ref = FP.filter_apply_diff(fm, mc, d2, gb, valid, r, dsf, gbf)
    out_pal = FP.filter_apply(fm, mc, d2, gb, valid, r, dsf, gbf,
                              interpret=True)
    np.testing.assert_allclose(np.asarray(out_ref), np.asarray(out_pal),
                               rtol=1e-4, atol=1e-5)


def test_film_grad_matches_between_paths():
    fm, mc, d2, gb, valid, gbf = _setup(1)
    r, dsf = 2, -0.5 / 4.0

    def loss_pal(x):
        return jnp.sum(jnp.sin(FP.filter_apply(
            x, mc, d2, gb, valid, r, dsf, gbf, interpret=True)))

    def loss_ref(x):
        return jnp.sum(jnp.sin(FP.filter_apply_diff(
            x, mc, d2, gb, valid, r, dsf, gbf)))

    g_pal = jax.grad(loss_pal)(fm)
    g_ref = jax.grad(loss_ref)(fm)
    np.testing.assert_allclose(np.asarray(g_pal), np.asarray(g_ref),
                               rtol=1e-3, atol=1e-5)


def test_gbuffer_grads_finite_difference():
    fm, mc, d2, gb, valid, gbf = _setup(2, H=6, W=7)
    r, dsf = 2, -0.5 / 4.0
    key = jax.random.PRNGKey(0)
    cot = jax.random.normal(key, fm.shape)

    def loss(g):
        return jnp.sum(cot * FP.filter_apply_diff(
            fm, mc, d2, g, valid, r, dsf, gbf))

    grad_g = np.asarray(jax.grad(loss)(gb))
    assert np.abs(grad_g).max() > 0  # gradients actually flow

    eps = 1e-3
    rng = np.random.default_rng(3)
    for _ in range(6):
        i, j, c = (rng.integers(0, s) for s in gb.shape)
        dg = np.zeros(gb.shape, np.float32)
        dg[i, j, c] = eps
        fd = (float(loss(gb + dg)) - float(loss(gb - dg))) / (2 * eps)
        assert abs(fd - grad_g[i, j, c]) < 5e-2 * max(1.0, abs(fd)), (
            i, j, c, fd, grad_g[i, j, c])
