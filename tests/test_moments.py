"""Moment-accumulator unit tests against closed-form moments.

The reference ships zero tests for its statistics layer (SURVEY.md §4);
these are the tests it should have had: streaming updates vs numpy
closed forms, Chan combine vs serial, Box-Cox dual-stream semantics, and
mesh-axis combination equals single-device accumulation.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from statmc_tpu.stats import moments


def _closed_form(xs):
    n = xs.shape[0]
    mean = xs.mean(axis=0)
    d = xs - mean
    return n, mean, (d**2).sum(axis=0), (d**3).sum(axis=0)


def _run_stream(xs, transform=False):
    st = moments.make_state((xs.shape[1],), xs.shape[2], transform=transform)
    upd = moments.update_transform if transform else moments.update

    def body(st, x):
        return upd(st, x), None

    st, _ = jax.lax.scan(body, st, jnp.asarray(xs))
    return st


def test_streaming_matches_closed_form():
    rng = np.random.default_rng(0)
    xs = rng.gamma(2.0, 1.0, size=(257, 5, 3)).astype(np.float32)
    st = _run_stream(xs)
    n, mean, m2, m3 = _closed_form(xs.astype(np.float64))
    assert np.allclose(st["n"], n)
    np.testing.assert_allclose(st["mean"], mean, rtol=2e-5)
    np.testing.assert_allclose(st["m2"], m2, rtol=2e-3)
    np.testing.assert_allclose(st["m3"], m3, rtol=2e-2, atol=1e-2)


def test_transform_dual_streams():
    rng = np.random.default_rng(1)
    xs = rng.gamma(2.0, 1.0, size=(64, 4, 3)).astype(np.float32)
    st = _run_stream(xs, transform=True)
    ys = moments.box_cox(xs.astype(np.float64))
    _, mean_t, m2_t, m3_t = _closed_form(ys)
    _, mean_r, m2_r, _ = _closed_form(xs.astype(np.float64))
    np.testing.assert_allclose(st["mean"], mean_t, rtol=1e-4)
    np.testing.assert_allclose(st["m2"], m2_t, rtol=1e-3)
    np.testing.assert_allclose(st["m3"], m3_t, rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(st["film_mean"], mean_r, rtol=1e-4)
    np.testing.assert_allclose(st["film_m2"], m2_r, rtol=1e-3)


def test_box_cox_lambda_half():
    x = jnp.array([1.0, 4.0, 0.25])
    np.testing.assert_allclose(
        moments.box_cox(x), [0.0, 2.0, -1.0], rtol=1e-6
    )


def test_chan_combine_equals_serial():
    rng = np.random.default_rng(2)
    xs = rng.gamma(2.0, 1.0, size=(100, 7, 3)).astype(np.float32)
    serial = _run_stream(xs)
    a = moments.from_batch(jnp.asarray(xs[:37]))
    b = moments.from_batch(jnp.asarray(xs[37:]))
    merged = moments.combine(a, b)
    for k in ("n", "mean", "m2", "m3"):
        np.testing.assert_allclose(
            merged[k], serial[k], rtol=5e-3, atol=1e-3, err_msg=k
        )


def test_combine_with_empty_state():
    rng = np.random.default_rng(3)
    xs = rng.random((10, 3, 3)).astype(np.float32)
    batch = moments.from_batch(jnp.asarray(xs))
    empty = moments.make_state((3,), 3, transform=False)
    merged = moments.combine(empty, batch)
    for k in ("n", "mean", "m2", "m3"):
        np.testing.assert_allclose(merged[k], batch[k], rtol=1e-6, err_msg=k)


def test_masked_update_skips_lanes():
    st = moments.make_state((2,), 1, transform=False)
    x = jnp.array([[1.0], [5.0]])
    mask = jnp.array([True, False])
    st = moments.update(st, x, mask)
    assert st["n"][0, 0] == 1 and st["n"][1, 0] == 0
    assert st["mean"][0, 0] == 1.0 and st["mean"][1, 0] == 0.0


def test_mean_variance_formula():
    rng = np.random.default_rng(4)
    xs = rng.random((50, 2, 3)).astype(np.float32)
    st = moments.from_batch(jnp.asarray(xs))
    var = moments.mean_variance(st)
    expect = xs.var(axis=0, ddof=1) / xs.shape[0]
    np.testing.assert_allclose(var, expect, rtol=1e-4)


def test_combine_across_axis_matches_global():
    """Sample-sharded accumulation == single-device accumulation."""
    if jax.device_count() < 4:
        pytest.skip("needs >=4 virtual devices")
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    ndev = 4
    rng = np.random.default_rng(5)
    xs = rng.gamma(2.0, 1.0, size=(ndev * 8, 6, 3)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("spp",))

    def shard_fn(x):
        local = moments.from_batch(x)
        return moments.combine_across_axis(local, "spp")

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=P("spp"), out_specs=P(),
        check_vma=False,
    )
    sharded = fn(jnp.asarray(xs))
    ref = moments.from_batch(jnp.asarray(xs))
    for k in ("n", "mean", "m2", "m3"):
        np.testing.assert_allclose(
            sharded[k], ref[k], rtol=5e-3, atol=1e-3, err_msg=k
        )
