"""Streaming per-pixel moment statistics as a combinable monoid.

Functional equivalent of the reference's StatTile accumulators
(/root/reference/src/statistics/estimator.h:162-232):

* ``update`` reproduces the one-pass Meng/Pebay update expressions in the
  exact order of AddStatSampleM1/M2/M3 (estimator.h:162-205), vectorized
  over pixels, so a lockstep run matches the reference's f32 arithmetic.
* ``update_transform`` reproduces AddTransformSample (estimator.h:212-226):
  the Box-Cox(lambda=0.5) transformed sample feeds the (mean, m2, m3)
  stream while the raw sample feeds a parallel (film_mean, film_m2) stream
  sharing the same n.
* ``combine`` implements Chan et al.'s pairwise update so that moment
  states computed over disjoint sample batches (e.g. per device along a
  sample-sharded mesh axis) merge exactly -- this is the mesh-native
  replacement for the reference's serial tile merge
  (estimator.cpp:341-407); there is nothing like it in the reference
  because a pthread pool never needs it.

A MomentState is a dict pytree so it shards/psums transparently.
All fields broadcast: shapes are [..., C] with C channels (C=3 RGB or
C=1 luminance), n is [..., 1].
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

Array = jax.Array
MomentState = Dict[str, Any]


def make_state(shape, channels: int, transform: bool, max_moment: int = 3,
               dtype=jnp.float32) -> MomentState:
    """Allocate a zeroed moment state for `shape` pixels x `channels`."""
    full = tuple(shape) + (channels,)
    st: MomentState = {
        "n": jnp.zeros(tuple(shape) + (1,), dtype=jnp.float32),
        "mean": jnp.zeros(full, dtype=dtype),
    }
    if max_moment >= 2:
        st["m2"] = jnp.zeros(full, dtype=dtype)
    if max_moment >= 3:
        st["m3"] = jnp.zeros(full, dtype=dtype)
    if transform:
        st["film_mean"] = jnp.zeros(full, dtype=dtype)
        st["film_m2"] = jnp.zeros(full, dtype=dtype)
    return st


def box_cox(x: Array, lam: float = 0.5) -> Array:
    """(x^lambda - 1)/lambda  (estimator.h:135-145; lambda=0.5 hardcoded
    at the AddTransformSample call site, estimator.h:215)."""
    return (jnp.power(x, lam) - 1.0) / lam


def _meng_update(n, mean, m2, m3, x, w):
    """One Meng/Pebay step; w is a [..., 1] {0,1} mask of active lanes.

    Follows estimator.h:188-205 statement order exactly (m3 uses the
    *updated* m2, which algebraically equals the standard Pebay update).
    """
    n_new = n + w
    n_safe = jnp.maximum(n_new, 1.0)
    d = x - mean
    d2 = d * d
    dn = d / n_safe
    dn2 = dn * dn
    mean_new = mean + w * dn
    out = {"n": n_new, "mean": mean_new}
    if m2 is not None:
        m2_new = m2 + w * (d * (d - dn))
        out["m2"] = m2_new
        if m3 is not None:
            out["m3"] = m3 + w * (-3.0 * dn * m2_new + d * (d2 - dn2))
    return out


def update(state: MomentState, sample: Array, mask: Array | None = None
           ) -> MomentState:
    """AddSampleM{1,2,3}: raw sample into the stat stream; film aliases it.

    sample: [..., C]; mask: [...] bool of lanes that actually drew a sample.
    """
    w = _mask_w(state, mask)
    new = _meng_update(
        state["n"], state["mean"], state.get("m2"), state.get("m3"), sample, w
    )
    # Without transform, film buffers alias the stat buffers
    # (estimator.cpp:128-137: mean/m2 share storage with film-mean/film-m2).
    if "film_mean" in state:
        new["film_mean"] = new["mean"]
        new["film_m2"] = new.get("m2", state["film_m2"])
    return new


def update_transform(state: MomentState, sample: Array,
                     mask: Array | None = None, lam: float = 0.5
                     ) -> MomentState:
    """AddTransformSample (estimator.h:212-226): Box-Cox into stats,
    raw sample into the film duals, sharing one n."""
    w = _mask_w(state, mask)
    new = _meng_update(
        state["n"], state["mean"], state.get("m2"), state.get("m3"),
        box_cox(sample, lam), w,
    )
    n_safe = jnp.maximum(new["n"], 1.0)
    fd = sample - state["film_mean"]
    fdn = fd / n_safe
    new["film_mean"] = state["film_mean"] + w * fdn
    new["film_m2"] = state["film_m2"] + w * (fd * (fd - fdn))
    return new


def _mask_w(state: MomentState, mask: Array | None) -> Array:
    if mask is None:
        return jnp.ones_like(state["n"])
    return mask[..., None].astype(state["n"].dtype)


def combine(a: MomentState, b: MomentState) -> MomentState:
    """Chan et al. pairwise-combine of two moment states over the same
    pixels.  Exact in expectation; numerically stable (no raw power sums).
    """
    na, nb = a["n"], b["n"]
    n = na + nb
    n_safe = jnp.maximum(n, 1.0)
    d = b["mean"] - a["mean"]
    dn = d / n_safe
    out: MomentState = {"n": n, "mean": a["mean"] + nb * dn}
    if "m2" in a:
        m2 = a["m2"] + b["m2"] + d * dn * na * nb
        out["m2"] = m2
        if "m3" in a:
            out["m3"] = (
                a["m3"] + b["m3"]
                + d * dn * dn * na * nb * (na - nb)
                + 3.0 * dn * (na * b["m2"] - nb * a["m2"])
            )
    if "film_mean" in a:
        fd = b["film_mean"] - a["film_mean"]
        fdn = fd / n_safe
        out["film_mean"] = a["film_mean"] + nb * fdn
        out["film_m2"] = a["film_m2"] + b["film_m2"] + fd * fdn * na * nb
    return out


def combine_across_axis(state: MomentState, axis_name: str) -> MomentState:
    """Merge per-device moment states along a named mesh axis.

    Implemented as all_gather + sequential Chan combine (the device axis is
    small).  This is the reduction that replaces the reference's
    mutex-guarded tile merge when samples are sharded across chips.
    """
    gathered = jax.lax.all_gather(state, axis_name)

    num = jax.tree_util.tree_leaves(gathered)[0].shape[0]

    def body(i, acc):
        return combine(acc, jax.tree.map(lambda x: x[i], gathered))

    init = jax.tree.map(lambda x: x[0], gathered)
    return jax.lax.fori_loop(1, num, body, init)


def from_batch(samples: Array, axis: int = 0, transform: bool = False,
               lam: float = 0.5, mask: Array | None = None) -> MomentState:
    """Compute a MomentState from a batch of samples in one shot.

    Stable two-pass form (subtract batch mean first).  Combined with
    ``combine`` this is how large spp chunks accumulate without a serial
    scan; equals the streaming result in exact arithmetic.
    """
    if mask is None:
        n = jnp.array(samples.shape[axis], dtype=jnp.float32)
        x = box_cox(samples, lam) if transform else samples
        mean = jnp.mean(x, axis=axis)
        d = x - jnp.expand_dims(mean, axis)
        m2 = jnp.sum(d * d, axis=axis)
        m3 = jnp.sum(d * d * d, axis=axis)
        st = {
            "n": jnp.broadcast_to(n, mean[..., :1].shape),
            "mean": mean, "m2": m2, "m3": m3,
        }
        if transform:
            fmean = jnp.mean(samples, axis=axis)
            fd = samples - jnp.expand_dims(fmean, axis)
            st["film_mean"] = fmean
            st["film_m2"] = jnp.sum(fd * fd, axis=axis)
        return st
    # Masked variant: weight 0/1 per sample.
    w = jnp.expand_dims(mask, -1).astype(samples.dtype)
    n = jnp.sum(w, axis=axis)
    n_safe = jnp.maximum(n, 1.0)
    x = box_cox(samples, lam) if transform else samples
    mean = jnp.sum(w * x, axis=axis) / n_safe
    d = (x - jnp.expand_dims(mean, axis)) * w
    st = {
        "n": n[..., :1],
        "mean": mean,
        "m2": jnp.sum(d * d, axis=axis),
        "m3": jnp.sum(d * d * d, axis=axis),
    }
    if transform:
        fmean = jnp.sum(w * samples, axis=axis) / n_safe
        fd = (samples - jnp.expand_dims(fmean, axis)) * w
        st["film_mean"] = fmean
        st["film_m2"] = jnp.sum(fd * fd, axis=axis)
    return st


def sample_variance(state: MomentState) -> Array:
    """Unbiased sample variance M2/(n-1)."""
    n = state["n"]
    return state["m2"] / jnp.maximum(n - 1.0, 1.0)


def mean_variance(state: MomentState, film: bool = False) -> Array:
    """Variance of the mean: M2/((n-1) n)  (estimator.cpp:524-569,
    the CPU CalculateMeanVars loop; feeds the -film-mean-var buffer)."""
    n = state["n"]
    m2 = state["film_m2"] if film and "film_m2" in state else state["m2"]
    return m2 / jnp.maximum((n - 1.0) * n, 1.0)
