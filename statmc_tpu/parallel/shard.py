"""Mesh-sharded rendering: pixels x samples over a 2-D device mesh.

The reference's entire parallel backend is a single-host pthread pool
over 16x16 image tiles plus one CUDA stream (SURVEY.md §2.7/§5.8).  The
mesh-native equivalent built here:

* mesh axes ("spp", "px"): film rows / pixel blocks sharded over "px",
  sample indices strided over "spp";
* scene/BVH tables replicated on every device (in_specs P());
* per-iteration moment statistics are computed locally per device and
  merged with the Chan pairwise-combine across the "spp" axis
  (stats/moments.combine_across_axis) -- the exact-merging monoid that
  replaces the reference's mutex film merge (film.cpp:136-151) and
  lock-free tile merge (estimator.cpp:341-407);
* film sample sums merge with a plain psum over "spp".

Because every random draw is addressed by (pixel_id, sample_index)
(core/rng.py), the N-device render equals the 1-device render up to the
order of moment combination (Chan vs serial Meng -- identical in exact
arithmetic), which the tests assert.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import rng as crng
from ..stats import moments
from ..stats import estimator as E
from ..driver import (RenderSetup, make_sample_fn, split_device_args,
                      zero_stats)

from jax import shard_map


def make_mesh(n_spp: int, n_px: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_spp * n_px, "not enough devices"
    arr = np.array(devices[: n_spp * n_px]).reshape(n_spp, n_px)
    return Mesh(arr, ("spp", "px"))


def pad_pixels(P_total: int, n_px: int) -> int:
    return ((P_total + n_px - 1) // n_px) * n_px


def make_sharded_chunk_fn(setup: RenderSetup, mesh: Mesh):
    """Jitted mesh-parallel render chunk.

    All [P]-major arrays (film, states, feedback, pixel ids) must be
    padded so the pixel axis divides the "px" axis size.
    """
    # Scene/BVH tables ride as replicated ARGUMENTS (driver.
    # split_device_args): closed-over tables bake into the program as
    # constants, which caps scene size at the compile-payload limit.
    scene_args, rebuild = split_device_args(setup)
    scene_spec = [P() for _ in scene_args]
    ecfg = setup.ecfg
    n_spp = mesh.shape["spp"]

    state_spec = jax.tree.map(lambda _: P(None, "px"), E.make_states(
        ecfg, mesh.shape["px"]))  # [NB,P,C]: shard pixel axis

    in_specs = (
        state_spec,  # states
        P("px"),  # film_sum
        P("px"),  # film_w
        P(),  # ray_total
        P(),  # base_key
        P(),  # sample_start
        P("px"),  # pixel_ids
        P("px"),  # lane_valid
        P("px"),  # avg_ls
        P("px"),  # win_b
        P("px"),  # win_l
        P(),  # feedback_on
    )
    stats_spec = {k: P() for k in zero_stats()}
    out_specs = (state_spec, P("px"), P("px"), P(), stats_spec)

    def chunk(scene_arrs, states, film_sum, film_w, ray_total, base_key,
              sample_start, pixel_ids, lane_valid, avg_ls, win_b, win_l,
              feedback_on, n_samples):
        sample_step = make_sample_fn(rebuild(scene_arrs))
        my_spp = jax.lax.axis_index("spp")
        # Per-device sample count: device k handles sample indices
        # sample_start + s*n_spp + k, so a remainder (n_samples not a
        # multiple of n_spp) gives the low-index devices one extra
        # sample instead of silently dropping the tail.
        n_local = (n_samples - my_spp + n_spp - 1) // n_spp

        # Fresh per-iteration local statistics (zeros), streamed serially
        # on each device, then Chan-combined across the sample axis.
        local_states = jax.tree.map(jnp.zeros_like, states)
        local_film = jnp.zeros_like(film_sum)
        local_w = jnp.zeros_like(film_w)
        local_rays = jnp.zeros(())
        local_stats = zero_stats()

        def body(s, carry):
            st, fs, fw, rt, sa = carry
            sample_index = sample_start + s * n_spp + my_spp
            return sample_step(
                st, fs, fw, rt, base_key, sample_index, pixel_ids,
                avg_ls, win_b, win_l, feedback_on, sa,
                valid=lane_valid,
            )

        (local_states, local_film, local_w, local_rays,
         local_stats) = jax.lax.fori_loop(
            0, n_local, body,
            (local_states, local_film, local_w, local_rays, local_stats),
        )

        merged = {
            t: moments.combine_across_axis(st, "spp")
            for t, st in local_states.items()
        }
        states = {t: moments.combine(states[t], merged[t]) for t in states}
        film_sum = film_sum + jax.lax.psum(local_film, "spp")
        film_w = film_w + jax.lax.psum(local_w, "spp")
        ray_total = ray_total + jax.lax.psum(
            jax.lax.psum(local_rays, "spp"), "px")
        # STAT counters (statpath.cpp:29-31 equivalents): sums ride a
        # two-axis psum, the path-length max a pmax; the mesh render
        # reports the same counters as the single-device driver.
        stats_delta = {
            k: (jax.lax.pmax(jax.lax.pmax(v, "spp"), "px")
                if k == "path_len_max"
                else jax.lax.psum(jax.lax.psum(v, "spp"), "px"))
            for k, v in local_stats.items()
        }
        return states, film_sum, film_w, ray_total, stats_delta

    sharded = shard_map(
        chunk,
        mesh=mesh,
        in_specs=(scene_spec,) + in_specs + (P(),),
        out_specs=out_specs,
        check_vma=False,
    )

    jitted = jax.jit(sharded, static_argnames=())

    def wrapper(states, film_sum, film_w, ray_total, base_key,
                sample_start, pixel_ids, lane_valid, avg_ls, win_b, win_l,
                feedback_on, n_samples):
        """Returns (states, film_sum, film_w, ray_total, stats_delta);
        stats_delta is this chunk's STAT counter increment.  lane_valid
        marks real (non-pad) pixel lanes; pad lanes render but are kept
        out of the psum'd STAT counters."""
        return jitted(
            scene_args, states, film_sum, film_w, ray_total, base_key,
            sample_start, pixel_ids, lane_valid, avg_ls, win_b, win_l,
            feedback_on, jnp.asarray(n_samples),
        )

    return wrapper


def make_sharded_filter(mesh: Mesh, height: int, width: int, channels: int,
                        n_gbuf: int, radius: int, ds_factor, gb_factors,
                        alpha: float = 0.005):
    """Row-sharded statistical filter with ppermute halo exchange.

    The film/moment buffers live row-sharded over the "px" axis; the
    window filter needs `radius` rows of halo from each neighbor.  Each
    device ships its boundary slabs up/down the axis with
    jax.lax.ppermute (zeros beyond the global edges), runs the filter on
    the extended slab, and keeps the center rows.  This is the mesh-native
    replacement for the reference's single-GPU whole-frame kernel launch
    (estimator.cpp:427-489).

    All [P]-shaped field arrays must reshape to [H, W, C] with H divisible
    by the "px" axis size and local height >= radius.
    """
    from ..denoise.filter_jax import stat_filter
    from ..denoise.ttest import quantile_table

    n_px = mesh.shape["px"]
    assert height % n_px == 0, "height must divide the px axis"
    hl = height // n_px
    assert hl >= radius, "local slab shorter than the filter radius"
    tq = jnp.asarray(quantile_table(alpha))
    r = radius

    def exchange(x):
        """x: [hl, W, C] per device -> [hl + 2r, W, C] with halos."""
        idx = jax.lax.axis_index("px")
        n = n_px
        # Rows I send down to the next device (they become its top halo).
        from_prev = jax.lax.ppermute(
            x[-r:], "px", [(i, i + 1) for i in range(n - 1)]
        )
        from_next = jax.lax.ppermute(
            x[:r], "px", [(i + 1, i) for i in range(n - 1)]
        )
        return jnp.concatenate([from_prev, x, from_next], axis=0)

    def local_filter(n_img, mean, m2, m3, fm, gbufs, film):
        """Per-device body (runs under shard_map).

        n_img: [hl,W]; mean/m2/m3/fm: [hl,W,C]; gbufs: [G,hl,W,3];
        film: [hl,W,3] or None-placeholder (zeros)."""
        n_e = exchange(n_img[..., None])[..., 0]
        mean_e = exchange(mean)
        m2_e = exchange(m2)
        m3_e = exchange(m3)
        fm_e = exchange(fm)
        gb_e = (jnp.stack([exchange(gbufs[g]) for g in range(n_gbuf)])
                if n_gbuf else jnp.zeros((0, hl + 2 * r, width, 3)))
        film_e = exchange(film)
        # Validity: ones locally; ppermute leaves zeros past the global
        # image edges so edge halos carry zero weight.
        valid_e = exchange(jnp.ones((hl, width, 1)))[..., 0]
        res = stat_filter(
            n_e, mean_e, m2_e, m3_e, fm_e, gb_e,
            jnp.asarray(gb_factors, jnp.float32),
            jnp.asarray(ds_factor, jnp.float32), tq, radius,
            film_img=film_e, valid=valid_e,
        )
        return (
            res["mean_corr"][r : r + hl],
            res["discriminator"][r : r + hl],
            res["film_mean_f"][r : r + hl],
            res["film_f"][r : r + hl],
        )

    spec_in = (
        P("px", None), P("px", None, None), P("px", None, None),
        P("px", None, None), P("px", None, None),
        P(None, "px", None, None), P("px", None, None),
    )
    spec_out = (
        P("px", None, None), P("px", None, None), P("px", None, None),
        P("px", None, None),
    )
    return jax.jit(shard_map(
        local_filter, mesh=mesh, in_specs=spec_in, out_specs=spec_out,
        check_vma=False,
    ))


def replicate_scene(setup: RenderSetup, mesh: Mesh) -> RenderSetup:
    """Replicate the scene tables + BVH on every device of the mesh."""
    repl = NamedSharding(mesh, P())

    def put(x):
        return jax.device_put(x, repl) if isinstance(x, jax.Array) else x

    scene = jax.tree.map(put, setup.scene)
    bvh = jax.tree.map(put, setup.bvh) if setup.bvh is not None else None
    import dataclasses

    return dataclasses.replace(setup, scene=scene, bvh=bvh)


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-host bring-up: jax.distributed.initialize + device report.

    The reference has no multi-node path at all (SURVEY.md §2.7: one
    pthread pool + one CUDA device); here the same pjit program spans
    hosts over DCN once every process calls this (scene tables are
    replicated per host by replicate_scene; film/moment reductions ride
    the mesh collectives).  Reads JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID from the environment when args
    are omitted; a single-process call is a no-op.
    """
    import os

    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("JAX_PROCESS_ID", "0")))
    if coordinator_address and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.devices()
