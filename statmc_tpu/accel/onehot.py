"""One-hot BVH traversal: gathers as matmuls.

The classic BVH walk is a per-lane pointer chase whose node fetches
become XLA gathers -- scalar-bound on a wide accelerator, far slower
per primitive than brute force.  This module reformulates the fetch:
each traversal step materializes a one-hot row per ray over the node axis and fetches
the node record with one f32 matmul

    row[r, :] = onehot[r, N] @ node_table[N, K]

A 0/1 one-hot times f32 data at Precision.HIGHEST is EXACT (each output
sums one x*1 against x*0 terms), so geometry fetched this way is
bit-identical to a gather -- but it runs as a matmul instead of the
scalar gather path.  (A default-precision f32 matmul may run in TF32
on the GPU and silently corrupt >8-bit integer links -- HIGHEST is
load-bearing.)

Two tables keep the hot loop lean:
  trav_table [N, 8]:  bbox lo(3) hi(3), miss link, leaf flag
  leaf_table [N, 48]: 4 inline triangles as (p0,e1,e2) + 4 tri ids
Both are fetched every iteration (a lax.cond gate around the leaf fetch
measured slower -- leaves are live most iterations and the cond blocks
loop pipelining).

Scaling: cost per step is R x N MACs, so this pays off while the node
table is small (<= ~4k nodes / ~16k triangles); larger scenes fall back
to the gather walk (accel/traverse.py) until the two-level cluster
scheme lands.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as cm
from .bvh import LEAF_SIZE, FlatBVH

ONEHOT_MAX_NODES = 4096
_RAY_CHUNK = 32768


class OneHotBVH(NamedTuple):
    trav_table: Any  # [N, 8] f32
    leaf_table: Any  # [N, 10*L] f32: L tris x (p0,e1,e2) then L ids
    n_nodes: int
    leaf_size: int

    @staticmethod
    def from_flat(bvh: FlatBVH, tri_p0, tri_e1, tri_e2,
                  leaf_size: int = LEAF_SIZE) -> "OneHotBVH":
        L = leaf_size
        lo = np.asarray(bvh.node_lo)
        hi = np.asarray(bvh.node_hi)
        miss = np.asarray(bvh.node_miss)
        leaf = np.asarray(bvh.node_leaf_off)
        slots = np.asarray(bvh.prim_slots)
        N = lo.shape[0]
        trav = np.zeros((N, 8), np.float32)
        trav[:, 0:3] = lo
        trav[:, 3:6] = hi
        trav[:, 6] = miss.astype(np.float32)
        trav[:, 7] = (leaf >= 0).astype(np.float32)
        leaf_t = np.zeros((N, 10 * L), np.float32)
        leaf_t[:, 9 * L :] = -1.0
        p0 = np.asarray(tri_p0)
        e1 = np.asarray(tri_e1)
        e2 = np.asarray(tri_e2)
        for i in range(N):
            if leaf[i] < 0:
                continue
            ids = slots[leaf[i] : leaf[i] + L]
            for k, t in enumerate(ids):
                base = 9 * k
                if t >= 0:
                    leaf_t[i, base : base + 3] = p0[t]
                    leaf_t[i, base + 3 : base + 6] = e1[t]
                    leaf_t[i, base + 6 : base + 9] = e2[t]
                leaf_t[i, 9 * L + k] = float(t)
        return OneHotBVH(
            trav_table=jnp.asarray(trav),
            leaf_table=jnp.asarray(leaf_t),
            n_nodes=N,
            leaf_size=L,
        )


def _onehot_fetch(onehot, table):
    return jax.lax.dot_general(
        onehot, table,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _traverse_chunk(trav_table, leaf_table, n_nodes: int, leaf_size: int,
                    o, d, t_max, any_hit: bool, use_onehot: bool = True):
    R = o.shape[0]
    L = leaf_size
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, jnp.sign(d) * 1e12 + 1e12)
    iota = jnp.arange(n_nodes, dtype=jnp.int32)

    def cond(state):
        it, node, _, _, done = state
        return (it < n_nodes) & jnp.any(~done)

    def body(state):
        it, node, t_best, best_id, done = state
        nid = jnp.maximum(node, 0)
        if use_onehot:
            onehot = (nid[:, None] == iota[None, :]).astype(jnp.float32)
            row = _onehot_fetch(onehot, trav_table)  # [R, 8]
        else:
            # Packed-row gather: one contiguous-row jnp.take per table.
            # Scales to any node count (no [R, N] one-hot); measured
            # within ~30%% of the one-hot fetch at small N.
            row = jnp.take(trav_table, nid, axis=0)

        lo = row[:, 0:3]
        hi = row[:, 3:6]
        miss = row[:, 6].astype(jnp.int32)
        is_leaf = row[:, 7] > 0.0
        live = ~done

        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tfar = jnp.min(jnp.maximum(t0, t1), axis=-1) * 1.0001
        bbox_hit = (tnear <= tfar) & (tfar > 0.0) & (tnear < t_best) & live
        leaf_active = bbox_hit & is_leaf

        # Leaf payload fetch + L-wide Moller-Trumbore.  Fetched every
        # iteration: a lax.cond gate measured slower (the branch runs
        # most iterations anyway and the cond blocks pipelining).
        if use_onehot:
            lrow = _onehot_fetch(onehot, leaf_table)  # [R, 10L]
        else:
            lrow = jnp.take(leaf_table, nid, axis=0)
        tris = lrow[:, 0 : 9 * L].reshape(R, L, 9)
        tri_ids = lrow[:, 9 * L :].astype(jnp.int32)
        p0 = tris[:, :, 0:3]
        e1 = tris[:, :, 3:6]
        e2 = tris[:, :, 6:9]
        oo = o[:, None, :]
        dd = d[:, None, :]
        pvec = jnp.cross(dd, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = oo - p0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(dd * qvec, axis=-1) * inv_det
        t = jnp.sum(e2 * qvec, axis=-1) * inv_det
        ok = (
            leaf_active[:, None]
            & (tri_ids >= 0)
            & (jnp.abs(det) > 1e-12)
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 1e-4) & (t < t_best[:, None])
        )
        t = jnp.where(ok, t, cm.INF)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        idj = jnp.take_along_axis(tri_ids, j[:, None], axis=-1)[:, 0]
        found = tj < t_best
        t_best = jnp.where(found, tj, t_best)
        best_id = jnp.where(found, idj, best_id)

        internal_hit = bbox_hit & ~is_leaf
        nxt = jnp.where(internal_hit, nid + 1, miss)
        node = jnp.where(live, nxt, node)
        done = done | (node < 0)
        if any_hit:
            done = done | (best_id >= 0)
        return it + 1, node, t_best, best_id, done

    state = (
        jnp.int32(0),
        jnp.zeros((R,), jnp.int32),
        t_max,
        -jnp.ones((R,), jnp.int32),
        jnp.zeros((R,), bool),
    )
    _, _, t_best, best_id, _ = jax.lax.while_loop(cond, body, state)
    return t_best, best_id, best_id >= 0


def intersect_onehot(bvh: OneHotBVH, o, d, t_max, any_hit: bool = False):
    """Closest-hit (or any-hit) via packed-table traversal: one-hot matmul
    fetch for small node tables, contiguous-row gather fetch beyond.
    Returns (t_best [R], tri_idx [R] (-1 miss), hit [R])."""
    R = o.shape[0]
    use_onehot = bvh.n_nodes <= ONEHOT_MAX_NODES
    if R <= _RAY_CHUNK:
        return _traverse_chunk(
            bvh.trav_table, bvh.leaf_table, bvh.n_nodes, bvh.leaf_size,
            o, d, t_max, any_hit, use_onehot,
        )

    n = (R + _RAY_CHUNK - 1) // _RAY_CHUNK
    Rp = n * _RAY_CHUNK

    def pad(x, fill=0.0):
        w = [(0, Rp - R)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, w, constant_values=fill)

    o_p = pad(o).reshape(n, _RAY_CHUNK, 3)
    d_p = pad(d, 1.0).reshape(n, _RAY_CHUNK, 3)
    tm_p = pad(t_max).reshape(n, _RAY_CHUNK)
    t_best, best_id, hit = jax.lax.map(
        lambda args: _traverse_chunk(
            bvh.trav_table, bvh.leaf_table, bvh.n_nodes, bvh.leaf_size,
            args[0], args[1], args[2], any_hit, use_onehot,
        ),
        (o_p, d_p, tm_p),
    )
    return (
        t_best.reshape(-1)[:R],
        best_id.reshape(-1)[:R],
        hit.reshape(-1)[:R],
    )
