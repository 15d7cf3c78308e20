"""kd-tree accelerator: pbrt SAH build + stackless kd-restart traversal.

Re-derivation of the reference's KdTreeAccel
(/root/reference/src/accelerators/kdtreeaccel.cpp):

* Build (host numpy): the exact SAH sweep over sorted bound edges with
  traversal/intersection costs, empty bonus, the max-extent axis with
  two retries, the bad-refine counter, and the default depth bound
  8 + 1.3 log2 N (kdtreeaccel.cpp:140-270; parameter defaults :434-439).
* Traversal (device): pbrt walks with an explicit todo STACK
  (kdtreeaccel.cpp:289-356) -- a per-lane stack is hostile to lockstep
  SPMD (divergent depths, scattered memory), so the wavefront shape is
  **kd-restart**: descend from the root clipping [t_lo, t_hi] to the
  near side at every interior node, test the reached leaf, then advance
  t_lo past the leaf and restart from the root.  No stack, bounded
  per-lane state, and every step is two packed-row gathers + masked
  arithmetic inside one lax.while_loop -- the same execution shape as
  the one-hot/take BVH walk (accel/onehot.py).

The kd-tree is selected by the scene's `Accelerator "kdtree"` directive
(api.cpp dispatch); BVH remains the default.  It is a PARITY component,
not the perf path: the restart scheme re-descends O(depth) nodes per
leaf, and the gather walk is scalar-bound -- the fused/two-level
intersectors stay the production accelerators.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as cm

# Leaf flag in the packed node row.
_LEAF = 3


class KdTreeTris(NamedTuple):
    """Flat device tables for the kd-restart walk."""
    node_f: Any   # [N, 1] f32: split position
    node_i: Any   # [N, 4] i32: axis/flags(3=leaf), above_child,
    #                           leaf_offset, leaf_count
    leaf_prims: Any  # [P] i32 flat triangle ids for all leaves
    tri_p0: Any   # [T,3] triangle tables (kept here so the walk is
    tri_e1: Any   # self-contained, mirroring OneHotBVH's leaf_table)
    tri_e2: Any
    world_lo: Any  # [3] scene bound
    world_hi: Any  # [3]
    n_nodes: int
    max_leaf: int  # max primitives in any leaf (static test width)

    @staticmethod
    def from_tris(tri_p0, tri_e1, tri_e2, **kw):
        return build_kdtree(tri_p0, tri_e1, tri_e2, **kw)


def build_kdtree(tri_p0, tri_e1, tri_e2, isect_cost: int = 80,
                 trav_cost: int = 1, empty_bonus: float = 0.5,
                 max_prims: int = 1, max_depth: int = -1) -> KdTreeTris:
    """SAH kd-tree over triangles (kdtreeaccel.cpp:84-270 semantics,
    iterative instead of recursive; numpy edge sweeps)."""
    p0 = np.asarray(tri_p0, np.float64)
    e1 = np.asarray(tri_e1, np.float64)
    e2 = np.asarray(tri_e2, np.float64)
    T = p0.shape[0]
    v1, v2 = p0 + e1, p0 + e2
    blo = np.minimum(np.minimum(p0, v1), v2)
    bhi = np.maximum(np.maximum(p0, v1), v2)
    wlo = blo.min(0) if T else np.zeros(3)
    whi = bhi.max(0) if T else np.ones(3)
    if max_depth <= 0:
        max_depth = int(round(8 + 1.3 * np.log2(max(T, 1))))

    node_f: list[float] = []
    node_i: list[tuple] = []
    leaf_prims: list[int] = []
    max_leaf = 1

    def make_leaf(prims):
        nonlocal max_leaf
        off = len(leaf_prims)
        leaf_prims.extend(int(p) for p in prims)
        max_leaf = max(max_leaf, len(prims))
        node_f.append(0.0)
        node_i.append((_LEAF, -1, off, len(prims)))

    # Iterative depth-first build; the second-child link patches in
    # after the below subtree emits (pbrt's AboveChild pointer,
    # kdtreeaccel.cpp:246-266).
    stack = [(np.arange(T), wlo.copy(), whi.copy(), max_depth, 0, -1)]
    while stack:
        prims, nlo, nhi, depth, bad, patch = stack.pop()
        node_id = len(node_i)
        if patch >= 0:  # we are the above-child of node `patch`
            f, _, lo_, lc_ = node_i[patch]
            node_i[patch] = (f, node_id, lo_, lc_)
        n = len(prims)
        if n <= max_prims or depth == 0:
            make_leaf(prims)
            continue
        d = nhi - nlo
        inv_sa = 1.0 / max(
            2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]), 1e-30)
        old_cost = isect_cost * n
        best = (np.inf, -1, -1.0, None, None)  # cost, axis, t, below, above
        axis = int(np.argmax(d))
        for retry in range(3):
            ax = (axis + retry) % 3
            lo_e = blo[prims, ax]
            hi_e = bhi[prims, ax]
            # Edge list: (t, type) with starts before ends at equal t
            # (the sort predicate at kdtreeaccel.cpp:191-197).
            ts = np.concatenate([lo_e, hi_e])
            typ = np.concatenate([np.zeros(n, np.int8),
                                  np.ones(n, np.int8)])
            order = np.lexsort((typ, ts))
            ts_s, typ_s = ts[order], typ[order]
            ends_before = np.cumsum(typ_s) - typ_s  # ends strictly before i
            starts_before = np.arange(2 * n) - ends_before
            n_above = n - ends_before - typ_s  # end at i decrements first
            n_below = starts_before
            oa0, oa1 = (ax + 1) % 3, (ax + 2) % 3
            inside = (ts_s > nlo[ax]) & (ts_s < nhi[ax])
            below_sa = 2 * (d[oa0] * d[oa1]
                            + (ts_s - nlo[ax]) * (d[oa0] + d[oa1]))
            above_sa = 2 * (d[oa0] * d[oa1]
                            + (nhi[ax] - ts_s) * (d[oa0] + d[oa1]))
            eb = np.where((n_above == 0) | (n_below == 0), empty_bonus,
                          0.0)
            cost = trav_cost + isect_cost * (1 - eb) * inv_sa * (
                below_sa * n_below + above_sa * n_above)
            cost = np.where(inside, cost, np.inf)
            j = int(np.argmin(cost)) if len(cost) else 0
            if len(cost) and np.isfinite(cost[j]) and cost[j] < best[0]:
                t_split = float(ts_s[j])
                below = prims[lo_e < t_split]
                above = prims[hi_e > t_split]
                # Edge-exact membership (pbrt classifies by the sorted
                # edge index, :246-252): prims whose lo == t_split and
                # are flat at the plane go above for start edges.
                flat = prims[(lo_e == t_split) & (hi_e == t_split)]
                if typ_s[j] == 0:  # start edge: flat prims go above
                    above = np.union1d(above, flat)
                else:
                    below = np.union1d(below, flat)
                best = (float(cost[j]), ax, t_split, below, above)
            if best[1] >= 0:
                break
        bcost, bax, bt, below, above = best
        if bcost > old_cost:
            bad += 1
        if (bax < 0 or bad == 3
                or (bcost > 4 * old_cost and n < 16)):
            make_leaf(prims)
            continue
        node_f.append(bt)
        node_i.append((bax, -1, 0, 0))  # above_child patched later
        lo_b, hi_b = nlo.copy(), nhi.copy()
        hi_b[bax] = bt
        lo_a, hi_a = nlo.copy(), nhi.copy()
        lo_a[bax] = bt
        # Push above first so below (node_id + 1) emits next (pbrt's
        # children-contiguous-below layout).
        stack.append((above, lo_a, hi_a, depth - 1, bad, node_id))
        stack.append((below, lo_b, hi_b, depth - 1, bad, -1))

    if not node_i:
        make_leaf(np.arange(T))
    if not leaf_prims:
        leaf_prims.append(-1)
    return KdTreeTris(
        node_f=jnp.asarray(np.asarray(node_f, np.float32)[:, None]),
        node_i=jnp.asarray(np.asarray(node_i, np.int32)),
        leaf_prims=jnp.asarray(np.asarray(leaf_prims, np.int32)),
        tri_p0=jnp.asarray(np.asarray(tri_p0, np.float32)),
        tri_e1=jnp.asarray(np.asarray(tri_e1, np.float32)),
        tri_e2=jnp.asarray(np.asarray(tri_e2, np.float32)),
        world_lo=jnp.asarray(wlo.astype(np.float32)),
        world_hi=jnp.asarray(whi.astype(np.float32)),
        n_nodes=len(node_i),
        max_leaf=int(max_leaf),
    )


_RAY_CHUNK = 32768


def _walk_chunk_v2(kd: KdTreeTris, o, d, t_max, any_hit: bool):
    """kd-restart: one while_loop whose state carries the current pass
    interval [t_lo, t_hi] (clipped during descent) plus the best hit."""
    R = o.shape[0]
    eps = 1e-4
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d,
                      jnp.sign(d) * 1e12 + 1e12)
    b0 = (kd.world_lo[None, :] - o) * inv_d
    b1 = (kd.world_hi[None, :] - o) * inv_d
    t_enter = jnp.maximum(jnp.max(jnp.minimum(b0, b1), -1), 0.0)
    t_exit = jnp.min(jnp.maximum(b0, b1), -1)
    miss_scene = t_enter > jnp.minimum(t_exit, t_max)
    KL = kd.max_leaf
    n_steps = 8 * kd.n_nodes + 64

    def cond(st):
        return (st["it"] < n_steps) & jnp.any(~st["done"])

    def body(st):
        nid = jnp.maximum(st["node"], 0)
        row_i = jnp.take(kd.node_i, nid, axis=0)
        split = jnp.take(kd.node_f, nid, axis=0)[:, 0]
        ax = row_i[:, 0]
        is_leaf = ax == _LEAF
        live = ~st["done"]
        t_lo, t_hi = st["t_lo"], st["t_hi"]

        # Interior descent: clip [t_lo, t_hi] to the child containing
        # the interval (or its near part when it crosses the split).
        axc = jnp.minimum(ax, 2)
        o_ax = jnp.take_along_axis(o, axc[:, None], -1)[:, 0]
        d_ax = jnp.take_along_axis(d, axc[:, None], -1)[:, 0]
        inv_ax = jnp.take_along_axis(inv_d, axc[:, None], -1)[:, 0]
        t_split = (split - o_ax) * inv_ax
        below = nid + 1
        above = row_i[:, 1]
        crosses = (t_split > t_lo) & (t_split < t_hi)
        # Before the crossing a ray moving +ax is on the below side;
        # when the interval does not cross, classify by its midpoint
        # (eps-tolerant: straddling prims live in BOTH children).
        p_mid = o_ax + 0.5 * (t_lo + t_hi) * d_ax
        near_below = jnp.where(crosses, d_ax > 0, p_mid < split)
        node_desc = jnp.where(near_below, below, above)
        t_hi_desc = jnp.where(crosses, t_split, t_hi)

        # Leaf test (same Moller-Trumbore as accel/onehot.py).
        leaf_live = is_leaf & live
        off = row_i[:, 2]
        cnt = row_i[:, 3]
        ids = jnp.take(kd.leaf_prims,
                       jnp.minimum(off[:, None] + jnp.arange(KL)[None, :],
                                   kd.leaf_prims.shape[0] - 1))
        in_cnt = jnp.arange(KL)[None, :] < cnt[:, None]
        tri = jnp.maximum(ids, 0)
        p0 = jnp.take(kd.tri_p0, tri, axis=0)
        e1 = jnp.take(kd.tri_e1, tri, axis=0)
        e2 = jnp.take(kd.tri_e2, tri, axis=0)
        oo = o[:, None, :]
        dd = d[:, None, :]
        pvec = jnp.cross(dd, e2)
        det = jnp.sum(e1 * pvec, -1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = oo - p0
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(dd * qvec, -1) * inv_det
        t = jnp.sum(e2 * qvec, -1) * inv_det
        ok = (leaf_live[:, None] & in_cnt & (ids >= 0)
              & (jnp.abs(det) > 1e-12)
              & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > eps) & (t < st["t_best"][:, None]))
        t = jnp.where(ok, t, cm.INF)
        j = jnp.argmin(t, -1)
        tj = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
        idj = jnp.take_along_axis(ids, j[:, None], -1)[:, 0]
        found = tj < st["t_best"]
        t_best = jnp.where(found & leaf_live, tj, st["t_best"])
        best_id = jnp.where(found & leaf_live, idj, st["best_id"])

        # Leaf epilogue: restart from the root past this pass's t_hi.
        new_lo = t_hi + eps * jnp.maximum(1.0, jnp.abs(t_hi))
        lim = jnp.minimum(t_exit, jnp.minimum(t_best, t_max))
        done_leaf = leaf_live & ((new_lo >= lim)
                                 | (any_hit & (best_id >= 0)))
        node = jnp.where(is_leaf, 0, node_desc)
        t_lo_n = jnp.where(is_leaf, new_lo, t_lo)
        t_hi_n = jnp.where(is_leaf, lim, t_hi_desc)
        node = jnp.where(live, node, st["node"])
        return dict(
            it=st["it"] + 1, node=node,
            t_lo=jnp.where(live, t_lo_n, t_lo),
            t_hi=jnp.where(live, t_hi_n, t_hi),
            t_best=t_best, best_id=best_id,
            done=st["done"] | done_leaf,
        )

    st = dict(
        it=jnp.int32(0),
        node=jnp.zeros((R,), jnp.int32),
        t_lo=t_enter,
        t_hi=jnp.minimum(t_exit, t_max),
        t_best=t_max,
        best_id=-jnp.ones((R,), jnp.int32),
        done=miss_scene | (t_max <= 0),
    )
    st = jax.lax.while_loop(cond, body, st)
    return st["t_best"], st["best_id"], st["best_id"] >= 0


def intersect_kdtree(kd: KdTreeTris, o, d, t_max, any_hit: bool = False):
    """Closest-hit (or any-hit) through the kd-restart walk.
    Returns (t [R], tri_id [R] (-1 miss), hit [R])."""
    R = o.shape[0]
    if R <= _RAY_CHUNK:
        return _walk_chunk_v2(kd, o, d, t_max, any_hit)
    n = (R + _RAY_CHUNK - 1) // _RAY_CHUNK
    Rp = n * _RAY_CHUNK

    def pad(x, fill=0.0):
        w = [(0, Rp - R)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, w, constant_values=fill)

    o_p = pad(o).reshape(n, _RAY_CHUNK, 3)
    d_p = pad(d, 1.0).reshape(n, _RAY_CHUNK, 3)
    tm_p = pad(t_max).reshape(n, _RAY_CHUNK)
    t, idx, hit = jax.lax.map(
        lambda a: _walk_chunk_v2(kd, a[0], a[1], a[2], any_hit),
        (o_p, d_p, tm_p))
    return t.reshape(-1)[:R], idx.reshape(-1)[:R], hit.reshape(-1)[:R]
