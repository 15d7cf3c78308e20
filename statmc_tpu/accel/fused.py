"""Fused dense intersection: ray x triangle tiles as bilinear forms.

Replaces the reference's per-ray BVH walk (src/accelerators/bvh.cpp:707+,
pointer-chasing over LinearBVHNodes) for small/medium scenes.  A
ray-triangle test is a *bilinear form* in Plucker coordinates, so
testing a ray tile against a triangle tile is two small-K products

    w   [3*Tt, Rt] = edge_rows [3*Tt, 8] @ [d; oxd]    (edge side products)
    n/d [2*Tt, Rt] = plane_rows[2*Tt, 8] @ [d; o; 1]   (plane numer/denom)

followed by a cheap epilogue (sign tests + plane-t + running min).
Per (ray, tri) pair the three edge "side" products decide inside/outside
and one plane equation yields t:

    w_k  = d . (a_k x b_k) + (b_k - a_k) . (o x d)   (edge k: a_k -> b_k)
    hit  = all w_k same sign
    t    = (n.v0 - n.o) / (n.d),   n = e1 x e2

The GPU kernel (Pallas, Triton route) gives each program RAY_BLOCK
rays, keeps their running (t, id) in registers and streams the packed
triangle table through them, evaluating the forms as f32 FMAs on
[_CHUNK, RAY_BLOCK] register tiles: no [R, T] temporary ever touches
device memory.  The plain reference (_intersect_ref, the CPU path)
computes the same forms as dots over the whole ray batch.

Tile culling (the BVH's job, re-shaped): triangles are Morton-ordered
so each TRI_TILE is spatially tight; per tile a conservative AABB is
kept and the kernel first slab-tests its ray block against it.  The
forms and epilogue run only if ANY ray can still hit the box closer
than its current best -- conservative, so results are identical to the
unculled form.  Ray batches arrive in pixel order (primary and shadow
rays are coherent), which is what makes the any() predicate selective.

Precision: every product is IEEE f32 (the reference's dots run at
Precision.HIGHEST; TF32 or bf16 keep too few mantissa bits for the sign
tests).  The sign test accepts both orientations and treats w == 0 as
inside on either side, so shared-edge hits resolve to whichever
triangle is nearer (cf. reference watertight test,
src/shapes/triangle.cpp:160+, which matters at CPU f64 only).

Scenes above FUSED_MAX_TRIS go to the two-level worklist walk
(accel/twolevel.py).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.backend import use_kernel

TRI_TILE = 64  # triangles per table tile (cull granularity)
FUSED_MAX_TRIS = 16384  # above: accel/twolevel.py
RAY_BLOCK = 128  # rays per kernel program
_CHUNK = 16  # triangles per [_CHUNK, RAY_BLOCK] register tile
_REF_TILES = 4  # table tiles per step of the plain reference's scan
_K = 8  # feature columns per triangle row


def _morton(cent: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from [T,3] centroids (10 bits/axis)."""
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.minimum(((cent - lo) / ext * 1024.0).astype(np.uint64), 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << 1)
            | (spread(q[:, 2]) << 2))


class FusedTris(NamedTuple):
    """Packed per-triangle row tables for the bilinear-form test.

    Triangles are Morton-reordered (perm maps packed idx -> original);
    tile_bounds [Ntt, 8] holds each tile's conservative AABB
    (lo3, hi3, pad2) for the in-kernel cull.

    edge_table:  [Ntt, 3, TRI_TILE, 8] f32, rows [cross(a,b), b-a, 0, 0]
                 pairing with ray rows [d, o x d, 0, 0].
    plane_table: [Ntt, 2, TRI_TILE, 8] f32, row 0 (numerator)
                 [0,0,0, -n, n.v0, 0] and row 1 (denominator) [n, 0...],
                 pairing with ray rows [d, o, 1, 0].
    Padded triangle rows are all-zero -> w=0 (inside) but den=0 -> t=inf.
    """

    edge_table: Any
    plane_table: Any
    tile_bounds: Any
    perm: Any
    n_tris: int

    @staticmethod
    def from_tris(p0, e1, e2) -> "FusedTris":
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        T = p0.shape[0]
        if T > 0:
            v0, v1, v2 = p0, p0 + e1, p0 + e2
            tlo = np.minimum(np.minimum(v0, v1), v2)
            thi = np.maximum(np.maximum(v0, v1), v2)
            order = np.argsort(_morton(0.5 * (tlo + thi)), kind="stable")
            p0, e1, e2 = p0[order], e1[order], e2[order]
            tlo, thi = tlo[order], thi[order]
        else:
            order = np.zeros((0,), np.int64)
            tlo = thi = np.zeros((0, 3), np.float32)
        ntt = max(1, -(-T // TRI_TILE))
        Tp = ntt * TRI_TILE
        v0, v1, v2 = p0, p0 + e1, p0 + e2
        n = np.cross(e1, e2)
        er = np.zeros((3, Tp, _K), np.float32)
        for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
            er[k, :T, 0:3] = np.cross(a, b)
            er[k, :T, 3:6] = b - a
        pr = np.zeros((2, Tp, _K), np.float32)
        pr[0, :T, 3:6] = -n
        pr[0, :T, 6] = np.sum(n * v0, axis=-1)
        pr[1, :T, 0:3] = n
        bounds = np.zeros((ntt, 8), np.float32)
        for j in range(ntt):
            a, b = j * TRI_TILE, min((j + 1) * TRI_TILE, T)
            if a >= T:  # all-padding tile: point box no ray can enter
                bounds[j, 0:3] = 1e30
                bounds[j, 3:6] = 1e30
                continue
            lo = tlo[a:b].min(axis=0)
            hi = thi[a:b].max(axis=0)
            eps = 1e-4 * max(1.0, float(np.abs(np.stack([lo, hi])).max()))
            bounds[j, 0:3] = lo - eps
            bounds[j, 3:6] = hi + eps
        # Identity permutation (input already Morton-ordered, see
        # driver._morton_order_scene): store None so intersect paths
        # skip the per-call [T] remap gather entirely.
        if np.array_equal(order, np.arange(T)):
            perm = None
        else:
            perm_np = np.full((Tp,), -1, np.int32)
            perm_np[:T] = order.astype(np.int32)
            perm = jnp.asarray(perm_np)
        return FusedTris(
            edge_table=jnp.asarray(np.ascontiguousarray(
                er.reshape(3, ntt, TRI_TILE, _K).transpose(1, 0, 2, 3))),
            plane_table=jnp.asarray(np.ascontiguousarray(
                pr.reshape(2, ntt, TRI_TILE, _K).transpose(1, 0, 2, 3))),
            tile_bounds=jnp.asarray(bounds),
            perm=perm,
            n_tris=T,
        )


def ray_inv(d):
    """Safe reciprocal direction for slab tests.  The degenerate-component
    fallback keeps the SIGN of d (a tiny negative component must yield a
    large NEGATIVE inverse, or the slab test collapses to tn=tf=0 and the
    cull stops being conservative)."""
    return jnp.where(jnp.abs(d) > 1e-12, 1.0 / jnp.where(d == 0, 1.0, d),
                     jnp.where(d < 0, -1e12, 1e12))


def tri_forms(col, d, m, o):
    """The five bilinear forms of a triangle set against a ray set, as
    f32 multiply-adds in one fixed order shared by every intersector
    (reference and kernels, both levels), so they agree bit for bit
    wherever the compiler contracts alike.

    col(form, f): [n, 1] column f of table form 0-2 (edge k: f 0:3 =
    cross(a_k, b_k), 3:6 = b_k - a_k), 3 (plane numerator: f 0:3 = -n,
    3 = n.v0) or 4 (denominator: f 0:3 = n).  d, m, o: three [1, R] ray
    rows each (direction, o x d, origin).  Returns w0, w1, w2, num, den
    [n, R]."""
    w = []
    for k in range(3):
        acc = col(k, 0) * d[0]
        for f in (1, 2):
            acc = acc + col(k, f) * d[f]
        for f in range(3):
            acc = acc + col(k, 3 + f) * m[f]
        w.append(acc)
    num = col(3, 3) + col(3, 0) * o[0]
    for f in (1, 2):
        num = num + col(3, f) * o[f]
    den = col(4, 0) * d[0]
    for f in (1, 2):
        den = den + col(4, f) * d[f]
    return w[0], w[1], w[2], num, den


def _fused_col(edge, plane):
    """tri_forms column reader over FusedTris tables: edge(k, f) reads
    column f of edge form k, plane(k, f) column f of plane row k."""
    def col(form, f):
        if form < 3:
            return edge(form, f)
        if form == 3:
            return plane(0, 6 if f == 3 else 3 + f)
        return plane(1, f)

    return col


def _ray_rows(o, d):
    """[R,3] rays -> the [1, R] row lists (d, o x d, o) of tri_forms."""
    m = jnp.cross(o, d)
    return tuple([x[:, a][None, :] for a in range(3)] for x in (d, m, o))


def hit_t(w0, w1, w2, num, den):
    """Sign test + plane t on [n, R] forms: t of each inside hit beyond
    the self-intersection epsilon, else 1e30.  Shared by every
    bilinear-form intersector (reference and kernels, both levels)."""
    inf = jnp.float32(1e30)  # Python-literal INF: Pallas kernels cannot
    # capture module-level device constants (cm.INF) as closures.
    wmin = jnp.minimum(jnp.minimum(w0, w1), w2)
    wmax = jnp.maximum(jnp.maximum(w0, w1), w2)
    inside = (wmin >= 0) | (wmax <= 0)
    safe = jnp.abs(den) > 1e-12
    t = jnp.where(safe, num / jnp.where(safe, den, 1.0), inf)
    return jnp.where(inside & (t > 1e-4), t, inf)


def fold_best(tc, ids, best_t, best_id):
    """Fold [n, R] candidate t (ids: their triangle ids, [n, R]) into the
    running [1, R] best.  Ties keep the smallest id, so folding tiles in
    ascending id order with a strict < matches one argmin over all."""
    tmin = jnp.min(tc, axis=0, keepdims=True)
    amin = jnp.min(jnp.where(tc <= tmin, ids, jnp.int32(2**30)), axis=0,
                   keepdims=True)
    better = tmin < best_t
    return (jnp.where(better, tmin, best_t),
            jnp.where(better, amin, best_id))


def _intersect_ref(ft: "FusedTris", o, d, t_max):
    """Plain jnp version of the kernel, unculled (the CPU path and the
    kernel's reference; the cull is conservative so results are
    identical).  Scans _REF_TILES table tiles per step.

    o/d: [R, 3]; returns (t [R], id [R]) in Morton order."""
    ntt = ft.edge_table.shape[0]
    ng = -(-ntt // _REF_TILES)
    pad = ((0, ng * _REF_TILES - ntt),) + ((0, 0),) * 3
    S = _REF_TILES * TRI_TILE

    def steps(table):  # [ntt, k, TT, 8] -> [ng, k, S, 8]
        k = table.shape[1]
        t = jnp.pad(table, pad).reshape(ng, _REF_TILES, k, TRI_TILE, _K)
        return t.transpose(0, 2, 1, 3, 4).reshape(ng, k, S, _K)

    rows = _ray_rows(o, d)
    iota = jax.lax.broadcasted_iota(jnp.int32, (S, o.shape[0]), 0)

    def body(carry, blk):
        eblk, pblk, base = blk
        col = _fused_col(lambda k, f: eblk[k, :, f][:, None],
                         lambda k, f: pblk[k, :, f][:, None])
        tc = hit_t(*tri_forms(col, *rows))
        return fold_best(tc, iota + base, *carry), None

    init = (t_max[None, :], jnp.full((1, o.shape[0]), -1, jnp.int32))
    bases = (jnp.arange(ng) * S).astype(jnp.int32)
    (best_t, best_id), _ = jax.lax.scan(
        body, init, (steps(ft.edge_table), steps(ft.plane_table), bases)
    )
    return best_t[0], best_id[0]


# ---------------------------------------------------------------------------
# GPU kernel


def _kernel(rays_ref, tmax_ref, edge_ref, plane_ref, bounds_ref, t_ref,
            id_ref, *, n_tiles):
    """One program: RAY_BLOCK rays against every triangle tile.
    rays_ref block [16, RB]: rows d(0:3), o x d(3:6), o(6:9), 1/d(9:12)."""
    RB = RAY_BLOCK
    d, m, o, inv = ([rays_ref[f, :].reshape(1, RB) for f in range(a, a + 3)]
                    for a in (0, 3, 6, 9))
    tmax = tmax_ref[:].reshape(1, RB)
    iota = jax.lax.broadcasted_iota(jnp.int32, (_CHUNK, RB), 0)

    def cull(j, best_t):
        """True when any ray enters tile j's box in front of its origin
        and closer than its current best hit."""
        tn = jnp.full((1, RB), -1e30, jnp.float32)
        tf = best_t  # entering beyond the current best cannot improve it
        for a in range(3):
            t0 = (bounds_ref[j, a] - o[a]) * inv[a]
            t1 = (bounds_ref[j, 3 + a] - o[a]) * inv[a]
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        live = (tn <= tf * 1.0001) & (tf > 0)
        return jnp.max(live.astype(jnp.int32)) > 0

    def chunk(j, c0, best):
        def reader(ref):  # [_CHUNK, 1] column f of table row k
            return lambda k, f: ref[j, k, pl.ds(c0, _CHUNK), f].reshape(
                _CHUNK, 1)

        col = _fused_col(reader(edge_ref), reader(plane_ref))
        tc = hit_t(*tri_forms(col, d, m, o))
        return fold_best(tc, iota + (j * TRI_TILE + c0), *best)

    def tile(j, best):
        def work(best):
            for c0 in range(0, TRI_TILE, _CHUNK):
                best = chunk(j, c0, best)
            return best

        return jax.lax.cond(cull(j, best[0]), work, lambda b: b, best)

    best = (tmax, jnp.full((1, RB), -1, jnp.int32))
    # Whole-block liveness skip: lanes of terminated paths carry
    # t_max = 0 (the integrator passes where(active, INF, 0)).
    best = jax.lax.cond(
        jnp.max(tmax) > 0,
        lambda b: jax.lax.fori_loop(0, n_tiles, tile, b),
        lambda b: b, best)
    t_ref[:] = best[0].reshape(RB)
    id_ref[:] = best[1].reshape(RB)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _intersect_pallas(edge_table, plane_table, tile_bounds, rays, t_max,
                      interpret: bool = False):
    """rays: [16, Rp] kernel ray rows, t_max: [Rp] (Rp a multiple of
    RAY_BLOCK) -> (t, id) each [Rp].  Returned ids index the
    Morton-ordered tables (remap via perm)."""
    Rp = t_max.shape[0]
    kern = functools.partial(_kernel, n_tiles=edge_table.shape[0])
    table = pl.BlockSpec(memory_space=pl.ANY)
    flat = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    return pl.pallas_call(
        kern,
        grid=(Rp // RAY_BLOCK,),
        in_specs=[pl.BlockSpec((16, RAY_BLOCK), lambda i: (0, i)), flat,
                  table, table, table],
        out_specs=[flat, flat],
        out_shape=[
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="intersect_fused",
    )(rays, t_max, edge_table, plane_table, tile_bounds)


def kernel_rays(o, d, R_pad):
    """[16, R_pad] kernel ray rows [d, o x d, o, 1/d, 0...]; pad lanes
    carry d = (1,1,1) so 1/d stays finite."""
    R = o.shape[0]
    o = jnp.pad(o, ((0, R_pad - R), (0, 0)))
    d = jnp.pad(d, ((0, R_pad - R), (0, 0)), constant_values=1.0)
    rows = jnp.concatenate(
        [d, jnp.cross(o, d), o, ray_inv(d), jnp.zeros((R_pad, 4))], -1)
    return rows.T


def intersect_fused(ft: FusedTris, o, d, t_max, any_hit: bool = False,
                    compact: bool = False):
    """Closest hit against all triangles.  Returns (t, tri_id, hit); t
    keeps the incoming t_max value on miss (callers compare t < t_max).

    any_hit is accepted for interface parity with the traversal paths;
    the dense form computes every pair either way.

    compact=True partitions live lanes (t_max > 0) to the front with a
    stable 2-bucket counting sort before tiling, so the kernel's
    all-dead ray-block skip actually fires: the integrator's RR kills
    lanes scattered through pixel order, and without the partition a
    ray block is almost never ALL dead.  Results are identical
    (per-lane independent; exact unsort).  Off by default: in the 720p
    staircase render the kernel ran 4 % faster without it (the
    regeneration driver already refills dead lanes; PERF.md)."""
    R = o.shape[0]
    kernel = use_kernel("fused")
    if compact:
        live = t_max > 0
        cs = jnp.cumsum(live.astype(jnp.int32))
        n_live = cs[-1]
        iot = jnp.arange(R, dtype=jnp.int32)
        pos = jnp.where(live, cs - 1, n_live + iot - cs)
        perm = jnp.zeros((R,), jnp.int32).at[pos].set(iot)
        packed = jnp.concatenate([o, d, t_max[:, None]], axis=-1)[perm]
        o, d = packed[:, 0:3], packed[:, 3:6]
        t_max = packed[:, 6]
    if kernel:
        Rp = -(-R // RAY_BLOCK) * RAY_BLOCK
        t, idx = _intersect_pallas(
            ft.edge_table, ft.plane_table, ft.tile_bounds,
            kernel_rays(o, d, Rp), jnp.pad(t_max, (0, Rp - R)))
        t, idx = t[:R], idx[:R]
    else:
        t, idx = _intersect_ref(ft, o, d, t_max)
    # Map Morton-packed ids back to original triangle ids (identity
    # when the scene tables were pre-Morton-ordered: perm is None, and
    # padded-row ids cannot win -- their den=0 makes t=inf).
    if ft.perm is not None:
        idx = jnp.where(idx >= 0, jnp.take(ft.perm, jnp.maximum(idx, 0)),
                        -1)
    else:
        idx = jnp.where(idx >= ft.n_tris, -1, idx)
    if compact:
        # Unsort exactly; t rides as bitcast int32 next to idx (int
        # transport preserves bit patterns, including NaN payloads).
        out = jnp.stack(
            [jax.lax.bitcast_convert_type(t, jnp.int32), idx], axis=-1
        )[pos]
        t = jax.lax.bitcast_convert_type(out[:, 0], jnp.float32)
        idx = out[:, 1]
    return t, idx, idx >= 0
