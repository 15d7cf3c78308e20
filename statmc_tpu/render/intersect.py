"""Primitive intersection tests + hit assembly.

Functional replacement for the reference's Shape::Intersect virtuals
(src/shapes/triangle.cpp, src/shapes/sphere.cpp) and
Scene::Intersect/IntersectP (src/core/scene.cpp).  All tests are
vectorized: a [R]-lane ray batch is tested against primitive sets with
broadcasting; the BVH (accel/) narrows the candidate set for large
scenes, while small scenes use the dense all-pairs path, which maps
perfectly onto wide vector hardware.

Triangles use Moller-Trumbore on precomputed (p0, e1, e2); the
reference's watertight transform-to-ray-space test (triangle.cpp:160+)
guards against edge leaks that matter at f64 CPU precision; at f32 on
the device both tests have comparable robustness and MT is 2x cheaper.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as cm
from ..scene.build import SceneTables

Array = jax.Array

PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPH = 2


class Hit(NamedTuple):
    """SoA hit record for a ray batch."""
    t: Any  # [R] hit distance (INF if miss)
    prim_kind: Any  # [R] PRIM_*
    prim_idx: Any  # [R]
    p: Any  # [R,3] hit point
    ng: Any  # [R,3] geometric normal (faceforward'd to wo later)
    ns: Any  # [R,3] shading normal
    uv: Any  # [R,2]
    mat_id: Any  # [R]
    light_id: Any  # [R] area-light id or -1
    uv_density: Any  # [R] sqrt(uv area / world area): ray-cone LOD factor
    # dpdu tangent [R,3], only materialized for scenes with hair
    # materials (the Marschner frame needs the curve axis,
    # hair.cpp:420 wo.x convention); None otherwise -- a static gate.
    tangent: Any = None
    # [R,2,2] anisotropic uv footprint axes per unit ray-cone width
    # (major, minor), only for scenes with image textures (EWA path,
    # scene/textures.py:_ewa_lookup); None otherwise.
    uv_axes: Any = None

    @property
    def found(self):
        return self.prim_kind != PRIM_NONE


def ray_triangles(o: Array, d: Array, p0: Array, e1: Array, e2: Array,
                  t_max: Array) -> tuple[Array, Array, Array, Array]:
    """Moller-Trumbore: rays [R,3] x tris [T,3] -> (t, u, v, hit) all [R,T]."""
    # Broadcast [R,1,3] vs [1,T,3].
    o = o[:, None, :]
    d = d[:, None, :]
    p0, e1, e2 = p0[None], e1[None], e2[None]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 1e-4) & (t < t_max[:, None])
    )
    return t, u, v, hit


def ray_spheres(o: Array, d: Array, center: Array, radius: Array,
                t_max: Array) -> tuple[Array, Array]:
    """Quadratic sphere test: rays [R,3] x spheres [S] -> (t, hit) [R,S]."""
    oc = o[:, None, :] - center[None]
    b = jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius[None] ** 2
    disc = b * b - c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    eps = 1e-3
    t = jnp.where(t0 > eps, t0, t1)
    hit = ok & (t > eps) & (t < t_max[:, None])
    return t, hit


def _assemble_hit(scene: SceneTables, o, d, t_best, kind, idx,
                  lean: bool = False,
                  want_tangent: bool | None = None) -> Hit:
    """Gather hit attributes for the closest primitives.

    lean=True skips the shading-only attributes (uv, material id,
    uv_density, interpolated ns as output) and gathers a smaller packed
    row -- used by the BSDF-MIS light probe, which only reads found /
    light_id / ng / p (statpath's EstimateDirect BSDF half,
    statpath.cpp:663-700).  ng keeps its exact orientation semantics
    (flip toward interpolated ns, triangle.cpp:372), so Le sidedness is
    identical to the full assembly."""
    R = o.shape[0]
    tri_idx = jnp.where(kind == PRIM_TRI, idx, 0)
    sph_idx = jnp.where(kind == PRIM_SPH, idx, 0)
    from ..scene.build import scene_has_hair
    from ..scene.textures import has_image_textures

    # want_tangent=None -> hair scenes only (the Marschner frame);
    # exact-lockstep parity forces it on so every BSDF frame is
    # pbrt's ss=normalize(dpdu) frame (core/reflection.h BSDF ctor).
    if want_tangent is None:
        want_tangent = scene_has_hair(scene)
    want_tangent = (not lean) and want_tangent
    want_axes = (not lean) and has_image_textures(scene.textures)
    tangent = None
    uv_axes = None

    p = o + t_best[:, None] * d

    has_tris = scene.tri_p0.shape[0] > 0
    has_sph = scene.sph_center.shape[0] > 0

    if has_tris:
        # One contiguous-row gather for all triangle attributes: device
        # gathers cost per row, not per element, so fetching a packed
        # [T, 27] row beats 12 separate per-field gathers.  The concatenate is a
        # [T, 27] copy, negligible and CSE'd across calls within a jit.
        fields = [
            scene.tri_p0, scene.tri_e1, scene.tri_e2,
            scene.tri_n0, scene.tri_n1, scene.tri_n2,
        ]
        if not lean:
            fields += [scene.tri_uv0, scene.tri_uv1, scene.tri_uv2]
        fields += [
            scene.tri_has_normals[:, None].astype(jnp.float32),
            scene.tri_light[:, None].astype(jnp.float32),
        ]
        if not lean:
            fields += [scene.tri_mat[:, None].astype(jnp.float32)]
        packed = jnp.concatenate(fields, axis=-1)
        row = jnp.take(packed, tri_idx, axis=0)
        p0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        b = 18 if lean else 24
        hasn = row[:, b] > 0.5
        light_t = jnp.round(row[:, b + 1]).astype(jnp.int32)
        mat_t = (jnp.zeros((R,), jnp.int32) if lean
                 else jnp.round(row[:, 26]).astype(jnp.int32))
        ng_t = cm.normalize(jnp.cross(e1, e2))
        # Recompute barycentrics at the hit for uv/shading normals.
        pvec = jnp.cross(d, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o - p0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        v = jnp.sum(d * jnp.cross(tvec, e1), axis=-1) * inv_det
        w = 1.0 - u - v
        ns_t = cm.normalize(
            w[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
        )
        # pbrt orients the geometric normal toward the shading normal
        # when shading normals exist (triangle.cpp:372).
        ng_t = jnp.where(
            (hasn & (cm.dot(ng_t, ns_t) < 0.0))[:, None], -ng_t, ng_t
        )
        ns_t = jnp.where(hasn[:, None], ns_t, ng_t)
        if lean:
            uv_t = jnp.zeros((R, 2))
            dens_t = jnp.zeros((R,))
        else:
            uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
            uv_t = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
            uv_area = jnp.abs(
                (uv1 - uv0)[:, 0] * (uv2 - uv0)[:, 1]
                - (uv1 - uv0)[:, 1] * (uv2 - uv0)[:, 0]
            )
            w_area = cm.length(jnp.cross(e1, e2))
            dens_t = jnp.sqrt(uv_area / jnp.maximum(w_area, 1e-12))
            if want_tangent:
                # dpdu from the uv parameterization (triangle.cpp:309
                # partial-derivative solve): the Marschner hair frame
                # needs the curve axis (u varies along the ribbon
                # length, scene/tessellate.py curve()).
                duv1, duv2 = uv1 - uv0, uv2 - uv0
                det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
                inv_uv = jnp.where(jnp.abs(det_uv) > 1e-12,
                                   1.0 / det_uv, 0.0)[:, None]
                tan_t = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_uv
                degen = jnp.sum(tan_t * tan_t, -1, keepdims=True) < 1e-16
                tan_t = cm.normalize(jnp.where(degen, e1, tan_t))
            if want_axes:
                # Anisotropic uv footprint per unit ray-cone width
                # (mipmap.h:Lookup dst0/dst1 stand-in): the cone's disc
                # projects onto the surface as an ellipse whose major
                # axis follows the view direction stretched by 1/cos.
                if not want_tangent:
                    duv1, duv2 = uv1 - uv0, uv2 - uv0

                def world_to_uv(wv):
                    # Solve wv = s*e1 + t*e2 (in-plane least squares)
                    # -> uv displacement s*duv1 + t*duv2.
                    g11 = jnp.sum(e1 * e1, -1)
                    g12 = jnp.sum(e1 * e2, -1)
                    g22 = jnp.sum(e2 * e2, -1)
                    b1 = jnp.sum(wv * e1, -1)
                    b2 = jnp.sum(wv * e2, -1)
                    det = g11 * g22 - g12 * g12
                    inv = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)
                    s_ = (g22 * b1 - g12 * b2) * inv
                    t_ = (g11 * b2 - g12 * b1) * inv
                    return s_[:, None] * duv1 + t_[:, None] * duv2

                cos_v = jnp.abs(jnp.sum(d * ng_t, -1))
                proj = d - jnp.sum(d * ng_t, -1, keepdims=True) * ng_t
                plen = jnp.linalg.norm(proj, axis=-1, keepdims=True)
                mhat = jnp.where(plen > 1e-6, proj / jnp.maximum(plen, 1e-12),
                                 cm.normalize(e1))
                stretch = 1.0 / jnp.maximum(cos_v, 0.05)
                minor_w = jnp.cross(ng_t, mhat)
                axes_t = jnp.stack([
                    world_to_uv(mhat) * stretch[:, None],
                    world_to_uv(minor_w),
                ], axis=1)  # [R, 2, 2]
    if has_sph:
        cen = scene.sph_center[sph_idx]
        dir_s = cm.normalize(p - cen)  # outward radial dir (drives uv)
        # ReverseOrientation / handedness sign (core/shape.cpp:49).
        if scene.sph_flip is not None:
            ng_s = dir_s * scene.sph_flip[sph_idx][:, None]
        else:
            ng_s = dir_s
        ns_s = ng_s
        light_s = scene.sph_light[sph_idx]
        if lean:
            uv_s = jnp.zeros((R, 2))
            mat_s = jnp.zeros((R,), jnp.int32)
            dens_s = jnp.zeros((R,))
        else:
            phi = jnp.arctan2(dir_s[..., 1], dir_s[..., 0])
            theta = jnp.arccos(jnp.clip(dir_s[..., 2], -1.0, 1.0))
            uv_s = jnp.stack(
                [phi / (2 * jnp.pi) + 0.5, theta / jnp.pi], axis=-1
            )
            mat_s = scene.sph_mat[sph_idx]
            rad = scene.sph_radius[sph_idx]
            dens_s = 1.0 / jnp.sqrt(jnp.maximum(
                4.0 * jnp.pi * rad * rad, 1e-12))

    if has_tris and has_sph:
        is_t = (kind == PRIM_TRI)[:, None]
        ng = jnp.where(is_t, ng_t, ng_s)
        ns = jnp.where(is_t, ns_t, ns_s)
        uv = jnp.where(is_t, uv_t, uv_s)
        mat = jnp.where(kind == PRIM_TRI, mat_t, mat_s)
        light = jnp.where(kind == PRIM_TRI, light_t, light_s)
        dens = jnp.where(kind == PRIM_TRI, dens_t, dens_s)
        if want_tangent:
            # Sphere dpdu = d(phi) direction; hair only rides triangles
            # so the zenith-tangent fallback is fine for spheres.
            tangent = jnp.where(is_t, tan_t, jnp.stack(
                [-dir_s[..., 1], dir_s[..., 0],
                 jnp.zeros_like(dir_s[..., 0])], -1))
        if want_axes:
            # Spheres fall back to an isotropic footprint of uv_density.
            # NB is_t is already [R,1]; index the raw kind mask so the
            # select broadcasts [R,1,1] against the [R,2,2] axes.
            iso = dens_s[:, None, None] * jnp.eye(2)
            uv_axes = jnp.where((kind == PRIM_TRI)[:, None, None],
                                axes_t, iso)
    elif has_tris:
        ng, ns, uv, mat, light, dens = ng_t, ns_t, uv_t, mat_t, light_t, dens_t
        if want_tangent:
            tangent = tan_t
        if want_axes:
            uv_axes = axes_t
    elif has_sph:
        ng, ns, uv, mat, light, dens = ng_s, ns_s, uv_s, mat_s, light_s, dens_s
    else:
        ng = ns = jnp.zeros((R, 3))
        uv = jnp.zeros((R, 2))
        mat = jnp.zeros((R,), jnp.int32)
        light = -jnp.ones((R,), jnp.int32)
        dens = jnp.zeros((R,))

    miss = kind == PRIM_NONE
    return Hit(
        t=t_best,
        prim_kind=kind,
        prim_idx=idx,
        p=p,
        ng=jnp.where(miss[:, None], 0.0, ng),
        ns=jnp.where(miss[:, None], 0.0, ns),
        uv=uv,
        mat_id=jnp.where(miss, 0, mat),
        light_id=jnp.where(miss, -1, light),
        uv_density=jnp.where(miss, 0.0, dens),
        tangent=tangent,
        uv_axes=uv_axes,
    )


# Chunking bounds: keep every [rays, tris] temporary under ~100 MB so
# arbitrary resolutions fit HBM (the all-pairs form at 512x512 x 2k tris
# would otherwise materialize multi-GB intermediates).
RAY_CHUNK = 32768
TRI_CHUNK = 512


def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill)


def _dense_closest_tris(scene, o, d, t_best):
    """Closest triangle hit for one ray chunk, scanning triangle chunks."""
    T = scene.tri_p0.shape[0]
    TC = min(TRI_CHUNK, T)
    n_chunks = (T + TC - 1) // TC
    Tp = n_chunks * TC
    p0 = _pad_to(scene.tri_p0, Tp)
    e1 = _pad_to(scene.tri_e1, Tp)
    # Padded triangles are degenerate (e2 = 0) -> det ~ 0 -> no hit.
    e2 = _pad_to(scene.tri_e2, Tp)
    p0 = p0.reshape(n_chunks, TC, 3)
    e1 = e1.reshape(n_chunks, TC, 3)
    e2 = e2.reshape(n_chunks, TC, 3)

    def body(carry, chunk):
        t_best, best = carry
        cp0, ce1, ce2, base = chunk
        t, _, _, hit = ray_triangles(o, d, cp0, ce1, ce2, t_best)
        t = jnp.where(hit, t, cm.INF)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        better = tj < t_best
        t_best = jnp.where(better, tj, t_best)
        best = jnp.where(better, base + j.astype(jnp.int32), best)
        return (t_best, best), None

    best0 = -jnp.ones(o.shape[:1], jnp.int32)
    bases = (jnp.arange(n_chunks) * TC).astype(jnp.int32)
    (t_best, best), _ = jax.lax.scan(
        body, (t_best, best0), (p0, e1, e2, bases)
    )
    return t_best, best


def intersect_dense(scene: SceneTables, o: Array, d: Array,
                    t_max: Array | None = None, lean: bool = False,
                    want_tangent: bool | None = None) -> Hit:
    """Closest-hit against every primitive via chunked all-pairs testing.

    This is the dense path for small/medium scenes: pure dense
    arithmetic, no gathers, no divergence (cf. accel/traverse.py)."""
    R = o.shape[0]
    if t_max is None:
        t_max = jnp.full((R,), cm.INF)

    def one_chunk(args):
        o_c, d_c, tm_c = args
        t_best = tm_c
        kind = jnp.zeros(o_c.shape[:1], jnp.int32)
        idx = jnp.zeros(o_c.shape[:1], jnp.int32)
        if scene.tri_p0.shape[0] > 0:
            tj, best = _dense_closest_tris(scene, o_c, d_c, t_best)
            better = best >= 0
            t_best = jnp.where(better, tj, t_best)
            kind = jnp.where(better, PRIM_TRI, kind)
            idx = jnp.where(better, jnp.maximum(best, 0), idx)
        if scene.sph_center.shape[0] > 0:
            t, hit = ray_spheres(
                o_c, d_c, scene.sph_center, scene.sph_radius, t_best
            )
            t = jnp.where(hit, t, cm.INF)
            j = jnp.argmin(t, axis=-1)
            tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
            better = tj < t_best
            t_best = jnp.where(better, tj, t_best)
            kind = jnp.where(better, PRIM_SPH, kind)
            idx = jnp.where(better, j.astype(jnp.int32), idx)
        return t_best, kind, idx

    if R <= RAY_CHUNK:
        t_best, kind, idx = one_chunk((o, d, t_max))
    else:
        n = (R + RAY_CHUNK - 1) // RAY_CHUNK
        Rp = n * RAY_CHUNK
        o_p = _pad_to(o, Rp).reshape(n, RAY_CHUNK, 3)
        d_p = _pad_to(d, Rp, fill=1).reshape(n, RAY_CHUNK, 3)
        tm_p = _pad_to(t_max, Rp).reshape(n, RAY_CHUNK)
        t_best, kind, idx = jax.lax.map(one_chunk, (o_p, d_p, tm_p))
        t_best = t_best.reshape(-1)[:R]
        kind = kind.reshape(-1)[:R]
        idx = idx.reshape(-1)[:R]

    return _assemble_hit(scene, o, d, t_best, kind, idx, lean=lean,
                         want_tangent=want_tangent)


def _bvh_intersect(bvh, scene, o, d, t_max, any_hit=False):
    """Dispatch over accelerator kinds: fused dense tables
    (accel/fused.FusedTris), the two-level worklist walk
    (accel/twolevel.TwoLevelTris, large scenes), packed one-hot/take
    tables (accel/onehot.OneHotBVH) or the legacy FlatBVH gather walk."""
    if type(bvh).__name__ == "TwoLevelTris":
        from ..accel.twolevel import intersect_twolevel

        return intersect_twolevel(bvh, o, d, t_max, any_hit=any_hit)
    if type(bvh).__name__ == "KdTreeTris":
        from ..accel.kdtree import intersect_kdtree

        return intersect_kdtree(bvh, o, d, t_max, any_hit=any_hit)
    if hasattr(bvh, "edge_table"):
        from ..accel.fused import intersect_fused

        return intersect_fused(bvh, o, d, t_max, any_hit=any_hit)
    if hasattr(bvh, "trav_table"):
        from ..accel.onehot import intersect_onehot

        return intersect_onehot(bvh, o, d, t_max, any_hit=any_hit)
    from ..accel.traverse import intersect_bvh

    return intersect_bvh(
        bvh, scene.tri_p0, scene.tri_e1, scene.tri_e2, o, d, t_max,
        any_hit=any_hit,
    )


def intersect_scene(scene: SceneTables, o: Array, d: Array,
                    t_max: Array | None = None, bvh=None,
                    lean: bool = False,
                    want_tangent: bool | None = None) -> Hit:
    """Closest hit via BVH for triangles (when provided) + dense spheres.

    lean=True returns a light-probe Hit (found/t/p/ng/light_id only;
    uv/mat_id/ns-interp/uv_density zeroed) -- the cheap assembly for
    BSDF-MIS rays that only need emitted radiance + light pdf."""
    if bvh is None:
        return intersect_dense(scene, o, d, t_max, lean=lean,
                               want_tangent=want_tangent)

    R = o.shape[0]
    if t_max is None:
        t_max = jnp.full((R,), cm.INF)
    t_best = t_max
    kind = jnp.zeros((R,), jnp.int32)
    idx = jnp.zeros((R,), jnp.int32)

    if scene.sph_center.shape[0] > 0:
        t, hit = ray_spheres(o, d, scene.sph_center, scene.sph_radius, t_best)
        t = jnp.where(hit, t, cm.INF)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        better = tj < t_best
        t_best = jnp.where(better, tj, t_best)
        kind = jnp.where(better, PRIM_SPH, kind)
        idx = jnp.where(better, j.astype(jnp.int32), idx)

    if scene.tri_p0.shape[0] > 0:
        tt, tid, found = _bvh_intersect(bvh, scene, o, d, t_best)
        better = found & (tt < t_best)
        t_best = jnp.where(better, tt, t_best)
        kind = jnp.where(better, PRIM_TRI, kind)
        idx = jnp.where(better, tid, idx)

    return _assemble_hit(scene, o, d, t_best, kind, idx, lean=lean,
                         want_tangent=want_tangent)


def occluded_scene(scene: SceneTables, o: Array, d: Array, t_max: Array,
                   bvh=None) -> Array:
    """Any-hit (shadow) test via BVH + dense spheres."""
    if bvh is None:
        return occluded_dense(scene, o, d, t_max)

    blocked = jnp.zeros(o.shape[:1], bool)
    if scene.sph_center.shape[0] > 0:
        _, hit = ray_spheres(o, d, scene.sph_center, scene.sph_radius, t_max)
        blocked |= jnp.any(hit, axis=-1)
    if scene.tri_p0.shape[0] > 0:
        _, _, found = _bvh_intersect(bvh, scene, o, d, t_max, any_hit=True)
        blocked |= found
    return blocked


def occluded_dense(scene: SceneTables, o: Array, d: Array, t_max: Array
                   ) -> Array:
    """Any-hit (shadow) test; [R] bool.  t_max excludes the light itself.
    Chunked like intersect_dense to bound temporary memory."""
    R = o.shape[0]

    def one_chunk(args):
        o_c, d_c, tm_c = args
        blocked = jnp.zeros(o_c.shape[:1], bool)
        if scene.tri_p0.shape[0] > 0:
            _, best = _dense_closest_tris(scene, o_c, d_c, tm_c)
            blocked |= best >= 0
        if scene.sph_center.shape[0] > 0:
            _, hit = ray_spheres(
                o_c, d_c, scene.sph_center, scene.sph_radius, tm_c
            )
            blocked |= jnp.any(hit, axis=-1)
        return blocked

    if R <= RAY_CHUNK:
        return one_chunk((o, d, t_max))
    n = (R + RAY_CHUNK - 1) // RAY_CHUNK
    Rp = n * RAY_CHUNK
    o_p = _pad_to(o, Rp).reshape(n, RAY_CHUNK, 3)
    d_p = _pad_to(d, Rp, fill=1).reshape(n, RAY_CHUNK, 3)
    tm_p = _pad_to(t_max, Rp).reshape(n, RAY_CHUNK)
    blocked = jax.lax.map(one_chunk, (o_p, d_p, tm_p))
    return blocked.reshape(-1)[:R]
