"""Light sampling over lanes.

Re-derivation of the reference's light plugins (src/lights/*.cpp) and
shape sampling routines (src/shapes/{sphere,triangle}.cpp Sample/Pdf) in
SoA form.  As in pbrt, every emissive *triangle* is its own light (the
reference's GraphicsState attaches one DiffuseAreaLight per Shape), and
sphere area lights use cone sampling from outside points
(shapes/sphere.cpp:Sample(ref, u)).

All routines map over [R] lanes with per-lane light ids; kinds are
evaluated branchlessly and selected by where().
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as cm
from ..scene import build as sb

Array = jax.Array


def _light_rows(scene: sb.SceneTables, light_id: Array):
    """One packed row gather for the per-light attributes.

    Device gathers cost per row, not per element (render/intersect.py
    _assemble_hit rationale): fetching one [L, 14] row beats the 7
    separate per-table gathers sample_li/pdf_li used to issue.  The
    concatenate is a tiny [L, 14] copy, CSE'd across call sites within
    a jitted step."""
    f32 = jnp.float32
    packed = jnp.concatenate([
        scene.light_kind[:, None].astype(f32),
        scene.light_L,
        scene.light_prim[:, None].astype(f32),
        scene.light_pos,
        scene.light_aux,
        scene.light_params,
        scene.light_area[:, None],
    ], axis=-1)  # [L, 14]
    row = jnp.take(packed, light_id, axis=0)
    kind = jnp.round(row[..., 0]).astype(jnp.int32)
    return (kind, row[..., 1:4], jnp.round(row[..., 4]).astype(jnp.int32),
            row[..., 5:8], row[..., 8:11], row[..., 11:13], row[..., 13])


def _has_image_lights(scene: sb.SceneTables) -> bool:
    """True when any goniometric/projection light exists.  A static
    Python decision, like `int(scene.env_light_id)` below; reads the
    build-time flags (scene/build.py:SceneFlags) so it survives the
    tables becoming jit arguments."""
    if getattr(scene, "flags", None) is not None:
        return scene.flags.has_image_lights
    try:
        k = np.asarray(scene.light_kind)
        return bool(np.any((k == sb.LIGHT_GONIO) | (k == sb.LIGHT_PROJ)))
    except Exception:  # traced scene without flags: keep the full path
        return True


class LightSample(NamedTuple):
    wi: Any  # [R,3] world, unit, toward light
    pdf: Any  # [R] solid-angle pdf
    li: Any  # [R,3] radiance arriving if unoccluded
    p_light: Any  # [R,3] point on light (for shadow-ray t_max)
    dist: Any  # [R] distance to the light point (INF for distant/inf)
    is_delta: Any  # [R] delta light (no MIS vs BSDF)


def sample_li(scene: sb.SceneTables, light_id: Array, ref_p: Array,
              ref_ng: Array, u2: Array) -> LightSample:
    """Sample one light per lane. light_id: [R] into the light tables."""
    kind, L, prim, pos, aux, par, area = _light_rows(scene, light_id)

    R = ref_p.shape[0]
    eps = 1e-4

    # ---- AREA_TRI: uniform-area triangle sampling --------------------
    if scene.tri_p0.shape[0] > 0:
        tid = jnp.where(kind == sb.LIGHT_AREA_TRI, prim, 0)
        # Single packed row gather (see _light_rows rationale).
        tri_packed = jnp.concatenate(
            [scene.tri_p0, scene.tri_e1, scene.tri_e2], axis=-1)
        trow = jnp.take(tri_packed, tid, axis=0)
        p0, e1, e2 = trow[..., 0:3], trow[..., 3:6], trow[..., 6:9]
        # Uniform barycentric (triangle.cpp:Sample / sampling.cpp:
        # UniformSampleTriangle): p = b0*v0 + b1*v1 + (1-b0-b1)*v2.
        # The vertex association matters for draw-for-draw parity with
        # the reference (lockstep replay), not just distribution
        # equality: v0 + b1*e1 + (1-b0-b1)*e2 reproduces pbrt's point
        # for the same (u1, u2).
        su0 = jnp.sqrt(jnp.maximum(u2[..., 0], 0.0))
        b0 = 1.0 - su0
        b1 = u2[..., 1] * su0
        p_tri = (p0 + b1[..., None] * e1
                 + (1.0 - b0 - b1)[..., None] * e2)
        n_tri = cm.normalize(jnp.cross(e1, e2))
        wi_t = p_tri - ref_p
        d2_t = cm.length_squared(wi_t)
        dist_t = jnp.sqrt(jnp.maximum(d2_t, 1e-20))
        wi_tn = wi_t / dist_t[..., None]
        cos_l = cm.absdot(n_tri, wi_tn)
        # pdf_area = 1/area -> solid angle (shape.cpp:Pdf(ref,wi)).
        pdf_t = d2_t / jnp.maximum(cos_l * area, 1e-12)
        pdf_t = jnp.where(cos_l > 1e-7, pdf_t, 0.0)
        li_t = jnp.where(
            (cm.dot(n_tri, -wi_tn) > 0)[..., None], L, 0.0
        )
    else:
        p_tri = jnp.zeros_like(ref_p)
        wi_tn = jnp.zeros_like(ref_p)
        dist_t = jnp.zeros((R,))
        pdf_t = jnp.zeros((R,))
        li_t = jnp.zeros_like(ref_p)

    # ---- AREA_SPH: cone sampling from outside (sphere.cpp:Sample) ----
    if scene.sph_center.shape[0] > 0:
        sid = jnp.where(kind == sb.LIGHT_AREA_SPH, prim, 0)
        srow = jnp.take(jnp.concatenate(
            [scene.sph_center, scene.sph_radius[:, None]], -1), sid, axis=0)
        c, r = srow[..., 0:3], srow[..., 3]
        to_c = c - ref_p
        dc2 = cm.length_squared(to_c)
        dc = jnp.sqrt(jnp.maximum(dc2, 1e-20))
        inside = dc2 <= r * r * 1.0001
        w = to_c / dc[..., None]
        wx, wy = cm.coordinate_system(w)
        sin2_tmax = jnp.clip(r * r / dc2, 0.0, 1.0)
        cos_tmax = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_tmax))
        cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_tmax
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        phi = u2[..., 1] * 2.0 * jnp.pi
        # Project onto the sphere (pbrt computes ds then the point).
        ds = dc * cos_t - jnp.sqrt(
            jnp.maximum(r * r - dc2 * sin_t * sin_t, 0.0)
        )
        cos_alpha = (dc2 + r * r - ds * ds) / jnp.maximum(2.0 * dc * r, 1e-12)
        sin_alpha = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_alpha**2))
        # Outward normal of the sampled point on the NEAR side of the
        # sphere: tilted away from -w by angle alpha (sphere.cpp:Sample:
        # the sampled point faces the reference point).
        n_sph = -(
            sin_alpha[..., None] * jnp.cos(phi)[..., None] * wx
            + sin_alpha[..., None] * jnp.sin(phi)[..., None] * wy
            + cos_alpha[..., None] * w
        )
        p_sph = c + r[..., None] * n_sph
        wi_s = cm.normalize(p_sph - ref_p)
        pdf_s = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_tmax), 1e-9)
        # Inside the sphere: uniform over the full sphere area.
        u_sph = _uniform_sphere(u2)
        p_in = c + r[..., None] * u_sph
        wi_in = cm.normalize(p_in - ref_p)
        d2_in = cm.length_squared(p_in - ref_p)
        cos_in = cm.absdot(u_sph, wi_in)
        pdf_in = d2_in / jnp.maximum(
            cos_in * 4.0 * jnp.pi * r * r, 1e-12
        )
        wi_sn = jnp.where(inside[..., None], wi_in, wi_s)
        p_sphere = jnp.where(inside[..., None], p_in, p_sph)
        pdf_sp = jnp.where(inside, pdf_in, pdf_s)
        n_at = jnp.where(inside[..., None], u_sph, n_sph)
        # ReverseOrientation sign: a reversed sphere emits inward
        # (core/shape.cpp:49 normal flip applied to the sampled point).
        if scene.sph_flip is not None:
            n_at = n_at * jnp.take(scene.sph_flip, sid, axis=0)[..., None]
        li_s = jnp.where((cm.dot(n_at, -wi_sn) > 0)[..., None], L, 0.0)
        dist_s = cm.length(p_sphere - ref_p)
    else:
        p_sphere = jnp.zeros_like(ref_p)
        wi_sn = jnp.zeros_like(ref_p)
        dist_s = jnp.zeros((R,))
        pdf_sp = jnp.zeros((R,))
        li_s = jnp.zeros_like(ref_p)

    # ---- POINT / SPOT -----------------------------------------------
    to_p = pos - ref_p
    d2_p = jnp.maximum(cm.length_squared(to_p), 1e-20)
    dist_p = jnp.sqrt(d2_p)
    wi_p = to_p / dist_p[..., None]
    li_p = L / d2_p[..., None]
    # Spot falloff (lights/spot.cpp:Falloff).
    cos_spot = cm.dot(-wi_p, aux)
    cos_falloff, cos_total = par[..., 1], par[..., 0]
    delta = jnp.clip(
        (cos_spot - cos_total)
        / jnp.maximum(cos_falloff - cos_total, 1e-9),
        0.0, 1.0,
    )
    falloff = jnp.where(
        cos_spot < cos_total, 0.0,
        jnp.where(cos_spot > cos_falloff, 1.0, (delta * delta) ** 2),
    )
    li_spot = li_p * falloff[..., None]

    # ---- GONIOMETRIC / PROJECTION (image-modulated point lights) -----
    # lights/goniometric.cpp:Scale and lights/projection.cpp:Projection:
    # the outgoing direction in light space indexes an intensity image.
    # The whole block (2 gathers + 2 texture lookups) is elided
    # statically when no light carries an image (_has_image_lights).
    if _has_image_lights(scene):
        w2l = scene.light_w2l[light_id].reshape((-1, 3, 3))
        tex_id = scene.light_tex[light_id]
        # Elementwise 3x3 apply (not einsum): a default-precision dot
        # may run in TF32 on the GPU and corrupt the light-space
        # direction (core/math.py:_apply33 rationale).
        w_out = jnp.sum(w2l * (-wi_p)[:, None, :], axis=-1)
        from ..scene.textures import sample_texture

        # Goniometric: lights/goniometric.h:70-71 swaps (y, z) BEFORE
        # SphericalTheta/SphericalPhi, so theta comes from the y
        # component and phi from (x, z).  sample_texture's imagemap path
        # applies the (1-v) row flip that the reference's direct MIPMap
        # lookup does not, so v is pre-flipped here to compensate.
        theta = jnp.arccos(jnp.clip(w_out[..., 1], -1.0, 1.0))
        phi_g = jnp.arctan2(w_out[..., 2], w_out[..., 0])
        phi_g = jnp.where(phi_g < 0, phi_g + 2 * jnp.pi, phi_g)
        uv_g = jnp.stack(
            [phi_g / (2 * jnp.pi), 1.0 - theta / jnp.pi], axis=-1)
        gain_g = sample_texture(scene.textures, tex_id, uv_g)
        li_gonio = li_p * jnp.where((tex_id >= 0)[..., None], gain_g, 1.0)
        # Projection: perspective divide onto the fov screen window.
        tan_half = jnp.maximum(par[..., 0], 1e-6)
        aspect = jnp.maximum(par[..., 1], 1e-6)
        zl = w_out[..., 2]
        safe_z = jnp.where(jnp.abs(zl) > 1e-6, zl, 1.0)
        sx = w_out[..., 0] / (safe_z * tan_half)
        sy = w_out[..., 1] / (safe_z * tan_half)
        sw = jnp.where(aspect > 1.0, aspect, 1.0)
        sh = jnp.where(aspect > 1.0, 1.0, 1.0 / aspect)
        u_pr = (sx / sw + 1.0) * 0.5
        v_pr = (sy / sh + 1.0) * 0.5
        in_frustum = (zl > 1e-3) & (u_pr >= 0) & (u_pr <= 1) \
            & (v_pr >= 0) & (v_pr <= 1)
        gain_p = sample_texture(
            scene.textures, tex_id, jnp.stack([u_pr, v_pr], axis=-1)
        )
        gain_p = jnp.where((tex_id >= 0)[..., None], gain_p, 1.0)
        li_proj = li_p * jnp.where(in_frustum[..., None], gain_p, 0.0)
    else:
        li_gonio = li_p
        li_proj = jnp.zeros_like(li_p)

    # ---- DISTANT -----------------------------------------------------
    wi_d = pos  # stored direction toward light
    li_d = L
    dist_d = jnp.full((R,), 2.0) * scene.world_radius

    # ---- INFINITE ----------------------------------------------------
    # pbrt samples the (u,v) map -> direction with
    # pdf = map_pdf / (2 pi^2 sin(theta)) (lights/infinite.cpp:Sample_Li);
    # constant map => map_pdf = 1.  With an environment image the (u,v)
    # draw importance-samples the luminance*sin(theta) Distribution2D.
    has_env = int(scene.env_light_id) >= 0
    if has_env:
        He, We = scene.env_map.shape[:2]
        vrow = jnp.searchsorted(scene.env_marginal_cdf, u2[..., 1],
                                side="right")
        vrow = jnp.minimum(vrow, He - 1).astype(jnp.int32)
        cond = scene.env_cond_cdf[vrow]  # [R, We]
        ucol = jax.vmap(
            lambda row, uu: jnp.searchsorted(row, uu, side="right")
        )(cond, u2[..., 0])
        ucol = jnp.minimum(ucol, We - 1).astype(jnp.int32)
        uu = (ucol.astype(jnp.float32) + 0.5) / We
        vv = (vrow.astype(jnp.float32) + 0.5) / He
        map_pdf = scene.env_pdf_uv[vrow, ucol]
        li_env = scene.env_map[vrow, ucol]
    else:
        uu, vv = u2[..., 0], u2[..., 1]
        map_pdf = jnp.ones((R,))
        li_env = jnp.broadcast_to(L, (R, 3))
    theta = vv * jnp.pi
    phi_i = uu * 2.0 * jnp.pi
    st = jnp.sin(theta)
    wi_light = cm.spherical_direction(st, jnp.cos(theta), phi_i)
    if has_env:
        # Light-to-world: invert the stored world-to-light rotation.
        l2w = jnp.linalg.inv(scene.env_world_to_light)
        wi_inf = cm.transform_vector(l2w, wi_light)
    else:
        wi_inf = wi_light
    pdf_inf = jnp.where(
        st > 1e-7,
        map_pdf / (2.0 * jnp.pi * jnp.pi * jnp.maximum(st, 1e-7)),
        0.0,
    )
    dist_inf = jnp.full((R,), 2.0) * scene.world_radius

    # ---- Select per kind --------------------------------------------
    is_tri = kind == sb.LIGHT_AREA_TRI
    is_sph = kind == sb.LIGHT_AREA_SPH
    is_pt = kind == sb.LIGHT_POINT
    is_spot = kind == sb.LIGHT_SPOT
    is_dist = kind == sb.LIGHT_DISTANT
    is_inf = kind == sb.LIGHT_INFINITE
    is_gonio = kind == sb.LIGHT_GONIO
    is_proj = kind == sb.LIGHT_PROJ
    is_pointlike = is_pt | is_spot | is_gonio | is_proj

    wi = jnp.where(is_tri[..., None], wi_tn, 0.0)
    wi = jnp.where(is_sph[..., None], wi_sn, wi)
    wi = jnp.where(is_pointlike[..., None], wi_p, wi)
    wi = jnp.where(is_dist[..., None], wi_d, wi)
    wi = jnp.where(is_inf[..., None], wi_inf, wi)

    pdf = jnp.where(is_tri, pdf_t, 0.0)
    pdf = jnp.where(is_sph, pdf_sp, pdf)
    pdf = jnp.where(is_pointlike | is_dist, 1.0, pdf)
    pdf = jnp.where(is_inf, pdf_inf, pdf)

    li = jnp.where(is_tri[..., None], li_t, 0.0)
    li = jnp.where(is_sph[..., None], li_s, li)
    li = jnp.where(is_pt[..., None], li_p, li)
    li = jnp.where(is_spot[..., None], li_spot, li)
    li = jnp.where(is_gonio[..., None], li_gonio, li)
    li = jnp.where(is_proj[..., None], li_proj, li)
    li = jnp.where(is_dist[..., None], li_d, li)
    li = jnp.where(is_inf[..., None], li_env, li)

    dist = jnp.where(is_tri, dist_t, 0.0)
    dist = jnp.where(is_sph, dist_s, dist)
    dist = jnp.where(is_pointlike, dist_p, dist)
    dist = jnp.where(is_dist, dist_d, dist)
    dist = jnp.where(is_inf, dist_inf, dist)

    p_l = jnp.where(is_tri[..., None], p_tri, ref_p + wi * dist[..., None])
    p_l = jnp.where(is_sph[..., None], p_sphere, p_l)

    return LightSample(
        wi=wi, pdf=pdf, li=li, p_light=p_l, dist=dist,
        is_delta=is_pointlike | is_dist,
    )


def _uniform_sphere(u2):
    z = 1.0 - 2.0 * u2[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def pdf_li(scene: sb.SceneTables, light_id: Array, ref_p: Array, wi: Array,
           hit_p: Array, hit_ng: Array, hit_valid: Array) -> Array:
    """Solid-angle pdf of sampling direction `wi` from light `light_id`
    given that a BSDF-sampled ray hit that light at hit_p (Light::Pdf_Li).
    For infinite lights hit_valid is False and hit_p unused.
    """
    kind, _, prim, _, _, _, area = _light_rows(scene, light_id)

    # Area triangle: r^2 / (cos * area).
    d2 = cm.length_squared(hit_p - ref_p)
    cos_l = cm.absdot(hit_ng, wi)
    pdf_area = jnp.where(
        cos_l > 1e-7, d2 / jnp.maximum(cos_l * area, 1e-12), 0.0
    )

    # Sphere: cone pdf from outside.
    if scene.sph_center.shape[0] > 0:
        sid = jnp.where(kind == sb.LIGHT_AREA_SPH, prim, 0)
        srow = jnp.take(jnp.concatenate(
            [scene.sph_center, scene.sph_radius[:, None]], -1), sid, axis=0)
        c, r = srow[..., 0:3], srow[..., 3]
        dc2 = cm.length_squared(c - ref_p)
        inside = dc2 <= r * r * 1.0001
        sin2_tmax = jnp.clip(r * r / jnp.maximum(dc2, 1e-20), 0.0, 1.0)
        cos_tmax = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_tmax))
        pdf_cone = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_tmax), 1e-9)
        pdf_sph = jnp.where(inside, pdf_area, pdf_cone)
    else:
        pdf_sph = jnp.zeros_like(pdf_area)

    # Infinite light: direction -> (u,v) -> map pdf (infinite.cpp:Pdf_Li).
    if int(scene.env_light_id) >= 0:
        wl = cm.transform_vector(scene.env_world_to_light, wi)
        theta = jnp.arccos(jnp.clip(wl[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(wl[..., 1], wl[..., 0])
        uu = jnp.mod(phi / (2 * jnp.pi), 1.0)
        vv = jnp.clip(theta / jnp.pi, 0.0, 1.0 - 1e-6)
        He, We = scene.env_map.shape[:2]
        vrow = jnp.clip((vv * He).astype(jnp.int32), 0, He - 1)
        ucol = jnp.clip((uu * We).astype(jnp.int32), 0, We - 1)
        map_pdf = scene.env_pdf_uv[vrow, ucol]
    else:
        theta = jnp.arccos(jnp.clip(wi[..., 2], -1.0, 1.0))
        map_pdf = jnp.ones_like(theta)
    st = jnp.sin(theta)
    pdf_inf = jnp.where(
        st > 1e-7,
        map_pdf / (2.0 * jnp.pi * jnp.pi * jnp.maximum(st, 1e-7)),
        0.0,
    )

    pdf = jnp.where(kind == sb.LIGHT_AREA_TRI, pdf_area, 0.0)
    pdf = jnp.where(kind == sb.LIGHT_AREA_SPH, pdf_sph, pdf)
    pdf = jnp.where(kind == sb.LIGHT_INFINITE, pdf_inf, pdf)
    return pdf


def escaped_radiance(scene: sb.SceneTables, d: Array) -> Array:
    """Sum of infinite lights' Le for escaped rays
    (InfiniteAreaLight::Le: equirect map lookup by direction)."""
    if scene.light_kind.shape[0] == 0:
        return jnp.zeros(d.shape[:-1] + (3,))
    inf_mask = scene.light_kind == sb.LIGHT_INFINITE
    total = jnp.sum(
        jnp.where(inf_mask[:, None], scene.light_L, 0.0), axis=0
    )
    out = jnp.broadcast_to(total, d.shape[:-1] + (3,))
    if int(scene.env_light_id) >= 0:
        wl = cm.transform_vector(scene.env_world_to_light, cm.normalize(d))
        theta = jnp.arccos(jnp.clip(wl[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(wl[..., 1], wl[..., 0])
        uu = jnp.mod(phi / (2 * jnp.pi), 1.0)
        vv = jnp.clip(theta / jnp.pi, 0.0, 1.0 - 1e-6)
        He, We = scene.env_map.shape[:2]
        vrow = jnp.clip((vv * He).astype(jnp.int32), 0, He - 1)
        ucol = jnp.clip((uu * We).astype(jnp.int32), 0, We - 1)
        # env_light_id's constant L was folded into the map; other
        # constant infinite lights (if any) still add their L above
        # because the map light's L was reset to 1... subtract it:
        out = out - 1.0 + scene.env_map[vrow, ucol]
    return out


def area_light_le(scene: sb.SceneTables, light_id: Array, ng: Array,
                  w: Array) -> Array:
    """Emitted radiance of an area light hit by a ray going `w` FROM the
    surface toward the viewer (DiffuseAreaLight::L: L if dot(n, w) > 0)."""
    L = scene.light_L[jnp.maximum(light_id, 0)]
    emit = (light_id >= 0) & (cm.dot(ng, w) > 0)
    return jnp.where(emit[..., None], L, 0.0)
