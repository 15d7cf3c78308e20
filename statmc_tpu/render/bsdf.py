"""Vectorized BSDF lobes + per-lane material dispatch.

Functional re-derivation of the reference's reflection stack
(src/core/reflection.{h,cpp}, src/core/microfacet.{h,cpp}) shaped for a
wavefront: every function maps over [R] lanes in the local shading frame
(z = shading normal).  Instead of virtual BxDF dispatch we evaluate the
small set of lobe families each material uses and select per lane by the
material-type id -- lanes stay converged, XLA fuses everything.

Materials covered (matching src/materials/*.cpp construction):
  matte      -> Lambertian / Oren-Nayar(sigma)
  plastic    -> Lambertian(Kd) + TR-microfacet dielectric(Ks)
  metal      -> TR-microfacet conductor(eta, k)
  substrate  -> FresnelBlend (Ashikhmin-Shirley)
  uber       -> plastic-style (Kd + Ks microfacet)
  translucent-> Lambertian approximation (full two-sided lobes TODO)
  mirror     -> specular reflection (Kr)
  glass      -> specular reflection+transmission, Fresnel dielectric
  disney     -> Burley diffuse x (1-metallic) + GGX w/ Schlick-to-color
  hair       -> absorption-colored diffuse + broad gloss (Marschner
                longitudinal/azimuthal product approximated; hair.cpp)
  fourier    -> substrate-like fallback (table files not read)
  kd/subsurface -> diffuse-albedo + dielectric coat approximation of
                the BSSRDF transport (never exercised by statpath)
  mix        -> folded at scene build (scene/build.py:_mix_rows)
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as cm
from ..scene import build as sb

Array = jax.Array
INV_PI = 1.0 / jnp.pi


class ShadingFrame(NamedTuple):
    t: Any  # tangent
    b: Any  # bitangent
    n: Any  # shading normal

    @staticmethod
    def from_normal(n):
        t, b = cm.coordinate_system(n)
        return ShadingFrame(t, b, n)

    def to_local(self, w):
        return jnp.stack(
            [cm.dot(w, self.t), cm.dot(w, self.b), cm.dot(w, self.n)], axis=-1
        )

    def to_world(self, w):
        return (
            w[..., 0:1] * self.t + w[..., 1:2] * self.b + w[..., 2:3] * self.n
        )


class MaterialLanes(NamedTuple):
    """Per-lane material parameters gathered from the scene tables."""
    mat_type: Any
    kd: Any
    ks: Any
    kr: Any
    kt: Any
    eta: Any
    k: Any
    rough_u: Any
    rough_v: Any
    sigma: Any
    # FourierBSDF table plumbing (render/fourier.py): per-lane table
    # index and the scene's stacked tables (None when the scene has no
    # readable .bsdf materials -> the substrate fallback evals).
    fourier_id: Any = None
    fourier_tab: Any = None
    # Marschner hair plumbing (render/hair.py): per-lane width offset
    # h = -1 + 2*v (hair.cpp:221).  None when the scene has no hair
    # materials -- a static gate that elides the hair model entirely.
    hair_h: Any = None
    # BSSRDF plumbing (render/sss.py): per-lane SSS table index.  None
    # when the scene has no subsurface materials; when present,
    # kdsubsurface/subsurface lanes expose the Kr/Kt FresnelSpecular
    # dielectric interface (kdsubsurface.cpp:70-74) instead of the
    # legacy albedo+coat approximation, and the integrator's in-bounce
    # SSS block consumes transmission events.
    sss_id: Any = None


def gather_materials(scene: sb.SceneTables, mat_id: Array,
                     uv: Array | None = None,
                     p: Array | None = None,
                     uv_fp: Array | None = None,
                     uv_axes: Array | None = None) -> MaterialLanes:
    # One packed [M, 24] row gather instead of 11 per-table gathers: device
    # gathers cost per row, not per element (render/intersect.py
    # _assemble_hit rationale); the concatenate is a tiny copy CSE'd
    # across call sites within a jitted step.
    f32 = jnp.float32
    packed = jnp.concatenate([
        scene.mat_type[:, None].astype(f32),
        scene.mat_kd, scene.mat_ks, scene.mat_kr, scene.mat_kt,
        scene.mat_eta, scene.mat_k,
        scene.mat_rough_u[:, None], scene.mat_rough_v[:, None],
        scene.mat_sigma[:, None],
        scene.mat_kd_tex[:, None].astype(f32),
    ], axis=-1)
    row = jnp.take(packed, mat_id, axis=0)
    kd = row[..., 1:4]
    if uv is not None:
        kd_tex = jnp.round(row[..., 22]).astype(jnp.int32)
        # Textured Kd: base color is 1 for textured rows, so the product
        # gives the texture value; untextured lanes sample 1.  p feeds
        # the 3-D noise textures (fbm/marble/...).  Elided statically
        # when the scene has no textures at all.
        if _scene_has_textures(scene):
            from ..scene.textures import sample_texture

            kd = kd * sample_texture(scene.textures, kd_tex, uv, p, uv_fp,
                                     uv_axes=uv_axes)
    fourier_id = None
    fourier_tab = None
    if scene.fourier is not None:
        fourier_id = jnp.take(scene.mat_fourier_id, mat_id, axis=0)
        fourier_tab = scene.fourier
    sss_id = None
    if scene.sss is not None:
        sss_id = jnp.take(scene.mat_sss_id, mat_id, axis=0)
    hair_h = None
    if uv is not None and _scene_has_hair(scene):
        # Ribbon v coordinate spans the curve width (scene/tessellate.py
        # curve(): v in {0,1} across the strip) -> h in [-1,1]
        # (hair.cpp:221).
        hair_h = jnp.clip(-1.0 + 2.0 * uv[..., 1], -0.999, 0.999)
    return MaterialLanes(
        mat_type=jnp.round(row[..., 0]).astype(jnp.int32),
        kd=kd,
        ks=row[..., 4:7],
        kr=row[..., 7:10],
        kt=row[..., 10:13],
        eta=row[..., 13:16],
        k=row[..., 16:19],
        rough_u=row[..., 19],
        rough_v=row[..., 20],
        sigma=row[..., 21],
        fourier_id=fourier_id,
        fourier_tab=fourier_tab,
        hair_h=hair_h,
        sss_id=sss_id,
    )


_scene_has_hair = sb.scene_has_hair


def _hair_lanes(m: MaterialLanes):
    """MaterialLanes slots -> HairLanes (slot mapping documented at
    scene/build.py MAT_HAIR)."""
    from . import hair as _hair

    return _hair.HairLanes(
        h=m.hair_h, eta=m.eta[..., 0], sigma_a=m.kt,
        beta_m=m.sigma, beta_n=m.rough_u, alpha=m.rough_v,
    )


def _scene_has_textures(scene: sb.SceneTables) -> bool:
    """Static check: does any material reference a texture row?
    Reads the build-time flags (scene/build.py:SceneFlags) so the gate
    stays static when the tables are jit arguments."""
    if getattr(scene, "flags", None) is not None:
        return scene.flags.has_textures
    try:
        import numpy as _np

        return bool(_np.any(_np.asarray(scene.mat_kd_tex) >= 0))
    except Exception:  # traced scene without flags: keep the path
        return True


def sss_interface(m: MaterialLanes) -> Array | None:
    """Lanes whose surface BSDF is the subsurface dielectric interface
    (FresnelSpecular, kdsubsurface.cpp:70-74 / subsurface.cpp:74-76).
    None (static) when the scene has no BSSRDF transport.  Rough
    interfaces keep the smooth lobe pair (scene/build.py note)."""
    if m.sss_id is None:
        return None
    return ((m.mat_type == sb.MAT_KDSUBSURFACE)
            | (m.mat_type == sb.MAT_SUBSURFACE)) & (m.sss_id >= 0)


def is_specular(m: MaterialLanes) -> Array:
    """Lanes whose material has only delta lobes (mirror, smooth glass,
    the subsurface FresnelSpecular interface)."""
    smooth_glass = (m.mat_type == sb.MAT_GLASS) & (m.rough_u < 1e-4)
    out = (m.mat_type == sb.MAT_MIRROR) | smooth_glass
    sssl = sss_interface(m)
    if sssl is not None:
        out = out | sssl
    return out


# --------------------------------------------------------------------------
# Local-frame helpers (reflection.h)
# --------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def reflect_local(wo):
    return jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)


def cosine_sample_hemisphere(u):
    """Concentric-disk cosine sampling (sampling.h:CosineSampleHemisphere)."""
    uo = 2.0 * u - 1.0
    zero = (jnp.abs(uo[..., 0]) < 1e-12) & (jnp.abs(uo[..., 1]) < 1e-12)
    big = jnp.abs(uo[..., 0]) > jnp.abs(uo[..., 1])
    r = jnp.where(big, uo[..., 0], uo[..., 1])
    theta = jnp.where(
        big,
        (jnp.pi / 4) * (uo[..., 1] / jnp.where(big, uo[..., 0], 1.0)),
        (jnp.pi / 2)
        - (jnp.pi / 4) * (uo[..., 0] / jnp.where(big, 1.0, uo[..., 1])),
    )
    x = jnp.where(zero, 0.0, r * jnp.cos(theta))
    y = jnp.where(zero, 0.0, r * jnp.sin(theta))
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    return jnp.stack([x, y, z], axis=-1)


# --------------------------------------------------------------------------
# Fresnel (reflection.cpp:FrDielectric / FrConductor)
# --------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized Fresnel for dielectrics; cos_i may be signed."""
    entering = cos_i > 0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(jnp.clip(cos_i, -1.0, 1.0))
    sin_t = ei / et * jnp.sqrt(jnp.maximum(0.0, 1.0 - ci * ci))
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-12)
    r_per = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-12)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return jnp.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """reflection.cpp:FrConductor (eta/k are [...,3] RGB)."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def schlick_fresnel(rs, cos_t):
    p = jnp.clip(1.0 - cos_t, 0.0, 1.0)
    return rs + (p**5)[..., None] * (1.0 - rs)


# --------------------------------------------------------------------------
# Trowbridge-Reitz (GGX) microfacet distribution (microfacet.cpp)
# --------------------------------------------------------------------------

def tr_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    s2 = jnp.maximum(0.0, 1.0 - c2)
    # tan2theta * (cos2phi/ax^2 + sin2phi/ay^2) without dividing by sin.
    e = (wh[..., 0] ** 2 / (ax * ax) + wh[..., 1] ** 2 / (ay * ay))
    denom_e = c2 + e
    d = 1.0 / (jnp.pi * ax * ay * denom_e * denom_e)
    return jnp.where(denom_e > 1e-16, d, 0.0)


def tr_lambda(w, ax, ay):
    c = jnp.abs(w[..., 2])
    s2 = jnp.maximum(0.0, 1.0 - c * c)
    # alpha^2 tan^2 theta with anisotropic projection.
    inv_c2 = 1.0 / jnp.maximum(c * c, 1e-12)
    a2t2 = (ax * ax * w[..., 0] ** 2 + ay * ay * w[..., 1] ** 2) * inv_c2
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + a2t2))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_sample_wh(wo, u, ax, ay):
    """Sample the full D(wh) cos(wh) distribution (isotropic+anisotropic).

    The reference samples *visible* normals by default
    (microfacet.cpp:TrowbridgeReitzSample); full-normal sampling is an
    equally unbiased estimator with slightly higher variance -- chosen
    here because it is branch-free.  pdf_wh = D(wh)|cos wh|.
    """
    # Anisotropic TR sampling (pbrt's non-visible branch,
    # microfacet.cpp:271-287).
    phi = jnp.arctan2(
        ay * jnp.sin(2 * jnp.pi * u[..., 1] + 0.5 * jnp.pi),
        ax * jnp.cos(2 * jnp.pi * u[..., 1] + 0.5 * jnp.pi),
    )
    iso = jnp.abs(ax - ay) < 1e-7
    phi = jnp.where(iso, u[..., 1] * 2 * jnp.pi, phi)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    alpha2 = 1.0 / jnp.maximum(
        cp * cp / jnp.maximum(ax * ax, 1e-12)
        + sp * sp / jnp.maximum(ay * ay, 1e-12),
        1e-12,
    )
    alpha2 = jnp.where(iso, ax * ax, alpha2)
    t2 = alpha2 * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-9)
    ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
    wh = cm.spherical_direction(st, ct, phi)
    return jnp.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def tr_pdf_wh(wh, ax, ay):
    return tr_d(wh, ax, ay) * jnp.abs(wh[..., 2])


# --------------------------------------------------------------------------
# Lobe evaluations (f and pdf given wo, wi in local frame)
# --------------------------------------------------------------------------

def _oren_nayar_f(kd, sigma_deg, wo, wi):
    """reflection.cpp:OrenNayar::f."""
    sigma = jnp.radians(sigma_deg)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_to = jnp.sqrt(jnp.maximum(0.0, 1.0 - wo[..., 2] ** 2))
    sin_ti = jnp.sqrt(jnp.maximum(0.0, 1.0 - wi[..., 2] ** 2))
    # max cos(phi_i - phi_o)
    cos_pi = jnp.where(sin_ti > 1e-4, wi[..., 0] / jnp.maximum(sin_ti, 1e-7), 1.0)
    sin_pi = jnp.where(sin_ti > 1e-4, wi[..., 1] / jnp.maximum(sin_ti, 1e-7), 0.0)
    cos_po = jnp.where(sin_to > 1e-4, wo[..., 0] / jnp.maximum(sin_to, 1e-7), 1.0)
    sin_po = jnp.where(sin_to > 1e-4, wo[..., 1] / jnp.maximum(sin_to, 1e-7), 0.0)
    d_cos = jnp.maximum(cos_pi * cos_po + sin_pi * sin_po, 0.0)
    abs_ci = jnp.abs(wi[..., 2])
    abs_co = jnp.abs(wo[..., 2])
    big = abs_ci > abs_co
    sin_a = jnp.where(big, sin_to, sin_ti)
    tan_b = jnp.where(
        big,
        sin_ti / jnp.maximum(abs_ci, 1e-7),
        sin_to / jnp.maximum(abs_co, 1e-7),
    )
    return kd * (INV_PI * (A + B * d_cos * sin_a * tan_b))[..., None]


def _microfacet_reflection_f(wo, wi, ax, ay, F):
    """MicrofacetReflection::f with precomputed Fresnel F [...,3]."""
    co, ci = abs_cos_theta(wo), abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (ci < 1e-7) | (co < 1e-7) | (jnp.sum(wh * wh, -1) < 1e-14)
    wh = cm.normalize(wh)
    d = tr_d(wh, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    f = F * (d * g / jnp.maximum(4.0 * ci * co, 1e-7))[..., None]
    return jnp.where(degenerate[..., None], 0.0, f)


def _microfacet_pdf(wo, wi, ax, ay):
    wh = cm.normalize(wo + wi)
    pdf_wh = tr_pdf_wh(wh, ax, ay)
    pdf = pdf_wh / jnp.maximum(4.0 * jnp.abs(cm.dot(wo, wh)), 1e-7)
    ok = same_hemisphere(wo, wi) & (jnp.sum((wo + wi) ** 2, -1) > 1e-14)
    return jnp.where(ok, pdf, 0.0)


def _microfacet_transmission_f(wo, wi, ax, ay, kt, eta_mat):
    """MicrofacetTransmission::f (reflection.cpp), radiance mode.

    eta_mat: [R] material IOR (assumes outside medium is vacuum)."""
    same = same_hemisphere(wo, wi)
    co = cos_theta(wo)
    ci = cos_theta(wi)
    eta = jnp.where(co > 0, eta_mat, 1.0 / eta_mat)
    wh = cm.normalize(wo + wi * eta[..., None])
    wh = jnp.where((wh[..., 2] < 0)[..., None], -wh, wh)
    wo_dot_wh = cm.dot(wo, wh)
    wi_dot_wh = cm.dot(wi, wh)
    # Both directions must be on opposite sides of the microfacet.
    valid = ~same & (wo_dot_wh * wi_dot_wh < 0) \
        & (jnp.abs(co) > 1e-7) & (jnp.abs(ci) > 1e-7)
    F = fresnel_dielectric(wo_dot_wh, 1.0, eta_mat)
    d = tr_d(wh, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    sqrt_denom = wo_dot_wh + eta * wi_dot_wh
    factor = 1.0 / eta  # radiance transport scaling
    # ci*co is negative for transmission; pbrt takes |...| of the whole
    # quotient -- guard only the magnitude.
    denom = ci * co * sqrt_denom * sqrt_denom
    denom = jnp.sign(denom) * jnp.maximum(jnp.abs(denom), 1e-9)
    f = (
        kt * ((1.0 - F) * jnp.abs(
            d * g * eta * eta * jnp.abs(wi_dot_wh) * jnp.abs(wo_dot_wh)
            * factor * factor / denom
        ))[..., None]
    )
    return jnp.where(valid[..., None], f, 0.0)


def _microfacet_transmission_pdf(wo, wi, ax, ay, eta_mat):
    same = same_hemisphere(wo, wi)
    co = cos_theta(wo)
    eta = jnp.where(co > 0, eta_mat, 1.0 / eta_mat)
    wh = cm.normalize(wo + wi * eta[..., None])
    wh = jnp.where((wh[..., 2] < 0)[..., None], -wh, wh)
    wo_dot_wh = cm.dot(wo, wh)
    wi_dot_wh = cm.dot(wi, wh)
    valid = ~same & (wo_dot_wh * wi_dot_wh < 0)
    sqrt_denom = wo_dot_wh + eta * wi_dot_wh
    dwh_dwi = jnp.abs(
        eta * eta * wi_dot_wh
        / jnp.maximum(sqrt_denom * sqrt_denom, 1e-12)
    )
    pdf = tr_pdf_wh(wh, ax, ay) * dwh_dwi
    return jnp.where(valid, pdf, 0.0)


def _fresnel_blend_f(kd, ks, wo, wi, ax, ay):
    """FresnelBlend::f (reflection.cpp, Ashikhmin-Shirley)."""
    co, ci = abs_cos_theta(wo), abs_cos_theta(wi)
    pow5 = lambda v: (1.0 - v) ** 5
    diffuse = (
        (28.0 / (23.0 * jnp.pi))
        * kd
        * (1.0 - ks)
        * ((1.0 - pow5(ci * 0.5)) * (1.0 - pow5(co * 0.5)))[..., None]
    )
    wh = wo + wi
    degenerate = jnp.sum(wh * wh, -1) < 1e-14
    wh = cm.normalize(wh)
    d = tr_d(wh, ax, ay)
    spec = (
        d
        / jnp.maximum(
            4.0 * jnp.abs(cm.dot(wi, wh)) * jnp.maximum(ci, co), 1e-7
        )
    )[..., None] * schlick_fresnel(ks, cm.dot(wi, wh))
    spec = jnp.where(degenerate[..., None], 0.0, spec)
    return diffuse + spec


# --------------------------------------------------------------------------
# Material dispatch: evaluate / pdf / sample over lanes
# --------------------------------------------------------------------------

def evaluate(m: MaterialLanes, wo: Array, wi: Array) -> tuple[Array, Array]:
    """(f [R,3], pdf [R]) of the non-delta lobes; zero for delta materials.

    Mirrors BSDF::f + BSDF::Pdf over BSDF_ALL & ~BSDF_SPECULAR.
    """
    refl = same_hemisphere(wo, wi)
    ax = jnp.maximum(m.rough_u, 1e-3)
    ay = jnp.maximum(m.rough_v, 1e-3)
    ci = abs_cos_theta(wi)

    lam_f = m.kd * INV_PI
    on_f = _oren_nayar_f(m.kd, m.sigma, wo, wi)
    matte_f = jnp.where((m.sigma > 0)[..., None], on_f, lam_f)
    lam_pdf = jnp.where(refl, ci * INV_PI, 0.0)

    F_cond = fresnel_conductor(cos_theta(wi), m.eta, m.k)
    metal_f = _microfacet_reflection_f(wo, wi, ax, ay, F_cond)
    mf_pdf = _microfacet_pdf(wo, wi, ax, ay)

    wh = cm.normalize(wo + wi)
    F_diel = fresnel_dielectric(cm.dot(wi, wh), 1.0, 1.5)[..., None]
    plastic_spec = _microfacet_reflection_f(wo, wi, ax, ay, F_diel * m.ks)
    plastic_f = m.kd * INV_PI + plastic_spec
    plastic_pdf = 0.5 * (lam_pdf + mf_pdf)

    substrate_f = _fresnel_blend_f(m.kd, m.ks, wo, wi, ax, ay)
    substrate_pdf = 0.5 * (lam_pdf + mf_pdf)

    # Disney principled (materials/disney.cpp, main lobes): Burley
    # retro-reflective diffuse weighted by (1-metallic) + GGX specular
    # with Schlick Fresnel toward the base color.  metallic rides the
    # sigma slot (scene/build.py).
    metallic = jnp.clip(m.sigma, 0.0, 1.0)[..., None]
    rough_lin = jnp.sqrt(ax)[..., None]  # alpha = roughness^2 at build
    cosd = cm.dot(wi, wh)
    co_a = jnp.maximum(abs_cos_theta(wo), 1e-7)
    ci_a = jnp.maximum(ci, 1e-7)
    fl = (1.0 - ci_a) ** 5
    fv = (1.0 - co_a) ** 5
    fd90 = (0.5 + 2.0 * rough_lin * (cosd**2)[..., None])
    burley = m.kd * INV_PI * (1.0 + (fd90 - 1.0) * fl[..., None]) \
        * (1.0 + (fd90 - 1.0) * fv[..., None])
    f0 = 0.04 * (1.0 - metallic) + m.kd * metallic
    f_schlick = f0 + (1.0 - f0) * ((1.0 - jnp.abs(cosd)) ** 5)[..., None]
    disney_spec = _microfacet_reflection_f(wo, wi, ax, ay, f_schlick)
    disney_f = (1.0 - metallic) * burley + disney_spec
    disney_pdf = 0.5 * (lam_pdf + mf_pdf)

    # Hair (materials/hair.cpp approximation, see scene/build.py): an
    # absorption-colored diffuse base + a broad glossy lobe of width
    # beta_n^2 replaces the Marschner longitudinal/azimuthal product.
    hair_f = m.kd * INV_PI + _microfacet_reflection_f(
        wo, wi, ax, ay, jnp.broadcast_to(m.ks, m.kd.shape))
    hair_pdf = 0.5 * (lam_pdf + mf_pdf)

    t = m.mat_type
    f = jnp.zeros_like(m.kd)
    pdf = jnp.zeros_like(ci)
    for mt, ff, pp in (
        (sb.MAT_MATTE, matte_f, lam_pdf),
        (sb.MAT_TRANSLUCENT, matte_f, lam_pdf),
        (sb.MAT_DISNEY, disney_f, disney_pdf),
        (sb.MAT_PLASTIC, plastic_f, plastic_pdf),
        (sb.MAT_UBER, plastic_f, plastic_pdf),
        (sb.MAT_METAL, metal_f, mf_pdf),
        (sb.MAT_SUBSTRATE, substrate_f, substrate_pdf),
        (sb.MAT_FOURIER, substrate_f, substrate_pdf),
        (sb.MAT_KDSUBSURFACE, plastic_f, plastic_pdf),
        (sb.MAT_SUBSURFACE, plastic_f, plastic_pdf),
        (sb.MAT_HAIR, hair_f, hair_pdf),
    ):
        sel = t == mt
        f = jnp.where(sel[..., None], ff, f)
        pdf = jnp.where(sel, pp, pdf)
    # Reflection-only lobes vanish under the surface.
    f = jnp.where(refl[..., None], f, 0.0)
    pdf = jnp.where(refl, pdf, 0.0)

    # Real FourierBSDF tables override the substrate-fallback f for
    # fourier lanes (render/fourier.py eval, reflection.cpp:322-377);
    # the pdf is the table pdf (matching the table sampler below).
    # Applied after the refl mask because the table itself encodes
    # sidedness (including transmission lobes).
    if m.fourier_tab is not None:
        from . import fourier as _fourier

        fe = _fourier.eval_f(m.fourier_tab, m.fourier_id, wo, wi)
        sel = (t == sb.MAT_FOURIER) & (m.fourier_id >= 0)
        f = jnp.where(sel[..., None], fe, f)
        # Table-true pdf to match the table sampler (Sample_f/Pdf pair,
        # reflection.cpp:379-427 + 429-480).
        pdf = jnp.where(
            sel, _fourier.pdf_wi(m.fourier_tab, m.fourier_id, wo, wi),
            pdf)

    # Full Marschner hair (render/hair.py) overrides the fallback lobe
    # pair when the scene has hair materials.  Applied after the refl
    # mask: hair scatters into the full sphere (TT/TRT transmit through
    # the fiber), and both f and pdf come from the model
    # (hair.cpp:418-480, 602-664).
    if m.hair_h is not None:
        from . import hair as _hair

        hl = _hair_lanes(m)
        sel = t == sb.MAT_HAIR
        f = jnp.where(sel[..., None], _hair.eval_f(hl, wo, wi), f)
        pdf = jnp.where(sel, _hair.pdf(hl, wo, wi), pdf)

    # Rough glass: microfacet reflection (Fresnel-weighted) +
    # microfacet transmission (materials/glass.cpp rough path).
    rough_glass = (t == sb.MAT_GLASS) & (m.rough_u >= 1e-4)
    eta0 = m.eta[..., 0]
    F_wh = fresnel_dielectric(cm.dot(wi, wh), 1.0, eta0)[..., None]
    rg_refl = _microfacet_reflection_f(wo, wi, ax, ay, F_wh * m.kr)
    rg_refl = jnp.where(refl[..., None], rg_refl, 0.0)
    rg_trans = _microfacet_transmission_f(wo, wi, ax, ay, m.kt, eta0)
    rg_f = rg_refl + rg_trans
    rg_pdf = 0.5 * (
        jnp.where(refl, mf_pdf, 0.0)
        + _microfacet_transmission_pdf(wo, wi, ax, ay, eta0)
    )
    f = jnp.where(rough_glass[..., None], rg_f, f)
    pdf = jnp.where(rough_glass, rg_pdf, pdf)

    # Smooth glass/mirror are delta -> f = 0 here.
    delta = is_specular(m)
    return jnp.where(delta[..., None], 0.0, f), jnp.where(delta, 0.0, pdf)


class BSDFSample(NamedTuple):
    wi: Any  # [R,3] local frame
    f: Any  # [R,3]
    pdf: Any  # [R]
    specular: Any  # [R] bool (delta lobe sampled)
    transmission: Any  # [R] bool


def sample(m: MaterialLanes, wo: Array, u2: Array, uc: Array) -> BSDFSample:
    """BSDF::Sample_f over lanes. u2: [R,2], uc: [R] lobe selector."""
    ax = jnp.maximum(m.rough_u, 1e-3)
    ay = jnp.maximum(m.rough_v, 1e-3)

    # Candidate A: cosine hemisphere (diffuse lobes).
    wi_cos = cosine_sample_hemisphere(u2)
    wi_cos = jnp.where((wo[..., 2:3] < 0), wi_cos * jnp.array([1.0, 1.0, -1.0]),
                       wi_cos)

    # Candidate B: microfacet half-vector.
    wh = tr_sample_wh(wo, u2, ax, ay)
    wi_mf = 2.0 * cm.dot(wo, wh)[..., None] * wh - wo

    # Candidate C: mirror reflection.
    wi_spec = reflect_local(wo)

    # Candidate D: refraction (glass).
    F = fresnel_dielectric(cos_theta(wo), 1.0, m.eta[..., 0])
    entering = cos_theta(wo) > 0
    eta_rel = jnp.where(entering, 1.0 / m.eta[..., 0], m.eta[..., 0])
    n_loc = jnp.where(
        entering[..., None],
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wo.shape),
        jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), wo.shape),
    )
    ci = cm.dot(n_loc, wo)
    s2t = jnp.maximum(0.0, 1.0 - ci * ci) * eta_rel * eta_rel
    tir = s2t >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - s2t))
    wi_refr = -wo * eta_rel[..., None] + (eta_rel * ci - ct)[..., None] * n_loc

    t = m.mat_type
    two_lobe = (
        (t == sb.MAT_PLASTIC) | (t == sb.MAT_UBER)
        | (t == sb.MAT_SUBSTRATE) | (t == sb.MAT_DISNEY)
        | (t == sb.MAT_FOURIER)
        | (t == sb.MAT_KDSUBSURFACE) | (t == sb.MAT_SUBSURFACE)
    )
    # Hair samples its own Marschner lobes when the scene has hair;
    # without the static gate it keeps the legacy two-lobe proposal.
    if m.hair_h is None:
        two_lobe = two_lobe | (t == sb.MAT_HAIR)
    metal = t == sb.MAT_METAL
    mirror = t == sb.MAT_MIRROR
    glass = (t == sb.MAT_GLASS) & (m.rough_u < 1e-4)
    rough_glass = (t == sb.MAT_GLASS) & (m.rough_u >= 1e-4)
    # BSSRDF transport: subsurface lanes expose the Kr/Kt
    # FresnelSpecular interface (kdsubsurface.cpp:70-74) -- identical
    # lobe algebra to smooth glass; transmission events feed the
    # integrator's Sample_Sp block (render/sss.py).
    sssl = sss_interface(m)
    if sssl is not None:
        two_lobe = two_lobe & ~sssl
        glass = glass | sssl

    # Rough glass refraction through the sampled microfacet normal.
    ci_wh = cm.dot(wo, wh)
    eta_rel_wh = jnp.where(ci_wh > 0, 1.0 / m.eta[..., 0], m.eta[..., 0])
    wh_f = jnp.where((ci_wh < 0)[..., None], -wh, wh)
    ci_whf = jnp.abs(ci_wh)
    s2t_wh = jnp.maximum(0.0, 1.0 - ci_whf * ci_whf) * eta_rel_wh**2
    ct_wh = jnp.sqrt(jnp.maximum(0.0, 1.0 - s2t_wh))
    wi_mf_refr = (
        -wo * eta_rel_wh[..., None]
        + (eta_rel_wh * ci_whf - ct_wh)[..., None] * wh_f
    )

    choose_mf = two_lobe & (uc < 0.5) | metal \
        | (rough_glass & (uc < 0.5))
    choose_mf_refr = rough_glass & (uc >= 0.5)
    choose_refl = glass & (uc < F) | mirror
    choose_refr = glass & (uc >= F)

    wi = wi_cos
    wi = jnp.where(choose_mf[..., None], wi_mf, wi)
    wi = jnp.where(choose_mf_refr[..., None], wi_mf_refr, wi)
    wi = jnp.where(choose_refl[..., None], wi_spec, wi)
    wi = jnp.where(choose_refr[..., None], wi_refr, wi)
    if m.hair_h is not None:
        from . import hair as _hair

        wi_hair = _hair.sample_wi(_hair_lanes(m), wo, u2, uc)
        wi = jnp.where((t == sb.MAT_HAIR)[..., None], wi_hair, wi)
    if m.fourier_tab is not None:
        # Real .bsdf tables sample their own tabulated distribution
        # (SampleCatmullRom2D + SampleFourier, reflection.cpp:429-480);
        # evaluate() returns the matching table pdf, so f/pdf stay a
        # consistent MIS pair.  Lanes without a table keep the
        # substrate proposal.
        from . import fourier as _fourier

        sel_ft = (t == sb.MAT_FOURIER) & (m.fourier_id >= 0)
        wi_ft, _ = _fourier.sample_wi(m.fourier_tab, m.fourier_id, wo,
                                      u2)
        wi = jnp.where(sel_ft[..., None], wi_ft, wi)

    f_eval, pdf_eval = evaluate(m, wo, wi)

    # Delta lobes: f/pdf become weight = f*|cos|/pdf handled by caller; we
    # report f already divided so that weight = f * |cos| / pdf works
    # uniformly: for specular set pdf=1 and f = F*R/|cos wi|.
    aci = jnp.maximum(abs_cos_theta(wi), 1e-7)
    f_mirror = m.kr / aci[..., None]  # FresnelNoOp (materials/mirror.cpp)
    f_glass_r = (F[..., None] * m.kr) / aci[..., None]
    # Radiance-mode scaling (eta_i/eta_t)^2 (reflection.cpp:SpecularTransmission).
    f_glass_t = ((1.0 - F) * eta_rel * eta_rel)[..., None] * m.kt / aci[..., None]
    f_glass_t = jnp.where(tir[..., None], 0.0, f_glass_t)

    specular = choose_refl | choose_refr
    f = jnp.where(specular[..., None], 0.0, f_eval)
    pdf = jnp.where(specular, 1.0, pdf_eval)
    f = jnp.where(mirror[..., None], f_mirror, f)
    f = jnp.where((choose_refl & glass)[..., None], f_glass_r, f)
    f = jnp.where(choose_refr[..., None], f_glass_t, f)
    # Glass delta-lobe selection probability: pbrt's FresnelSpecular folds
    # the choice prob into pdf (pdf=F or 1-F) while f carries the same
    # factor (reflection.cpp:FresnelSpecular::Sample_f), so the weight
    # f*|cos|/pdf reduces to R or T*(etaI/etaT)^2.
    pdf = jnp.where(choose_refl & glass, jnp.maximum(F, 1e-7), pdf)
    pdf = jnp.where(choose_refr, jnp.maximum(1.0 - F, 1e-7), pdf)

    return BSDFSample(
        wi=wi, f=f, pdf=pdf, specular=specular,
        transmission=choose_refr,
    )
