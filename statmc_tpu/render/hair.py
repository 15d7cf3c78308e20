"""Marschner hair BSDF: longitudinal x azimuthal lobe products.

Replaces /root/reference/src/materials/hair.cpp (HairBSDF): the
pbrt-v3 implementation of "A Practical and Controllable Hair and Fur
Model for Production Path Tracing" (Chiang et al. 2016) — pMax=3
discrete scattering modes (R, TT, TRT) plus a residual lobe, each the
product of a longitudinal Gaussian-like term Mp (von Mises-Fisher via
modified Bessel I0, hair.cpp:62-72), an attenuation Ap from Fresnel +
single-pass transmittance (hair.cpp:96-114), and an azimuthal trimmed
logistic Np centered on the perfect-specular deflection
(hair.cpp:116-140), with cuticle-scale tilt rotating the longitudinal
angles per lobe (hair.cpp:411-415).

Wavefront shape: every helper is vectorized over the lane axis [R] and
branch-free — the reference's `if (v <= .1)` numeric split and the
per-lobe p dispatch become jnp.where selects / a static python loop of
length 4; the dphi -> [-pi,pi] remap is a mod, not a while loop.  All
lanes of a wavefront evaluate the full model; scenes without hair
materials never trace this module (MaterialLanes.hair_h is None — a
static gate in bsdf.evaluate/sample).

Frame convention matches pbrt's BSDF local space for curves: x = curve
tangent (dpdu), z = shading normal; the longitudinal angle is measured
against the (y,z) normal plane (sin(theta) = w.x) and the azimuth is
atan2(w.z, w.y).  h in [-1,1] is the offset across the curve width,
derived from the ribbon's v texture coordinate (hair.cpp:221
`h = -1 + 2 * uv[1]`; scene/tessellate.py writes v in {0,1} across the
strip).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..core import spectrum as spec

Array = jax.Array

P_MAX = 3
_PI = 3.14159265358979
_SQRT_PI_OVER_8 = 0.626657069


class HairLanes(NamedTuple):
    """Per-lane hair parameters (HairBSDF constructor args)."""
    h: Any         # [R] offset across the width, in [-1, 1]
    eta: Any       # [R]
    sigma_a: Any   # [R,3] absorption inside the cortex
    beta_m: Any    # [R] longitudinal roughness in [0,1]
    beta_n: Any    # [R] azimuthal roughness in [0,1]
    alpha: Any     # [R] cuticle scale tilt, degrees


def sigma_a_from_concentration(ce, cp):
    """Melanin concentrations -> absorption (hair.cpp:270-277)."""
    eu = jnp.array([0.419, 0.697, 1.37])
    ph = jnp.array([0.187, 0.4, 1.05])
    ce = jnp.asarray(ce, jnp.float32)
    cp = jnp.asarray(cp, jnp.float32)
    return ce[..., None] * eu + cp[..., None] * ph


def sigma_a_from_reflectance(c, beta_n):
    """Azimuthally-averaged reflectance -> absorption (hair.cpp:279-287)."""
    c = jnp.clip(jnp.asarray(c, jnp.float32), 1e-5, 1.0)
    bn = jnp.asarray(beta_n, jnp.float32)
    denom = (5.969 - 0.215 * bn + 2.532 * bn**2 - 10.73 * bn**3
             + 5.574 * bn**4 + 0.245 * bn**5)
    return (jnp.log(c) / denom[..., None]) ** 2


def _i0(x):
    """Modified Bessel I0, 10-term series (hair.cpp:74-86).  The input
    is clamped to the series' accurate range; callers that may exceed it
    go through _log_i0's asymptotic branch instead."""
    x2 = jnp.minimum(x * x, 144.0)
    val = jnp.ones_like(x)
    term = jnp.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    """log I0(x) with the large-x asymptotic form (hair.cpp:89-94)."""
    big = x + 0.5 * (-jnp.log(2 * _PI) + jnp.log(1.0 / jnp.maximum(x, 1e-6))
                     + 1.0 / (8.0 * jnp.maximum(x, 1e-6)))
    return jnp.where(x > 12.0, big, jnp.log(_i0(jnp.minimum(x, 12.0))))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe (hair.cpp:62-72), branch-free.

    Small v uses the log-space form (the direct one overflows sinh);
    both branch inputs are clamped so the unselected branch stays
    finite under jnp.where.
    """
    v = jnp.maximum(v, 1e-8)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    log_form = jnp.exp(
        jnp.clip(_log_i0(a) - b - 1.0 / v + 0.6931
                 + jnp.log(1.0 / (2.0 * v)), -80.0, 80.0))
    v_big = jnp.maximum(v, 0.05)  # direct form only selected when v > .1
    ab = cos_ti * cos_to / v_big
    bb = sin_ti * sin_to / v_big
    direct = jnp.exp(-bb) * _i0(ab) / (jnp.sinh(1.0 / v_big) * 2.0 * v_big)
    return jnp.where(small, log_form, direct)


def _ap(cos_to, eta, h, T):
    """Attenuations A_0..A_3: Fresnel at entry, (1-f)^2 T for TT, extra
    fT per internal bounce, and the geometric-series residual
    (hair.cpp:96-114).  Returns [..., P_MAX+1, 3]."""
    cos_gamma_o = _safe_sqrt(1.0 - h * h)
    cos_theta = cos_to * cos_gamma_o
    f = _fr_dielectric(cos_theta, eta)[..., None]
    a0 = jnp.broadcast_to(f, T.shape)
    a1 = (1.0 - f) ** 2 * T
    a2 = a1 * T * f
    tf = jnp.clip(T * f, 0.0, 0.9999)
    a3 = a2 * tf / (1.0 - tf)
    return jnp.stack([a0, a1, a2, a3], axis=-2)


def _fr_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel, exterior side (core/reflection.cpp
    FrDielectric with etaI=1)."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    s2t = jnp.maximum(0.0, 1.0 - ci * ci) / (eta * eta)
    ct = _safe_sqrt(1.0 - s2t)
    r_par = (eta * ci - ct) / jnp.maximum(eta * ci + ct, 1e-7)
    r_perp = (ci - eta * ct) / jnp.maximum(ci + eta * ct, 1e-7)
    fr = 0.5 * (r_par**2 + r_perp**2)
    return jnp.where(s2t >= 1.0, 1.0, fr)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def _logistic_pdf(x, s):
    x = jnp.abs(x) / s
    e = jnp.exp(-jnp.minimum(x, 80.0))
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return jax.nn.sigmoid(x / s)


def _trimmed_logistic(x, s, a, b):
    return _logistic_pdf(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    """Inverse-CDF sample of the trimmed logistic (hair.cpp:142-149)."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    t = 1.0 / jnp.clip(u * k + _logistic_cdf(a, s), 1e-7, 1.0 - 1e-7) - 1.0
    x = -s * jnp.log(jnp.maximum(t, 1e-30))
    return jnp.clip(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    """Net azimuthal deflection of mode p (hair.cpp:116-118)."""
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * _PI


def _np_azimuthal(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_p(p, gamma_o, gamma_t)
    dphi = jnp.mod(dphi + _PI, 2.0 * _PI) - _PI  # remap to [-pi, pi]
    return _trimmed_logistic(dphi, s, -_PI, _PI)


def _variances(beta_m):
    """Longitudinal variance per lobe (hair.cpp:396-403)."""
    v0 = (0.726 * beta_m + 0.812 * beta_m**2 + 3.7 * beta_m**20) ** 2
    return [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]


def _azimuthal_s(beta_n):
    """Logistic scale from azimuthal roughness (hair.cpp:406-407)."""
    return _SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n**2
                              + 5.372 * beta_n**22)


def _tilt_terms(alpha_deg):
    """sin/cos of 2^k * alpha via double-angle chaining
    (hair.cpp:411-415)."""
    a = alpha_deg * (_PI / 180.0)
    s0 = jnp.sin(a)
    c0 = _safe_sqrt(1.0 - s0 * s0)
    s1 = 2.0 * c0 * s0
    c1 = c0 * c0 - s0 * s0
    s2 = 2.0 * c1 * s1
    c2 = c1 * c1 - s1 * s1
    return (s0, s1, s2), (c0, c1, c2)


def _tilted(p, sin_to, cos_to, sin2k, cos2k):
    """Rotate (sin,cos)theta_o by the lobe's cuticle tilt
    (hair.cpp:448-469): R by -2a, TT by a, TRT by 4a."""
    if p == 0:
        s = sin_to * cos2k[1] - cos_to * sin2k[1]
        c = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p == 1:
        s = sin_to * cos2k[0] + cos_to * sin2k[0]
        c = cos_to * cos2k[0] - sin_to * sin2k[0]
    elif p == 2:
        s = sin_to * cos2k[2] + cos_to * sin2k[2]
        c = cos_to * cos2k[2] - sin_to * sin2k[2]
    else:
        s, c = sin_to, cos_to
    return s, jnp.abs(c)


def _geometry(hp: HairLanes, wo):
    """Angles shared by f/pdf/sample (hair.cpp:420-443)."""
    sin_to = jnp.clip(wo[..., 0], -1.0, 1.0)
    cos_to = jnp.maximum(_safe_sqrt(1.0 - sin_to**2), 1e-5)
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    gamma_o = _safe_asin(hp.h)

    sin_tt = sin_to / hp.eta
    cos_tt = jnp.maximum(_safe_sqrt(1.0 - sin_tt**2), 1e-5)
    etap = _safe_sqrt(hp.eta**2 - sin_to**2) / cos_to
    sin_gt = hp.h / jnp.maximum(etap, 1e-5)
    cos_gt = _safe_sqrt(1.0 - sin_gt**2)
    gamma_t = _safe_asin(sin_gt)
    # Transmittance of one pass through the cortex (hair.cpp:441).
    T = jnp.exp(-hp.sigma_a * (2.0 * cos_gt / cos_tt)[..., None])
    return sin_to, cos_to, phi_o, gamma_o, gamma_t, T


def eval_f(hp: HairLanes, wo: Array, wi: Array) -> Array:
    """HairBSDF::f (hair.cpp:418-480): sum_p Mp * Ap * Np, divided by
    |cos(wi)| so the caller's f*|cos| integrator convention holds."""
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _geometry(hp, wo)
    sin_ti = jnp.clip(wi[..., 0], -1.0, 1.0)
    cos_ti = _safe_sqrt(1.0 - sin_ti**2)
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o

    ap = _ap(cos_to, hp.eta, hp.h, T)
    v = _variances(hp.beta_m)
    s = _azimuthal_s(hp.beta_n)
    sin2k, cos2k = _tilt_terms(hp.alpha)

    fsum = jnp.zeros(wo.shape[:-1] + (3,))
    for p in range(P_MAX):
        sin_top, cos_top = _tilted(p, sin_to, cos_to, sin2k, cos2k)
        mp = _mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
        np_ = _np_azimuthal(phi, p, s, gamma_o, gamma_t)
        fsum = fsum + (mp * np_)[..., None] * ap[..., p, :]
    mp_r = _mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
    fsum = fsum + (mp_r / (2.0 * _PI))[..., None] * ap[..., P_MAX, :]

    abs_cos_wi = jnp.abs(wi[..., 2])
    fsum = fsum / jnp.maximum(abs_cos_wi, 1e-5)[..., None]
    return jnp.where((abs_cos_wi > 0)[..., None], fsum, 0.0)


def _ap_pdf(hp: HairLanes, cos_to, gamma_t_T):
    """Lobe-selection pmf from luminance of Ap (hair.cpp:483-508)."""
    T = gamma_t_T
    ap = _ap(cos_to, hp.eta, hp.h, T)
    y = spec.luminance(ap)  # elementwise: no TF32 product
    return y / jnp.maximum(y.sum(-1, keepdims=True), 1e-12)


def pdf(hp: HairLanes, wo: Array, wi: Array) -> Array:
    """HairBSDF::Pdf (hair.cpp:602-664)."""
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _geometry(hp, wo)
    sin_ti = jnp.clip(wi[..., 0], -1.0, 1.0)
    cos_ti = _safe_sqrt(1.0 - sin_ti**2)
    phi = jnp.arctan2(wi[..., 2], wi[..., 1]) - phi_o

    ap_pdf = _ap_pdf(hp, cos_to, T)
    v = _variances(hp.beta_m)
    s = _azimuthal_s(hp.beta_n)
    sin2k, cos2k = _tilt_terms(hp.alpha)

    out = jnp.zeros(wo.shape[:-1])
    for p in range(P_MAX):
        sin_top, cos_top = _tilted(p, sin_to, cos_to, sin2k, cos2k)
        mp = _mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
        np_ = _np_azimuthal(phi, p, s, gamma_o, gamma_t)
        out = out + mp * np_ * ap_pdf[..., p]
    out = out + _mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX]) \
        * ap_pdf[..., P_MAX] / (2.0 * _PI)
    return out


def _demux(u):
    """One uniform -> two, by de-interleaving mantissa-scaled bits
    (pbrt's DemuxFloat, hair.cpp:49-57 Compact1By1)."""
    bits = jnp.uint32(jnp.clip(u, 0.0, 1.0 - 1e-7) * (1 << 30))
    even = bits & jnp.uint32(0x55555555)
    odd = (bits >> 1) & jnp.uint32(0x55555555)

    def compact(x):
        x = (x | (x >> 1)) & jnp.uint32(0x33333333)
        x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
        x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
        x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
        return x

    a = compact(even).astype(jnp.float32) / 32768.0
    b = compact(odd).astype(jnp.float32) / 32768.0
    return jnp.clip(a, 0.0, 1.0 - 1e-6), jnp.clip(b, 0.0, 1.0 - 1e-6)


def sample_wi(hp: HairLanes, wo: Array, u2: Array, uc: Array):
    """HairBSDF::Sample_f direction (hair.cpp:510-566): pick lobe p by
    the Ap luminance pmf, sample Mp for theta_i, Np for dphi.

    Draw mapping: uc selects p; u2[...,0] drives cos(theta) (the
    reference's u[1][0]); u2[...,1] demuxes into the azimuth and dphi
    draws.  Returns wi only — f/pdf come from eval_f/pdf, exactly as the
    reference recomputes them for the sampled direction.
    """
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _geometry(hp, wo)
    ap_pdf = _ap_pdf(hp, cos_to, T)
    v = _variances(hp.beta_m)
    s = _azimuthal_s(hp.beta_n)
    sin2k, cos2k = _tilt_terms(hp.alpha)

    # Discrete inverse-CDF over the 4 lobes.
    cdf = jnp.cumsum(ap_pdf, axis=-1)
    p_idx = jnp.sum((uc[..., None] >= cdf[..., :-1]).astype(jnp.int32), -1)

    # Tilted theta_o for every lobe, gathered by p.
    tilts = [_tilted(p, sin_to, cos_to, sin2k, cos2k)
             for p in range(P_MAX + 1)]
    sin_all = jnp.stack([t[0] for t in tilts], -1)
    cos_all = jnp.stack([t[1] for t in tilts], -1)
    sin_top = jnp.take_along_axis(sin_all, p_idx[..., None], -1)[..., 0]
    cos_top = jnp.take_along_axis(cos_all, p_idx[..., None], -1)[..., 0]
    v_all = jnp.stack(v, -1)
    vp = jnp.take_along_axis(v_all, p_idx[..., None], -1)[..., 0]

    u_theta = jnp.maximum(u2[..., 0], 1e-5)
    u_azim, u_dphi = _demux(u2[..., 1])

    # Mp inverse-CDF (hair.cpp:542-549).  Deliberate deviation from the
    # cited lines: the tilted cos(theta_o) is used with |cos| here AND
    # in pdf(), so sampler and density stay mutually consistent at
    # grazing theta_o with large alpha (the reference has a known
    # sampler/pdf sign mismatch there; ours cancels in f/pdf either way).
    cos_t = 1.0 + vp * jnp.log(u_theta + (1.0 - u_theta)
                               * jnp.exp(-2.0 / jnp.maximum(vp, 1e-6)))
    sin_t = _safe_sqrt(1.0 - cos_t**2)
    cos_ph = jnp.cos(2.0 * _PI * u_azim)
    sin_ti = -cos_t * sin_top + sin_t * cos_ph * cos_top
    cos_ti = _safe_sqrt(1.0 - sin_ti**2)

    # Np sample (hair.cpp:551-562); residual lobe is uniform in phi.
    phi_centers = jnp.stack(
        [_phi_p(p, gamma_o, gamma_t) for p in range(P_MAX)], -1)
    dphi_lobe = jnp.take_along_axis(
        phi_centers, jnp.minimum(p_idx, P_MAX - 1)[..., None], -1
    )[..., 0] + _sample_trimmed_logistic(u_dphi, s, -_PI, _PI)
    dphi = jnp.where(p_idx >= P_MAX, 2.0 * _PI * u_dphi, dphi_lobe)

    phi_i = phi_o + dphi
    wi = jnp.stack(
        [sin_ti, cos_ti * jnp.cos(phi_i), cos_ti * jnp.sin(phi_i)], -1)
    return wi
