"""Separable BSSRDF device transport: Sample_Sp / Pdf_Sp / Sw lanes.

Wavefront re-derivation of the reference's subsurface sampling scheme
(/root/reference/src/core/bssrdf.cpp:233-393 Sample_Sp/Pdf_Sp/
Sample_Sr/Pdf_Sr, src/core/bssrdf.h:86-97 Sw, :153-168 the radiance
-mode adapter), consumed by the integrator's in-bounce SSS block
(statpath.cpp:892-926).  The profile tables themselves are the host
precompute in render/bssrdf.py (photon-beam diffusion).

Wavefront shape vs the reference:

* pbrt interpolates the (rho, radius) profile with 4x4 spline weights
  per evaluation (TabulatedBSSRDF::Sr).  rho[ch] is a per-MATERIAL
  constant, so the rho axis is collapsed at build time into per-channel
  radius rows [T, 3, NS] -- identical math (Catmull-Rom weights commute
  with the per-node linear combination), 4 gathers per eval instead of
  16.
* SampleCatmullRom2D's scalar Newton-bisection (interpolation.cpp:
  217-290) becomes a fixed-trip masked iteration over lanes; the CDF
  FindInterval is a 6-trip binary search with one scalar gather per
  trip (per-lane [NS] row gathers would be ~700 MB at film scale).
* The unbounded IntersectionChain walk (bssrdf.cpp:303-321) becomes a
  bounded K-step probe chain -- K closest-hit dispatches over masked
  lanes.  K=4 covers the chain depths reachable within the 0.999
  profile radius on closed meshes (pbrt's chain rarely exceeds 2).
* Axis/channel selection, projection-axis pdf mixing and the Sw exit
  lobe are straight masked-lane arithmetic.

The whole module is statically gated: scenes without subsurface
materials compile none of it (scene.sss is None).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as cm

Array = jax.Array

# Probe-chain depth (bssrdf.cpp:303-321 walks until the segment exits;
# bounded here -- see module docstring).
PROBE_STEPS = 4


class SSSTables(NamedTuple):
    """Stacked per-material BSSRDF tables (device side).

    T = number of subsurface materials; NS = radius nodes (64, matching
    bssrdf.cpp:152-156's geometric grid)."""
    radius: Any   # [NS] unitless optical radius nodes (shared grid)
    prof: Any     # [T,3,NS] rho-collapsed profile rows per RGB channel
    cdf: Any      # [T,3,NS] IntegrateCatmullRom CDF rows
    rhoeff: Any   # [T,3] effective albedo at each channel's rho
    sigma_t: Any  # [T,3] world-space extinction per channel
    eta: Any      # [T] interior IOR
    c_sw: Any     # [T] Sw normalization 1 - 2*FresnelMoment1(1/eta)
    rmax: Any     # [T,3] world-space Sample_Sr(ch, 0.999) bound


# ------------------------------------------------------------------
# Host-side table construction
# ------------------------------------------------------------------

def _host_cr_weights(nodes: np.ndarray, x: float):
    """Scalar CatmullRomWeights (interpolation.cpp:61-103)."""
    n = len(nodes)
    if not (nodes[0] <= x <= nodes[-1]):
        x = float(np.clip(x, nodes[0], nodes[-1]))
    i = int(np.searchsorted(nodes, x, side="right") - 1)
    i = max(0, min(i, n - 2))
    x0, x1 = nodes[i], nodes[i + 1]
    t = (x - x0) / (x1 - x0) if x1 > x0 else 0.0
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if i > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[i - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if i + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[i + 2] - x0)
        w[3] = w3
        w[1] -= w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return i - 1, w


def _host_sample_cr(x: np.ndarray, f: np.ndarray, cdf: np.ndarray,
                    u: float) -> float:
    """Scalar SampleCatmullRom (interpolation.cpp:217-290) over one
    radius row; returns the sampled x."""
    u = u * cdf[-1]
    i = int(np.searchsorted(cdf, u, side="right") - 1)
    i = max(0, min(i, len(x) - 2))
    f0, f1 = f[i], f[i + 1]
    x0, x1 = x[i], x[i + 1]
    width = x1 - x0
    d0 = (width * (f1 - f[i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0)
    d1 = (width * (f[i + 2] - f0) / (x[i + 2] - x0)
          if i + 2 < len(x) else f1 - f0)
    u = (u - cdf[i]) / width if width > 0 else 0.0
    if f0 != f1:
        t = (f0 - np.sqrt(max(0.0, f0 * f0 + 2 * u * (f1 - f0)))) / (f0 - f1)
    else:
        t = u / max(f0, 1e-30)
    a, b = 0.0, 1.0
    for _ in range(64):
        if not (a <= t <= b):
            t = 0.5 * (a + b)
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        if abs(Fhat - u) < 1e-8 * max(cdf[-1], 1e-30):
            break
        if Fhat - u > 0:
            b = t
        else:
            a = t
        t = t - (Fhat - u) / fhat if abs(fhat) > 1e-30 else 0.5 * (a + b)
    return float(x0 + width * np.clip(t, 0.0, 1.0))


def build_sss_tables(entries) -> SSSTables:
    """Stack per-material tables from (sigma_a, sigma_s, g, eta) dicts.

    Mirrors TabulatedBSSRDF's construction (bssrdf.h:112-130: rho[ch] =
    sigma_s/sigma_t) on top of ComputeBeamDiffusionBSSRDF, with the rho
    spline axis pre-collapsed per channel (module docstring)."""
    from . import bssrdf as BD

    tables: dict[tuple, Any] = {}
    prof_l, cdf_l, rhoeff_l, sig_l, eta_l, c_l, rmax_l = \
        [], [], [], [], [], [], []
    for e in entries:
        g, eta = float(e["g"]), float(e["eta"])
        key = (round(g, 6), round(eta, 6))
        if key not in tables:
            tables[key] = BD.compute_beam_diffusion_bssrdf(g=g, eta=eta)
        tab = tables[key]
        sigma_a = np.asarray(e["sigma_a"], np.float64).reshape(3)
        sigma_s = np.asarray(e["sigma_s"], np.float64).reshape(3)
        sigma_t = sigma_a + sigma_s
        rho = np.where(sigma_t > 0, sigma_s / np.maximum(sigma_t, 1e-30),
                       0.0)
        NS = len(tab.radius)
        prof_c = np.zeros((3, NS))
        cdf_c = np.zeros((3, NS))
        rhoeff_c = np.zeros(3)
        rmax_c = np.zeros(3)
        for ch in range(3):
            off, w = _host_cr_weights(tab.rho, float(rho[ch]))
            for j in range(4):
                k = min(max(off + j, 0), len(tab.rho) - 1)
                if w[j] == 0.0:
                    continue
                prof_c[ch] += w[j] * tab.profile[k]
                cdf_c[ch] += w[j] * tab.profile_cdf[k]
                rhoeff_c[ch] += w[j] * tab.rho_eff[k]
            # Collapsed rows can go slightly negative at the spline
            # boundary; the CDF must stay monotone for FindInterval.
            cdf_c[ch] = np.maximum.accumulate(np.maximum(cdf_c[ch], 0.0))
            if sigma_t[ch] > 0 and cdf_c[ch][-1] > 0:
                rmax_c[ch] = _host_sample_cr(
                    tab.radius, prof_c[ch], cdf_c[ch], 0.999) / sigma_t[ch]
        prof_l.append(prof_c)
        cdf_l.append(cdf_c)
        rhoeff_l.append(np.maximum(rhoeff_c, 1e-9))
        sig_l.append(sigma_t)
        eta_l.append(eta)
        c_l.append(1.0 - 2.0 * BD.fresnel_moment1(1.0 / eta))
        rmax_l.append(rmax_c)
    f32 = np.float32
    return SSSTables(
        radius=np.asarray(tables[next(iter(tables))].radius, f32),
        prof=np.stack(prof_l).astype(f32),
        cdf=np.stack(cdf_l).astype(f32),
        rhoeff=np.stack(rhoeff_l).astype(f32),
        sigma_t=np.stack(sig_l).astype(f32),
        eta=np.asarray(eta_l, f32),
        c_sw=np.asarray(c_l, f32),
        rmax=np.stack(rmax_l).astype(f32),
    )


# ------------------------------------------------------------------
# Device-side spline machinery
# ------------------------------------------------------------------

def _find_interval_rows(flat: Array, base: Array, ns: int, u: Array):
    """Per-lane FindInterval (interpolation.h:FindInterval) over rows of
    a flat value table: largest i in [0, ns-2] with flat[base+i] <= u.
    One scalar gather per binary-search trip (see module docstring)."""
    lo = jnp.zeros_like(base)
    hi = jnp.full_like(base, ns - 1)
    trips = int(np.ceil(np.log2(ns))) + 1
    for _ in range(trips):
        mid = (lo + hi + 1) // 2
        v = jnp.take(flat, base + mid)
        pred = v <= u
        lo = jnp.where(pred, mid, lo)
        hi = jnp.where(pred, hi, mid - 1)
    return jnp.clip(lo, 0, ns - 2)


def _segment_coeffs(flat: Array, base: Array, i: Array, nodes: Array):
    """Hermite segment (x0, x1, f0, f1, d0, d1) at interval i with
    pbrt's one-sided boundary derivatives (interpolation.cpp:236-247)."""
    ns = nodes.shape[0]
    x0 = jnp.take(nodes, i)
    x1 = jnp.take(nodes, i + 1)
    f0 = jnp.take(flat, base + i)
    f1 = jnp.take(flat, base + i + 1)
    width = x1 - x0
    fm1 = jnp.take(flat, base + jnp.maximum(i - 1, 0))
    xm1 = jnp.take(nodes, jnp.maximum(i - 1, 0))
    d0 = jnp.where(i > 0,
                   width * (f1 - fm1) / jnp.maximum(x1 - xm1, 1e-30),
                   f1 - f0)
    fp2 = jnp.take(flat, base + jnp.minimum(i + 2, ns - 1))
    xp2 = jnp.take(nodes, jnp.minimum(i + 2, ns - 1))
    d1 = jnp.where(i + 2 < ns,
                   width * (fp2 - f0) / jnp.maximum(xp2 - x0, 1e-30),
                   f1 - f0)
    return x0, x1, f0, f1, d0, d1


def _eval_profile(tab: SSSTables, tid: Array, ch: int, r_opt: Array):
    """Spline value of the collapsed profile row at optical radius
    (TabulatedBSSRDF::Sr's radius interpolation, bssrdf.cpp:233-259,
    with the rho axis pre-collapsed).  Out-of-range radii return 0
    (CatmullRomWeights' false branch)."""
    nodes = tab.radius
    ns = nodes.shape[0]
    flat = tab.prof.reshape(-1)
    base = (tid * 3 + ch) * ns
    idx = jnp.clip(
        jnp.searchsorted(nodes, r_opt, side="right") - 1, 0, ns - 2)
    x0, x1, f0, f1, d0, d1 = _segment_coeffs(flat, base, idx, nodes)
    t = (r_opt - x0) / jnp.maximum(x1 - x0, 1e-30)
    val = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                              + t * (d0 + d1 + 2 * (f0 - f1))))
    ok = (r_opt >= nodes[0]) & (r_opt <= nodes[-1])
    return jnp.where(ok, val, 0.0)


def sample_sr(tab: SSSTables, tid: Array, ch: Array, u: Array) -> Array:
    """TabulatedBSSRDF::Sample_Sr over lanes (bssrdf.cpp:354-361 via
    SampleCatmullRom2D, interpolation.cpp:217-290): invert the profile
    CDF at u; returns WORLD radius, or -1 where sigma_t[ch] == 0."""
    nodes = tab.radius
    ns = nodes.shape[0]
    cdf_f = tab.cdf.reshape(-1)
    prof_f = tab.prof.reshape(-1)
    base = (tid * 3 + ch) * ns
    cmax = jnp.take(cdf_f, base + ns - 1)
    up = u * cmax
    i = _find_interval_rows(cdf_f, base, ns, up)
    x0, x1, f0, f1, d0, d1 = _segment_coeffs(prof_f, base, i, nodes)
    width = x1 - x0
    ui = (up - jnp.take(cdf_f, base + i)) / jnp.maximum(width, 1e-30)
    # Initial guess from the linear-profile closed form.
    t = jnp.where(
        jnp.abs(f0 - f1) > 1e-20,
        (f0 - jnp.sqrt(jnp.maximum(0.0, f0 * f0 + 2 * ui * (f1 - f0))))
        / jnp.where(jnp.abs(f0 - f1) > 1e-20, f0 - f1, 1.0),
        ui / jnp.maximum(f0, 1e-30),
    )
    a = jnp.zeros_like(t)
    b = jnp.ones_like(t)
    for _ in range(16):  # fixed-trip masked Newton-bisection
        t = jnp.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        big = Fhat - ui > 0
        b = jnp.where(big, t, b)
        a = jnp.where(big, a, t)
        t = t - (Fhat - ui) / jnp.where(jnp.abs(fhat) > 1e-30, fhat, 1.0)
    r_opt = x0 + width * jnp.clip(t, 0.0, 1.0)
    st = jnp.take(tab.sigma_t.reshape(-1), tid * 3 + ch)
    return jnp.where((st > 0) & (cmax > 0),
                     r_opt / jnp.maximum(st, 1e-30), -1.0)


def pdf_sr(tab: SSSTables, tid: Array, ch: int, r: Array) -> Array:
    """TabulatedBSSRDF::Pdf_Sr over lanes (bssrdf.cpp:363-393)."""
    st = jnp.take(tab.sigma_t.reshape(-1), tid * 3 + ch)
    r_opt = r * st
    sr = _eval_profile(tab, tid, ch, r_opt)
    sr = jnp.where(r_opt > 0, sr / (2.0 * jnp.pi * jnp.maximum(r_opt, 1e-30)),
                   sr)
    rhoeff = jnp.take(tab.rhoeff.reshape(-1), tid * 3 + ch)
    return jnp.maximum(0.0, sr * st * st / rhoeff)


def sp(tab: SSSTables, tid: Array, r: Array) -> Array:
    """Spatial profile Sp(po, pi) = Sr(|po-pi|) per RGB channel
    (bssrdf.h:84-85, bssrdf.cpp:233-259).  Returns [R,3]."""
    out = []
    for ch in range(3):
        st = jnp.take(tab.sigma_t.reshape(-1), tid * 3 + ch)
        r_opt = r * st
        sr = _eval_profile(tab, tid, ch, r_opt)
        sr = jnp.where(
            r_opt > 0, sr / (2.0 * jnp.pi * jnp.maximum(r_opt, 1e-30)), sr)
        out.append(jnp.maximum(0.0, sr * st * st))
    return jnp.stack(out, axis=-1)


# ------------------------------------------------------------------
# Sw exit lobe (bssrdf.h:86-97 + the radiance-mode adapter :153-168)
# ------------------------------------------------------------------

def fr_dielectric(cos_i: Array, eta_i, eta_t) -> Array:
    """FrDielectric over lanes (core/reflection.cpp:47-72)."""
    cos_i = jnp.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(cos_i)
    st = ei / et * jnp.sqrt(jnp.maximum(0.0, 1.0 - ci * ci))
    tir = st >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - st * st))
    rpar = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-12)
    rper = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-12)
    return jnp.where(tir, 1.0, 0.5 * (rpar * rpar + rper * rper))


def sw_eval(eta: Array, c_sw: Array, cos_w: Array) -> Array:
    """Sw(w) scaled for radiance transport: (1 - Fr(cos)) / (c pi) *
    eta^2 (bssrdf.h:89-93; adapter :158-163 multiplies eta^2 in
    radiance mode)."""
    fr = fr_dielectric(cos_w, 1.0, eta)
    return (1.0 - fr) / (c_sw * jnp.pi) * eta * eta


# ------------------------------------------------------------------
# Sample_Sp: axis/channel/radius selection + bounded probe chain
# ------------------------------------------------------------------

class SpSample(NamedTuple):
    p: Any        # [P,3] exit point pi
    ns: Any       # [P,3] shading normal at pi
    s_over_pdf: Any  # [P,3] Sp / pdf (the betas multiplier)
    ok: Any       # [P] bool: a valid exit interaction was found


def sample_sp(scene, bvh, tab: SSSTables, sid: Array, po_p: Array,
              frame, po_mat: Array, u1: Array, u2: Array,
              active: Array) -> SpSample:
    """SeparableBSSRDF::Sample_Sp over masked lanes (bssrdf.cpp:
    248-330) + Pdf_Sp (bssrdf.cpp:332-352).

    frame is the po shading frame (ss, ts, ns) = (frame.t, frame.b,
    frame.n); sid the per-lane table index (<0 lanes never fire)."""
    P = po_p.shape[0]
    tid = jnp.maximum(sid, 0)

    # --- projection axis (u1 < .5 -> ns, < .75 -> ss, else ts) -------
    ax_ns = u1 < 0.5
    ax_ss = (u1 >= 0.5) & (u1 < 0.75)
    ax_ts = u1 >= 0.75
    u1r = jnp.where(ax_ns, u1 * 2.0,
                    jnp.where(ax_ss, (u1 - 0.5) * 4.0, (u1 - 0.75) * 4.0))

    def pick(a, b, c):
        return jnp.where(ax_ns[..., None], a,
                         jnp.where(ax_ss[..., None], b, c))

    ss_, ts_, ns_ = frame.t, frame.b, frame.n
    vx = pick(ss_, ts_, ns_)
    vy = pick(ts_, ns_, ss_)
    vz = pick(ns_, ss_, ts_)

    # --- spectral channel + radius (bssrdf.cpp:273-281) --------------
    ch = jnp.clip((u1r * 3.0).astype(jnp.int32), 0, 2)
    u1c = u1r * 3.0 - ch.astype(jnp.float32)
    r = sample_sr(tab, tid, ch, u2[:, 0])
    phi = 2.0 * jnp.pi * u2[:, 1]
    rmax = jnp.take(tab.rmax.reshape(-1), tid * 3 + ch)
    fail = (r < 0) | (r >= rmax) | ~active
    l = 2.0 * jnp.sqrt(jnp.maximum(rmax * rmax - r * r, 0.0))

    # --- bounded probe chain (bssrdf.cpp:283-321) ---------------------
    base = (po_p + r[..., None] * (vx * jnp.cos(phi)[..., None]
                                   + vy * jnp.sin(phi)[..., None])
            - (0.5 * l)[..., None] * vz)
    remaining = jnp.where(fail, 0.0, l)
    eps = 1e-4 * jnp.maximum(1.0, cm.length(po_p))
    hits_p, hits_ns, valid = [], [], []
    probe_on = ~fail
    for _ in range(PROBE_STEPS):
        o_k = base + eps[..., None] * vz
        t_k = jnp.maximum(remaining - 2.0 * eps, 0.0)
        h = intersect_probe(scene, bvh, o_k, vz,
                            jnp.where(probe_on, t_k, 0.0))
        good = h.found & probe_on
        match = good & (h.mat_id == po_mat)
        hits_p.append(h.p)
        hits_ns.append(h.ns)
        valid.append(match)
        adv = jnp.where(good, h.t + eps, 0.0)
        base = jnp.where(good[..., None], h.p, base)
        remaining = jnp.maximum(remaining - adv, 0.0)
        probe_on = good & (remaining > 2.0 * eps)
    valid = jnp.stack(valid, axis=-1)            # [P,K]
    hp = jnp.stack(hits_p, axis=1)               # [P,K,3]
    hn = jnp.stack(hits_ns, axis=1)
    n_found = jnp.sum(valid, axis=-1).astype(jnp.int32)
    fail = fail | (n_found == 0)

    # --- select one admissible interaction (bssrdf.cpp:322-327) -------
    selected = jnp.clip((u1c * n_found.astype(jnp.float32)).astype(jnp.int32),
                        0, jnp.maximum(n_found - 1, 0))
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=-1) - 1
    hot = valid & (rank == selected[..., None])
    hotf = hot.astype(jnp.float32)[..., None]
    pi_p = jnp.sum(hp * hotf, axis=1)
    pi_ns = cm.normalize(jnp.sum(hn * hotf, axis=1)
                         + jnp.where(fail, 1.0, 0.0)[..., None]
                         * jnp.array([0.0, 0.0, 1.0]))

    # --- Pdf_Sp over 3 axes x 3 channels (bssrdf.cpp:332-352) ---------
    dvec = po_p - pi_p
    d_l = jnp.stack([cm.dot(ss_, dvec), cm.dot(ts_, dvec),
                     cm.dot(ns_, dvec)], axis=-1)
    n_l = jnp.stack([cm.dot(ss_, pi_ns), cm.dot(ts_, pi_ns),
                     cm.dot(ns_, pi_ns)], axis=-1)
    rproj = jnp.stack([
        jnp.sqrt(d_l[:, 1] ** 2 + d_l[:, 2] ** 2),
        jnp.sqrt(d_l[:, 2] ** 2 + d_l[:, 0] ** 2),
        jnp.sqrt(d_l[:, 0] ** 2 + d_l[:, 1] ** 2),
    ], axis=-1)
    axis_prob = jnp.array([0.25, 0.25, 0.5])
    pdf = jnp.zeros((P,))
    for axis in range(3):
        for c in range(3):
            pdf = pdf + (pdf_sr(tab, tid, c, rproj[:, axis])
                         * jnp.abs(n_l[:, axis]) * axis_prob[axis]
                         * (1.0 / 3.0))
    pdf = pdf / jnp.maximum(n_found.astype(jnp.float32), 1.0)

    s_val = sp(tab, tid, cm.length(dvec))
    ok = ~fail & (pdf > 0) & jnp.any(s_val > 0, axis=-1)
    s_over_pdf = jnp.where(
        ok[..., None], s_val / jnp.maximum(pdf, 1e-30)[..., None], 0.0)
    return SpSample(p=pi_p, ns=pi_ns, s_over_pdf=s_over_pdf, ok=ok)


def intersect_probe(scene, bvh, o, d, t_max):
    """Closest-hit with material id + shading normal for the probe
    chain.  Thin wrapper so tests can monkeypatch geometry."""
    from .intersect import intersect_scene

    return intersect_scene(scene, o, d, t_max=t_max, bvh=bvh)


# ------------------------------------------------------------------
# Direct lighting at the exit point with the Sw lobe
# ------------------------------------------------------------------

def estimate_direct_sw(scene, bvh, dist, keys, dstep, pi_p: Array,
                       pi_ns: Array, eta: Array, c_sw: Array,
                       active: Array, sampler_mode_ignored=None):
    """UniformSampleOneLight at the SSS exit vertex with the adapter's
    Sw lobe as the BSDF (statpath.cpp:903-914's non-SMIS arm;
    EstimateDirect both halves, core/integrator.cpp:95-236).

    The SMIS variant statpath uses when enableSMIS is on
    (UniformSampleOneLightSMIS) is NOT replicated at sss vertices -- a
    documented simplification: the exit vertex falls back to plain
    power-heuristic MIS (the win-rate feedback state is per-bounce
    film-space and the exit vertex has no stable strategy identity).

    Draws ride dedicated threefry slots (media-style: variable-rate
    sites stay outside the LD slot map, core/rng.py:32-41)."""
    from ..core import rng as crng
    from . import bsdf as B
    from . import lights as LT
    from .intersect import intersect_scene, occluded_scene
    from .lightdistrib import sample_light_id
    from .integrator import power_heuristic, _offset_origin

    P = pi_p.shape[0]
    exit_frame = B.ShadingFrame.from_normal(pi_ns)
    u_sel = crng.uniform_1d(keys, dstep, crng.SLOT_SSS_LIGHT_SELECT)
    u_light = crng.uniform_2d(keys, dstep, crng.SLOT_SSS_LIGHT)
    light_id, sel_pmf = sample_light_id(dist, u_sel, pi_p)
    lsamp = LT.sample_li(scene, light_id, pi_p, pi_ns, u_light)
    cos_wi = cm.dot(lsamp.wi, pi_ns)
    # Reflection-only lobe: wi must share the ns hemisphere with
    # wo = +ns (adapter is BSDF_REFLECTION | BSDF_DIFFUSE).
    f_l = jnp.where(cos_wi > 0, sw_eval(eta, c_sw, cos_wi) * cos_wi, 0.0)
    pdf_scatter = jnp.where(cos_wi > 0, cos_wi / jnp.pi, 0.0)
    lvalid = active & (lsamp.pdf > 0) & jnp.any(lsamp.li > 0, -1) \
        & (f_l > 0)
    sh_o = _offset_origin(pi_p, pi_ns, lsamp.wi)
    occ = occluded_scene(
        scene, sh_o, lsamp.wi,
        jnp.where(lvalid, jnp.maximum(lsamp.dist * 0.999, 0.0), 0.0),
        bvh=bvh)
    li_l = jnp.where((lvalid & ~occ)[..., None], lsamp.li, 0.0)
    w_l = jnp.where(lsamp.is_delta, 1.0,
                    power_heuristic(1.0, lsamp.pdf, 1.0, pdf_scatter))
    ld = (f_l * w_l / jnp.maximum(lsamp.pdf, 1e-30))[..., None] * li_l

    # BSDF half: cosine-sample the Sw lobe.
    u_bs = crng.uniform_2d(keys, dstep, crng.SLOT_SSS_NEE_BSDF)
    wi_l = B.cosine_sample_hemisphere(u_bs)
    wi_w = exit_frame.to_world(wi_l)
    cos_b = jnp.maximum(wi_l[:, 2], 0.0)
    f_b = sw_eval(eta, c_sw, cos_b) * cos_b
    pdf_b = cos_b / jnp.pi
    bs_o = _offset_origin(pi_p, pi_ns, wi_w)
    bvalid = active & ~lsamp.is_delta & (pdf_b > 0) & (f_b > 0)
    hit2 = intersect_scene(scene, bs_o, wi_w,
                           t_max=jnp.where(bvalid, cm.INF, 0.0), bvh=bvh,
                           lean=True)
    same_light = hit2.found & (hit2.light_id == light_id)
    li_b_hit = LT.area_light_le(scene, hit2.light_id, hit2.ng, -wi_w)
    from ..scene import build as sb
    is_inf = scene.light_kind[light_id] == sb.LIGHT_INFINITE
    li_b_esc = jnp.where(is_inf[..., None],
                         LT.escaped_radiance(scene, wi_w), 0.0)
    li_b = jnp.where(same_light[..., None], li_b_hit,
                     jnp.where(hit2.found[..., None], 0.0, li_b_esc))
    light_pdf_b = LT.pdf_li(scene, light_id, pi_p, wi_w, hit2.p, hit2.ng,
                            hit2.found)
    w_b = power_heuristic(1.0, pdf_b, 1.0, light_pdf_b)
    add_b = (f_b * w_b / jnp.maximum(pdf_b, 1e-30))[..., None] * li_b
    ld = ld + jnp.where((bvalid & (light_pdf_b > 0))[..., None], add_b, 0.0)
    return jnp.where(active[..., None],
                     ld / jnp.maximum(sel_pmf, 1e-30)[..., None], 0.0)
