"""Realistic (lens-system) camera: element tracing + exit-pupil sampling.

Re-derivation of the reference's RealisticCamera
(/root/reference/src/cameras/realistic.cpp):

* lens prescription rows (curvature radius, thickness, eta, aperture
  diameter; millimetres) scaled to metres, aperture stop clamped by
  "float aperturediameter" (realistic.cpp:58-72);
* thick-lens autofocus: trace paraxial rays from both sides, compute
  cardinal points, solve for the rear-element translation that focuses
  "float focusdistance" (realistic.cpp:365-474);
* exit-pupil bounds per radial film segment, found by tracing a grid of
  rear-element samples (realistic.cpp:BoundExitPupil:499-537);
* GenerateRay: physical film point -> sampled exit-pupil point ->
  sequential spherical-interface trace with refraction
  (TraceLensesFromFilm, realistic.cpp:100-151), weight
  cos^4(theta) * pupilArea / pupilArea[0] (simple weighting,
  realistic.cpp:779-783).

Wavefront shape: the lens stack is tiny and static, so the per-element walk
unrolls as a python loop of vectorized ops over all lanes with an
`alive` mask -- no data-dependent control flow.  All precomputation
(focus, pupil bounds) runs once on the host in vectorized numpy; the
device trace touches only [N]-element constant arrays.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core import math as cm


class LensSystem(NamedTuple):
    curvature: Any      # [N] f32 metres; 0 marks the aperture stop
    thickness: Any      # [N]
    eta: Any            # [N]
    ap_radius: Any      # [N] metres
    rear_z: float       # z of the rear element plane (lens space)
    pupil_bounds: Any   # [NSLOT, 4] (x0, y0, x1, y1) exit-pupil bounds
    film_diag: float    # metres
    film_ext: Any       # [2] physical film half-extent (x, y) metres


# ---------------------------------------------------------------------------
# Host-side trace (vectorized numpy) -- used for focus + pupil bounds.
# ---------------------------------------------------------------------------


def _refract_np(wi, n, eta_rel):
    """Refract unit wi about unit n with relative IOR eta_rel = etaI/etaT
    (core/reflection.h:Refract); returns (wt, ok)."""
    cos_i = np.sum(n * wi, axis=-1)
    sin2_i = np.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta_rel * eta_rel * sin2_i
    ok = sin2_t < 1.0
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin2_t))
    wt = (-wi * eta_rel[..., None]
          + (eta_rel * cos_i - cos_t)[..., None] * n)
    return wt, ok


def _trace_np(curv, thick, eta, ap_r, o, d, from_scene=False):
    """TraceLensesFromFilm/Scene (realistic.cpp:100-151, 175-220) over a
    batch: o, d [R, 3] in LENS space (z flipped camera space).  Returns
    (o_out, d_out, alive)."""
    N = len(curv)
    alive = np.ones(o.shape[0], bool)
    o = o.copy()
    d = d.copy()
    order = range(N) if from_scene else range(N - 1, -1, -1)
    # Element z: from film, elementZ starts at 0 and walks negative.
    if from_scene:
        element_z = -float(np.sum(thick))
    else:
        element_z = 0.0
    for i in order:
        if not from_scene:
            element_z -= thick[i]
        is_stop = curv[i] == 0
        if is_stop:
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (element_z - o[:, 2]) / d[:, 2]
            ok = (d[:, 2] < 0) if not from_scene else (d[:, 2] != 0)
            n_el = np.zeros_like(o)
        else:
            radius = curv[i]
            z_center = element_z + radius
            oc = o - np.array([0.0, 0.0, z_center])
            A = np.sum(d * d, -1)
            B = 2.0 * np.sum(d * oc, -1)
            C = np.sum(oc * oc, -1) - radius * radius
            disc = B * B - 4 * A * C
            ok = disc > 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            q = np.where(B < 0, -0.5 * (B - sq), -0.5 * (B + sq))
            with np.errstate(divide="ignore", invalid="ignore"):
                t0 = np.where(ok, q / A, np.inf)
                t1 = np.where(ok, C / np.where(q == 0, 1, q), np.inf)
            tmin, tmax = np.minimum(t0, t1), np.maximum(t0, t1)
            closer = (d[:, 2] > 0) ^ (radius < 0)
            t = np.where(closer, tmin, tmax)
            ok = ok & (t >= 0)
            p = o + t[:, None] * d
            n_el = p - np.array([0.0, 0.0, z_center])
            n_el = n_el / np.maximum(
                np.linalg.norm(n_el, axis=-1, keepdims=True), 1e-20)
            n_el = np.where(np.sum(n_el * -d, -1, keepdims=True) < 0,
                            -n_el, n_el)
        p = o + t[:, None] * d
        r2 = p[:, 0] ** 2 + p[:, 1] ** 2
        ok = ok & (r2 <= ap_r[i] * ap_r[i])
        if not is_stop:
            if from_scene:
                eta_i = 1.0 if i == 0 or eta[i - 1] == 0 else eta[i - 1]
                eta_t = eta[i] if eta[i] != 0 else 1.0
            else:
                eta_i = eta[i]
                eta_t = eta[i - 1] if (i > 0 and eta[i - 1] != 0) else 1.0
            dn = d / np.maximum(
                np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
            wt, rok = _refract_np(-dn, n_el, np.full(len(o),
                                                     eta_i / eta_t))
            ok = ok & rok
            d = np.where(ok[:, None], wt, d)
        o = np.where(ok[:, None], p, o)
        alive = alive & ok
        if from_scene:
            element_z += thick[i]
    return o, d, alive


def _compute_cardinal(o_in, d_in, o_out, d_out):
    """(principal plane z, focal z) from a paraxial ray pair
    (realistic.cpp:ComputeCardinalPoints:416-427)."""
    tf = -o_out[0] / d_out[0]
    fz = -(o_out[2] + tf * d_out[2])
    tp = (o_in[0] - o_out[0]) / d_out[0]
    pz = -(o_out[2] + tp * d_out[2])
    return pz, fz


def make_lens_system(lens_rows: np.ndarray, aperture_diameter_mm: float,
                     focus_distance: float, film_diag_m: float,
                     xres: int, yres: int, n_slots: int = 64,
                     n_pupil_samples: int = 256 * 256) -> LensSystem:
    """Build + focus the lens system and bound the exit pupil."""
    rows = np.asarray(lens_rows, np.float64).reshape(-1, 4)
    curv = rows[:, 0] * 1e-3
    thick = rows[:, 1] * 1e-3
    eta = rows[:, 2].copy()
    ap_d = rows[:, 3].copy()
    stop = curv == 0
    if aperture_diameter_mm is not None:
        ap_d[stop] = np.minimum(ap_d[stop], aperture_diameter_mm)
    ap_r = ap_d * 1e-3 / 2.0

    # Thick-lens focus (realistic.cpp:429-452): paraxial x offset.
    x = 0.001 * film_diag_m

    # The traces run in LENS space (z negative toward the scene); the
    # cardinal-point formulas are written in CAMERA space
    # (realistic.cpp:416-427 after LensToCamera), so flip z on the way
    # out.
    flip = np.array([1.0, 1.0, -1.0])

    def cardinal_from_scene():
        front_z = -float(np.sum(thick))
        o = np.array([[x, 0.0, front_z - 1.0]])
        d = np.array([[0.0, 0.0, 1.0]])
        oo, dd, ok = _trace_np(curv, thick, eta, ap_r, o, d,
                               from_scene=True)
        assert ok[0], "thick-lens trace from scene failed"
        return _compute_cardinal(o[0] * flip, d[0] * flip,
                                 oo[0] * flip, dd[0] * flip)

    def cardinal_from_film():
        rear_z = -thick[-1]
        o = np.array([[x, 0.0, rear_z + 1.0]])
        d = np.array([[0.0, 0.0, -1.0]])
        oo, dd, ok = _trace_np(curv, thick, eta, ap_r, o, d)
        assert ok[0], "thick-lens trace from film failed"
        return _compute_cardinal(o[0] * flip, d[0] * flip,
                                 oo[0] * flip, dd[0] * flip)

    pz0, fz0 = cardinal_from_scene()   # film side
    pz1, fz1 = cardinal_from_film()    # scene side
    f = fz0 - pz0
    z = -focus_distance
    c = (pz1 - z - pz0) * (pz1 - z - 4 * f - pz0)
    assert c > 0, "focusdistance too short for this lens"
    delta = 0.5 * (pz1 - z + pz0 - np.sqrt(c))
    thick[-1] = thick[-1] + delta

    rear_z = -float(thick[-1])
    rear_r = float(ap_r[-1])

    # Exit-pupil bounds per radial film segment
    # (realistic.cpp:BoundExitPupil): grid of rear-plane samples traced
    # from the segment's film point; union of survivors + spacing pad.
    half_diag = film_diag_m / 2.0
    side = int(np.sqrt(n_pupil_samples))
    us = (np.arange(side) + 0.5) / side
    gx, gy = np.meshgrid(us, us, indexing="ij")
    prx = (-1.5 * rear_r) + gx.reshape(-1) * (3.0 * rear_r)
    pry = (-1.5 * rear_r) + gy.reshape(-1) * (3.0 * rear_r)
    bounds = np.zeros((n_slots, 4), np.float64)
    S = side * side
    for i in range(n_slots):
        fx = (i + 0.5) / n_slots * half_diag
        o = np.stack([np.full(S, fx), np.zeros(S), np.zeros(S)], -1)
        pr = np.stack([prx, pry, np.full(S, rear_z)], -1)
        d = pr - o
        _, _, ok = _trace_np(curv, thick, eta, ap_r, o, d)
        if not ok.any():
            bounds[i] = (-1.5 * rear_r, -1.5 * rear_r,
                         1.5 * rear_r, 1.5 * rear_r)
            continue
        bx, by = prx[ok], pry[ok]
        pad = 2.0 * (3.0 * rear_r * np.sqrt(2.0)) / side
        bounds[i] = (bx.min() - pad, by.min() - pad,
                     bx.max() + pad, by.max() + pad)

    aspect = yres / xres
    ext_x = np.sqrt(film_diag_m**2 / (1 + aspect * aspect))
    ext_y = aspect * ext_x

    # The prescription rides as STATIC tuples of Python floats, not
    # device arrays: trace_from_film unrolls the element loop with
    # per-element Python branches (curvature==0 aperture stops), and the
    # camera pytree travels through jit as an argument
    # (driver.split_device_args) where array leaves turn into tracers.
    return LensSystem(
        curvature=tuple(float(c) for c in curv),
        thickness=tuple(float(t) for t in thick),
        eta=tuple(float(e) for e in eta),
        ap_radius=tuple(float(a) for a in ap_r),
        rear_z=rear_z,
        pupil_bounds=jnp.asarray(bounds, jnp.float32),
        film_diag=float(film_diag_m),
        film_ext=jnp.asarray([ext_x, ext_y], jnp.float32),
    )


# ---------------------------------------------------------------------------
# Device-side generate (jnp, static unroll over elements).
# ---------------------------------------------------------------------------


def _refract_jnp(wi, n, eta_rel):
    cos_i = jnp.sum(n * wi, axis=-1)
    sin2_t = eta_rel * eta_rel * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    ok = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = (-wi * eta_rel[..., None]
          + (eta_rel * cos_i - cos_t)[..., None] * n)
    return wt, ok


def trace_from_film(lens: LensSystem, o, d):
    """Batched TraceLensesFromFilm in lens space; (o, d, alive)."""
    curv = np.asarray(lens.curvature)
    thick = np.asarray(lens.thickness)
    eta = np.asarray(lens.eta)
    ap_r = np.asarray(lens.ap_radius)
    N = curv.shape[0]
    alive = jnp.ones(o.shape[:-1], bool)
    element_z = 0.0
    for i in range(N - 1, -1, -1):
        element_z -= float(thick[i])
        if curv[i] == 0:
            t = (element_z - o[..., 2]) / jnp.where(
                d[..., 2] == 0, 1.0, d[..., 2])
            ok = d[..., 2] < 0
            n_el = jnp.zeros_like(o)
        else:
            radius = float(curv[i])
            z_center = element_z + radius
            oc = o - jnp.array([0.0, 0.0, z_center])
            A = jnp.sum(d * d, -1)
            B = 2.0 * jnp.sum(d * oc, -1)
            C = jnp.sum(oc * oc, -1) - radius * radius
            disc = B * B - 4 * A * C
            ok = disc > 0
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            q = jnp.where(B < 0, -0.5 * (B - sq), -0.5 * (B + sq))
            t0 = q / jnp.where(A == 0, 1.0, A)
            t1 = C / jnp.where(q == 0, 1.0, q)
            tmin = jnp.minimum(t0, t1)
            tmax = jnp.maximum(t0, t1)
            closer = (d[..., 2] > 0) ^ (radius < 0)
            t = jnp.where(closer, tmin, tmax)
            ok = ok & (t >= 0)
            p_hit = o + t[..., None] * d
            n_el = p_hit - jnp.array([0.0, 0.0, z_center])
            n_el = n_el / jnp.maximum(
                jnp.linalg.norm(n_el, axis=-1, keepdims=True), 1e-20)
            n_el = jnp.where(
                jnp.sum(n_el * -d, -1, keepdims=True) < 0, -n_el, n_el)
        p_hit = o + t[..., None] * d
        r2 = p_hit[..., 0] ** 2 + p_hit[..., 1] ** 2
        ok = ok & (r2 <= float(ap_r[i]) ** 2)
        if curv[i] != 0:
            eta_i = float(eta[i])
            eta_t = float(eta[i - 1]) if (i > 0 and eta[i - 1] != 0) \
                else 1.0
            dn = d / jnp.maximum(
                jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
            wt, rok = _refract_jnp(
                -dn, n_el, jnp.full(o.shape[:-1], eta_i / eta_t))
            ok = ok & rok
            d = jnp.where(ok[..., None], wt, d)
        o = jnp.where(ok[..., None], p_hit, o)
        alive = alive & ok
    return o, d, alive


def generate_rays_realistic(lens: LensSystem, c2w, xres, yres,
                            p_film_raster, u_lens):
    """(o_world, d_world, weight) for raster points + lens samples
    (realistic.cpp:GenerateRay:749-784, simple weighting)."""
    s = p_film_raster / jnp.asarray([xres, yres], jnp.float32)
    ext = lens.film_ext
    p2 = (s - 0.5) * ext  # physical extent lerp, centred
    p_film = jnp.stack([-p2[..., 0], p2[..., 1],
                        jnp.zeros_like(p2[..., 0])], -1)

    # SampleExitPupil (realistic.cpp:616-636).
    r_film = jnp.sqrt(p_film[..., 0] ** 2 + p_film[..., 1] ** 2)
    n_slots = lens.pupil_bounds.shape[0]
    idx = jnp.clip(
        (r_film / (lens.film_diag / 2) * n_slots).astype(jnp.int32),
        0, n_slots - 1)
    b = lens.pupil_bounds[idx]
    lx = b[..., 0] + u_lens[..., 0] * (b[..., 2] - b[..., 0])
    ly = b[..., 1] + u_lens[..., 1] * (b[..., 3] - b[..., 1])
    area = jnp.maximum((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                       0.0)
    area0 = jnp.maximum(
        (lens.pupil_bounds[0, 2] - lens.pupil_bounds[0, 0])
        * (lens.pupil_bounds[0, 3] - lens.pupil_bounds[0, 1]), 1e-20)
    safe_r = jnp.where(r_film > 0, r_film, 1.0)
    cos_a = jnp.where(r_film > 0, p_film[..., 0] / safe_r, 1.0)
    sin_a = jnp.where(r_film > 0, p_film[..., 1] / safe_r, 0.0)
    p_rear = jnp.stack(
        [cos_a * lx - sin_a * ly, sin_a * lx + cos_a * ly,
         jnp.full_like(lx, lens.rear_z)], -1)

    d0 = p_rear - p_film
    o_l, d_l, alive = trace_from_film(lens, p_film, d0)

    # Lens space <-> camera space: z flip (realistic.cpp:103).
    flip = jnp.asarray([1.0, 1.0, -1.0])
    o_cam = o_l * flip
    d_cam = d_l * flip
    R = c2w[:3, :3]
    tvec = c2w[:3, 3]
    # Elementwise 3x3 rotation: a width-3 product may run in TF32.
    o_w = cm.transform_vector(R, o_cam) + tvec
    d_w = cm.transform_vector(R, d_cam)
    d_w = d_w / jnp.maximum(
        jnp.linalg.norm(d_w, axis=-1, keepdims=True), 1e-20)

    d0n = d0 / jnp.maximum(jnp.linalg.norm(d0, axis=-1, keepdims=True),
                           1e-20)
    cos4 = d0n[..., 2] ** 4
    w = jnp.where(alive, cos4 * area / area0, 0.0)
    # Dead rays keep a unit direction so downstream normalize/intersect
    # math stays finite; their weight is 0.
    d_w = jnp.where(alive[..., None], d_w,
                    jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]),
                                     d_w.shape))
    return o_w, d_w, w
