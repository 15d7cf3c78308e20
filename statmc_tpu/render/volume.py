"""Wavefront volumetric path tracer (volpath) with participating media.

Wavefront re-derivation of the reference's VolPathIntegrator::Li
(/root/reference/src/integrators/volpath.cpp:54-188) and its media:

* HomogeneousMedium::Sample/Tr (src/media/homogeneous.cpp:44-77):
  channel-stratified exponential distance sampling, closed-form
  transmittance;
* GridDensityMedium::Sample/Tr (src/media/grid.cpp:47-115): delta
  tracking for the scattering event, ratio tracking for transmittance,
  trilinear density lookups in [0,1]^3 density space;
* Henyey-Greenstein phase function (src/core/medium.cpp HG);
* attenuated NEE: shadow and BSDF/phase-MIS rays walk through
  null-material boundaries multiplying per-segment medium transmittance
  (VisibilityTester::Tr / Scene::IntersectTr, src/core/scene.cpp),
  re-shaped as a BOUNDED crossing loop (K segments, K=1 when the scene
  has no null materials);
* surface vertices follow volpath.cpp:100-147 (NEE + BSDF sampling +
  etaScale Russian roulette from bounce 4).

Wavefront shape differences: the recursive per-sample loop is a lax.scan over
a fixed bounce budget with per-lane masks (medium and surface vertices
both consume a bounce, volpath.cpp:71); delta/ratio tracking are
bounded fori_loops (unbiased until the step cap, which is far past any
practical optical depth); every random draw is counter-addressed, with
tracking-loop draws folding the iteration index into the site key.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as cm
from ..core import rng as crng
from ..scene import build as sb
from . import bsdf as B
from . import lights as LT
from .integrator import (
    IntegratorConfig, SampleOutput, _approx_albedo, _offset_origin,
    _scrub_ls, power_heuristic,
)
from .intersect import PRIM_TRI, intersect_scene
from .lightdistrib import sample_light_id

Array = jax.Array

BIG = 1e8  # stands in for an infinite ray extent (escaped rays)
GRID_SAMPLE_STEPS = 256  # delta-tracking step cap (E[steps] ~ maxD*st*L)
GRID_TR_STEPS = 128  # ratio-tracking step cap per segment
# Key stride between transmittance_walk segments: each segment's
# ratio-tracking loop consumes GRID_TR_STEPS iterations of SLOT_TR, so
# adjacent segments must sit at least that far apart in key space.
_SEG_KEY_STRIDE = GRID_TR_STEPS


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (core/medium.h:HenyeyGreenstein; the
# value IS the pdf -- sampling is exact).
# ---------------------------------------------------------------------------


def hg_phase(g: Array, cos_theta: Array) -> Array:
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * jnp.pi * denom
                            * jnp.sqrt(jnp.maximum(denom, 1e-12)))


def sample_hg(g: Array, wo: Array, u2: Array) -> Array:
    """Sample wi around -wo's axis (medium.cpp HenyeyGreenstein::Sample_p
    measures theta from wo and builds the frame around wo; the returned
    direction continues the path)."""
    g_safe = jnp.where(jnp.abs(g) < 1e-3, 1e-3, g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u2[:, 0])
    cos_t = jnp.where(
        jnp.abs(g) < 1e-3,
        1.0 - 2.0 * u2[:, 0],
        -(1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe),
    )
    cos_t = jnp.clip(cos_t, -1.0, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u2[:, 1]
    frame = B.ShadingFrame.from_normal(wo)
    local = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
    )
    return frame.to_world(local)


# ---------------------------------------------------------------------------
# Media lookups
# ---------------------------------------------------------------------------


def _apply44_p(m: Array, p: Array) -> Array:
    """Homogeneous point transform, elementwise (no bf16 dot; [P,4,4]x[P,3])."""
    x = m[:, 0, 0] * p[:, 0] + m[:, 0, 1] * p[:, 1] + m[:, 0, 2] * p[:, 2] + m[:, 0, 3]
    y = m[:, 1, 0] * p[:, 0] + m[:, 1, 1] * p[:, 1] + m[:, 1, 2] * p[:, 2] + m[:, 1, 3]
    z = m[:, 2, 0] * p[:, 0] + m[:, 2, 1] * p[:, 1] + m[:, 2, 2] * p[:, 2] + m[:, 2, 3]
    return jnp.stack([x, y, z], axis=-1)


def _apply44_v(m: Array, v: Array) -> Array:
    x = m[:, 0, 0] * v[:, 0] + m[:, 0, 1] * v[:, 1] + m[:, 0, 2] * v[:, 2]
    y = m[:, 1, 0] * v[:, 0] + m[:, 1, 1] * v[:, 1] + m[:, 1, 2] * v[:, 2]
    z = m[:, 2, 0] * v[:, 0] + m[:, 2, 1] * v[:, 1] + m[:, 2, 2] * v[:, 2]
    return jnp.stack([x, y, z], axis=-1)


def _grid_density(scene: sb.SceneTables, midx: Array, p: Array) -> Array:
    """Trilinear density at p in [0,1]^3 density space; 0 outside
    (grid.cpp:47-61 Density + the D() out-of-range clamp)."""
    n = scene.med_nxyz[midx].astype(jnp.float32)  # [P,3] (nx,ny,nz)
    ps = p * n - 0.5
    pi = jnp.floor(ps)
    dd = ps - pi
    pi = pi.astype(jnp.int32)

    def D(ox, oy, oz):
        xi = pi[:, 0] + ox
        yi = pi[:, 1] + oy
        zi = pi[:, 2] + oz
        ok = ((xi >= 0) & (xi < scene.med_nxyz[midx, 0])
              & (yi >= 0) & (yi < scene.med_nxyz[midx, 1])
              & (zi >= 0) & (zi < scene.med_nxyz[midx, 2]))
        v = scene.med_grid[
            midx, jnp.clip(zi, 0, scene.med_grid.shape[1] - 1),
            jnp.clip(yi, 0, scene.med_grid.shape[2] - 1),
            jnp.clip(xi, 0, scene.med_grid.shape[3] - 1),
        ]
        return jnp.where(ok, v, 0.0)

    d00 = D(0, 0, 0) * (1 - dd[:, 0]) + D(1, 0, 0) * dd[:, 0]
    d10 = D(0, 1, 0) * (1 - dd[:, 0]) + D(1, 1, 0) * dd[:, 0]
    d01 = D(0, 0, 1) * (1 - dd[:, 0]) + D(1, 0, 1) * dd[:, 0]
    d11 = D(0, 1, 1) * (1 - dd[:, 0]) + D(1, 1, 1) * dd[:, 0]
    d0 = d00 * (1 - dd[:, 1]) + d10 * dd[:, 1]
    d1 = d01 * (1 - dd[:, 1]) + d11 * dd[:, 1]
    return d0 * (1 - dd[:, 2]) + d1 * dd[:, 2]


def _unit_cube_range(om: Array, dm: Array, tmax: Array):
    """Ray overlap [t0, t1] with [0,1]^3 (Bounds3f::IntersectP)."""
    inv = jnp.where(jnp.abs(dm) > 1e-12, 1.0 / dm,
                    jnp.where(dm >= 0, 1e12, -1e12))
    t_lo = (0.0 - om) * inv
    t_hi = (1.0 - om) * inv
    tn = jnp.minimum(t_lo, t_hi)
    tf = jnp.maximum(t_lo, t_hi)
    t0 = jnp.maximum(jnp.max(tn, axis=-1), 0.0)
    t1 = jnp.minimum(jnp.min(tf, axis=-1), tmax)
    return t0, t1, t0 <= t1


def _tr_key(keys: Array, step, slot: int, it) -> Array:
    """Per-lane key for tracking-loop iteration draws: fold (step, slot,
    iteration) into the per-(pixel,sample) keys."""
    b = jnp.broadcast_to(jnp.asarray(step), keys.shape[:1])

    def mk(k, bb):
        k = jax.random.fold_in(k, bb)
        k = jax.random.fold_in(k, slot)
        return jax.random.fold_in(k, it)

    return jax.vmap(mk)(keys, b)


def sample_medium(scene: sb.SceneTables, cfg: IntegratorConfig, med: Array,
                  o: Array, d: Array, t_hit: Array, keys: Array, step):
    """Sample a scattering event in [0, t_hit) along normalized d.

    Returns (t [P], sampled [P] bool, weight [P,3]) -- the beta factor is
    Tr*sigma_s/pdf on a scatter, Tr/pdf on pass-through
    (homogeneous.cpp:50-77; grid.cpp:63-72 delta tracking).
    Only meaningful where med >= 0 (callers mask)."""
    P = o.shape[0]
    midx = jnp.clip(med, 0, None)
    sa = scene.med_sigma_a[midx]
    ss = scene.med_sigma_s[midx]
    st = sa + ss  # [P,3]
    u = crng.uniform_2d(keys, step, crng.SLOT_MEDIUM)

    # Homogeneous closed form.
    chan = jnp.minimum((u[:, 0] * 3).astype(jnp.int32), 2)
    st_c = jnp.take_along_axis(st, chan[:, None], axis=1)[:, 0]
    dist = -jnp.log1p(-u[:, 1]) / jnp.maximum(st_c, 1e-20)
    t_h = jnp.minimum(dist, t_hit)
    sampled_h = dist < t_hit
    tr = jnp.exp(-st * jnp.minimum(t_h, BIG)[:, None])
    density = jnp.where(sampled_h[:, None], st * tr, tr)
    pdf = jnp.mean(density, axis=-1)
    pdf = jnp.where(pdf <= 0, 1.0, pdf)
    w_h = jnp.where(sampled_h[:, None], tr * ss, tr) / pdf[:, None]

    if not cfg.has_grid_media:
        return t_h, sampled_h, w_h

    # Grid delta tracking in density space (grid.cpp:63-72).  The ray
    # keeps its WORLD-distance parameterization through the transform
    # (pbrt transforms o and d without renormalizing, so t stays in
    # world units and sigma_t applies directly).
    w2m = scene.med_w2m[midx]
    om = _apply44_p(w2m, o)
    dm = _apply44_v(w2m, d)
    t0, t1, inbox = _unit_cube_range(om, dm, t_hit)
    st0 = jnp.maximum(scene.med_sigt0[midx], 1e-20)
    imd = scene.med_inv_maxd[midx]

    def body(i, c):
        t, done, scattered = c
        k = _tr_key(keys, step, crng.SLOT_TR, i)
        uu = jax.vmap(lambda kk: jax.random.uniform(kk, (2,)))(k)
        t_new = t - jnp.log1p(-uu[:, 0]) * imd / st0
        esc = t_new >= t1
        dens = _grid_density(scene, midx, om + dm * t_new[:, None])
        real = dens * imd > uu[:, 1]
        scattered = scattered | (~done & ~esc & real)
        done_new = done | esc | real
        t = jnp.where(done, t, t_new)
        return t, done_new, scattered

    t_m, _, scat = jax.lax.fori_loop(
        0, GRID_SAMPLE_STEPS, body,
        (t0, ~inbox, jnp.zeros((P,), bool)),
    )
    t_g = jnp.minimum(t_m, t_hit)
    w_g = jnp.where(scat[:, None], ss / jnp.maximum(st, 1e-20),
                    jnp.ones((P, 3)))

    is_grid = scene.med_kind[midx] == 1
    return (
        jnp.where(is_grid, t_g, t_h),
        jnp.where(is_grid, scat, sampled_h),
        jnp.where(is_grid[:, None], w_g, w_h),
    )


def _segment_tr(scene: sb.SceneTables, cfg: IntegratorConfig, med: Array,
                o: Array, d: Array, seg: Array, keys: Array, step,
                it_base: int) -> Array:
    """Transmittance through one medium segment of length seg along
    normalized d (homogeneous closed form; grid ratio tracking,
    grid.cpp:75-115).  Returns [P,3]; 1 where med < 0."""
    midx = jnp.clip(med, 0, None)
    st = scene.med_sigma_a[midx] + scene.med_sigma_s[midx]
    seg_c = jnp.clip(seg, 0.0, BIG)
    tr_h = jnp.exp(-st * seg_c[:, None])

    if cfg.has_grid_media:
        w2m = scene.med_w2m[midx]
        om = _apply44_p(w2m, o)
        dm = _apply44_v(w2m, d)
        t0, t1, inbox = _unit_cube_range(om, dm, seg_c)
        st0 = jnp.maximum(scene.med_sigt0[midx], 1e-20)
        imd = scene.med_inv_maxd[midx]

        def body(i, c):
            tr, t, done = c
            k = _tr_key(keys, step, crng.SLOT_TR, it_base + i)
            uu = jax.vmap(lambda kk: jax.random.uniform(kk, (2,)))(k)
            t_new = t - jnp.log1p(-uu[:, 0]) * imd / st0
            esc = t_new >= t1
            dens = _grid_density(scene, midx, om + dm * t_new[:, None])
            tr_new = tr * (1.0 - jnp.maximum(0.0, dens * imd))
            # Ratio-tracking Russian roulette (grid.cpp:104-110).
            q = jnp.maximum(0.05, 1.0 - tr_new)
            rr = tr_new < 0.1
            killed = rr & (uu[:, 1] < q)
            tr_new = jnp.where(killed, 0.0, jnp.where(
                rr, tr_new / (1.0 - q), tr_new))
            upd = ~done & ~esc
            tr = jnp.where(upd, tr_new, tr)
            t = jnp.where(done, t, t_new)
            done = done | esc | killed
            return tr, t, done

        tr_g, _, _ = jax.lax.fori_loop(
            0, GRID_TR_STEPS, body,
            (jnp.ones_like(t0), t0, ~inbox),
        )
        is_grid = scene.med_kind[midx] == 1
        tr_h = jnp.where(is_grid[:, None], tr_g[:, None], tr_h)

    return jnp.where((med >= 0)[:, None], tr_h, 1.0)


def _crossing_medium(scene: sb.SceneTables, hit, d: Array,
                     med: Array) -> Array:
    """Medium on the far side of a crossed surface: the shape's inside
    medium when the ray travels against the outward geometric normal,
    its outside medium otherwise (core/interaction.h GetMedium(w))."""
    if scene.tri_med_in is None:
        return med
    idx = hit.prim_idx
    n_tri = max(scene.tri_med_in.shape[0], 1)
    n_sph = max(scene.sph_med_in.shape[0], 1)
    ti = jnp.clip(idx, 0, n_tri - 1)
    si = jnp.clip(idx, 0, n_sph - 1)
    m_in = jnp.where(
        hit.prim_kind == PRIM_TRI,
        scene.tri_med_in[ti] if scene.tri_med_in.shape[0] else -1,
        scene.sph_med_in[si] if scene.sph_med_in.shape[0] else -1,
    )
    m_out = jnp.where(
        hit.prim_kind == PRIM_TRI,
        scene.tri_med_out[ti] if scene.tri_med_out.shape[0] else -1,
        scene.sph_med_out[si] if scene.sph_med_out.shape[0] else -1,
    )
    entering = cm.dot(d, hit.ng) < 0
    return jnp.where(hit.found, jnp.where(entering, m_in, m_out), med)


def transmittance_walk(scene: sb.SceneTables, bvh, cfg: IntegratorConfig,
                       med0: Array, o: Array, d: Array, t_max: Array,
                       keys: Array, step, slot_tag: int):
    """Walk a ray through media and null boundaries accumulating Tr
    (Scene::IntersectTr, src/core/scene.cpp:57-77).

    Returns (tr [P,3], hit) where hit is the first REAL-material surface
    (or light) encountered within t_max; tr excludes that surface's
    blocking (the caller decides: shadow rays zero it, MIS rays read its
    Le).  K crossing segments bound the loop; K=1 when the scene has no
    null materials (cfg.null_extra == 0), else 1 + null_extra so the
    walk crosses at least as many null interfaces as the bounce scan
    budgets pass-throughs for (the reference's Scene::IntersectTr loop
    is unbounded; agreeing with null_extra means no shadow ray stops
    short of a boundary the camera path could legally cross)."""
    P = o.shape[0]
    K = 1 + cfg.null_extra if cfg.null_extra else 1
    tr = jnp.ones((P, 3))
    cur_o = o
    med = med0
    remaining = t_max
    walking = t_max > 0
    first = None
    for k in range(K):
        hit = intersect_scene(
            scene, cur_o, d, t_max=jnp.where(walking, remaining, 0.0),
            bvh=bvh)
        seg = jnp.minimum(jnp.where(hit.found, hit.t, BIG), remaining)
        tr = tr * jnp.where(
            walking[:, None],
            # Key spacing: _segment_tr draws it_base + i with
            # i < GRID_TR_STEPS, and distance sampling uses raw
            # iterations 0..GRID_SAMPLE_STEPS-1 on the same SLOT_TR;
            # segments are spaced by a full loop cap and slot_tags by
            # K_MAX segments so no (step, slot, it) key ever collides
            # (a collision correlates consecutive segments' uniforms
            # and biases the product of their Tr estimates).
            _segment_tr(scene, cfg, med, cur_o, d, seg, keys, step,
                        it_base=(GRID_SAMPLE_STEPS
                                 + _SEG_KEY_STRIDE * (16 * slot_tag + k))),
            1.0,
        )
        is_hit = hit.found & walking
        null_mat = scene.mat_type[hit.mat_id] == sb.MAT_NONE
        real = is_hit & ~null_mat
        if first is None:
            first = hit._replace(
                prim_kind=jnp.where(real, hit.prim_kind, 0),
                light_id=jnp.where(real, hit.light_id, -1),
            )
            real_any = real
        else:
            fresh = real & ~real_any
            first = jax.tree.map(
                lambda new, old: jnp.where(
                    fresh.reshape(fresh.shape + (1,) * (new.ndim - 1)),
                    new, old),
                hit._replace(
                    prim_kind=jnp.where(real, hit.prim_kind, 0),
                    light_id=jnp.where(real, hit.light_id, -1)),
                first,
            )
            real_any = real_any | fresh
        # Cross null boundaries and continue.
        cross = is_hit & null_mat
        med = jnp.where(cross, _crossing_medium(scene, hit, d, med), med)
        remaining = jnp.where(cross, remaining - hit.t, remaining)
        cur_o = jnp.where(cross[:, None], hit.p + d * 1e-4, cur_o)
        walking = cross
    return tr, first, real_any


# ---------------------------------------------------------------------------
# The volpath bounce scan
# ---------------------------------------------------------------------------


def trace_volpath(
    scene: sb.SceneTables,
    bvh,
    dist,
    cfg: IntegratorConfig,
    o0: Array,
    d0: Array,
    keys: Array,
    avg_ls: Array,
    win_bsdf: Array,
    win_light: Array,
    feedback_on: Array,
    albedo_luts=None,
    ld_stream=None,
) -> SampleOutput:
    """Media-aware bounce scan with the same SampleOutput contract as
    integrator.trace, so the driver, film, statistics, and denoiser all
    work unchanged for volpath scenes.  Ls[0] carries the film estimate;
    per-bounce tracking / SMIS / ACRR are statpath features volpath does
    not have (volpath.cpp has neither) and stay zero."""
    P = o0.shape[0]
    NL = cfg.n_ls
    NB = max(cfg.nb_mis, 1)
    cam_med = jnp.full((P,), scene.cam_medium, jnp.int32)

    carry = dict(
        o=o0, d=d0,
        L=jnp.zeros((P, 3)),
        beta=jnp.ones((P, 3)),
        specular=jnp.zeros((P,), bool),
        active=jnp.ones((P,), bool),
        eta_scale=jnp.ones((P,)),
        med=cam_med,
        bounce=jnp.zeros((P,), jnp.int32),
        mat_id=jnp.zeros((P,)),
        depth=jnp.zeros((P,)),
        normal=jnp.zeros((P, 3)),
        albedo=jnp.zeros((P, 3)),
        n_rays=jnp.zeros((P,)),
        path_len=jnp.zeros((P,)),
        cum_t=jnp.zeros((P,)),
    )
    n_steps = cfg.max_depth + 1 + cfg.null_extra

    def body(carry, step):
        o, d = carry["o"], carry["d"]
        active = carry["active"]
        bl = carry["bounce"]
        med = carry["med"]
        beta = carry["beta"]
        L = carry["L"]

        tmax_live = jnp.where(active, cm.INF, 0.0)
        hit = intersect_scene(scene, o, d, t_max=tmax_live, bvh=bvh)
        found = hit.found & active
        t_hit = jnp.where(found, hit.t, BIG)

        # --- medium event sampling (volpath.cpp:76-78) -------------------
        in_med = active & (med >= 0)
        t_m, sampled_m, w_m = sample_medium(
            scene, cfg, med, o, d, t_hit, keys, step)
        beta = beta * jnp.where(in_med[:, None], w_m, 1.0)
        beta_dead = jnp.all(beta <= 0, axis=-1)
        mi = in_med & sampled_m & ~beta_dead

        # --- surface emission (volpath.cpp:100-110) ----------------------
        emit = ((bl == 0) | carry["specular"]) & ~mi & active & ~beta_dead
        le_hit = LT.area_light_le(scene, hit.light_id, hit.ng, -d)
        le_esc = LT.escaped_radiance(scene, d)
        le = jnp.where(found[..., None], le_hit,
                       jnp.where(active[..., None], le_esc, 0.0))
        L = L + jnp.where(emit[..., None], beta * le, 0.0)

        depth_ok = bl < cfg.max_depth

        # =================== medium vertex ================================
        m_vert = mi & depth_ok
        p_m = o + d * t_m[:, None]
        g = scene.med_g[jnp.clip(med, 0, None)]

        # Light half of EstimateDirect (phase f == pdf).  The light
        # selection point is the actual vertex (medium or surface) so
        # spatial distributions look up the right voxel.
        u_sel = crng.uniform_1d(keys, step, crng.SLOT_LIGHT_SELECT)
        p_sel = jnp.where(mi[:, None], p_m, hit.p)
        light_id, sel_pmf = sample_light_id(dist, u_sel, p_sel)
        u_light = crng.uniform_2d(keys, step, crng.SLOT_LIGHT_SAMPLE)
        lsamp = LT.sample_li(scene, light_id, p_m, jnp.zeros_like(p_m),
                             u_light)
        ph_l = hg_phase(g, cm.dot(-d, lsamp.wi))
        lvalid = m_vert & (lsamp.pdf > 0) & jnp.any(lsamp.li > 0, -1) \
            & (ph_l > 0)
        # Infinite/distant lights: pbrt's VisibilityTester endpoint is
        # p + 2*worldRadius*wi (infinite.cpp Sample_Li), so media
        # attenuate over that length, not over an unbounded ray.
        sh_len = jnp.minimum(lsamp.dist, 2.0 * scene.world_radius) * 0.999
        tr_l, blk, blocked = transmittance_walk(
            scene, bvh, cfg, med, p_m, lsamp.wi,
            jnp.where(lvalid, jnp.maximum(sh_len, 0.0), 0.0),
            keys, step, slot_tag=1)
        li_l = jnp.where((lvalid & ~blocked)[..., None],
                         lsamp.li * tr_l, 0.0)
        w_l = jnp.where(lsamp.is_delta, 1.0,
                        power_heuristic(1.0, lsamp.pdf, 1.0, ph_l))
        contr_l = ph_l[..., None] * li_l * w_l[..., None] \
            / jnp.maximum(lsamp.pdf, 1e-30)[..., None]

        # Phase half.
        u_ph = crng.uniform_2d(keys, step, crng.SLOT_PHASE_NEE)
        wi_ph = sample_hg(g, -d, u_ph)
        ph_p = hg_phase(g, cm.dot(-d, wi_ph))
        pvalid = m_vert & ~lsamp.is_delta & (ph_p > 0)
        tr_p, hit_p, real_p = transmittance_walk(
            scene, bvh, cfg, med, p_m, wi_ph,
            jnp.where(pvalid, cm.INF, 0.0), keys, step, slot_tag=2)
        same_light = real_p & (hit_p.light_id == light_id)
        li_p_hit = LT.area_light_le(scene, hit_p.light_id, hit_p.ng,
                                    -wi_ph)
        is_inf = scene.light_kind[light_id] == sb.LIGHT_INFINITE
        li_p_esc = jnp.where(is_inf[..., None],
                             LT.escaped_radiance(scene, wi_ph), 0.0)
        li_p = jnp.where(same_light[..., None], li_p_hit,
                         jnp.where(real_p[..., None], 0.0, li_p_esc))
        lpdf_p = LT.pdf_li(scene, light_id, p_m, wi_ph, hit_p.p,
                           hit_p.ng, real_p)
        w_p = power_heuristic(1.0, ph_p, 1.0, lpdf_p)
        contr_p = tr_p * li_p * w_p[..., None]  # f/pdf == 1 for HG
        contr_p = jnp.where((pvalid & (lpdf_p > 0))[..., None]
                            | (pvalid & ~real_p & is_inf)[..., None],
                            contr_p, 0.0)

        ld_m = (contr_l + contr_p) / jnp.maximum(sel_pmf, 1e-30)[..., None]
        L = L + jnp.where(m_vert[..., None], beta * ld_m, 0.0)

        # Phase-sampled continuation (beta unchanged: f/pdf == 1).
        u_pc_m = crng.uniform_2d(keys, step, crng.SLOT_PHASE)
        wi_m = sample_hg(g, -d, u_pc_m)

        # =================== surface vertex ===============================
        cone_w = cfg.cone0 + cfg.cone_spread * (carry["cum_t"] + jnp.where(
            found, hit.t, 0.0))
        m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p,
                               uv_fp=cone_w * hit.uv_density)
        null_mat = m.mat_type == sb.MAT_NONE
        s_vert = found & ~mi & depth_ok & ~null_mat & ~beta_dead
        pass_through = found & ~mi & depth_ok & null_mat & ~beta_dead

        frame = B.ShadingFrame.from_normal(
            jnp.where(jnp.any(hit.ns != 0, -1, keepdims=True), hit.ns,
                      jnp.array([0.0, 0.0, 1.0])))
        wo_l = frame.to_local(-d)

        # Bounce-0 feature capture (G-buffers still work under volpath).
        first = (bl == 0) & s_vert
        carry_mat = jnp.where(first, (hit.mat_id + 1).astype(jnp.float32),
                              carry["mat_id"])
        carry_depth = jnp.where(first, hit.t, carry["depth"])
        carry_normal = jnp.where(first[..., None], hit.ns, carry["normal"])
        if albedo_luts is not None:
            from .albedo_lut import albedo_from_curves

            alb = albedo_from_curves(albedo_luts[0], albedo_luts[1],
                                     hit.mat_id, m.kd, B.cos_theta(wo_l))
        else:
            alb = _approx_albedo(m, B.cos_theta(wo_l))
        carry_albedo = jnp.where(first[..., None], alb, carry["albedo"])

        # NEE (volpath.cpp:124-127; attenuated visibility).
        delta_b = B.is_specular(m)
        nee = s_vert & ~delta_b
        lsamp_s = LT.sample_li(scene, light_id, hit.p, hit.ng, u_light)
        wi_sl = frame.to_local(lsamp_s.wi)
        f_l, pdf_scat = B.evaluate(m, wo_l, wi_sl)
        f_l = f_l * cm.absdot(lsamp_s.wi, hit.ns)[..., None]
        svalid = nee & (lsamp_s.pdf > 0) & jnp.any(lsamp_s.li > 0, -1) \
            & jnp.any(f_l > 0, -1)
        sh_o = _offset_origin(hit.p, hit.ng, lsamp_s.wi)
        med_sh = _crossing_medium(scene, hit, lsamp_s.wi, med)
        sh_len_s = jnp.minimum(lsamp_s.dist,
                               2.0 * scene.world_radius) * 0.999
        tr_s, _, blocked_s = transmittance_walk(
            scene, bvh, cfg, med_sh, sh_o, lsamp_s.wi,
            jnp.where(svalid, jnp.maximum(sh_len_s, 0.0), 0.0),
            keys, step, slot_tag=3)
        li_s = jnp.where((svalid & ~blocked_s)[..., None],
                         lsamp_s.li * tr_s, 0.0)
        w_sl = jnp.where(lsamp_s.is_delta, 1.0,
                         power_heuristic(1.0, lsamp_s.pdf, 1.0, pdf_scat))
        contr_sl = f_l * li_s * w_sl[..., None] \
            / jnp.maximum(lsamp_s.pdf, 1e-30)[..., None]

        # BSDF half.
        u_bs = crng.uniform_2d(keys, step, crng.SLOT_BSDF_NEE)
        uc_bs = crng.uniform_1d(keys, step, crng.SLOT_BSDF_COMPONENT)
        bsmp = B.sample(m, wo_l, u_bs, uc_bs)
        wi_b = frame.to_world(bsmp.wi)
        f_b = bsmp.f * cm.absdot(wi_b, hit.ns)[..., None]
        bvalid = nee & ~lsamp_s.is_delta & (bsmp.pdf > 0) \
            & jnp.any(f_b > 0, -1)
        bs_o = _offset_origin(hit.p, hit.ng, wi_b)
        med_b = _crossing_medium(scene, hit, wi_b, med)
        tr_b, hit_b, real_b = transmittance_walk(
            scene, bvh, cfg, med_b, bs_o, wi_b,
            jnp.where(bvalid, cm.INF, 0.0), keys, step, slot_tag=4)
        same_l_b = real_b & (hit_b.light_id == light_id)
        li_b_hit = LT.area_light_le(scene, hit_b.light_id, hit_b.ng, -wi_b)
        li_b_esc = jnp.where(is_inf[..., None],
                             LT.escaped_radiance(scene, wi_b), 0.0)
        li_b = jnp.where(same_l_b[..., None], li_b_hit,
                         jnp.where(real_b[..., None], 0.0, li_b_esc))
        lpdf_b = LT.pdf_li(scene, light_id, hit.p, wi_b, hit_b.p,
                           hit_b.ng, real_b)
        w_bb = jnp.where(bsmp.specular, 1.0,
                         power_heuristic(1.0, bsmp.pdf, 1.0, lpdf_b))
        contr_bb = f_b * (tr_b * li_b) * w_bb[..., None] \
            / jnp.maximum(bsmp.pdf, 1e-30)[..., None]
        contr_bb = jnp.where(
            (bvalid & (bsmp.specular | (lpdf_b > 0)))[..., None]
            | (bvalid & ~real_b & is_inf)[..., None],
            contr_bb, 0.0)

        ld_s = (jnp.where(svalid[..., None], contr_sl, 0.0) + contr_bb) \
            / jnp.maximum(sel_pmf, 1e-30)[..., None]
        L = L + jnp.where(nee[..., None], beta * ld_s, 0.0)

        # BSDF continuation (volpath.cpp:129-147).
        u_pc = crng.uniform_2d(keys, step, crng.SLOT_BSDF)
        uc_pc = crng.uniform_1d(keys, step, crng.SLOT_BSDF_COMPONENT_PC)
        psmp = B.sample(m, wo_l, u_pc, uc_pc)
        wi_c = frame.to_world(psmp.wi)
        bsdf_beta = psmp.f * cm.absdot(wi_c, hit.ns)[..., None] \
            / jnp.maximum(psmp.pdf, 1e-30)[..., None]
        dead_s = s_vert & (jnp.all(psmp.f <= 0, -1) | (psmp.pdf <= 0))
        eta2 = m.eta[..., 0] ** 2
        entering = cm.dot(-d, hit.ng) > 0
        eta_mul = jnp.where(
            psmp.specular & psmp.transmission & s_vert,
            jnp.where(entering, eta2, 1.0 / jnp.maximum(eta2, 1e-9)),
            1.0,
        )

        # ---- merge the three vertex kinds -------------------------------
        new_beta = jnp.where(s_vert[:, None], beta * bsdf_beta, beta)
        d_new = jnp.where(m_vert[:, None], wi_m,
                          jnp.where(pass_through[:, None], d,
                                    jnp.where(s_vert[:, None], wi_c, d)))
        o_surf = _offset_origin(hit.p, hit.ng, d_new)
        o_new = jnp.where(
            m_vert[:, None], p_m,
            jnp.where(pass_through[:, None], hit.p + d * 1e-4,
                      jnp.where(s_vert[:, None], o_surf, o)))
        # Medium transitions: continuation rays crossing a surface pick
        # up the far side's medium (transmission: d_new on the SAME side
        # of ng as the incoming d); medium vertices stay in theirs.
        crossed = cm.dot(d_new, hit.ng) * cm.dot(d, hit.ng) > 0
        med_new = jnp.where(
            pass_through | (s_vert & crossed),
            _crossing_medium(scene, hit, d_new, med), med)
        spec_new = jnp.where(m_vert, False,
                             jnp.where(pass_through, carry["specular"],
                                       psmp.specular))
        eta_scale = carry["eta_scale"] * jnp.where(dead_s, 1.0, eta_mul)

        active = active & ~beta_dead & (
            m_vert | pass_through | (s_vert & ~dead_s))

        # Russian roulette (volpath.cpp:179-187: bounces > 3).
        rr_beta_max = jnp.max(new_beta * eta_scale[:, None], axis=-1)
        q = jnp.maximum(0.05, 1.0 - rr_beta_max)
        u_rr = crng.uniform_1d(keys, step, crng.SLOT_RR)
        do_rr = (bl > 3) & active & (rr_beta_max < cfg.rr_threshold)
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        new_beta = jnp.where((do_rr & ~killed)[:, None],
                             new_beta / jnp.maximum(1.0 - q, 1e-6)[:, None],
                             new_beta)

        n_rays = carry["n_rays"] + carry["active"].astype(jnp.float32) \
            + 2.0 * (m_vert | nee).astype(jnp.float32)
        path_len = carry["path_len"] + (m_vert | s_vert).astype(jnp.float32)
        bl_new = bl + jnp.where(pass_through, 0, 1).astype(jnp.int32)

        new_carry = dict(
            o=o_new, d=d_new, L=L, beta=new_beta, specular=spec_new,
            active=active, eta_scale=eta_scale, med=med_new,
            bounce=bl_new, mat_id=carry_mat, depth=carry_depth,
            normal=carry_normal, albedo=carry_albedo, n_rays=n_rays,
            path_len=path_len,
            cum_t=carry["cum_t"] + jnp.where(found, hit.t, 0.0),
        )
        return new_carry, None

    carry, _ = jax.lax.scan(body, carry, jnp.arange(n_steps))

    ls = jnp.zeros((P, NL, 3)).at[:, 0, :].set(carry["L"])
    return SampleOutput(
        ls=_scrub_ls(ls),
        mis_bsdf=jnp.zeros((P, NB)),
        mis_light=jnp.zeros((P, NB)),
        mat_id=carry["mat_id"],
        depth=carry["depth"],
        normal=carry["normal"],
        albedo=carry["albedo"],
        n_rays=carry["n_rays"],
        path_len=carry["path_len"],
    )
