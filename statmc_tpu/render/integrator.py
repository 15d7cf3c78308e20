"""Wavefront statistics-tracking path integrator.

Wavefront re-derivation of the reference's StatPathIntegrator::Li
(/root/reference/src/statistics/statpath.cpp:761-958) including:

* per-bounce radiance estimates Ls[i] with partial throughputs betas[i]
  (betas[i] accumulates BSDF factors only from bounces >= i,
  statpath.cpp:873-877) -- the inputs to ACRR;
* next-event estimation with both MIS halves (core/integrator.cpp:
  EstimateDirect semantics: light sample + BSDF sample per bounce);
* selective MIS (SMIS) with win-rate-driven strategy disabling and the
  goto-light re-run (statpath.cpp:552-730), vectorized as masked lanes;
* approximate-contribution Russian roulette (ACRR): survival scaled by
  denoised per-bounce mean ratios (statpath.cpp:930-953);
* bounce-0 G-buffer feature capture (statpath.cpp:828-835);
* the NaN/negative/inf radiance scrub (statpath.cpp:333-351).

Control flow differences from the reference are architectural, not
semantic: the recursive-ish per-sample bounce loop becomes a lax.scan
over a fixed bounce axis with per-lane active masks; every sample of
every pixel advances in lockstep as one XLA program.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as cm
from ..core import rng as crng
from ..core import spectrum as spec
from ..scene import build as sb
from . import bsdf as B
from . import lights as LT
from .intersect import intersect_scene, occluded_scene
from .lightdistrib import LightDistribution, sample_light_id

Array = jax.Array


class IntegratorConfig(NamedTuple):
    """Static (hashable) integrator configuration -- the product of the
    reference's config compiler (statpath.cpp:1026-1173)."""
    max_depth: int = 5
    n_ls: int = 1  # Radiance bounceEnd (>=1); >1 when ACRR tracks bounces
    nb_mis: int = 0  # MISWinRate bounceEnd; 0 disables SMIS tallies
    enable_smis: bool = False
    enable_acrr: bool = False
    rr_threshold: float = 1.0
    rr_start_bounce: int = 4  # reference: RR from the 5th bounce (b > 3)
    sampler_mode: int = 0  # core/rng.py MODE_*: random / (0,2)-seq / halton
    cone0: float = 0.0  # ray-cone width at the origin (ortho pixel size)
    cone_spread: float = 0.0  # ray-cone growth per unit distance
    # Ray cones replace pbrt's per-ray differential vectors
    # (core/camera.h:RayDifferential, scaled 1/sqrt(spp) at
    # statpath.cpp:301-303 -- folded into cone_spread at prepare()):
    # the cone width at a hit drives the MIPmap trilinear level.
    enable_nee: bool = True  # False = brute-force BSDF-only estimator
    # (not a reference feature; used as an independent ground truth for
    # validating the NEE+MIS estimator in tests)
    direct_only: bool = False  # whitted/directlighting semantics: paths
    # continue ONLY through specular lobes (integrators/directlighting.cpp
    # and whitted.cpp recurse solely via SpecularReflect/Transmit)
    null_extra: int = 0  # extra scan steps granted for null-material
    # pass-throughs, which do NOT consume a bounce (statpath.cpp:823-827
    # does bounces-- on a null-BSDF hit); >0 only when the scene has
    # null materials, keeping the common case at max_depth+1 steps
    volumetric: bool = False  # volpath + scene has media: dispatch the
    # media-aware bounce scan (render/volume.py, volpath.cpp:54-188)
    has_grid_media: bool = False  # compile the delta/ratio-tracking
    # loops only when a grid medium exists (homogeneous is closed-form)
    enable_sss: bool = False  # scene has subsurface materials: compile
    # the in-bounce BSSRDF block (render/sss.py, statpath.cpp:892-926);
    # off for every other scene -- the probe-chain intersects and the
    # exit-vertex NEE are entirely elided


class SampleOutput(NamedTuple):
    ls: Any  # [P, NL, 3] per-bounce radiance estimates (Ls[0] = film L)
    mis_bsdf: Any  # [P, NB] tallies this sample
    mis_light: Any  # [P, NB]
    mat_id: Any  # [P] material id feature (0 = miss)
    depth: Any  # [P] ray.tMax at first hit
    normal: Any  # [P,3] shading normal at first hit
    albedo: Any  # [P,3] approximate albedo at first hit
    n_rays: Any  # [P] rays traced for this sample (closest + shadow)
    path_len: Any  # [P] number of bounces survived (pathLength stat)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0, f * f / jnp.maximum(denom, 1e-30), 0.0)


def _approx_albedo(m: B.MaterialLanes, cos_o: Array) -> Array:
    """Directional albedo approximation.

    The reference precomputes per-material-family albedo LUTs
    (src/statistics/lut.h, src/statistics/luts/) queried at bounce 0
    (src/core/material.cpp:63-92).  On the device a closed-form per-family
    approximation replaces the 8-D gather; the LUT path (with its
    precompute tool) is layered on top for parity runs.
    """
    t = m.mat_type
    f_diel = B.fresnel_dielectric(jnp.abs(cos_o), 1.0, 1.5)[..., None]
    f_cond = B.fresnel_conductor(cos_o, m.eta, m.k)
    f_glass = B.fresnel_dielectric(jnp.abs(cos_o), 1.0, m.eta[..., 0])[..., None]
    alb = m.kd
    alb = jnp.where(
        ((t == sb.MAT_PLASTIC) | (t == sb.MAT_UBER)
         | (t == sb.MAT_SUBSTRATE))[..., None],
        m.kd + m.ks * f_diel, alb,
    )
    alb = jnp.where((t == sb.MAT_METAL)[..., None], f_cond, alb)
    alb = jnp.where((t == sb.MAT_MIRROR)[..., None], m.kr, alb)
    alb = jnp.where(
        (t == sb.MAT_GLASS)[..., None],
        m.kr * f_glass + m.kt * (1.0 - f_glass), alb,
    )
    return jnp.clip(alb, 0.0, 1.0)


def _offset_origin(p, ng, w):
    """Spawn-ray origin offset along the geometric normal."""
    n = jnp.where(cm.dot(ng, w)[..., None] < 0, -ng, ng)
    return p + n * 1e-4 * jnp.maximum(1.0, cm.length(p))[..., None]


def _zero_path_carry(P: int, NL: int, NB: int) -> dict:
    """Per-path state that resets at every sample start (regeneration)."""
    return dict(
        ls=jnp.zeros((P, NL, 3)),
        betas=jnp.ones((P, NL, 3)),
        specular=jnp.zeros((P,), bool),
        active=jnp.ones((P,), bool),
        eta_scale=jnp.ones((P,)),
        mis_bsdf=jnp.zeros((P, NB)),
        mis_light=jnp.zeros((P, NB)),
        mat_id=jnp.zeros((P,)),
        depth=jnp.zeros((P,)),
        normal=jnp.zeros((P, 3)),
        albedo=jnp.zeros((P, 3)),
        n_rays=jnp.zeros((P,)),
        path_len=jnp.zeros((P,)),
        cum_t=jnp.zeros((P,)),
        bounce=jnp.zeros((P,), jnp.int32),
    )


def _bounce_step(scene, bvh, dist, cfg: IntegratorConfig, carry, step,
                 keys, avg_ls, win_bsdf, win_light, feedback_on,
                 albedo_luts, ld_stream):
    """One lockstep bounce over all lanes.

    `step` is the draw-site index: the scan counter in per-sample mode,
    or the per-lane step-in-sample counter [P] under path regeneration
    (both count physics steps from 0 at the sample start, so the random
    streams are identical between the two drivers)."""
    P = carry["o"].shape[0]
    NL = cfg.n_ls
    NB = max(cfg.nb_mis, 1)
    o, d = carry["o"], carry["d"]
    active = carry["active"]
    betas, ls = carry["betas"], carry["ls"]
    if True:  # (kept indentation of the former scan-body closure)
        # Per-lane bounce index (NOT the scan step): null pass-throughs
        # leave it unchanged, so all bounce-addressed state (per-bounce
        # Ls buffers, SMIS tallies, RR start) matches the reference's
        # bounces counter exactly.
        bl = carry["bounce"]
        # Draw-site index: lockstep replay addresses the table by the
        # per-lane bounce counter (null pass-throughs consume NO draws,
        # matching statpath.cpp:823-827 which re-spawns before any
        # sampler call); all other modes use the physics step counter.
        dstep = bl if cfg.sampler_mode == crng.MODE_LOCKSTEP else step
        # EXACT lockstep replay (core/lockstep.py EXACT mode): draws are
        # positional reads of the raw per-tile PCG32 stream at a cursor
        # that advances exactly as the reference's conditional sampler
        # consumption would (consumption rules: lockstep.py docstring).
        exact = cfg.sampler_mode == crng.MODE_LOCKSTEP_EXACT
        if exact:
            rows = ld_stream  # [P, L] serial stream rows (lane = tile)
            cur0 = carry["cursor"]

            def take_at(pos):
                return jnp.take_along_axis(
                    rows, jnp.clip(pos, 0, rows.shape[1] - 1)[:, None],
                    axis=1)[:, 0]

        # Dead lanes carry t_max = 0: they cannot hit anything, and the
        # fused kernel's per-tile cull sees a whole-dead ray tile as
        # unable to vote for any triangle tile and skips the dots.
        tmax_live = jnp.where(active, cm.INF, 0.0)
        # Exact replay needs pbrt's BSDF frame at EVERY vertex (ss =
        # normalize(dpdu), core/reflection.h) so cosine-sampled world
        # directions match the reference draw-for-draw.
        hit = intersect_scene(scene, o, d, t_max=tmax_live, bvh=bvh,
                              want_tangent=True if exact else None)
        found = hit.found & active

        # --- emitted light at the vertex (bounce 0 or after specular) ---
        if cfg.enable_nee:
            emit = (bl == 0) | carry["specular"]
        else:
            emit = jnp.ones((P,), bool)  # BSDF-only: Le at every vertex
        le_hit = LT.area_light_le(scene, hit.light_id, hit.ng, -d)
        le_esc = LT.escaped_radiance(scene, d)
        le = jnp.where(found[..., None], le_hit,
                       jnp.where(active[..., None], le_esc, 0.0))
        ls = ls + jnp.where(
            (emit & active)[..., None, None], betas * le[:, None, :], 0.0
        )

        shading = found & (bl < cfg.max_depth)
        cum_t = carry["cum_t"] + jnp.where(found, hit.t, 0.0)
        cone_w = cfg.cone0 + cfg.cone_spread * cum_t
        m = B.gather_materials(
            scene, hit.mat_id, hit.uv, hit.p,
            uv_fp=cone_w * hit.uv_density,
            uv_axes=(hit.uv_axes * cone_w[..., None, None]
                     if hit.uv_axes is not None else None))
        null_mat = m.mat_type == sb.MAT_NONE
        # Null materials pass through without counting the bounce
        # (statpath.cpp:823-827 re-spawns with bounces--): the per-lane
        # counter bl is simply not advanced below.
        shading = shading & ~null_mat

        ns_safe = jnp.where(jnp.any(hit.ns != 0, -1, keepdims=True), hit.ns,
                            jnp.array([0.0, 0.0, 1.0]))
        frame = B.ShadingFrame.from_normal(ns_safe)
        if hit.tangent is not None:
            # Hair scenes: pbrt's BSDF frame uses dpdu as the local x
            # axis (ss, core/reflection.h BSDF ctor) -- the Marschner
            # model measures its longitudinal angle against the curve
            # axis, so the frame must carry the true tangent.
            t_proj = hit.tangent - cm.dot(hit.tangent, ns_safe)[..., None] \
                * ns_safe
            ok = (jnp.sum(t_proj * t_proj, -1, keepdims=True) > 1e-12)
            t_x = cm.normalize(jnp.where(ok, t_proj, frame.t))
            frame = B.ShadingFrame(t_x, jnp.cross(ns_safe, t_x), ns_safe)
        wo_world = -d
        wo_l = frame.to_local(wo_world)

        # --- bounce-0 feature capture -----------------------------------
        first = (bl == 0) & shading
        mat_feature = (hit.mat_id + 1).astype(jnp.float32)
        carry_mat = jnp.where(first, mat_feature, carry["mat_id"])
        carry_depth = jnp.where(first, hit.t, carry["depth"])
        carry_normal = jnp.where(first[..., None], hit.ns, carry["normal"])
        if albedo_luts is not None:
            from .albedo_lut import albedo_from_curves

            alb = albedo_from_curves(
                albedo_luts[0], albedo_luts[1], hit.mat_id, m.kd,
                B.cos_theta(wo_l),
            )
        else:
            alb = _approx_albedo(m, B.cos_theta(wo_l))
        carry_albedo = jnp.where(first[..., None], alb, carry["albedo"])

        # --- next-event estimation --------------------------------------
        delta_bsdf = B.is_specular(m)
        nee = shading & ~delta_bsdf
        if not cfg.enable_nee:
            nee = jnp.zeros_like(nee)

        if exact:
            # pbrt: select(1) + uLight(2) + uScattering(2), consumed
            # only when NEE runs (statpath.cpp:846,744-752).
            u_sel = take_at(cur0)
            u_light = jnp.stack([take_at(cur0 + 1), take_at(cur0 + 2)], -1)
        else:
            u_sel = crng.draw_1d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_LIGHT_SELECT)
            u_light = crng.draw_2d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_LIGHT_SAMPLE)
        light_id, sel_pmf = sample_light_id(dist, u_sel, hit.p)
        p_off_wi = hit.p  # offset applied per ray below

        lsamp = LT.sample_li(scene, light_id, hit.p, hit.ng, u_light)
        wi_l = frame.to_local(lsamp.wi)
        f_l, pdf_l_scatter = B.evaluate(m, wo_l, wi_l)
        f_l = f_l * cm.absdot(lsamp.wi, hit.ns)[..., None]
        lvalid = nee & (lsamp.pdf > 0) & jnp.any(lsamp.li > 0, -1) \
            & jnp.any(f_l > 0, -1)
        sh_o = _offset_origin(hit.p, hit.ng, lsamp.wi)
        occ = occluded_scene(
            scene, sh_o, lsamp.wi,
            jnp.where(lvalid, jnp.maximum(lsamp.dist * 0.999, 0.0), 0.0),
            bvh=bvh,
        )
        li_l = jnp.where((lvalid & ~occ)[..., None], lsamp.li, 0.0)
        contributed_l = jnp.any(li_l > 0, -1) & lvalid
        w_l = power_heuristic(1.0, lsamp.pdf, 1.0, pdf_l_scatter)
        contr_l = f_l * li_l / jnp.maximum(lsamp.pdf, 1e-30)[..., None]

        # BSDF half of EstimateDirect.
        if exact:
            u_bs = jnp.stack([take_at(cur0 + 3), take_at(cur0 + 4)], -1)
            uc_bs = u_bs[:, 0]  # pbrt remaps uScattering.x in-place
        else:
            u_bs = crng.draw_2d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_BSDF_NEE)
            uc_bs = crng.draw_1d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_BSDF_COMPONENT)
        bsmp = B.sample(m, wo_l, u_bs, uc_bs)
        wi2 = frame.to_world(bsmp.wi)
        f_b = bsmp.f * cm.absdot(wi2, hit.ns)[..., None]
        bs_o = _offset_origin(hit.p, hit.ng, wi2)
        # Lean light probe: the BSDF-MIS ray only needs found / light_id
        # / ng / p (Le sidedness + Pdf_Li), so skip the uv/material
        # attribute gathers of the full assembly.
        hit2 = intersect_scene(scene, bs_o, wi2,
                               t_max=jnp.where(nee, cm.INF, 0.0), bvh=bvh,
                               lean=True)
        same_light = hit2.found & (hit2.light_id == light_id)
        li_b_hit = LT.area_light_le(scene, hit2.light_id, hit2.ng, -wi2)
        is_inf_light = scene.light_kind[light_id] == sb.LIGHT_INFINITE
        # Escaped BSDF-MIS rays toward an infinite light evaluate its Le
        # by direction (environment map aware).
        li_b_esc = jnp.where(
            is_inf_light[..., None], LT.escaped_radiance(scene, wi2), 0.0
        )
        li_b = jnp.where(same_light[..., None], li_b_hit,
                         jnp.where(hit2.found[..., None], 0.0, li_b_esc))
        light_pdf_b = LT.pdf_li(
            scene, light_id, hit.p, wi2, hit2.p, hit2.ng, hit2.found
        )
        w_b = jnp.where(
            bsmp.specular, 1.0,
            power_heuristic(1.0, bsmp.pdf, 1.0, light_pdf_b),
        )
        bvalid = (
            nee & ~lsamp.is_delta & (bsmp.pdf > 0) & jnp.any(f_b > 0, -1)
            & (bsmp.specular | (light_pdf_b > 0))
        )
        contributed_b = jnp.any(li_b > 0, -1) & bvalid
        contr_b = f_b * li_b / jnp.maximum(bsmp.pdf, 1e-30)[..., None]

        # --- SMIS strategy disabling (statpath.cpp:559-560,630-728) -----
        # bl is per-lane, so bounce-indexed reads become gathers and the
        # tally scatter a one-hot add (NB is a small static axis).
        smis_here = cfg.enable_smis & (bl < cfg.nb_mis)
        bidx = jnp.minimum(bl, NB - 1)
        bhot = jax.nn.one_hot(bidx, NB, dtype=jnp.float32)

        def at_b(arr):  # [P, NB] -> [P] value at this lane's bounce
            return jnp.take_along_axis(arr, bidx[:, None], axis=1)[:, 0]

        wr_l = at_b(win_light)
        wr_b = at_b(win_bsdf)
        t_b = at_b(carry["mis_bsdf"])
        t_l = at_b(carry["mis_light"])
        fb = feedback_on
        dl0 = smis_here & fb & (wr_l < 1e-3) & (t_l == 0) \
            & ((wr_b >= 1e-3) | (t_b > 0))
        db0 = smis_here & fb & (wr_b < 1e-3) & (t_b == 0) \
            & ((wr_l >= 1e-3) | (t_l > 0))

        exec_l1 = (~dl0 | lsamp.is_delta) & contributed_l
        clear_db = exec_l1 & ~lsamp.is_delta & (w_l <= 0.5)
        db1 = db0 & ~clear_db
        exec_b = ~db1 & ~lsamp.is_delta & contributed_b
        goto_l = exec_b & (w_b <= 0.5) & dl0
        dl1 = dl0 & ~goto_l

        # Contributions with SMIS full-weight promotion.
        ld = jnp.zeros((P, 3))
        add_l1 = jnp.where(
            lsamp.is_delta[..., None],
            contr_l,
            jnp.where((db0 & (w_l > 0.5))[..., None], contr_l,
                      contr_l * w_l[..., None]),
        )
        ld = ld + jnp.where(exec_l1[..., None], add_l1, 0.0)
        add_b = jnp.where((dl1)[..., None], contr_b, contr_b * w_b[..., None])
        ld = ld + jnp.where(exec_b[..., None], add_b, 0.0)
        # goto-light re-run: light half executes once more.
        add_l2 = jnp.where((db1 & (w_l > 0.5))[..., None], contr_l,
                           contr_l * w_l[..., None])
        ld = ld + jnp.where((goto_l & contributed_l)[..., None], add_l2, 0.0)

        ld = ld / jnp.maximum(sel_pmf, 1e-30)[..., None]
        ls = ls + jnp.where(nee[..., None, None],
                            betas * ld[:, None, :], 0.0)

        # Tallies (only when SMIS active at this bounce).
        inc_lt = jnp.where(exec_l1 & ~lsamp.is_delta,
                           jnp.where(w_l > 0.5, 1.0, 0.0), 0.0)
        inc_bt = jnp.where(exec_l1 & ~lsamp.is_delta,
                           jnp.where(w_l > 0.5, 0.0, 1.0), 0.0)
        inc_bt = inc_bt + jnp.where(exec_b, jnp.where(w_b > 0.5, 1.0, 0.0), 0.0)
        inc_lt = inc_lt + jnp.where(exec_b, jnp.where(w_b > 0.5, 0.0, 1.0), 0.0)
        # second light run tallies again
        rerun = goto_l & contributed_l
        inc_lt = inc_lt + jnp.where(rerun, jnp.where(w_l > 0.5, 1.0, 0.0), 0.0)
        inc_bt = inc_bt + jnp.where(rerun, jnp.where(w_l > 0.5, 0.0, 1.0), 0.0)
        sm = (smis_here & nee).astype(jnp.float32)
        mis_bsdf = carry["mis_bsdf"] + bhot * (sm * inc_bt)[:, None]
        mis_light = carry["mis_light"] + bhot * (sm * inc_lt)[:, None]

        # --- BSDF sampling for path continuation ------------------------
        if exact:
            # NEE consumed 5 iff it ran; continuation Get2D consumed
            # whenever the bounce shades (statpath.cpp:869, even when
            # f==0/pdf==0 breaks right after).
            cur1 = cur0 + 5 * nee.astype(jnp.int32)
            u_pc = jnp.stack([take_at(cur1), take_at(cur1 + 1)], -1)
            uc_pc = u_pc[:, 0]
            cur2 = cur1 + 2 * shading.astype(jnp.int32)
        else:
            u_pc = crng.draw_2d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_BSDF)
            uc_pc = crng.draw_1d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_BSDF_COMPONENT_PC)
        psmp = B.sample(m, wo_l, u_pc, uc_pc)
        wi_c = frame.to_world(psmp.wi)
        bsdf_beta = (
            psmp.f * cm.absdot(wi_c, hit.ns)[..., None]
            / jnp.maximum(psmp.pdf, 1e-30)[..., None]
        )
        dead = ~shading | jnp.all(psmp.f <= 0, -1) | (psmp.pdf <= 0)
        if cfg.direct_only:
            # whitted/directlighting: only specular lobes continue
            # (directlighting.cpp / whitted.cpp recurse solely via
            # SpecularReflect/SpecularTransmit).
            dead = dead | ~psmp.specular
        # Null materials continue straight through.
        pass_through = found & (bl < cfg.max_depth) & null_mat
        dead = dead & ~pass_through

        bmask = (jnp.arange(NL)[None, :] <= bl[:, None]) & ~dead[:, None]
        betas = betas * jnp.where(
            bmask[..., None],
            jnp.where(pass_through[:, None, None], 1.0, bsdf_beta[:, None, :]),
            1.0,
        )
        specular_new = jnp.where(pass_through, carry["specular"],
                                 psmp.specular)
        eta2 = m.eta[..., 0] ** 2
        entering = cm.dot(wo_world, hit.ng) > 0
        eta_mul = jnp.where(
            psmp.specular & psmp.transmission,
            jnp.where(entering, eta2, 1.0 / jnp.maximum(eta2, 1e-9)),
            1.0,
        )
        eta_scale = carry["eta_scale"] * jnp.where(dead, 1.0, eta_mul)

        d_new = jnp.where(pass_through[..., None], d, wi_c)
        o_new = _offset_origin(hit.p, hit.ng, d_new)
        o_new = jnp.where(pass_through[..., None],
                          hit.p + d * 1e-4, o_new)

        active = active & found & (bl < cfg.max_depth) & ~dead

        # --- BSSRDF transport (statpath.cpp:892-926) --------------------
        # A transmission event through a subsurface material's
        # FresnelSpecular interface relocates the lane to an exit point
        # pi (Sample_Sp probe chain), multiplies betas[i<=bounce] by
        # S/pdf, adds one EstimateDirect at pi with the Sw lobe, and
        # continues along a cosine-sampled Sw direction -- all within
        # the same bounce, before RR, exactly as the reference orders
        # it.  Statically elided unless the scene has sss materials.
        sss_rays = None
        if cfg.enable_sss and scene.sss is not None:
            from . import sss as SSS

            assert not exact, \
                "exact-lockstep replay does not model BSSRDF draw sites"
            sid = m.sss_id
            sss_fire = shading & (sid >= 0) & psmp.transmission & ~dead \
                & active
            tid = jnp.maximum(sid, 0)
            u_ax = crng.uniform_1d(keys, dstep, crng.SLOT_SSS_AXIS)
            u_rad = crng.uniform_2d(keys, dstep, crng.SLOT_SSS_RADIUS)
            spr = SSS.sample_sp(scene, bvh, scene.sss, sid, hit.p, frame,
                                hit.mat_id, u_ax, u_rad, sss_fire)
            sss_ok = sss_fire & spr.ok
            # betas[i] *= S/pdf for i <= bounces (statpath.cpp:899).
            bm_s = (jnp.arange(NL)[None, :] <= bl[:, None]) \
                & sss_ok[:, None]
            betas = betas * jnp.where(bm_s[..., None],
                                      spr.s_over_pdf[:, None, :], 1.0)
            # Direct lighting at the exit vertex (statpath.cpp:903-914).
            eta_sss = jnp.take(scene.sss.eta, tid)
            c_sss = jnp.take(scene.sss.c_sw, tid)
            ld_sss = SSS.estimate_direct_sw(
                scene, bvh, dist, keys, dstep, spr.p, spr.ns,
                eta_sss, c_sss, sss_ok)
            ls = ls + jnp.where(sss_ok[..., None, None],
                                betas * ld_sss[:, None, :], 0.0)
            # Sw continuation (statpath.cpp:917-925): wo = +ns at pi,
            # cosine-sampled wi, weight f*|cos|/pdf = Sw * pi.
            u_sw = crng.uniform_2d(keys, dstep, crng.SLOT_SSS_SW)
            exit_frame = B.ShadingFrame.from_normal(spr.ns)
            wi_sw_l = B.cosine_sample_hemisphere(u_sw)
            wi_sw = exit_frame.to_world(wi_sw_l)
            f_over_pdf = SSS.sw_eval(eta_sss, c_sss, wi_sw_l[:, 2]) \
                * jnp.pi
            betas = betas * jnp.where(bm_s[..., None],
                                      f_over_pdf[:, None, None], 1.0)
            d_new = jnp.where(sss_ok[..., None], wi_sw, d_new)
            o_new = jnp.where(sss_ok[..., None],
                              _offset_origin(spr.p, spr.ns, wi_sw), o_new)
            specular_new = jnp.where(sss_ok, False, specular_new)
            # Failed Sample_Sp breaks the path (statpath.cpp:898).
            active = active & ~(sss_fire & ~spr.ok)
            # Probe chain + shadow + BSDF-MIS closest rays.
            sss_rays = jnp.where(sss_fire,
                                 float(SSS.PROBE_STEPS) + 2.0, 0.0)

        # --- Russian roulette (statpath.cpp:930-953) --------------------
        rr_here = bl > (cfg.rr_start_bounce - 1)
        avg_idx = jnp.minimum(bl + 1, NL - 1)
        acrr_on = cfg.enable_acrr & feedback_on
        avg_l0 = jnp.maximum(avg_ls[:, 0], 1e-12)
        avg_at = jnp.take_along_axis(avg_ls, avg_idx[:, None], axis=1)[:, 0]
        avg = jnp.where(acrr_on, avg_at / avg_l0, 1.0)
        rr_beta_max = jnp.max(
            betas[:, 0, :] * eta_scale[:, None], axis=-1
        )
        survival = rr_beta_max * avg
        q = jnp.maximum(0.05, 1.0 - survival)
        # Null pass-throughs never reach the RR block (statpath.cpp:
        # 823-827 `continue`s before it).
        do_rr = rr_here & active & ~pass_through \
            & (survival < cfg.rr_threshold)
        if exact:
            # pbrt's Get1D sits inside both conditionals
            # (statpath.cpp:941-948): consumed only when do_rr.
            u_rr = take_at(cur2)
            cur3 = cur2 + do_rr.astype(jnp.int32)
        else:
            u_rr = crng.draw_1d(keys, ld_stream, cfg.sampler_mode, dstep, crng.SLOT_RR)
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        betas = jnp.where(
            (do_rr & ~killed)[:, None, None],
            betas / jnp.maximum(1.0 - q, 1e-6)[:, None, None],
            betas,
        )

        n_rays = (
            carry["n_rays"]
            + carry["active"].astype(jnp.float32)  # path closest-hit
            + 2.0 * nee.astype(jnp.float32)  # shadow + BSDF-MIS closest
        )
        if sss_rays is not None:
            n_rays = n_rays + sss_rays
        path_len = carry["path_len"] + shading.astype(jnp.float32)
        # Advance the per-lane bounce counter; null pass-throughs stay
        # (statpath.cpp:823-827 bounces--).
        bl_new = bl + jnp.where(pass_through, 0, 1).astype(jnp.int32)
        new_carry = dict(
            o=o_new, d=d_new, ls=ls, betas=betas,
            specular=specular_new, active=active, eta_scale=eta_scale,
            mis_bsdf=mis_bsdf, mis_light=mis_light,
            mat_id=carry_mat, depth=carry_depth,
            normal=carry_normal, albedo=carry_albedo, n_rays=n_rays,
            path_len=path_len, cum_t=cum_t, bounce=bl_new,
        )
        if exact:
            new_carry["cursor"] = cur3
        return new_carry


def _scrub_ls(ls):
    """NaN / negative / infinite luminance scrub on the film estimate
    (statpath.cpp:333-351): only Ls[0] is scrubbed."""
    l0 = ls[:, 0, :]
    y = spec.luminance(l0)
    bad = jnp.isnan(jnp.sum(l0, -1)) | (y < -1e-5) | jnp.isinf(y)
    return ls.at[:, 0, :].set(jnp.where(bad[..., None], 0.0, l0))


def _carry_output(cfg: IntegratorConfig, carry) -> SampleOutput:
    return SampleOutput(
        ls=_scrub_ls(carry["ls"]),
        mis_bsdf=carry["mis_bsdf"][:, : max(cfg.nb_mis, 1)],
        mis_light=carry["mis_light"][:, : max(cfg.nb_mis, 1)],
        mat_id=carry["mat_id"],
        depth=carry["depth"],
        normal=carry["normal"],
        albedo=carry["albedo"],
        n_rays=carry["n_rays"],
        path_len=carry["path_len"],
    )


def trace(
    scene: sb.SceneTables,
    bvh,
    dist: LightDistribution,
    cfg: IntegratorConfig,
    o0: Array,
    d0: Array,
    keys: Array,  # [P,2] per-(pixel,sample) key data
    avg_ls: Array,  # [P, NL] denoised per-bounce mean luminance (ACRR)
    win_bsdf: Array,  # [P, NB] denoised MIS win rates
    win_light: Array,  # [P, NB]
    feedback_on: Array,  # scalar bool: iteration > 1 (ACRR/SMIS feedback live)
    albedo_luts=None,  # per-material reduced curves (render/albedo_lut.py)
    ld_stream=None,  # (pixel scramble keys [P,2], sample index): LD modes
) -> SampleOutput:
    """Per-sample lockstep driver: every lane traces exactly one sample
    through a fixed-length bounce scan.  Shares `_bounce_step` with the
    path-regeneration driver (`trace_wavefront`); both produce identical
    per-sample outputs (the random streams are addressed by
    (pixel, sample, step-in-sample, slot) in both)."""
    P = o0.shape[0]
    carry = dict(o=o0, d=d0,
                 **_zero_path_carry(P, cfg.n_ls, max(cfg.nb_mis, 1)))

    # Scan steps: one per bounce plus the escape/Le step, plus a bounded
    # allowance for null-material pass-throughs (which do not advance the
    # per-lane bounce counter, mirroring statpath.cpp:823-827).
    n_steps = cfg.max_depth + 1 + cfg.null_extra

    def body(carry, step):
        new_carry = _bounce_step(
            scene, bvh, dist, cfg, carry, step, keys,
            avg_ls, win_bsdf, win_light, feedback_on,
            albedo_luts, ld_stream,
        )
        return new_carry, None

    carry, _ = jax.lax.scan(body, carry, jnp.arange(n_steps))
    return _carry_output(cfg, carry)


def trace_wavefront(
    scene: sb.SceneTables,
    bvh,
    dist: LightDistribution,
    cfg: IntegratorConfig,
    gen_ray_fn,  # (u_cam [P,2], sample_idx [P]) -> (o [P,3], d [P,3])
    pixel_ids: Array,  # [P] global pixel ids
    base_key: Array,
    sample_start,  # first sample index (scalar int32)
    n_samples: int,  # samples per lane this dispatch (static)
    avg_ls: Array,
    win_bsdf: Array,
    win_light: Array,
    feedback_on: Array,
    record_fn,  # (SampleOutput, done [P] bool, acc) -> acc
    acc0,  # accumulator pytree threaded through record_fn
    albedo_luts=None,
):
    """Path-regeneration wavefront driver.

    The per-sample scan wastes every lane whose path terminated early:
    with RR from bounce 4 the mean path uses ~half of the
    max_depth+1 steps, so ~half of all intersection + shading work is
    masked-off lanes.  Here a lane that finishes its sample immediately
    starts its next one (per-lane sample counter), keeping lanes ~100%
    occupied until the tail of the last sample; completed samples are
    recorded via `record_fn` the moment they finish.  Per-pixel sample
    order is preserved (each lane walks its own samples sequentially),
    so film sums and streaming moment updates are bit-identical to the
    per-sample driver: masked no-op updates add exact zeros.

    There is no counterpart in the reference -- its CPU threads simply
    run variable-length loops (statpath.cpp:761-958); regeneration is
    the wavefront answer to lockstep divergence.
    """
    P = pixel_ids.shape[0]
    NL = cfg.n_ls
    NB = max(cfg.nb_mis, 1)
    n_steps = cfg.max_depth + 1 + cfg.null_extra
    scr = (crng.pixel_scramble(base_key, pixel_ids)
           if cfg.sampler_mode != crng.MODE_RANDOM else None)

    sample_start = jnp.asarray(sample_start, jnp.int32)

    carry0 = dict(
        o=jnp.zeros((P, 3)), d=jnp.zeros((P, 3)),
        **_zero_path_carry(P, NL, NB),
    )
    # All lanes start "between samples": the first loop iteration
    # regenerates sample 0 for every lane.
    carry0["active"] = jnp.zeros((P,), bool)
    state0 = dict(
        carry=carry0,
        keys=jnp.zeros((P, 2), jnp.uint32),
        live=jnp.zeros((P,), bool),
        s_local=jnp.full((P,), -1, jnp.int32),  # current sample (local)
        sis=jnp.zeros((P,), jnp.int32),  # step-in-sample draw counter
        t=jnp.zeros((), jnp.int32),
        acc=acc0,
    )

    def cond(st):
        more = st["live"] | (st["s_local"] + 1 < n_samples)
        return (st["t"] < n_samples * n_steps) & jnp.any(more)

    def body(st):
        carry = st["carry"]
        # --- regenerate finished lanes ---------------------------------
        regen = ~st["live"] & (st["s_local"] + 1 < n_samples)
        s_new = jnp.where(regen, st["s_local"] + 1, st["s_local"])
        sample_idx = sample_start + jnp.maximum(s_new, 0)
        fresh_keys = crng.pixel_keys(base_key, pixel_ids, sample_idx)
        keys = jnp.where(regen[:, None], fresh_keys, st["keys"])
        ld = (scr, sample_idx) if scr is not None else None
        u_cam = crng.draw_2d(keys, ld, cfg.sampler_mode, 0,
                             crng.SLOT_CAMERA)
        o_new, d_new = gen_ray_fn(u_cam, sample_idx)
        fresh = _zero_path_carry(P, NL, NB)
        fresh["o"], fresh["d"] = o_new, d_new

        def sel(new, old):
            r = regen
            while r.ndim < new.ndim:
                r = r[..., None]
            return jnp.where(r, new, old)

        carry = {k: sel(fresh[k], carry[k]) for k in carry}
        live = st["live"] | regen
        carry["active"] = carry["active"] & live
        sis = jnp.where(regen, 0, st["sis"])

        # --- one lockstep physics step ----------------------------------
        carry = _bounce_step(
            scene, bvh, dist, cfg, carry, sis, keys,
            avg_ls, win_bsdf, win_light, feedback_on,
            albedo_luts, ld,
        )
        sis = sis + 1

        # --- record finished samples ------------------------------------
        done = live & (~carry["active"] | (sis >= n_steps))
        out = _carry_output(cfg, carry)
        # Sanitize: non-done lanes contribute exact zeros so masked
        # moment updates are no-ops even if an in-flight lane holds
        # inf/NaN (0 * inf = NaN would otherwise poison w=0 updates).
        dm = done[:, None]
        out = out._replace(
            ls=jnp.where(done[:, None, None], out.ls, 0.0),
            mis_bsdf=jnp.where(dm, out.mis_bsdf, 0.0),
            mis_light=jnp.where(dm, out.mis_light, 0.0),
            mat_id=jnp.where(done, out.mat_id, 0.0),
            depth=jnp.where(done, out.depth, 0.0),
            normal=jnp.where(dm, out.normal, 0.0),
            albedo=jnp.where(dm, out.albedo, 0.0),
            n_rays=jnp.where(done, out.n_rays, 0.0),
            path_len=jnp.where(done, out.path_len, 0.0),
        )
        acc = record_fn(out, done, st["acc"])
        return dict(
            carry=carry, keys=keys, live=live & ~done,
            s_local=s_new, sis=sis, t=st["t"] + 1, acc=acc,
        )

    state = jax.lax.while_loop(cond, body, state0)
    return state["acc"]
