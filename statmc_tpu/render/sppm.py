"""Stochastic progressive photon mapping (wavefront, dense gather).

Re-derivation of the reference's SPPMIntegrator
(/root/reference/src/integrators/sppm.cpp:1-890):

* camera pass: follow each pixel's ray through specular chains,
  accumulate direct light (Le + NEE) along the way, and store ONE
  visible point (position, beta, material, frame) at the first
  non-specular vertex (sppm.cpp "generate SPPM visible points");
* photon pass: emit photonsPerIteration photons from the lights
  (Sample_Le: position + cosine direction + power weight), trace
  maxdepth bounces, and deposit each non-first vertex's beta into every
  visible point within that pixel's current radius;
* per-pixel statistics update with alpha = 2/3: N' = N + alpha*M,
  R' = R*sqrt(N'/(N+M)), tau' = (tau + beta*Phi)*(R'/R)^2
  (sppm.cpp:"update pixel values from this pass's photons");
* final estimate L = Ld/iterations + tau/(Nphotons_total * pi * R^2).

Wavefront shape difference: the reference hashes visible points into a grid
so each photon touches one cell.  Here the deposit is a DENSE masked
pairwise pass (photon vertices x visible points, blocked) -- on this
hardware a regular [Nv, P] distance test beats a scattered
hash walk for the resolutions the reference paper uses; a hashed-sort
variant is the documented scale-up path for multi-megapixel films.
Photon RNG is counter-addressed like everything else, so photon paths
are independent of sharding/iteration chunking.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as cm
from ..core import rng as crng
from ..core import spectrum as spec
from ..scene import build as sb
from . import bsdf as B
from . import camera as CAM
from .alt_integrators import AltRenderer
from .integrator import _offset_origin, power_heuristic
from .intersect import intersect_scene, occluded_scene
from .lightdistrib import sample_light_id
from . import lights as LT

ALPHA = 2.0 / 3.0  # pbrt "radiussearch" alpha default


def _light_power_pmf(scene):
    """Photon-allocation pmf matching each light kind's Power()
    (src/lights/*.cpp): point 4*pi*I, spot 2*pi*(1 - (cosFalloff +
    cosTotal)/2)*I, area pi*area*L, distant/infinite pi*worldRadius^2*L.
    The estimator stays unbiased for any pmf (beta divides by it), but
    matching Power() matches pbrt's variance allocation."""
    k = scene.light_kind
    lum = spec.luminance(scene.light_L)
    wr2 = scene.world_radius * scene.world_radius
    cos_total = scene.light_params[:, 0]
    cos_falloff = scene.light_params[:, 1]
    power = jnp.where(
        k <= sb.LIGHT_AREA_SPH,
        lum * jnp.maximum(scene.light_area, 1e-9) * jnp.pi,
        jnp.where(
            k == sb.LIGHT_SPOT,
            lum * 2.0 * jnp.pi
            * (1.0 - 0.5 * (cos_falloff + cos_total)),
            jnp.where(
                (k == sb.LIGHT_DISTANT) | (k == sb.LIGHT_INFINITE),
                lum * jnp.pi * wr2,
                lum * 4.0 * jnp.pi,  # point / gonio / proj
            ),
        ),
    )
    total = jnp.maximum(jnp.sum(power), 1e-20)
    return power / total


def sample_le(scene, light_id, u_pos, u_dir):
    """Photon origin/direction/weight for one light per lane
    (each light type's Sample_Le; beta = Le * cos / (pdfPos*pdfDir)).

    Supported: point, spot, area (tri + sphere), distant.  Infinite
    lights are not emitted from (documented gap; their contribution to
    camera paths still arrives via escaped_radiance)."""
    kind = scene.light_kind[light_id]
    Lrad = scene.light_L[light_id]
    pos = scene.light_pos[light_id]
    par = scene.light_params[light_id]
    R = light_id.shape[0]

    # Uniform sphere direction (point lights; pdf 1/4pi).
    z = 1.0 - 2.0 * u_dir[:, 0]
    r_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u_dir[:, 1]
    d_sph = jnp.stack([r_ * jnp.cos(phi), r_ * jnp.sin(phi), z], -1)

    o = pos
    d = d_sph
    beta = Lrad * (4.0 * jnp.pi)  # I / pdfDir

    # Spot: uniform cone around the spot axis (SpotLight::Sample_Le).
    is_spot = kind == sb.LIGHT_SPOT
    cos_total = par[:, 0]
    axis = scene.light_aux[light_id]
    zc = 1.0 - u_dir[:, 0:1] * (1.0 - cos_total[:, None])
    rc = jnp.sqrt(jnp.maximum(0.0, 1.0 - zc * zc))
    frame_s = B.ShadingFrame.from_normal(axis)
    d_cone = frame_s.to_world(jnp.concatenate(
        [rc * jnp.cos(phi)[:, None], rc * jnp.sin(phi)[:, None], zc], -1))
    falloff = LT._spot_falloff(par, cm.dot(d_cone, axis)) \
        if hasattr(LT, "_spot_falloff") else 1.0
    pdf_cone = 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - cos_total, 1e-6))
    beta_spot = Lrad * falloff if isinstance(falloff, jnp.ndarray) else Lrad
    beta_spot = beta_spot / pdf_cone[:, None]
    d = jnp.where(is_spot[:, None], d_cone, d)
    beta = jnp.where(is_spot[:, None], beta_spot, beta)

    # Area tri: uniform point + cosine direction.
    if scene.tri_p0.shape[0] > 0:
        is_tri = kind == sb.LIGHT_AREA_TRI
        t = jnp.maximum(scene.light_prim[light_id], 0)
        p0 = scene.tri_p0[t]
        e1, e2 = scene.tri_e1[t], scene.tri_e2[t]
        su = jnp.sqrt(jnp.maximum(u_pos[:, 0], 1e-12))
        b0 = 1.0 - su
        b1 = u_pos[:, 1] * su
        p_tri = p0 + e1 * b0[:, None] + e2 * b1[:, None]
        n_tri = jnp.cross(e1, e2)
        n_tri = n_tri / jnp.maximum(cm.length(n_tri), 1e-12)[:, None]
        area = scene.light_area[light_id]
        # Cosine-hemisphere direction around n.
        frame_t = B.ShadingFrame.from_normal(n_tri)
        rr = jnp.sqrt(u_dir[:, 0])
        d_cos = frame_t.to_world(jnp.stack(
            [rr * jnp.cos(phi), rr * jnp.sin(phi),
             jnp.sqrt(jnp.maximum(0.0, 1.0 - u_dir[:, 0]))], -1))
        # beta = L * cos / (pdfPos * pdfDir) = L * pi * area
        beta_tri = Lrad * jnp.pi * jnp.maximum(area, 1e-12)[:, None]
        o = jnp.where(is_tri[:, None], p_tri + n_tri * 1e-4, o)
        d = jnp.where(is_tri[:, None], d_cos, d)
        beta = jnp.where(is_tri[:, None], beta_tri, beta)

    # Area sphere: uniform surface point + cosine direction.
    if scene.sph_center.shape[0] > 0:
        is_sph = kind == sb.LIGHT_AREA_SPH
        si = jnp.maximum(scene.light_prim[light_id], 0)
        c = scene.sph_center[si]
        rad = scene.sph_radius[si]
        p_s = c + d_sph * rad[:, None]
        # Emission normal carries the ReverseOrientation sign (a
        # reversed sphere light emits photons inward).
        n_s = d_sph
        if scene.sph_flip is not None:
            n_s = n_s * jnp.take(scene.sph_flip, si, axis=0)[:, None]
        frame_sp = B.ShadingFrame.from_normal(n_s)
        rr = jnp.sqrt(u_pos[:, 0])
        phi2 = 2.0 * jnp.pi * u_pos[:, 1]
        d_cos2 = frame_sp.to_world(jnp.stack(
            [rr * jnp.cos(phi2), rr * jnp.sin(phi2),
             jnp.sqrt(jnp.maximum(0.0, 1.0 - u_pos[:, 0]))], -1))
        area_s = scene.light_area[light_id]
        beta_s = Lrad * jnp.pi * jnp.maximum(area_s, 1e-12)[:, None]
        o = jnp.where(is_sph[:, None], p_s + n_s * 1e-4, o)
        d = jnp.where(is_sph[:, None], d_cos2, d)
        beta = jnp.where(is_sph[:, None], beta_s, beta)

    # Distant: photons start on a worldRadius disk outside the scene and
    # travel -w (DistantLight::Sample_Le; light_pos stores the direction
    # TOWARD the light, lights.py:197).
    is_dist = kind == sb.LIGHT_DISTANT
    wdir = scene.light_pos[light_id]
    wr = scene.world_radius
    frame_d = B.ShadingFrame.from_normal(wdir)
    rd = jnp.sqrt(jnp.maximum(u_pos[:, 0], 0.0)) * wr
    phid = 2.0 * jnp.pi * u_pos[:, 1]
    o_dist = scene.world_center + frame_d.to_world(jnp.stack(
        [rd * jnp.cos(phid), rd * jnp.sin(phid), jnp.zeros_like(rd)], -1)
    ) + wdir * (2.0 * wr)
    beta_dist = Lrad * (jnp.pi * wr * wr)
    o = jnp.where(is_dist[:, None], o_dist, o)
    d = jnp.where(is_dist[:, None], -wdir, d)
    beta = jnp.where(is_dist[:, None], beta_dist, beta)

    ok = (kind != sb.LIGHT_INFINITE) & (kind != sb.LIGHT_GONIO) \
        & (kind != sb.LIGHT_PROJ)
    return o, d, jnp.where(ok[:, None], beta, 0.0)


class SPPMRenderer(AltRenderer):
    """integrator "sppm": each driver iteration = one SPPM pass
    (camera pass + photonsperiteration photons)."""

    def _reset_state(self):
        s = self.s
        P = s.width * s.height
        ip = s.integrator_params if hasattr(s, "integrator_params") else None
        self.n_photons = int(self._desc_param("photonsperiteration",
                                              max(P, 4096)))
        r0 = float(self._desc_param("radius", 1.0))
        self.radius = jnp.full((P,), r0)
        self.n_acc = jnp.zeros((P,))
        self.tau = jnp.zeros((P, 3))
        self.Ld = jnp.zeros((P, 3))
        self.n_iters = 0
        self.total_photons = 0
        self.pmf = None
        self._cam_fn = None
        self._ph_fn = None

    def _desc_param(self, name, default):
        v = self._ip.find_one(name, default) if self._ip else default
        return v

    def __init__(self, desc, base_seed: int = 0, force_dense: bool = False):
        self._ip = desc.integrator_params
        super().__init__(desc, base_seed, force_dense=force_dense)

    # ---- camera pass ------------------------------------------------------
    def _camera_pass(self, it):
        s = self.s
        P = s.width * s.height
        pixel_ids = jnp.arange(P, dtype=jnp.int32)

        def run(base_key):
            keys = crng.pixel_keys(base_key, pixel_ids,
                                   jnp.asarray(it, jnp.int32))
            px = (pixel_ids % s.width).astype(jnp.float32)
            py = (pixel_ids // s.width).astype(jnp.float32)
            u_cam = crng.uniform_2d(keys, 0, crng.SLOT_CAMERA)
            o, d = CAM.generate_rays(s.cam, jnp.stack([px, py], -1) + u_cam)

            beta = jnp.ones((P, 3))
            Ld = jnp.zeros((P, 3))
            active = jnp.ones((P,), bool)
            have_vp = jnp.zeros((P,), bool)
            vp_p = jnp.zeros((P, 3))
            vp_wo = jnp.zeros((P, 3))
            vp_beta = jnp.zeros((P, 3))
            vp_mat = jnp.zeros((P,), jnp.int32)
            vp_uv = jnp.zeros((P, 2))
            vp_ns = jnp.zeros((P, 3))
            specular = jnp.ones((P,), bool)  # bounce 0 collects Le

            carry = dict(o=o, d=d, beta=beta, Ld=Ld, active=active,
                         have=have_vp, vp_p=vp_p, vp_wo=vp_wo,
                         vp_beta=vp_beta, vp_mat=vp_mat, vp_uv=vp_uv,
                         vp_ns=vp_ns, spec=specular)

            def body(carry, b):
                o, d = carry["o"], carry["d"]
                active = carry["active"]
                hit = intersect_scene(
                    s.scene, o, d, t_max=jnp.where(active, cm.INF, 0.0),
                    bvh=s.bvh)
                found = hit.found & active
                le = LT.area_light_le(s.scene, hit.light_id, hit.ng, -d)
                esc = LT.escaped_radiance(s.scene, d)
                lee = jnp.where(found[:, None], le,
                                jnp.where(active[:, None], esc, 0.0))
                Ld = carry["Ld"] + jnp.where(
                    (carry["spec"] & active)[:, None],
                    carry["beta"] * lee, 0.0)

                m = B.gather_materials(s.scene, hit.mat_id, hit.uv, hit.p)
                frame = B.ShadingFrame.from_normal(jnp.where(
                    jnp.any(hit.ns != 0, -1, keepdims=True), hit.ns,
                    jnp.array([0.0, 0.0, 1.0])))
                wo_l = frame.to_local(-d)
                delta = B.is_specular(m)
                diffuse_hit = found & ~delta

                # NEE at every vertex (sppm.cpp camera pass direct light).
                u_sel = crng.uniform_1d(keys, b, crng.SLOT_LIGHT_SELECT)
                light_id, sel_pmf = sample_light_id(s.dist, u_sel, hit.p)
                u_l = crng.uniform_2d(keys, b, crng.SLOT_LIGHT_SAMPLE)
                ls = LT.sample_li(s.scene, light_id, hit.p, hit.ng, u_l)
                wi_l = frame.to_local(ls.wi)
                f_l, _ = B.evaluate(m, wo_l, wi_l)
                f_l = f_l * cm.absdot(ls.wi, hit.ns)[:, None]
                valid = diffuse_hit & (ls.pdf > 0) & jnp.any(f_l > 0, -1)
                occ = occluded_scene(
                    s.scene, _offset_origin(hit.p, hit.ng, ls.wi), ls.wi,
                    jnp.where(valid, jnp.maximum(ls.dist * 0.999, 0.0),
                              0.0), bvh=s.bvh)
                contr = f_l * ls.li / jnp.maximum(
                    ls.pdf * sel_pmf, 1e-20)[:, None]
                Ld = Ld + jnp.where((valid & ~occ)[:, None],
                                    carry["beta"] * contr, 0.0)

                # Store the visible point at the first non-specular hit,
                # or — matching sppm.cpp's `isDiffuse || (isGlossy &&
                # depth == maxDepth - 1)` — at the final depth even for
                # specular BSDFs, so all-specular paths still gather
                # (their f may be zero, but glossy-as-specular ones
                # are not lost).
                last = b == s.icfg.max_depth
                store = (diffuse_hit | (found & last)) & ~carry["have"]
                vp_p = jnp.where(store[:, None], hit.p, carry["vp_p"])
                vp_wo = jnp.where(store[:, None], -d, carry["vp_wo"])
                vp_beta = jnp.where(store[:, None], carry["beta"],
                                    carry["vp_beta"])
                vp_mat = jnp.where(store, hit.mat_id, carry["vp_mat"])
                vp_uv = jnp.where(store[:, None], hit.uv, carry["vp_uv"])
                vp_ns = jnp.where(store[:, None], hit.ns, carry["vp_ns"])
                have = carry["have"] | store

                # Continue ONLY through specular lobes once; the path
                # terminates at the visible point otherwise.
                u_b = crng.uniform_2d(keys, b, crng.SLOT_BSDF)
                uc = crng.uniform_1d(keys, b, crng.SLOT_BSDF_COMPONENT_PC)
                bs = B.sample(m, wo_l, u_b, uc)
                wi_c = frame.to_world(bs.wi)
                bsdf_beta = bs.f * cm.absdot(wi_c, hit.ns)[:, None] \
                    / jnp.maximum(bs.pdf, 1e-20)[:, None]
                cont = found & delta & (bs.pdf > 0) \
                    & jnp.any(bs.f > 0, -1) & ~carry["have"]
                beta = jnp.where(cont[:, None],
                                 carry["beta"] * bsdf_beta, carry["beta"])
                return dict(
                    o=_offset_origin(hit.p, hit.ng, wi_c), d=wi_c,
                    beta=beta, Ld=Ld, active=active & cont,
                    have=have, vp_p=vp_p, vp_wo=vp_wo, vp_beta=vp_beta,
                    vp_mat=vp_mat, vp_uv=vp_uv, vp_ns=vp_ns,
                    spec=cont,
                ), None

            carry, _ = jax.lax.scan(body, carry,
                                    jnp.arange(s.icfg.max_depth + 1))
            return carry

        return jax.jit(run)

    # ---- photon pass --------------------------------------------------------
    def _photon_pass(self):
        s = self.s
        P = s.width * s.height
        Nph = self.n_photons

        def run(base_key, it, vp, radius):
            ids = jnp.arange(Nph, dtype=jnp.int32)
            keys = crng.pixel_keys(
                jax.random.fold_in(base_key, 0x9E37), ids,
                jnp.asarray(it, jnp.int32))
            u_sel = crng.uniform_1d(keys, 0, crng.SLOT_LIGHT_SELECT)
            pmf = _light_power_pmf(s.scene)
            cdf = jnp.cumsum(pmf)
            light_id = jnp.searchsorted(cdf, u_sel).astype(jnp.int32)
            light_id = jnp.clip(light_id, 0, pmf.shape[0] - 1)
            sel = pmf[light_id]
            u_pos = crng.uniform_2d(keys, 0, crng.SLOT_LIGHT_SAMPLE)
            u_dir = crng.uniform_2d(keys, 0, crng.SLOT_BSDF)
            o, d, beta = sample_le(s.scene, light_id, u_pos, u_dir)
            beta = beta / jnp.maximum(sel, 1e-12)[:, None] / Nph
            active = jnp.any(beta > 0, -1)

            vp_p, vp_wo, vp_beta, vp_mat, vp_uv, vp_ns, have = vp
            vp_m = B.gather_materials(s.scene, vp_mat, vp_uv, vp_p)
            vp_frame = B.ShadingFrame.from_normal(jnp.where(
                jnp.any(vp_ns != 0, -1, keepdims=True), vp_ns,
                jnp.array([0.0, 0.0, 1.0])))
            r2 = radius * radius

            vp_frame_b = B.ShadingFrame(
                t=vp_frame.t[:, None, :], b=vp_frame.b[:, None, :],
                n=vp_frame.n[:, None, :])
            vp_m_b = jax.tree.map(lambda x: x[:, None], vp_m)

            def deposit(ph_p, ph_wi, ph_beta, ph_on, phi, m_count):
                """Dense gather: photons [Nph] against all VPs [P]."""
                d2 = jnp.sum(
                    (vp_p[:, None, :] - ph_p[None, :, :]) ** 2, -1)
                near = (d2 <= r2[:, None]) & ph_on[None, :] & have[:, None]
                wi_l = vp_frame_b.to_local(
                    jnp.broadcast_to(-ph_wi[None], (P, Nph, 3)))
                wo_l = vp_frame.to_local(vp_wo)
                f, _ = B.evaluate(vp_m_b, wo_l[:, None, :], wi_l)
                contrib = jnp.where(
                    near[..., None], f * ph_beta[None], 0.0)
                phi = phi + jnp.sum(contrib, axis=1)
                m_count = m_count + jnp.sum(near, axis=1).astype(
                    jnp.float32)
                return phi, m_count

            phi = jnp.zeros((P, 3))
            m_count = jnp.zeros((P,))

            def body(carry, b):
                o, d, beta, active, phi, m_count = carry
                hit = intersect_scene(
                    s.scene, o, d, t_max=jnp.where(active, cm.INF, 0.0),
                    bvh=s.bvh)
                found = hit.found & active
                # Deposit at every vertex EXCEPT the emission vertex
                # itself handles b>=1 (sppm.cpp skips depth 0: direct
                # light is the camera pass's NEE).
                dep_on = found & (b > 0)
                phi, m_count = deposit(hit.p, d, beta, dep_on, phi,
                                       m_count)

                m = B.gather_materials(s.scene, hit.mat_id, hit.uv, hit.p)
                frame = B.ShadingFrame.from_normal(jnp.where(
                    jnp.any(hit.ns != 0, -1, keepdims=True), hit.ns,
                    jnp.array([0.0, 0.0, 1.0])))
                wo_l = frame.to_local(-d)
                u_b = crng.uniform_2d(keys, b + 1, crng.SLOT_BSDF)
                uc = crng.uniform_1d(keys, b + 1,
                                     crng.SLOT_BSDF_COMPONENT_PC)
                bs = B.sample(m, wo_l, u_b, uc)
                wi_c = frame.to_world(bs.wi)
                bnew = beta * bs.f * cm.absdot(wi_c, hit.ns)[:, None] \
                    / jnp.maximum(bs.pdf, 1e-20)[:, None]
                # RR on the photon throughput (sppm.cpp photon RR).
                q = jnp.maximum(
                    0.0, 1.0 - spec.luminance(bnew)
                    / jnp.maximum(spec.luminance(beta), 1e-20))
                u_rr = crng.uniform_1d(keys, b + 1, crng.SLOT_RR)
                live = found & (bs.pdf > 0) & jnp.any(bs.f > 0, -1) \
                    & (u_rr >= q)
                bnew = bnew / jnp.maximum(1.0 - q, 1e-6)[:, None]
                return (
                    _offset_origin(hit.p, hit.ng, wi_c), wi_c,
                    jnp.where(live[:, None], bnew, 0.0), active & live,
                    phi, m_count,
                ), None

            (o, d, beta, active, phi, m_count), _ = jax.lax.scan(
                body, (o, d, beta, active, phi, m_count),
                jnp.arange(s.icfg.max_depth))
            return phi, m_count

        return jax.jit(run)

    def _render_iteration(self, i: int) -> float:
        s = self.s
        if self._cam_fn is None:
            self._cam_fn = self._camera_pass(0)
            self._ph_fn = self._photon_pass()
        base_key = crng.base_key(s.base_seed)
        it = self.n_iters
        cam = self._cam_fn(jax.random.fold_in(base_key, it))
        self.Ld = self.Ld + cam["Ld"]
        vp = (cam["vp_p"], cam["vp_wo"], cam["vp_beta"], cam["vp_mat"],
              cam["vp_uv"], cam["vp_ns"], cam["have"])
        phi, m_count = self._ph_fn(base_key, it, vp, self.radius)
        # pbrt per-pixel update (sppm.cpp:"update pixel values").
        has_m = m_count > 0
        n_new = self.n_acc + ALPHA * m_count
        ratio = jnp.where(has_m, n_new / jnp.maximum(
            self.n_acc + m_count, 1e-12), 1.0)
        r_new = self.radius * jnp.sqrt(ratio)
        tau_new = (self.tau + cam["vp_beta"] * phi) * ratio[:, None]
        self.tau = jnp.where(has_m[:, None], tau_new, self.tau)
        self.radius = jnp.where(has_m, r_new, self.radius)
        self.n_acc = jnp.where(has_m, n_new, self.n_acc)
        self.n_iters += 1
        self.total_photons += self.n_photons
        return float(self.n_photons * s.icfg.max_depth
                     + s.width * s.height * 2)

    @property
    def film_mean(self):
        P = self.s.width * self.s.height
        direct = self.Ld / max(self.n_iters, 1)
        indirect = self.tau / (
            max(self.n_iters, 1) * jnp.pi
            * jnp.maximum(self.radius * self.radius, 1e-12))[:, None]
        return direct + indirect
