"""Bidirectional path tracing (wavefront, all-strategy connections).

Re-derivation of the reference's BDPTIntegrator
(/root/reference/src/integrators/bdpt.cpp):

* camera + light subpath generation as two bounded random walks
  (bdpt.cpp:GenerateCameraSubpath/GenerateLightSubpath:352-476), with
  per-vertex forward/reverse AREA densities (Vertex::ConvertDensity);
* every (s, t) connection strategy with s+t <= maxdepth+2
  (bdpt.cpp:ConnectBDPT:691-780): s=0 (pure camera hit on a light),
  s=1 (light resampling, the NEE analogue), s>=2 x t>=2 (vertex-vertex
  connections), and t=1 (light path hits the camera lens -> film splat);
* the full recursive MIS weight over all alternative strategies
  (bdpt.cpp:MISWeight:477-576), computed from stored pdfFwd/pdfRev
  arrays with the four endpoint-pdf overrides the reference applies via
  ScopedAssignment, here substituted functionally per (s, t).

Wavefront shape: one lane = one pixel sample; subpaths are SoA arrays
[P, V, ...] built by a python-static bounce loop (V = maxdepth+2), and
the (s, t) double loop is unrolled statically -- each strategy is a
batched connection + one batched shadow ray over all lanes.  t=1
splats accumulate through a scatter-add film (pbrt's film splat,
bdpt.cpp:RenderBDPT tile loop).

Infinite lights: escaped camera rays create a light vertex carrying the
environment radiance with solid-angle densities (bdpt.cpp:962-1000,
bdpt.h:330/372/401 -- ConvertDensity passes through, PdfLight uses the
planar world-disc density, PdfLightOrigin the summed direction
density), and the s=1 strategy NEE-samples infinite lights with the
same density expressions, so the (0,t)/(1,t) weights partition.
Remaining documented gap: the LIGHT subpath does not emit from
infinite lights (s>=2 strategies never start at the environment);
those paths are covered by the s=0/s=1 strategies, whose MIS
denominators therefore omit the unimplemented alternatives exactly as
pbrt omits strategies whose pdfs are zero.
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
from . import lights as LT
from .alt_integrators import AltRenderer
from .integrator import _offset_origin
from .intersect import intersect_scene, occluded_scene
from .lightdistrib import sample_light_id
from .sppm import _light_power_pmf

# Vertex type tags.
VT_NONE = 0
VT_CAMERA = 1
VT_LIGHT = 2
VT_SURFACE = 3


def _remap0(x):
    """pbrt bdpt.cpp:remap0 -- treat 0 pdfs as 1 in MIS ratios."""
    return jnp.where(x > 0, x, 1.0)


def _convert_density(pdf_dir, from_p, to_p, to_ng, to_on_surface):
    """Solid-angle pdf at from_p -> area density at to_p
    (bdpt.cpp Vertex::ConvertDensity)."""
    w = to_p - from_p
    d2 = jnp.sum(w * w, axis=-1)
    inv_d2 = jnp.where(d2 > 0, 1.0 / jnp.maximum(d2, 1e-20), 0.0)
    cosw = jnp.abs(jnp.sum(to_ng * w, axis=-1)) * jnp.sqrt(inv_d2)
    return pdf_dir * inv_d2 * jnp.where(to_on_surface, cosw, 1.0)


def _emit_sample(scene, light_id, u_pos, u_dir):
    """Sample_Le over lanes: returns (o, d, Le, ng, pdf_pos, pdf_dir,
    delta_pos) for each light kind (src/lights/*.cpp Sample_Le).

    Supported kinds: point, spot, area (tri + sphere), distant.
    Goniometric/projection emit as point lights (image gain ignored on
    the emission side); infinite lights are not emitted from
    (module-docstring gap)."""
    kind = scene.light_kind[light_id]
    Lrad = scene.light_L[light_id]
    pos = scene.light_pos[light_id]
    par = scene.light_params[light_id]
    aux = scene.light_aux[light_id]
    R = light_id.shape[0]

    # Point (+gonio/proj): uniform sphere, pdfPos delta, pdfDir 1/4pi.
    z = 1.0 - 2.0 * u_dir[:, 0]
    r_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u_dir[:, 1]
    d_sph = jnp.stack([r_ * jnp.cos(phi), r_ * jnp.sin(phi), z], -1)
    o = pos
    d = d_sph
    Le = Lrad
    ng = d_sph
    pdf_pos = jnp.ones((R,))
    pdf_dir = jnp.full((R,), 1.0 / (4.0 * jnp.pi))
    delta_pos = jnp.ones((R,), bool)

    # Spot: uniform cone (spot.cpp:Sample_Le).
    is_spot = kind == sb.LIGHT_SPOT
    cos_total = par[:, 0]
    zc = 1.0 - u_dir[:, 0:1] * (1.0 - cos_total[:, None])
    rc = jnp.sqrt(jnp.maximum(0.0, 1.0 - zc * zc))
    frame_s = B.ShadingFrame.from_normal(aux)
    d_cone = frame_s.to_world(jnp.concatenate(
        [rc * jnp.cos(phi)[:, None], rc * jnp.sin(phi)[:, None], zc], -1))
    pdf_cone = 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - cos_total, 1e-9))
    cos_falloff = par[:, 1]
    cs = cm.dot(d_cone, aux)
    delta_f = jnp.clip((cs - cos_total)
                       / jnp.maximum(cos_falloff - cos_total, 1e-9), 0, 1)
    falloff = jnp.where(cs < cos_total, 0.0,
                        jnp.where(cs > cos_falloff, 1.0,
                                  (delta_f * delta_f) ** 2))
    d = jnp.where(is_spot[:, None], d_cone, d)
    Le = jnp.where(is_spot[:, None], Lrad * falloff[:, None], Le)
    ng = jnp.where(is_spot[:, None], aux, ng)
    pdf_dir = jnp.where(is_spot, pdf_cone, pdf_dir)

    # Area tri: uniform point, cosine direction (diffuse.cpp:Sample_Le).
    if scene.tri_p0.shape[0] > 0:
        is_tri = kind == sb.LIGHT_AREA_TRI
        t = jnp.maximum(scene.light_prim[light_id], 0)
        p0 = scene.tri_p0[t]
        e1, e2 = scene.tri_e1[t], scene.tri_e2[t]
        su = jnp.sqrt(jnp.maximum(u_pos[:, 0], 1e-12))
        b0 = 1.0 - su
        b1 = u_pos[:, 1] * su
        p_tri = p0 + e1 * b0[:, None] + e2 * b1[:, None]
        n_tri = cm.normalize(jnp.cross(e1, e2))
        area = jnp.maximum(scene.light_area[light_id], 1e-12)
        frame_t = B.ShadingFrame.from_normal(n_tri)
        rr = jnp.sqrt(jnp.maximum(u_dir[:, 0], 0.0))
        cz = jnp.sqrt(jnp.maximum(0.0, 1.0 - u_dir[:, 0]))
        d_cos = frame_t.to_world(jnp.stack(
            [rr * jnp.cos(phi), rr * jnp.sin(phi), cz], -1))
        o = jnp.where(is_tri[:, None], p_tri + n_tri * 1e-4, o)
        d = jnp.where(is_tri[:, None], d_cos, d)
        Le = jnp.where(is_tri[:, None], Lrad, Le)
        ng = jnp.where(is_tri[:, None], n_tri, ng)
        pdf_pos = jnp.where(is_tri, 1.0 / area, pdf_pos)
        pdf_dir = jnp.where(is_tri, jnp.maximum(cz, 0.0) / jnp.pi, pdf_dir)
        delta_pos = delta_pos & ~is_tri

    # Area sphere: uniform surface point, cosine direction.
    if scene.sph_center.shape[0] > 0:
        is_sph = kind == sb.LIGHT_AREA_SPH
        si = jnp.maximum(scene.light_prim[light_id], 0)
        c = scene.sph_center[si]
        rad = scene.sph_radius[si]
        p_s = c + d_sph * rad[:, None]
        # Emission normal carries the ReverseOrientation sign.
        n_s = d_sph
        if scene.sph_flip is not None:
            n_s = n_s * jnp.take(scene.sph_flip, si, axis=0)[:, None]
        frame_sp = B.ShadingFrame.from_normal(n_s)
        rr = jnp.sqrt(jnp.maximum(u_pos[:, 0], 0.0))
        phi2 = 2.0 * jnp.pi * u_pos[:, 1]
        cz2 = jnp.sqrt(jnp.maximum(0.0, 1.0 - u_pos[:, 0]))
        d_cos2 = frame_sp.to_world(jnp.stack(
            [rr * jnp.cos(phi2), rr * jnp.sin(phi2), cz2], -1))
        area_s = jnp.maximum(scene.light_area[light_id], 1e-12)
        o = jnp.where(is_sph[:, None], p_s + n_s * 1e-4, o)
        d = jnp.where(is_sph[:, None], d_cos2, d)
        Le = jnp.where(is_sph[:, None], Lrad, Le)
        ng = jnp.where(is_sph[:, None], n_s, ng)
        pdf_pos = jnp.where(is_sph, 1.0 / area_s, pdf_pos)
        pdf_dir = jnp.where(is_sph, jnp.maximum(cz2, 0.0) / jnp.pi,
                            pdf_dir)
        delta_pos = delta_pos & ~is_sph

    # Distant: disk outside the scene, parallel rays
    # (distant.cpp:Sample_Le: pdfPos = 1/(pi R^2), pdfDir delta).
    is_dist = kind == sb.LIGHT_DISTANT
    wdir = pos  # direction TOWARD the light
    wr = scene.world_radius
    frame_d = B.ShadingFrame.from_normal(wdir)
    rd = jnp.sqrt(jnp.maximum(u_pos[:, 0], 0.0)) * wr
    phid = 2.0 * jnp.pi * u_pos[:, 1]
    o_dist = scene.world_center + frame_d.to_world(jnp.stack(
        [rd * jnp.cos(phid), rd * jnp.sin(phid), jnp.zeros_like(rd)], -1)
    ) + wdir * (2.0 * wr)
    o = jnp.where(is_dist[:, None], o_dist, o)
    d = jnp.where(is_dist[:, None], -wdir, d)
    Le = jnp.where(is_dist[:, None], Lrad, Le)
    ng = jnp.where(is_dist[:, None], -wdir, ng)
    pdf_pos = jnp.where(is_dist, 1.0 / (jnp.pi * wr * wr), pdf_pos)
    pdf_dir = jnp.where(is_dist, 1.0, pdf_dir)

    ok = (kind != sb.LIGHT_INFINITE)
    Le = jnp.where(ok[:, None], Le, 0.0)
    return o, d, Le, ng, pdf_pos, pdf_dir, delta_pos


def _pdf_le_dir(scene, light_id, ng_light, w):
    """pdfDir of a light emitting direction w from a point with normal
    ng_light (Light::Pdf_Le direction part)."""
    kind = scene.light_kind[light_id]
    cosw = cm.dot(ng_light, w)
    pdf = jnp.full(light_id.shape, 1.0 / (4.0 * jnp.pi))  # point-like
    cos_total = scene.light_params[light_id][..., 0]
    pdf = jnp.where(
        kind == sb.LIGHT_SPOT,
        1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - cos_total, 1e-9)), pdf)
    pdf = jnp.where(
        (kind == sb.LIGHT_AREA_TRI) | (kind == sb.LIGHT_AREA_SPH),
        jnp.maximum(cosw, 0.0) / jnp.pi, pdf)
    pdf = jnp.where(kind == sb.LIGHT_DISTANT, 0.0, pdf)
    return pdf


def _scene_has_infinite(scene) -> bool:
    import numpy as _np

    return bool(_np.any(_np.asarray(scene.light_kind)
                        == sb.LIGHT_INFINITE))


def _infinite_light_density(scene, pmf_all, w):
    """InfiniteLightDensity (bdpt.h:114-126): sum over infinite lights
    of Pdf_Li(w) * pmf(light) -- the solid-angle density with which the
    strategy family samples direction w toward the environment."""
    import numpy as _np

    kinds = _np.asarray(scene.light_kind)
    R = w.shape[0]
    zero3 = jnp.zeros((R, 3))
    total = jnp.zeros((R,))
    for li in _np.nonzero(kinds == sb.LIGHT_INFINITE)[0]:
        lid = jnp.full((R,), int(li), jnp.int32)
        p = LT.pdf_li(scene, lid, zero3, w, zero3, zero3,
                      jnp.zeros((R,), bool))
        total = total + pmf_all[int(li)] * p
    return total


def _pdf_light_origin(scene, pmf_all, light_id):
    """pmf(light) * pdfPos (Vertex::PdfLightOrigin, area part)."""
    pmf = pmf_all[light_id]
    kind = scene.light_kind[light_id]
    area = jnp.maximum(scene.light_area[light_id], 1e-12)
    wr = scene.world_radius
    pdf_pos = jnp.where(
        (kind == sb.LIGHT_AREA_TRI) | (kind == sb.LIGHT_AREA_SPH),
        1.0 / area,
        jnp.where(kind == sb.LIGHT_DISTANT,
                  1.0 / (jnp.pi * wr * wr), 1.0))
    return pmf * pdf_pos



class _Draws:
    """Pluggable draw source for the BDPT walks/connections.

    Threefry mode (keys != None): draws address (bounce, slot) exactly
    as before.  PSS mode (U != None): each STATIC call site gets a
    fixed dim range of the primary-sample vector U [C, D], assigned in
    deterministic trace order -- the property Kelemen-MLT needs
    (render/pssmlt.py mutates U and re-evaluates the same function).
    """

    def __init__(self, keys=None, U=None, skip: int = 0):
        self.keys = keys
        self.U = U
        self._dims = {}
        self._next = skip

    def _dim(self, b, slot, n):
        key = (int(b), int(slot))
        if key not in self._dims:
            self._dims[key] = self._next
            self._next += n
        return self._dims[key]

    def d1(self, b, slot):
        if self.U is None:
            return crng.uniform_1d(self.keys, b, slot)
        i = self._dim(b, slot, 1)
        assert i + 1 <= self.U.shape[1], "MLT U vector too short"
        return self.U[:, i]

    def d2(self, b, slot):
        if self.U is None:
            return crng.uniform_2d(self.keys, b, slot)
        i = self._dim(b, slot, 2)
        assert i + 2 <= self.U.shape[1], "MLT U vector too short"
        return self.U[:, i:i + 2]


class _Path:
    """SoA subpath: arrays [P, V, ...]; V slots, slot 0 the endpoint."""

    def __init__(self, P, V):
        self.P, self.V = P, V
        z = lambda *s: jnp.zeros((P, V) + s)
        self.p = z(3)
        self.ng = z(3)
        self.ns = z(3)
        self.beta = z(3)
        self.pdf_fwd = z()
        self.pdf_rev = z()
        self.mat_id = jnp.zeros((P, V), jnp.int32)
        self.uv = z(2)
        self.wo = z(3)  # world, toward the previous vertex
        self.vtype = jnp.zeros((P, V), jnp.int32)
        self.delta = jnp.zeros((P, V), bool)
        # Slot-0-only: light POSITION is a Dirac delta (point/spot/
        # distant -- pbrt's IsDeltaLight()).  Distinct from `delta`,
        # which marks SPECULAR scattering vertices: a delta light is
        # still a perfectly valid NEE target, so only the s=0 strategy
        # (bdpt.cpp:536 deltaLightvertex at i==0) is excluded by it.
        # Conflating the two excluded real strategies from the MIS
        # denominator (round-3 analytic 1.60-vs-1.00 overcount).
        self.light_delta = jnp.zeros((P, V), bool)
        # Escaped-ray light vertex (bdpt.cpp:962-1000): the camera walk
        # ends in a VT_LIGHT vertex carrying the infinite lights' Le;
        # its densities stay in SOLID-ANGLE measure (ConvertDensity
        # passes through for infinite vertices, bdpt.h:330).
        self.infinite = jnp.zeros((P, V), bool)
        self.light_id = jnp.full((P, V), -1, jnp.int32)

    def set(self, i, **kw):
        for k, v in kw.items():
            arr = getattr(self, k)
            setattr(self, k, arr.at[:, i].set(v))

    def exists(self, i):
        return self.vtype[:, i] != VT_NONE

    def on_surface(self, i):
        """Vertex::IsOnSurface (bdpt.h): surface hits AND area-light
        vertices carry a geometric normal; camera/delta-light/infinite
        endpoints do not, so densities converted TO them keep the
        1/d^2 form."""
        return (self.vtype[:, i] == VT_SURFACE) | (
            (self.vtype[:, i] == VT_LIGHT) & ~self.light_delta[:, i]
            & ~self.infinite[:, i])

    def n_valid(self):
        return jnp.sum((self.vtype != VT_NONE).astype(jnp.int32), axis=1)


def _bsdf_pdf(scene, mat_id, uv, p, ns, wo_w, wi_w):
    """BSDF pdf of sampling wi_w given wo_w at a surface vertex."""
    m = B.gather_materials(scene, mat_id, uv, p)
    frame = B.ShadingFrame.from_normal(jnp.where(
        jnp.any(ns != 0, -1, keepdims=True), ns,
        jnp.array([0.0, 0.0, 1.0])))
    _, pdf = B.evaluate(m, frame.to_local(wo_w), frame.to_local(wi_w))
    return pdf


def _bsdf_f(scene, mat_id, uv, p, ns, wo_w, wi_w):
    m = B.gather_materials(scene, mat_id, uv, p)
    frame = B.ShadingFrame.from_normal(jnp.where(
        jnp.any(ns != 0, -1, keepdims=True), ns,
        jnp.array([0.0, 0.0, 1.0])))
    f, pdf = B.evaluate(m, frame.to_local(wo_w), frame.to_local(wi_w))
    return f, pdf


class BDPTRenderer(AltRenderer):
    """integrator "bdpt" (bdpt.cpp): every driver iteration adds
    `pixelsamples` full bidirectional samples per pixel."""

    def _reset_state(self):
        s = self.s
        P = s.width * s.height
        self.film_sum = jnp.zeros((P, 3))
        self.splat_sum = jnp.zeros((P, 3))
        self.n_samples = 0
        self._iter_fn = None
        # Strategy depth: s + t <= max_depth + 2 (pbrt maxDepth edges).
        self.max_depth = int(s.ecfg.max_depth)
        # Debug hook: restrict to a set of (s, t) strategies (None = all).
        self.strategy_filter = None
        # Debug hook: disable MIS weighting (weights -> 1; biased).
        self.debug_no_mis = False
        # MLT contribution mode: drop the t=1 (light->lens splat)
        # strategies AND their MIS denominator terms, so the remaining
        # t>=2 strategy sum still partitions (render/pssmlt.py needs a
        # single-pixel contribution function).
        self.exclude_t1 = False

    @property
    def film_mean(self):
        n = max(self.n_samples, 1)
        return (self.film_sum + self.splat_sum) / n

    # ------------------------------------------------------------------
    def _camera_walk(self, keys, o0, d0, V):
        """Camera subpath: vertex 0 = the camera, then up to V-1 surface
        vertices (GenerateCameraSubpath, bdpt.cpp:352-395)."""
        s = self.s
        scene, bvh = s.scene, s.bvh
        P = o0.shape[0]
        path = _Path(P, V)
        # Camera vertex: beta 1; pdfs handled via Pdf_We at connection.
        path.set(0, p=o0, ng=d0, ns=d0, beta=jnp.ones((P, 3)),
                 vtype=jnp.full((P,), VT_CAMERA, jnp.int32))
        _, pdf_dir0 = self._pdf_we(o0, d0)
        self._walk(path, keys, o0, d0, jnp.ones((P, 3)), pdf_dir0,
                   start=1, mode_importance=False)
        return path

    def _light_walk(self, keys, V, n_lanes=None):
        """Light subpath (GenerateLightSubpath, bdpt.cpp:397-476).

        n_lanes overrides the one-lane-per-pixel default (the MLT
        contribution function runs one lane per Markov chain)."""
        s = self.s
        scene = s.scene
        P = n_lanes if n_lanes is not None else s.width * s.height
        u_sel = keys.d1(0, crng.SLOT_LIGHT_SELECT + 16)
        pmf_all = _light_power_pmf(scene)
        cdf = jnp.cumsum(pmf_all)
        light_id = jnp.clip(jnp.searchsorted(cdf, u_sel), 0,
                            pmf_all.shape[0] - 1).astype(jnp.int32)
        pmf = pmf_all[light_id]
        u_pos = keys.d2(0, crng.SLOT_LIGHT_SAMPLE + 16)
        u_dir = keys.d2(0, crng.SLOT_BSDF + 16)
        o, d, Le, ng, pdf_pos, pdf_dir, delta_pos = _emit_sample(
            scene, light_id, u_pos, u_dir)
        path = _Path(P, self.max_depth + 1)
        ok = jnp.any(Le > 0, -1) & (pdf_pos > 0) & (pdf_dir > 0) & (pmf > 0)
        path.set(0, p=o, ng=ng, ns=ng, beta=Le,
                 pdf_fwd=pmf * pdf_pos,
                 vtype=jnp.where(ok, VT_LIGHT, VT_NONE),
                 light_id=light_id,
                 light_delta=delta_pos)
        cos0 = jnp.abs(cm.dot(ng, d))
        beta = Le * cos0[:, None] / jnp.maximum(
            pmf * pdf_pos * pdf_dir, 1e-20)[:, None]
        beta = jnp.where(ok[:, None], beta, 0.0)
        self._walk(path, keys, o, d, beta, pdf_dir, start=1,
                   mode_importance=True)
        self._light_pmf_all = pmf_all
        return path

    def _walk(self, path, keys, o, d, beta, pdf_dir, start, mode_importance):
        """Shared RandomWalk (bdpt.cpp:294-350): record vertices with
        forward/reverse area densities.  Static python loop (V small)."""
        s = self.s
        scene, bvh = s.scene, s.bvh
        P = path.P
        active = jnp.any(beta > 0, -1)
        slot_base = 32 if mode_importance else 0
        has_inf = (not mode_importance) and _scene_has_infinite(scene)
        for i in range(start, path.V):
            hit = intersect_scene(
                scene, o, d, t_max=jnp.where(active, cm.INF, 0.0), bvh=bvh)
            found = hit.found & active
            # Forward area density at the new vertex.
            prev_p = path.p[:, i - 1]
            pdf_fwd = _convert_density(pdf_dir, prev_p, hit.p, hit.ng,
                                       jnp.ones((P,), bool))
            if has_inf:
                # Escaped camera ray -> infinite-light vertex
                # (bdpt.cpp:962-1000): beta unchanged, direction kept in
                # wo, pdf_fwd stays SOLID-ANGLE (bdpt.h:330).
                escaped = active & ~hit.found
            else:
                escaped = jnp.zeros((P,), bool)
            far_p = o + d * (2.0 * scene.world_radius)
            m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p)
            frame = B.ShadingFrame.from_normal(jnp.where(
                jnp.any(hit.ns != 0, -1, keepdims=True), hit.ns,
                jnp.array([0.0, 0.0, 1.0])))
            wo_l = frame.to_local(-d)
            delta = B.is_specular(m)
            keep = found | escaped
            path.set(
                i,
                p=jnp.where(found[:, None], hit.p,
                            jnp.where(escaped[:, None], far_p, 0.0)),
                ng=jnp.where(found[:, None], hit.ng, 0.0),
                ns=jnp.where(found[:, None], hit.ns, 0.0),
                beta=jnp.where(keep[:, None], beta, 0.0),
                pdf_fwd=jnp.where(found, pdf_fwd,
                                  jnp.where(escaped, pdf_dir, 0.0)),
                mat_id=jnp.where(found, hit.mat_id, 0),
                uv=jnp.where(found[:, None], hit.uv, 0.0),
                wo=jnp.where(keep[:, None], -d, 0.0),
                vtype=jnp.where(found, VT_SURFACE,
                                jnp.where(escaped, VT_LIGHT, VT_NONE)),
                delta=found & delta,
                infinite=escaped,
                light_id=jnp.where(found, hit.light_id, -1),
            )
            if i + 1 >= path.V:
                # Still need prev.pdf_rev from this vertex's BSDF: pbrt
                # computes it when sampling the continuation; the last
                # vertex never continues, so stop here.
                break
            u_b = keys.d2(i + slot_base, crng.SLOT_BSDF)
            uc = keys.d1(i + slot_base, crng.SLOT_BSDF_COMPONENT_PC)
            bs = B.sample(m, wo_l, u_b, uc)
            wi_w = frame.to_world(bs.wi)
            cosw = jnp.abs(cm.dot(wi_w, hit.ns))
            new_beta = beta * bs.f * cosw[:, None] / jnp.maximum(
                bs.pdf, 1e-20)[:, None]
            # pbrt shading-normal correction for importance transport
            # (bdpt.cpp CorrectShadingNormal).
            if mode_importance:
                num = (jnp.abs(cm.dot(-d, hit.ns))
                       * jnp.abs(cm.dot(wi_w, hit.ng)))
                den = (jnp.abs(cm.dot(-d, hit.ng))
                       * jnp.abs(cm.dot(wi_w, hit.ns)))
                corr = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9),
                                 0.0)
                new_beta = new_beta * corr[:, None]
            # Reverse pdf at the PREVIOUS vertex.
            _, pdf_rev_dir = B.evaluate(m, frame.to_local(wi_w), wo_l)
            pdf_rev_dir = jnp.where(bs.specular, 0.0, pdf_rev_dir)
            prev_rev = _convert_density(
                pdf_rev_dir, hit.p, prev_p, path.ng[:, i - 1],
                path.on_surface(i - 1))
            path.pdf_rev = path.pdf_rev.at[:, i - 1].set(
                jnp.where(found, prev_rev, path.pdf_rev[:, i - 1]))
            live = found & (bs.pdf > 0) & jnp.any(bs.f > 0, -1)
            pdf_dir = jnp.where(bs.specular, 0.0, bs.pdf)
            o = _offset_origin(hit.p, hit.ng, wi_w)
            d = wi_w
            beta = jnp.where(live[:, None], new_beta, 0.0)
            active = live

    # ------------------------------------------------------------------
    def _pdf_we(self, p_from, w):
        """(pdf_pos, pdf_dir) of the pinhole camera emitting ray (p, w)
        (cameras/perspective.cpp:Pdf_We)."""
        cam = self.s.cam
        c2w = np.asarray(cam.camera_to_world)
        w2c = jnp.asarray(np.linalg.inv(c2w.astype(np.float64))
                          .astype(np.float32))
        d_cam = cm.transform_vector(w2c, w)
        cos_t = d_cam[..., 2]
        pdf_dir = jnp.where(
            cos_t > 1e-6,
            1.0 / jnp.maximum(self._film_area()
                              * jnp.maximum(cos_t, 1e-6) ** 3, 1e-12),
            0.0)
        return jnp.ones_like(pdf_dir), pdf_dir

    def _film_area(self):
        """Area of the screen window on the z=1 camera plane."""
        cam = self.s.cam
        r2c = np.asarray(cam.raster_to_camera).astype(np.float64)
        W, H = self.s.width, self.s.height
        pmin = r2c @ np.array([0.0, 0.0, 0.0, 1.0])
        pmax = r2c @ np.array([float(W), float(H), 0.0, 1.0])
        pmin = pmin[:3] / pmin[3]
        pmax = pmax[:3] / pmax[3]
        pmin = pmin / pmin[2]  # project to the z=1 camera plane
        pmax = pmax / pmax[2]
        return float(abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1])))

    def _sample_wi_camera(self, p_ref):
        """PerspectiveCamera::Sample_Wi for a pinhole lens: direction to
        the camera, importance We, and the raster position it lands on.
        Returns (wi, dist, We [P,3], raster_idx [P] int32, valid)."""
        cam = self.s.cam
        W, H = self.s.width, self.s.height
        c2w = np.asarray(cam.camera_to_world).astype(np.float64)
        cam_p = jnp.asarray(
            (c2w @ np.array([0.0, 0.0, 0.0, 1.0]))[:3].astype(np.float32))
        w2c = jnp.asarray(np.linalg.inv(c2w).astype(np.float32))
        c2r = jnp.asarray(np.linalg.inv(
            np.asarray(cam.raster_to_camera).astype(np.float64))
            .astype(np.float32))
        to_cam = cam_p[None] - p_ref
        dist = cm.length(to_cam)
        wi = to_cam / jnp.maximum(dist, 1e-12)[:, None]
        # Direction camera -> p_ref in camera space; project to raster.
        d_cam = cm.transform_vector(w2c, -wi)
        cos_t = d_cam[..., 2]
        safe = cos_t > 1e-6
        p_plane = d_cam / jnp.maximum(cos_t, 1e-6)[:, None]
        p_ras = cm.transform_point(c2r, p_plane)
        xr = p_ras[..., 0]
        yr = p_ras[..., 1]
        inside = safe & (xr >= 0) & (xr < W) & (yr >= 0) & (yr < H)
        idx = (jnp.clip(yr.astype(jnp.int32), 0, H - 1) * W
               + jnp.clip(xr.astype(jnp.int32), 0, W - 1))
        A = self._film_area()
        we = jnp.where(
            inside, 1.0 / (A * jnp.maximum(cos_t, 1e-6) ** 4), 0.0)
        return wi, dist, we[:, None] * jnp.ones((1, 3)), idx, inside, cos_t

    # ------------------------------------------------------------------
    def _mis_weight(self, qs, pt, s_n, t_n, overrides,
                    env_no_lightwalk=None):
        """bdpt.cpp:MISWeight:477-576 with functional endpoint overrides.

        overrides: dict mapping ('q'|'p', index) -> pdf_rev value.
        env_no_lightwalk: [P] bool -- lanes whose path ends at an
        infinite light.  Our light walk does not emit from infinite
        lights (module docstring), so the s'>=2 alternatives do not
        exist for those paths and their denominator terms are dropped
        (pbrt includes them because its GenerateLightSubpath samples
        env emission; keeping them here would under-weight env paths)."""
        if s_n + t_n == 2:
            return jnp.ones((pt.P,))
        sum_ri = jnp.zeros((pt.P,))

        def rev(path, tag, i):
            v = path.pdf_rev[:, i]
            if (tag, i) in overrides:
                return overrides[(tag, i)]
            return v

        def dlt(path, tag, i):
            # Connection endpoints act as connectible (non-delta).
            if tag == "p" and i == t_n - 1:
                return jnp.zeros((path.P,), bool)
            if tag == "q" and i == s_n - 1:
                return jnp.zeros((path.P,), bool)
            return path.delta[:, i]

        ri = jnp.ones((pt.P,))
        for i in range(t_n - 1, 0, -1):
            ri = ri * _remap0(rev(pt, "p", i)) / _remap0(pt.pdf_fwd[:, i])
            if i == 1 and self.exclude_t1:
                # MLT mode never samples the t=1 strategies; drop their
                # terms so the reduced strategy set partitions.
                continue
            use = ~dlt(pt, "p", i) & ~dlt(pt, "p", i - 1)
            if env_no_lightwalk is not None and s_n + t_n - i >= 2:
                # This term is the (s' = s+t-i, t' = i) alternative,
                # which starts the light walk at the environment.
                use = use & ~env_no_lightwalk
            sum_ri = sum_ri + jnp.where(use, ri, 0.0)
        ri = jnp.ones((pt.P,))
        for i in range(s_n - 1, -1, -1):
            ri = ri * _remap0(rev(qs, "q", i)) / _remap0(qs.pdf_fwd[:, i])
            if i > 0:
                # bdpt.cpp:536: deltaLightvertex at i>0 is the SPECULAR
                # delta of the previous vertex; the light vertex's
                # `delta` field is always false in pbrt, so a delta
                # light POSITION never suppresses these terms.
                use = ~dlt(qs, "q", i) & ~dlt(qs, "q", i - 1)
            else:
                # i==0 is the s=0 alternative: impossible iff the light
                # position cannot be hit (IsDeltaLight: point/spot/
                # distant) -- bdpt.cpp:537 lightVertices[0].IsDeltaLight.
                use = ~dlt(qs, "q", 0) & ~qs.light_delta[:, 0]
            sum_ri = sum_ri + jnp.where(use, ri, 0.0)
        return 1.0 / (1.0 + sum_ri)

    # ------------------------------------------------------------------
    def _build_iteration(self):
        s = self.s
        scene, bvh = s.scene, s.bvh
        P = s.width * s.height
        W = s.width
        D = self.max_depth
        Vc = D + 2  # camera subpath slots (camera + D+1 surface)
        pixel_ids = jnp.arange(P, dtype=jnp.int32)
        pmf_uniform = None

        def one_sample(base_key, it):
            raw = crng.pixel_keys(base_key, pixel_ids,
                                  jnp.asarray(it, jnp.int32))
            keys = _Draws(keys=raw)
            px = (pixel_ids % W).astype(jnp.float32)
            py = (pixel_ids // W).astype(jnp.float32)
            u_cam = keys.d2(0, crng.SLOT_CAMERA)
            o0, d0 = CAM.generate_rays(
                self.s.cam, jnp.stack([px, py], -1) + u_cam)
            pt = self._camera_walk(keys, o0, d0, Vc)
            qs = self._light_walk(keys, D + 1)
            pmf_all = self._light_pmf_all

            film = jnp.zeros((P, 3))
            splat = jnp.zeros((P, 3))

            surf = VT_SURFACE

            def vis(pa, pb, ng_a, valid):
                wdir = pb - pa
                dist = cm.length(wdir)
                wn = wdir / jnp.maximum(dist, 1e-12)[:, None]
                occ = occluded_scene(
                    scene, _offset_origin(pa, ng_a, wn), wn,
                    jnp.where(valid, jnp.maximum(dist * 0.999, 0.0), 0.0),
                    bvh=bvh)
                return ~occ

            # ---- strategies ------------------------------------------
            flt = self.strategy_filter
            for t_n in range(2, Vc + 1):
                for s_n in range(0, D + 2):
                    if s_n + t_n > D + 2:
                        continue
                    if flt is not None and (s_n, t_n) not in flt:
                        continue
                    c, w = self._connect(qs, pt, s_n, t_n, keys, pmf_all,
                                         vis)
                    if c is None:
                        continue
                    if self.debug_no_mis:
                        w = jnp.ones_like(w) * (w > 0)
                    film = film + c * w[:, None]
            # t = 1: light subpath -> camera splats.
            for s_n in range(2, D + 2):
                if flt is not None and (s_n, 1) not in flt:
                    continue
                contrib, idx, w = self._connect_t1(qs, s_n, pmf_all, vis)
                if contrib is None:
                    continue
                if self.debug_no_mis:
                    w = jnp.ones_like(w) * (w > 0)
                splat = splat + jnp.zeros((P, 3)).at[idx].add(
                    contrib * w[:, None])
            return film, splat

        def run(base_key, it, n):
            def body(i, acc):
                f, sp = acc
                f2, sp2 = one_sample(base_key, it * n + i)
                return (f + f2, sp + sp2)

            return jax.lax.fori_loop(
                0, n, body, (jnp.zeros((P, 3)), jnp.zeros((P, 3))))

        return run

    # ------------------------------------------------------------------
    def _connect(self, qs, pt, s_n, t_n, keys, pmf_all, vis):
        """One (s, t>=2) strategy over all lanes (bdpt.cpp:ConnectBDPT).
        Returns (contribution [P,3], mis_weight [P]) or (None, None)."""
        scene = self.s.scene
        P = pt.P
        ti = t_n - 1
        pt_ok = pt.exists(ti) & (pt.vtype[:, ti] == VT_SURFACE)

        if s_n == 0:
            # Camera path alone: pt[t-1] must be emissive -- an area
            # light hit, or the escaped-ray infinite-light vertex.
            lid = pt.light_id[:, ti]
            le = LT.area_light_le(scene, lid, pt.ng[:, ti], pt.wo[:, ti])
            is_inf = pt.infinite[:, ti]
            has_inf = _scene_has_infinite(scene)
            if has_inf:
                env_dir = -pt.wo[:, ti]
                le = jnp.where(is_inf[:, None],
                               LT.escaped_radiance(scene, env_dir), le)
            L = pt.beta[:, ti] * le
            emissive = ((pt.vtype[:, ti] == VT_SURFACE) & (lid >= 0)) \
                | is_inf
            valid = pt.exists(ti) & emissive & jnp.any(le > 0, -1)
            if t_n - 2 >= 0:
                prev_ok = pt.exists(t_n - 2)
                valid = valid & prev_ok
            # Overrides: pt[t-1].pdf_rev = PdfLightOrigin;
            # pt[t-2].pdf_rev = PdfLight (dir density at pt[t-2]).
            ov = {}
            lid_s = jnp.maximum(lid, 0)
            origin = _pdf_light_origin(scene, pmf_all, lid_s)
            if has_inf:
                # bdpt.h:401-404: infinite vertices use the summed
                # solid-angle density of sampling this direction.
                origin = jnp.where(
                    is_inf,
                    _infinite_light_density(scene, pmf_all, env_dir),
                    origin)
            ov[("p", ti)] = origin
            if ti - 1 >= 0:
                wdir = pt.p[:, ti - 1] - pt.p[:, ti]
                dist = jnp.maximum(cm.length(wdir), 1e-12)
                wn = wdir / dist[:, None]
                pdir = _pdf_le_dir(scene, lid_s, pt.ng[:, ti], wn)
                prev_rev = _convert_density(
                    pdir, pt.p[:, ti], pt.p[:, ti - 1], pt.ng[:, ti - 1],
                    pt.vtype[:, ti - 1] == VT_SURFACE)
                if has_inf:
                    # Vertex::PdfLight for infinite lights (bdpt.h:372):
                    # planar world-disc density, cos-projected onto the
                    # receiver, NO 1/d^2.
                    wr = scene.world_radius
                    plan = 1.0 / (jnp.pi * wr * wr)
                    cos_prev = jnp.abs(cm.dot(pt.ng[:, ti - 1],
                                              pt.wo[:, ti]))
                    prev_rev = jnp.where(
                        is_inf,
                        plan * jnp.where(pt.on_surface(ti - 1),
                                         cos_prev, 1.0),
                        prev_rev)
                ov[("p", ti - 1)] = prev_rev
            L = jnp.where(valid[:, None], L, 0.0)
            w = self._mis_weight(qs, pt, s_n, t_n, ov,
                                 env_no_lightwalk=(is_inf if has_inf
                                                   else None))
            return L, jnp.where(valid, w, 0.0)

        if s_n == 1:
            # Resample a light from pt[t-1] (the NEE-analogue strategy).
            u_sel = keys.d1(t_n, crng.SLOT_LIGHT_SELECT + 8)
            light_id, sel_pmf = sample_light_id(
                self.s.dist, u_sel, pt.p[:, ti])
            u_l = keys.d2(t_n, crng.SLOT_LIGHT_SAMPLE + 8)
            ls = LT.sample_li(scene, light_id, pt.p[:, ti], pt.ng[:, ti],
                              u_l)
            f, _ = _bsdf_f(scene, pt.mat_id[:, ti], pt.uv[:, ti],
                           pt.p[:, ti], pt.ns[:, ti], pt.wo[:, ti], ls.wi)
            f = f * jnp.abs(cm.dot(ls.wi, pt.ns[:, ti]))[:, None]
            valid = pt_ok & ~pt.delta[:, ti] & (ls.pdf > 0) \
                & jnp.any(ls.li > 0, -1) & jnp.any(f > 0, -1)
            unocc = vis(pt.p[:, ti], ls.p_light, pt.ng[:, ti], valid)
            valid = valid & unocc
            beta_light = ls.li / jnp.maximum(
                ls.pdf * sel_pmf, 1e-20)[:, None]
            L = pt.beta[:, ti] * f * beta_light
            # Sampled light vertex for MIS: pdf_fwd = PdfLightOrigin.
            wdir = ls.p_light - pt.p[:, ti]
            dist = jnp.maximum(cm.length(wdir), 1e-12)
            wn = wdir / dist[:, None]
            # light normal at the sampled point: approximate by the
            # direction-facing geometric normal encoded in sample_li's
            # sidedness (li already carries it); use -wn for delta kinds.
            qs1 = _Path(P, 1)
            lid_s = jnp.maximum(light_id, 0)
            kind = scene.light_kind[lid_s]
            is_area = (kind == sb.LIGHT_AREA_TRI) | (kind == sb.LIGHT_AREA_SPH)
            is_inf_l = kind == sb.LIGHT_INFINITE
            has_inf = _scene_has_infinite(scene)
            ng_l = jnp.where(is_area[:, None],
                             self._area_light_normal(scene, lid_s, ls),
                             -wn)
            pdf_fwd0 = _pdf_light_origin(scene, pmf_all, lid_s) \
                * sel_pmf / jnp.maximum(pmf_all[lid_s], 1e-20)
            if has_inf:
                # PdfLightOrigin for an infinite light = the summed
                # solid-angle direction density (bdpt.h:401-404), kept
                # un-converted like every infinite-vertex density.
                pdf_fwd0 = jnp.where(
                    is_inf_l,
                    _infinite_light_density(scene, pmf_all, wn),
                    pdf_fwd0)
            qs1.set(0, p=ls.p_light, ng=ng_l, ns=ng_l, beta=beta_light,
                    pdf_fwd=pdf_fwd0,
                    vtype=jnp.where(valid, VT_LIGHT, VT_NONE),
                    light_id=light_id,
                    light_delta=ls.is_delta,
                    infinite=is_inf_l)
            ov = {}
            # qs[0].pdf_rev = pt[t-1].Pdf(pt[t-2] -> qs[0]).
            pdf_q0 = _bsdf_pdf(scene, pt.mat_id[:, ti], pt.uv[:, ti],
                               pt.p[:, ti], pt.ns[:, ti], pt.wo[:, ti],
                               wn)
            q0_rev = _convert_density(
                pdf_q0, pt.p[:, ti], ls.p_light, ng_l, is_area)
            if has_inf:
                # ConvertDensity passes through for infinite vertices
                # (bdpt.h:330): keep the raw solid-angle BSDF pdf.
                q0_rev = jnp.where(is_inf_l, pdf_q0, q0_rev)
            ov[("q", 0)] = q0_rev
            # pt[t-1].pdf_rev = light's emission pdf toward pt[t-1].
            pdir = _pdf_le_dir(scene, lid_s, ng_l, -wn)
            p_ti_rev = _convert_density(
                pdir, ls.p_light, pt.p[:, ti], pt.ng[:, ti],
                jnp.ones((P,), bool))
            if has_inf:
                # Vertex::PdfLight for infinite lights (bdpt.h:372).
                wr = scene.world_radius
                plan = (1.0 / (jnp.pi * wr * wr)) \
                    * jnp.abs(cm.dot(pt.ng[:, ti], wn))
                p_ti_rev = jnp.where(is_inf_l, plan, p_ti_rev)
            ov[("p", ti)] = p_ti_rev
            if ti - 1 >= 0:
                # pt[t-2].pdf_rev = pt[t-1].Pdf(qs[0] -> pt[t-2]).
                wprev = pt.p[:, ti - 1] - pt.p[:, ti]
                dprev = jnp.maximum(cm.length(wprev), 1e-12)
                wpn = wprev / dprev[:, None]
                pdf_p2 = _bsdf_pdf(scene, pt.mat_id[:, ti], pt.uv[:, ti],
                                   pt.p[:, ti], pt.ns[:, ti], wn, wpn)
                ov[("p", ti - 1)] = _convert_density(
                    pdf_p2, pt.p[:, ti], pt.p[:, ti - 1],
                    pt.ng[:, ti - 1],
                    pt.vtype[:, ti - 1] == VT_SURFACE)
            L = jnp.where(valid[:, None], L, 0.0)
            w = self._mis_weight(qs1, pt, 1, t_n, ov,
                                 env_no_lightwalk=(is_inf_l if has_inf
                                                   else None))
            return L, jnp.where(valid, w, 0.0)

        # s >= 2: surface-surface connection.
        si = s_n - 1
        qs_ok = qs.exists(si) & (qs.vtype[:, si] == VT_SURFACE)
        valid = pt_ok & qs_ok & ~pt.delta[:, ti] & ~qs.delta[:, si]
        wdir = qs.p[:, si] - pt.p[:, ti]
        d2 = jnp.maximum(cm.length_squared(wdir), 1e-20)
        dist = jnp.sqrt(d2)
        wn = wdir / dist[:, None]
        f_t, _ = _bsdf_f(self.s.scene, pt.mat_id[:, ti], pt.uv[:, ti],
                         pt.p[:, ti], pt.ns[:, ti], pt.wo[:, ti], wn)
        f_s, _ = _bsdf_f(self.s.scene, qs.mat_id[:, si], qs.uv[:, si],
                         qs.p[:, si], qs.ns[:, si], qs.wo[:, si], -wn)
        g = (jnp.abs(cm.dot(wn, pt.ns[:, ti]))
             * jnp.abs(cm.dot(wn, qs.ns[:, si])) / d2)
        valid = valid & (jnp.any(f_t > 0, -1) & jnp.any(f_s > 0, -1))
        unocc = vis(pt.p[:, ti], qs.p[:, si], pt.ng[:, ti], valid)
        valid = valid & unocc
        L = pt.beta[:, ti] * f_t * g[:, None] * f_s * qs.beta[:, si]
        ov = {}
        # qs[s-1].pdf_rev = pt[t-1].Pdf(pt[t-2] -> qs[s-1]).
        pdf_qs1 = _bsdf_pdf(self.s.scene, pt.mat_id[:, ti], pt.uv[:, ti],
                            pt.p[:, ti], pt.ns[:, ti], pt.wo[:, ti], wn)
        ov[("q", si)] = _convert_density(
            pdf_qs1, pt.p[:, ti], qs.p[:, si], qs.ng[:, si],
            jnp.ones((P,), bool))
        # qs[s-2].pdf_rev = qs[s-1].Pdf(pt[t-1] -> qs[s-2]).
        if si - 1 >= 0:
            wq = qs.p[:, si - 1] - qs.p[:, si]
            dq = jnp.maximum(cm.length(wq), 1e-12)
            wqn = wq / dq[:, None]
            pdf_qs2 = _bsdf_pdf(self.s.scene, qs.mat_id[:, si],
                                qs.uv[:, si], qs.p[:, si], qs.ns[:, si],
                                -wn, wqn)
            ov[("q", si - 1)] = _convert_density(
                pdf_qs2, qs.p[:, si], qs.p[:, si - 1], qs.ng[:, si - 1],
                qs.on_surface(si - 1))
        # pt[t-1].pdf_rev = qs[s-1].Pdf(qs[s-2] -> pt[t-1]).
        pdf_pt1 = _bsdf_pdf(self.s.scene, qs.mat_id[:, si], qs.uv[:, si],
                            qs.p[:, si], qs.ns[:, si], qs.wo[:, si], -wn)
        ov[("p", ti)] = _convert_density(
            pdf_pt1, qs.p[:, si], pt.p[:, ti], pt.ng[:, ti],
            jnp.ones((P,), bool))
        # pt[t-2].pdf_rev = pt[t-1].Pdf(qs[s-1] -> pt[t-2]).
        if ti - 1 >= 0:
            wp = pt.p[:, ti - 1] - pt.p[:, ti]
            dp = jnp.maximum(cm.length(wp), 1e-12)
            wpn = wp / dp[:, None]
            pdf_pt2 = _bsdf_pdf(self.s.scene, pt.mat_id[:, ti],
                                pt.uv[:, ti], pt.p[:, ti], pt.ns[:, ti],
                                wn, wpn)
            ov[("p", ti - 1)] = _convert_density(
                pdf_pt2, pt.p[:, ti], pt.p[:, ti - 1], pt.ng[:, ti - 1],
                pt.vtype[:, ti - 1] == VT_SURFACE)
        L = jnp.where(valid[:, None], L, 0.0)
        w = self._mis_weight(qs, pt, s_n, t_n, ov)
        return L, jnp.where(valid, w, 0.0)

    def _area_light_normal(self, scene, light_id, ls):
        """Geometric EMISSION normal at an area-light sample point.

        Triangles encode ReverseOrientation by winding swap (the cross
        product is already flipped); spheres carry the explicit
        sph_flip sign (scene/build.py:606-656) -- omitting it zeroed
        the s=1 emission-pdf MIS override on reversed sphere lights
        (round-3/4 analytic s3 failure)."""
        if scene.tri_p0.shape[0] > 0:
            t = jnp.maximum(scene.light_prim[light_id], 0)
            n_tri = cm.normalize(jnp.cross(scene.tri_e1[t],
                                           scene.tri_e2[t]))
        else:
            n_tri = jnp.zeros_like(ls.p_light)
        if scene.sph_center.shape[0] > 0:
            si = jnp.maximum(scene.light_prim[light_id], 0)
            n_sph = cm.normalize(ls.p_light - scene.sph_center[si])
            if scene.sph_flip is not None:
                n_sph = n_sph * jnp.take(scene.sph_flip, si,
                                         axis=0)[:, None]
            kind = scene.light_kind[light_id]
            return jnp.where((kind == sb.LIGHT_AREA_SPH)[:, None],
                             n_sph, n_tri)
        return n_tri

    def _connect_t1(self, qs, s_n, pmf_all, vis):
        """t = 1: connect qs[s-1] to the camera; splat to the raster
        pixel the connection lands in (bdpt.cpp:721-744)."""
        scene = self.s.scene
        P = qs.P
        si = s_n - 1
        ok = qs.exists(si) & (qs.vtype[:, si] == VT_SURFACE) \
            & ~qs.delta[:, si]
        wi, dist, we, idx, inside, cos_lens = self._sample_wi_camera(
            qs.p[:, si])
        f, _ = _bsdf_f(scene, qs.mat_id[:, si], qs.uv[:, si], qs.p[:, si],
                       qs.ns[:, si], qs.wo[:, si], wi)
        # Importance-transport shading-normal correction for the camera
        # connection half (bdpt.cpp ConnectBDPT t==1 case uses
        # AbsDot(ns, wi) * correction folded via Vertex::f in Importance
        # mode).
        num = (jnp.abs(cm.dot(qs.wo[:, si], qs.ns[:, si]))
               * jnp.abs(cm.dot(wi, qs.ng[:, si])))
        den = (jnp.abs(cm.dot(qs.wo[:, si], qs.ng[:, si]))
               * jnp.abs(cm.dot(wi, qs.ns[:, si])))
        corr = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9), 0.0)
        cosw = jnp.abs(cm.dot(wi, qs.ns[:, si]))
        # Pinhole Sample_Wi (perspective.cpp:Sample_Wi): with a point
        # lens, pdf = dist^2 / |cos(lens normal, wi)| and the returned
        # importance is We/pdf; cos(lens normal, wi) is cos_lens here.
        pdf_dist = (jnp.maximum(dist, 1e-12) ** 2
                    / jnp.maximum(cos_lens, 1e-6))
        valid = ok & inside & jnp.any(f > 0, -1) & jnp.any(we > 0, -1)
        cam_p = qs.p[:, si] + wi * dist[:, None]
        unocc = vis(qs.p[:, si], cam_p, qs.ng[:, si], valid)
        valid = valid & unocc
        L = (qs.beta[:, si] * f * (corr * cosw)[:, None] * we
             / pdf_dist[:, None])
        # MIS: camera-side path has a single vertex (the camera);
        # overrides: qs[s-1].pdf_rev = camera Pdf_We dir density;
        # qs[s-2].pdf_rev = qs[s-1].Pdf(camera -> qs[s-2]).
        pt1 = _Path(P, 1)
        pt1.set(0, p=cam_p, ng=wi, ns=wi, beta=we,
                vtype=jnp.where(valid, VT_CAMERA, VT_NONE))
        ov = {}
        _, pdf_dir = self._pdf_we(cam_p, -wi)
        ov[("q", si)] = _convert_density(
            pdf_dir, cam_p, qs.p[:, si], qs.ng[:, si],
            jnp.ones((P,), bool))
        if si - 1 >= 0:
            wq = qs.p[:, si - 1] - qs.p[:, si]
            dq = jnp.maximum(cm.length(wq), 1e-12)
            wqn = wq / dq[:, None]
            pdf_q2 = _bsdf_pdf(scene, qs.mat_id[:, si], qs.uv[:, si],
                               qs.p[:, si], qs.ns[:, si], wi, wqn)
            ov[("q", si - 1)] = _convert_density(
                pdf_q2, qs.p[:, si], qs.p[:, si - 1], qs.ng[:, si - 1],
                qs.on_surface(si - 1))
        w = self._mis_weight(qs, pt1, s_n, 1, ov)
        L = jnp.where(valid[:, None], L, 0.0)
        return L, idx, jnp.where(valid, w, 0.0)

    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    def make_contribution(self, n_chains: int, max_dims: int = 256):
        """Kelemen-MLT contribution function over the BDPT strategy sum
        (render/pssmlt.py).

        pbrt's MLT mutates ONE (s,t) strategy per state (mlt.cpp:120-260
        picks depth + strategy from the connection stream).  On a SIMD
        wavefront that design wastes all lanes but one strategy's worth
        of connection work, so here f(U) is the FULL t>=2 strategy sum:
        mutations of the light-stream dims of U explore caustic paths
        exactly as pbrt's light-subpath stream does, and the evaluation
        stays lane-uniform.  t=1 strategies (which splat to a different
        pixel than U's film dims) are excluded WITH their MIS terms
        (exclude_t1), so the reduced mixture still partitions --
        unbiased, documented deviation.

        Returns (f, n_dims): f(U [C, n_dims]) -> (y [C], L [C,3],
        pix [C] int32)."""
        import functools

        s = self.s
        W, H = s.width, s.height
        scene, bvh = s.scene, s.bvh
        D = self.max_depth
        Vc = D + 2
        self.exclude_t1 = True
        holder = {}

        def f(U):
            keys = _Draws(U=U, skip=2)
            px = jnp.clip(U[:, 0] * W, 0.0, W - 1e-3)
            py = jnp.clip(U[:, 1] * H, 0.0, H - 1e-3)
            o0, d0 = CAM.generate_rays(s.cam, jnp.stack([px, py], -1))
            pt = self._camera_walk(keys, o0, d0, Vc)
            qs = self._light_walk(keys, D + 1, n_lanes=n_chains)
            pmf_all = self._light_pmf_all

            def vis(pa, pb, ng_a, valid):
                wdir = pb - pa
                dist = cm.length(wdir)
                wn = wdir / jnp.maximum(dist, 1e-12)[:, None]
                occ = occluded_scene(
                    scene, _offset_origin(pa, ng_a, wn), wn,
                    jnp.where(valid, jnp.maximum(dist * 0.999, 0.0), 0.0),
                    bvh=bvh)
                return ~occ

            L = jnp.zeros((n_chains, 3))
            for t_n in range(2, Vc + 1):
                for s_n in range(0, D + 2):
                    if s_n + t_n > D + 2:
                        continue
                    c, w = self._connect(qs, pt, s_n, t_n, keys, pmf_all,
                                         vis)
                    if c is None:
                        continue
                    L = L + c * w[:, None]
            pix = (py.astype(jnp.int32) * W + px.astype(jnp.int32))
            holder["dims"] = keys._next
            return spec.luminance(L), L, pix

        # Discover the dim count with an abstract trace (no compute).
        jax.eval_shape(f, jax.ShapeDtypeStruct((n_chains, max_dims),
                                               jnp.float32))
        return f, holder["dims"]

    def _render_iteration(self, i: int) -> float:
        s = self.s
        if self._iter_fn is None:
            self._iter_fn = jax.jit(self._build_iteration(),
                                    static_argnames=("n",))
        n = s.ecfg.pixel_samples if not s.ecfg.exp_iterations or i == 1 \
            else s.ecfg.pixel_samples << (i - 2)
        base_key = crng.base_key(s.base_seed)
        film, splat = self._iter_fn(jax.random.fold_in(base_key, i), i, n)
        self.film_sum = self.film_sum + film
        self.splat_sum = self.splat_sum + splat
        self.n_samples += n
        P = s.width * s.height
        D = self.max_depth
        # rays: 2 walks of ~D segments + ~D^2/2 connection shadow rays.
        return float(n * P * (2 * D + (D * (D + 1)) // 2))
