"""Ambient-occlusion integrator (wavefront).

Re-derivation of the reference's AOIntegrator
(/root/reference/src/integrators/ao.cpp:57-102): at the first hit,
average visibility over `nsamples` hemisphere directions around the
face-forwarded GEOMETRIC normal (ao.cpp:77 "true geometry, not shading
geometry"), cosine-weighted by default (`"bool cossample"`), uniform
otherwise; null-BSDF hits re-spawn through the surface (ao.cpp:67-71).

Wavefront shape: one lane per pixel; the nsamples occlusion probes run as a
lax.scan of batched any-hit queries over all lanes (each step is one
full-width occlusion dispatch -- the shadow-ray shape the accelerators
are optimized for), instead of the reference's per-pixel sample array.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as cm
from ..core import rng as crng
from ..scene import build as sb
from . import bsdf as B
from . import camera as CAM
from .alt_integrators import AltRenderer
from .integrator import _offset_origin
from .intersect import intersect_scene, occluded_scene


class AORenderer(AltRenderer):
    """integrator "ao": each driver iteration adds `pixelsamples`
    camera samples, each probing `nsamples` occlusion directions."""

    def __init__(self, desc, base_seed: int = 0, force_dense: bool = False):
        ip = desc.integrator_params
        self.cos_sample = bool(ip.find_one("cossample", True)) if ip \
            else True
        self.n_samples_ao = int(ip.find_one("nsamples", 64)) if ip else 64
        super().__init__(desc, base_seed, force_dense=force_dense)

    def _reset_state(self):
        P = self.s.width * self.s.height
        self.film_sum = jnp.zeros((P, 3))
        self.n_cam = 0
        self._iter_fn = None

    @property
    def film_mean(self):
        return self.film_sum / max(self.n_cam, 1)

    def _build_iteration(self):
        s = self.s
        scene, bvh = s.scene, s.bvh
        P = s.width * s.height
        W = s.width
        NS = self.n_samples_ao
        cos_sample = self.cos_sample
        pixel_ids = jnp.arange(P, dtype=jnp.int32)

        def one_sample(base_key, it):
            keys = crng.pixel_keys(base_key, pixel_ids,
                                   jnp.asarray(it, jnp.int32))
            px = (pixel_ids % W).astype(jnp.float32)
            py = (pixel_ids // W).astype(jnp.float32)
            u_cam = crng.uniform_2d(keys, 0, crng.SLOT_CAMERA)
            o, d = CAM.generate_rays(s.cam, jnp.stack([px, py], -1) + u_cam)

            # First hit; one null-BSDF pass-through re-spawn (ao.cpp:67
            # retry loop; one level matches the bundled null scenes).
            hit = intersect_scene(scene, o, d, bvh=bvh)
            m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p)
            null_mat = hit.found & (m.mat_type == sb.MAT_NONE)
            o2 = _offset_origin(hit.p, -hit.ng, d)
            hit2 = intersect_scene(
                scene, o2, d,
                t_max=jnp.where(null_mat, cm.INF, 0.0), bvh=bvh)
            use2 = null_mat & hit2.found
            p = jnp.where(use2[:, None], hit2.p, hit.p)
            ng = jnp.where(use2[:, None], hit2.ng, hit.ng)
            found = jnp.where(null_mat, use2, hit.found)

            # Frame on the face-forwarded geometric normal (ao.cpp:77).
            n = jnp.where(cm.dot(ng, -d)[:, None] < 0, -ng, ng)
            frame = B.ShadingFrame.from_normal(
                jnp.where(jnp.any(n != 0, -1, keepdims=True), n,
                          jnp.array([0.0, 0.0, 1.0])))

            def probe(acc, k):
                u = crng.uniform_2d(keys, k, crng.SLOT_BSDF)
                if cos_sample:
                    wi_l = B.cosine_sample_hemisphere(u)
                    # weight = dot(wi,n)/pdf = cos/(cos/pi) = pi; the
                    # 1/nsamples and the uniform-vs-cos constants fold
                    # into `scale` below (ao.cpp:97 L += dot/(pdf*n)).
                    wgt = jnp.full((P,), jnp.pi)
                else:
                    z = u[:, 0]
                    r_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
                    phi = 2.0 * jnp.pi * u[:, 1]
                    wi_l = jnp.stack(
                        [r_ * jnp.cos(phi), r_ * jnp.sin(phi), z], -1)
                    wgt = z * (2.0 * jnp.pi)  # dot/(1/2pi)
                wi = frame.to_world(wi_l)
                occ = occluded_scene(
                    scene, _offset_origin(p, n, wi), wi,
                    jnp.where(found, cm.INF, 0.0), bvh=bvh)
                return acc + jnp.where(found & ~occ, wgt, 0.0), None

            vis, _ = jax.lax.scan(probe, jnp.zeros((P,)),
                                  jnp.arange(NS, dtype=jnp.int32))
            return jnp.broadcast_to((vis / NS)[:, None], (P, 3))

        def run(base_key, it, n):
            def body(i, acc):
                return acc + one_sample(base_key, it * n + i)

            return jax.lax.fori_loop(0, n, body, jnp.zeros((P, 3)))

        return jax.jit(run, static_argnames=("n",))

    def _render_iteration(self, i: int) -> float:
        s = self.s
        if self._iter_fn is None:
            self._iter_fn = self._build_iteration()
        n = s.ecfg.pixel_samples if not s.ecfg.exp_iterations or i == 1 \
            else s.ecfg.pixel_samples << (i - 2)
        base_key = crng.base_key(s.base_seed)
        film = self._iter_fn(jax.random.fold_in(base_key, i), i, n)
        self.film_sum = self.film_sum + film
        self.n_cam += n
        P = s.width * s.height
        return float(n * P * (1 + self.n_samples_ao))
