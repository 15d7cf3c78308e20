"""Directional-albedo lookup tables: N-D multilinear interp + MC precompute.

The reference precomputes per-material-family directional-albedo tables
(~100x faster than pbrt's rho(); src/statistics/luts/precomputealbedo/
README) and queries them per bounce-0 intersection through a generic
up-to-8-D multilinear interpolator (src/statistics/lut.h:163-272), with
constant-texture dimensions baked out at material construction
(src/core/material.cpp:134-255).

Wavefront shape: tables are flat device arrays; interpolation over N static
dims unrolls into 2^N gathers + lerps, vectorized over all lanes.  The
precompute is itself a JAX Monte Carlo integration over the existing
BSDF sampling code (no separate C++ tool needed; exposed as
`python -m statmc_tpu.tools.precomputealbedo` with the reference tool's
--comparetopbrt / --testlut / --benchmark modes).

Two table tiers:
  1. Full N-D family tables (FAMILY_AXES below): the reference's 9
     precomputed families with their axis grids
     (precomputealbedo/main.cpp:78-128) -- matte/mirror 2-D, hair 4-D,
     plastic 4-D, metal/substrate 5-D, translucent/glass 6-D, uber 8-D;
     produced and self-tested by tools/precomputealbedo.
  2. Per-material reduced curves (precompute_material_curves): the
     constant-texture reduction (material.cpp:134-255) collapses every
     non-cos_theta dimension at build, and Kd-linearity covers textured
     Kd exactly -- this is the render-time query path.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import functools

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class LookupTable(NamedTuple):
    """Flattened N-D table with per-dim sizes (lut.h:163 equivalent)."""
    data: Array  # [prod(sizes)] or [prod(sizes), C]
    sizes: tuple  # static per-dim sample counts

    def lookup(self, coords: Array) -> Array:
        """Multilinear interpolation.

        coords: [..., N] normalized in [0,1] per dimension.
        Returns [...] or [..., C].
        """
        n = len(self.sizes)
        idx0 = []
        fracs = []
        for d in range(n):
            x = jnp.clip(coords[..., d], 0.0, 1.0) * (self.sizes[d] - 1)
            i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0,
                          self.sizes[d] - 2 if self.sizes[d] > 1 else 0)
            idx0.append(i0)
            fracs.append(x - i0.astype(jnp.float32))

        strides = []
        s = 1
        for d in reversed(range(n)):
            strides.insert(0, s)
            s *= self.sizes[d]

        out = None
        for corner in range(1 << n):
            flat = 0
            w = None
            for d in range(n):
                hi = (corner >> d) & 1
                step = hi if self.sizes[d] > 1 else 0
                flat = flat + (idx0[d] + step) * strides[d]
                wd = fracs[d] if hi else (1.0 - fracs[d])
                w = wd if w is None else w * wd
            val = self.data[flat]
            if val.ndim > flat.ndim:
                w = w[..., None]
            out = val * w if out is None else out + val * w
        return out


def _mc_albedo(mat_lanes, cos_thetas: Array, n_samples: int,
               key, full_sphere=False) -> Array:
    """MC directional albedo rho(wo) = E[f |cos wi| / pdf] per lane.

    full_sphere=True integrates over the whole sphere (hair fibers
    scatter through TT/TRT; the hemispherical GetAlbedo convention
    would halve their response).  Accepts a per-lane [G] bool mask for
    mixed-material batches (precompute_material_curves)."""
    from . import bsdf as B

    G = cos_thetas.shape[0]
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_thetas**2))
    wo = jnp.stack([st, jnp.zeros_like(st), cos_thetas], axis=-1)
    if isinstance(full_sphere, bool):
        sphere_mask = None if not full_sphere else True
    else:
        sphere_mask = full_sphere[..., None]

    def body(i, acc):
        k = jax.random.fold_in(key, i)
        u2 = jax.random.uniform(k, (G, 2))
        uc = jax.random.uniform(jax.random.fold_in(k, 1), (G,))
        smp = B.sample(mat_lanes, wo, u2, uc)
        w = smp.f * jnp.abs(smp.wi[..., 2:3]) / jnp.maximum(
            smp.pdf, 1e-9)[..., None]
        w = jnp.where(jnp.isfinite(w), w, 0.0)
        if sphere_mask is None:
            # Reflection-side albedo only (GetAlbedo semantics).
            w = jnp.where((smp.wi[..., 2:3] > 0), w, 0.0)
        elif sphere_mask is not True:
            w = jnp.where(sphere_mask | (smp.wi[..., 2:3] > 0), w, 0.0)
        return acc + w

    total = jax.lax.fori_loop(0, n_samples, body, jnp.zeros((G, 3)))
    return total / n_samples


# ---------------------------------------------------------------------------
# Full N-D family tables.  Axis definitions mirror the reference's
# precompute grids (statistics/luts/precomputealbedo/main.cpp:78-128 and
# the per-family material constructions at main.cpp:404-480): axis 0 is
# always cos(theta_o) in [CosEpsilon, 1]; spectral axes (Kd, Ks, ...)
# are swept achromatically and queried per channel at render time
# (material.cpp LUT_SET_INDICES_SPECTRUM).
# ---------------------------------------------------------------------------

TROWBRIDGE_ALPHA_MIN = 0.0472695  # core/pbrt.h:233
TROWBRIDGE_ALPHA_MAX = 1.62142    # core/pbrt.h:234
_COS_EPS = 1e-4
_EPS = 1e-4

# family -> list of (axis name, lo, hi[, gamma]); axis 0 is cos_theta
# everywhere.  gamma != 1 warps the grid spacing: texel i sits at
# lo + (i/(n-1))**gamma * (hi - lo), concentrating samples near lo where
# the albedo's curvature lives (conductor Fresnel near eta ~ 0, grazing
# cos_theta).  The reference's grids are uniform (main.cpp GetFloat
# Lerp); the warp halves the worst-case interpolation error at equal
# table size (measured: metal max |err| 0.076 -> <0.05 at 8^5).
FAMILY_AXES = {
    "matte": [("cos_theta", _COS_EPS, 1.0), ("sigma", 0.0, 90.0)],
    "mirror": [("cos_theta", _COS_EPS, 1.0), ("kr", 0.0, 1.0)],
    "metal": [("cos_theta", _COS_EPS, 1.0, 2.0), ("eta", _EPS, 7.14),
              ("k", _EPS, 8.62, 2.0),
              ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
              ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX)],
    "plastic": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
                ("ks", 0.0, 1.0),
                ("rough", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX)],
    "substrate": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
                  ("ks", 0.0, 1.0),
                  ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
                  ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX)],
    "translucent": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
                    ("ks", 0.0, 1.0),
                    ("rough", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
                    ("kr", 0.0, 1.0), ("kt", 0.0, 1.0)],
    "glass": [("cos_theta", _COS_EPS, 1.0), ("kr", 0.0, 1.0),
              ("kt", 0.0, 1.0),
              ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
              ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
              ("eta", 1.0 + _EPS, 2.42)],
    "uber": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
             ("ks", 0.0, 1.0), ("kr", 0.0, 1.0), ("kt", 0.0, 1.0),
             ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
             ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
             ("eta", 1.0 + _EPS, 2.42)],
    "hair": [("cos_theta", _COS_EPS, 1.0, 2.0), ("sigma_a", _EPS, 1.0, 2.0),
             ("beta_m", _EPS, 1.0), ("beta_n", _EPS, 1.0, 2.0)],
}

# The reference excludes disney/fourier/kdsubsurface/subsurface from
# precompute (non-bounded parameter scales, main.cpp:339-344); those
# families keep the per-material reduced curves below.

_FAMILY_MAT = None  # lazily built name -> MAT_* map


def _family_mat_type(family: str) -> int:
    global _FAMILY_MAT
    if _FAMILY_MAT is None:
        from ..scene import build as sb

        _FAMILY_MAT = {
            "matte": sb.MAT_MATTE, "mirror": sb.MAT_MIRROR,
            "metal": sb.MAT_METAL, "plastic": sb.MAT_PLASTIC,
            "substrate": sb.MAT_SUBSTRATE,
            "translucent": sb.MAT_TRANSLUCENT, "glass": sb.MAT_GLASS,
            "uber": sb.MAT_UBER, "hair": sb.MAT_HAIR,
        }
    return _FAMILY_MAT[family]


def _lanes_from_coords(family: str, coords: Array):
    """Normalized [G, N] coords -> (MaterialLanes [G], cos_theta [G]).

    Mirrors the reference's grid-point material constructions
    (main.cpp:404-480); hair parameters ride the repurposed slots
    documented at scene/build.py MAT_HAIR."""
    from .bsdf import MaterialLanes

    axes = FAMILY_AXES[family]
    G = coords.shape[0]
    vals = {}
    for i, ax in enumerate(axes):
        name, lo, hi = ax[0], ax[1], ax[2]
        gamma = ax[3] if len(ax) > 3 else 1.0
        u = coords[..., i] ** gamma if gamma != 1.0 else coords[..., i]
        vals[name] = lo + u * (hi - lo)

    def spec(name, default):
        if name in vals:
            return jnp.broadcast_to(vals[name][..., None], (G, 3))
        return jnp.full((G, 3), default)

    def scal(name, default):
        return vals.get(name, jnp.full((G,), default))

    if "rough" in vals:
        rough_u = rough_v = vals["rough"]
    else:
        rough_u = scal("rough_u", 0.0)
        rough_v = vals.get("rough_v", rough_u)
    hair_h = None
    sigma = scal("sigma", 0.0)
    eta = spec("eta", 1.5)
    kt = spec("kt", 0.0)
    if family == "hair":
        hair_h = jnp.zeros((G,))
        kt = spec("sigma_a", 0.0)     # sigma_a slot
        sigma = scal("beta_m", 0.3)   # beta_m slot
        rough_u = scal("beta_n", 0.3)
        rough_v = jnp.full((G,), 2.0)  # alpha degrees
        eta = jnp.full((G, 3), 1.55)
    lanes = MaterialLanes(
        mat_type=jnp.full((G,), _family_mat_type(family), jnp.int32),
        kd=spec("kd", 1.0 if family == "matte" else 0.0),
        ks=spec("ks", 0.0),
        kr=spec("kr", 0.0),
        kt=kt,
        eta=eta,
        k=spec("k", 0.0),
        rough_u=rough_u,
        rough_v=rough_v,
        sigma=sigma,
        hair_h=hair_h,
    )
    return lanes, vals["cos_theta"]


def mc_albedo_at(family: str, coords: Array, n_samples: int = 1024,
                 seed: int = 0) -> Array:
    """Fresh MC albedo at arbitrary normalized coords [G, N] -> [G]."""
    lanes, cos = _lanes_from_coords(family, coords)
    out = _mc_albedo(lanes, cos, n_samples, jax.random.PRNGKey(seed),
                     full_sphere=(family == "hair"))
    return out[..., 0]


def precompute_family_nd(family: str, sizes=None, n_samples: int = 1024,
                         seed: int = 0, chunk: int = 1 << 15
                         ) -> LookupTable:
    """Full N-D albedo table for one family (lut width 8 as in
    main.cpp:48 LutWidth; uber defaults to 4/dim -- the reference
    downloads its 8^8 uber table rather than shipping it)."""
    axes = FAMILY_AXES[family]
    n = len(axes)
    if sizes is None:
        sizes = (4,) * n if family == "uber" else (8,) * n
        if family == "metal":
            # The conductor Fresnel pivots violently around
            # (eta ~ 1, k ~ 0) and at grazing cos_theta; denser cos/eta
            # axes (+ the k/cos warps above) bring off-grid error under
            # the 0.05 threshold (measured on CPU runs).
            sizes = (16, 16, 8, 8, 8)
    assert len(sizes) == n
    grids = [np.linspace(0.0, 1.0, s) if s > 1 else np.array([0.0])
             for s in sizes]
    mesh = np.meshgrid(*grids, indexing="ij")
    coords = np.stack([m.reshape(-1) for m in mesh], -1).astype(np.float32)
    G = coords.shape[0]
    out = np.empty((G,), np.float32)
    fn = jax.jit(functools.partial(mc_albedo_at, family,
                                   n_samples=n_samples, seed=seed))
    for s0 in range(0, G, chunk):
        out[s0:s0 + chunk] = np.asarray(
            fn(jnp.asarray(coords[s0:s0 + chunk])))
    return LookupTable(data=jnp.asarray(out), sizes=tuple(sizes))


def precompute_family(family: str, sizes=(16, 16), n_samples: int = 1024,
                      seed: int = 0, eta=None, k=None) -> LookupTable:
    """Precompute a (cos_theta, param2) albedo table for one family.

    param2 axis: sigma in [0, 90] deg for matte; alpha in [0.01, 1] for
    microfacet families.  Albedo here is for unit Kd/Ks; callers scale
    by the material color (matching e.g. matte.cpp:110-113
    Kd * Material::GetAlbedo).
    """
    from . import bsdf as B
    from ..scene import build as sb

    n_cos, n_p2 = sizes
    cos = (np.arange(n_cos) + 0.5) / n_cos
    if family == "matte":
        p2 = np.linspace(0.0, 90.0, n_p2)
        mat_type = sb.MAT_MATTE
    elif family == "metal":
        p2 = np.linspace(0.01, 1.0, n_p2)
        mat_type = sb.MAT_METAL
    elif family == "substrate":
        p2 = np.linspace(0.01, 1.0, n_p2)
        mat_type = sb.MAT_SUBSTRATE
    elif family == "plastic":
        p2 = np.linspace(0.01, 1.0, n_p2)
        mat_type = sb.MAT_PLASTIC
    else:
        raise ValueError(f"unknown albedo family {family!r}")

    cc, pp = np.meshgrid(cos, p2, indexing="ij")
    G = cc.size
    ones = jnp.ones((G, 3))
    zeros = jnp.zeros((G, 3))
    eta_arr = (jnp.broadcast_to(jnp.asarray(eta, jnp.float32), (G, 3))
               if eta is not None else jnp.full((G, 3), 1.5))
    k_arr = (jnp.broadcast_to(jnp.asarray(k, jnp.float32), (G, 3))
             if k is not None else jnp.zeros((G, 3)))
    rough = jnp.asarray(pp.reshape(-1), jnp.float32)
    sigma = (jnp.asarray(pp.reshape(-1), jnp.float32)
             if family == "matte" else jnp.zeros((G,)))
    if family == "matte":
        rough = jnp.zeros((G,))

    from .bsdf import MaterialLanes

    lanes = MaterialLanes(
        mat_type=jnp.full((G,), mat_type, jnp.int32),
        kd=ones, ks=ones if family != "matte" else zeros,
        kr=zeros, kt=zeros, eta=eta_arr, k=k_arr,
        rough_u=rough, rough_v=rough, sigma=sigma,
    )
    vals = _mc_albedo(
        lanes, jnp.asarray(cc.reshape(-1), jnp.float32), n_samples,
        jax.random.PRNGKey(seed),
    )[..., 0]  # family tables are achromatic at unit coefficients
    return LookupTable(data=vals, sizes=(n_cos, n_p2))


# ---------------------------------------------------------------------------
# Per-material reduced tables (the reference's LUT reduction:
# material.cpp:134-255 bakes constant-texture dimensions out at material
# construction; with untextured parameters every dimension but cos_theta
# is constant, so each material reduces to a 1-D albedo curve).
# ---------------------------------------------------------------------------


def precompute_material_curves(scene_tables, n_cos: int = 16,
                               n_samples: int = 512, seed: int = 3):
    """Returns (lut_d [M, n_cos, 3], lut_rest [M, n_cos, 3]):

    albedo(cos) ~= kd_runtime * lut_d[mat](cos) + lut_rest[mat](cos)

    lut_d is the diffuse-lobe albedo with unit Kd (so textured Kd scales
    linearly at query time); lut_rest holds every non-Kd lobe with the
    material's actual parameters.
    """
    from .bsdf import MaterialLanes

    M = int(scene_tables.mat_type.shape[0])
    cos = jnp.asarray((np.arange(n_cos) + 0.5) / n_cos, jnp.float32)
    G = M * n_cos

    def tile(x):
        return jnp.repeat(x, n_cos, axis=0)

    ones3 = jnp.ones((G, 3))
    zeros3 = jnp.zeros((G, 3))
    from ..scene import build as sb

    # Hair lanes route through the full Marschner model (hair_h=0,
    # sigma_a riding the kt slot) and integrate over the whole sphere,
    # the analogue of the reference's dedicated hair albedo LUT
    # (materials/hair.cpp:171 hairAlbedoLUT).  Elided statically when
    # the scene has no hair.
    has_hair = bool(np.any(np.asarray(scene_tables.mat_type)
                           == sb.MAT_HAIR))
    hair_h = jnp.zeros((G,)) if has_hair else None
    base = MaterialLanes(
        mat_type=tile(scene_tables.mat_type),
        kd=ones3,
        ks=zeros3,
        kr=zeros3,
        kt=zeros3,
        eta=tile(scene_tables.mat_eta),
        k=tile(scene_tables.mat_k),
        rough_u=tile(scene_tables.mat_rough_u),
        rough_v=tile(scene_tables.mat_rough_v),
        sigma=tile(scene_tables.mat_sigma),
        hair_h=hair_h,
    )
    rest = base._replace(
        kd=zeros3,
        ks=tile(scene_tables.mat_ks),
        kr=tile(scene_tables.mat_kr),
        kt=tile(scene_tables.mat_kt),
    )
    cc = jnp.tile(cos, (M,))
    key = jax.random.PRNGKey(seed)
    sphere_mask = (base.mat_type == sb.MAT_HAIR) if has_hair else False
    lut_d = _mc_albedo(base, cc, n_samples, key,
                       full_sphere=sphere_mask).reshape(M, n_cos, 3)
    lut_rest = _mc_albedo(
        rest, cc, n_samples, jax.random.fold_in(key, 1),
        full_sphere=sphere_mask,
    ).reshape(M, n_cos, 3)
    # The kd * lut_d decomposition only applies to families with a
    # Kd-proportional lobe; conductor/dielectric families ignore Kd, so
    # their whole albedo lives in lut_rest (computed with kd=0 above,
    # which those BSDFs never read anyway).  Hair is likewise excluded:
    # its full-sphere Marschner albedo lives entirely in lut_rest.
    t = scene_tables.mat_type
    kd_linear = (
        (t == sb.MAT_MATTE) | (t == sb.MAT_PLASTIC) | (t == sb.MAT_UBER)
        | (t == sb.MAT_SUBSTRATE) | (t == sb.MAT_TRANSLUCENT)
        | (t == sb.MAT_DISNEY)
    )
    lut_d = jnp.where(kd_linear[:, None, None], lut_d, 0.0)
    return lut_d, lut_rest


def albedo_from_curves(lut_d: Array, lut_rest: Array, mat_id: Array,
                       kd: Array, cos_o: Array) -> Array:
    """Query the reduced curves per lane: [R,3] albedo."""
    n_cos = lut_d.shape[1]
    x = jnp.clip(jnp.abs(cos_o), 0.0, 1.0) * n_cos - 0.5
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_cos - 2)
    f = jnp.clip(x - i0, 0.0, 1.0)[..., None]
    d = lut_d[mat_id, i0] * (1 - f) + lut_d[mat_id, i0 + 1] * f
    rr = lut_rest[mat_id, i0] * (1 - f) + lut_rest[mat_id, i0 + 1] * f
    return jnp.clip(kd * d + rr, 0.0, 1.0)
