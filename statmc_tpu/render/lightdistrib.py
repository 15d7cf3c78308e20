"""Light sampling distributions.

The reference supports uniform/power/spatial strategies
(src/core/lightdistrib.cpp; statpath defaults to "spatial",
statpath.cpp:982).  Here:

* uniform / power: exact ports of the distribution math (power uses each
  light's total emitted power, lightdistrib.cpp:PowerLightDistribution).
* spatial: the reference's voxel importance estimation
  (SpatialLightDistribution::ComputeDistribution,
  lightdistrib.cpp:235-295): per voxel, 128 Halton-placed points sample
  every light through Sample_Li and accumulate luminance(Li)/pdf, with
  the 0.001*avg minimum-weight floor.  The wavefront shape differs in WHERE
  the voxels are computed: pbrt builds Distribution1Ds lazily in a
  lock-free hash table as shading points land in voxels (a pointer
  structure XLA cannot express); here the full [V, L] table is
  precomputed at build time with the same estimator (batched
  lights.sample_li over voxel-point lanes) and voxel lookups become a
  gather.  Per-axis voxel counts follow pbrt's proportional rule with a
  smaller cap (16 vs 64 per axis) because the table is dense, not lazy.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import spectrum as spec
from ..scene import build as sb

Array = jax.Array


class LightDistribution(NamedTuple):
    cdf: Array  # [V, L] per-voxel (V=1 for uniform/power)
    pmf: Array  # [V, L]
    grid_res: Any  # (nx, ny, nz) or None
    world_lo: Any  # [3]
    world_inv_extent: Any  # [3]


def _light_power(scene: sb.SceneTables) -> np.ndarray:
    kind = np.asarray(scene.light_kind)
    L = np.asarray(scene.light_L)
    area = np.asarray(scene.light_area)
    wr = float(scene.world_radius)
    lum = L @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    power = np.zeros(kind.shape[0], np.float32)
    power[kind == sb.LIGHT_AREA_TRI] = (
        lum[kind == sb.LIGHT_AREA_TRI] * area[kind == sb.LIGHT_AREA_TRI] * np.pi
    )
    power[kind == sb.LIGHT_AREA_SPH] = (
        lum[kind == sb.LIGHT_AREA_SPH] * area[kind == sb.LIGHT_AREA_SPH] * np.pi
    )
    power[kind == sb.LIGHT_POINT] = 4.0 * np.pi * lum[kind == sb.LIGHT_POINT]
    # Image-modulated point lights: 4pi I is the upper bound pbrt also
    # uses before image averaging (goniometric.cpp:Power ~ average).
    power[kind == sb.LIGHT_GONIO] = 4.0 * np.pi * lum[kind == sb.LIGHT_GONIO]
    power[kind == sb.LIGHT_PROJ] = 2.0 * np.pi * lum[kind == sb.LIGHT_PROJ]
    power[kind == sb.LIGHT_SPOT] = (
        2.0 * np.pi * lum[kind == sb.LIGHT_SPOT]
    )
    power[kind == sb.LIGHT_DISTANT] = (
        np.pi * wr * wr * lum[kind == sb.LIGHT_DISTANT]
    )
    power[kind == sb.LIGHT_INFINITE] = (
        np.pi * wr * wr * lum[kind == sb.LIGHT_INFINITE]
    )
    return power


# Spatial grid: pbrt sizes the widest axis at maxVoxels=64 and computes
# voxels LAZILY per shading point (lightdistrib.cpp:95-112).  The dense
# precomputed table caps the widest axis at 16 instead (up to ~4k
# voxels x 128 estimation samples x L lights of build-time Sample_Li
# evaluations); beyond SPATIAL_MAX_LIGHTS the table would not fit and
# spatial falls back to power -- noise-level change only, zero bias.
SPATIAL_MAX_VOXELS = 16
SPATIAL_N_SAMPLES = 128  # per-voxel estimation points (lightdistrib.cpp:255)
SPATIAL_MAX_LIGHTS = 2048


def _radical_inverse(base: int, n: int) -> np.ndarray:
    """RadicalInverse(base, i) for i in [0, n) (core/lowdiscrepancy.h)."""
    out = np.zeros(n, np.float64)
    i = np.arange(n, dtype=np.int64)
    inv_base = 1.0 / base
    f = inv_base
    while i.max(initial=0) > 0:
        out += (i % base) * f
        i //= base
        f *= inv_base
    return out.astype(np.float32)


def _flat(pmf: np.ndarray) -> LightDistribution:
    cdf = np.cumsum(pmf, axis=-1).astype(np.float32)
    cdf[..., -1] = 1.0
    return LightDistribution(
        cdf=jnp.asarray(cdf[None] if cdf.ndim == 1 else cdf),
        pmf=jnp.asarray(pmf[None] if pmf.ndim == 1 else pmf),
        grid_res=None,
        world_lo=jnp.zeros((3,)),
        world_inv_extent=jnp.ones((3,)),
    )


def make_distribution(scene: sb.SceneTables, strategy: str = "power"
                      ) -> LightDistribution:
    nl = int(np.asarray(scene.light_kind).shape[0])
    if nl == 0:
        return _flat(np.ones((1,), np.float32))
    if strategy == "uniform":
        return _flat(np.full(nl, 1.0 / nl, np.float32))

    p = _light_power(scene)
    tot = p.sum()
    power_pmf = (
        p / tot if tot > 0 else np.full(nl, 1.0 / nl)
    ).astype(np.float32)

    if strategy != "spatial" or nl > SPATIAL_MAX_LIGHTS:
        return _flat(power_pmf)

    # Spatial (SpatialLightDistribution::ComputeDistribution,
    # lightdistrib.cpp:235-295): per voxel, SPATIAL_N_SAMPLES points on
    # a (2,3,5)-base Halton pattern inside the voxel; each samples every
    # light via Sample_Li with the (7,11)-base Halton pair and
    # accumulates luminance(Li)/pdf (visibility ignored, exactly as the
    # reference does); a 0.001*avg minimum-weight floor keeps every
    # light selectable.  The per-axis voxel counts follow pbrt's
    # proportional rule (widest axis = SPATIAL_MAX_VOXELS).
    # Tight per-axis world bounds (pbrt voxelizes scene.WorldBound()).
    pts = []
    if np.asarray(scene.tri_p0).shape[0]:
        p0 = np.asarray(scene.tri_p0)
        p1 = p0 + np.asarray(scene.tri_e1)
        p2 = p0 + np.asarray(scene.tri_e2)
        pts += [p0, p1, p2]
    if np.asarray(scene.sph_center).shape[0]:
        c = np.asarray(scene.sph_center)
        rr = np.asarray(scene.sph_radius)[:, None]
        pts += [c - rr, c + rr]
    if not pts:
        return _flat(power_pmf)
    allp = np.concatenate(pts, 0)
    lo = allp.min(0).astype(np.float32)
    hi = allp.max(0).astype(np.float32)
    diag = np.maximum(hi - lo, 1e-6)
    bmax = float(diag.max())
    nv = np.maximum(
        1, np.round(diag / bmax * SPATIAL_MAX_VOXELS).astype(int))
    V = int(nv[0] * nv[1] * nv[2])

    S = SPATIAL_N_SAMPLES
    u3 = np.stack([_radical_inverse(2, S), _radical_inverse(3, S),
                   _radical_inverse(5, S)], -1)  # [S,3] voxel lerp
    u2 = np.stack([_radical_inverse(7, S), _radical_inverse(11, S)], -1)

    # Voxel lower corners [V,3] in ix-major (ix*ny + iy)*nz + iz order
    # (matches the lookup in sample_light_id).
    ix, iy, iz = np.meshgrid(np.arange(nv[0]), np.arange(nv[1]),
                             np.arange(nv[2]), indexing="ij")
    corner01 = np.stack([ix, iy, iz], -1).reshape(-1, 3) / nv  # [V,3]
    po = (corner01[:, None, :] + u3[None, :, :] / nv) * diag + lo  # [V,S,3]

    from . import lights as LT

    # Host-numpy scene tables must lift to device arrays before the jit
    # closure: jnp ops coerce numpy operands, but sample_li's gonio/
    # projection block fancy-indexes light_w2l with a traced light id,
    # and numpy.__getitem__ on a tracer raises (hit by any image-light
    # scene under the spatial distribution).
    scene = scene.to_device() if hasattr(scene, "to_device") else scene

    @jax.jit
    def chunk_contrib(po_c):
        """po_c: [Vc, S, 3] -> [Vc, L] summed luminance(Li)/pdf."""
        Vc = po_c.shape[0]
        p_flat = jnp.broadcast_to(po_c[:, :, None, :], (Vc, S, nl, 3)
                                  ).reshape(-1, 3)
        lid = jnp.broadcast_to(jnp.arange(nl, dtype=jnp.int32)[None, None],
                               (Vc, S, nl)).reshape(-1)
        uu = jnp.broadcast_to(jnp.asarray(u2)[None, :, None, :],
                              (Vc, S, nl, 2)).reshape(-1, 2)
        ng = jnp.zeros_like(p_flat)  # pbrt passes a zero normal
        ls = LT.sample_li(scene, lid, p_flat, ng, uu)
        y = spec.luminance(ls.li)  # elementwise: no TF32 product
        c = jnp.where(ls.pdf > 0, y / jnp.maximum(ls.pdf, 1e-30), 0.0)
        return jnp.sum(c.reshape(Vc, S, nl), axis=1)

    # Chunk voxels so the flattened lane count stays bounded.
    CH = max(1, (1 << 20) // max(S * nl, 1))
    contrib = np.zeros((V, nl), np.float32)
    po_j = jnp.asarray(po.astype(np.float32))
    for v0 in range(0, V, CH):
        v1 = min(v0 + CH, V)
        contrib[v0:v1] = np.asarray(chunk_contrib(po_j[v0:v1]))

    # Minimum-weight floor (lightdistrib.cpp:283-292).
    avg = contrib.sum(-1, keepdims=True) / (S * nl)
    min_c = np.where(avg > 0, 1e-3 * avg, 1.0)
    contrib = np.maximum(contrib, min_c)

    pmf = contrib / contrib.sum(-1, keepdims=True)
    cdf = np.cumsum(pmf, axis=-1).astype(np.float32)
    cdf[..., -1] = 1.0
    return LightDistribution(
        cdf=jnp.asarray(cdf),
        pmf=jnp.asarray(pmf.astype(np.float32)),
        grid_res=tuple(int(x) for x in nv),
        world_lo=jnp.asarray(lo),
        world_inv_extent=jnp.asarray((1.0 / diag).astype(np.float32)),
    )


def sample_light_id(dist: LightDistribution, u: Array,
                    p: Array | None = None) -> tuple[Array, Array]:
    """Draw a light id per lane: (id [R], pmf [R]).

    p: [R,3] shading points for the spatial strategy (voxel lookup);
    ignored for flat distributions.
    """
    if dist.grid_res is None or p is None:
        cdf = dist.cdf[0]
        idx = jnp.searchsorted(cdf, u, side="right")
        idx = jnp.minimum(idx, cdf.shape[0] - 1).astype(jnp.int32)
        return idx, dist.pmf[0][idx]
    nx, ny, nz = dist.grid_res
    res = jnp.asarray([nx, ny, nz], jnp.float32)
    cap = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32)
    # Voxel of p (lightdistrib.cpp Lookup: offset in the world bound,
    # clamped for points just outside from intersection roundoff).
    g = jnp.clip(
        ((p - dist.world_lo) * dist.world_inv_extent * res).astype(jnp.int32),
        0, cap,
    )
    v = (g[..., 0] * ny + g[..., 1]) * nz + g[..., 2]
    cdf_rows = dist.cdf[v]  # [R, L]
    idx = jax.vmap(
        lambda row, uu: jnp.searchsorted(row, uu, side="right")
    )(cdf_rows, u)
    idx = jnp.minimum(idx, dist.cdf.shape[1] - 1).astype(jnp.int32)
    pmf = jnp.take_along_axis(dist.pmf[v], idx[:, None], axis=1)[:, 0]
    return idx, pmf
