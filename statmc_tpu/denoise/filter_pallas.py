"""Pallas kernel (Triton route) for the statistical denoising filter +
custom VJP.

Same semantics as filter_jax.stat_filter (the XLA reference
implementation; see its docstring for the derivation), shaped for a GPU:

* planar channel layout [C, H+2r, W+2r]: each program owns one
  TH x TW output tile, keeps the center values of every plane and the
  running sums in registers, and walks the (2r+1)^2 window in-kernel.
  Every window offset reads the shifted neighbour tile of each plane
  from device memory, but consecutive offsets touch the same cache
  lines, so each plane is fetched from DRAM about once per tile; the
  XLA sweep instead re-streams every padded plane once per offset and
  writes its accumulators back each time (memory-bound by two orders
  of magnitude at r=20);
* invalid neighbours (zero padding, halo rows past the image edge) carry
  d2 = -inf, which fails the two-sample test, so no validity plane is
  read per offset (centers read their own d2 once);
* everything computes in f32; filter constants (spatial/range Gaussian
  factors) are baked into the trace as Python floats (they are config
  constants in the reference too: estimator.h:259).

The custom VJP exploits the symmetry of the unnormalized weights
(w_ij = w_ji: spatial, range, and acceptance terms are all symmetric):

  F_i = sum_j w_ij m_j / W_i,  W_i = sum_j w_ij
  dL/dm_j = sum_i g_i w_ij / W_i = U[g / W]_j

where U is the *unnormalized* filter -- so the backward pass is one more
launch of the same kernel with normalization off.  Gradients through the
binary acceptance test are zero almost everywhere and are treated as
such (straight-through on the gate); gradients w.r.t. the moment buffers
therefore vanish by construction, matching the finite-difference
behavior of the reference filter at any point where no accept flips.
"""
from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jax.Array

# Output tile per program: TW = 32 f32 columns is one 128-byte row
# segment per load; 16 x 32 pixels over 4 warps is 4 pixels a thread.
TH, TW = 16, 32
NUM_WARPS = 4


def _round_up(x, m):
    return (x + m - 1) // m * m


def _filter_kernel(mc_ref, d2_ref, d2c_ref, fm_ref, gb_ref, out_ref,
                   wsum_ref, *, C, CF, G, th, tw, radius, ds_factor,
                   gb_factors, normalize):
    """One program: output rows [i*th, i*th+th), columns [j*tw, j*tw+tw).
    Inputs are padded planar [*, Hp+2r, Wp+2r]; outputs [CF, Hp, Wp] and
    [Hp, Wp].  C = acceptance-test channels (mc/d2); CF = filtered
    channels (fm may carry the film image as extra planes).  d2 marks
    invalid neighbours with -inf; d2c holds the centers' own values."""
    r = radius
    y0 = pl.program_id(0) * th
    x0 = pl.program_id(1) * tw

    def tile(ref, c, dy, dx):
        return ref[c, pl.ds(y0 + dy, th), pl.ds(x0 + dx, tw)]

    mc_c = [tile(mc_ref, c, r, r) for c in range(C)]
    thr_c = [tile(d2c_ref, c, r, r) + 1e-20 for c in range(C)]
    gb_c = [tile(gb_ref, g, r, r) for g in range(G)]

    def dx_body(dx, carry, dy, sdy):
        wsum, *acc = carry
        accept = None
        for c in range(C):
            diff = mc_c[c] - tile(mc_ref, c, dy, dx)
            a = diff * diff <= thr_c[c] + tile(d2_ref, c, dy, dx)
            accept = a if accept is None else accept & a
        fdx = (dx - r).astype(jnp.float32)
        arg = sdy + ds_factor * (fdx * fdx)
        for g in range(G):
            dg = gb_c[g] - tile(gb_ref, g, dy, dx)
            arg = arg + gb_factors[g] * (dg * dg)
        w = jnp.where(accept, jnp.exp(arg), 0.0)
        return (wsum + w,) + tuple(
            acc[c] + w * tile(fm_ref, c, dy, dx) for c in range(CF))

    def dy_body(dy, carry):
        fdy = (dy - r).astype(jnp.float32)
        body = partial(dx_body, dy=dy, sdy=ds_factor * (fdy * fdy))
        return jax.lax.fori_loop(0, 2 * r + 1, body, carry)

    zero = jnp.zeros((th, tw), jnp.float32)
    wsum, *acc = jax.lax.fori_loop(0, 2 * r + 1, dy_body,
                                   (zero,) * (CF + 1))
    scale = 1.0 / jnp.maximum(wsum, 1e-20) if normalize else None
    for c in range(CF):
        out_ref[c, pl.ds(y0, th), pl.ds(x0, tw)] = (
            acc[c] * scale if normalize else acc[c])
    wsum_ref[pl.ds(y0, th), pl.ds(x0, tw)] = wsum


def _planar(img_hwc, r, Hp, Wp, fill=0.0):
    """[H,W,C] -> [C, Hp+2r, Wp+2r] planar, padded with `fill`."""
    H, W = img_hwc.shape[:2]
    return jnp.pad(jnp.moveaxis(img_hwc, -1, 0),
                   ((0, 0), (r, Hp - H + r), (r, Wp - W + r)),
                   constant_values=fill)


@partial(jax.jit, static_argnames=(
    "radius", "ds_factor", "gb_factors", "normalize", "interpret"))
def _run_filter(mc, d2, fm, gbufs, valid, radius, ds_factor, gb_factors,
                normalize=True, interpret=False):
    """mc/d2: [H,W,C]; fm: [H,W,CF] (CF >= C: trailing planes filter
    along, e.g. the film image); gbufs: [H,W,G] flattened G-buffer
    planes; valid: [H,W] neighbour validity.  H and W need not be
    multiples of the tile.  Returns (out [H,W,CF], wsum [H,W])."""
    H, W, C = mc.shape
    CF = fm.shape[-1]
    G = gbufs.shape[-1]
    r = radius
    Hp, Wp = _round_up(H, TH), _round_up(W, TW)

    mc_p = _planar(mc, r, Hp, Wp)
    d2c_p = _planar(d2, r, Hp, Wp)
    d2_p = _planar(jnp.where(valid[..., None] > 0, d2, -jnp.inf), r, Hp,
                   Wp, fill=-jnp.inf)
    fm_p = _planar(fm, r, Hp, Wp)
    # G = 0: the kernel never reads the G-buffer operand.
    gb_p = _planar(gbufs, r, Hp, Wp) if G else jnp.zeros((1, 1, 1))

    kernel = functools.partial(
        _filter_kernel, C=C, CF=CF, G=G, th=TH, tw=TW, radius=r,
        ds_factor=float(ds_factor),
        gb_factors=tuple(float(g) for g in gb_factors),
        normalize=normalize,
    )
    out, wsum = pl.pallas_call(
        kernel,
        grid=(Hp // TH, Wp // TW),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 5,
        out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_shape=[
            jax.ShapeDtypeStruct((CF, Hp, Wp), jnp.float32),
            jax.ShapeDtypeStruct((Hp, Wp), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="stat_filter",
    )(mc_p, d2_p, d2c_p, fm_p, gb_p)
    return jnp.moveaxis(out[:, :H, :W], 0, -1), wsum[:H, :W]


# ---------------------------------------------------------------------------
# Differentiable entry point
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8))
def filter_apply(film_mean, mc, d2, gbufs, valid, radius, ds_factor,
                 gb_factors, interpret=False):
    """Normalized statistical filter of `film_mean` with weights from
    (mc, d2, gbufs).  Differentiable in film_mean."""
    out, _ = _run_filter(
        mc, d2, film_mean, gbufs, valid, radius, ds_factor, gb_factors,
        normalize=True, interpret=interpret,
    )
    return out


def _filter_fwd(film_mean, mc, d2, gbufs, valid, radius, ds_factor,
                gb_factors, interpret=False):
    out, wsum = _run_filter(
        mc, d2, film_mean, gbufs, valid, radius, ds_factor, gb_factors,
        normalize=True, interpret=interpret,
    )
    return out, (mc, d2, gbufs, valid, wsum)


def _filter_bwd(radius, ds_factor, gb_factors, interpret, res, g):
    mc, d2, gbufs, valid, wsum = res
    gg = g / jnp.maximum(wsum, 1e-20)[..., None]
    # w_ij symmetric => dL/dm = U[g / W] (unnormalized filter).
    grad_m, _ = _run_filter(
        mc, d2, gg, gbufs, valid, radius, ds_factor, gb_factors,
        normalize=False, interpret=interpret,
    )
    zeros = jax.tree.map(jnp.zeros_like, (mc, d2, gbufs, valid))
    return (grad_m,) + zeros


filter_apply.defvjp(_filter_fwd, _filter_bwd)


# ---------------------------------------------------------------------------
# Fully-differentiable twin (G-buffer + film gradients)
# ---------------------------------------------------------------------------


def filter_apply_diff(film_mean, mc, d2, gbufs, valid, radius, ds_factor,
                      gb_factors):
    """Pure-JAX twin of filter_apply with identical weight math, fully
    differentiable via autodiff: gradients flow through the spatial and
    G-buffer range kernels AND into the filtered payload.  Gradients
    through the binary acceptance gate are zero almost everywhere and
    are stopped explicitly (they are a measure-zero step function; the
    reference CUDA filter has the same property under finite
    differences).

    This is the differentiable-rendering entry (north star beyond the
    reference): the Pallas filter_apply keeps the hot film-mean VJP
    (one extra kernel launch), while this twin exists for G-buffer /
    feature-learning gradients where the O(r^2) XLA sweep cost is
    acceptable.  Returns out [H,W,CF]."""
    H, W, C = mc.shape
    r = radius
    side = 2 * r + 1

    def pad(x):
        return jnp.pad(x, ((r, r), (r, r), (0, 0)))

    mc_p = pad(mc)
    d2_p = pad(d2)
    fm_p = pad(film_mean)
    gb_p = pad(gbufs) if gbufs.shape[-1] else None
    v_p = jnp.pad(valid, ((r, r), (r, r)))
    gbf = jnp.asarray(gb_factors, jnp.float32)

    def body(k, acc):
        wsum, fsum = acc
        dy = k // side - r
        dx = k % side - r

        def sl(img):
            return jax.lax.dynamic_slice(
                img, (dy + r, dx + r, 0), (H, W, img.shape[2]))

        mc_j = sl(mc_p)
        d2_j = sl(d2_p)
        diff = mc - mc_j
        accept = jnp.all(diff * diff <= d2 + d2_j + 1e-20, axis=-1)
        accept = jax.lax.stop_gradient(accept.astype(jnp.float32))
        v_j = jax.lax.dynamic_slice(
            v_p, (dy + r, dx + r), (H, W))
        logw = ds_factor * (dy * dy + dx * dx).astype(jnp.float32)
        if gb_p is not None:
            dg = gbufs - sl(gb_p)
            logw = logw + jnp.sum(gbf * dg * dg, axis=-1)
        w = jnp.exp(logw) * accept * v_j
        return wsum + w, fsum + w[..., None] * sl(fm_p)

    wsum0 = jnp.zeros((H, W))
    fsum0 = jnp.zeros((H, W) + film_mean.shape[-1:])
    wsum, fsum = jax.lax.fori_loop(0, side * side, body, (wsum0, fsum0))
    return fsum / jnp.maximum(wsum, 1e-20)[..., None]
