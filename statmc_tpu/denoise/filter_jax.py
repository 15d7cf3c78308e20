"""Statistical joint-bilateral denoising filter (XLA reference impl).

Re-derivation of the out-of-tree CUDA kernel
`cv::cuda::stat_denoiser::filter` (see SURVEY.md §2.4: the submodule is
not mounted; interface + algorithm reconstructed from the call site
/root/reference/src/statistics/estimator.cpp:427-489, the README
"Buffer System" section, and the paper):

For every pixel i and neighbor j in a (2*radius+1)^2 window the filter
decides whether i and j estimate the *same* underlying radiance via a
per-channel two-sample test on the Box-Cox-transformed sample moments:

  mean_corr = mean + m3hat / (6 * s^2 * n)        (Johnson 1978
      skewness-corrected mean; m3hat = M3/n, s^2 = M2/(n-1))
  disc      = t_{1-alpha/2}(n-1) * sqrt(s^2 / n)  (the per-pixel
      "discriminator": the half-width of the corrected-mean confidence
      interval, supplementary §B)
  accept(i,j) = all_channels |mean_corr_i - mean_corr_j|
                    <= sqrt(disc_i^2 + disc_j^2)

Accepted neighbors are weighted by the spatial Gaussian
exp(filterDSFactor * d^2) with filterDSFactor = -0.5/sigma_s^2
(estimator.h:259) and joint-bilateral G-buffer range factors
exp(-0.5/sigma_r^2 * ||g_i - g_j||^2) (README filterbuffersds), and the
*untransformed* film means are averaged:

  film_mean_f_i = sum_j w_ij film_mean_j / sum_j w_ij

With MEMFNC=1 the reference swaps in Moon et al. [2013] confidence
intervals: the same structure on untransformed means without the
skewness correction -- exposed here as `moon_ci=True`.

This module is the correctness reference (the CPU path); the GPU kernel
with identical semantics lives in filter_pallas.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.backend import use_kernel
from .ttest import MAX_DF, quantile_table

Array = jax.Array


def _pad(img, r):
    """Zero-pad [H,W,C] by r on both spatial axes."""
    return jnp.pad(img, ((r, r), (r, r), (0, 0)))


@partial(jax.jit, static_argnames=("radius", "moon_ci"))
def stat_filter(
    n: Array,  # [H,W] sample counts
    mean: Array,  # [H,W,C] mean of (transformed) samples
    m2: Array,  # [H,W,C]
    m3: Array,  # [H,W,C]
    film_mean: Array,  # [H,W,C] mean of raw samples
    gbufs: Array,  # [G,H,W,3] G-buffer means (zero-padded channels)
    gb_factors: Array,  # [G] -0.5/sigma_r^2
    ds_factor: Array,  # scalar -0.5/sigma_s^2
    tq: Array,  # [MAX_DF+1] t critical values
    radius: int,
    film_img: Array | None = None,  # [H,W,3] actual film (Radiance b0)
    moon_ci: bool = False,
    valid: Array | None = None,  # [H,W] 0/1 neighbor validity (halo mask)
):
    """Returns dict(mean_corr, discriminator, film_mean_f, weight_sum
    [H,W][, film_f])."""
    H, W, C = mean.shape
    r = radius
    mean_corr, disc = corrected_stats(
        n, film_mean if moon_ci else mean, m2, m3, tq, moon_ci)

    # Padded fields.
    mc_p = _pad(mean_corr, r)
    d2_p = _pad(disc * disc, r)
    fm_p = _pad(film_mean, r)
    base_valid = jnp.ones((H, W, 1)) if valid is None else valid[..., None]
    valid_p = _pad(base_valid, r)
    G = gbufs.shape[0]
    gb_p = jnp.stack([_pad(gbufs[g], r) for g in range(G)]) \
        if G else jnp.zeros((0, H + 2 * r, W + 2 * r, 3))
    film_p = _pad(film_img, r) if film_img is not None else None

    side = 2 * r + 1
    d2_self = disc * disc

    def body(k, acc):
        wsum, fsum, filmsum = acc
        dy = k // side - r
        dx = k % side - r
        oy = dy + r
        ox = dx + r

        def sl(img):
            return jax.lax.dynamic_slice(
                img, (oy, ox, 0), (H, W, img.shape[2])
            )

        mc_j = sl(mc_p)
        d2_j = sl(d2_p)
        fm_j = sl(fm_p)
        v_j = sl(valid_p)[..., 0]

        diff = mean_corr - mc_j
        accept = jnp.all(
            diff * diff <= d2_self + d2_j + 1e-20, axis=-1
        )

        w = jnp.exp(ds_factor * (dy * dy + dx * dx).astype(jnp.float32))
        rw = jnp.zeros((H, W))
        for g in range(G):
            dg = gbufs[g] - jax.lax.dynamic_slice(
                gb_p[g], (oy, ox, 0), (H, W, 3)
            )
            rw = rw + gb_factors[g] * jnp.sum(dg * dg, axis=-1)
        w = w * jnp.exp(rw) * accept * v_j

        wsum = wsum + w
        fsum = fsum + w[..., None] * fm_j
        if film_p is not None:
            filmsum = filmsum + w[..., None] * sl(film_p)
        return wsum, fsum, filmsum

    wsum0 = jnp.zeros((H, W))
    fsum0 = jnp.zeros((H, W, C))
    filmsum0 = jnp.zeros((H, W, 3)) if film_img is not None else jnp.zeros((1,))
    wsum, fsum, filmsum = jax.lax.fori_loop(
        0, side * side, body, (wsum0, fsum0, filmsum0)
    )

    wsafe = jnp.maximum(wsum, 1e-20)[..., None]
    film_mean_f = fsum / wsafe
    out = dict(
        mean_corr=mean_corr, discriminator=disc, film_mean_f=film_mean_f,
        weight_sum=wsum,
    )
    if film_img is not None:
        out["film_f"] = filmsum / wsafe
    return out


def corrected_stats(n, mean, m2, m3, tq, moon_ci: bool = False):
    """Johnson-corrected means + discriminator (CI half width) per pixel.

    Shared by both filter implementations; elementwise, XLA-fused.
    With moon_ci the caller passes the untransformed film mean as
    `mean` and no skewness correction applies.
    Returns (mean_corr, disc) with shapes of `mean`.
    """
    nf = jnp.maximum(n, 1.0)[..., None]
    s2 = m2 / jnp.maximum(nf - 1.0, 1.0)
    if moon_ci:
        mean_corr = mean
    else:
        m3hat = m3 / nf
        corr = m3hat / jnp.maximum(6.0 * s2 * nf, 1e-12)
        corr = jnp.where(s2 > 1e-12, corr, 0.0)
        mean_corr = mean + corr
    sem = jnp.sqrt(jnp.maximum(s2 / nf, 0.0))
    df = jnp.clip(n - 1.0, 0.0, float(MAX_DF)).astype(jnp.int32)
    tcrit = tq[df][..., None]
    return mean_corr, tcrit * sem


class StatDenoiser:
    """Drives the filter over every DenoiseGroup buffer -- the functional
    analogue of Estimator::Denoise (estimator.cpp:427-489)."""

    def __init__(self, ecfg, width: int, height: int, alpha: float = 0.005,
                 moon_ci: bool = False):
        from ..stats import estimator as E

        self.E = E
        self.ecfg = ecfg
        self.W, self.H = width, height
        self.alpha = alpha
        self.moon_ci = moon_ci
        self.tq = jnp.asarray(quantile_table(alpha))
        self.ds_factor = jnp.asarray(
            -0.5 / (ecfg.filter_sd * ecfg.filter_sd), jnp.float32
        )
        self.radius = int(ecfg.filter_radius)

    def _gbuffers(self, states, height=None):
        """Collect enabled filter G-buffer means.

        Returns (stacked [G,H,W,3], per-buffer factors [G],
                 planes [H,W,Gp], per-plane factors tuple).
        height overrides self.H (sharded denoise: local row slab).
        """
        E = self.E
        H = self.H if height is None else height
        gb, factors, planes, pfac = [], [], [], []
        for t in (E.STAT_MATERIAL_ID, E.STAT_DEPTH, E.STAT_NORMAL,
                  E.STAT_ALBEDO):
            c = self.ecfg.configs[t]
            if c.enable and c.enable_for_filter and t in states:
                # Stays on device: no host round trip per buffer.
                fm = states[t].get("film_mean", states[t]["mean"])[0]
                img = fm.reshape(H, self.W, c.n_channels)
                fac = -0.5 / (c.filter_sd * c.filter_sd)
                planes.append(img)
                pfac.extend([fac] * c.n_channels)
                if c.n_channels == 1:
                    img = jnp.concatenate(
                        [img, jnp.zeros((H, self.W, 2))], -1
                    )
                gb.append(img)
                factors.append(fac)
        if gb:
            return (jnp.stack(gb), jnp.asarray(factors, jnp.float32),
                    jnp.concatenate(planes, -1), tuple(pfac))
        return (jnp.zeros((0, H, self.W, 3)),
                jnp.zeros((0,), jnp.float32),
                jnp.zeros((H, self.W, 0)), ())

    def __call__(self, state, cfg_type, film, width, height, gbufs=None,
                 halo=None):
        """Filter all bounce buffers of one stat type.

        state: MomentState [NB,P,C]; film: [H,W,3] actual film image for
        Radiance (or None).  Returns derived buffers [NB,P,C] + film_f.
        gbufs overrides the prepare_gbuffers cache (pass explicitly when
        tracing under an outer jit -- the cache must never hold tracers).
        halo: optional exchange fn ([h,W,C] -> [h+2r,W,C]); when set,
        this call runs on a LOCAL row slab under shard_map — every field
        is halo-extended before filtering and outputs are cropped back
        (the sharded decomposition of the reference's whole-frame
        launch, estimator.cpp:427-489).
        """
        H, W = height, width
        NB = state["n"].shape[0]
        C = state["mean"].shape[-1]
        if gbufs is None:
            gbufs = getattr(self, "_gb_cache", None)
        if gbufs is None:
            raise RuntimeError("call prepare_gbuffers(states) first")
        gb, gf, gb_planes, gf_planes = gbufs

        r = self.radius
        valid = None
        if halo is not None:
            ex = halo
            valid = ex(jnp.ones((H, W, 1)))[..., 0]
            gb = (jnp.stack([ex(gb[g]) for g in range(gb.shape[0])])
                  if gb.shape[0] else jnp.zeros((0, H + 2 * r, W, 3)))
            gb_planes = (ex(gb_planes) if gb_planes.shape[-1]
                         else jnp.zeros((H + 2 * r, W, 0)))
        else:
            def ex(x):
                return x

        outs = {"mean_corr": [], "discriminator": [], "film_mean_f": []}
        film_f = None
        # Reference aliasing (estimator.cpp:143-146, RGB path): with
        # denoiseFilm on, Radiance b0's film-mean-f buffer IS the
        # filtered film (film-f) -- the reference filters ONE image and
        # aliases, so filtering the film planes separately (CF=2C) is
        # wasted sweep work: film == film-mean for the box filter (both
        # are the per-pixel sample mean; our refparity fixtures pin
        # both).  Alias here and halve the filtered-plane count.
        alias_film = C == 3
        for j in range(NB):
            n_img = state["n"][j, :, 0].reshape(H, W)
            mean = state["mean"][j].reshape(H, W, C)
            m2 = state.get("m2", state["mean"])[j].reshape(H, W, C)
            m3 = state.get("m3", jnp.zeros_like(state["mean"]))[j].reshape(
                H, W, C)
            fm = state.get("film_mean", state["mean"])[j].reshape(H, W, C)
            fi = film if (film is not None and j == 0) else None
            if fi is not None and alias_film:
                fi = None
                want_film_alias = True
            else:
                want_film_alias = False
            res = self._filter(
                ex(n_img[..., None])[..., 0], ex(mean), ex(m2), ex(m3),
                ex(fm), gb, gf, gb_planes, gf_planes,
                None if fi is None else ex(fi), valid)
            if halo is not None:
                res = {k: v[r:r + H] for k, v in res.items()}
            outs["mean_corr"].append(res["mean_corr"].reshape(-1, C))
            outs["discriminator"].append(res["discriminator"].reshape(-1, C))
            outs["film_mean_f"].append(res["film_mean_f"].reshape(-1, C))
            if fi is not None:
                film_f = res["film_f"]
            elif want_film_alias:
                film_f = res["film_mean_f"].reshape(H, W, C)
        return {
            "mean_corr": jnp.stack(outs["mean_corr"]),
            "discriminator": jnp.stack(outs["discriminator"]),
            "film_mean_f": jnp.stack(outs["film_mean_f"]),
            "film_f": film_f,
        }

    def _filter(self, n_img, mean, m2, m3, fm, gb, gf, gb_planes, gf_planes,
                film, valid):
        """One bounce buffer through the kernel (GPU) or stat_filter
        (CPU); same outputs as stat_filter."""
        if not use_kernel("denoise"):
            return stat_filter(
                n_img, mean, m2, m3, fm, gb, gf, self.ds_factor, self.tq,
                self.radius, film_img=film, moon_ci=self.moon_ci,
                valid=valid,
            )
        from .filter_pallas import _run_filter

        H, W, C = mean.shape
        mc, disc = corrected_stats(
            n_img, fm if self.moon_ci else mean, m2, m3, self.tq,
            self.moon_ci)
        fstack = fm if film is None else jnp.concatenate([fm, film], -1)
        out, _ = _run_filter(
            mc, disc * disc, fstack, gb_planes,
            jnp.ones((H, W)) if valid is None else valid, self.radius,
            float(self.ds_factor), gf_planes,
        )
        res = {"mean_corr": mc, "discriminator": disc,
               "film_mean_f": out[..., :C]}
        if film is not None:
            res["film_f"] = out[..., C:]
        return res

    def prepare_gbuffers(self, states):
        self._gb_cache = self._gbuffers(states)
