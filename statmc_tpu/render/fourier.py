"""FourierBSDF: tabulated BSDF reader + wavefront evaluation.

Replaces the reference's FourierBSDFTable machinery
(src/materials/fourier.cpp:116-206 Read, src/core/reflection.cpp:322-377
FourierBSDF::f, src/core/interpolation.cpp:61-103 CatmullRomWeights,
:348-361 Fourier) with a wavefront shape:

* the on-disk SCATFUN v1 format is parsed bit-exactly (same header,
  same subset restrictions: flags==1, 1 or 3 channels, nBases==1);
* the variable-length per-(muI, muO) coefficient lists are PADDED into
  one dense [nMu, nMu, nCh, M] block so a ray batch can gather its
  4x4 Catmull-Rom neighborhood with plain vectorized takes -- the
  reference walks a ragged offset table per intersection
  (reflection.cpp:341-355), which is pointer-chasing a lockstep wavefront cannot do;
* series longer than M_CAP are truncated (energy in high-order cosine
  terms of near-specular tables; a warning reports the dropped tail).

Evaluation math matches reflection.cpp:322-377 exactly: Catmull-Rom
weights in muI/muO including the one-sided boundary stencils, Fourier
cosine series in the azimuth difference, Y/R/B channel layout with the
green reconstruction G = 1.39829 Y - 0.100913 B - 0.297375 R, the
1/|muI| scale, and the radiance-mode eta^2 adjoint factor.

Sampling: fourier lanes importance-sample their own tabulated
distribution (sample_wi/pdf_wi below): SampleCatmullRom2D inversion of
the interpolated muI marginal CDF + SampleFourier Newton-bisection of
the azimuth series (interpolation.cpp:217-290, 292-361,
reflection.cpp:379-480), run as FIXED-iteration branch-free loops over
all lanes.  Near-specular tables (alum.bsdf-class) therefore sample
their own lobes instead of a broad proposal.
"""
from __future__ import annotations

import struct
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

M_CAP = 64  # dense padded Fourier-order cap (see module docstring)

_HEADER = b"SCATFUN\x01"


class FourierFile(NamedTuple):
    """Host-side parse of one .bsdf file (numpy)."""
    mu: np.ndarray      # [nMu] zenith cosine nodes (ascending)
    cdf: np.ndarray     # [nMu, nMu] marginal CDF (sampling)
    m: np.ndarray       # [nMu, nMu] int series length per node pair
    ak: np.ndarray      # [nMu, nMu, nCh, M] dense padded coefficients
    eta: float
    n_channels: int
    m_max: int          # the file's true mMax (before padding/truncation)


def read_bsdf(path: str, m_cap: int = M_CAP) -> FourierFile:
    """Parse a SCATFUN v1 .bsdf file (materials/fourier.cpp:116-206)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _HEADER:
        raise ValueError(f"{path}: not a SCATFUN v1 file")
    ints = np.frombuffer(data, dtype="<i4", offset=8, count=9)
    flags, n_mu, n_coeffs, m_max, n_channels, n_bases = ints[:6]
    (eta,) = struct.unpack_from("<f", data, 8 + 9 * 4)
    # 4 more unused int32 slots follow eta (fourier.cpp:158-162).
    off = 8 + 9 * 4 + 4 + 4 * 4
    if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
        raise ValueError(
            f"{path}: unsupported SCATFUN variant (flags={flags}, "
            f"channels={n_channels}, bases={n_bases})")
    mu = np.frombuffer(data, dtype="<f4", offset=off, count=n_mu)
    off += 4 * n_mu
    cdf = np.frombuffer(data, dtype="<f4", offset=off,
                        count=n_mu * n_mu).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    ol = np.frombuffer(data, dtype="<i4", offset=off,
                       count=n_mu * n_mu * 2).reshape(n_mu * n_mu, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(data, dtype="<f4", offset=off, count=n_coeffs)

    m_arr = ol[:, 1].reshape(n_mu, n_mu)
    M = min(int(m_max), m_cap) if m_max > 0 else 1
    ak = np.zeros((n_mu, n_mu, n_channels, M), np.float32)
    dropped = 0.0
    for i in range(n_mu * n_mu):
        offset, length = int(ol[i, 0]), int(ol[i, 1])
        if length <= 0:
            continue
        take = min(length, M)
        # per-pair layout is [nCh, m] contiguous (reflection.cpp:352).
        blk = a[offset:offset + n_channels * length].reshape(
            n_channels, length)
        ak[i // n_mu, i % n_mu, :, :take] = blk[:, :take]
        if length > M:
            dropped = max(dropped, float(np.abs(blk[:, M:]).max()))
    if dropped > 0:
        import logging
        logging.getLogger("statmc_tpu.fourier").warning(
            "%s: Fourier series truncated at %d orders "
            "(largest dropped coefficient %.3g)", path, M, dropped)
    return FourierFile(mu=np.asarray(mu, np.float32),
                       cdf=np.asarray(cdf, np.float32),
                       m=np.minimum(m_arr, M).astype(np.int32),
                       ak=ak, eta=float(eta), n_channels=int(n_channels),
                       m_max=int(m_max))


def write_bsdf(path: str, mu: np.ndarray, ak_list, eta: float = 1.0,
               n_channels: int = 1) -> None:
    """Write a SCATFUN v1 file (test/tool generator; inverse of
    read_bsdf, format per materials/fourier.cpp:148-186).

    ak_list: nested [nMu][nMu] -> [nCh, m] float arrays (m may vary)."""
    n_mu = len(mu)
    coeffs, offlen = [], []
    off = 0
    m_max = 0
    for i in range(n_mu):
        for o in range(n_mu):
            blk = np.asarray(ak_list[i][o], np.float32).reshape(
                n_channels, -1)
            m = blk.shape[1] if blk.size else 0
            if m and not np.any(blk):
                m = 0
            offlen.append((off, m))
            if m:
                coeffs.append(blk[:, :m].reshape(-1))
                off += n_channels * m
                m_max = max(m_max, m)
    a = (np.concatenate(coeffs) if coeffs
         else np.zeros((0,), np.float32))
    # Marginal CDF rows per muO: IntegrateCatmullRom of the order-0
    # luminance coefficient over muI (interpolation.cpp:293-322) -- the
    # table the importance sampler inverts, so it must be the true
    # integral of the a0 spline.
    # ak_list is [muO][muI]-major (file pair order, reflection.h:166):
    # cdf row o must integrate a0 ALONG muI at fixed muO.
    a0 = np.zeros((n_mu, n_mu), np.float64)
    for o in range(n_mu):
        for i in range(n_mu):
            blk = np.asarray(ak_list[o][i], np.float64).reshape(
                n_channels, -1)
            a0[o, i] = blk[0, 0] if blk.size else 0.0
    x = np.asarray(mu, np.float64)
    cdf = np.zeros((n_mu, n_mu), np.float64)
    for o in range(n_mu):
        vals = a0[o]
        for i in range(n_mu - 1):
            x0, x1 = x[i], x[i + 1]
            f0, f1 = vals[i], vals[i + 1]
            width = x1 - x0
            d0 = (width * (f1 - vals[i - 1]) / (x1 - x[i - 1])
                  if i > 0 else f1 - f0)
            d1 = (width * (vals[i + 2] - f0) / (x[i + 2] - x0)
                  if i + 2 < n_mu else f1 - f0)
            cdf[o, i + 1] = cdf[o, i] + (
                (d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
        # The Hermite integral of a DISCONTINUOUS profile (reflection
        # tables step to zero across muI=0) can dip locally; the
        # inversion requires a monotone cdf.
        cdf[o] = np.maximum.accumulate(cdf[o])
    cdf = cdf.astype(np.float32)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(np.asarray(
            [1, n_mu, a.size, m_max, n_channels, 1, 0, 0, 0],
            "<i4").tobytes())
        f.write(struct.pack("<f", eta))
        f.write(np.zeros(4, "<i4").tobytes())
        f.write(np.asarray(mu, "<f4").tobytes())
        f.write(np.asarray(cdf, "<f4").tobytes())
        f.write(np.asarray(offlen, "<i4").tobytes())
        f.write(np.asarray(a, "<f4").tobytes())


class FourierTables(NamedTuple):
    """Stacked device tables for every fourier material in a scene.

    Tables are padded to the largest (nMu, M) among them; `n_mu` keeps
    each table's true node count (padded mu nodes repeat the last node
    so searchsorted never lands in them)."""
    mu: Any      # [F, nMuP]
    n_mu: Any    # [F] int32
    ak: Any      # [F, nMuP, nMuP, 3, MP]  (1-channel files replicated)
    eta: Any     # [F]
    n_channels: Any  # [F] int32
    # Importance-sampling tables (reflection.cpp:379-427 Sample_f/Pdf):
    cdf: Any = None   # [F, nMuP, nMuP] marginal CDF rows (muO-major)
    a0: Any = None    # [F, nMuP, nMuP] order-0 luminance coefficient


def stack_tables(files: list[FourierFile]) -> FourierTables:
    F = len(files)
    n_mu_p = max(f.mu.shape[0] for f in files)
    m_p = max(f.ak.shape[-1] for f in files)
    mu = np.zeros((F, n_mu_p), np.float32)
    ak = np.zeros((F, n_mu_p, n_mu_p, 3, m_p), np.float32)
    n_mu = np.zeros((F,), np.int32)
    eta = np.zeros((F,), np.float32)
    nch = np.zeros((F,), np.int32)
    cdf = np.zeros((F, n_mu_p, n_mu_p), np.float32)
    for i, fl in enumerate(files):
        n = fl.mu.shape[0]
        mu[i, :n] = fl.mu
        mu[i, n:] = fl.mu[-1] + 1.0  # out-of-range guard nodes
        a = fl.ak
        if fl.n_channels == 1:
            a = np.repeat(a, 3, axis=2)
        ak[i, :n, :n, :, :a.shape[-1]] = a
        cdf[i, :n, :n] = fl.cdf
        # Pad columns with the row maximum so FindInterval never lands
        # past the true node range.
        if n < n_mu_p:
            cdf[i, :n, n:] = fl.cdf[:, -1:]
        n_mu[i] = n
        eta[i] = fl.eta
        nch[i] = fl.n_channels
    a0 = ak[:, :, :, 0, 0]  # Y-channel order-0 coefficient (muO-major)
    return FourierTables(mu=jnp.asarray(mu), n_mu=jnp.asarray(n_mu),
                         ak=jnp.asarray(ak), eta=jnp.asarray(eta),
                         n_channels=jnp.asarray(nch),
                         cdf=jnp.asarray(cdf),
                         a0=jnp.asarray(np.ascontiguousarray(a0)))


def _catmull_rom_weights(nodes: Array, n: Array, x: Array):
    """Vectorized CatmullRomWeights (interpolation.cpp:61-103).

    nodes: [R, nMuP] per-lane node row; n: [R] true node count;
    x: [R].  Returns (offset [R] int32, weights [R, 4], ok [R])."""
    R = x.shape[0]
    nP = nodes.shape[1]
    first = nodes[:, 0]
    last = jnp.take_along_axis(nodes, (n - 1)[:, None], axis=1)[:, 0]
    # Frame rotations leave |cos| a few ulp beyond 1.0; pbrt's exact
    # bounds test would zero those SAMPLES (visible as darkened film
    # pixels wherever a ray direction rounds past a node), so tolerate
    # 1e-5 of numeric overhang and clamp into the node range.
    ok = (x >= first - 1e-5) & (x <= last + 1e-5)
    x = jnp.clip(x, first, last)
    # FindInterval: largest idx with nodes[idx] <= x, clamped to
    # [1, n-2] exactly like pbrt's FindInterval + offset = idx - 1.
    le = (nodes <= x[:, None]) & (
        jnp.arange(nP)[None, :] < n[:, None])
    idx = jnp.sum(le, axis=1) - 1
    idx = jnp.clip(idx, 0, jnp.maximum(n - 2, 0))
    x0 = jnp.take_along_axis(nodes, idx[:, None], axis=1)[:, 0]
    x1 = jnp.take_along_axis(nodes, jnp.minimum(idx + 1, n - 1)[:, None],
                             axis=1)[:, 0]
    t = (x - x0) / jnp.where(x1 > x0, x1 - x0, 1.0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    # First node weight (one-sided at the boundary).
    xm1 = jnp.take_along_axis(nodes, jnp.maximum(idx - 1, 0)[:, None],
                              axis=1)[:, 0]
    w0_in = (t3 - 2 * t2 + t) * (x1 - x0) / jnp.where(
        x1 > xm1, x1 - xm1, 1.0)
    w0_edge = t3 - 2 * t2 + t
    has_m1 = idx > 0
    w0 = jnp.where(has_m1, -w0_in, 0.0)
    w1 = jnp.where(has_m1, w1, w1 - w0_edge)
    w2 = w2 + jnp.where(has_m1, w0_in, w0_edge)
    # Last node weight.
    xp2 = jnp.take_along_axis(nodes, jnp.minimum(idx + 2, n - 1)[:, None],
                              axis=1)[:, 0]
    w3_in = (t3 - t2) * (x1 - x0) / jnp.where(xp2 > x0, xp2 - x0, 1.0)
    w3_edge = t3 - t2
    has_p2 = idx + 2 < n
    w1 = w1 - jnp.where(has_p2, w3_in, w3_edge)
    w2 = w2 + jnp.where(has_p2, 0.0, w3_edge)
    w3 = jnp.where(has_p2, w3_in, 0.0)
    weights = jnp.stack([w0, w1, w2, w3], axis=-1)
    return (idx - 1).astype(jnp.int32), weights, ok


def eval_f(tab: FourierTables, fid: Array, wo: Array, wi: Array) -> Array:
    """FourierBSDF::f over lanes (reflection.cpp:322-377).

    fid: [R] table index (lanes with fid < 0 return 0); wo/wi: [R, 3]
    local shading frame.  Returns RGB f [R, 3]."""
    R = wo.shape[0]
    f = jnp.maximum(fid, 0)
    mu_rows = jnp.take(tab.mu, f, axis=0)          # [R, nMuP]
    n_rows = jnp.take(tab.n_mu, f, axis=0)         # [R]
    mu_i = -wi[:, 2]
    mu_o = wo[:, 2]
    # CosDPhi(-wi, wo) (geometry.h): azimuth-difference cosine.
    num = wi[:, 0] * wo[:, 0] + wi[:, 1] * wo[:, 1]
    den2 = ((wi[:, 0] ** 2 + wi[:, 1] ** 2)
            * (wo[:, 0] ** 2 + wo[:, 1] ** 2))
    cos_phi = jnp.where(den2 > 1e-20,
                        jnp.clip(-num / jnp.sqrt(jnp.maximum(den2, 1e-20)),
                                 -1.0, 1.0),
                        1.0)
    oi, wI, okI = _catmull_rom_weights(mu_rows, n_rows, mu_i)
    oo, wO, okO = _catmull_rom_weights(mu_rows, n_rows, mu_o)
    ok = okI & okO & (fid >= 0)

    MP = tab.ak.shape[-1]
    nP = tab.ak.shape[1]
    ak_flat = tab.ak.reshape(tab.ak.shape[0] * nP * nP, 3, MP)
    acc = jnp.zeros((R, 3, MP))
    for b in range(4):
        for a in range(4):
            w = (wI[:, a] * wO[:, b])[:, None, None]
            ii = jnp.clip(oi + a, 0, nP - 1)
            jj = jnp.clip(oo + b, 0, nP - 1)
            # File layout is [muO, muI]-major: GetAk reads
            # m[offsetO * nMu + offsetI] (reflection.h:166-169).
            rows = jnp.take(ak_flat, (f * nP + jj) * nP + ii, axis=0)
            acc = acc + w * rows
    phi = jnp.arccos(cos_phi)
    cosk = jnp.cos(jnp.arange(MP)[None, :] * phi[:, None])  # [R, MP]
    sums = jnp.sum(acc * cosk[:, None, :], axis=-1)          # [R, 3] Y,R,B
    Y = jnp.maximum(sums[:, 0], 0.0)
    scale = jnp.where(jnp.abs(mu_i) > 1e-12, 1.0 / jnp.abs(mu_i), 0.0)
    # Radiance-transport adjoint factor (reflection.cpp:361-365).
    eta_t = jnp.take(tab.eta, f, axis=0)
    same_side = mu_i * mu_o > 0
    eta_f = jnp.where(mu_i > 0, 1.0 / eta_t, eta_t)
    scale = scale * jnp.where(same_side, eta_f * eta_f, 1.0)
    nch = jnp.take(tab.n_channels, f, axis=0)
    Rc = sums[:, 1]
    Bc = sums[:, 2]
    G = 1.39829 * Y - 0.100913 * Bc - 0.297375 * Rc
    rgb = jnp.stack([Rc, G, Bc], axis=-1)
    mono = jnp.broadcast_to(Y[:, None], rgb.shape)
    out = jnp.where((nch == 1)[:, None], mono, rgb)
    out = jnp.maximum(out * scale[:, None], 0.0)
    return jnp.where(ok[:, None], out, 0.0)


def lambertian_file(albedo, n_mu: int = 16) -> tuple[np.ndarray, list]:
    """(mu nodes, ak_list) for an ideal Lambertian reflector: the
    azimuth-constant series a_0 = rho/pi * |muI| (the table stores
    f * |muI|, cf. the 1/|muI| scale in reflection.cpp:359).

    Conventions baked in: muI = CosTheta(-wi), so REFLECTION entries
    live where muI and muO have opposite signs; 3-channel files store
    [Y, R, B] with G reconstructed at eval (reflection.cpp:369-373);
    ak_list is [muO][muI]-major like the file (reflection.h:166)."""
    albedo = np.atleast_1d(np.asarray(albedo, np.float32))
    if albedo.shape[0] == 3:
        y = (0.212671 * albedo[0] + 0.715160 * albedo[1]
             + 0.072169 * albedo[2])
        chans = np.array([y, albedo[0], albedo[2]], np.float32)
    else:
        chans = albedo
    nch = chans.shape[0]
    mu = np.linspace(-1.0, 1.0, n_mu, dtype=np.float32)
    ak = [[np.zeros((nch, 1), np.float32) for _ in range(n_mu)]
          for _ in range(n_mu)]
    for o, mo in enumerate(mu):
        for i, mi in enumerate(mu):
            if mi * mo < 0:  # reflection side
                ak[o][i] = (chans[:, None] / np.pi
                            * np.float32(abs(mi)))
    return mu, ak


# ---------------------------------------------------------------------------
# Importance sampling (reflection.cpp:379-427 FourierBSDF::Sample_f/Pdf,
# interpolation.cpp:217-290 SampleCatmullRom2D, :292-361 SampleFourier).
# Newton-bisection loops run a FIXED iteration count over all lanes --
# the branch-free wavefront shape of pbrt's while-loops; 16 iterations halve
# the bracket to ~1e-5, matching pbrt's 1e-6 break in practice.
# ---------------------------------------------------------------------------


def _interp_over_muo(flat_rows, f, oo, wO, nP):
    """sum_b wO[:, b] * table[f, clip(oo+b), :] for a [F*nP, nP] flat
    table -- the `interpolate` lambda of SampleCatmullRom2D."""
    out = 0.0
    for b in range(4):
        rows = jnp.take(flat_rows,
                        f * nP + jnp.clip(oo + b, 0, nP - 1), axis=0)
        out = out + wO[:, b:b + 1] * rows
    return out


def sample_mu_i(tab: FourierTables, fid: Array, mu_o: Array, u: Array):
    """SampleCatmullRom2D over the muI marginal: returns
    (mu_i [R], pdf_mu [R], ok [R])."""
    R = mu_o.shape[0]
    f = jnp.maximum(fid, 0)
    nP = tab.mu.shape[1]
    mu_rows = jnp.take(tab.mu, f, axis=0)
    n_rows = jnp.take(tab.n_mu, f, axis=0)
    oo, wO, okO = _catmull_rom_weights(mu_rows, n_rows, mu_o)

    cdf_flat = tab.cdf.reshape(-1, nP)
    a0_flat = tab.a0.reshape(-1, nP)
    cdf_i = _interp_over_muo(cdf_flat, f, oo, wO, nP)   # [R, nP]
    a0_i = _interp_over_muo(a0_flat, f, oo, wO, nP)

    maximum = jnp.take_along_axis(cdf_i, (n_rows - 1)[:, None],
                                  axis=1)[:, 0]
    ok = okO & (maximum > 0)
    uu = u * maximum
    valid_col = jnp.arange(nP)[None, :] < n_rows[:, None]
    le = (cdf_i <= uu[:, None]) & valid_col
    idx = jnp.clip(jnp.sum(le, axis=1) - 1, 0, jnp.maximum(n_rows - 2, 0))

    take = lambda arr, i: jnp.take_along_axis(
        arr, jnp.clip(i, 0, nP - 1)[:, None], axis=1)[:, 0]
    f0 = take(a0_i, idx)
    f1 = take(a0_i, idx + 1)
    x0 = take(mu_rows, idx)
    x1 = take(mu_rows, idx + 1)
    width = jnp.maximum(x1 - x0, 1e-12)
    uu = (uu - take(cdf_i, idx)) / width
    d0 = jnp.where(idx > 0,
                   width * (f1 - take(a0_i, idx - 1))
                   / jnp.maximum(x1 - take(mu_rows, idx - 1), 1e-12),
                   f1 - f0)
    d1 = jnp.where(idx + 2 < n_rows,
                   width * (take(a0_i, idx + 2) - f0)
                   / jnp.maximum(take(mu_rows, idx + 2) - x0, 1e-12),
                   f1 - f0)

    # Hermite-segment inversion (interpolation.cpp:246-286).
    t = jnp.where(
        jnp.abs(f0 - f1) > 1e-12,
        (f0 - jnp.sqrt(jnp.maximum(
            0.0, f0 * f0 + 2.0 * uu * (f1 - f0)))) /
        jnp.where(jnp.abs(f0 - f1) > 1e-12, f0 - f1, 1.0),
        uu / jnp.maximum(f0, 1e-12))
    a = jnp.zeros((R,))
    b = jnp.ones((R,))
    fhat = f0
    for _ in range(16):
        t = jnp.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (0.5 * d0
                              + t * ((1.0 / 3.0) * (-2 * d0 - d1)
                                     + f1 - f0
                                     + t * (0.25 * (d0 + d1)
                                            + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        below = Fhat - uu < 0
        a = jnp.where(below, t, a)
        b = jnp.where(below, b, t)
        t = t - (Fhat - uu) / jnp.where(jnp.abs(fhat) > 1e-12, fhat, 1.0)
    pdf_mu = jnp.where(ok, jnp.maximum(fhat, 0.0)
                       / jnp.maximum(maximum, 1e-20), 0.0)
    return x0 + width * jnp.clip(t, 0.0, 1.0), pdf_mu, ok


def _luminance_ak(tab: FourierTables, f, mu_i, mu_o):
    """4x4-interpolated Y-channel coefficient vector [R, MP] + ok."""
    nP = tab.mu.shape[1]
    MP = tab.ak.shape[-1]
    mu_rows = jnp.take(tab.mu, f, axis=0)
    n_rows = jnp.take(tab.n_mu, f, axis=0)
    oi, wI, okI = _catmull_rom_weights(mu_rows, n_rows, mu_i)
    oo, wO, okO = _catmull_rom_weights(mu_rows, n_rows, mu_o)
    akY_flat = tab.ak[:, :, :, 0, :].reshape(-1, MP)
    acc = jnp.zeros((mu_i.shape[0], MP))
    for b in range(4):
        for a in range(4):
            w = (wI[:, a] * wO[:, b])[:, None]
            ii = jnp.clip(oi + a, 0, nP - 1)
            jj = jnp.clip(oo + b, 0, nP - 1)
            acc = acc + w * jnp.take(akY_flat, (f * nP + jj) * nP + ii,
                                     axis=0)
    return acc, okI & okO, oo, wO


def _sample_fourier_phi(akY: Array, u: Array):
    """SampleFourier (interpolation.cpp:292-361): invert
    F(phi) = a0 phi + sum ak sin(k phi)/k on [0, pi]."""
    R, MP = akY.shape
    flip = u >= 0.5
    uu = jnp.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    ks = jnp.arange(MP, dtype=jnp.float32)
    recip = jnp.where(ks > 0, 1.0 / jnp.maximum(ks, 1.0), 0.0)
    a = jnp.zeros((R,))
    b = jnp.full((R,), jnp.pi)
    phi = jnp.full((R,), 0.5 * jnp.pi)
    a0 = akY[:, 0]
    fv = a0
    for _ in range(20):
        kphi = ks[None, :] * phi[:, None]
        F = a0 * phi + jnp.sum(akY[:, 1:] * recip[None, 1:]
                               * jnp.sin(kphi[:, 1:]), axis=1)
        fv = jnp.sum(akY * jnp.cos(kphi), axis=1)
        F = F - uu * a0 * jnp.pi
        hi = F > 0
        b = jnp.where(hi, phi, b)
        a = jnp.where(hi, a, phi)
        step = phi - F / jnp.where(jnp.abs(fv) > 1e-12, fv, 1.0)
        inb = (step > a) & (step < b) & jnp.isfinite(step)
        phi = jnp.where(inb, step, 0.5 * (a + b))
    pdf_phi = jnp.where(a0 > 0, (0.5 / jnp.pi) * fv
                        / jnp.maximum(a0, 1e-20), 0.0)
    phi = jnp.where(flip, 2.0 * jnp.pi - phi, phi)
    return phi, jnp.maximum(pdf_phi, 0.0)


def sample_wi(tab: FourierTables, fid: Array, wo: Array, u2: Array):
    """FourierBSDF::Sample_f direction (reflection.cpp:429-480):
    returns (wi [R,3], pdf [R])."""
    mu_o = wo[:, 2]
    mu_i, pdf_mu, ok_mu = sample_mu_i(tab, jnp.maximum(fid, 0), mu_o,
                                      u2[:, 1])
    f = jnp.maximum(fid, 0)
    akY, ok_ak, _, _ = _luminance_ak(tab, f, mu_i, mu_o)
    phi, pdf_phi = _sample_fourier_phi(akY, u2[:, 0])
    sin2_i = jnp.maximum(0.0, 1.0 - mu_i * mu_i)
    sin2_o = jnp.maximum(wo[:, 0] ** 2 + wo[:, 1] ** 2, 1e-20)
    norm = jnp.sqrt(sin2_i / sin2_o)
    norm = jnp.where(jnp.isfinite(norm), norm, 0.0)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    wi = -jnp.stack([norm * (cp * wo[:, 0] - sp * wo[:, 1]),
                     norm * (sp * wo[:, 0] + cp * wo[:, 1]),
                     mu_i], axis=-1)
    wi = wi / jnp.maximum(
        jnp.linalg.norm(wi, axis=-1, keepdims=True), 1e-12)
    pdf = jnp.where(ok_mu & ok_ak,
                    jnp.maximum(pdf_mu * pdf_phi, 0.0), 0.0)
    return wi, pdf


def pdf_wi(tab: FourierTables, fid: Array, wo: Array, wi: Array) -> Array:
    """FourierBSDF::Pdf (reflection.cpp:379-427)."""
    f = jnp.maximum(fid, 0)
    nP = tab.mu.shape[1]
    mu_i = -wi[:, 2]
    mu_o = wo[:, 2]
    akY, ok, oo, wO = _luminance_ak(tab, f, mu_i, mu_o)
    # CosDPhi(-wi, wo).
    num = wi[:, 0] * wo[:, 0] + wi[:, 1] * wo[:, 1]
    den2 = ((wi[:, 0] ** 2 + wi[:, 1] ** 2)
            * (wo[:, 0] ** 2 + wo[:, 1] ** 2))
    cos_phi = jnp.where(den2 > 1e-20,
                        jnp.clip(-num / jnp.sqrt(jnp.maximum(den2, 1e-20)),
                                 -1.0, 1.0), 1.0)
    MP = akY.shape[1]
    phi = jnp.arccos(cos_phi)
    Y = jnp.sum(akY * jnp.cos(jnp.arange(MP)[None, :] * phi[:, None]),
                axis=1)
    n_rows = jnp.take(tab.n_mu, f, axis=0)
    cdf_flat = tab.cdf.reshape(-1, nP)
    rho = 0.0
    for b in range(4):
        row = jnp.take(cdf_flat, f * nP + jnp.clip(oo + b, 0, nP - 1),
                       axis=0)
        last = jnp.take_along_axis(row, (n_rows - 1)[:, None],
                                   axis=1)[:, 0]
        rho = rho + wO[:, b] * last * (2.0 * jnp.pi)
    return jnp.where(ok & (rho > 0) & (Y > 0),
                     Y / jnp.maximum(rho, 1e-20), 0.0)
