#!/usr/bin/env python3
"""Proof that the render -> denoise path runs on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the 2x2 mesh phase only

Run it from the repository root.  It drives the system through its own
entry points (driver.load(...).render()) in ONE process, with random
numbers from fixed seeds.

One-card phases, in order:
  1. device   JAX must report a GPU; prints its kind, the device count
              and nvidia-smi's name and power limit.
  2. render   the render-denoise configuration (configs/render-denoise.
              pbrt: filter sigma 10, radius 20, albedo + normal range
              terms) on the procedural staircase proxy, 1280x720, 16 spp,
              maxdepth 8, two iterations with ACRR/SMIS feedback in the
              second; FusedTris accelerator, denoise kernel.
  3. kernels  each kernel against its plain reference at real width:
              the denoise filter on that render's own buffers, the fused
              intersector on its primary rays and one bounce.
  4. terrain  the 131k-triangle terrain, 1280x720, 4 spp, one iteration
              through TwoLevelTris; then the walk kernel against the
              bounded XLA walk on its primary rays and one bounce.
  5. tests    the card-only tests (pytest marker `card`), in this
              process.

Four-card phase: the staircase proxy at 1280x720, 8 spp with the denoise
on a 2x2 ("spp" x "px") mesh, against the one-card render on device 0.

The last line of stdout is one JSON object
{"ok": ..., "device": {"platform": ..., "kind": ..., "count": ...}}.
A failed phase makes "ok" false and the exit code 1.  Without a GPU, or
outside a checkout of the repository, the script prints no result and
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1280, 720
FEEDBACK = '"bool acrr" ["true"] "integer trackedbounces" [3] "bool smis" ["true"] '

# Tolerances of the kernel-versus-reference checks, with their reasons:
# the filter sums 1681 window offsets in another order than the XLA
# sweep and folds the spatial and range terms into one exp, so a pixel
# whose accepted set agrees differs by float rounding only (well under
# 1e-4 relative); a pixel-offset whose two-sample test sits within
# rounding of its threshold may flip, which changes that pixel's weight
# set, so up to FILTER_FLIP_SHARE of the pixels may exceed the bound.
FILTER_RTOL = 1e-4
FILTER_FLIP_SHARE = 1e-3
# Intersectors: the kernels evaluate the bilinear forms as f32 FMAs, the
# references as IEEE f32 dots; a ray can change its triangle only at an
# exact tie (same t, shared edge or vertex) or where an edge product is
# within rounding of zero (grazing hits, which bounce rays leaving a
# surface meet on its neighbouring triangles).  t = num/den with num a
# difference of plane offsets, so a ray leaving a surface (small t)
# carries an absolute rounding error of ~1e-5 world units; HIT_T_ATOL is
# the renderer's self-intersection epsilon, below which it resolves
# nothing.
HIT_T_RTOL = 1e-5
HIT_T_ATOL = 1e-4
HIT_MISMATCH_SHARE = 1e-3


def log(*a):
    print(*a, flush=True)


def card_name():
    """nvidia-smi's name and power limit of the first card (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def write_scene(text, name):
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), name)
    with open(path, "w") as f:
        f.write(text)
    return path


def staircase_scene(spp, iterations, extra=""):
    from statmc_tpu.testscenes import scene_text

    return write_scene(scene_text(
        width=WIDTH, height=HEIGHT, spp=spp, iterations=iterations,
        maxdepth=8, denoise=True, filtersd=10.0, filterradius=20,
        extra_integrator=extra), "staircase-proxy.pbrt")


def check_film(r, what):
    import numpy as np

    film = np.asarray(r.film_mean)
    assert np.isfinite(film).all(), f"{what}: film_mean has non-finites"
    assert film.mean() > 0, f"{what}: film_mean is black"
    if r.film_f is not None:
        film_f = np.asarray(r.film_f)
        assert np.isfinite(film_f).all(), f"{what}: film_f has non-finites"
        assert film_f.mean() > 0, f"{what}: film_f is black"
    return float(film.mean())


def report_logs(logs, what, card):
    for lg in logs:
        note = " (includes compilation)" if lg["iteration"] == 1 else ""
        log(f"{what} iteration {lg['iteration']}{note}: "
            f"render_s={lg['render_s']:.4f} denoise_s={lg['denoise_s']:.4f} "
            f"rays={lg['rays_total']:.0f} "
            f"rays/s={lg['rays_total'] / lg['render_s']:.4g} [{card}]")


def timed(fn, *args):
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def memory_line(fn, *args):
    import jax

    m = jax.jit(fn).lower(*args).compile().memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    return (f"memory_analysis: args={m.argument_size_in_bytes} "
            f"out={m.output_size_in_bytes} temp={m.temp_size_in_bytes} B")


# ---------------------------------------------------------------------------
# Phases


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX reports {devs[0].platform!r})")
    card = card_name()
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"nvidia-smi: {card}")
    return devs, card


def phase_render(card):
    from statmc_tpu.accel.fused import FusedTris
    from statmc_tpu.core.backend import use_kernel
    from statmc_tpu.driver import load

    r = load(staircase_scene(16, 2, FEEDBACK))
    assert isinstance(r.s.bvh, FusedTris), type(r.s.bvh).__name__
    assert use_kernel("fused") and use_kernel("denoise")
    log(f"render: staircase proxy, {r.s.bvh.n_tris} triangles, FusedTris, "
        "denoise kernel (Pallas/Triton), 1280x720, 16 spp x 2 iterations")
    logs = r.render(iterations=2, verbose=False)
    mean = check_film(r, "render")
    assert r.film_f is not None, "render: no denoised film"
    report_logs(logs, "render", card)
    log(f"render: film mean {mean:.6g}")
    return r


def compare_hits(name, k, ref, card, tk, tr):
    """Kernel vs reference (t, id, hit) on one ray batch."""
    import numpy as np

    tk_, ik, _ = (np.asarray(x) for x in k)
    tr_, ir, _ = (np.asarray(x) for x in ref)
    diff = ik != ir
    t_ok = np.abs(tk_ - tr_) <= HIT_T_RTOL * np.abs(tr_) + HIT_T_ATOL
    tie = diff & t_ok
    mismatch = diff & ~tie
    both = (ik >= 0) & (ir >= 0) & ~diff
    rel = np.abs(tk_[both] - tr_[both]) / np.maximum(np.abs(tr_[both]), 1e-30)
    t_bad = float((both & ~t_ok).mean())
    share = float(mismatch.mean())
    log(f"{name}: rays={ik.size} hits={int((ir >= 0).sum())} "
        f"ids differ={int(diff.sum())} (ties {int(tie.sum())}, "
        f"other {int(mismatch.sum())} = {share:.3g} of rays, limit "
        f"{HIT_MISMATCH_SHARE}); same id: t max rel err "
        f"{(rel.max() if rel.size else 0.0):.3g}, median "
        f"{(np.median(rel) if rel.size else 0.0):.3g}, share beyond "
        f"{HIT_T_RTOL} rel + {HIT_T_ATOL} abs: {t_bad:.3g}; kernel "
        f"{tk * 1e3:.3f} ms, reference {tr * 1e3:.3f} ms [{card}]")
    assert share <= HIT_MISMATCH_SHARE, f"{name}: id mismatch {share}"
    assert t_bad <= HIT_MISMATCH_SHARE, f"{name}: t mismatch {t_bad}"


def bounce_rays(o, d, t, hit, seed):
    """From each primary hit point, a ray in a seeded random direction;
    missed lanes are dead (t_max = 0)."""
    import jax
    import jax.numpy as jnp

    from statmc_tpu.core import math as cm

    p = o + jnp.where(hit, t, 0.0)[:, None] * d
    nd = jax.random.normal(jax.random.PRNGKey(seed), d.shape)
    nd = nd / jnp.linalg.norm(nd, axis=-1, keepdims=True)
    return p, nd, jnp.where(hit, cm.INF, 0.0)


def camera_rays(r):
    import jax.numpy as jnp

    from statmc_tpu.render import camera as CAM

    W, H = r.s.width, r.s.height
    ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    p = jnp.stack([xs.reshape(-1), ys.reshape(-1)], -1) + 0.5
    return CAM.generate_rays(r.s.cam, p.astype(jnp.float32))


def check_intersector(name, fn, path, bvh, o, d, t_max, card, chunk):
    """Kernel vs reference over the batch in equal chunks."""
    import jax
    import jax.numpy as jnp

    from statmc_tpu.core.backend import reference_on_gpu

    def run(f):
        outs, secs = [], 0.0
        for a in range(0, o.shape[0], chunk):
            out, s = timed(f, o[a:a + chunk], d[a:a + chunk],
                           t_max[a:a + chunk])
            outs.append(out)
            secs += s
        return tuple(jnp.concatenate(x) for x in zip(*outs)), secs

    k_fn = jax.jit(lambda o, d, t: fn(bvh, o, d, t))
    log(f"{name} kernel " + memory_line(
        lambda o, d, t: fn(bvh, o, d, t), o[:chunk], d[:chunk],
        t_max[:chunk]))
    k, tk = run(k_fn)
    with reference_on_gpu(path):
        r_fn = jax.jit(lambda o, d, t: fn(bvh, o, d, t))
        ref, tr = run(r_fn)
    compare_hits(name, k, ref, card, tk, tr)
    return k


def phase_kernels(r, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from statmc_tpu.accel.fused import intersect_fused
    from statmc_tpu.core import math as cm
    from statmc_tpu.core.backend import reference_on_gpu
    from statmc_tpu.denoise.filter_jax import corrected_stats, stat_filter
    from statmc_tpu.denoise.filter_pallas import _run_filter
    from statmc_tpu.stats import estimator as E

    # -- denoise filter on the render's own Radiance buffers -------------
    s, dn = r.s, r.denoiser
    W, H, P = s.width, s.height, r.P
    states = r._real_states()
    cfg = s.ecfg.configs[E.RADIANCE]
    film = (r.film_sum[:P] / jnp.maximum(r.film_w[:P], 1.0)[..., None])
    film = film.reshape(H, W, 3)

    def denoise(sts, fi):
        return dn(sts[E.RADIANCE], cfg, fi, W, H, gbufs=dn._gbuffers(sts))

    args = (states, film)
    log("denoise kernel " + memory_line(denoise, *args))
    out_k, tk = timed(jax.jit(denoise), *args)
    with reference_on_gpu("denoise"):
        out_r, tr = timed(jax.jit(lambda *a: denoise(*a)), *args)

    # Accepted pixel-offsets of bounce 0 under each path: zero spatial
    # and range factors make every accepted weight exactly 1.
    st = states[E.RADIANCE]
    n = st["n"][0, :, 0].reshape(H, W)
    mean, m2, m3 = (st[k][0].reshape(H, W, 3) for k in ("mean", "m2", "m3"))
    mc, disc = corrected_stats(n, mean, m2, m3, dn.tq)
    ones = jnp.ones((H, W, 1))
    cnt_k = np.asarray(_run_filter(
        mc, disc * disc, ones, jnp.zeros((H, W, 0)), jnp.ones((H, W)),
        dn.radius, 0.0, (), normalize=False)[1])
    with reference_on_gpu("denoise"):
        cnt_r = np.asarray(stat_filter(
            n, mean, m2, m3, jnp.ones((H, W, 3)), jnp.zeros((0, H, W, 3)),
            jnp.zeros((0,)), jnp.float32(0.0), dn.tq, dn.radius,
        )["weight_sum"])
    flips = cnt_k != cnt_r
    log(f"denoise accepted pixel-offsets (bounce 0): kernel "
        f"{cnt_k.sum():.0f}, reference {cnt_r.sum():.0f} of "
        f"{H * W * (2 * dn.radius + 1) ** 2}; pixels whose count differs: "
        f"{int(flips.sum())}")

    worst = 0.0
    for key in ("film_mean_f", "film_f"):
        a, b = np.asarray(out_k[key]), np.asarray(out_r[key])
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        scale = np.abs(b).mean() + 1e-30
        rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3 * scale)).max(-1)
        share = float((rel > FILTER_RTOL).mean())
        worst = max(worst, share)
        log(f"denoise {key}: max rel err {rel.max():.3g}, median "
            f"{np.median(rel):.3g}, share beyond {FILTER_RTOL}: {share:.3g} "
            f"(limit {FILTER_FLIP_SHARE})")
    log(f"denoise Radiance ({out_k['film_mean_f'].shape[0]} bounce "
        f"buffers): kernel {tk * 1e3:.3f} ms, reference {tr * 1e3:.3f} ms "
        f"[{card}]")
    assert worst <= FILTER_FLIP_SHARE, f"denoise mismatch share {worst}"

    # -- fused intersector on primary rays and one bounce ----------------
    o, d = camera_rays(r)
    t_max = jnp.full((o.shape[0],), cm.INF)
    chunk = o.shape[0] // 8
    prim = check_intersector("fused primary", intersect_fused, "fused",
                             s.bvh, o, d, t_max, card, chunk)
    ob, db, tb = bounce_rays(o, d, prim[0], prim[2], 1)
    check_intersector("fused bounce", intersect_fused, "fused", s.bvh,
                      ob, db, tb, card, chunk)


def phase_terrain(card):
    import jax.numpy as jnp

    from statmc_tpu.accel.twolevel import TwoLevelTris, intersect_twolevel
    from statmc_tpu.core import math as cm
    from statmc_tpu.core.backend import use_kernel
    from statmc_tpu.driver import load
    from statmc_tpu.testscenes import terrain_scene_text

    r = load(write_scene(terrain_scene_text(
        width=WIDTH, height=HEIGHT, spp=4, iterations=1, maxdepth=8),
        "terrain-proxy.pbrt"))
    assert isinstance(r.s.bvh, TwoLevelTris), type(r.s.bvh).__name__
    assert use_kernel("walk")
    log(f"terrain: {r.s.bvh.n_tris} triangles, TwoLevelTris, walk kernel "
        "(Pallas/Triton), 1280x720, 4 spp x 1 iteration")
    logs = r.render(iterations=1, verbose=False)
    mean = check_film(r, "terrain")
    report_logs(logs, "terrain", card)
    r.reset()
    lg = r.render(iterations=1, verbose=False)[0]
    log(f"terrain steady iteration: render_s={lg['render_s']:.4f} "
        f"rays={lg['rays_total']:.0f} "
        f"rays/s={lg['rays_total'] / lg['render_s']:.4g} [{card}]")
    log(f"terrain: film mean {mean:.6g}")

    o, d = camera_rays(r)
    t_max = jnp.full((o.shape[0],), cm.INF)
    chunk = o.shape[0] // 8
    prim = check_intersector("walk primary", intersect_twolevel, "walk",
                             r.s.bvh, o, d, t_max, card, chunk)
    ob, db, tb = bounce_rays(o, d, prim[0], prim[2], 2)
    check_intersector("walk bounce", intersect_twolevel, "walk", r.s.bvh,
                      ob, db, tb, card, chunk)
    # One renderer dispatch (driver.PIXEL_BLOCK_TWOLEVEL), whole blocks.
    n = min(131072, o.shape[0] // 512 * 512)
    cull_share("camera", r.s.bvh, o[:n], d[:n], t_max[:n], card)
    cull_share("bounce", r.s.bvh, ob[:n], db[:n], tb[:n], card)


def cull_share(name, tl, o, d, t_max, card):
    """The XLA cull's share of one two-level intersect call, and the
    worklist lengths the walk then sees (rays sorted as the walk sorts
    them)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from statmc_tpu.accel import twolevel as TL

    perm, _ = TL._morton_partition(tl, o, d, t_max)
    o, d, t_max = o[perm], d[perm], t_max[perm]
    votes = jax.jit(lambda o, d, t: TL._votes_xla(tl.bounds, o, d, t))
    full = jax.jit(lambda o, d, t: TL.intersect_twolevel(tl, o, d, t))
    vote_f, tv = timed(votes, o, d, t_max)
    _, tf = timed(full, o, d, t_max)
    G = vote_f.shape[0]
    _, n_eff = TL._compact(vote_f.reshape(G, tl.n_sub, tl.fsub).any(-1))
    n_eff = np.asarray(n_eff)
    log(f"walk {name} rays, {o.shape[0]} per call: cull {tv * 1e3:.3f} ms "
        f"of {tf * 1e3:.3f} ms ({tv / tf:.3g}); worklists: median "
        f"{np.median(n_eff):.0f}, max {n_eff.max()} of {tl.n_sub} "
        f"subtiles, {int((n_eff > TL.MAXS).sum())}/{G} blocks over "
        f"{TL.MAXS} walk densely [{card}]")


def phase_card_tests():
    import pytest

    os.environ["STATMC_TEST_ON_CARD"] = "1"
    rc = pytest.main(["-q", "-m", "card", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_on_card.py")])
    assert rc == 0, f"card-only tests: pytest exit code {int(rc)}"


def phase_mesh(card):
    import jax
    import numpy as np

    from statmc_tpu.driver import load
    from statmc_tpu.parallel.shard import make_mesh

    assert len(jax.devices()) >= 4, f"--cards 4 needs 4 GPUs, JAX sees {len(jax.devices())}"
    path = staircase_scene(8, 1)
    r1 = load(path)
    lg1 = r1.render(iterations=1, verbose=False)
    check_film(r1, "one card")
    rm = load(path, mesh=make_mesh(2, 2))
    assert rm.mesh is not None
    lgm = rm.render(iterations=1, verbose=False)
    assert rm._denoise_fn is not None
    check_film(rm, "2x2 mesh")
    log(f"one card (device 0): render_s={lg1[0]['render_s']:.4f} "
        f"denoise_s={lg1[0]['denoise_s']:.4f} (includes compilation) [{card}]")
    log(f"2x2 mesh: render_s={lgm[0]['render_s']:.4f} "
        f"denoise_s={lgm[0]['denoise_s']:.4f} (includes compilation) [{card}]")
    # test_sharding.py's tolerance for film and moments; the same for
    # film_f, whose inputs differ only by the Chan-vs-serial rounding of
    # the moments (the kernel sums each pixel's window in the same order
    # on every card), save accept flips at the test threshold.
    pairs = [("film_mean", r1.film_mean, rm.film_mean)]
    for t, st in r1._real_states().items():
        for key in ("mean", "m2"):
            if key in st:
                pairs.append((f"state {t} {key}", st[key],
                              rm._real_states()[t][key]))
    for name, a, b in pairs:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    a, b = np.asarray(r1.film_f), np.asarray(rm.film_f)
    bad = ~np.isclose(b, a, rtol=FILTER_RTOL, atol=1e-5)
    log(f"2x2 mesh vs one card: film and {len(pairs) - 1} moment buffers "
        f"allclose (rtol 1e-4, atol 1e-5); film_f max abs diff "
        f"{np.abs(a - b).max():.3g}, share beyond rtol {FILTER_RTOL}: "
        f"{bad.mean():.3g} (limit {FILTER_FLIP_SHARE})")
    assert bad.mean() <= FILTER_FLIP_SHARE, "film_f differs"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "statmc_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    devs, card = phase_device()
    ok = True

    def run(name, fn, *a):
        nonlocal ok
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*a)
            log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        except Exception:
            ok = False
            traceback.print_exc(file=sys.stdout)
            log(f"== phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            return None

    if args.cards == 4:
        run("mesh 2x2", phase_mesh, card)
    else:
        r = run("render", phase_render, card)
        if r is not None:
            run("kernels", phase_kernels, r, card)
        else:
            ok = False
        del r  # release the 720p buffers before the terrain compiles
        run("terrain", phase_terrain, card)
        run("card tests", phase_card_tests)

    log(json.dumps({"ok": ok, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
