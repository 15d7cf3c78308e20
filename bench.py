"""Benchmark: the reference's own veach-mis scene, rendered + denoised.

Round-1 verdict asked for the bench to anchor on a real reference scene:
/root/reference/scenes/veach-mis/scene-stat.pbrt (BASELINE config 1) is
staged through statmc_tpu/refscenes.py and rendered with the
render-denoise configuration (full statistics + statistical filter).
If the reference tree is not mounted, the procedural staircase proxy
(statmc_tpu/testscenes.py) stands in.

Protocol (mirrors BASELINE.md): warm-up iteration (compile + first
dispatch), then a timed iteration for render throughput, then a
steady-state denoise batch (K back-to-back async dispatches, blocked
once) for filter throughput — matching how the denoiser runs in
production, pipelined behind the render stream.

Runs on an NVIDIA GPU only: on any other platform it exits non-zero
without a result.  One JAX process; the scenes share it in turn.

Prints ONE JSON line:
  {"metric": ..., "value": rays/s/chip, "unit": "rays/s",
   "vs_baseline": value / 5e6, ...}

vs_baseline anchor: the reference repo publishes no numbers
(BASELINE.md).  5 Mrays/s is our documented estimate of
pbrt-v3's CPU path-tracing throughput on the paper's 16-core Ryzen 9
5950X (pbrt-v3 typically traces 2-10 Mrays/s on interior scenes); the
anchor is fixed so successive rounds are comparable.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time

import jax
import numpy as np

WIDTH, HEIGHT = 1280, 720  # the scene's own Film resolution
SPP = 16
MAXDEPTH = 16              # the scene's own ExtraParams choice
DENOISE_BATCH = 8
BASELINE_RAYS_PER_S = 5e6


def _scene_path():
    from statmc_tpu import refscenes

    if refscenes.reference_available("veach-mis"):
        return (
            refscenes.stage_resized(
                "veach-mis", "render-denoise", WIDTH, HEIGHT, SPP,
                iterations=1, maxdepth=MAXDEPTH,
            ),
            "veach-mis",
        )
    from statmc_tpu.testscenes import scene_text

    text = scene_text(
        width=WIDTH, height=HEIGHT, spp=SPP, iterations=1,
        maxdepth=8, denoise=True, filtersd=10.0, filterradius=20,
    )
    tmp = tempfile.mkdtemp()
    path = tmp + "/staircase-proxy.pbrt"
    with open(path, "w") as f:
        f.write(text)
    return path, "staircase-proxy"


def _bench_terrain():
    """Second bench line (round-2 verdict #1): a >=100k-triangle scene
    through the two-level worklist traversal (accel/twolevel.py), the
    path that replaces the reference's full BVH walk at scale
    (/root/reference/src/accelerators/bvh.cpp:707+)."""
    from statmc_tpu.driver import load
    from statmc_tpu.testscenes import terrain_scene_text

    text = terrain_scene_text(width=WIDTH, height=HEIGHT, spp=4,
                              iterations=1, maxdepth=8)
    tmp = tempfile.mkdtemp()
    path = tmp + "/terrain-proxy.pbrt"
    with open(path, "w") as f:
        f.write(text)
    r = load(path)
    n_tris = getattr(r.s.bvh, "n_tris", 0)
    r.render(iterations=1, verbose=False)   # warm-up / compile
    r.reset()
    log = r.render(iterations=1, verbose=False)[0]
    rays_per_s = log["rays_total"] / log["render_s"]
    out = {
        "terrain_131k_rays_per_s": round(rays_per_s, 1),
        "terrain_tris": int(n_tris),
        "terrain_render_s": round(log["render_s"], 3),
        "terrain_vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
    }
    del r

    # ~1M-triangle line (round-3 verdict #2), in its own guard so the
    # 131k numbers above survive a failure here.
    try:
        text = terrain_scene_text(width=WIDTH, height=HEIGHT, spp=2,
                                  iterations=1, maxdepth=8, n=708)
        path = tmp + "/terrain-big.pbrt"
        with open(path, "w") as f:
            f.write(text)
        r = load(path)
        out["terrain_big_tris"] = int(getattr(r.s.bvh, "n_tris", 0))
        r.render(iterations=1, verbose=False)
        r.reset()
        log = r.render(iterations=1, verbose=False)[0]
        rays_big = log["rays_total"] / log["render_s"]
        out["terrain_big_rays_per_s"] = round(rays_big, 1)
        out["terrain_big_render_s"] = round(log["render_s"], 3)
    except Exception as e:
        out["terrain_big_error"] = f"{type(e).__name__}: {e}"[:160]
    return out


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX reports {dev.platform!r}",
              file=sys.stderr)
        return 1
    from statmc_tpu.driver import load

    path, scene_name = _scene_path()
    r = load(path)

    # Warm-up (compile + first run), then timed run.
    r.render(iterations=1, verbose=False)
    r.reset()
    logs = r.render(iterations=1, verbose=False)
    log = logs[0]

    rays = log["rays_total"]
    rays_per_s = rays / log["render_s"]
    mpix = WIDTH * HEIGHT / 1e6

    # Steady-state denoise: K async dispatches, one block.
    t0 = time.perf_counter()
    for _ in range(DENOISE_BATCH):
        r._denoise()
    jax.block_until_ready(r.film_f)
    denoise_s = (time.perf_counter() - t0) / DENOISE_BATCH
    denoise_ms_per_mpix = denoise_s * 1e3 / mpix

    # Blocking latency: min over a few one-shot calls.
    blocking = []
    for _ in range(3):
        t0 = time.perf_counter()
        r._denoise()
        jax.block_until_ready(r.film_f)
        blocking.append(time.perf_counter() - t0)
    denoise_blocking_ms = min(blocking) * 1e3

    film = np.asarray(r.film_mean)
    ok = bool(np.isfinite(film).all() and film.mean() > 0)

    result = {
        "metric": f"{scene_name}_{SPP}spp_rays_per_s_per_chip",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
        "denoise_ms_per_mpix": round(denoise_ms_per_mpix, 2),
        "denoise_blocking_ms": round(denoise_blocking_ms, 2),
        "render_s": round(log["render_s"], 3),
        "rays_total": int(rays),
        "spp": SPP,
        "resolution": f"{WIDTH}x{HEIGHT}",
        "finite_film": ok,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    del r  # release film/device buffers before the terrain scene compiles
    try:
        result.update(_bench_terrain())
    except Exception as e:  # the headline line must survive a terrain failure
        result["terrain_error"] = f"{type(e).__name__}: {e}"[:200]
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
