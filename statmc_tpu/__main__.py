"""CLI: `python -m statmc_tpu [options] scene.pbrt`.

Mirrors the reference's extended pbrt flag surface
(/root/reference/src/main/pbrt.cpp:97-220 + README "Additional
Command-Line Options"): --writeimages, --displayserver <ip:port>,
--baseseed <n>, --denoise, --warmup, --outdir.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="statmc_tpu",
        description="Statistical Monte Carlo renderer (JAX, wavefront)",
    )
    ap.add_argument("scene", help="pbrt scene description file")
    ap.add_argument("--writeimages", action="store_true",
                    help="write regex-selected buffers to disk")
    ap.add_argument("--displayserver", default=None, metavar="IP:PORT",
                    help="stream buffers to a tev display server")
    ap.add_argument("--baseseed", type=int, default=0,
                    help="base seed for the sampler")
    ap.add_argument("--denoise", action="store_true",
                    help="skip rendering; denoise prerendered buffers")
    ap.add_argument("--warmup", action="store_true",
                    help="run one throwaway iteration first")
    ap.add_argument("--outdir", default="out",
                    help="output directory (default: out/)")
    ap.add_argument("--mesh", default=None, metavar="SPPxPX",
                    help="multi-device mesh, e.g. 2x4 (samples x pixel "
                         "rows), or 'auto' for 1 x n_devices")
    ap.add_argument("--iterations", type=int, default=None,
                    help="override iteration count")
    ap.add_argument("--strictassets", action="store_true",
                    help="error (instead of warn) on missing PLY/texture "
                         "asset files")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a JAX profiler (XPlane) trace of the "
                         "render loop into DIR — the sampling-profiler "
                         "equivalent (src/core/stats.cpp:263)")
    args = ap.parse_args(argv)

    from .driver import load

    mesh = args.mesh
    if mesh and mesh != "auto":
        from statmc_tpu.parallel.shard import make_mesh

        n_spp, n_px = (int(v) for v in mesh.lower().split("x"))
        mesh = make_mesh(n_spp, n_px)
    r = load(args.scene, base_seed=args.baseseed, mesh=mesh,
             strict_assets=True if args.strictassets else None)
    tev = None
    if args.displayserver:
        from .io.display import TevClient

        tev = TevClient(args.displayserver)
        tev.connect()

    if args.denoise:
        n_it = args.iterations or r.s.ecfg.iterations
        for i in range(1, n_it + 1):
            written = r.denoise_from_disk(args.outdir, i)
            print(f"Iteration: {i}")
            for w in written:
                print(f"  wrote {w}")
            if tev is not None:
                tev.display_buffers(
                    f"{os.path.basename(args.scene)}-{r.total_spp(i)}",
                    _selected(r),
                )
        return 0

    if args.warmup:
        print("==== Warm-Up Start ====")
        r.render(iterations=1, verbose=True)
        r.reset()
        print("==== Warm-Up End ====")

    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    n_it = args.iterations or r.s.ecfg.iterations
    for i in range(1, n_it + 1):
        log = r.run_iteration(i)
        print(f"Iteration: {log['iteration']}")
        print(f"SPP: {log['spp']}")
        print(f"Rendering time [ns]: {int(log['render_s'] * 1e9)}")
        # Label kept for script compatibility with the reference's
        # per-iteration report (statpath.cpp:402-429).
        print(f"CUDA time [ns]: {int(log['denoise_s'] * 1e9)}")
        import time

        t0 = time.perf_counter()
        if args.writeimages:
            for w in r.write_outputs(args.outdir, i):
                print(f"  wrote {w}")
        if tev is not None:
            tev.display_buffers(
                f"{os.path.basename(args.scene)}-{log['spp']}", _selected(r)
            )
        print(f"Output time [ns]: {int((time.perf_counter() - t0) * 1e9)}")
    if args.profile:
        import jax

        jax.profiler.stop_trace()
        print(f"profiler trace written to {args.profile}")
    if tev is not None:
        tev.close()
    r.print_stats()
    return 0


def _selected(r):
    import re

    rx = re.compile(r.s.ecfg.output_regex)
    return {k: v for k, v in r.buffers().items() if rx.fullmatch(k)}


if __name__ == "__main__":
    sys.exit(main())
