#!/usr/bin/env python3
"""Kernel-versus-XLA timings on an NVIDIA GPU, end to end in the cell
where each kernel runs.

    python scripts/kernel_ab.py [--repeats 2] [--out FILE]

Each hand-written kernel is timed against the plain version XLA
compiles (core/backend.reference_on_gpu), through driver.load(...)
.render(), in one process, in turns (A, B, B, A per repeat), in the
staircase render-denoise cell (1280x720, 16 spp, maxdepth 8, filter
radius 20; one iteration per timing): fused kernel vs _intersect_ref
(render_s), denoise kernel vs stat_filter (denoise_s).  The walk
kernel's comparison is chip_smoke.py's terrain phase: a terrain render
through the XLA walk does not fit a call's time limit.

Prints one JSON object per measurement, each with the card's name and
power limit, and writes them all to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def scene_file(text, name):
    path = os.path.join(tempfile.mkdtemp(prefix="kernel_ab_"), name)
    with open(path, "w") as f:
        f.write(text)
    return path


def build(path, refs=()):
    """Load and warm one renderer; tracing (and so the choice of path)
    happens in the warm-up render inside the context."""
    from statmc_tpu.core.backend import reference_on_gpu
    from statmc_tpu.driver import load

    with reference_on_gpu(*refs):
        r = load(path)
        r.render(iterations=1, verbose=False)
    return r


def once(r):
    r.reset()
    lg = r.render(iterations=1, verbose=False)[0]
    return lg["render_s"], lg["denoise_s"], lg["rays_total"]


def ab(cell, a_name, a, b_name, b, repeats, card, emit):
    """A, B, B, A turns; medians of render_s and denoise_s."""
    times = {a_name: [], b_name: []}
    for _ in range(repeats):
        for name, r in ((a_name, a), (b_name, b), (b_name, b),
                        (a_name, a)):
            times[name].append(once(r))
    for name, ts in times.items():
        emit({"cell": cell, "config": name,
              "render_s": statistics.median(t[0] for t in ts),
              "denoise_s": statistics.median(t[1] for t in ts),
              "rays": ts[0][2], "runs": len(ts),
              "render_s_all": [t[0] for t in ts],
              "denoise_s_all": [t[1] for t in ts], "card": card})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "kernel_ab.jsonl"))
    args = ap.parse_args(argv)

    import jax

    from statmc_tpu.testscenes import scene_text

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"kernel_ab: needs an NVIDIA GPU, JAX reports "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    card = card_name()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w")

    def emit(rec):
        rec["device_kind"] = dev.device_kind
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    stair = scene_file(scene_text(
        width=1280, height=720, spp=16, iterations=1, maxdepth=8,
        denoise=True, filtersd=10.0, filterradius=20), "staircase.pbrt")
    kern = build(stair)
    for name, path in (("fused reference", "fused"),
                       ("denoise reference", "denoise")):
        other = build(stair, refs=(path,))
        ab("staircase", "kernels", kern, name, other, args.repeats, card,
           emit)
        del other
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
