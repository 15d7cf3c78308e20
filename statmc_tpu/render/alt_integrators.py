"""Dispatch for the non-statpath light-transport algorithms.

The reference keeps pbrt-v3's full integrator set functional
(/root/reference/src/integrators/: bdpt.cpp, mlt.cpp, sppm.cpp).  These
are distinct transport algorithms -- bidirectional connection, Markov
chain mutation over primary-sample space, and progressive photon
mapping -- and must NOT be silently aliased onto unidirectional path
tracing (they produce different images on the scenes they exist for:
caustics, difficult visibility).

Wavefront drivers live in sibling modules:
  * render/bdpt.py    -- bidirectional path tracer: all (s,t) connection
                         strategies, pbrt's recursive MIS weights, t=1
                         film splats (bdpt.cpp:352-780)
  * render/sppm.py    -- stochastic progressive photon mapping (sppm.cpp:1)
  * render/pssmlt.py  -- primary-sample-space MLT over many parallel
                         chains (mlt.cpp:1; pbrt's MLT is already PSS)
"""
from __future__ import annotations

import os
import re
import time

import numpy as np


class AltRenderer:
    """Driver-compatible surface for the non-statpath integrators: the
    same iteration loop / output contract as driver.Renderer (so the
    CLI, tev streaming, and PFM outputs work unchanged), with the
    transport algorithm supplied by `_render_iteration`."""

    def __init__(self, desc, base_seed: int = 0, force_dense: bool = False):
        from ..driver import prepare

        self.s = prepare(desc, base_seed, force_dense=force_dense)
        self.base_seed = base_seed
        self.reset()

    # -- subclass hooks ----------------------------------------------------
    def _reset_state(self):
        raise NotImplementedError

    def _render_iteration(self, i: int) -> float:
        """Advance the estimator by one iteration; returns rays traced."""
        raise NotImplementedError

    @property
    def film_mean(self):
        raise NotImplementedError

    # -- shared driver surface ----------------------------------------------
    def reset(self):
        import jax.numpy as jnp

        self.ray_total = jnp.zeros(())
        self._reset_state()

    def total_spp(self, i: int) -> int:
        spp = self.s.ecfg.pixel_samples
        return (spp << (i - 1) if self.s.ecfg.exp_iterations
                else i * spp)

    def run_iteration(self, i: int):
        import jax

        t0 = time.perf_counter()
        rays = self._render_iteration(i)
        jax.block_until_ready(self.film_mean)
        self.ray_total = self.ray_total + rays
        return {
            "iteration": i,
            "spp": self.total_spp(i),
            "render_s": time.perf_counter() - t0,
            "denoise_s": 0.0,
            "rays_total": float(self.ray_total),
        }

    def render(self, iterations=None, out_dir=None, verbose=True,
               start_iteration: int = 1):
        n_it = iterations or self.s.ecfg.iterations
        logs = []
        for i in range(start_iteration, n_it + 1):
            log = self.run_iteration(i)
            if out_dir is not None:
                log["written"] = self.write_outputs(out_dir, i)
            logs.append(log)
            if verbose:
                print(f"Iteration: {log['iteration']}\n"
                      f"SPP: {log['spp']}\n"
                      f"Rendering time [ns]: {int(log['render_s'] * 1e9)}")
        return logs

    def buffers(self) -> dict:
        H, W = self.s.height, self.s.width
        return {"film": np.asarray(self.film_mean).reshape(H, W, 3)}

    def write_outputs(self, out_dir: str, iteration: int):
        from ..io.pfm import write_pfm

        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(self.s.filename))[0]
        spp = self.total_spp(iteration)
        rx = re.compile(self.s.ecfg.output_regex)
        written = []
        for name, arr in self.buffers().items():
            if rx.fullmatch(name):
                path = os.path.join(out_dir, f"{stem}-{spp}-{name}.pfm")
                write_pfm(path, arr)
                written.append(path)
        return written

    def print_stats(self, file=None):
        import sys

        f = file or sys.stdout
        print("Statistics:", file=f)
        print("  Integrator", file=f)
        print(f"    Rays traced {int(float(self.ray_total))}", file=f)


def make_alt_renderer(name: str, desc, base_seed: int = 0,
                      force_dense: bool = False):
    try:
        if name == "bdpt":
            from .bdpt import BDPTRenderer

            return BDPTRenderer(desc, base_seed, force_dense=force_dense)
        if name == "sppm":
            from .sppm import SPPMRenderer

            return SPPMRenderer(desc, base_seed, force_dense=force_dense)
        if name == "mlt":
            from .pssmlt import MLTRenderer

            return MLTRenderer(desc, base_seed, force_dense=force_dense)
        if name == "ao":
            from .ao import AORenderer

            return AORenderer(desc, base_seed, force_dense=force_dense)
    except ImportError as e:
        raise NotImplementedError(
            f"integrator {name!r}: wavefront driver not built yet; "
            "refusing to silently alias onto unidirectional path tracing "
            f"(would render a different image). [{e}]"
        ) from e
    raise ValueError(f"unknown alternative integrator {name!r}")
