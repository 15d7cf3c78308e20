"""Primary-sample-space Metropolis light transport (many parallel chains).

Re-derivation of the reference's MLTIntegrator
(/root/reference/src/integrators/mlt.cpp:1-420): Kelemen-style
Metropolis over the primary sample space U in [0,1]^D, with large-step /
small-step mutations, the two-sample (current+proposed) splatting
estimator, and bootstrap normalization b = E[L].

Differences from the reference, by design:

* The path-contribution function f(U) is BIDIRECTIONAL by default
  (pbrt's design): render/bdpt.py make_contribution evaluates the full
  t>=2 BDPT strategy sum from U, whose dims cover the camera subpath,
  the light subpath, and the per-strategy connection draws -- mutating
  light-stream dims explores caustic paths exactly as pbrt's
  light-subpath stream does.  Where pbrt evaluates ONE (s,t) strategy
  per state (mlt.cpp:120-260), the wavefront evaluates the whole MIS
  mixture: on SIMD hardware per-lane strategy divergence would waste
  every other strategy's work anyway, and the full sum is an equally
  valid (lower-variance) contribution function.  t=1 strategies are
  excluded with their MIS terms (single-pixel contribution; see
  bdpt.py:make_contribution).  `"bool bidirectional" ["false"]` falls
  back to mutating the unidirectional path tracer under the lockstep
  draw-table mode (core/rng.py MODE_LOCKSTEP).
* One chain per lane: tens of thousands of INDEPENDENT Markov chains
  advance in lockstep, each mutation evaluating f for every chain as
  one XLA program -- the wavefront replacement for pbrt's nChains=1000 CPU
  tasks.  Independent chains also sidestep pbrt's startup-bias caveat:
  each chain is seeded by resampling the bootstrap distribution.
* Splatting is a scatter-add into the film (film.cpp AddSplat).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lockstep as LS
from ..core import rng as crng
from ..core import spectrum as spec
from . import camera as CAM
from .alt_integrators import AltRenderer
from .integrator import trace

N_CHAINS = 8192
SIGMA = 0.01  # pbrt MLTSampler default
P_LARGE = 0.3  # pbrt "largestepprobability" default
N_BOOTSTRAP = 65536


class MLTRenderer(AltRenderer):
    """integrator "mlt": iterations map to mutation batches; iteration i
    contributes total_spp(i) mutations per pixel on average."""

    def __init__(self, desc, base_seed: int = 0, force_dense: bool = False):
        ip = desc.integrator_params
        self.bidirectional = bool(ip.find_one("bidirectional", True)) \
            if ip else True
        self._desc = desc
        self._force_dense = force_dense
        super().__init__(desc, base_seed, force_dense=force_dense)

    def _reset_state(self):
        s = self.s
        self.cfg = s.icfg._replace(sampler_mode=crng.MODE_LOCKSTEP)
        if self.bidirectional:
            from .bdpt import BDPTRenderer

            self._bdpt = BDPTRenderer(self._desc, self.base_seed,
                                      force_dense=self._force_dense)
            self._f_bdpt, self.D = self._bdpt.make_contribution(N_CHAINS)
        else:
            self._bdpt = None
            n_steps = s.icfg.max_depth + 1 + s.icfg.null_extra
            self.D = LS.dims_per_sample(n_steps)
        P = s.width * s.height
        self.splat = jnp.zeros((P, 3))
        self.n_mut = 0
        self.key = jax.random.PRNGKey(np.uint32(self.base_seed))
        self._chains = None
        self.b = None
        self._step_fn = None

    # -- f(U): luminance + rgb + pixel of the path U encodes -------------
    def _f(self, U):
        if self._bdpt is not None:
            return self._f_bdpt(U)
        s = self.s
        C = U.shape[0]
        px = jnp.clip(U[:, 0] * s.width, 0.0, s.width - 1e-3)
        py = jnp.clip(U[:, 1] * s.height, 0.0, s.height - 1e-3)
        o, d = CAM.generate_rays(s.cam, jnp.stack([px, py], -1))
        keys = jnp.zeros((C, 2), jnp.uint32)
        NL = max(s.icfg.n_ls, 1)
        NB = max(s.icfg.nb_mis, 1)
        out = trace(
            s.scene, s.bvh, s.dist, self.cfg, o, d, keys,
            jnp.ones((C, NL)), jnp.zeros((C, NB)), jnp.zeros((C, NB)),
            jnp.asarray(False),
            ld_stream=(U[:, None, :], jnp.zeros((), jnp.int32)),
        )
        L = out.ls[:, 0, :]
        pix = (py.astype(jnp.int32) * s.width + px.astype(jnp.int32))
        return spec.luminance(L), L, pix

    def _bootstrap(self):
        """b = E[y] over uniform U; chains seeded by resampling the
        bootstrap population proportionally to y (mlt.cpp:RenderRound 1)."""
        k1, k2, self.key = jax.random.split(self.key, 3)
        rows = []
        ys = []
        per = N_CHAINS  # evaluate in chain-sized batches
        f = jax.jit(self._f)
        for i in range(N_BOOTSTRAP // per):
            U = jax.random.uniform(jax.random.fold_in(k1, i), (per, self.D))
            y, _, _ = f(U)
            rows.append(U)
            ys.append(y)
        U_all = jnp.concatenate(rows)
        y_all = jnp.concatenate(ys)
        self.b = float(jnp.mean(y_all))
        if self.b <= 0:
            self.b = 1e-9  # black scene; chains splat nothing anyway
        idx = jax.random.categorical(
            k2, jnp.log(jnp.maximum(y_all, 1e-20)), shape=(N_CHAINS,))
        U0 = U_all[idx]
        y0, L0, pix0 = f(U0)
        self._chains = (U0, y0, L0, pix0)

    def _make_step(self):
        f = self._f

        def step(chains, splat, key):
            U, y, L, pix = chains
            C = U.shape[0]
            k1, k2, k3, k4 = jax.random.split(key, 4)
            large = jax.random.uniform(k1, (C,)) < P_LARGE
            # Small step: wrapped gaussian perturbation (MLTSampler's
            # EnsureReady mutation, mlt.cpp:72-96, simplified to a fixed
            # per-dim sigma); large step: fresh uniform.
            eps = jax.random.normal(k2, U.shape) * SIGMA
            U_small = jnp.mod(U + eps, 1.0)
            U_large = jax.random.uniform(k3, U.shape)
            U_new = jnp.where(large[:, None], U_large, U_small)
            y_new, L_new, pix_new = f(U_new)

            a = jnp.minimum(1.0, y_new / jnp.maximum(y, 1e-20))
            a = jnp.where(y <= 0, 1.0, a)
            # Two-sample splat (mlt.cpp:Render main loop): both states
            # contribute their unit-luminance color weighted by the
            # acceptance probability; the film scale b/mpp restores
            # radiometric units.
            splat = splat.at[pix_new].add(
                jnp.where((y_new > 0)[:, None],
                          (a / jnp.maximum(y_new, 1e-20))[:, None] * L_new,
                          0.0))
            splat = splat.at[pix].add(
                jnp.where((y > 0)[:, None],
                          ((1.0 - a) / jnp.maximum(y, 1e-20))[:, None] * L,
                          0.0))

            acc = jax.random.uniform(k4, (C,)) < a
            U = jnp.where(acc[:, None], U_new, U)
            y = jnp.where(acc, y_new, y)
            L = jnp.where(acc[:, None], L_new, L)
            pix = jnp.where(acc, pix_new, pix)
            return (U, y, L, pix), splat

        def batch(chains, splat, key, n_steps):
            def body(carry, k):
                ch, sp = carry
                ch, sp = step(ch, sp, k)
                return (ch, sp), None

            (chains, splat), _ = jax.lax.scan(
                body, (chains, splat), jax.random.split(key, n_steps))
            return chains, splat

        return jax.jit(batch, static_argnames=("n_steps",))

    def _render_iteration(self, i: int) -> float:
        if self.b is None:
            self._bootstrap()
        if self._step_fn is None:
            self._step_fn = self._make_step()
        s = self.s
        P = s.width * s.height
        spp_prev = self.total_spp(i - 1) if i > 1 else 0
        target = self.total_spp(i) * P
        n_steps = max(1, -(-(target - spp_prev * P) // N_CHAINS))
        self.key, k = jax.random.split(self.key)
        self._chains, self.splat = self._step_fn(
            self._chains, self.splat, k, n_steps=n_steps)
        self.n_mut += n_steps * N_CHAINS
        # ~1 camera ray + shadow/MIS rays per bounce per mutation.
        return float(n_steps * N_CHAINS)

    @property
    def film_mean(self):
        # film = b * splat / nTotalMutations (mlt.cpp:Render tail: the
        # splat scale is b / mutationsPerPixel with splats averaged per
        # pixel implicitly by the P factor).
        scale = self.b * self.s.width * self.s.height / max(self.n_mut, 1)
        return self.splat * scale
