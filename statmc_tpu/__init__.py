"""statmc-tpu: a statistical Monte Carlo rendering framework in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
cg-tuwien/StatMC ("A Statistical Approach to Monte Carlo Denoising",
Sakai et al., SIGGRAPH Asia 2024): a wavefront path tracer that tracks
per-pixel streaming statistics (n, mean, M2, M3, Box-Cox transformed)
alongside radiance and G-buffers, an iterative render->denoise loop, a
statistical joint-bilateral denoising filter as a differentiable Pallas
kernel for the GPU, ACRR and SMIS.

Nothing here is a port: the reference is an OO C++/CUDA plugin renderer
(pbrt-v3 + OpenCV); this package is a SoA, masked-stream, mesh-sharded
JAX program.  See SURVEY.md at the repo root for the mapping.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: the wavefront trace program is large, so
# warm starts reuse compiled programs.  JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it the cache lives at the fixed
# <checkout>/.jax_cache.  Opt out with STATMC_NO_JIT_CACHE=1.
if not _os.environ.get("STATMC_NO_JIT_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update(
            "jax_compilation_cache_dir",
            _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
