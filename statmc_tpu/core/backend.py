"""Which implementation a hot path runs: its Pallas kernel or the plain
jnp reference.

Three paths have a kernel: "denoise" (denoise/filter_pallas.py),
"fused" (accel/fused.py) and "walk" (accel/twolevel.py).  On the GPU
each runs its kernel, compiled through Triton; on the CPU each runs its
plain reference, which is what the tests exercise.  There is no third
choice: any other backend raises.
"""
from __future__ import annotations

import contextlib

import jax

KERNEL_PATHS = ("denoise", "fused", "walk")

_reference_on_gpu: set[str] = set()


def use_kernel(path: str) -> bool:
    """True when `path` runs its kernel (GPU), False for the plain
    reference (CPU).  Raises on any other backend."""
    if path not in KERNEL_PATHS:
        raise ValueError(f"unknown kernel path {path!r}")
    backend = jax.default_backend()
    if backend == "gpu":
        return path not in _reference_on_gpu
    if backend == "cpu":
        return False
    raise NotImplementedError(
        f"{path}: no implementation for backend {backend!r} "
        "(the kernel runs on 'gpu', the plain reference on 'cpu')")


@contextlib.contextmanager
def reference_on_gpu(*paths: str):
    """Run the named paths through their plain reference on the GPU too,
    for kernel-versus-XLA checks and timings.  The choice is made when a
    function is traced, so build (or load) what is measured inside the
    block."""
    for p in paths:
        if p not in KERNEL_PATHS:
            raise ValueError(f"unknown kernel path {p!r}")
    saved = set(_reference_on_gpu)
    _reference_on_gpu.update(paths)
    try:
        yield
    finally:
        _reference_on_gpu.clear()
        _reference_on_gpu.update(saved)
