"""Choice of path for the three kernels, and what surrounds each kernel:
its wrapper's padding of odd sizes, the walk kernel's body (interpret
mode), and where the compile cache goes."""
import functools
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest

from statmc_tpu.accel import fused as F
from statmc_tpu.accel import twolevel as TL
from statmc_tpu.core import backend
from statmc_tpu.denoise import filter_jax as FJ
from statmc_tpu.denoise import filter_pallas as FP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tris(T, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((T, 3)) * 20 - 10).astype(np.float32),
            (rng.random((T, 3)) - 0.5).astype(np.float32),
            (rng.random((T, 3)) - 0.5).astype(np.float32))


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    o = (rng.random((R, 3)) * 24 - 12).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(R) % 7 == 0, 0.0, 1e30).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)


def _on(monkeypatch, name):
    """Make the backend module see JAX backend `name`."""
    monkeypatch.setattr(backend, "jax", types.SimpleNamespace(
        default_backend=lambda: name))


def _spy(monkeypatch, module, attr, calls, tag, **bind):
    fn = getattr(module, attr)
    fn = functools.partial(fn, **bind) if bind else fn

    def wrapped(*a, **k):
        calls.append(tag)
        return fn(*a, **k)

    monkeypatch.setattr(module, attr, wrapped)


def _denoise_case(monkeypatch, calls):
    _spy(monkeypatch, FP, "_run_filter", calls, "kernel", interpret=True)
    _spy(monkeypatch, FJ, "stat_filter", calls, "reference")
    ecfg = types.SimpleNamespace(filter_sd=2.0, filter_radius=2)
    dn = FJ.StatDenoiser(ecfg, 12, 10)
    rng = np.random.default_rng(0)
    H, W = 10, 12
    f = [jnp.asarray(rng.random((H, W, 3)), jnp.float32) for _ in range(4)]
    gb = jnp.asarray(rng.random((H, W, 3)), jnp.float32)
    return lambda: dn._filter(
        jnp.full((H, W), 8.0), f[0], f[1], f[2], f[3], gb[None],
        jnp.asarray([-50.0]), gb, (-50.0,) * 3, None, None)["film_mean_f"]


def _fused_case(monkeypatch, calls):
    _spy(monkeypatch, F, "_intersect_pallas", calls, "kernel",
         interpret=True)
    _spy(monkeypatch, F, "_intersect_ref", calls, "reference")
    ft = F.FusedTris.from_tris(*_tris(300, 1))
    o, d, t_max = _rays(200, 2)
    return lambda: F.intersect_fused(ft, o, d, t_max)


def _walk_case(monkeypatch, calls):
    _spy(monkeypatch, TL, "_walk_pallas", calls, "kernel", interpret=True)
    _spy(monkeypatch, TL, "_walk_xla", calls, "reference")
    tl = TL.TwoLevelTris.from_tris(*_tris(700, 3))
    o, d, t_max = _rays(300, 4)
    return lambda: TL.intersect_twolevel(tl, o, d, t_max)


_CASES = {"denoise": _denoise_case, "fused": _fused_case,
          "walk": _walk_case}


@pytest.mark.parametrize("backend_name, expect", [
    ("gpu", "kernel"), ("cpu", "reference"), ("rocm", NotImplementedError)])
@pytest.mark.parametrize("path", sorted(_CASES))
def test_path_choice(monkeypatch, path, backend_name, expect):
    """gpu -> the kernel, cpu -> the plain reference, anything else ->
    an error, for each of the three wrappers."""
    calls = []
    run = _CASES[path](monkeypatch, calls)
    _on(monkeypatch, backend_name)
    if expect is NotImplementedError:
        with pytest.raises(NotImplementedError):
            run()
        assert calls == []
    else:
        run()
        assert calls == [expect]


def test_reference_on_gpu_forces_reference(monkeypatch):
    calls = []
    run = _fused_case(monkeypatch, calls)
    _on(monkeypatch, "gpu")
    with backend.reference_on_gpu("fused"):
        run()
    run()
    assert calls == ["reference", "kernel"]


@pytest.mark.parametrize("path", ["fused", "walk"])
def test_intersector_wrapper_pads_odd_ray_counts(monkeypatch, path):
    """R not a multiple of the kernel's ray block (nor of RT_WALK): the
    wrapper pads, runs the kernel (interpret mode) and crops back, and
    agrees with the reference path lane for lane."""
    p0, e1, e2 = _tris(900, 5)
    o, d, t_max = _rays(1000, 6)
    if path == "fused":
        acc, fn = F.FusedTris.from_tris(p0, e1, e2), F.intersect_fused
        monkeypatch.setattr(F, "_intersect_pallas", functools.partial(
            F._intersect_pallas, interpret=True))
    else:
        acc, fn = TL.TwoLevelTris.from_tris(p0, e1, e2), TL.intersect_twolevel
        monkeypatch.setattr(TL, "_walk_pallas", functools.partial(
            TL._walk_pallas, interpret=True))
    t_r, id_r, hit_r = fn(acc, o, d, t_max)
    _on(monkeypatch, "gpu")
    t_k, id_k, hit_k = fn(acc, o, d, t_max)
    assert t_k.shape == id_k.shape == (1000,)
    np.testing.assert_array_equal(np.asarray(id_k), np.asarray(id_r))
    m = np.asarray(hit_r)
    np.testing.assert_allclose(np.asarray(t_k)[m], np.asarray(t_r)[m],
                               rtol=1e-6)
    assert not np.asarray(hit_k)[::7].any()  # dead lanes never hit


def test_walk_kernel_interpret_matches_xla():
    """The walk kernel body (interpret mode) against the bounded XLA
    walk, on the same worklists, submasks and rays."""
    tl = TL.TwoLevelTris.from_tris(*_tris(3000, 7))
    o, d, t_max = _rays(2 * TL.RT_WALK, 8)
    G = 2
    vote_f = TL._votes_xla(tl.bounds, o, d, t_max)
    vote = vote_f.reshape(G, tl.n_sub, tl.fsub).any(-1)
    mask = TL._pack_submask(vote_f, tl.fsub)
    order, n_eff = TL._compact(vote)
    feat = TL.ray_features16(o, d)
    t_x, id_x = TL._walk_xla(
        tl, order, n_eff, mask,
        feat.reshape(G, TL.RT_WALK, 16).transpose(0, 2, 1),
        t_max.reshape(G, TL.RT_WALK))
    t_k, id_k = TL._walk_pallas(tl.table, order, n_eff, mask, feat.T,
                                t_max, fsub=tl.fsub, interpret=True)
    np.testing.assert_array_equal(np.asarray(id_k),
                                  np.asarray(id_x).reshape(-1))
    m = np.asarray(id_k) >= 0
    assert m.any()
    np.testing.assert_allclose(np.asarray(t_k)[m],
                               np.asarray(t_x).reshape(-1)[m], rtol=1e-6)


def test_walk_xla_dense_fallback_block():
    """A block whose worklist overflows MAXS walks every subtile, and the
    batched walk still matches the dense fused reference."""
    tl = TL.TwoLevelTris.from_tris(*_tris(600, 9))
    ft = F.FusedTris.from_tris(*_tris(600, 9))
    o, d, t_max = _rays(TL.RT_WALK, 10)
    feat = TL.ray_features16(o, d).T[None]
    nst = tl.n_sub
    order = jnp.zeros((1, TL.MAXS), jnp.int32)
    n_eff = jnp.asarray([TL.MAXS + 1], jnp.int32)  # overflow: dense
    t_x, id_x = TL._walk_xla(tl, order, n_eff,
                             jnp.zeros((1, nst * tl.fsub // 32 + 1),
                                       jnp.int32), feat, t_max[None])
    t_r, id_r = F._intersect_ref(ft, o, d, t_max)
    id_r = np.where(np.asarray(id_r) >= 0,
                    np.asarray(ft.perm)[np.maximum(np.asarray(id_r), 0)], -1)
    id_x = np.where(np.asarray(id_x[0]) >= 0,
                    np.asarray(tl.perm)[np.maximum(np.asarray(id_x[0]), 0)],
                    -1)
    np.testing.assert_array_equal(id_x, id_r)


@pytest.mark.parametrize("env_dir", [None, "/x"])
def test_compile_cache_placement(env_dir):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no directory of its
    own; unset: the cache is <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "STATMC_NO_JIT_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", "import statmc_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
        timeout=120).stdout.strip().splitlines()[-1]
    assert out == (env_dir or os.path.join(REPO, ".jax_cache"))
