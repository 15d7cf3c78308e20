"""Two-level worklist traversal correctness (accel/twolevel.py).

The worklist walk must be exactly the dense fused intersection: the
block-level cull is conservative, the compaction keeps every voting
subtile (or falls back to a dense walk on overflow), and the K16
one-dot epilogue reproduces the fused epilogue's expression order, so
(t, id) agree bit-for-bit wherever the dense path finds a hit.
"""
import numpy as np
import jax.numpy as jnp

from statmc_tpu.accel.fused import FusedTris, _intersect_ref
from statmc_tpu.accel import twolevel as TL
from statmc_tpu.accel.twolevel import TwoLevelTris, intersect_twolevel


def _random_tris(T, seed=0):
    rng = np.random.default_rng(seed)
    p0 = (rng.random((T, 3)) * 20 - 10).astype(np.float32)
    e1 = (rng.random((T, 3)) - 0.5).astype(np.float32)
    e2 = (rng.random((T, 3)) - 0.5).astype(np.float32)
    return p0, e1, e2


def _random_rays(R, seed=1):
    rng = np.random.default_rng(seed)
    o = (rng.random((R, 3)) * 24 - 12).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_twolevel_matches_dense_fused():
    p0, e1, e2 = _random_tris(2000)
    ft = FusedTris.from_tris(p0, e1, e2)
    tl = TwoLevelTris.from_tris(p0, e1, e2)
    o, d = _random_rays(1024)
    t_max = jnp.full((1024,), 1e30)

    t_ref, id_ref = _intersect_ref(ft, o, d, t_max)
    id_ref = np.where(np.asarray(id_ref) >= 0,
                      np.asarray(ft.perm)[np.maximum(np.asarray(id_ref), 0)],
                      -1)

    t2, id2, hit2 = intersect_twolevel(tl, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(id2), id_ref)
    m = id_ref >= 0
    np.testing.assert_allclose(np.asarray(t2)[m], np.asarray(t_ref)[m],
                               rtol=1e-6)


def test_twolevel_nosort_matches_sorted():
    """sort=False (coherent-batch fast path) must agree exactly with the
    sorted path: the worklist is conservative either way."""
    p0, e1, e2 = _random_tris(1800, seed=9)
    tl = TwoLevelTris.from_tris(p0, e1, e2)
    o, d = _random_rays(1024, seed=10)
    t_max = jnp.full((1024,), 1e30)
    t1, id1, h1 = intersect_twolevel(tl, o, d, t_max, sort=True)
    t2, id2, h2 = intersect_twolevel(tl, o, d, t_max, sort=False)
    np.testing.assert_array_equal(np.asarray(id1), np.asarray(id2))
    m = np.asarray(h1)
    np.testing.assert_allclose(np.asarray(t1)[m], np.asarray(t2)[m],
                               rtol=1e-6)


def test_twolevel_any_hit_and_dead_lanes():
    p0, e1, e2 = _random_tris(1500, seed=3)
    tl = TwoLevelTris.from_tris(p0, e1, e2)
    o, d = _random_rays(512, seed=4)
    # Half the lanes dead (t_max = 0) -- they must report no hit.
    t_max = jnp.where(jnp.arange(512) % 2 == 0, 1e30, 0.0)
    t, idx, hit = intersect_twolevel(tl, o, d, t_max, any_hit=True)
    hit = np.asarray(hit)
    assert not hit[1::2].any()
    assert hit[0::2].any()  # dense random soup: some ray hits something


def test_worklists_are_conservative():
    """Every subtile that contains a ray's true hit must be in that
    ray's block worklist (within n_eff)."""
    p0, e1, e2 = _random_tris(3000, seed=5)
    ft = FusedTris.from_tris(p0, e1, e2)
    tl = TwoLevelTris.from_tris(p0, e1, e2)
    R = TL.RT_WALK
    o, d = _random_rays(R, seed=6)
    t_max = jnp.full((R,), 1e30)
    t_ref, id_packed = _intersect_ref(ft, o, d, t_max)
    vote_f = TL._votes_xla(tl.bounds, o, d, t_max)
    G = vote_f.shape[0]
    vote = vote_f.reshape(G, tl.n_sub, tl.fsub).any(-1)
    order, n_eff = TL._compact(vote)
    order, n_eff = np.asarray(order), np.asarray(n_eff)
    vote_f = np.asarray(vote_f)
    stf = TL.ST // tl.fsub
    idp = np.asarray(id_packed[0] if id_packed.ndim > 1 else id_packed)
    for r in range(R):
        if idp[r] < 0:
            continue
        s = idp[r] // TL.ST
        g = r // TL.RT_WALK
        if n_eff[g] > TL.MAXS:  # dense-fallback block: everything walks
            continue
        assert s in order[g, : n_eff[g]], (r, s)
        # The fine submask must also keep the true hit's subgroup.
        assert vote_f[g, idp[r] // stf], (r, idp[r] // stf)


def test_compact_overflow_falls_back_dense():
    """A block voting for more than MAXS subtiles must switch to the
    dense-walk sentinel (n_eff = nst) instead of dropping candidates."""
    nst = TL.MAXS * 2
    vote = jnp.ones((1, nst), bool)
    order, n_eff = TL._compact(vote)
    assert int(n_eff[0]) == nst
    np.testing.assert_array_equal(np.asarray(order[0]),
                                  np.arange(TL.MAXS))


def test_pack_submask_roundtrip():
    """Bit-packed fine votes must decode back to the vote row (the walk
    walk reads these words bit by bit)."""
    rng = np.random.default_rng(11)
    nf = 203
    vote = rng.random((5, nf)) < 0.3
    words = np.asarray(TL._pack_submask(jnp.asarray(vote), 4))
    for g in range(5):
        for f in range(nf):
            bit = (words[g, f // 32] >> (f % 32)) & 1
            assert bool(bit) == bool(vote[g, f]), (g, f)
