"""Two-level fused traversal: worklist-driven intersection at scale.

Extends the fused bilinear-form intersector (accel/fused.py) past
FUSED_MAX_TRIS to 100k-1M+ triangle scenes -- the answer to the
reference's full BVH walk over large scenes
(/root/reference/src/accelerators/bvh.cpp:707+).

Shape of the algorithm (no pointer chasing anywhere):

1. BUILD: triangles are Morton-ordered and packed into ST=128-triangle
   subtiles.  Each subtile's edge+plane rows live in ONE [16, 5*ST]
   block in a combined-K layout: the 16 feature rows carry
   [d, o x d, o, 1, pad] so the three edge forms AND the two plane
   forms of all 128 triangles come out of one product per walk step.
   AABBs are additionally kept at FINE granularity (FSUB=4 32-triangle
   subgroups per subtile for scenes <= FINE_MAX_TRIS).
2. SORT: rays partition by (direction octant, origin Morton cell) or,
   for larger scenes and batches, by a stable 8-bucket counting sort on
   the octant alone.  Dead lanes (t_max <= 0) partition to the back so
   whole blocks of them skip every stage.
3. CULL (_votes_xla): every ray slab-tests every FINE subgroup AABB;
   the votes OR-reduce over each RT_WALK-ray block.  One broadcast
   test over all blocks, which XLA fuses into a single reduction.
4. COMPACT (sort-free): fine votes OR-reduce to subtile granularity;
   the per-block vote rows become dense worklists via a cumsum +
   rank-compare.  The fine votes are ALSO bit-packed into per-block
   submask words ([G, nst_fine/32] i32).  Blocks voting for more than
   MAXS subtiles fall back to a dense walk -- conservative, never drops
   a candidate.
5. WALK: each ray block walks ONLY its worklist; per subtile the five
   forms, then the sign-test/plane-t/argmin epilogue per 32-row
   SUBGROUP, gated by the submask bits: a subgroup no ray in the block
   can hit skips its entire epilogue.  On the GPU this is a Pallas
   kernel (Triton route, _walk_pallas): each program takes _WALK_RB
   rays of one block, reads that block's worklist row and count
   itself, and keeps its running (t, id) in registers.  On the CPU
   it is _walk_xla, the same walk batched over all blocks for as many
   steps as the longest worklist.

Results are bit-identical to the dense fused reference up to the
rounding of the products: the worklist and submask are conservative (a
subgroup is only skipped when NO ray in the block can hit its AABB
closer than t_max), and the epilogue is accel/fused.py's (ties resolve
to the smallest packed triangle id in both).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.backend import use_kernel
from .fused import _morton, fold_best, hit_t, ray_inv, tri_forms

ST = 128        # triangles per subtile (worklist granularity)
STF = 32        # triangles per fine subgroup (cull/gating granularity)
RT_WALK = 512   # rays per block (cull/worklist granularity)
MAXS = 384      # worklist slots per block before the dense fallback
FINE_MAX_TRIS = 300_000  # beyond: cull cost is rays*n_fine, gate off
_SORT_MODE = "morton"  # "morton" (argsort, max coherence) | "octant"
_WALK_RB = 128  # rays per walk-kernel program (RT_WALK // 4)
_CHUNK = 16     # triangles per [_CHUNK, _WALK_RB] register tile


class TwoLevelTris(NamedTuple):
    """Packed K16 subtile tables + bounds for the two-level traversal.

    table: [nst, 16, 5*ST] f32.  Feature rows (the contraction axis)
      are [d(0:3), o x d(3:6), o(6:9), 1(9), 0(10:16)]; lanes hold the
      five forms per triangle column-blocked as [w0|w1|w2|num|den]*ST:
        edge k   (w0..w2): rows 0:3 = cross(a_k, b_k), rows 3:6 = b_k-a_k
        plane num:          rows 6:9 = -n, row 9 = n.v0
        plane den:          rows 0:3 = n
      so  out = table[s]^T . feat  yields all five [ST, Rt] forms of
      one subtile from one product.
    bounds: [nf, 8] FINE subgroup AABBs (lo3, hi3, pad2); nf = nst *
      fsub.  fsub = ST // STF for scenes <= FINE_MAX_TRIS, else 1
      (fine AABBs exist to gate epilogue subgroups; for megascale
      scenes the cull cost rays*nf dominates, so gating turns off).
    perm: packed-id -> original-triangle-id map, or None when the scene
      tables were pre-Morton-ordered (driver._morton_order_scene).
    """
    table: Any
    bounds: Any
    perm: Any
    n_tris: int
    n_sub: int
    fsub: int
    world_lo: Any  # [3] scene AABB (ray-sort quantization)
    world_ext: Any  # [3]

    @staticmethod
    def from_tris(p0, e1, e2, fsub: int | None = None) -> "TwoLevelTris":
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        T = p0.shape[0]
        if fsub is None:
            fsub = ST // STF if T <= FINE_MAX_TRIS else 1
        stf = ST // fsub
        if T > 0:
            v0, v1, v2 = p0, p0 + e1, p0 + e2
            tlo = np.minimum(np.minimum(v0, v1), v2)
            thi = np.maximum(np.maximum(v0, v1), v2)
            order = np.argsort(_morton(0.5 * (tlo + thi)), kind="stable")
            p0, e1, e2 = p0[order], e1[order], e2[order]
            tlo, thi = tlo[order], thi[order]
        else:
            order = np.zeros((0,), np.int64)
            tlo = thi = np.zeros((0, 3), np.float32)
        nst = max(1, -(-T // ST))
        nf = nst * fsub
        Tp = nst * ST
        v0, v1, v2 = p0, p0 + e1, p0 + e2
        n = np.cross(e1, e2)

        tab = np.zeros((nst, 16, 5 * ST), np.float32)
        sub = np.arange(T) // ST
        col = np.arange(T) % ST
        for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
            tab[sub, 0:3, k * ST + col] = np.cross(a, b)
            tab[sub, 3:6, k * ST + col] = b - a
        tab[sub, 6:9, 3 * ST + col] = -n
        tab[sub, 9, 3 * ST + col] = np.sum(n * v0, axis=-1)
        tab[sub, 0:3, 4 * ST + col] = n
        # Padded triangle columns are all-zero: every w = 0 ("inside")
        # but den = 0 -> t = inf, so they can never win.

        bounds = np.zeros((nf, 8), np.float32)
        for j in range(nf):
            a, b = j * stf, min((j + 1) * stf, T)
            if a >= T:
                bounds[j, 0:3] = 1e30
                bounds[j, 3:6] = 1e30
                continue
            lo = tlo[a:b].min(axis=0)
            hi = thi[a:b].max(axis=0)
            eps = 1e-4 * max(1.0, float(np.abs(np.stack([lo, hi])).max()))
            bounds[j, 0:3] = lo - eps
            bounds[j, 3:6] = hi + eps

        real = bounds[:, 0] < 1e29
        wlo = (bounds[real, 0:3].min(axis=0) if real.any()
               else np.zeros(3, np.float32))
        whi = (bounds[real, 3:6].max(axis=0) if real.any()
               else np.ones(3, np.float32))

        if np.array_equal(order, np.arange(T)):
            perm = None
        else:
            perm_np = np.full((Tp,), -1, np.int32)
            perm_np[:T] = order.astype(np.int32)
            perm = jnp.asarray(perm_np)
        return TwoLevelTris(
            table=jnp.asarray(tab),
            bounds=jnp.asarray(bounds),
            perm=perm,
            n_tris=T,
            n_sub=nst,
            fsub=fsub,
            world_lo=jnp.asarray(wlo.astype(np.float32)),
            world_ext=jnp.asarray(
                np.maximum(whi - wlo, 1e-6).astype(np.float32)),
        )


def ray_features16(o, d):
    """[R, 16] combined-K features [d, o x d, o, 1, 0...] pairing with
    the K16 table rows (one product yields edge AND plane forms)."""
    m = jnp.cross(o, d)
    one = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    pad = jnp.zeros(o.shape[:-1] + (6,), o.dtype)
    return jnp.concatenate([d, m, o, one, pad], axis=-1)


def _row(form, f):
    """Table row of tri_forms column f of `form` (lanes form*ST + ...)."""
    if form == 3:
        return 9 if f == 3 else 6 + f
    return f


def _feat_rows(feat):
    """[16, R] feature rows -> tri_forms' (d, o x d, o) [1, R] rows."""
    return tuple([feat[a + i][None, :] for i in range(3)] for a in (0, 3, 6))


# ---------------------------------------------------------------------------
# Cull: per-block fine-subgroup votes.


def _votes_xla(bounds, o, d, t_max):
    """[G, nf] bool: does any ray of each RT_WALK-ray block enter fine
    subgroup f's box in front of its origin and before its t_max?  One
    broadcast slab test over all blocks, OR-reduced over each block's
    rays; XLA fuses it into one reduction with no [G, RT, nf]
    temporary."""
    R = o.shape[0]
    G = R // RT_WALK
    ob = o.reshape(G, RT_WALK, 1, 3)
    invb = ray_inv(d).reshape(G, RT_WALK, 1, 3)
    tn = jnp.float32(-1e30)
    tf = t_max.reshape(G, RT_WALK, 1)
    for a in range(3):
        t0 = (bounds[:, a] - ob[..., a]) * invb[..., a]
        t1 = (bounds[:, 3 + a] - ob[..., a]) * invb[..., a]
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    return jnp.any((tn <= tf * 1.0001) & (tf > 0), axis=1)


def _compact(vote, maxs: int = MAXS):
    """Sort-free worklist compaction: vote [G, nst] bool ->
    (order [G, maxs] int32, n_eff [G] int32).

    order[g, j] = id of the (j+1)-th voting subtile, found by ranking
    the vote cumsum (elementwise compares; no [G, nst] sort).  Blocks
    with more than maxs votes fall back to the dense walk: order
    becomes iota and n_eff = nst, which the kernel detects by
    n_eff > maxs -- conservative, never drops a candidate.
    """
    G, nst = vote.shape
    cs = jnp.cumsum(vote.astype(jnp.int32), axis=1)
    count = cs[:, -1]
    over = count > maxs
    tgt = jnp.arange(1, maxs + 1, dtype=jnp.int32)

    def chunk(csb):
        return jnp.sum(csb[:, :, None] < tgt[None, None, :], axis=1
                       ).astype(jnp.int32)

    CH = 8
    Gc = -(-G // CH)
    if Gc * CH != G:
        cs = jnp.pad(cs, ((0, Gc * CH - G), (0, 0)))
    order = jax.lax.map(chunk, cs.reshape(Gc, CH, nst)
                        ).reshape(Gc * CH, maxs)[:G]
    order = jnp.where(over[:, None],
                      jnp.arange(maxs, dtype=jnp.int32)[None], order)
    n_eff = jnp.where(over, nst, count)
    return order, n_eff


def _pack_submask(vote_f, fsub: int):
    """Fine votes [G, nf] bool -> per-block bit words [G, nw] i32
    (bit i of word w = vote for fine subgroup w*32+i).  Elementwise;
    the walk reads one word per gated subgroup."""
    G, nf = vote_f.shape
    nw = max(1, -(-nf // 32))
    v = vote_f
    if nw * 32 != nf:
        v = jnp.pad(vote_f, ((0, 0), (0, nw * 32 - nf)))
    bits = jnp.left_shift(
        jnp.ones((), jnp.int32), jnp.arange(32, dtype=jnp.int32))
    return jnp.sum(
        v.reshape(G, nw, 32).astype(jnp.int32) * bits[None, None, :],
        axis=-1, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Walk: the five forms per worklist subtile + submask-gated epilogue.


def _submask_bit(word_at, fid):
    """Vote bit of fine subgroup fid; word_at(w) reads word w of the
    block's packed mask row."""
    word = word_at(jax.lax.shift_right_logical(fid, 5))
    return jax.lax.shift_right_logical(word, jax.lax.rem(fid, 32)) & 1


def _walk_kernel(feat_ref, tmax_ref, order_ref, count_ref, mask_ref,
                 tab_ref, t_ref, id_ref, *, fsub: int):
    """One program: _WALK_RB rays of block g walk g's worklist.
    feat_ref block [16, RB]: rows d(0:3), o x d(3:6), o(6:9), 1(9)."""
    RB = _WALK_RB
    g = pl.program_id(0) // (RT_WALK // RB)
    d, m, o = _feat_rows([feat_ref[f, :] for f in range(9)])
    tmax = tmax_ref[:].reshape(1, RB)
    n = count_ref[g]
    dense = n > MAXS
    stf = ST // fsub
    iota = jax.lax.broadcasted_iota(jnp.int32, (_CHUNK, RB), 0)

    def chunk(tid, off, best):
        def col(form, f):  # [_CHUNK, 1]
            return tab_ref[tid, _row(form, f),
                           pl.ds(form * ST + off, _CHUNK)].reshape(_CHUNK, 1)

        tc = hit_t(*tri_forms(col, d, m, o))
        return fold_best(tc, iota + (tid * ST + off), *best)

    def step(k, best):
        # Overflow blocks (n > MAXS) walk densely: subtile id == k.
        tid = jnp.where(dense, k, order_ref[g, jnp.minimum(k, MAXS - 1)])
        for jj in range(fsub):
            def group(best, jj=jj):
                for c0 in range(0, stf, _CHUNK):
                    best = chunk(tid, jj * stf + c0, best)
                return best

            if fsub > 1:
                bit = _submask_bit(lambda w: mask_ref[g, w],
                                   tid * fsub + jj)
                best = jax.lax.cond(dense | (bit > 0), group,
                                    lambda b: b, best)
            else:
                best = group(best)
        return best

    best = (tmax, jnp.full((1, RB), -1, jnp.int32))
    best = jax.lax.cond(jnp.max(tmax) > 0,
                        lambda b: jax.lax.fori_loop(0, n, step, b),
                        lambda b: b, best)
    t_ref[:] = best[0].reshape(RB)
    id_ref[:] = best[1].reshape(RB)


@functools.partial(jax.jit, static_argnames=("fsub", "interpret"))
def _walk_pallas(table, order, count, mask, feat, t_max, fsub: int,
                 interpret: bool = False):
    """feat: [16, Rp] ray rows, t_max: [Rp] (Rp = G * RT_WALK); order
    [G, MAXS], count [G], mask [G, nw] -> (t, id) each [Rp]."""
    Rp = t_max.shape[0]
    kern = functools.partial(_walk_kernel, fsub=fsub)
    whole = pl.BlockSpec(memory_space=pl.ANY)
    flat = pl.BlockSpec((_WALK_RB,), lambda i: (i,))
    return pl.pallas_call(
        kern,
        grid=(Rp // _WALK_RB,),
        in_specs=[pl.BlockSpec((16, _WALK_RB), lambda i: (0, i)), flat,
                  whole, whole, whole, whole],
        out_specs=[flat, flat],
        out_shape=[
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="walk_twolevel",
    )(feat, t_max, order, count, mask, table)


def _walk_xla(tl: "TwoLevelTris", order, n_eff, mask, feat, t_max):
    """Plain XLA walk (the CPU path and the kernel's reference): all
    blocks step together, each through its own worklist, for as many
    steps as the longest one (a dense-fallback block needs nst); a
    block past its count contributes nothing.  Same semantics as the
    kernel.  feat [G, 16, RT], t_max [G, RT] -> (t, id) each [G, RT]."""
    nst = tl.table.shape[0]
    fsub = tl.fsub
    stf = ST // fsub
    iota_f = jax.lax.broadcasted_iota(jnp.int32, (stf, RT_WALK), 0)
    inf = jnp.float32(1e30)

    def block_step(k, orderb, nb, maskb, featb, best):
        dense = nb > MAXS
        tid = jnp.where(dense, k, orderb[jnp.minimum(k, MAXS - 1)])
        tid = jnp.minimum(tid, nst - 1)
        tab = tl.table[tid]  # [16, 5*ST]
        rows = _feat_rows(featb)
        for jj in range(fsub):
            go = k < nb
            if fsub > 1:
                bit = _submask_bit(lambda w: maskb[w], tid * fsub + jj)
                go = go & (dense | (bit > 0))
            off = jj * stf

            def col(form, f, off=off):
                a = form * ST + off
                return tab[_row(form, f), a:a + stf][:, None]

            tc = jnp.where(go, hit_t(*tri_forms(col, *rows)), inf)
            best = fold_best(tc, iota_f + (tid * ST + off), *best)
        return best

    step = jax.vmap(block_step, in_axes=(None, 0, 0, 0, 0, 0))
    G = feat.shape[0]
    best = (t_max[:, None, :], jnp.full((G, 1, RT_WALK), -1, jnp.int32))
    best = jax.lax.fori_loop(
        0, jnp.max(n_eff),
        lambda k, b: step(k, order, n_eff, mask, feat, b), best)
    return best[0][:, 0], best[1][:, 0]


def _spread5(x):
    """Interleave 5-bit ints with 2-bit gaps (Morton, 15-bit total)."""
    x = x & 0x1F
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def _morton_partition(tl, o, d, t_max):
    """Full-coherence ordering: argsort by (octant, origin Morton cell).
    Used for fine-gated scene sizes, where block coherence decides how
    many subtiles each block walks; _octant_partition is the cheap
    alternative for larger scenes and batches."""
    R = o.shape[0]
    q = jnp.clip(((o - tl.world_lo) / tl.world_ext * 32.0)
                 .astype(jnp.int32), 0, 31)
    morton = (_spread5(q[:, 0]) | (_spread5(q[:, 1]) << 1)
              | (_spread5(q[:, 2]) << 2))
    octant = ((d[:, 0] > 0).astype(jnp.int32) * 4
              + (d[:, 1] > 0).astype(jnp.int32) * 2
              + (d[:, 2] > 0).astype(jnp.int32))
    key = (octant << 15) | morton
    key = jnp.where(t_max > 0, key, jnp.int32(1 << 20))
    perm = jnp.argsort(key)
    pos = jnp.zeros_like(perm).at[perm].set(jnp.arange(R, dtype=perm.dtype))
    return perm, pos


def _octant_partition(o, d, t_max):
    """Stable 9-bucket counting partition by direction octant (dead
    lanes, t_max <= 0, go last): (perm, pos) with pos the destination
    lane of each input lane and perm its inverse.

    Cumsums + one scatter instead of the octant+Morton argsort.  Lanes
    arrive in pixel order, so within-octant origins stay spatially
    coherent -- block coherence, which is all the per-block cull
    needs."""
    R = o.shape[0]
    octant = ((d[:, 0] > 0).astype(jnp.int32) * 4
              + (d[:, 1] > 0).astype(jnp.int32) * 2
              + (d[:, 2] > 0).astype(jnp.int32))
    key = jnp.where(t_max > 0, octant, jnp.int32(8))
    pos = jnp.zeros((R,), jnp.int32)
    base = jnp.int32(0)
    for b in range(9):
        m = key == b
        mi = m.astype(jnp.int32)
        ranks = jnp.cumsum(mi) - 1
        pos = jnp.where(m, base + ranks, pos)
        base = base + jnp.sum(mi)
    perm = jnp.zeros((R,), jnp.int32).at[pos].set(
        jnp.arange(R, dtype=jnp.int32))
    return perm, pos


def intersect_twolevel(tl: TwoLevelTris, o, d, t_max,
                       any_hit: bool = False, sort: bool = True):
    """Closest (or any) hit; same contract as fused.intersect_fused.

    sort=True partitions rays by direction octant before blocking: the
    worklist cull is per RT_WALK-ray BLOCK, so block coherence decides
    how many subtiles each block walks.  Secondary/bounce rays arrive
    direction-shuffled from the wavefront integrator and need it;
    already-coherent batches (camera/shadow rays in pixel order) can
    pass sort=False to skip the partition + packed gathers.  Results
    are identical either way (the worklist is conservative and the
    epilogue math is shared)."""
    R = o.shape[0]
    if sort:
        # Morton argsort only for fine-gated scene sizes and moderate
        # batches; the cheap counting partition everywhere bigger.
        if (tl.n_tris <= FINE_MAX_TRIS and R <= 1_100_000
                and _SORT_MODE == "morton"):
            perm, pos = _morton_partition(tl, o, d, t_max)
        else:
            perm, pos = _octant_partition(o, d, t_max)
        # One packed gather for the permutation: [o(3), d(3), tmax(1)].
        packed = jnp.concatenate([o, d, t_max[:, None]], axis=-1)[perm]
        o, d = packed[:, 0:3], packed[:, 3:6]
        t_max = packed[:, 6]

    G = max(1, -(-R // RT_WALK))
    Rp = G * RT_WALK

    def pad(x, fill):
        return jnp.pad(x, [(0, Rp - R)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=fill)

    o_p, d_p = pad(o, 0.0), pad(d, 1.0)
    tm_p = pad(t_max, 0.0)
    nst = tl.table.shape[0]
    vote_f = _votes_xla(tl.bounds, o_p, d_p, tm_p)
    if tl.fsub > 1:
        vote = vote_f.reshape(G, nst, tl.fsub).any(-1)
        mask = _pack_submask(vote_f, tl.fsub)
    else:
        vote = vote_f
        mask = jnp.zeros((G, 1), jnp.int32)
    order, n_eff = _compact(vote)

    feat = ray_features16(o_p, d_p)  # [Rp, 16]
    if use_kernel("walk"):
        t, idx = _walk_pallas(tl.table, order, n_eff, mask, feat.T, tm_p,
                              fsub=tl.fsub)
    else:
        t, idx = _walk_xla(
            tl, order, n_eff, mask,
            feat.reshape(G, RT_WALK, 16).transpose(0, 2, 1),
            tm_p.reshape(G, RT_WALK))
    t = t.reshape(-1)[:R]
    idx = idx.reshape(-1)[:R]
    if tl.perm is not None:
        idx = jnp.where(idx >= 0, jnp.take(tl.perm, jnp.maximum(idx, 0)),
                        -1)
    else:
        idx = jnp.where(idx >= tl.n_tris, -1, idx)
    if not sort:
        return t, idx, idx >= 0
    # Unsort back to caller lane order: one packed gather by pos.  t
    # rides as bitcast int32 lanes next to idx -- int transport
    # preserves bit patterns exactly, whereas the reverse (idx as f32)
    # would carry idx = -1 (0xFFFFFFFF) as a NaN pattern that float
    # paths may canonicalize, turning misses into bogus hits.
    out = jnp.stack(
        [jax.lax.bitcast_convert_type(t, jnp.int32), idx], axis=-1)[pos]
    t = jax.lax.bitcast_convert_type(out[:, 0], jnp.float32)
    idx = out[:, 1]
    return t, idx, idx >= 0
