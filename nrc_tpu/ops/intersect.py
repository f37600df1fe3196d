"""Ray-scene intersection: the replacement for OptiX RT cores.

The reference delegates all traversal to ``optixTrace`` against a two-level
GAS/IAS (``Device.cpp:1845-2253``). This renderer uses no ray-tracing
hardware, so intersection is an explicit data-parallel computation over the ray wavefront:

- ``intersect_bruteforce`` / ``occluded_bruteforce``: every ray against every
  triangle (Möller–Trumbore), chunked over triangles with a running min.
  Dense and branch-free — for small scenes it was faster than divergent
  traversal on an earlier accelerator, and it is the default below
  ``BVH_THRESHOLD`` triangles.
- ``intersect_bvh`` / ``occluded_bvh``: stackless skip-link BVH traversal
  (lockstep ``lax.while_loop`` over the whole wavefront) over the
  pre-order-flattened binned-SAH BVH from ``ops/bvh.py`` for large scenes.

Closest-hit returns (t, prim, u, v); any-hit (shadow rays,
``__anyhit__shadow`` equivalent, ``hit.cu:1428-1468``) returns a bool mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.math import cross, dot

RT_MAX = np.float32(3.0e38)
BVH_THRESHOLD = 16384  # switch to BVH traversal above this many triangles


class TriSoA(NamedTuple):
    """Precomputed triangle SoA for Möller–Trumbore.

    ``packed`` ([T, 9] = p0|e1|e2) serves the per-winner epilogue with ONE
    row gather instead of three.
    """

    p0: jnp.ndarray  # [T, 3]
    e1: jnp.ndarray  # [T, 3] = p1 - p0
    e2: jnp.ndarray  # [T, 3] = p2 - p0
    packed: jnp.ndarray = None  # [T, 9] = p0|e1|e2 (optional)

    @staticmethod
    def build(p0, p1, p2) -> "TriSoA":
        p0 = jnp.asarray(p0, jnp.float32)
        e1 = jnp.asarray(p1, jnp.float32) - p0
        e2 = jnp.asarray(p2, jnp.float32) - p0
        return TriSoA(p0, e1, e2, jnp.concatenate([p0, e1, e2], axis=-1))

    @property
    def num(self) -> int:
        return self.p0.shape[0]

    def gather_rows(self, idx):
        """(p0, e1, e2) rows by index via one packed gather."""
        if self.packed is not None:
            row = self.packed[idx]
            return row[..., 0:3], row[..., 3:6], row[..., 6:9]
        return self.p0[idx], self.e1[idx], self.e2[idx]


class Hit(NamedTuple):
    t: jnp.ndarray      # [N] f32, RT_MAX when missed
    prim: jnp.ndarray   # [N] i32, -1 when missed
    u: jnp.ndarray      # [N] f32 barycentric
    v: jnp.ndarray      # [N] f32

    @property
    def valid(self) -> jnp.ndarray:
        return self.prim >= 0


def _mt_hits(org, direction, tris: TriSoA, tmin, tmax):
    """All-pairs Möller–Trumbore: rays [N,3] x tris [T] -> (t, u, v, ok) [N, T].

    Component-SoA formulation: every intermediate is an [N, T] plane (rays
    by triangles). A packed [N, T, 3] layout puts the 3-vector on the
    minor dimension, which measured far slower on an earlier accelerator.
    """
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]          # [N, 1]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    p0x, p0y, p0z = tris.p0[None, :, 0], tris.p0[None, :, 1], tris.p0[None, :, 2]
    e1x, e1y, e1z = tris.e1[None, :, 0], tris.e1[None, :, 1], tris.e1[None, :, 2]
    e2x, e2y, e2z = tris.e2[None, :, 0], tris.e2[None, :, 1], tris.e2[None, :, 2]

    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    # tvec = o - p0
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    ok = ok & (t > tmin[:, None]) & (t < tmax[:, None])
    return t, u, v, ok


def intersect_bruteforce(
    org: jnp.ndarray,
    direction: jnp.ndarray,
    tris: TriSoA,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    chunk: int = 512,
) -> Hit:
    """Closest hit by chunked brute force. org/direction [N,3], tmin/tmax [N]."""
    n = org.shape[0]
    num_t = tris.num
    if num_t == 0:
        return Hit(
            t=jnp.full((n,), RT_MAX),
            prim=jnp.full((n,), -1, jnp.int32),
            u=jnp.zeros((n,)),
            v=jnp.zeros((n,)),
        )

    chunk = min(chunk, num_t)
    num_chunks = -(-num_t // chunk)
    padded = num_chunks * chunk
    pad = padded - num_t

    def pad_t(x):
        return jnp.pad(x, ((0, pad), (0, 0))) if pad else x

    tri_pad = TriSoA(pad_t(tris.p0), pad_t(tris.e1), pad_t(tris.e2))
    tri_chunks = jax.tree.map(
        lambda x: x.reshape(num_chunks, chunk, 3), tri_pad
    )

    # Single-reduction argmin via IEEE key packing: all candidate t are
    # >= tmin >= 0, so the int32 bit pattern of t is order-preserving;
    # truncate the low mantissa bits and pack the lane index there, then
    # ONE int-min reduction yields both winner-t and winner-lane. (The
    # two-reduction formulation duplicated the fused Moller-Trumbore
    # producer into both reduction fusions.)
    lane_bits = max((chunk - 1).bit_length(), 1)
    lane_mask = np.int32((1 << lane_bits) - 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
    miss_key = np.int32(np.float32(RT_MAX).view(np.int32) & ~lane_mask)

    def body(carry, tri_c):
        best_key, best_prim, base = carry
        cap = jnp.minimum(
            tmax, (best_key & ~lane_mask).view(jnp.float32)
        )
        t, _, _, ok = _mt_hits(
            org, direction, TriSoA(*tri_c), tmin, cap
        )
        key = jnp.where(
            ok, (t.view(jnp.int32) & ~lane_mask) | lane, miss_key | lane
        )
        key_min = jnp.min(key, axis=1)
        closer = key_min < best_key
        best_prim = jnp.where(
            closer & (key_min < miss_key),
            base + (key_min & lane_mask),
            best_prim,
        )
        best_key = jnp.minimum(best_key & ~lane_mask, key_min & ~lane_mask)
        return (best_key, best_prim, base + chunk), None

    init = (
        jnp.full((n,), miss_key, jnp.int32),
        jnp.full((n,), -1, jnp.int32),
        np.int32(0),
    )
    (_, prim, _), _ = jax.lax.scan(body, init, tri_chunks)

    # Re-derive exact t + barycentrics for the single winner per ray (O(N));
    # the truncated key-t only arbitrates the winner (2^-13 relative ties).
    valid = prim >= 0
    pi = jnp.maximum(prim, 0)
    p0, e1, e2 = tris.gather_rows(pi)
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
    tvec = org - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    u = jnp.where(valid, u, 0.0)
    v = jnp.where(valid, v, 0.0)
    t = jnp.where(valid, t, RT_MAX)
    return Hit(t=t, prim=prim, u=u, v=v)


def occluded_bruteforce(
    org: jnp.ndarray,
    direction: jnp.ndarray,
    tris: TriSoA,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    chunk: int = 512,
) -> jnp.ndarray:
    """Any-hit visibility test -> bool [N] (True = occluded)."""
    n = org.shape[0]
    num_t = tris.num
    if num_t == 0:
        return jnp.zeros((n,), bool)

    chunk = min(chunk, num_t)
    num_chunks = -(-num_t // chunk)
    pad = num_chunks * chunk - num_t

    def pad_t(x):
        return jnp.pad(x, ((0, pad), (0, 0))) if pad else x

    tri_chunks = jax.tree.map(
        lambda x: x.reshape(num_chunks, chunk, 3),
        TriSoA(pad_t(tris.p0), pad_t(tris.e1), pad_t(tris.e2)),
    )

    def body(occ, tri_c):
        _, _, _, ok = _mt_hits(org, direction, TriSoA(*tri_c), tmin, tmax)
        return occ | jnp.any(ok, axis=1), None

    occ, _ = jax.lax.scan(body, jnp.zeros((n,), bool), tri_chunks)
    return occ


# ---------------------------------------------------------------------------
# BVH traversal — stackless skip links, lockstep over the wavefront
# ---------------------------------------------------------------------------
#
# The flattened layout (``ops/bvh.py::flatten_skip_links``) numbers nodes in
# pre-order: an inner node's "hit" successor is node+1 and every node stores
# its pre-order "miss" successor, so the whole wavefront advances one node
# pointer per step with two row gathers and dense vector math — no per-ray
# stack (whose [N, depth] scatter updates made the old vmapped-stack
# traversal far slower than brute force). Leaves hold exactly
# ``leaf_size`` packed triangles (degenerate-padded), unrolled statically.


def _skip_traverse(org, direction, bvh, tmin, tmax, any_hit: bool):
    """Two-phase lockstep walk. The inner *descend* while_loop advances
    through inner nodes with only the [N, 8] node-row gather + slab test;
    lanes that reach a leaf whose box they hit PARK there. When every lane
    is parked (at a leaf or the sentinel) the outer step runs the leaf
    batch once: the second [N, K*10] row gather + K triangle tests, then
    advances parked lanes to their miss links. Inner-node visits outnumber
    leaf visits and no longer pay the leaf gather + K intersection tests
    (faster than the unified step on an earlier accelerator)."""
    n = org.shape[0]
    octants, block = bvh["node_box"].shape[0], bvh["node_box"].shape[1]
    nodes_flat = bvh["node_box"].reshape(-1, 8)
    # per-ray octant picks the near-child-first pre-order variant
    if octants > 1:
        base = (
            (direction[:, 0] > 0).astype(jnp.int32)
            | ((direction[:, 1] > 0).astype(jnp.int32) << 1)
            | ((direction[:, 2] > 0).astype(jnp.int32) << 2)
        ) * block
    else:
        base = jnp.zeros((n,), jnp.int32)
    sentinel = base + (block - 1)
    leaf_size = bvh["leaf_pack"].shape[1] // 10  # static, from the row width
    inv_d = jnp.where(
        jnp.abs(direction) > 1e-20,
        1.0 / jnp.where(direction != 0.0, direction, 1.0),
        np.float32(3.0e38),
    )

    def descend_cond(s):
        node, lrow, _, _ = s
        return jnp.any((node != sentinel) & (lrow < 0))

    def descend(s):
        node, lrow, best_t, best_prim = s
        active = (node != sentinel) & (lrow < 0)
        row = nodes_flat[node]                     # [N, 8]
        lo, hi = row[:, 0:3], row[:, 3:6]
        miss = row[:, 6].view(jnp.int32)
        lr = row[:, 7].view(jnp.int32)
        is_leaf = lr >= 0
        t0 = (lo - org) * inv_d
        t1 = (hi - org) * inv_d
        near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        cap = jnp.minimum(tmax, best_t)
        hit_box = jnp.maximum(near, tmin) <= jnp.minimum(far, cap)
        park = hit_box & is_leaf
        new_lrow = jnp.where(active, jnp.where(park, lr, -1), lrow)
        nxt = jnp.where(hit_box & ~is_leaf, node + 1, miss)
        nxt = jnp.where(park, node, nxt)  # parked lanes advance in outer
        nxt = jnp.where(active, nxt, node)
        return nxt, new_lrow, best_t, best_prim

    def outer_cond(s):
        node, _, _, _ = s
        return jnp.any(node != sentinel)

    def outer(s):
        node, lrow, best_t, best_prim = jax.lax.while_loop(
            descend_cond, descend, s
        )
        # every lane is at the sentinel or parked at a hit leaf (lrow >= 0).
        # All leaf_size triangles are tested as ONE set of [N, K]-shaped ops:
        # a per-triangle unrolled loop emits ~15*K tiny [N] ops, each
        # dispatch-bound at chunk size.
        do_leaf = lrow >= 0
        tri = bvh["leaf_pack"][jnp.maximum(lrow, 0)]    # [N, K*10]
        blk = tri[:, : 9 * leaf_size].reshape(n, leaf_size, 9)
        p0 = blk[..., 0:3]
        e1 = blk[..., 3:6]
        e2 = blk[..., 6:9]
        pid = tri[:, 9 * leaf_size:].view(jnp.int32)    # [N, K]
        dirn = direction[:, None, :]
        pvec = jnp.cross(dirn, e2)
        det = jnp.sum(e1 * pvec, axis=-1)               # [N, K]
        ok = jnp.abs(det) > 1e-12
        invd = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        tvec = org[:, None, :] - p0
        u = jnp.sum(tvec * pvec, axis=-1) * invd
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(dirn * qvec, axis=-1) * invd
        t = jnp.sum(e2 * qvec, axis=-1) * invd
        cap = jnp.minimum(tmax, best_t)
        ok = (
            do_leaf[:, None] & ok & (pid >= 0)
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > tmin[:, None]) & (t < cap[:, None])
        )
        t_ok = jnp.where(ok, t, RT_MAX)
        k_best = jnp.argmin(t_ok, axis=1)
        t_best = jnp.min(t_ok, axis=1)
        hit_any = t_best < cap
        # one-hot select, NOT take_along_axis (lowers to a per-lane gather)
        oh_k = (
            jax.lax.broadcasted_iota(jnp.int32, (n, leaf_size), 1)
            == k_best[:, None]
        )
        pid_best = jnp.sum(jnp.where(oh_k, pid, 0), axis=1, dtype=jnp.int32)
        best_t = jnp.where(hit_any, t_best, best_t)
        best_prim = jnp.where(hit_any, pid_best, best_prim)

        # advance parked lanes to their miss links
        row = nodes_flat[node]
        miss = row[:, 6].view(jnp.int32)
        nxt = jnp.where(do_leaf, miss, node)
        if any_hit:
            nxt = jnp.where(best_prim >= 0, sentinel, nxt)
        return nxt, jnp.full((n,), -1, jnp.int32), best_t, best_prim

    # lanes with an empty t-range (inactive rays) start done
    node0 = jnp.where(tmax <= tmin, sentinel, base)
    _, _, t, prim = jax.lax.while_loop(
        outer_cond, outer,
        (node0, jnp.full((n,), -1, jnp.int32),
         jnp.full((n,), RT_MAX), jnp.full((n,), -1, jnp.int32)),
    )
    return t, prim


# A lockstep walk gathers one node row for EVERY lane, finished or not, and
# runs until the LAST lane finishes. Splitting the batch into chunks of
# coherent rays (sorted by direction octant + quantized direction + origin
# Morton code) lets each chunk's while_loop exit as soon as ITS slowest ray
# finishes, with bit-identical results; lax.map runs chunks sequentially.
# The chunk size was chosen on an earlier accelerator and is not yet
# re-measured on the GPU.
import os as _os

TRAVERSAL_CHUNK = int(_os.environ.get("NRC_TRAVERSAL_CHUNK", "512"))


def _part_bits(v):
    """Spread 5 bits to every 3rd position (for 3-axis Morton interleave)."""
    v = (v | (v << 8)) & 0x100F
    v = (v | (v << 4)) & 0x10C3
    v = (v | (v << 2)) & 0x1249
    return v


def _coherence_key(org, direction, tmin, tmax, root_lo, root_hi):
    """Sort key: [dead:1 | octant:3 | dir_q:6 | org_morton:15]. Dead lanes
    (empty t-range) sort last so they pool into chunks that exit at once."""
    oct_ = (
        (direction[:, 0] > 0).astype(jnp.int32)
        | ((direction[:, 1] > 0).astype(jnp.int32) << 1)
        | ((direction[:, 2] > 0).astype(jnp.int32) << 2)
    )
    dq = jnp.clip(((direction + 1.0) * 1.999).astype(jnp.int32), 0, 3)
    ext = jnp.maximum(root_hi - root_lo, 1e-30)
    oq = jnp.clip(((org - root_lo) / ext * 31.999).astype(jnp.int32), 0, 31)
    morton = (
        _part_bits(oq[:, 0]) | (_part_bits(oq[:, 1]) << 1)
        | (_part_bits(oq[:, 2]) << 2)
    )
    key = (oct_ << 21) | (dq[:, 0] << 19) | (dq[:, 1] << 17) | (dq[:, 2] << 15) | morton
    return jnp.where(tmax <= tmin, jnp.int32(1 << 24), key)


def chunked_over_rays(traverse_fn, org, direction, bvh, tmin, tmax):
    """Coherence-sorted chunked wrapper shared by the triangle, wide, and
    curve walks. ``traverse_fn(org, dir, tmin, tmax) -> (t, prim)`` runs per
    chunk; dead-lane padding uses tmin=1/tmax=0 (starts at the sentinel)
    and the `_coherence_key` dead bit pools such lanes into tail chunks.
    ``bvh`` is either the skip-link dict (root box from ``node_box`` row 0)
    or an explicit ``(root_lo, root_hi)`` pair."""
    if isinstance(bvh, dict):
        nodes_flat = bvh["node_box"].reshape(-1, 8)
        root_lo, root_hi = nodes_flat[0, 0:3], nodes_flat[0, 3:6]
    else:
        root_lo, root_hi = bvh
    n = org.shape[0]
    if n < 2 * TRAVERSAL_CHUNK:
        return traverse_fn(org, direction, tmin, tmax)
    pad = (-n) % TRAVERSAL_CHUNK
    if pad:
        org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
        direction = jnp.concatenate(
            [direction, jnp.ones((pad, 3), direction.dtype)]
        )
        tmin = jnp.concatenate([tmin, jnp.ones((pad,), tmin.dtype)])
        tmax = jnp.concatenate([tmax, jnp.zeros((pad,), tmax.dtype)])
    m = n + pad
    key = _coherence_key(org, direction, tmin, tmax, root_lo, root_hi)
    perm = jnp.argsort(key)
    c = m // TRAVERSAL_CHUNK
    so = org[perm].reshape(c, TRAVERSAL_CHUNK, 3)
    sd = direction[perm].reshape(c, TRAVERSAL_CHUNK, 3)
    stn = tmin[perm].reshape(c, TRAVERSAL_CHUNK)
    stx = tmax[perm].reshape(c, TRAVERSAL_CHUNK)

    def one(args):
        o, dd, tn, tx = args
        return traverse_fn(o, dd, tn, tx)

    t, prim = jax.lax.map(one, (so, sd, stn, stx))
    t = t.reshape(m)
    prim = prim.reshape(m)
    inv = jnp.zeros(m, jnp.int32).at[perm].set(jnp.arange(m, dtype=jnp.int32))
    return t[inv][:n], prim[inv][:n]


def _chunked_traverse(org, direction, bvh, tmin, tmax, any_hit: bool):
    return chunked_over_rays(
        lambda o, d, tn, tx: _skip_traverse(o, d, bvh, tn, tx, any_hit),
        org, direction, bvh, tmin, tmax,
    )


def intersect_bvh(org, direction, bvh, tris: TriSoA, tmin, tmax) -> Hit:
    """Closest hit over the skip-link BVH; barycentrics re-derived for the
    single winner per ray (same epilogue as the brute-force path)."""
    t, prim = _chunked_traverse(org, direction, bvh, tmin, tmax, any_hit=False)
    return hit_from_t_prim(org, direction, tris, t, prim)


def occluded_bvh(org, direction, bvh, tris: TriSoA, tmin, tmax) -> jnp.ndarray:
    """Any-hit visibility over the skip-link BVH (lanes park at the
    sentinel as soon as they find any hit)."""
    _, prim = _chunked_traverse(org, direction, bvh, tmin, tmax, any_hit=True)
    return prim >= 0


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def hit_from_t_prim(org, direction, tris: TriSoA, t, prim) -> Hit:
    """Winner (t, prim) -> full Hit with barycentrics re-derived (the
    shared epilogue of the BVH walks; also used by the primary raster)."""
    valid = prim >= 0
    pi = jnp.maximum(prim, 0)
    p0, e1, e2 = tris.gather_rows(pi)
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(
        jnp.abs(det) > 1e-12, 1.0 / jnp.where(det != 0, det, 1.0), 0.0
    )
    tvec = org - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    return Hit(
        t=jnp.where(valid, t, RT_MAX),
        prim=prim,
        u=jnp.where(valid, u, 0.0),
        v=jnp.where(valid, v, 0.0),
    )


def make_anyhit_prim(tris: TriSoA, bvh=None):
    """Any-hit that also reports WHICH primitive it found -> prim [N] i32
    (-1 = none; arbitrary intersecting prim, not the nearest — same contract
    as an OptiX anyhit invocation). Used by the cutout shadow fast path
    (render/integrator.py): a found prim whose material cannot be cut out
    resolves the shadow ray without the stochastic-transparency hop loop.
    Returns None when only the brute-force path is in play (small scenes
    keep the plain hop loop)."""
    if bvh is not None and tris.num > BVH_THRESHOLD:
        if "rows" in bvh or "rows_hi" in bvh:
            from .intersect_wide import _chunked_wide

            return lambda o, d, tn, tf: _chunked_wide(
                o, d, bvh, tn, tf, any_hit=True
            )[1]
        return lambda o, d, tn, tf: _chunked_traverse(
            o, d, bvh, tn, tf, any_hit=True
        )[1]
    return None


def make_intersectors(tris: TriSoA, bvh=None):
    """Return (closest_hit_fn, any_hit_fn) choosing brute force vs BVH
    by scene size (``BVH_THRESHOLD``); small scenes take the fused XLA
    brute force."""
    if bvh is not None and tris.num > BVH_THRESHOLD:
        if "rows" in bvh or "rows_hi" in bvh:  # 8-wide walk (ops/intersect_wide.py)
            from .intersect_wide import intersect_wbvh, occluded_wbvh

            return (
                lambda o, d, tn, tf: intersect_wbvh(o, d, bvh, tris, tn, tf),
                lambda o, d, tn, tf: occluded_wbvh(o, d, bvh, tris, tn, tf),
            )
        return (
            lambda o, d, tn, tf: intersect_bvh(o, d, bvh, tris, tn, tf),
            lambda o, d, tn, tf: occluded_bvh(o, d, bvh, tris, tn, tf),
        )
    return (
        lambda o, d, tn, tf: intersect_bruteforce(o, d, tris, tn, tf),
        lambda o, d, tn, tf: occluded_bruteforce(o, d, tris, tn, tf),
    )
