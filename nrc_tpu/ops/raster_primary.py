"""Tiled primary-visibility rasterizer: camera rays without the BVH walk.

Primary rays are the one ray class whose structure the wavefront tracer
cannot exploit: they all share one origin and their directions are a known
function of the pixel grid — yet the walk pays the same per-ray gather
cost as any incoherent batch. The reference needs no
equivalent because RT cores make primaries nearly free
(``raygeneration.cu:227``).

The answer here: rasterize the visibility. At camera-set time the host
conservatively bins every triangle to the 16x16-pixel screen tiles its
projection (near-clipped, 1px-padded for subpixel jitter) overlaps, and
ships the binned triangle rows as ONE contiguous tile-major array. Per
frame the device resolves each tile's 256 pixel rays against the tile's
candidate rows as dense [tiles, 256, K] Moller-Trumbore — pure elementwise math
with ZERO per-lane gathers (each tile's rows arrive as a contiguous
slice). The candidate sets are conservative supersets, and the per-pair
test is exactly the walk's triangle test, so the winner (nearest valid
prim) is identical to the BVH walk's for every pixel.

Skew handling: tiles are sorted by candidate count and padded in GROUPS
(power-of-two K buckets), so a dense foliage tile does not inflate the
whole screen's K.

Scope: pinhole lens, triangles, static camera between rebuilds (the
Renderer rebuilds bins on camera move; benchmark/accumulation frames
reuse them). Cutout passthrough, volumes and every later bounce keep the
walk — the raster only replaces depth-0 ``closest_hit``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import RT_MAX

TILE = 16          # preferred screen tile edge (pixels); the builder's
                   # ladder (16/24/20/32/12/8, first divisor of BOTH
                   # dimensions wins) prefers larger tiles; the ladder was
                   # set on an earlier accelerator, not yet on the GPU
PAD_PX = 1.5       # conservative projection pad (subpixel jitter + rounding)
NEAR_EPS = 1e-5


class RasterMeta(NamedTuple):
    """Static (hashable) shape info — part of the jit cache key, so a
    camera move that changes the group layout retraces the frame."""

    group_k: Tuple[int, ...]      # static K per group
    group_tiles: Tuple[int, ...]  # static tile count per group
    width: int
    height: int
    tile: int                     # tile edge in pixels


class RasterData(NamedTuple):
    """Device-side binned primary-visibility data (tile-major).

    ``rows`` is derived ON DEVICE from ``tris.packed[pids]`` after the
    host binning (one gather per camera build) — shipping the binned
    rows themselves would re-upload duplicated geometry.
    """

    rows: jnp.ndarray       # [S, 9] f32 tri rows (p0|e1|e2), tile-major, padded
    pids: jnp.ndarray       # [S] i32 source prim ids (-1 = pad slot)
    perm: jnp.ndarray       # [n_pix] pixel-linear -> tile-major lane permute
    inv_perm: jnp.ndarray   # [n_pix] inverse permute


def build_raster_bins(p0, p1, p2, cam_p, cam_u, cam_v, cam_w,
                      width: int, height: int):
    """Host-side conservative binning (numpy). Returns (meta, pids_np,
    perm_np, inv_perm_np) — the caller derives the device row array from
    ``tris.packed[pids]``. None when the screen does not tile evenly."""
    import os as _os

    forced = _os.environ.get("NRC_RASTER_TILE")
    # prefer LARGER tiles: the resolve cost is pairs-bound; 8 is the last
    # resort (the ladder dates from an earlier accelerator)
    candidates = [int(forced)] if forced else [16, 24, 20, 32, 12, 8]
    tile = next(
        (t for t in candidates if width % t == 0 and height % t == 0),
        None,
    )
    if tile is None:
        return None
    ntx, nty = width // tile, height // tile
    n_tiles = ntx * nty

    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    # camera basis: ray(x, y) = normalize(sx*U + sy*V + W) with
    # sx = 2*(px+jx)/W - 1, sy = 2*(py+jy)/H - 1 (scene/camera.py pinhole).
    # A world point Q projects via c = M^-1 (Q - P), M = [U V W] columns:
    # sx = c0/c2, sy = c1/c2, valid when c2 > 0.
    M = np.stack([np.asarray(cam_u), np.asarray(cam_v),
                  np.asarray(cam_w)], axis=1).astype(np.float64)
    try:
        Minv = np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return None

    def project(v):  # [T, 3] -> (sx, sy, cz)
        c = (v - np.asarray(cam_p)[None, :]) @ Minv.T
        return c[:, 0], c[:, 1], c[:, 2]

    verts = [p0, p1, p2]
    sxs, sys_, czs = zip(*(project(v) for v in verts))
    sxs = np.stack(sxs, 1)    # [T, 3]
    sys_ = np.stack(sys_, 1)
    czs = np.stack(czs, 1)

    behind = czs <= NEAR_EPS
    # a triangle is DROPPABLE only when strictly at-or-behind the camera
    # plane (cz <= 0 for all vertices): vertices in the (0, NEAR_EPS]
    # slab still project (to huge clamped bounds — conservative), and the
    # walk with tmin = 0 can hit them
    all_behind = (czs <= 0.0).all(axis=1)
    any_behind = behind.any(axis=1) & ~all_behind

    # screen-space AABB in pixels for fully-front triangles
    with np.errstate(divide="ignore", invalid="ignore"):
        px = (sxs / czs + 1.0) * 0.5 * width
        py = (sys_ / czs + 1.0) * 0.5 * height
    lo_x = px.min(axis=1) - PAD_PX
    hi_x = px.max(axis=1) + PAD_PX
    lo_y = py.min(axis=1) - PAD_PX
    hi_y = py.max(axis=1) + PAD_PX
    # near-plane clip, conservative: a straddling triangle's visible part
    # can project anywhere along the directions of its front vertices —
    # clip each behind-vertex edge to the near plane and extend the AABB
    # by the clipped points (standard conservative near clip).
    if any_behind.any():
        idx = np.nonzero(any_behind)[0]
        for a in range(3):
            b = (a + 1) % 3
            za, zb = czs[idx, a], czs[idx, b]
            cross = (za <= NEAR_EPS) != (zb <= NEAR_EPS)
            if not cross.any():
                continue
            j = idx[cross]
            t = (NEAR_EPS - czs[j, a]) / (czs[j, b] - czs[j, a])
            cx = sxs[j, a] + t * (sxs[j, b] - sxs[j, a])
            cy = sys_[j, a] + t * (sys_[j, b] - sys_[j, a])
            qx = (cx / NEAR_EPS + 1.0) * 0.5 * width
            qy = (cy / NEAR_EPS + 1.0) * 0.5 * height
            # a point AT the near plane projects to +-inf-ish: clamp to
            # the full screen (fully conservative for those tris)
            lo_x[j] = np.minimum(lo_x[j], np.clip(qx, -1.0, width))
            hi_x[j] = np.maximum(hi_x[j], np.clip(qx, 0.0, width + 1.0))
            lo_y[j] = np.minimum(lo_y[j], np.clip(qy, -1.0, height))
            hi_y[j] = np.maximum(hi_y[j], np.clip(qy, 0.0, height + 1.0))
        # vertices in front still contribute their projected AABB (done
        # above with invalid behind entries): recompute those rows with
        # behind vertices masked out of the min/max
        bx = np.where(behind, np.inf, px)
        by = np.where(behind, np.inf, py)
        lo_x[idx] = np.minimum(lo_x[idx], bx[idx].min(axis=1) - PAD_PX)
        lo_y[idx] = np.minimum(lo_y[idx], by[idx].min(axis=1) - PAD_PX)
        bx = np.where(behind, -np.inf, px)
        by = np.where(behind, -np.inf, py)
        hi_x[idx] = np.maximum(hi_x[idx], bx[idx].max(axis=1) + PAD_PX)
        hi_y[idx] = np.maximum(hi_y[idx], by[idx].max(axis=1) + PAD_PX)

    # NaN bounds (a vertex exactly at the camera origin: 0/0 projection)
    # would fail every comparison and silently DROP a hittable triangle —
    # replace with full-screen bounds (fully conservative)
    bad = ~(np.isfinite(lo_x) & np.isfinite(hi_x)
            & np.isfinite(lo_y) & np.isfinite(hi_y))
    lo_x = np.where(bad, -1.0, lo_x)
    hi_x = np.where(bad, width + 1.0, hi_x)
    lo_y = np.where(bad, -1.0, lo_y)
    hi_y = np.where(bad, height + 1.0, hi_y)

    keep = ~all_behind
    tids = np.nonzero(keep)[0].astype(np.int64)
    tx0 = np.clip(np.floor(lo_x[keep] / tile), 0, ntx - 1).astype(np.int64)
    tx1 = np.clip(np.floor(hi_x[keep] / tile), 0, ntx - 1).astype(np.int64)
    ty0 = np.clip(np.floor(lo_y[keep] / tile), 0, nty - 1).astype(np.int64)
    ty1 = np.clip(np.floor(hi_y[keep] / tile), 0, nty - 1).astype(np.int64)
    # drop tris entirely off screen
    on = (hi_x[keep] >= 0) & (lo_x[keep] <= width) & \
         (hi_y[keep] >= 0) & (lo_y[keep] <= height)
    tids, tx0, tx1, ty0, ty1 = (a[on] for a in (tids, tx0, tx1, ty0, ty1))

    spans_x = tx1 - tx0 + 1
    spans_y = ty1 - ty0 + 1
    counts = spans_x * spans_y
    total = int(counts.sum())
    if total == 0:
        return None
    # expand (tri, tile) pairs
    rep = np.repeat(np.arange(tids.size), counts)
    # within-tri pair ordinal -> (dx, dy)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ordinal = np.arange(total) - starts[rep]
    dx = ordinal % spans_x[rep]
    dy = ordinal // spans_x[rep]
    pair_tile = (ty0[rep] + dy) * ntx + (tx0[rep] + dx)
    pair_tri = tids[rep]

    order = np.argsort(pair_tile, kind="stable")
    pair_tile = pair_tile[order]
    pair_tri = pair_tri[order]
    tile_counts = np.bincount(pair_tile, minlength=n_tiles)

    # group tiles by candidate count into power-of-two K buckets
    tile_order = np.argsort(tile_counts, kind="stable")
    ks = np.maximum(8, 2 ** np.ceil(
        np.log2(np.maximum(tile_counts[tile_order], 1))
    ).astype(np.int64))
    group_k, group_tiles = [], []
    gstart = 0
    for i in range(1, n_tiles + 1):
        if i == n_tiles or ks[i] != ks[gstart]:
            group_k.append(int(ks[gstart]))
            group_tiles.append(i - gstart)
            gstart = i

    # emit the padded tile-major pid array (rows derived on device)
    tile_starts = np.concatenate([[0], np.cumsum(tile_counts)[:-1]])
    S = int(np.sum(np.array(group_k)
                   * np.array(group_tiles, dtype=np.int64)))
    pids = np.full((S,), -1, np.int32)
    out = 0
    ti = 0
    for k, gt in zip(group_k, group_tiles):
        for _ in range(gt):
            tl = int(tile_order[ti])
            c = int(tile_counts[tl])
            st = int(tile_starts[tl])
            pids[out:out + c] = pair_tri[st:st + c]
            out += k
            ti += 1

    # pixel-linear -> tile-major permutation (pixels of tile_order[0]'s
    # tile first, row-major within each tile)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pix_tile = (yy // tile) * ntx + (xx // tile)
    pix_lane = (yy % tile) * tile + (xx % tile)
    tile_rank = np.empty((n_tiles,), np.int64)
    tile_rank[tile_order] = np.arange(n_tiles)
    tm_index = tile_rank[pix_tile] * (tile * tile) + pix_lane  # dest lane
    perm = np.empty((width * height,), np.int64)
    perm[tm_index.reshape(-1)] = np.arange(width * height)
    inv_perm = tm_index.reshape(-1)

    import sys as _sys

    print(
        f"raster bins: tile={tile} tiles={n_tiles} pairs={total} "
        f"slots={S} maxK={int(tile_counts.max())} "
        f"groups={len(group_k)}", file=_sys.stderr, flush=True,
    )
    meta = RasterMeta(
        group_k=tuple(group_k),
        group_tiles=tuple(group_tiles),
        width=width,
        height=height,
        tile=tile,
    )
    return meta, pids, perm.astype(np.int32), inv_perm.astype(np.int32)


def _mt_tiles(rows, pids, org, dirs, tmin, tmax):
    """Dense Moller-Trumbore: rows [G, K, 9], org/dirs [G, L, 3],
    tmin/tmax [G, L] -> (t, prim) [G, L]. Component-major (no minor-dim-3
    axis — the wide walk's ``_leaf_tri_t`` lesson), same math/epsilons as
    the walk's leaf test (identical winners)."""
    # triangle columns [G, 1, K]; ray components [G, L, 1]
    c = [rows[:, None, :, k] for k in range(9)]
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    dx = dirs[:, :, 0:1]
    dy = dirs[:, :, 1:2]
    dz = dirs[:, :, 2:3]
    ox = org[:, :, 0:1]
    oy = org[:, :, 1:2]
    oz = org[:, :, 2:3]
    pvx = dy * e2z - dz * e2y                            # [G, L, K]
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = jnp.abs(det) > 1e-12
    invd = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * invd
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invd
    ok = (
        ok & (pids[:, None, :] >= 0)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[:, :, None]) & (t < tmax[:, :, None])
    )
    t = jnp.where(ok, t, RT_MAX)
    k_best = jnp.argmin(t, axis=-1)                      # [G, L]
    t_best = jnp.min(t, axis=-1)
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, t.shape, 2) == k_best[:, :, None]
    )
    prim = jnp.sum(
        jnp.where(oh, pids[:, None, :], 0), axis=-1, dtype=jnp.int32
    )
    hit = t_best < RT_MAX
    return jnp.where(hit, t_best, RT_MAX), jnp.where(hit, prim, -1)


def raster_closest_hit(meta: RasterMeta, rb: RasterData, org, dirs,
                       tmin, tmax):
    """Resolve primary visibility for the FULL pixel grid.

    org/dirs/tmin/tmax are pixel-linear [n_pix(,3)] (the render
    wavefront's lane order). Returns (t, prim) pixel-linear. Winners are
    identical to the BVH walk's (conservative candidate sets + the same
    triangle test)."""
    L = meta.tile * meta.tile
    o = org[rb.perm].reshape(-1, L, 3)
    d = dirs[rb.perm].reshape(-1, L, 3)
    tn = tmin[rb.perm].reshape(-1, L)
    tx = tmax[rb.perm].reshape(-1, L)
    t_parts, p_parts = [], []
    tile0 = 0
    slot0 = 0
    for k, gt in zip(meta.group_k, meta.group_tiles):
        rows = jax.lax.slice_in_dim(
            rb.rows, slot0, slot0 + gt * k, axis=0
        ).reshape(gt, k, 9)
        pids = jax.lax.slice_in_dim(
            rb.pids, slot0, slot0 + gt * k, axis=0
        ).reshape(gt, k)
        og = jax.lax.slice_in_dim(o, tile0, tile0 + gt, axis=0)
        dg = jax.lax.slice_in_dim(d, tile0, tile0 + gt, axis=0)
        tng = jax.lax.slice_in_dim(tn, tile0, tile0 + gt, axis=0)
        txg = jax.lax.slice_in_dim(tx, tile0, tile0 + gt, axis=0)
        # bound the [gt, L, K] intermediate: chunk tiles so gt*L*K stays
        # ~<= 2^24 elements
        budget = max(1, (1 << 24) // (L * k))
        if gt > budget:
            nchunk = -(-gt // budget)
            pad_t = nchunk * budget - gt
            if pad_t:
                og = jnp.pad(og, ((0, pad_t), (0, 0), (0, 0)))
                dg = jnp.pad(dg, ((0, pad_t), (0, 0), (0, 0)),
                             constant_values=1.0)
                tng = jnp.pad(tng, ((0, pad_t), (0, 0)),
                              constant_values=1.0)
                txg = jnp.pad(txg, ((0, pad_t), (0, 0)))
                rows = jnp.pad(rows, ((0, pad_t), (0, 0), (0, 0)))
                pids = jnp.pad(pids, ((0, pad_t), (0, 0)),
                               constant_values=-1)

            def one(args):
                r, p, a, b, c, e = args
                return _mt_tiles(r, p, a, b, c, e)

            tg, pg = jax.lax.map(
                one,
                (rows.reshape(nchunk, budget, k, 9),
                 pids.reshape(nchunk, budget, k),
                 og.reshape(nchunk, budget, L, 3),
                 dg.reshape(nchunk, budget, L, 3),
                 tng.reshape(nchunk, budget, L),
                 txg.reshape(nchunk, budget, L)),
            )
            tg = tg.reshape(-1, L)[:gt]
            pg = pg.reshape(-1, L)[:gt]
        else:
            tg, pg = _mt_tiles(rows, pids, og, dg, tng, txg)
        t_parts.append(tg)
        p_parts.append(pg)
        tile0 += gt
        slot0 += gt * k
    t = jnp.concatenate(t_parts, axis=0).reshape(-1)
    prim = jnp.concatenate(p_parts, axis=0).reshape(-1)
    return t[rb.inv_perm], prim[rb.inv_perm]
