"""The per-frame NRC step: one jitted program, no mid-frame host syncs.

Redesign of ``Device::render`` (``nrc/src/Device.cpp:2292-2517``)
— the reference's frame pipeline is

    optixLaunch -> DtoH numTrainingRecords (hard sync!) -> infer ->
    accumulate -> propagate -> shuffle (curand+cub sort) -> 4x train

Here the whole of it is a single XLA program over static shapes:

- render + training wavefronts (``integrator.trace_wavefront``)
- cache inference over [#pixels + #tiles] queries in one batch
  (``Device::nrcInferRadiance``, Device.cpp:1272-1308)
- mode-dependent accumulation (``accumulate_render_radiance``,
  ``nrc_helpers.cu:77-129``) with the incremental-mean update of
  ``raygeneration.cu:406-411``
- radiance propagation as a dense reverse scan over per-tile record slots
  (replaces the per-tile linked-list walk of ``nrc_helpers.cu:131-224``)
- shuffle via prefix-sum compaction + ``jax.random.permutation`` with
  modulo duplication (replaces curand + cub radix sort + permute kernel,
  ``NRCUtil.cu`` / ``nrc_helpers.cu:226-249``)
- NUM_BATCHES fused Adam+EMA steps (``Device::nrcTrainRadiance``,
  Device.cpp:1473-1513)

The training-record count stays on device; the host reads it (and the loss)
once per frame from the returned stats — after the frame, not inside it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    BATCH_SIZE,
    NUM_BATCHES,
    FrameConfig,
    NetworkConfig,
    RenderMode,
)
from ..models import network as N
from ..utils import rng as R
from ..scene.camera import generate_primary_rays
from .integrator import QUERY_DIMS, trace_wavefront, trace_wavefront_chunked
from .scene_device import DeviceScene


class FrameStats(NamedTuple):
    loss: jnp.ndarray               # scalar, mean of the batch losses
    num_train_records: jnp.ndarray  # scalar i32
    # rays actually cast this frame (closest-hit segments of live lanes +
    # shadow rays with a valid light sample, both wavefronts) — the honest
    # Mrays/s numerator. The reference's potential-ray figure assumes every
    # path traces all max_depth+1 segments plus one shadow ray each; the
    # area-spread heuristic truncates most FULL-mode paths in 1-2 bounces,
    # so traced is typically a small fraction of potential.
    traced_rays: jnp.ndarray = np.int32(0)  # scalar i32


class CameraArrays(NamedTuple):
    p: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray


def _pixel_grid(cfg: FrameConfig, rows: Optional[int] = None, row_offset=0):
    """Pixel coords + linear indices for ``rows`` image rows starting at
    ``row_offset`` (traced). Sharding the frame over rows (P1 pixel-space
    data parallelism) just offsets this grid per chip, so per-pixel RNG
    streams match the single-chip program exactly.

    Computed with on-device iota, NOT numpy meshgrid, so no constant of
    #pixels size (~11 MB at 720p) is baked into the program."""
    rows = cfg.height if rows is None else rows
    lin = jnp.arange(rows * cfg.width, dtype=jnp.int32)
    ys = lin // cfg.width + row_offset
    xs = lin % cfg.width
    return (
        jnp.stack([xs, ys], -1).astype(jnp.float32),
        (ys * cfg.width + xs).astype(jnp.uint32),
    )


def _tile_origins(cfg: FrameConfig, tile_rows: Optional[int] = None, row_offset=0):
    tsx, tsy = cfg.tile_size
    ntx, nty = cfg.num_tiles_xy
    nty = nty if tile_rows is None else tile_rows
    lin = jnp.arange(nty * ntx, dtype=jnp.int32)
    return (
        (lin % ntx) * tsx,
        (lin // ntx) * tsy + row_offset,
    )


def query_reflectance(q):
    """diffuse + specular albedo of a radiance query
    (``RadianceQuery::reflectance``, ``neural_radiance_caching.h:117``)."""
    return q[..., 9:12] + q[..., 12:15]


def _safe_div(a, b):
    return a / (b + 1e-6)  # DENOMINATOR_EPSILON, config.h:55


def propagate_radiance(rec_target, rec_ltp, rec_count, end_radiance, end_mask):
    """Self-training radiance propagation (``propagate_train_radiance``,
    ``nrc_helpers.cu:131-224``).

    Per tile, walk record slots from deep to shallow:
        target[i] += localThroughput[i] * L;  L = target[i]
    starting with L = cache(end_query) * radianceMask. Records of one tile
    are consecutive slots here, so the linked-list walk becomes a dense
    reverse scan, parallel over tiles elementwise.
    """
    d = rec_target.shape[1]
    L = end_radiance * end_mask[..., None]
    out = rec_target
    for slot in range(d - 1, -1, -1):
        valid = (slot < rec_count)[..., None]
        new_t = out[:, slot] + rec_ltp[:, slot] * L
        out = out.at[:, slot].set(jnp.where(valid, new_t, out[:, slot]))
        L = jnp.where(valid, new_t, L)
    return out


def assemble_training_batches(key, rec_query, rec_target, rec_count):
    """Compact valid records and build the shuffled training set.

    Replaces curand + cub radix sort + ``permute_train_data``
    (``NRCUtil.cu:7-35``, ``nrc_helpers.cu:226-249``): prefix-sum compaction
    (the atomic-free allocator) + one ``jax.random.permutation``
    with modulo duplication when undersampled.

    Returns (batch_q [NB, BS, 15], batch_t [NB, BS, 3], num_records).
    """
    t, d, qd = rec_query.shape
    cap = t * d
    flat_q = rec_query.reshape(cap, qd)
    flat_t = rec_target.reshape(cap, 3)
    slot_ids = jnp.tile(jnp.arange(d, dtype=jnp.int32), (t,))
    valid = slot_ids < jnp.repeat(rec_count, d)

    dest = jnp.where(valid, jnp.cumsum(valid.astype(jnp.int32)) - 1, cap)
    num_records = jnp.sum(valid.astype(jnp.int32))

    comp_q = jnp.zeros((cap, qd), flat_q.dtype).at[dest].set(flat_q, mode="drop")
    comp_t = jnp.zeros((cap, 3), flat_t.dtype).at[dest].set(flat_t, mode="drop")

    total = NUM_BATCHES * BATCH_SIZE
    perm = jax.random.permutation(key, total)
    sel = perm % jnp.maximum(num_records, 1)
    batch_q = comp_q[sel].reshape(NUM_BATCHES, BATCH_SIZE, qd)
    batch_t = comp_t[sel].reshape(NUM_BATCHES, BATCH_SIZE, 3)
    return batch_q, batch_t, num_records


def frame_step(
    scene: DeviceScene,
    net_state: N.NetworkState,
    image: jnp.ndarray,          # [H*W, 3] accumulated HDR
    camera: CameraArrays,
    iteration_index: jnp.ndarray,    # i32, accumulation index (resets on move)
    total_subframe: jnp.ndarray,     # u32, ever-increasing (RNG stream)
    cfg: FrameConfig,
    net_cfg: NetworkConfig,
    learning_rate: Optional[jnp.ndarray] = None,
    train_unbiased_ratio: float = 1.0 / 16.0,
    grad_reduce=None,
    count_reduce=None,
    grid_grad_reduce=None,
    shard_rows: Optional[int] = None,
    row_offset=0,
    raster_meta=None,   # static RasterMeta (jit-key via partial)
    raster_data=None,   # RasterData arrays (traced)
) -> Tuple[jnp.ndarray, N.NetworkState, FrameStats]:
    """One full frame. Returns (image', net_state', stats).

    With ``shard_rows``/``row_offset`` the step renders only that horizontal
    band — the shard_map body for pixel-space data parallelism (SURVEY P1);
    ``image`` is then the band's slice and ``grad_reduce`` should psum/pmean
    over the data axis (P5 replicated training).
    """
    rows = cfg.height if shard_rows is None else shard_rows
    n_pixels = cfg.width * rows
    tsy = cfg.tile_size[1]
    tile_rows = rows // tsy
    n_tiles = cfg.num_tiles_xy[0] * tile_rows
    screen = (cfg.width, cfg.height)

    # ---- per-frame randomness (host rand() in the reference,
    # Device.cpp:2423-2428; here an on-device TEA stream) -----------------
    frame_seed = R.tea(np.uint32(0x9E3779B9), total_subframe)
    frame_seed, u_tt = R.rng(frame_seed)
    tsx, tsy = cfg.tile_size
    tile_training_index = jnp.minimum(
        (u_tt * (tsx * tsy)).astype(jnp.int32), tsx * tsy - 1
    )

    # ---- render wavefront (all pixels) ----------------------------------
    pix, pidx = _pixel_grid(cfg, rows, row_offset)
    seeds = R.tea(pidx, total_subframe)
    seeds, jitter = R.rng2(seeds)
    org, dirn = generate_primary_rays(
        pix, jitter, screen, camera.p, camera.u, camera.v, camera.w,
        lens=cfg.lens_shader,
    )
    primary_hit = None
    if raster_meta is not None and shard_rows is None and cfg.lens_shader == 0:
        # Tiled primary-visibility raster (ops/raster_primary.py): resolve
        # every pixel's first hit with dense per-screen-tile MT tests —
        # no BVH walk, no gathers; winners identical to the walk's. The
        # bins are camera-static (the Renderer rebuilds them on move).
        from ..ops.intersect import RT_MAX, hit_from_t_prim
        from ..ops.raster_primary import raster_closest_hit

        t0_, prim0 = raster_closest_hit(
            raster_meta, raster_data, org, dirn,
            jnp.zeros((n_pixels,)), jnp.full((n_pixels,), RT_MAX),
        )
        primary_hit = hit_from_t_prim(org, dirn, scene.tris, t0_, prim0)
    render_out = trace_wavefront_chunked(
        scene, org, dirn, seeds, cfg, train=False, primary_hit=primary_hit
    )

    # ---- training wavefront (one ray per tile, raygeneration.cu:123-136) -
    if cfg.train:
        tile_x0, tile_y0 = _tile_origins(cfg, tile_rows, row_offset)
        lx = tile_training_index % tsx
        ly = tile_training_index // tsx
        tpx = tile_x0 + lx
        tpy = tile_y0 + ly
        t_pidx = (tpy * cfg.width + tpx).astype(jnp.uint32)
        t_seeds = R.tea(t_pidx + np.uint32(0x7F4A7C15), total_subframe)
        t_seeds, u_unb = R.rng(t_seeds)
        unbiased = u_unb < train_unbiased_ratio
        t_pix = jnp.stack([tpx, tpy], axis=-1).astype(jnp.float32)
        t_seeds, t_jitter = R.rng2(t_seeds)
        t_org, t_dir = generate_primary_rays(
            t_pix, t_jitter, screen, camera.p, camera.u, camera.v, camera.w,
            lens=cfg.lens_shader,
        )
        train_out = trace_wavefront_chunked(
            scene, t_org, t_dir, t_seeds, cfg, train=True, unbiased=unbiased
        )
    else:
        train_out = None

    traced_rays = jnp.sum(render_out.traced_count)
    if cfg.train:
        traced_rays = traced_rays + jnp.sum(train_out.traced_count)

    # ---- cache inference over [#pixels + #tiles] queries ----------------
    # (Device::nrcInferRadiance, Device.cpp:1272-1308)
    mode = cfg.render_mode
    need_render_cache = mode in (
        RenderMode.FULL,
        RenderMode.CACHE_ONLY,
        RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION,
    )
    queries = []
    if need_render_cache:
        queries.append(render_out.render_query)
    if cfg.train:
        queries.append(train_out.end_query)
    if mode == RenderMode.CACHE_FIRST_VERTEX:
        queries.append(render_out.cache_vis_query)
    if queries:
        all_q = jnp.concatenate(queries, axis=0)
        all_r = N.infer(net_state, all_q, net_cfg)
        if cfg.reflectance_factoring:
            # the cache predicts radiance/reflectance; scale every
            # consumption (render end, suffix end, cache-vis) by its own
            # query's reflectance (nrc_helpers.cu:68-69,95-96,156-159)
            all_r = all_r * query_reflectance(all_q)
    ofs = 0
    cache_render = jnp.zeros((n_pixels, 3))
    if need_render_cache:
        cache_render = all_r[:n_pixels]
        ofs = n_pixels
    if cfg.train:
        cache_end = all_r[ofs : ofs + n_tiles] if queries else jnp.zeros((n_tiles, 3))
        ofs += n_tiles
    if mode == RenderMode.CACHE_FIRST_VERTEX:
        cache_vis = all_r[ofs : ofs + n_pixels]

    # ---- accumulate into the image --------------------------------------
    w_acc = 1.0 / (iteration_index.astype(jnp.float32) + 1.0)
    radiance = render_out.radiance
    if mode == RenderMode.FULL:
        contrib = radiance + render_out.last_render_throughput * cache_render
        image = image + (contrib - image) * w_acc
    elif mode == RenderMode.NO_CACHE:
        image = image + (radiance - image) * w_acc
    elif mode == RenderMode.CACHE_ONLY:
        image = render_out.last_render_throughput * cache_render
    elif mode == RenderMode.CACHE_FIRST_VERTEX:
        image = cache_vis
    elif mode == RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION:
        image = cache_render
    elif mode == RenderMode.DEBUG_THROUGHPUT_ONLY:
        image = render_out.last_render_throughput
    elif mode == RenderMode.DEBUG_TIME_VIEW:
        from ..utils.tonemap import time_view_ramp

        # per-pixel work events through the cold-to-hot ramp (the analog of
        # USE_TIME_VIEW's clock alpha channel, raygeneration.cu:392-404);
        # running max over the accumulation like a latched heat view
        heat = time_view_ramp(
            render_out.bounce_count.astype(jnp.float32) / float(cfg.max_depth)
        )
        image = jnp.maximum(image, heat)

    # ---- training --------------------------------------------------------
    # NRC_PROFILE_SKIP truncates the frame program after a named stage
    # ("all" = right after the wavefronts, "assemble" = after propagation,
    # "train" = after batch assembly) — a stage-timing harness for the
    # profiler, never set in production.
    import os
    _skip = os.environ.get("NRC_PROFILE_SKIP", "")
    if cfg.train and "all" in _skip:
        return image, net_state, FrameStats(
            loss=jnp.sum(train_out.rec_target) * 0.0,
            num_train_records=jnp.sum(train_out.rec_count),
            traced_rays=traced_rays,
        )
    if cfg.train:
        targets = propagate_radiance(
            train_out.rec_target,
            train_out.rec_ltp,
            train_out.rec_count,
            cache_end,
            train_out.end_mask,
        )
        if "assemble" in _skip:
            return image, net_state, FrameStats(
                loss=jnp.sum(targets) * 0.0,
                num_train_records=jnp.sum(train_out.rec_count),
                traced_rays=traced_rays,
            )
        if cfg.reflectance_factoring:
            # propagation ran in radiance units; train on
            # radiance/reflectance per record (the consistent form of the
            # reference's convert-accumulate-convert in
            # propagate_train_radiance, nrc_helpers.cu:187-207)
            targets = _safe_div(targets, query_reflectance(train_out.rec_query))
        shuffle_key = jax.random.fold_in(
            jax.random.PRNGKey(0x5EED), total_subframe
        )
        batch_q, batch_t, num_records = assemble_training_batches(
            shuffle_key, train_out.rec_query, targets, train_out.rec_count
        )
        if "train" in _skip:
            return image, net_state, FrameStats(
                loss=jnp.sum(batch_q) * 0.0 + jnp.sum(batch_t) * 0.0,
                num_train_records=num_records,
                traced_rays=traced_rays,
            )

        def do_train(ns):
            def body(carry, batch):
                ns, _ = carry
                bq, bt = batch
                ns2, loss = N.train_step(
                    ns, bq, bt, net_cfg,
                    learning_rate=learning_rate, grad_reduce=grad_reduce,
                    loss_scale=(num_records > 0).astype(jnp.float32),
                    grid_grad_reduce=grid_grad_reduce,
                )
                return (ns2, loss), loss

            (ns2, _), losses = jax.lax.scan(
                body, (ns, np.float32(0.0)), (batch_q, batch_t)
            )
            return ns2, jnp.mean(losses)

        def skip_train(ns):
            return ns, np.float32(0.0)

        # The branch predicate must agree across shards: the train branch
        # contains gradient collectives, and a per-shard cond would diverge.
        global_records = (
            count_reduce(num_records) if count_reduce is not None else num_records
        )
        net_state, loss = jax.lax.cond(
            global_records > 0, do_train, skip_train, net_state
        )
    else:
        loss = np.float32(0.0)
        num_records = np.int32(0)

    return image, net_state, FrameStats(
        loss=loss, num_train_records=num_records, traced_rays=traced_rays
    )
