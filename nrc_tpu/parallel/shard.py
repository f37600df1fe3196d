"""Multi-chip scaling: the frame step under ``shard_map`` on a device Mesh.

Replacement for the reference's single-node multi-GPU machinery
(SURVEY.md §2.5): NVML topology discovery + ``cuCtxEnablePeerAccess`` islands
(``Raytracer.cpp:264-458``), checkerboard tile distribution
(``__raygen__path_tracer_local_copy``), and the P2P compositor
(``compositor.cu`` + ``Device.cpp:2651-2725``) all collapse into a
``jax.sharding.Mesh`` + ``shard_map``:

- P1 pixel-space data parallelism: the image is sharded by rows over the
  ``data`` axis; each chip renders its band with the *same* per-pixel RNG
  streams as the single-chip program (the band offset feeds the TEA seeds).
- P3 resource policy: scene/network arrays are replicated (P(None)); the
  sharded-hash-table variant (P6) partitions the grid tables over ``data``
  by resolution level and routes lookups owner-to-owner with an all_to_all.
- P4 compositor: nothing to do — the output stays sharded; host assembly is
  ``jax.device_get`` of a sharded array.
- P5 replicated training: per-chip record batches, ``pmean`` of gradients
  inside the fused Adam step.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import FrameConfig, NetworkConfig
from ..models import network as N
from ..render.frame import CameraArrays, FrameStats, frame_step
from ..render.scene_device import DeviceScene

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data mesh. Multi-host: pass the global device list."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def net_state_specs(net_state, shard_hash_tables: bool):
    """PartitionSpec pytree for a ``NetworkState``.

    Dense MLP params/moments are replicated (P5 data-parallel training).
    With ``shard_hash_tables`` (SURVEY P6), every [L, S, F] hash-table leaf —
    table, its EMA, and its Adam moments — is LEVEL-sharded over the data
    axis (each device owns L/D whole resolution levels): the sharded
    embedding-table layout the reference's single-GPU tcnn grid cannot
    express. Lookups run the owner-routed all_gather + all_to_all exchange
    of ``encodings.sharded_hash_grid_lookup`` — O(B) gather work per chip.
    """
    def leaf_spec(path, leaf):
        if shard_hash_tables and "grid" in jax.tree_util.keystr(path):
            return P(DATA_AXIS, None, None)
        return P()

    return jax.tree_util.tree_map_with_path(leaf_spec, net_state)


def sharded_frame_step(
    mesh: Mesh,
    cfg: FrameConfig,
    net_cfg: NetworkConfig,
    train_unbiased_ratio: float = 1.0 / 16.0,
    net_state_example=None,
):
    """Build the jitted multi-chip frame step.

    Returns ``step(scene, net_state, image, camera, iteration, subframe)``
    where ``image`` is a global [H*W, 3] array sharded by rows. Scene is
    replicated; MLP gradients are pmean'd across chips. When
    ``net_cfg.hash_shard_axis == DATA_AXIS`` the hash tables (+ EMA + Adam
    moments) are level-sharded over the mesh and lookups run the owner-
    routed all_gather + all_to_all exchange of
    ``encodings.sharded_hash_grid_lookup``;
    ``net_state_example`` (any concrete NetworkState) is then required to
    shape the per-leaf partition specs.
    """
    n_dev = mesh.devices.size
    assert cfg.height % (n_dev * cfg.tile_size[1]) == 0, (
        f"height {cfg.height} must divide over {n_dev} devices in whole tiles"
    )
    shard_rows = cfg.height // n_dev
    shard_tables = net_cfg.hash_shard_axis == DATA_AXIS
    if shard_tables:
        assert net_state_example is not None, (
            "sharded hash tables need net_state_example for partition specs"
        )
        net_specs = net_state_specs(net_state_example, True)
    else:
        net_specs = P()

    def body(scene, net_state, image_shard, camera, iteration, subframe):
        shard_id = jax.lax.axis_index(DATA_AXIS)
        row_offset = shard_id.astype(jnp.int32) * shard_rows
        grad_reduce = lambda g: jax.lax.pmean(g, DATA_AXIS)
        count_reduce = lambda c: jax.lax.psum(c, DATA_AXIS)
        # sharded tables: the lookup adjoint already sums each owner's rows
        # over all chips' batches; only the 1/D loss-mean scaling remains
        grid_grad_reduce = (
            (lambda g: jax.tree.map(lambda x: x / n_dev, g))
            if shard_tables else None
        )
        image_flat = image_shard.reshape(-1, 3)
        image2, net2, stats = frame_step(
            scene, net_state, image_flat, camera, iteration, subframe,
            cfg=cfg, net_cfg=net_cfg,
            train_unbiased_ratio=train_unbiased_ratio,
            grad_reduce=grad_reduce,
            count_reduce=count_reduce,
            grid_grad_reduce=grid_grad_reduce,
            shard_rows=shard_rows, row_offset=row_offset,
        )
        stats = FrameStats(
            loss=jax.lax.pmean(stats.loss, DATA_AXIS),
            num_train_records=jax.lax.psum(stats.num_train_records, DATA_AXIS),
            traced_rays=jax.lax.psum(stats.traced_rays, DATA_AXIS),
        )
        return image2.reshape(shard_rows, cfg.width, 3), net2, stats

    mapped = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(),                      # scene replicated
            net_specs,                # network replicated / tables sharded
            P(DATA_AXIS, None, None),  # image [H, W, 3] sharded by rows
            P(),                      # camera
            P(),                      # iteration
            P(),                      # subframe
        ),
        out_specs=(P(DATA_AXIS, None, None), net_specs, P()),
        check_vma=False,
    )

    @jax.jit
    def step(scene, net_state, image, camera, iteration, subframe):
        img3 = image.reshape(cfg.height, cfg.width, 3)
        img3, net2, stats = mapped(
            scene, net_state, img3, camera, iteration, subframe
        )
        return img3.reshape(-1, 3), net2, stats

    return step


class ParallelRenderer:
    """Multi-chip variant of ``render.renderer.Renderer`` (same surface)."""

    def __init__(self, renderer, mesh: Optional[Mesh] = None):
        from ..render.renderer import Renderer

        assert isinstance(renderer, Renderer)
        self.r = renderer
        self.mesh = mesh or make_mesh()
        self._steps = {}
        # place the image sharded over rows
        sharding = NamedSharding(self.mesh, P(DATA_AXIS, None))
        h, w = self.r.cfg.height, self.r.cfg.width
        self.r.image = jax.device_put(self.r.image, sharding)
        # place the network: replicated, or tables level-sharded (P6)
        shard_tables = self.r.net_cfg.hash_shard_axis == DATA_AXIS
        if shard_tables:
            n_dev = self.mesh.devices.size
            assert self.r.net_cfg.hash_n_levels % n_dev == 0, (
                f"level-sharded tables need devices ({n_dev}) to divide "
                f"hash_n_levels ({self.r.net_cfg.hash_n_levels})"
            )
            specs = net_state_specs(self.r.net_state, True)
            shardings = jax.tree.map(
                lambda s: NamedSharding(self.mesh, s), specs,
                is_leaf=lambda x: isinstance(x, P),
            )
            self.r.net_state = jax.device_put(self.r.net_state, shardings)

    def _step(self):
        key = (self.r.cfg.tile_size, self.r.cfg.render_mode, self.r.cfg.train)
        if key not in self._steps:
            self._steps[key] = sharded_frame_step(
                self.mesh, self.r.cfg, self.r.net_cfg,
                self.r.hyper.train_unbiased_ratio,
                net_state_example=self.r.net_state,
            )
        return self._steps[key]

    def render_frame(self):
        step = self._step()
        r = self.r
        r.image, r.net_state, stats = step(
            r.device_scene, r.net_state, r.image, r._camera_arrays(),
            jnp.int32(r.iteration), jnp.uint32(r.total_subframe),
        )
        r.iteration += 1
        r.total_subframe += 1
        r.last_stats = stats
        if r.cfg.train:
            # deferred async stats readback (see Renderer.render_frame)
            for leaf in (stats.loss, stats.num_train_records):
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
            r._pending_stats.append(stats)
            if len(r._pending_stats) > 2:
                r.loss_history.append(float(r._pending_stats.popleft().loss))
        return stats

    def flush_stats(self):
        while self.r._pending_stats:
            self.r.loss_history.append(
                float(self.r._pending_stats.popleft().loss)
            )

    def render(self, spp: int):
        for _ in range(spp):
            stats = self.render_frame()
        jax.block_until_ready(self.r.image)
        return stats

    def image_hdr(self):
        return self.r.image_hdr()
