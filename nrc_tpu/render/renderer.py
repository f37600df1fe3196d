"""Host-side renderer orchestration: accumulation, adaptation, screenshots.

Plays the role of ``Application::render/benchmark`` + ``Raytracer::render``
(``nrc/src/Application.cpp:417-540``, ``Raytracer.cpp:696-720``): drives the
jitted frame program, restarts accumulation on state changes, adapts the
training tile size between frames (quantized, so the jit cache stays small),
and writes tonemapped PNG / linear HDR screenshots
(``Application::screenshot``, ``Application.cpp:2562-2673``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    FrameConfig,
    NetworkConfig,
    NRCHyperParams,
    RenderMode,
    SystemConfig,
    adjust_tile_size,
)
from ..models import network as N
from ..scene.scene_builder import Scene
from ..utils.image_io import write_hdr, write_png
from ..utils.tonemap import tonemap_to_u8
from .frame import CameraArrays, frame_step
from .scene_device import DeviceScene, upload_scene


def _diag_off():
    import os

    return os.environ.get("NRC_DIAG_OFF", "").split(",")


class Renderer:
    """Single-accelerator renderer (multi-chip variant in ``parallel/``)."""

    def __init__(
        self,
        scene: Scene,
        system: SystemConfig,
        net_cfg: Optional[NetworkConfig] = None,
        render_mode: RenderMode = RenderMode.FULL,
        train: bool = True,
        adaptive_tiles: bool = True,
        position_scale: Optional[float] = None,
        seed: int = 0,
        reflectance_factoring: bool = False,
    ):
        self.scene = scene
        self.system = system
        self.net_cfg = net_cfg or NetworkConfig()
        self.hyper = NRCHyperParams(learning_rate=self.net_cfg.learning_rate)
        self.device_scene: DeviceScene = upload_scene(scene)
        self.adaptive_tiles = adaptive_tiles

        if position_scale is None:
            # per-scene normalization (the reference hardcodes 0.005 for
            # Cornell, hit.cu:595-597; we derive it from the scene AABB)
            lo, hi = scene.aabb()
            extent = float(np.max(hi - lo)) if lo.size else 1.0
            position_scale = 0.1 / max(extent, 1e-6)

        w, h = system.resolution
        self.cfg = FrameConfig(
            width=w,
            height=h,
            tile_size=system.tile_size,
            max_depth=system.path_lengths[1],
            min_depth_rr=system.path_lengths[0],
            render_mode=render_mode,
            train=train,
            lens_shader=scene.lens_shader,
            scene_epsilon=system.scene_epsilon,
            walk_length=system.walk_length,
            position_scale=position_scale,
            has_volumes=bool(
                np.max(scene.materials.sigma_a) + np.max(scene.materials.sigma_s)
                > 0.0
            ),
            # NRC_DIAG_OFF: comma list of transport features to compile
            # OUT for profiling attribution (results become wrong) — e.g.
            # NRC_DIAG_OFF=tex,cutout isolates texture-fetch cost
            has_textures=scene.materials.atlas.num_textures > 0
            and "tex" not in _diag_off(),
            has_layered=bool(
                np.any(scene.materials.blend_mode != 0)
                or np.any(scene.materials.mod_mode != 0)
            ),
            has_cutout=bool(
                np.min(scene.materials.cutout_opacity) < 1.0
                or np.max(scene.materials.cutout_tex) >= 0
            ) and "cutout" not in _diag_off(),
            has_measured=bool(np.max(scene.materials.mbsdf_index) >= 0),
            has_noise=bool(np.max(scene.materials.noise_mode) > 0)
            and "noise" not in _diag_off(),
            has_noise_bump=bool(
                np.max(np.abs(scene.materials.noise_bump_factor)) > 0
            ) and "noise" not in _diag_off(),
            noise_levels_static=int(
                np.max(scene.materials.noise_levels, initial=1)
            ),
            # static lobe-family specialization: compile only the archetypes
            # this scene declares (both blend lobes)
            archetype_set=frozenset(
                np.unique(scene.materials.archetype).tolist()
                + np.unique(scene.materials.archetype2).tolist()
            ),
            reflectance_factoring=reflectance_factoring,
            # shadow-ray RR threshold (see FrameConfig.nee_rr_tau); env
            # override for A/B — 0 restores trace-every-sample reference
            # behavior with bit-identical sample streams
            nee_rr_tau=float(os.environ.get("NRC_NEE_RR_TAU", "0.0")),
        )

        self.net_state = N.init_network(jax.random.PRNGKey(seed), self.net_cfg)
        self.image = jnp.zeros((w * h, 3), jnp.float32)
        self.iteration = 0
        self.total_subframe = 0
        self.last_stats = None
        from collections import deque

        self.loss_history = deque(maxlen=256)
        self._pending_stats = deque()
        self._step_cache = {}
        # tiled primary-visibility raster (ops/raster_primary.py): replaces
        # the depth-0 BVH walk with dense per-screen-tile tests for big
        # pinhole scenes. Bins depend on the camera; rebuilt lazily on move.
        self._raster_meta = None
        self._raster_data = None
        self._raster_cam = None
        self._raster_enabled = (
            os.environ.get("NRC_RASTER_PRIMARY", "1") == "1"
            and scene.num_triangles > 16384
            and self.cfg.lens_shader == 0
            and w % 8 == 0 and h % 8 == 0
        )

    # -- state management --------------------------------------------------

    def restart_accumulation(self) -> None:
        """Camera/material change restarts progressive accumulation
        (``Application::restartRendering``)."""
        self.iteration = 0
        self.image = jnp.zeros_like(self.image)

    def reset_cache(self, seed: int = 0) -> None:
        """Re-create the network (GUI 'reset cache' -> ``Device.cpp:2415-2421``)."""
        self.net_state = N.init_network(jax.random.PRNGKey(seed), self.net_cfg)

    def set_render_mode(self, mode: RenderMode) -> None:
        self.cfg = dataclasses.replace(self.cfg, render_mode=mode)
        self.restart_accumulation()

    def set_encoding(self, encoding, seed: int = 0) -> None:
        """Live input-encoding switch (the reference GUI combo re-creates
        the tcnn model with the per-encoding learning rate and resets the
        cache, ``Application.cpp:671-689`` -> ``Device.cpp:2409-2421``)."""
        from ..config import InputEncoding

        if isinstance(encoding, str):
            encoding = InputEncoding[encoding.upper()]
        if encoding == self.net_cfg.encoding:
            return
        # ema_decay=None + adam_eps reset so __post_init__ re-resolves both
        # for the NEW encoding (a plain replace would carry the previous
        # encoding's resolved values: FREQ->HASH would keep EMA 0.95 and
        # eps 1e-8 instead of tcnn's 0.99/1e-15, and back)
        self.net_cfg = dataclasses.replace(
            self.net_cfg, encoding=encoding, ema_decay=None, adam_eps=1e-8
        )
        # per-encoding default lr (NetworkConfig.learning_rate derives it,
        # matching cfg::modelConfig's 1e-3 freq / 1e-2 hash)
        self.hyper = dataclasses.replace(
            self.hyper, learning_rate=self.net_cfg.learning_rate
        )
        # compiled steps capture net_cfg — the encoding switch invalidates
        # them (the analog of the reference's full re-create_from_config)
        self._step_cache = {}
        self.net_state = N.init_network(jax.random.PRNGKey(seed), self.net_cfg)
        self.restart_accumulation()

    def update_material(self, index: int, **changes) -> None:
        """Live material-parameter edit (the reference GUI's per-material
        MDL argument-block editors, ``MaterialMDL.h:62-295`` Param_info ->
        ``Device::updateMaterial``, ``Device.cpp:1700-1722``). ``changes``
        are ``scene.materials.Material`` field overrides; geometry, BVH,
        and texture decodes are reused — only the material-derived device
        arrays re-upload."""
        from ..scene.materials import MaterialTable
        from .scene_device import patch_materials

        rows = self.scene.material_rows
        rows[index] = dataclasses.replace(rows[index], **changes)
        atlas = self.scene.materials.atlas
        self.scene.materials = MaterialTable.build(rows, atlas=atlas)
        self.device_scene = patch_materials(self.device_scene, self.scene)
        self.restart_accumulation()

    def _camera_arrays(self) -> CameraArrays:
        p, u, v, w = self.scene.camera.frustum()
        return CameraArrays(
            p=jnp.asarray(p), u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w)
        )

    def _maybe_build_raster(self):
        """(Re)build the primary raster bins when the camera moved."""
        if not self._raster_enabled:
            return
        p, u, v, w = self.scene.camera.frustum()
        cam_key = (tuple(p.tolist()), tuple(u.tolist()),
                   tuple(v.tolist()), tuple(w.tolist()))
        if cam_key == self._raster_cam:
            return
        from ..ops.raster_primary import RasterData, build_raster_bins

        built = build_raster_bins(
            self.scene.p0, self.scene.p1, self.scene.p2,
            p, u, v, w, self.cfg.width, self.cfg.height,
        )
        if built is None:
            # drop any PREVIOUS camera's bins too — the frame must fall
            # back to the walk rather than resolve with stale candidates
            self._raster_enabled = False
            self._raster_meta = None
            self._raster_data = None
            self._raster_cam = None
            return
        meta, pids_np, perm_np, inv_np = built
        pids = jnp.asarray(pids_np)
        # binned tri rows derived ON DEVICE from the resident packed
        # geometry (one gather per camera build) — the host ships only
        # the pid/permutation arrays
        rows = self.device_scene.tris.packed[jnp.maximum(pids, 0)]
        self._raster_meta = meta
        self._raster_data = RasterData(
            rows=rows, pids=pids,
            perm=jnp.asarray(perm_np), inv_perm=jnp.asarray(inv_np),
        )
        self._raster_cam = cam_key

    def _compiled_step(self, cfg: FrameConfig):
        # key on every static field (hyper-parameter edits recompile, the
        # analog of the reference's setState dirty-diff re-upload); the
        # raster meta (group layout) is static too — a camera move that
        # reshapes the bins retraces
        key = tuple(
            tuple(sorted(v)) if isinstance(v, frozenset) else v
            for v in dataclasses.astuple(cfg)
        ) + (self._raster_meta,)
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                functools.partial(
                    frame_step,
                    cfg=cfg,
                    net_cfg=self.net_cfg,
                    train_unbiased_ratio=cfg.train_unbiased_ratio,
                    raster_meta=self._raster_meta,
                )
            )
            # bound the cache: camera motion reshapes the raster bins and
            # would otherwise retain one compiled frame program per pose
            while len(self._step_cache) > 16:
                self._step_cache.pop(next(iter(self._step_cache)))
        return self._step_cache[key]

    def set_hyper_params(
        self,
        learning_rate: float = None,
        train_unbiased_ratio: float = None,
        area_spread_factor: float = None,
    ) -> None:
        """Live NRC hyper-parameter updates (the reference's Stats-window
        sliders -> ``DeviceState`` dirty diff, ``Device.cpp:1724-1842``)."""
        import math

        h = self.hyper
        if learning_rate is not None:
            h = dataclasses.replace(h, learning_rate=learning_rate)
        if train_unbiased_ratio is not None:
            h = dataclasses.replace(
                h, train_unbiased_ratio=train_unbiased_ratio
            )
        if area_spread_factor is not None:
            h = dataclasses.replace(h, area_spread_factor=area_spread_factor)
        self.hyper = h
        self.cfg = dataclasses.replace(
            self.cfg,
            area_spread_sqrt=math.sqrt(h.area_spread_factor),
            train_unbiased_ratio=h.train_unbiased_ratio,
        )

    # -- frame loop --------------------------------------------------------

    def render_frame(self):
        """One subframe (1 spp accumulated)."""
        self._maybe_build_raster()
        step = self._compiled_step(self.cfg)
        self.image, self.net_state, stats = step(
            self.device_scene,
            self.net_state,
            self.image,
            self._camera_arrays(),
            jnp.int32(self.iteration),
            jnp.uint32(self.total_subframe),
            # traced: live lr edits don't recompile (optimizer->set_learning_rate)
            learning_rate=jnp.float32(self.hyper.learning_rate),
            raster_data=self._raster_data,
        )
        self.iteration += 1
        self.total_subframe += 1
        self.last_stats = stats
        if self.cfg.train:
            # Defer the stats readback: start an async device->host copy now
            # and consume it a couple of frames later, when it has already
            # landed — the frame loop never blocks on a readback round trip.
            # (The reference synchronously reads numTrainingRecords mid-frame,
            # Device.cpp:2487-2491 — its one hard sync; we keep even the
            # *end-of-frame* read off the critical path.)
            for leaf in (stats.loss, stats.num_train_records):
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
            self._pending_stats.append(stats)
            if len(self._pending_stats) > 2:
                self._consume_stats(self._pending_stats.popleft())
        return stats

    def _consume_stats(self, stats) -> None:
        # stats-window loss ring buffer (256-frame plot,
        # Application.cpp:1020-1048)
        self.loss_history.append(float(stats.loss))
        if self.adaptive_tiles:
            # adaptive tile sizing from a ~2-frame-old record count
            # (Device::adjustTileSize, Device.cpp:818-828; the lag only
            # delays the tile-size ramp by two frames)
            n = int(stats.num_train_records)
            new_ts = adjust_tile_size(self.cfg.tile_size, n)
            if new_ts != self.cfg.tile_size:
                self.cfg = dataclasses.replace(self.cfg, tile_size=new_ts)

    def flush_stats(self) -> None:
        """Drain deferred per-frame stats (call before reading
        ``loss_history`` at end of run)."""
        while self._pending_stats:
            self._consume_stats(self._pending_stats.popleft())

    def render(self, spp: int):
        for _ in range(spp):
            stats = self.render_frame()
        jax.block_until_ready(self.image)
        return stats

    def benchmark(self, spp: int):
        """Timed loop (``Application::benchmark``, Application.cpp:496-540)."""
        # warmup/compile
        self.render_frame()
        self.restart_accumulation()
        jax.block_until_ready(self.image)
        frame_stats = []
        t0 = time.perf_counter()
        for _ in range(spp):
            frame_stats.append(self.render_frame())
        jax.block_until_ready(self.image)
        dt = time.perf_counter() - t0
        # readback after the timer stops — per-frame int() would sync the
        # async dispatch pipeline and measure round trips, not render time
        traced = sum(int(s.traced_rays) for s in frame_stats)
        return {
            "spp": spp,
            "seconds": dt,
            "fps": spp / dt,
            # primary: rays actually cast (closest-hit segments of live lanes
            # + valid shadow rays); secondary: the potential-ray figure that
            # assumes every path runs all segments
            "mrays_per_s": traced / dt / 1e6,
            "potential_mrays_per_s": self.cfg.num_pixels
            * spp * (self.cfg.max_depth + 1) / dt / 1e6,
            "loss": float(self.last_stats.loss) if self.last_stats else 0.0,
        }

    # -- output ------------------------------------------------------------

    def image_hdr(self) -> np.ndarray:
        """[H, W, 3] linear HDR, row 0 at the top (display orientation)."""
        img = np.asarray(self.image).reshape(self.cfg.height, self.cfg.width, 3)
        return img[::-1]

    def save_system_description(self, path: str) -> str:
        """Write the current system state in the reference's system-file
        format (Key S -> ``Application::saveSystemDescription``,
        ``Application.cpp:1296-1335``), re-loadable by ``load_scene``."""
        s, tm, cam = self.system, self.system.tonemapper, self.scene.camera
        lines = [
            f"resolution {s.resolution[0]} {s.resolution[1]}",
            f"tileSize {s.tile_size[0]} {s.tile_size[1]}",
            f"samplesSqrt {s.samples_sqrt}",
            f"devicesMask {s.devices_mask}",
            f"arenaSize {s.arena_size_mib}",
            f"interop {s.interop}",
            f"present {s.present}",
            f"peerToPeer {s.peer_to_peer}",
            f"pathLengths {s.path_lengths[0]} {s.path_lengths[1]}",
            f"walkLength {s.walk_length}",
            f"epsilonFactor {s.epsilon_factor}",
            f"clockFactor {s.clock_factor}",
            f"lensShader {s.lens_shader}",
            "center " + " ".join(str(c) for c in cam.center),
            f"camera {cam.phi} {cam.theta} {cam.fov} {cam.distance}",
            f"prefixScreenshot \"{s.prefix_screenshot}\"",
            f"gamma {tm.gamma}",
            "colorBalance " + " ".join(str(c) for c in tm.color_balance),
            f"whitePoint {tm.white_point}",
            f"burnHighlights {tm.burn_highlights}",
            f"crushBlacks {tm.crush_blacks}",
            f"saturation {tm.saturation}",
            f"brightness {tm.brightness}",
        ]
        lines += [f"searchPath \"{p}\"" for p in s.search_paths]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def screenshot(self, path: str, tonemap: bool = True) -> str:
        if self.cfg.render_mode == RenderMode.DEBUG_TIME_VIEW:
            # already display-ready ramp colors — bypass the tonemapper
            ldr = np.asarray(
                jnp.clip(jnp.asarray(self.image_hdr()), 0.0, 1.0) * 255.0
            ).astype(np.uint8)
            if not path.endswith(".png"):
                path += ".png"
            write_png(path, ldr)
            return path
        if tonemap:
            ldr = np.asarray(
                tonemap_to_u8(jnp.asarray(self.image_hdr()), self.system.tonemapper)
            )
            if not path.endswith(".png"):
                path += ".png"
            write_png(path, ldr)
        else:
            if not path.endswith(".hdr"):
                path += ".hdr"
            write_hdr(path, self.image_hdr())
        return path
