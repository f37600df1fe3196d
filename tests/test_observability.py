"""Observability parity (SURVEY.md §5): time-view bounce AOV + color ramp,
system-description save/reload, loss ring buffer."""

import os
import numpy as np
import jax.numpy as jnp

from nrc_tpu.config import RenderMode
from nrc_tpu.render.renderer import Renderer
from nrc_tpu.scene.scene_builder import load_scene
from nrc_tpu.utils.tonemap import time_view_ramp

REF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)


def _cornell(res=32, tile=8):
    scene, system = load_scene(
        f"{REF}/system_mdl_cornell.txt", f"{REF}/scene_mdl_cornell.txt"
    )
    system.resolution = (res, res)
    system.tile_size = (tile, tile)
    scene.camera.aspect = 1.0
    return scene, system


class TestColorRamp:
    def test_control_points(self):
        """Reference's cold-to-hot ramp control points
        (Rasterizer.cpp:306-345)."""
        x = jnp.asarray([0.0, 0.25, 0.5, 0.75, 1.0])
        c = np.asarray(time_view_ramp(x))
        np.testing.assert_allclose(c[0], [0, 0, 1], atol=1e-6)  # blue
        np.testing.assert_allclose(c[1], [0, 1, 0], atol=1e-6)  # green
        np.testing.assert_allclose(c[2], [1, 0, 0], atol=1e-6)  # red
        np.testing.assert_allclose(c[3], [1, 1, 0], atol=1e-6)  # yellow
        np.testing.assert_allclose(c[4], [1, 1, 1], atol=1e-6)  # white

    def test_midpoints_interpolate(self):
        c = np.asarray(time_view_ramp(jnp.asarray([0.125])))
        np.testing.assert_allclose(c[0], [0.0, 0.5, 0.5], atol=1e-6)
        # out-of-range clamps
        c = np.asarray(time_view_ramp(jnp.asarray([-1.0, 2.0])))
        np.testing.assert_allclose(c[0], [0, 0, 1], atol=1e-6)
        np.testing.assert_allclose(c[1], [1, 1, 1], atol=1e-6)


class TestTimeView:
    def test_time_view_renders_heat_map(self):
        scene, system = _cornell()
        r = Renderer(scene, system, render_mode=RenderMode.DEBUG_TIME_VIEW,
                     train=False, adaptive_tiles=False)
        r.render(2)
        img = np.asarray(r.image_hdr())
        assert np.all(np.isfinite(img))
        assert img.min() >= 0.0 and img.max() <= 1.0
        # interior pixels bounce >= twice -> non-trivial heat variation
        assert img.std() > 0.01
        # all pixels hit at least the box -> nothing stays at ramp(0) blue
        assert img.mean() > 0.1

    def test_bounce_count_in_wavefront(self):
        import jax

        from nrc_tpu.render.integrator import trace_wavefront
        from nrc_tpu.render.scene_device import upload_scene
        from nrc_tpu.scene.camera import generate_primary_rays
        from nrc_tpu.utils import rng as R
        from nrc_tpu.config import FrameConfig

        scene, system = _cornell()
        dev = upload_scene(scene)
        res = 16
        cfg = FrameConfig(width=res, height=res, max_depth=4,
                          render_mode=RenderMode.NO_CACHE, train=False)
        p, u, v, w = scene.camera.frustum()
        ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
        pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2), jnp.float32)
        seeds = R.tea(jnp.arange(res * res, dtype=jnp.uint32), jnp.uint32(0))
        seeds, jitter = R.rng2(seeds)
        org, d = generate_primary_rays(
            pix, jitter, (res, res),
            jnp.asarray(p), jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
        )
        out = trace_wavefront(dev, org, d, seeds, cfg, train=False)
        bc = np.asarray(out.bounce_count)
        assert bc.shape == (res * res,)
        # the box doesn't fill the frame at Cornell's fov: interior pixels
        # bounce, border pixels miss into the black background
        interior = bc.reshape(res, res)[4:-4, 4:-4]
        assert interior.min() >= 1
        assert bc.max() <= cfg.max_depth + 1
        assert interior.max() > interior.min()  # termination varies


class TestSaveSystem:
    def test_roundtrip(self, tmp_path):
        scene, system = _cornell()
        r = Renderer(scene, system, render_mode=RenderMode.NO_CACHE,
                     train=False)
        path = str(tmp_path / "system_saved.txt")
        r.save_system_description(path)
        # reloadable by the same parser, state preserved
        scene2, system2 = load_scene(path, f"{REF}/scene_mdl_cornell.txt")
        assert system2.resolution == system.resolution
        assert system2.path_lengths == system.path_lengths
        assert system2.tonemapper.gamma == system.tonemapper.gamma
        assert scene2.camera.distance == scene.camera.distance
        assert scene2.camera.fov == scene.camera.fov


class TestLossHistory:
    def test_ring_buffer_fills(self):
        scene, system = _cornell(tile=8)
        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        for _ in range(4):
            r.render_frame()
        # readbacks are deferred (async, ~2-frame lag) so the loop never
        # blocks on the device; flush drains the tail
        assert len(r.loss_history) == 2
        r.flush_stats()
        assert len(r.loss_history) == 4
        assert all(np.isfinite(x) for x in r.loss_history)
        assert r.loss_history.maxlen == 256
