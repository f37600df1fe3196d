"""End-to-end frame-step tests: the online self-training loop on Cornell.

These are the build's equivalent of the reference's implicit oracles
(SURVEY.md §4): NoCache as ground truth, loss decreasing over frames, and
Full-mode images approaching the NoCache reference.
"""

import os
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrc_tpu.config import FrameConfig, NetworkConfig, RenderMode
from nrc_tpu.render.frame import (
    assemble_training_batches,
    propagate_radiance,
)
from nrc_tpu.render.renderer import Renderer
from nrc_tpu.scene.scene_builder import load_scene

REF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)


@pytest.fixture(scope="module")
def cornell_small():
    scene, system = load_scene(
        f"{REF}/system_mdl_cornell.txt", f"{REF}/scene_mdl_cornell.txt"
    )
    system.resolution = (64, 64)
    system.tile_size = (8, 8)
    scene.camera.aspect = 1.0
    return scene, system


class TestPropagation:
    def test_radiance_flows_backward(self):
        # 2 tiles, 3 slots; tile 0 has 2 records, tile 1 has 0
        rec_target = jnp.zeros((2, 3, 3))
        rec_ltp = jnp.asarray(
            [[[0.5, 0.5, 0.5], [0.25, 0.25, 0.25], [0, 0, 0]],
             [[1, 1, 1], [1, 1, 1], [1, 1, 1]]]
        )
        rec_count = jnp.asarray([2, 0], jnp.int32)
        end_radiance = jnp.asarray([[8.0, 8.0, 8.0], [5.0, 5.0, 5.0]])
        end_mask = jnp.asarray([1.0, 1.0])
        out = np.asarray(
            propagate_radiance(rec_target, rec_ltp, rec_count, end_radiance, end_mask)
        )
        # slot1: 0 + 0.25*8 = 2 ; slot0: 0 + 0.5*2 = 1
        np.testing.assert_allclose(out[0, 1], [2.0] * 3)
        np.testing.assert_allclose(out[0, 0], [1.0] * 3)
        np.testing.assert_allclose(out[1], 0.0)  # no records -> untouched

    def test_unbiased_mask_zeroes_cache(self):
        rec_target = jnp.full((1, 2, 3), 3.0)
        rec_ltp = jnp.full((1, 2, 3), 0.5)
        rec_count = jnp.asarray([2], jnp.int32)
        end_radiance = jnp.asarray([[100.0, 100.0, 100.0]])
        end_mask = jnp.asarray([0.0])  # unbiased: don't propagate cache
        out = np.asarray(
            propagate_radiance(rec_target, rec_ltp, rec_count, end_radiance, end_mask)
        )
        # slot1: 3 + 0.5*0 = 3; slot0: 3 + 0.5*3 = 4.5
        np.testing.assert_allclose(out[0, 1], 3.0)
        np.testing.assert_allclose(out[0, 0], 4.5)


class TestBatchAssembly:
    def test_compaction_and_duplication(self):
        t, d = 4, 3
        q = jnp.arange(t * d * 15, dtype=jnp.float32).reshape(t, d, 15)
        tg = jnp.arange(t * d * 3, dtype=jnp.float32).reshape(t, d, 3)
        count = jnp.asarray([2, 0, 1, 3], jnp.int32)
        bq, bt, n = assemble_training_batches(jax.random.PRNGKey(0), q, tg, count)
        assert int(n) == 6
        from nrc_tpu.config import BATCH_SIZE, NUM_BATCHES

        assert bq.shape == (NUM_BATCHES, BATCH_SIZE, 15)
        # every sampled row must be one of the 6 valid records
        valid_rows = set()
        qn = np.asarray(q).reshape(-1, 15)
        for tile in range(t):
            for s in range(int(count[tile])):
                valid_rows.add(tuple(qn[tile * d + s]))
        sampled = np.asarray(bq).reshape(-1, 15)
        for row in sampled[:200]:
            assert tuple(row) in valid_rows


class TestOnlineTraining:
    def test_loss_decreases_and_full_mode_converges(self, cornell_small):
        scene, system = cornell_small
        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        losses = []
        for _ in range(40):
            stats = r.render_frame()
            losses.append(float(stats.loss))
        assert int(stats.num_train_records) > 0
        # online training on ~100 MC-noisy records/frame plateaus at the
        # noise floor; compare the untrained start against the plateau
        early = np.mean(losses[:2])
        late = np.mean(losses[-10:])
        assert late < early * 0.9, f"loss should decrease: {early} -> {late}"
        img = r.image_hdr()
        assert np.all(np.isfinite(img))
        assert img.mean() > 0.02

    def test_full_vs_nocache_psnr(self, cornell_small):
        scene, system = cornell_small
        # ground truth: NoCache at decent spp
        r_gt = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, train=False)
        r_gt.render(48)
        gt = r_gt.image_hdr()

        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        # let the cache warm up, then restart accumulation and measure
        for _ in range(40):
            r.render_frame()
        r.restart_accumulation()
        for _ in range(48):
            r.render_frame()
        full = r.image_hdr()

        def psnr(a, b, peak=None):
            mse = np.mean((a - b) ** 2)
            peak = peak or max(b.max(), 1e-6)
            return 10 * np.log10(peak ** 2 / mse)

        # tonemap-space comparison is more meaningful than raw HDR
        from nrc_tpu.utils.tonemap import tonemap

        gt_t = np.asarray(tonemap(jnp.asarray(gt), system.tonemapper))
        full_t = np.asarray(tonemap(jnp.asarray(full), system.tonemapper))
        p = psnr(full_t, gt_t, peak=1.0)
        assert p > 18.0, f"FULL-mode image too far from NoCache oracle: {p:.2f} dB"

    def test_cache_modes_run(self, cornell_small):
        scene, system = cornell_small
        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        for _ in range(5):
            r.render_frame()
        for mode in (
            RenderMode.CACHE_ONLY,
            RenderMode.CACHE_FIRST_VERTEX,
            RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION,
            RenderMode.DEBUG_THROUGHPUT_ONLY,
        ):
            r.set_render_mode(mode)
            r.render_frame()
            img = r.image_hdr()
            assert np.all(np.isfinite(img)), mode


class TestHyperParams:
    def test_set_hyper_params_threads_through(self, cornell_small):
        import dataclasses

        scene, system = cornell_small
        from nrc_tpu.render.renderer import Renderer
        from nrc_tpu.config import RenderMode

        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        r.set_hyper_params(learning_rate=5e-3, train_unbiased_ratio=0.5,
                           area_spread_factor=0.04)
        assert r.hyper.learning_rate == 5e-3
        assert r.cfg.train_unbiased_ratio == 0.5
        assert abs(r.cfg.area_spread_sqrt - 0.2) < 1e-6
        # renders with the new static config (fresh compile keyed on cfg)
        stats = r.render_frame()
        assert stats is not None


class TestReflectanceFactoring:
    def test_converges_with_factoring(self, cornell_small):
        """With reflectance factoring the cache learns radiance/albedo and
        predictions are scaled back: loss decreases and the image stays
        finite and lit (USE_REFLECTANCE_FACTORING semantics)."""
        scene, system = cornell_small
        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False, reflectance_factoring=True)
        losses = []
        for _ in range(40):
            stats = r.render_frame()
            losses.append(float(stats.loss))
        assert int(stats.num_train_records) > 0
        early = np.mean(losses[:2])
        late = np.mean(losses[-10:])
        assert np.isfinite(losses).all()
        assert late < early * 0.9, f"loss should decrease: {early} -> {late}"
        img = r.image_hdr()
        assert np.all(np.isfinite(img))
        assert img.mean() > 0.02

    def test_query_reflectance_slice(self):
        from nrc_tpu.render.frame import query_reflectance

        q = np.zeros((2, 15), np.float32)
        q[0, 9:12] = (0.2, 0.3, 0.4)   # diffuse albedo
        q[0, 12:15] = (0.1, 0.1, 0.1)  # specular albedo
        np.testing.assert_allclose(
            query_reflectance(q)[0], [0.3, 0.4, 0.5], atol=1e-7
        )


class TestTracedRayAccounting:
    def test_traced_rays_positive_and_below_potential(self, cornell_small):
        """FrameStats.traced_rays counts rays actually cast: > 0, bounded by
        the potential figure (pixels+tiles) x (max_depth+1) x 2, and — since
        the area-spread heuristic truncates most FULL paths in 1-2 bounces —
        well below it on Cornell."""
        scene, system = cornell_small
        r = Renderer(scene, system, render_mode=RenderMode.FULL,
                     train=True, adaptive_tiles=False)
        for _ in range(2):
            stats = r.render_frame()
        traced = int(stats.traced_rays)
        potential = (r.cfg.num_pixels + r.cfg.num_tiles) * (r.cfg.max_depth + 1) * 2
        assert traced > r.cfg.num_pixels  # at least one segment per pixel
        assert traced <= potential
        # Cornell FULL mode truncates early: traced is a small fraction
        assert traced < 0.8 * potential

    def test_no_cache_traces_more_than_full(self, cornell_small):
        """NO_CACHE paths run to max_depth (no truncation into the cache), so
        they must cast more rays per frame than FULL."""
        scene, system = cornell_small
        r_full = Renderer(scene, system, render_mode=RenderMode.FULL,
                          train=False, adaptive_tiles=False)
        r_nc = Renderer(scene, system, render_mode=RenderMode.NO_CACHE,
                        train=False, adaptive_tiles=False)
        t_full = int(r_full.render_frame().traced_rays)
        t_nc = int(r_nc.render_frame().traced_rays)
        assert t_nc > t_full > 0
