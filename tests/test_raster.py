"""Tiled primary-visibility raster (round 5, ops/raster_primary.py).

The raster resolves camera-ray visibility with dense per-screen-tile MT
tests over conservative candidate sets — winners must be identical to the
brute-force/BVH answer for every pixel (same triangle test, superset
candidates)."""

import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nrc_tpu.ops.intersect import TriSoA, intersect_bruteforce
from nrc_tpu.ops.raster_primary import (
    RasterData,
    build_raster_bins,
    raster_closest_hit,
)
from nrc_tpu.scene.camera import generate_primary_rays

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)


def _soup(T, seed, spread=0.3, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(lo, hi, (T, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    return p0, p1, p2


def _run_case(cam_p, cam_u, cam_v, cam_w, p0, p1, p2, W, H, seed):
    rng = np.random.default_rng(seed)
    tris = TriSoA.build(p0, p1, p2)
    built = build_raster_bins(p0, p1, p2, cam_p, cam_u, cam_v, cam_w, W, H)
    assert built is not None
    meta, pids_np, perm_np, inv_np = built
    pids = jnp.asarray(pids_np)
    data = RasterData(
        rows=tris.packed[jnp.maximum(pids, 0)],
        pids=pids,
        perm=jnp.asarray(perm_np),
        inv_perm=jnp.asarray(inv_np),
    )
    lin = np.arange(W * H)
    pix = np.stack([lin % W, lin // W], -1).astype(np.float32)
    jit = rng.uniform(0, 1, (W * H, 2)).astype(np.float32)
    org, d = generate_primary_rays(
        jnp.asarray(pix), jnp.asarray(jit), (W, H),
        jnp.asarray(cam_p), jnp.asarray(cam_u), jnp.asarray(cam_v),
        jnp.asarray(cam_w),
    )
    tmin = jnp.zeros(W * H)
    tmax = jnp.full((W * H,), 1e30)
    t, prim = raster_closest_hit(meta, data, org, d, tmin, tmax)
    bf = intersect_bruteforce(org, d, tris, tmin, tmax)
    pa, pb = np.asarray(prim), np.asarray(bf.prim)
    ta, tb = np.asarray(t), np.asarray(bf.t)
    mism = np.nonzero(pa != pb)[0]
    bad = [i for i in mism
           if abs(ta[i] - tb[i]) > 1e-5 * max(1.0, abs(tb[i]))]
    assert not bad, (len(bad), bad[:5])
    assert int((pa >= 0).sum()) == int((pb >= 0).sum())
    return meta


class TestRasterParity:
    def test_front_soup_matches_bruteforce(self):
        p0, p1, p2 = _soup(4000, 3)
        meta = _run_case(
            np.array([0.0, 0.0, 6.0], np.float32),
            np.array([1.2, 0.0, 0.0], np.float32),
            np.array([0.0, 0.9, 0.1], np.float32),   # skewed basis
            np.array([0.0, 0.0, -1.0], np.float32),
            p0, p1, p2, 64, 48, seed=4,
        )
        assert meta.tile == 16

    def test_camera_inside_soup_near_clip(self):
        # camera inside the cloud: behind + straddling triangles exercise
        # the conservative near clip
        p0, p1, p2 = _soup(6000, 7, spread=0.8, lo=-3.0, hi=3.0)
        _run_case(
            np.array([0.1, -0.2, 0.05], np.float32),
            np.array([1.3, 0.1, 0.0], np.float32),
            np.array([0.0, 1.0, 0.0], np.float32),
            np.array([0.2, 0.0, -1.0], np.float32),
            p0, p1, p2, 80, 64, seed=8,
        )

    def test_tile8_fallback_resolution(self):
        # 40x24 is 8-divisible but not 16-divisible (the 1280x360 / 2K case)
        p0, p1, p2 = _soup(2000, 11)
        meta = _run_case(
            np.array([0.0, 0.0, 6.0], np.float32),
            np.array([1.2, 0.0, 0.0], np.float32),
            np.array([0.0, 0.9, 0.0], np.float32),
            np.array([0.0, 0.0, -1.0], np.float32),
            p0, p1, p2, 40, 24, seed=12,
        )
        assert meta.tile == 8


class TestRasterInFrame:
    def test_renderer_image_matches_walk(self, tmp_path):
        """End-to-end: the raster-primary frame must match the walk frame
        (same transport, only depth-0 resolution differs; winners are
        identical so images agree to float tolerance)."""
        import os

        from nrc_tpu.config import RenderMode
        from nrc_tpu.render.renderer import Renderer
        from nrc_tpu.scene.scene_builder import load_scene

        scene_file = tmp_path / "scene.txt"
        base = open(
            f"{CORNELL}/scene_mdl_cornell.txt"
        ).read()
        scene_file.write_text(
            base + "\npush\nscale 3 3 3\ntranslate 0 -3 0\n"
            "model sphere 180 90 1 bsdf_diffuse_reflection_c_red\npop\n"
        )
        scene, system = load_scene(
            f"{CORNELL}/system_mdl_cornell.txt", str(scene_file)
        )
        system.resolution = (64, 48)
        scene.camera.aspect = 64 / 48
        system.tile_size = (8, 8)

        def render(raster: bool):
            os.environ["NRC_RASTER_PRIMARY"] = "1" if raster else "0"
            r = Renderer(
                scene, system, render_mode=RenderMode.NO_CACHE,
                train=False, adaptive_tiles=False,
            )
            if raster:
                assert r._raster_enabled
            for _ in range(2):
                r.render_frame()
            if raster:
                assert r._raster_meta is not None
            return np.asarray(r.image)

        try:
            a = render(True)
            b = render(False)
        finally:
            os.environ.pop("NRC_RASTER_PRIMARY", None)
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
