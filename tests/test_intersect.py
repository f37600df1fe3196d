"""Intersection tests: brute force vs BVH parity, shadow rays, Cornell scene."""

import os
import jax.numpy as jnp
import numpy as np
import pytest

from nrc_tpu.ops.bvh import build_bvh, flatten_skip_links
from nrc_tpu.ops.intersect import (
    RT_MAX,
    TriSoA,
    intersect_bruteforce,
    intersect_bvh,
    occluded_bruteforce,
    occluded_bvh,
)

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)


def random_tris(n, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    base = rs.randn(n, 3) * scale
    p0 = base
    p1 = base + rs.randn(n, 3) * 0.3
    p2 = base + rs.randn(n, 3) * 0.3
    return p0.astype(np.float32), p1.astype(np.float32), p2.astype(np.float32)


class TestBruteForce:
    def test_single_triangle_hit(self):
        tris = TriSoA.build(
            np.array([[0.0, 0.0, 0.0]]),
            np.array([[1.0, 0.0, 0.0]]),
            np.array([[0.0, 1.0, 0.0]]),
        )
        org = jnp.asarray([[0.2, 0.2, -1.0], [0.9, 0.9, -1.0]])
        d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
        tmin = jnp.zeros(2)
        tmax = jnp.full((2,), 100.0)
        hit = intersect_bruteforce(org, d, tris, tmin, tmax)
        assert bool(hit.valid[0]) and not bool(hit.valid[1])
        assert float(hit.t[0]) == pytest.approx(1.0, abs=1e-5)
        assert float(hit.u[0]) == pytest.approx(0.2, abs=1e-5)
        assert float(hit.v[0]) == pytest.approx(0.2, abs=1e-5)

    def test_closest_of_two(self):
        tris = TriSoA.build(
            np.array([[-1, -1, 2.0], [-1, -1, 1.0]]),
            np.array([[3, -1, 2.0], [3, -1, 1.0]]),
            np.array([[-1, 3, 2.0], [-1, 3, 1.0]]),
        )
        org = jnp.asarray([[0.0, 0.0, 0.0]])
        d = jnp.asarray([[0.0, 0.0, 1.0]])
        hit = intersect_bruteforce(org, d, tris, jnp.zeros(1), jnp.full((1,), 100.0))
        assert int(hit.prim[0]) == 1
        assert float(hit.t[0]) == pytest.approx(1.0, abs=1e-5)

    def test_tmin_respected(self):
        tris = TriSoA.build(
            np.array([[-1, -1, 1.0]]), np.array([[3, -1, 1.0]]), np.array([[-1, 3, 1.0]])
        )
        org = jnp.asarray([[0.0, 0.0, 0.0]])
        d = jnp.asarray([[0.0, 0.0, 1.0]])
        hit = intersect_bruteforce(org, d, tris, jnp.full((1,), 1.5), jnp.full((1,), 100.0))
        assert not bool(hit.valid[0])

    def test_occlusion(self):
        tris = TriSoA.build(
            np.array([[-1, -1, 1.0]]), np.array([[3, -1, 1.0]]), np.array([[-1, 3, 1.0]])
        )
        org = jnp.asarray([[0.0, 0.0, 0.0]] * 2)
        d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
        occ = occluded_bruteforce(org, d, tris, jnp.zeros(2), jnp.full((2,), 100.0))
        assert bool(occ[0]) and not bool(occ[1])


class TestBVH:
    def test_build_valid(self):
        p0, p1, p2 = random_tris(500, seed=3)
        bvh = build_bvh(p0, p1, p2)
        n = bvh["lo"].shape[0]
        assert n >= 2
        assert np.sort(bvh["order"]).tolist() == list(range(500))
        # leaf ranges tile [0, 500)
        leaf = bvh["count"] > 0
        total = bvh["count"][leaf].sum()
        assert total == 500
        # children AABBs inside parents
        for node in range(n):
            if bvh["count"][node] == 0:
                l, r = bvh["left"][node], bvh["right"][node]
                for c in (l, r):
                    assert np.all(bvh["lo"][c] >= bvh["lo"][node] - 1e-5)
                    assert np.all(bvh["hi"][c] <= bvh["hi"][node] + 1e-5)

    def test_matches_bruteforce(self):
        p0, p1, p2 = random_tris(300, seed=1)
        tris = TriSoA.build(p0, p1, p2)
        bvh_np = flatten_skip_links(build_bvh(p0, p1, p2), p0, p1, p2)
        bvh = {k: jnp.asarray(v) for k, v in bvh_np.items()}

        rs = np.random.RandomState(7)
        n = 256
        org = jnp.asarray(rs.randn(n, 3) * 3, jnp.float32)
        d = jnp.asarray(rs.randn(n, 3), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        tmin = jnp.zeros(n)
        tmax = jnp.full((n,), 1e30)

        hb = intersect_bruteforce(org, d, tris, tmin, tmax)
        hv = intersect_bvh(org, d, bvh, tris, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hv.valid))
        np.testing.assert_allclose(
            np.asarray(hb.t)[np.asarray(hb.valid)],
            np.asarray(hv.t)[np.asarray(hb.valid)],
            rtol=1e-4,
        )
        # prim can differ only at exactly-equal t; check it rarely differs
        same = np.mean(np.asarray(hb.prim) == np.asarray(hv.prim))
        assert same > 0.97

    def test_occlusion_matches(self):
        p0, p1, p2 = random_tris(200, seed=2)
        tris = TriSoA.build(p0, p1, p2)
        bvh = {
            k: jnp.asarray(v)
            for k, v in flatten_skip_links(
                build_bvh(p0, p1, p2), p0, p1, p2
            ).items()
        }
        rs = np.random.RandomState(5)
        n = 128
        org = jnp.asarray(rs.randn(n, 3) * 2, jnp.float32)
        d = jnp.asarray(rs.randn(n, 3), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        tmin = jnp.zeros(n)
        tmax = jnp.full((n,), 4.0)
        ob = occluded_bruteforce(org, d, tris, tmin, tmax)
        ov = occluded_bvh(org, d, bvh, tris, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(ob), np.asarray(ov))


class TestCornell:
    def test_cornell_primary_rays(self):
        from nrc_tpu.scene.scene_builder import load_scene
        from nrc_tpu.scene.camera import generate_primary_rays

        scene, system = load_scene(
            f"{CORNELL}/system_mdl_cornell.txt",
            f"{CORNELL}/scene_mdl_cornell.txt",
        )
        tris = TriSoA.build(scene.p0, scene.p1, scene.p2)
        p, u, v, w = scene.camera.frustum()
        res = 32
        ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
        pix = jnp.asarray(
            np.stack([xs, ys], -1).reshape(-1, 2) * (320.0 / res), jnp.float32
        )
        org, d = generate_primary_rays(
            pix, jnp.full((res * res, 2), 0.5), (320, 320),
            jnp.asarray(p), jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
        )
        hit = intersect_bruteforce(
            org, d, tris, jnp.zeros(res * res), jnp.full((res * res,), 1e30)
        )
        # the camera looks in through the open front face: central rays hit,
        # wide-angle rays fly past the box (no front wall, no env light)
        valid = np.asarray(hit.valid)
        assert valid.mean() > 0.5
        center = valid.reshape(res, res)[res // 4 : -res // 4, res // 4 : -res // 4]
        assert np.all(center)
        t = np.asarray(hit.t)[valid]
        assert t.min() > 5.0 and t.max() < 60.0


class TestChunkedTraversal:
    """The coherence-sorted chunked wrapper must be exact vs the plain
    walk: non-divisible N, dead lanes, and the any-hit variant."""

    def _setup(self, n_rays):
        p0, p1, p2 = random_tris(3000, seed=7)
        tris = TriSoA.build(p0, p1, p2)
        bvh = flatten_skip_links(build_bvh(p0, p1, p2), p0, p1, p2)
        bvh = {k: jnp.asarray(v) for k, v in bvh.items()}
        rs = np.random.RandomState(11)
        org = jnp.asarray(rs.randn(n_rays, 3) * 2.0, jnp.float32)
        d = jnp.asarray(rs.randn(n_rays, 3), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return tris, bvh, org, d

    def test_chunked_matches_plain_closest(self):
        from nrc_tpu.ops.intersect import _skip_traverse

        n = 5000  # > 2*TRAVERSAL_CHUNK and not a multiple of it
        tris, bvh, org, d = self._setup(n)
        tmin = jnp.zeros(n)
        tmax = jnp.full((n,), RT_MAX)
        # a band of dead lanes (terminated paths)
        tmax = tmax.at[1000:1500].set(0.0)
        hit = intersect_bvh(org, d, bvh, tris, tmin, tmax)
        t_ref, p_ref = _skip_traverse(org, d, bvh, tmin, tmax, False)
        np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(p_ref))
        valid = np.asarray(p_ref) >= 0
        np.testing.assert_allclose(
            np.asarray(hit.t)[valid], np.asarray(t_ref)[valid], rtol=1e-6
        )
        assert not np.any(np.asarray(hit.prim)[1000:1500] >= 0)

    def test_chunked_matches_plain_anyhit(self):
        from nrc_tpu.ops.intersect import _skip_traverse

        n = 4608
        tris, bvh, org, d = self._setup(n)
        tmin = jnp.zeros(n)
        tmax = jnp.full((n,), 3.0)
        occ = occluded_bvh(org, d, bvh, tris, tmin, tmax)
        _, p_ref = _skip_traverse(org, d, bvh, tmin, tmax, True)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(p_ref) >= 0)

    def test_small_batch_uses_plain_path(self):
        n = 256
        tris, bvh, org, d = self._setup(n)
        tmin = jnp.zeros(n)
        tmax = jnp.full((n,), RT_MAX)
        hit = intersect_bvh(org, d, bvh, tris, tmin, tmax)
        ref = intersect_bruteforce(org, d, tris, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(ref.prim))


def test_native_flatten_matches_python():
    """The C pre-order walk + collapse sizes must reproduce the Python
    fallback bit for bit (compare bitcast columns as i32: NaN patterns)."""
    import nrc_tpu.native as N
    from nrc_tpu.ops import bvh as B

    if N.get_lib() is None:
        pytest.skip("native lib unavailable")
    p0, p1, p2 = random_tris(500, seed=5)
    b = build_bvh(p0, p1, p2)
    rows = np.concatenate([p0, p1 - p0, p2 - p0], -1).astype(np.float32)
    fc = B.flatten_skip_links_rows(b, rows, 4)
    lib_save, failed_save = N._lib, N._failed
    try:
        N._lib, N._failed = None, True
        fp = B.flatten_skip_links_rows(b, rows, 4)
    finally:
        N._lib, N._failed = lib_save, failed_save
    for k in fc:
        a, c = fc[k], fp[k]
        if a.dtype == np.float32:
            a, c = a.view(np.int32), c.view(np.int32)
        np.testing.assert_array_equal(a, c, err_msg=k)
