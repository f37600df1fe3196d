"""8-wide BVH build + traversal vs brute force (identical hits).

The wide path (``ops/bvh_wide.py`` + ``ops/intersect_wide.py``) replaces
the binary skip-link walk for large scenes: one gathered row tests 8 child
boxes. These tests pin exact winner agreement with the chunked brute force
on random soups and on a reference asset, plus the build invariants.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nrc_tpu.ops.intersect import (
    RT_MAX,
    TriSoA,
    intersect_bruteforce,
    occluded_bruteforce,
)
from nrc_tpu.ops.bvh_wide import BRANCH, NONE, build_wide_bvh
from nrc_tpu.ops.intersect_wide import intersect_wbvh, occluded_wbvh


def _soup(T, seed=1, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.random((T, 3)).astype(np.float32) * 10
    p0 = c + rng.normal(size=(T, 3)).astype(np.float32) * spread
    p1 = c + rng.normal(size=(T, 3)).astype(np.float32) * spread
    p2 = c + rng.normal(size=(T, 3)).astype(np.float32) * spread
    return p0, p1, p2


def _rays(N, seed=2, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    org = (lo + rng.random((N, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def _assert_same_hits(a_prim, a_t, b_prim, b_t):
    pa, pb = np.asarray(a_prim), np.asarray(b_prim)
    ta, tb = np.asarray(a_t), np.asarray(b_t)
    mism = np.nonzero(pa != pb)[0]
    # different winner allowed only on an exact-t tie
    real = [
        i for i in mism
        if abs(ta[i] - tb[i]) > 1e-5 * max(1.0, abs(tb[i]))
    ]
    assert not real, (len(real), real[:5])
    same = (pa >= 0) & (pa == pb)
    np.testing.assert_allclose(ta[same], tb[same], rtol=1e-5)


class TestBuild:
    def test_invariants(self):
        p0, p1, p2 = _soup(2000)
        wb = build_wide_bvh(p0, p1, p2)
        W = wb["wsplit"].shape[1]
        rows, P = wb["rows"].shape
        L = rows - W
        assert P >= BRANCH * 7
        metas = wb["rows"][:W, BRANCH * 6: BRANCH * 7].view(np.int32)
        inner = (metas >= 0) & (metas != NONE)
        # inner children point inside the node-row prefix
        assert metas[inner].max(initial=0) < W
        # every leaf row referenced exists
        leafs = np.where((metas < 0) & (metas != NONE), ~metas, -1)
        assert leafs.max() < L
        # all prims present exactly once across leaves
        ids = wb["leaf_ids"]
        got = np.sort(ids[ids >= 0])
        np.testing.assert_array_equal(got, np.arange(2000))

    def test_tiny_scene_single_leaf(self):
        p0, p1, p2 = _soup(3)
        wb = build_wide_bvh(p0, p1, p2)
        tris = TriSoA.build(p0, p1, p2)
        org, d = _rays(64)
        tmin = jnp.zeros(64)
        tmax = jnp.full((64,), RT_MAX)
        a = intersect_wbvh(org, d, jax.tree.map(jnp.asarray, wb), tris, tmin, tmax)
        b = intersect_bruteforce(org, d, tris, tmin, tmax)
        _assert_same_hits(a.prim, a.t, b.prim, b.t)


class TestTraversal:
    @pytest.mark.parametrize("T,N", [(500, 777), (5000, 4100)])
    def test_matches_bruteforce(self, T, N):
        p0, p1, p2 = _soup(T)
        tris = TriSoA.build(p0, p1, p2)
        wb = jax.tree.map(jnp.asarray, build_wide_bvh(p0, p1, p2))
        org, d = _rays(N)
        tmin = np.zeros(N, np.float32)
        tmax = np.full(N, RT_MAX, np.float32)
        tmax[::13] = 0.0  # dead lanes
        tmin[::7] = 0.5   # epsilon offsets
        tmin_j, tmax_j = jnp.asarray(tmin), jnp.asarray(tmax)
        a = intersect_wbvh(org, d, wb, tris, tmin_j, tmax_j)
        b = intersect_bruteforce(org, d, tris, tmin_j, tmax_j)
        _assert_same_hits(a.prim, a.t, b.prim, b.t)
        # dead lanes report no hit
        assert not np.asarray(a.prim[::13] >= 0).any()

    def test_anyhit_matches(self):
        p0, p1, p2 = _soup(3000)
        tris = TriSoA.build(p0, p1, p2)
        wb = jax.tree.map(jnp.asarray, build_wide_bvh(p0, p1, p2))
        N = 2048
        org, d = _rays(N)
        tmin = jnp.full((N,), 1e-3)
        tmax = jnp.full((N,), RT_MAX)
        oa = occluded_wbvh(org, d, wb, tris, tmin, tmax)
        ob = occluded_bruteforce(org, d, tris, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))

    def test_finite_tmax_segments(self):
        # shadow-ray style: tmax = distance to a light point
        p0, p1, p2 = _soup(1500, seed=5)
        tris = TriSoA.build(p0, p1, p2)
        wb = jax.tree.map(jnp.asarray, build_wide_bvh(p0, p1, p2))
        N = 513
        org, d = _rays(N, seed=6)
        rng = np.random.default_rng(7)
        tmax = jnp.asarray(rng.random(N).astype(np.float32) * 8.0)
        tmin = jnp.full((N,), 1e-4)
        a = intersect_wbvh(org, d, wb, tris, tmin, tmax)
        b = intersect_bruteforce(org, d, tris, tmin, tmax)
        _assert_same_hits(a.prim, a.t, b.prim, b.t)

    def test_near_axis_directions(self):
        # directions nearly parallel to axes exercise the inf-slab edge
        # cases that broke the inverted-AABB empty-slot trick
        p0, p1, p2 = _soup(800, seed=9)
        tris = TriSoA.build(p0, p1, p2)
        wb = jax.tree.map(jnp.asarray, build_wide_bvh(p0, p1, p2))
        N = 384
        rng = np.random.default_rng(10)
        org = jnp.asarray(rng.random((N, 3)).astype(np.float32) * 10)
        d = np.zeros((N, 3), np.float32)
        ax = rng.integers(0, 3, N)
        d[np.arange(N), ax] = np.where(rng.random(N) < 0.5, 1.0, -1.0)
        d += rng.normal(size=(N, 3)).astype(np.float32) * 1e-9
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = jnp.asarray(d)
        tmin = jnp.zeros(N)
        tmax = jnp.full((N,), RT_MAX)
        a = intersect_wbvh(org, d, wb, tris, tmin, tmax)
        b = intersect_bruteforce(org, d, tris, tmin, tmax)
        _assert_same_hits(a.prim, a.t, b.prim, b.t)


class TestSort8:
    def test_matches_argsort(self):
        from nrc_tpu.ops.intersect_wide import sort8_by_key

        rng = np.random.default_rng(3)
        key = rng.random((257, 8)).astype(np.float32)
        key[rng.random((257, 8)) < 0.3] = np.inf  # missed/empty slots
        val = rng.integers(-100, 100, (257, 8)).astype(np.int32)
        got = np.asarray(sort8_by_key(jnp.asarray(key), jnp.asarray(val)))
        order = np.argsort(key, axis=1, kind="stable")
        want = np.take_along_axis(val, order, axis=1)
        skey = np.take_along_axis(key, order, axis=1)
        # values must agree wherever keys are unique; on ties any order is
        # fine — compare sorted values within each tie group
        for r in range(257):
            i = 0
            while i < 8:
                j = i
                while j < 8 and skey[r, j] == skey[r, i]:
                    j += 1
                np.testing.assert_array_equal(
                    np.sort(got[r, i:j]), np.sort(want[r, i:j])
                )
                i = j


class TestSplitU16Rows:
    def test_split_walk_identical_hits(self):
        """The u16 half-table layout (bvh_wide.split_rows_u16) must produce
        BIT-identical hits: the reconstruct is an exact bitcast round trip.
        (Kept as a capability: faster gathers in isolation, slower inside
        the walk's while body on an earlier accelerator — see
        scene_device.upload_scene.)"""
        from nrc_tpu.ops.bvh_wide import build_wide_bvh, split_rows_u16
        from nrc_tpu.ops.intersect_wide import _chunked_wide

        rng = np.random.default_rng(11)
        t0 = rng.random((3000, 3), dtype=np.float32) * 4 - 2
        p0 = t0
        p1 = t0 + rng.random((3000, 3), dtype=np.float32) * 0.3
        p2 = t0 + rng.random((3000, 3), dtype=np.float32) * 0.3
        wide = build_wide_bvh(p0, p1, p2)
        split = dict(wide)
        split.update(split_rows_u16(split.pop("rows")))
        org = rng.random((256, 3), dtype=np.float32) * 4 - 2
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        tmin = jnp.full((256,), 1e-4)
        tmax = jnp.full((256,), 3.0e38)
        a = _chunked_wide(jnp.asarray(org), jnp.asarray(d), 
                          {k: jnp.asarray(v) for k, v in wide.items()},
                          tmin, tmax, any_hit=False)
        b = _chunked_wide(jnp.asarray(org), jnp.asarray(d),
                          {k: jnp.asarray(v) for k, v in split.items()},
                          tmin, tmax, any_hit=False)
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


class TestBranch16:
    @pytest.mark.parametrize("branch,leaf", [(16, 8), (16, 16)])
    def test_matches_bruteforce(self, branch, leaf):
        """Branch-generic walk (round 4): 16-wide nodes halve tree depth —
        fewer row gathers per ray at the same ~15 ns/index gather rate."""
        p0, p1, p2 = _soup(5000, seed=21)
        tris = TriSoA.build(p0, p1, p2)
        wb = jax.tree.map(
            jnp.asarray, build_wide_bvh(p0, p1, p2, branch=branch,
                                        leaf_size=leaf)
        )
        org, d = _rays(2000, seed=22)
        tmin = jnp.zeros(2000)
        tmax = jnp.full((2000,), RT_MAX)
        a = intersect_wbvh(org, d, wb, tris, tmin, tmax)
        b = intersect_bruteforce(org, d, tris, tmin, tmax)
        _assert_same_hits(a.prim, a.t, b.prim, b.t)
        oa = occluded_wbvh(org, d, wb, tris, jnp.full((2000,), 1e-3), tmax)
        ob = occluded_bruteforce(org, d, tris, jnp.full((2000,), 1e-3), tmax)
        np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))


class TestRefillDriver:
    """Persistent-wavefront refill walk (round 5, NRC_TRAVERSAL_REFILL).

    Measured a net loss on the demo harness (BASELINE.md round-5 refill
    table) and ships opt-in; parity stays pinned so the experimental
    driver cannot rot."""

    def test_matches_bruteforce_with_dead_lanes(self, monkeypatch):
        from nrc_tpu.ops import intersect as I
        from nrc_tpu.ops import intersect_wide as IW

        p0, p1, p2 = _soup(4000, seed=31)
        tris = TriSoA.build(p0, p1, p2)
        wb = jax.tree.map(jnp.asarray, build_wide_bvh(p0, p1, p2))
        n = 1500
        org, d = _rays(n, seed=32)
        tmin = jnp.zeros(n)
        tmax = jnp.full((n,), RT_MAX).at[::5].set(0.0)  # dead lanes
        monkeypatch.setattr(I, "TRAVERSAL_CHUNK", 64)
        monkeypatch.setattr(IW, "_REFILL_GROUPS", 4)
        a = intersect_wbvh(org, d, wb, tris, tmin, tmax)
        monkeypatch.setattr(IW, "_REFILL_GROUPS", 0)
        b = intersect_wbvh(org, d, wb, tris, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(a.prim), np.asarray(b.prim))
        np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), rtol=1e-6)
        monkeypatch.setattr(IW, "_REFILL_GROUPS", 4)
        oa = occluded_wbvh(org, d, wb, tris, jnp.full((n,), 1e-3), tmax)
        monkeypatch.setattr(IW, "_REFILL_GROUPS", 0)
        ob = occluded_wbvh(org, d, wb, tris, jnp.full((n,), 1e-3), tmax)
        np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))
