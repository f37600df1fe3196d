"""Ray / rounded-cone intersection for hair & curve primitives.

Replacement for OptiX's built-in cubic-B-spline curve
intersector (reference ``Device.cpp:857-863`` builtin IS module +
``__closesthit__curves``, ``hit.cu:1665-2046``). Strands are tessellated on
the host into *rounded cones* — linear segments swept with linearly varying
radius (``scene/hair.py``) — which admit a closed-form quadratic
intersection that vectorizes cleanly onto elementwise: no per-thread spline
root-finding, no divergence.

The analytic round-cone test follows the standard quadratic formulation
(lateral surface + two sphere caps). Traversal mirrors the triangle BVH in
``ops/intersect.py`` (binned-SAH nodes from the native builder over segment
AABBs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DENOM = 1e-20
RT_MAX = np.float32(3.0e38)


class CurveHit(NamedTuple):
    t: jnp.ndarray      # [N]
    prim: jnp.ndarray   # [N] segment id (-1 = miss)

    @property
    def valid(self) -> jnp.ndarray:
        return self.prim >= 0


def segment_aabb_corners(pa, pb, ra, rb):
    """Conservative per-segment AABB corner points for the BVH builder
    (fed as degenerate 'triangles' to ``bvh_build_binned_sah``)."""
    lo = np.minimum(pa - ra[:, None], pb - rb[:, None]).astype(np.float32)
    hi = np.maximum(pa + ra[:, None], pb + rb[:, None]).astype(np.float32)
    return lo, hi, lo.copy()


def _roundcone_t(o, d, pa, ba, ra, rb, m0, tmin, tmax):
    """Scalar round-cone intersection: smallest valid t, or RT_MAX.

    Lateral cone surface via the quadratic in (k2, k1, k0); sphere caps at
    both endpoints. ``d`` must be normalized. Shape-polymorphic: scalar/vec3
    or [N]/[N, 3] batches (the lockstep traversal's leaf tests).
    """
    oa = o - pa
    ob = oa - ba
    rr = ra - rb
    m1 = jnp.sum(ba * oa, axis=-1)
    m2 = jnp.sum(ba * d, axis=-1)
    m3 = jnp.sum(d * oa, axis=-1)
    m5 = jnp.sum(oa * oa, axis=-1)
    m6 = jnp.sum(ob * d, axis=-1)
    m7 = jnp.sum(ob * ob, axis=-1)

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra

    h = k1 * k1 - k0 * k2
    safe_k2 = jnp.where(jnp.abs(k2) > DENOM, k2, 1.0)
    t_body = (-jnp.sqrt(jnp.maximum(h, 0.0)) - k1) / safe_k2
    y = m1 - ra * rr + t_body * m2
    body_ok = (
        (h >= 0.0) & (jnp.abs(k2) > DENOM)
        & (y > 0.0) & (y < d2)
        & (t_body > tmin) & (t_body < tmax)
    )
    t_body = jnp.where(body_ok, t_body, RT_MAX)

    # sphere caps
    h1 = m3 * m3 - m5 + ra * ra
    t_ca = -m3 - jnp.sqrt(jnp.maximum(h1, 0.0))
    ca_ok = (h1 >= 0.0) & (t_ca > tmin) & (t_ca < tmax)
    t_ca = jnp.where(ca_ok, t_ca, RT_MAX)

    h2 = m6 * m6 - m7 + rb * rb
    t_cb = -m6 - jnp.sqrt(jnp.maximum(h2, 0.0))
    cb_ok = (h2 >= 0.0) & (t_cb > tmin) & (t_cb < tmax)
    t_cb = jnp.where(cb_ok, t_cb, RT_MAX)

    return jnp.minimum(t_body, jnp.minimum(t_ca, t_cb))


class CurveSoA(NamedTuple):
    """Device-resident segment arrays (+ precomputed ba, m0)."""

    pa: jnp.ndarray         # [K, 3]
    ba: jnp.ndarray         # [K, 3] pb - pa
    ra: jnp.ndarray         # [K]
    rb: jnp.ndarray         # [K]
    m0: jnp.ndarray         # [K] dot(ba, ba)
    u_a: jnp.ndarray        # [K]
    u_b: jnp.ndarray        # [K]
    reference: jnp.ndarray  # [K, 3]
    color_a: jnp.ndarray    # [K, 3]
    color_b: jnp.ndarray    # [K, 3]
    material_id: jnp.ndarray  # [K] i32

    @property
    def num(self) -> int:
        return int(self.pa.shape[0])

    @staticmethod
    def build(seg) -> "CurveSoA":
        """From a host ``scene.hair.CurveSegments``. Stays numpy — the
        scene-upload boundary ships the whole DeviceScene as a few packed
        transfers (``utils.device_pack``)."""
        f = lambda x: np.ascontiguousarray(np.asarray(x, np.float32))
        ba = (seg.pb - seg.pa).astype(np.float32)
        return CurveSoA(
            pa=f(seg.pa),
            ba=f(ba),
            ra=f(seg.ra),
            rb=f(seg.rb),
            m0=f(np.sum(ba * ba, axis=-1)),
            u_a=f(seg.u_a),
            u_b=f(seg.u_b),
            reference=f(seg.reference),
            color_a=f(seg.color_a),
            color_b=f(seg.color_b),
            material_id=np.ascontiguousarray(
                np.asarray(seg.material_id, np.int32)
            ),
        )


def build_curve_bvh(seg, max_leaf: int = 4):
    """Skip-link BVH over segment AABBs: binned-SAH build via the native
    builder, then the same pre-order miss-link flattening as triangles,
    with 9-float payload rows pa | ba | (ra, rb, m0) per segment."""
    from .bvh import build_bvh, flatten_skip_links_rows

    lo, hi, lo2 = segment_aabb_corners(seg.pa, seg.pb, seg.ra, seg.rb)
    b = build_bvh(lo, hi, lo2, max_leaf=max_leaf)
    ba = (seg.pb - seg.pa).astype(np.float32)
    rows = np.concatenate(
        [
            seg.pa.astype(np.float32),
            ba,
            seg.ra.astype(np.float32)[:, None],
            seg.rb.astype(np.float32)[:, None],
            np.sum(ba * ba, axis=-1, dtype=np.float32)[:, None],
        ],
        axis=-1,
    )
    return flatten_skip_links_rows(b, rows, leaf_size=max_leaf)


def build_wide_curve_bvh(seg, leaf_size: int = 8, max_leaf: int = 4):
    """8-wide BVH over segment AABBs (the production traversal for large
    strand counts — same collapse + component-major row layout as
    triangles, ``ops/bvh_wide.py``); payload rows pa | ba | (ra, rb, m0)
    consumed by ``intersect_wide._leaf_cone_t``."""
    from .bvh import build_bvh
    from .bvh_wide import flatten_wide_rows

    lo, hi, lo2 = segment_aabb_corners(seg.pa, seg.pb, seg.ra, seg.rb)
    b = build_bvh(lo, hi, lo2, max_leaf=max_leaf)
    ba = (seg.pb - seg.pa).astype(np.float32)
    rows = np.concatenate(
        [
            seg.pa.astype(np.float32),
            ba,
            seg.ra.astype(np.float32)[:, None],
            seg.rb.astype(np.float32)[:, None],
            np.sum(ba * ba, axis=-1, dtype=np.float32)[:, None],
        ],
        axis=-1,
    )
    return flatten_wide_rows(b, rows, leaf_size=leaf_size)


def _skip_traverse_curves(org, direction, bvh, tmin, tmax, any_hit: bool):
    """Two-phase lockstep skip-link walk (see
    ops/intersect.py::_skip_traverse); the outer leaf batch runs the
    vectorized round-cone test."""
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
    leaf_size = bvh["leaf_pack"].shape[1] // 10  # 9 payload floats + id
    inv_d = jnp.where(
        jnp.abs(direction) > 1e-20,
        1.0 / jnp.where(direction != 0.0, direction, 1.0),
        np.float32(3.0e38),
    )

    def step_cond(s):
        node, lrow, _, _ = s
        return jnp.any((node != sentinel) | (lrow >= 0))

    def step(s):
        node, lrow, best_t, best_prim = s

        # ---- leaf service: lanes parked last step test their K round
        # cones now and advance to the miss link. ONE flat loop — the
        # nested two-phase descend/leaf structure paid a loop re-entry per
        # leaf round (see ops/intersect_wide.py).
        do_leaf = lrow >= 0
        seg = bvh["leaf_pack"][jnp.maximum(lrow, 0)]    # [N, K*10]
        for k in range(leaf_size):
            pa = seg[:, 9 * k: 9 * k + 3]
            ba = seg[:, 9 * k + 3: 9 * k + 6]
            ra = seg[:, 9 * k + 6]
            rb = seg[:, 9 * k + 7]
            m0 = seg[:, 9 * k + 8]
            pid = seg[:, 9 * leaf_size + k].view(jnp.int32)
            t = _roundcone_t(
                org, direction, pa, ba, ra, rb, m0,
                tmin, jnp.minimum(best_t, tmax),
            )
            ok = do_leaf & (pid >= 0) & (t < jnp.minimum(best_t, tmax))
            best_t = jnp.where(ok, t, best_t)
            best_prim = jnp.where(ok, pid, best_prim)
        row = nodes_flat[node]                          # [N, 8]
        miss = row[:, 6].view(jnp.int32)
        node = jnp.where(do_leaf, miss, node)
        if any_hit:
            node = jnp.where(best_prim >= 0, sentinel, node)
        lrow = jnp.full((n,), -1, jnp.int32)

        # ---- descend service ------------------------------------------
        active = node != sentinel
        row = nodes_flat[node]
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
        park = active & hit_box & is_leaf
        lrow = jnp.where(park, lr, lrow)
        nxt = jnp.where(hit_box & ~is_leaf, node + 1, miss)
        nxt = jnp.where(park, node, nxt)  # leaf serviced next step
        node = jnp.where(active, nxt, node)
        return node, lrow, best_t, best_prim

    node0 = jnp.where(tmax <= tmin, sentinel, base)
    _, _, t, prim = jax.lax.while_loop(
        step_cond, step,
        (node0, jnp.full((n,), -1, jnp.int32),
         jnp.full((n,), RT_MAX), jnp.full((n,), -1, jnp.int32)),
    )
    return t, prim


def _chunked_traverse_curves(org, direction, bvh, tmin, tmax, any_hit: bool):
    """Coherence-sorted chunked wrapper (shared skeleton in
    ops/intersect.py::chunked_over_rays): each chunk's lockstep walk exits
    when its own slowest ray finishes."""
    from .intersect import chunked_over_rays

    return chunked_over_rays(
        lambda o, d, tn, tx: _skip_traverse_curves(o, d, bvh, tn, tx, any_hit),
        org, direction, bvh, tmin, tmax,
    )


def intersect_curves_bvh(org, direction, bvh, curves: CurveSoA, tmin, tmax) -> CurveHit:
    if "rows" in bvh or "rows_hi" in bvh:  # 8-wide production walk (large strand counts)
        from .intersect_wide import intersect_curves_wbvh

        t, prim = intersect_curves_wbvh(org, direction, bvh, tmin, tmax)
        return CurveHit(t=t, prim=prim)
    t, prim = _chunked_traverse_curves(org, direction, bvh, tmin, tmax, any_hit=False)
    return CurveHit(t=t, prim=prim)


def occluded_curves_bvh(org, direction, bvh, curves: CurveSoA, tmin, tmax) -> jnp.ndarray:
    if "rows" in bvh or "rows_hi" in bvh:
        from .intersect_wide import occluded_curves_wbvh

        return occluded_curves_wbvh(org, direction, bvh, tmin, tmax)
    _, prim = _chunked_traverse_curves(org, direction, bvh, tmin, tmax, any_hit=True)
    return prim >= 0


def intersect_curves_bruteforce(
    org, direction, curves: CurveSoA, tmin, tmax, chunk: int = 512
) -> CurveHit:
    """All-pairs [N, K] test for small segment counts (tests/oracles)."""

    def one(o, d, tn, tf):
        ts = jax.vmap(
            lambda pa, ba, ra, rb, m0: _roundcone_t(o, d, pa, ba, ra, rb, m0, tn, tf)
        )(curves.pa, curves.ba, curves.ra, curves.rb, curves.m0)
        best = jnp.argmin(ts)
        t = ts[best]
        return t, jnp.where(t < RT_MAX, best.astype(jnp.int32), np.int32(-1))

    t, prim = jax.vmap(one)(org, direction, tmin, tmax)
    return CurveHit(t=t, prim=prim)


class CurveFrame(NamedTuple):
    normal: jnp.ndarray    # [N, 3] rounded-cone surface normal
    tangent: jnp.ndarray   # [N, 3] fiber tangent (longitudinal axis)
    b1: jnp.ndarray        # [N, 3] azimuthal frame (from the strand reference)
    b2: jnp.ndarray        # [N, 3]
    u_fiber: jnp.ndarray   # [N]
    v_fiber: jnp.ndarray   # [N]
    color: jnp.ndarray     # [N, 3] interpolated strand color


def curve_shading_frame(curves: CurveSoA, prim, x) -> CurveFrame:
    """Shading attributes at hit point ``x`` on segment ``prim``: the
    rounded-cone surface normal, the fiber tangent, a per-strand-stable
    azimuthal frame, the texture coordinates the reference exposes as
    uFiber/vFiber (``hit.cu:1769-1816``), and the interpolated strand color.
    """
    p = jnp.maximum(prim, 0)
    pa = curves.pa[p]
    ba = curves.ba[p]
    m0 = jnp.maximum(curves.m0[p], DENOM)
    ra = curves.ra[p]
    rb = curves.rb[p]

    y = jnp.sum((x - pa) * ba, axis=-1)
    rr = ra - rb
    d2 = m0 - rr * rr
    on_body = (y > 0.0) & (y < d2)
    # body normal: d2*(x - pa) - ba*y ; cap normals: from the cap centers
    n_body = d2[..., None] * (x - pa) - ba * y[..., None]
    cap_a = y <= 0.0
    n_cap = jnp.where(
        cap_a[..., None], x - pa, x - (pa + ba)
    )
    n = jnp.where(on_body[..., None], n_body, n_cap)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), DENOM)

    tangent = ba / jnp.maximum(jnp.sqrt(m0)[..., None], DENOM)

    s = jnp.clip(y / m0, 0.0, 1.0)
    u_fiber = curves.u_a[p] + s * (curves.u_b[p] - curves.u_a[p])
    color = (
        curves.color_a[p]
        + s[..., None] * (curves.color_b[p] - curves.color_a[p])
    )

    # vFiber: azimuth of the surface normal around the fiber, measured
    # against the per-strand reference bitangent (Curves.cpp:186-234;
    # hit.cu fiber state). Range [0, 1).
    ref = curves.reference[p]
    b1 = ref - tangent * jnp.sum(ref * tangent, axis=-1, keepdims=True)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1, axis=-1, keepdims=True), DENOM)
    b2 = jnp.cross(tangent, b1)
    ang = jnp.arctan2(jnp.sum(n * b2, axis=-1), jnp.sum(n * b1, axis=-1))
    v_fiber = (ang / (2.0 * jnp.pi)) % 1.0

    return CurveFrame(n, tangent, b1, b2, u_fiber, v_fiber, color)
