"""BVH build: host-side binned-SAH builder -> flat device arrays.

Replaces the reference's OptiX acceleration-structure builds
(``Device::createGeometry`` GAS + compaction, ``Device.cpp:1845-1963``;
``createTLAS``, ``Device.cpp:2175-2220``). The build runs in native C
(``native/nrc_native.c::bvh_build_binned_sah``, 16-bin SAH) with a NumPy
median-split fallback; the output is a flat SoA node array consumed by the
traversal kernels in ``ops/intersect.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def build_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, max_leaf: int = 4) -> Dict[str, np.ndarray]:
    """Build a BVH; returns dict of flat arrays:

    - lo/hi [n, 3] node AABBs
    - left/right [n] child indices (-1 for leaves)
    - start/count [n] leaf primitive range into ``order`` (count 0 for inner)
    - order [T] primitive permutation
    """
    num = int(p0.shape[0])
    if num == 0:
        return {
            "lo": np.zeros((1, 3), np.float32),
            "hi": np.zeros((1, 3), np.float32),
            "left": np.full((1,), -1, np.int32),
            "right": np.full((1,), -1, np.int32),
            "start": np.zeros((1,), np.int32),
            "count": np.zeros((1,), np.int32),
            "order": np.zeros((0,), np.int32),
        }

    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        cap = 2 * num
        order = np.zeros(num, np.int32)
        lo = np.zeros((cap, 3), np.float32)
        hi = np.zeros((cap, 3), np.float32)
        left = np.zeros(cap, np.int32)
        right = np.zeros(cap, np.int32)
        start = np.zeros(cap, np.int32)
        count = np.zeros(cap, np.int32)
        a0 = np.ascontiguousarray(p0, np.float32)
        a1 = np.ascontiguousarray(p1, np.float32)
        a2 = np.ascontiguousarray(p2, np.float32)
        n = lib.bvh_build_binned_sah(
            a0.ctypes.data, a1.ctypes.data, a2.ctypes.data, num, max_leaf,
            order.ctypes.data, lo.ctypes.data, hi.ctypes.data,
            left.ctypes.data, right.ctypes.data,
            start.ctypes.data, count.ctypes.data,
        )
        return {
            "lo": lo[:n], "hi": hi[:n],
            "left": left[:n], "right": right[:n],
            "start": start[:n], "count": count[:n],
            "order": order,
        }

    return _build_median_split(p0, p1, p2, max_leaf)


def flatten_skip_links(
    bvh: Dict[str, np.ndarray],
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    leaf_size: int = 4,
) -> Dict[str, np.ndarray]:
    """Re-flatten a (left/right/start/count) BVH into the stackless
    skip-link layout the lockstep traversal consumes.

    Pre-order node numbering makes the "hit" successor of an inner node
    simply ``node + 1``; each node additionally stores the pre-order
    ``miss`` successor (where to resume when its AABB test fails or a leaf
    finishes). Traversal is then a single lockstep pointer walk — no
    per-ray stack arrays (whose [N, depth] scatter updates dominated the
    old vmapped-stack traversal).

    The lockstep walk is gather-latency/bandwidth-bound (serialized row
    fetches per step), so the layout keeps node rows minimal and fetches
    the leaf triangle block in one second row gather (rather than inlining
    the block into every node row, which wastes its bytes on inner-node
    visits):

    - ``node_box`` [octants, n+1, 8]: lo | hi | bitcast(miss) |
      bitcast(leaf_row); 8 per-direction-octant pre-order variants by
      default (leaf_row -1 = inner; row n of each block = that block's
      sentinel: inverted AABB, self-missing). See
      ``flatten_skip_links_rows`` for the ordering contract.
    - ``leaf_pack`` [L, leaf_size*10]: leaf_size x (p0|e1|e2) triangle rows
      followed by leaf_size bitcast prim ids (-1 padding)
    - ``leaf_ids`` [L, leaf_size] i32 (host-side reference)

    Leaves smaller than ``leaf_size`` are padded with degenerate (zero)
    triangles and prim id -1. The binary SAH leaves (max 4) are merged
    post-hoc: a subtree whose total primitive count fits ``leaf_size``
    collapses into one leaf, shortening the walk.
    """
    e1 = (p1 - p0).astype(np.float32)
    e2 = (p2 - p0).astype(np.float32)
    tri_rows = np.concatenate([p0.astype(np.float32), e1, e2], axis=-1)
    return flatten_skip_links_rows(bvh, tri_rows, leaf_size)


def flatten_skip_links_rows(
    bvh: Dict[str, np.ndarray],
    prim_rows: np.ndarray,      # [K, R] per-primitive payload rows
    leaf_size: int = 4,
    octant_orders: bool = True,
) -> Dict[str, np.ndarray]:
    """Primitive-generic skip-link flattening (triangles, curve segments):
    leaf rows pack ``leaf_size`` payload rows + bitcast prim ids.

    With ``octant_orders`` the node table holds EIGHT pre-order variants,
    one per ray-direction octant, each visiting the nearer child first
    along the children's dominant separating axis. A ray starts at
    ``octant * (n+1)`` and walks links that stay inside its block; the
    near-first order tightens the closest-hit tmax cap sooner and prunes
    more of the far subtree — the stackless substitute for ordered
    stack traversal. Leaf rows are shared across octants.
    """
    left, right = bvh["left"], bvh["right"]
    start, count, order = bvh["start"], bvh["count"], bvh["order"]
    lo, hi = bvh["lo"], bvh["hi"]
    n_old = lo.shape[0]
    row_w = prim_rows.shape[1]
    max_built = int(count.max(initial=0))
    assert leaf_size >= max_built, (
        f"leaf_size {leaf_size} < builder leaf capacity {max_built}"
    )

    # post-order: primitive count + collapsed node count per subtree
    from ..native import get_lib

    lib = get_lib()
    left32 = np.ascontiguousarray(left, np.int32)
    right32 = np.ascontiguousarray(right, np.int32)
    count32 = np.ascontiguousarray(count, np.int32)
    if lib is not None:
        prims = np.zeros(n_old, np.int32)
        nsize = np.zeros(n_old, np.int32)
        lib.bvh_collapse_sizes(
            left32.ctypes.data, right32.ctypes.data, count32.ctypes.data,
            np.int32(n_old), np.int32(leaf_size),
            prims.ctypes.data, nsize.ctypes.data,
        )
    else:
        prims = np.zeros(n_old, np.int64)
        nsize = np.zeros(n_old, np.int64)
        st = [(0, False)]
        while st:
            v, done = st.pop()
            if done:
                prims[v] = prims[left[v]] + prims[right[v]]
                nsize[v] = (
                    1 if prims[v] <= leaf_size
                    else 1 + nsize[left[v]] + nsize[right[v]]
                )
            elif left[v] < 0:
                prims[v] = count[v]
                nsize[v] = 1
            else:
                st.append((v, True))
                st.append((left[v], False))
                st.append((right[v], False))

    def collect_prims(node):
        out, st2 = [], [node]
        while st2:
            v = st2.pop()
            if left[v] < 0:
                out.extend(order[start[v]: start[v] + count[v]].tolist())
            else:
                st2.append(right[v])
                st2.append(left[v])
        return out

    n = int(nsize[0])
    centers = (lo + hi) * 0.5

    # precompute per-inner-node ordering inputs, vectorized: the dominant
    # child-separating axis and which child is the lower-centroid one
    is_collapsed_leaf = prims <= leaf_size
    safe_l = np.maximum(left, 0)
    safe_r = np.maximum(right, 0)
    sep = centers[safe_l] - centers[safe_r]
    dom_axis = np.argmax(np.abs(sep), axis=-1)
    left_is_lower = sep[np.arange(n_old), dom_axis] <= 0.0

    # collapsed-leaf ROOTS (a leaf in the emitted tree): subtree fits the
    # leaf and the parent's doesn't. Their packed rows are shared across
    # all octant blocks; leaf_row_map: old node -> row id (-1 = inner).
    parent_fits = np.zeros(n_old, bool)
    inner = left >= 0
    parent_fits[left[inner]] = is_collapsed_leaf[np.nonzero(inner)[0]]
    parent_fits[right[inner]] = is_collapsed_leaf[np.nonzero(inner)[0]]
    leaf_root = is_collapsed_leaf & ~parent_fits
    leaf_nodes = np.nonzero(leaf_root)[0]
    leaf_row_map = np.full(n_old, -1, np.int32)
    leaf_row_map[leaf_nodes] = np.arange(len(leaf_nodes), dtype=np.int32)

    # pack leaf rows: builder leaves vectorized (one fancy-indexed pass —
    # the common case when leaf_size == builder max_leaf); collapsed
    # multi-node subtrees (rare) fall back to the per-node descent
    n_leaves = len(leaf_nodes)
    ids_mat = np.full((n_leaves, leaf_size), -1, np.int32)
    simple = left[leaf_nodes] < 0
    sn = leaf_nodes[simple]
    if len(sn):
        k = np.arange(leaf_size)[None, :]
        idx = start[sn][:, None] + np.minimum(k, count[sn][:, None] - 1)
        gathered = order[idx].astype(np.int32)
        ids_mat[simple] = np.where(k < count[sn][:, None], gathered, -1)
    for row_i in np.nonzero(~simple)[0]:
        prim = collect_prims(int(leaf_nodes[row_i]))
        ids_mat[row_i, : len(prim)] = prim
    rows_mat = np.where(
        (ids_mat >= 0)[:, :, None],
        prim_rows[np.maximum(ids_mat, 0)],
        np.float32(0.0),
    ).astype(np.float32)
    leaf_pack = np.concatenate(
        [rows_mat.reshape(n_leaves, leaf_size * row_w),
         ids_mat.view(np.float32)],
        axis=1,
    ) if n_leaves else np.zeros((1, leaf_size * (row_w + 1)), np.float32)
    leaf_ids = (
        ids_mat if n_leaves else np.full((1, leaf_size), -1, np.int32)
    )

    nsize32 = np.ascontiguousarray(nsize, np.int32)
    is_leaf_u8 = np.ascontiguousarray(is_collapsed_leaf, np.uint8)

    def preorder_walk(first_low: tuple):
        """(perm, miss) for one child-order variant: native C walk, with a
        pure-Python fallback."""
        l_first = np.ascontiguousarray(
            left_is_lower == np.asarray(first_low, bool)[dom_axis], np.uint8
        )
        if lib is not None:
            perm = np.empty(n, np.int32)
            miss = np.empty(n, np.int32)
            got = lib.bvh_flatten_preorder(
                left32.ctypes.data, right32.ctypes.data, nsize32.ctypes.data,
                is_leaf_u8.ctypes.data, l_first.ctypes.data,
                np.int32(n_old),
                perm.ctypes.data, miss.ctypes.data,
            )
            assert got == n, (got, n)
            return perm, miss
        perm = [0] * n
        miss = [0] * n
        left_l, right_l = left.tolist(), right.tolist()
        nsize_l, leaf_l = nsize.tolist(), is_collapsed_leaf.tolist()
        lf = l_first.tolist()
        idx = 0
        stack = [(0, n)]  # (old node, miss target in block-local numbering)
        while stack:
            node, miss_t = stack.pop()
            new = idx
            idx += 1
            perm[new] = node
            miss[new] = miss_t
            if not leaf_l[node]:
                l, r = left_l[node], right_l[node]
                a, b = (l, r) if lf[node] else (r, l)
                # pre-order: first child = new+1; second after its subtree
                stack.append((b, miss_t))
                stack.append((a, new + 1 + nsize_l[a]))
        assert idx == n, (idx, n)
        return np.asarray(perm, np.int32), np.asarray(miss, np.int32)

    def emit_order(first_low: tuple, base: int) -> np.ndarray:
        perm, miss = preorder_walk(first_low)
        block = np.empty((n + 1, 8), np.float32)
        pa = perm.astype(np.int64)
        block[:n, 0:3] = lo[pa]
        block[:n, 3:6] = hi[pa]
        block[:n, 6] = (miss + np.int32(base)).view(np.float32)
        block[:n, 7] = leaf_row_map[pa].view(np.float32)
        # sentinel row: inverted AABB (never hit), self-missing
        block[n, 0:3] = np.float32(3.0e38)
        block[n, 3:6] = np.float32(-3.0e38)
        block[n, 6] = np.int32(base + n).view(np.float32)
        block[n, 7] = np.int32(-1).view(np.float32)
        return block

    # [octants, n+1, 8]: octant count and block size live in the SHAPE so
    # they stay static through jit (scalar dict entries would be traced)
    if octant_orders:
        node_box = np.stack([
            emit_order(
                (bool(o & 1), bool(o >> 1 & 1), bool(o >> 2 & 1)),
                base=o * (n + 1),
            )
            for o in range(8)
        ])
    else:
        node_box = emit_order((True, True, True), base=0)[None]

    return {
        "node_box": node_box,
        "leaf_pack": leaf_pack,
        "leaf_ids": leaf_ids,
    }


def _build_median_split(p0, p1, p2, max_leaf: int) -> Dict[str, np.ndarray]:
    """NumPy fallback: median split on the widest centroid axis."""
    num = p0.shape[0]
    lo_p = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    hi_p = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    cen = (lo_p + hi_p) * 0.5

    order = np.arange(num, dtype=np.int32)
    nodes = {k: [] for k in ("lo", "hi", "left", "right", "start", "count")}

    def emit():
        for k in nodes:
            nodes[k].append(0)
        return len(nodes["lo"]) - 1

    def build(start, end):
        node = emit()
        sel = order[start:end]
        nodes["lo"][node] = lo_p[sel].min(0)
        nodes["hi"][node] = hi_p[sel].max(0)
        n = end - start
        if n <= max_leaf:
            nodes["left"][node] = -1
            nodes["right"][node] = -1
            nodes["start"][node] = start
            nodes["count"][node] = n
            return node
        c = cen[sel]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = start + n // 2
        part = np.argpartition(c[:, axis], n // 2)
        order[start:end] = sel[part]
        nodes["start"][node] = -1
        nodes["count"][node] = 0
        nodes["left"][node] = build(start, mid)
        nodes["right"][node] = build(mid, end)
        return node

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 2 * num + 100))
    try:
        build(0, num)
    finally:
        sys.setrecursionlimit(old)

    return {
        "lo": np.asarray(nodes["lo"], np.float32),
        "hi": np.asarray(nodes["hi"], np.float32),
        "left": np.asarray(nodes["left"], np.int32),
        "right": np.asarray(nodes["right"], np.int32),
        "start": np.asarray(nodes["start"], np.int32),
        "count": np.asarray(nodes["count"], np.int32),
        "order": order,
    }
