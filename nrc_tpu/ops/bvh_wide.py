"""8-wide BVH build: collapse the binary SAH tree into branch-8 nodes
whose rows carry ALL EIGHT children's AABBs + child pointers.

Why wide: the lockstep traversal's cost is gathered node ROWS (on the
accelerator this was designed on, nearly independent of row width), so a node row that answers "which of 8 subtrees does this ray
enter?" in ONE gather replaces ~7 binary-node gathers of the skip-link
walk. This is the analog of the RT-core/CWBVH wide-node idea behind
``optixTrace`` (reference: ``Device.cpp:1845-2253`` builds the OptiX GAS;
the traversal hardware is opaque — we replace it, not translate it).

Output arrays (consumed by ``ops/intersect_wide.py``):

- ``rows`` [W + L, P] f32: ONE unified table of node rows followed by leaf
  rows, so the walk issues exactly ONE row gather per step whatever a lane
  is doing (descend or leaf test) — gathers are per-row latency-bound and
  an older layout paid two of them (separate ``wnode`` + ``leaf_pack``
  fetches) per step.

  - node row (indices 0..W-1): COMPONENT-major child boxes — lox*8 |
    loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8 — followed by 8 bitcast-i32
    child metas, zero-padded to P. Component-major keeps every slab-test
    op a full-width [N, 8] elementwise with no minor-dim-3 axis (a packed
    per-child (lo3|hi3) layout relayout-shuffles each min/max; same
    lesson as intersect._mt_hits). meta >= 0 -> inner child (wide node
    index); meta < 0 -> leaf child (row = W + ~meta); meta == NONE ->
    empty slot. Slot order is build order: the walk sorts children by
    actual slab entry distance at visit time (a 19-comparator network on
    [N, 8] columns), which replaced an 8x octant-replicated
    pre-sorted variants — true per-ray ordering prunes more, and the node
    table shrinks 8x.
  - leaf row (indices W..W+L-1): component-major primitive columns
    (p0x*ls | p0y*ls | ... | e2z*ls) + ls bitcast prim ids (-1 padding),
    zero-padded to P.

  P = max(56, (row_w + 1) * leaf_size); both row kinds parse their own
  prefix of the gathered [N, P] row.
- ``wsplit`` [1, W] i32 (shape-carried static): node-row count W — the
  leaf-row base offset in ``rows``.
- ``depth`` [1, D] i32 (shape-carried static): max wide-tree depth, the
  traversal's stack bound.
- ``leaf_row_w`` [1, row_w] i32 (shape-carried static): per-primitive
  payload width (9 for both triangles p0|e1|e2 and curve pa|ba|ra,rb,m0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .bvh import build_bvh

BRANCH = 8
NONE = np.int32(-2147483648)  # empty-slot meta (INT32_MIN; ~leaf never is)


def collapse_wide(
    left: np.ndarray,
    right: np.ndarray,
    start: np.ndarray,
    count: np.ndarray,
    order: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    leaf_size: int,
    branch: int = BRANCH,
):
    """Binary (left/right/start/count) tree -> wide-node lists.

    A binary subtree whose total primitive count fits ``leaf_size``
    becomes one leaf child; otherwise the child set of a wide node is
    grown by repeatedly expanding the child subtree with the largest
    surface area until ``branch`` slots are used (the standard greedy
    binary->wide collapse).

    Returns (wide_children, wide_boxes, leaves) where wide_children[i] is
    a list of ('inner', wide_idx) / ('leaf', leaf_idx) slots, wide_boxes[i]
    the matching [len, 6] child AABBs, and leaves a list of prim-id lists.
    """
    n = lo.shape[0]
    # subtree primitive counts (iterative post-order)
    prims = np.zeros(n, np.int64)
    stack = [(0, False)]
    while stack:
        v, done = stack.pop()
        if done:
            prims[v] = prims[left[v]] + prims[right[v]]
        elif left[v] < 0:
            prims[v] = count[v]
        else:
            stack.append((v, True))
            stack.append((left[v], False))
            stack.append((right[v], False))

    area = np.prod(np.maximum(hi - lo, 0.0), axis=-1)  # proxy: volume
    ext = np.maximum(hi - lo, 0.0)
    area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                  + ext[:, 2] * ext[:, 0])

    def collect(v):
        out, st = [], [v]
        while st:
            u = st.pop()
            if left[u] < 0:
                out.extend(order[start[u]: start[u] + count[u]].tolist())
            else:
                st.append(right[u])
                st.append(left[u])
        return out

    wide_children = []  # per wide node: list of ('inner'|'leaf', idx)
    wide_boxes = []     # per wide node: list of (lo3, hi3)
    leaves = []         # leaf idx -> prim id list
    depth_of = []       # per wide node

    def make_leaf(v):
        leaves.append(collect(v))
        return len(leaves) - 1

    # BFS so children wide-ids can be patched after allocation
    root_fits = prims[0] <= leaf_size
    if root_fits or left[0] < 0:
        # degenerate: single wide node with one leaf child
        wide_children.append([("leaf", make_leaf(0))])
        wide_boxes.append([(lo[0], hi[0])])
        depth_of.append(0)
    else:
        todo = [(0, 0)]  # (binary node, wide parent depth)
        wide_of = {}     # binary node -> wide idx
        wide_children.append(None)
        wide_boxes.append(None)
        depth_of.append(0)
        wide_of[0] = 0
        while todo:
            v, d = todo.pop()
            wi = wide_of[v]
            depth_of[wi] = d
            # grow child set: expand the largest-area inner, non-leaf-fitting
            # child until `branch` slots
            slots = [left[v], right[v]]
            while len(slots) < branch:
                best, best_a = -1, -1.0
                for i, u in enumerate(slots):
                    if left[u] >= 0 and prims[u] > leaf_size and area[u] > best_a:
                        best, best_a = i, area[u]
                if best < 0:
                    break
                u = slots.pop(best)
                slots.extend([left[u], right[u]])
            ch, bx = [], []
            for u in slots:
                if left[u] < 0 or prims[u] <= leaf_size:
                    ch.append(("leaf", make_leaf(u)))
                else:
                    wide_children.append(None)
                    wide_boxes.append(None)
                    depth_of.append(0)
                    wide_of[u] = len(wide_children) - 1
                    ch.append(("inner", wide_of[u]))
                    todo.append((u, d + 1))
                bx.append((lo[u], hi[u]))
            wide_children[wi] = ch
            wide_boxes[wi] = bx

    return wide_children, wide_boxes, leaves, max(depth_of) + 1



def collapse_wide_arrays(
    bvh: Dict[str, np.ndarray], leaf_size: int, branch: int = BRANCH
):
    """Collapse to flat arrays: (metas [W,B] i32, los/his [W,B,3] f32,
    ids_mat [L,leaf_size] i32, depth_levels). Native C fast path
    (``nrc_native.c::bvh_collapse_wide``; the Python walk took ~45 s on the
    486k-tri scene) with the pure-Python fallback below it."""
    left = np.ascontiguousarray(bvh["left"], np.int32)
    right = np.ascontiguousarray(bvh["right"], np.int32)
    start = np.ascontiguousarray(bvh["start"], np.int32)
    count = np.ascontiguousarray(bvh["count"], np.int32)
    order = np.ascontiguousarray(bvh["order"], np.int32)
    lo = np.ascontiguousarray(bvh["lo"], np.float32)
    hi = np.ascontiguousarray(bvh["hi"], np.float32)
    n_old = left.shape[0]

    from ..native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "bvh_collapse_wide"):
        meta = np.empty((n_old, branch), np.int32)
        box = np.empty((n_old, branch, 6), np.float32)
        ids = np.empty((n_old, max(leaf_size, 1)), np.int32)
        cnt = np.zeros(3, np.int32)
        got = lib.bvh_collapse_wide(
            left.ctypes.data, right.ctypes.data,
            start.ctypes.data, count.ctypes.data, order.ctypes.data,
            lo.ctypes.data, hi.ctypes.data,
            np.int32(n_old), np.int32(leaf_size), np.int32(branch),
            meta.ctypes.data, box.ctypes.data, ids.ctypes.data,
            cnt.ctypes.data,
        )
        if got > 0:
            W, L, depth = int(cnt[0]), int(cnt[1]), int(cnt[2])
            return (
                meta[:W].copy(),
                box[:W, :, 0:3].copy(),
                box[:W, :, 3:6].copy(),
                ids[:max(L, 1)].copy(),
                depth,
            )

    wide_children, wide_boxes, leaves, depth = collapse_wide(
        left, right, start, count, order, lo, hi, leaf_size, branch
    )
    W = len(wide_children)
    metas = np.full((W, branch), NONE, np.int32)
    los = np.full((W, branch, 3), 3.0e38, np.float32)
    his = np.full((W, branch, 3), -3.0e38, np.float32)
    for wi, (ch, bx) in enumerate(zip(wide_children, wide_boxes)):
        for si, ((kind, idx), (blo, bhi)) in enumerate(zip(ch, bx)):
            metas[wi, si] = idx if kind == "inner" else ~np.int32(idx)
            los[wi, si] = blo
            his[wi, si] = bhi
    L = max(len(leaves), 1)
    ids_mat = np.full((L, leaf_size), -1, np.int32)
    for i, prim in enumerate(leaves):
        assert len(prim) <= leaf_size, (len(prim), leaf_size)
        ids_mat[i, : len(prim)] = prim
    return metas, los, his, ids_mat, depth


def build_wide_bvh(
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    leaf_size: int = 8,
    branch: int = BRANCH,
    max_leaf: int = 4,
) -> Dict[str, np.ndarray]:
    """Triangles -> 8-wide flat BVH arrays (see module docstring)."""
    b = build_bvh(p0, p1, p2, max_leaf=max_leaf)
    return flatten_wide_rows(
        b,
        np.concatenate(
            [p0.astype(np.float32),
             (p1 - p0).astype(np.float32),
             (p2 - p0).astype(np.float32)],
            axis=-1,
        ),
        leaf_size=leaf_size,
        branch=branch,
    )


def flatten_wide_rows(
    bvh: Dict[str, np.ndarray],
    prim_rows: np.ndarray,   # [T, R] per-primitive payload
    leaf_size: int = 8,
    branch: int = BRANCH,
) -> Dict[str, np.ndarray]:
    """Generic (triangles/curve segments) wide flattening."""
    metas, los, his, ids_mat, depth = collapse_wide_arrays(
        bvh, leaf_size, branch
    )
    W = metas.shape[0]
    L = ids_mat.shape[0]
    row_w = prim_rows.shape[1]

    # ---- leaf rows: COMPONENT-major -------------------------------------
    # [L, row_w*ls + ls]: component k of all ls primitives contiguous
    # (p0x of tris 0..ls-1, then p0y, ... then ids). The traversal's leaf
    # math then runs on [N, ls] slices with no minor-dim-3 axis — packed
    # per-triangle (p0|e1|e2) rows forced cross products on a 3-wide minor
    # axis (same lesson as intersect._mt_hits).
    rows_mat = np.where(
        (ids_mat >= 0)[:, :, None],
        prim_rows[np.maximum(ids_mat, 0)],
        np.float32(0.0),
    ).astype(np.float32)                                   # [L, ls, row_w]
    comp_major = np.ascontiguousarray(
        rows_mat.transpose(0, 2, 1)
    ).reshape(L, row_w * leaf_size)
    leaf_pack = np.concatenate(
        [comp_major, ids_mat.view(np.float32)], axis=1
    )

    # ---- node rows: ONE variant, build slot order ------------------------
    # the walk orders children by actual slab entry distance at visit time
    # (see module docstring), so no octant pre-sorting and no 8x
    # replication. Empty slots carry meta NONE — the traversal masks them
    # by meta, NOT by their inverted AABB: (3e38 - o) * inv_d overflows to
    # ±inf on BOTH slabs for near-axis directions, turning the inverted
    # box into an always-hit.
    valid = metas != NONE
    node_rows = np.concatenate(
        [
            np.ascontiguousarray(los.transpose(0, 2, 1)).reshape(W, -1),
            np.ascontiguousarray(his.transpose(0, 2, 1)).reshape(W, -1),
            metas.view(np.float32),
        ],
        axis=1,
    )                                                      # [W, 7*branch]

    # ---- unified table: node rows then leaf rows, padded to P ------------
    P = max(7 * branch, leaf_pack.shape[1])
    rows = np.zeros((W + L, P), np.float32)
    rows[:W, : 7 * branch] = node_rows
    rows[W:, : leaf_pack.shape[1]] = leaf_pack

    root = np.stack(
        [np.min(np.where(valid[0][:, None], los[0], np.inf), axis=0),
         np.max(np.where(valid[0][:, None], his[0], -np.inf), axis=0)]
    ).astype(np.float32)

    return {
        "rows": rows,                                    # [W + L, P] f32
        "branch": np.zeros((1, branch), np.int32),       # static via shape
        "wsplit": np.zeros((1, W), np.int32),            # static via shape
        "leaf_ids": ids_mat,
        "root": root,                                    # [2, 3] exact AABB
        "depth": np.zeros((1, depth + 1), np.int32),     # static via shape
        # (+1 safety slot over the exact max level count)
        # per-primitive payload width, shape-encoded like depth: consumers
        # derive leaf_size = leaf_ids.shape[1] instead of hardcoding the
        # 9-float triangle row layout
        "leaf_row_w": np.zeros((1, row_w), np.int32),
    }


def split_rows_u16(rows: np.ndarray) -> Dict[str, np.ndarray]:
    """f32 row table -> two uint16 HALF tables (hi/lo bits of every value).

    On the accelerator this was written for, a row gather's cost tracked
    the PHYSICAL row size after padding, so 16-bit rows gathered faster
    than f32 rows; not yet measured on the GPU. Storing the unified
    node+leaf table as two u16 half tables makes the walk pay two fast gathers + a full-width
    reconstruct (cast/shift/or/bitcast) instead of one slow gather, with
    BIT-EXACT f32 rows — geometry precision and the i32 meta/pid columns
    are untouched."""
    assert rows.dtype == np.float32 and rows.shape[1] <= 128
    u16 = rows.view(np.uint16).reshape(rows.shape[0], rows.shape[1], 2)
    # little-endian: [..., 0] = low half, [..., 1] = high half
    return {
        "rows_lo": np.ascontiguousarray(u16[..., 0]),
        "rows_hi": np.ascontiguousarray(u16[..., 1]),
    }
