"""Lockstep 8-wide BVH traversal (replacement for ``optixTrace``).

EXACTLY one row gather per lane per step, from the unified node+leaf table
(``bvh_wide`` ``rows``): a lane's ``pending`` address names either a wide
node (slab-test all 8 children in one [N, 8] pass) or a leaf row
(primitive-test leaf_size prims as [N, ls] vector math). An older
layout paid TWO gathers per step (a node fetch inside visit() plus an
unconditional leaf_pack fetch); gathers are per-row latency-bound, so
unifying the tables halves the walk's dominant cost.

Children are sorted by actual slab entry distance at visit time
(``sort8_by_key``, a 19-comparator Batcher network of full-width selects)
— true per-ray ordered descent, which finds close hits sooner, shrinks
``best_t``, and culls more subtrees than an octant-presorted
static order (and removes the 8x octant replication of the node table).

There are no per-lane scatter stacks (which made an earlier
vmapped-stack walk far slower): the traversal stack is a dense
[N, D, 8] i32 array updated with one-hot selects over the static depth
axis D (shape-carried from the build), which is plain elementwise math. Per-lane
state:

- ``children`` [N, 8] i32: remaining child metas of the current node
  (NONE = visited/missed/empty), entry-distance sorted. meta >= 0 ->
  inner wide node; meta < 0 -> leaf row W + ~meta in the unified table.
- ``stack`` [N, D, 8] + ``depth`` [N]: saved sibling sets.
- ONE flat while loop (a nested two-phase descend/leaf structure paid a
  loop re-entry and fusion boundary per leaf round, which dominated the
  walk on an earlier accelerator).

Same coherence-sorted 2048-lane chunking as the binary path
(``chunked_over_rays``): each chunk's while_loop exits at ITS slowest ray.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import RT_MAX, Hit, TriSoA, chunked_over_rays
from .bvh_wide import NONE  # empty child slot (INT32_MIN; ~meta never is)

# Profiling knob: skip the leaf triangle tests (results become wrong) to
# isolate descend-phase cost from leaf-phase cost on real scenes.
import os as _os

_SKIP_LEAF = _os.environ.get("NRC_WIDE_SKIP_LEAF", "0") == "1"


def _leaf_tri_t(c, pid, org, direction, tmin, cap):
    """Component-major Moller-Trumbore over a leaf's triangle columns.

    ``c``: 9 [N, ls] planes (p0x..p0z | e1x..e1z | e2x..e2z). Returns
    t_ok [N, ls] with RT_MAX at invalid/missed slots. All math is
    full-width [N, ls] elementwise (no minor-dim-3 axis)."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    dx = direction[:, 0:1]
    dy = direction[:, 1:2]
    dz = direction[:, 2:3]
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz          # [N, ls]
    ok = jnp.abs(det) > 1e-12
    invd = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvx = org[:, 0:1] - p0x
    tvy = org[:, 1:2] - p0y
    tvz = org[:, 2:3] - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * invd
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invd
    ok = (
        ok & (pid >= 0)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[:, None]) & (t < cap[:, None])
    )
    return jnp.where(ok, t, RT_MAX)


def _leaf_cone_t(c, pid, org, direction, tmin, cap):
    """Component-major round-cone test over a leaf's curve-segment columns.

    ``c``: 9 [N, ls] planes (pax..paz | bax..baz | ra | rb | m0) — the
    curve payload rows of ``curve_intersect.build_wide_curve_bvh``. Same
    quadratic + sphere-cap formulation as ``curve_intersect._roundcone_t``
    but laid out as full-width [N, ls] elementwise math (the triangle-leaf
    playbook applied to hair). ``direction`` must be
    normalized (same contract as the binary curve walk)."""
    pax, pay, paz, bax, bay, baz, ra, rb, m0 = c
    dx = direction[:, 0:1]
    dy = direction[:, 1:2]
    dz = direction[:, 2:3]
    oax = org[:, 0:1] - pax
    oay = org[:, 1:2] - pay
    oaz = org[:, 2:3] - paz
    obx = oax - bax
    oby = oay - bay
    obz = oaz - baz
    rr = ra - rb
    m1 = bax * oax + bay * oay + baz * oaz
    m2 = bax * dx + bay * dy + baz * dz
    m3 = dx * oax + dy * oay + dz * oaz
    m5 = oax * oax + oay * oay + oaz * oaz
    m6 = obx * dx + oby * dy + obz * dz
    m7 = obx * obx + oby * oby + obz * obz

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    ok2 = jnp.abs(k2) > 1e-20
    safe_k2 = jnp.where(ok2, k2, 1.0)
    t_body = (-jnp.sqrt(jnp.maximum(h, 0.0)) - k1) / safe_k2
    y = m1 - ra * rr + t_body * m2
    tn = tmin[:, None]
    tx = cap[:, None]
    body_ok = (
        (h >= 0.0) & ok2 & (y > 0.0) & (y < d2)
        & (t_body > tn) & (t_body < tx)
    )
    t_body = jnp.where(body_ok, t_body, RT_MAX)

    h1 = m3 * m3 - m5 + ra * ra
    t_ca = -m3 - jnp.sqrt(jnp.maximum(h1, 0.0))
    t_ca = jnp.where((h1 >= 0.0) & (t_ca > tn) & (t_ca < tx), t_ca, RT_MAX)
    h2 = m6 * m6 - m7 + rb * rb
    t_cb = -m6 - jnp.sqrt(jnp.maximum(h2, 0.0))
    t_cb = jnp.where((h2 >= 0.0) & (t_cb > tn) & (t_cb < tx), t_cb, RT_MAX)

    t = jnp.minimum(t_body, jnp.minimum(t_ca, t_cb))
    return jnp.where(pid >= 0, t, RT_MAX)


def _batcher_network(n: int):
    """Batcher odd-even mergesort comparator pairs for power-of-2 n
    (n=8 -> the classic 19-comparator network, n=16 -> 63)."""
    pairs = []

    def merge(lo, m, r):
        step = r * 2
        if step < m:
            merge(lo, m, step)
            merge(lo + r, m, step)
            for i in range(lo + r, lo + m - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, m):
        if m > 1:
            k = m // 2
            sort(lo, k)
            sort(lo + k, k)
            merge(lo, m, 1)

    sort(0, n)
    return tuple(pairs)


_SORT_NETS = {8: _batcher_network(8), 16: _batcher_network(16)}


def sort8_by_key(key, val):
    """Sort the B [N]-columns of ``val`` by ascending ``key`` ([N, B]
    each, B a power of 2) with a Batcher network (19 comparators at B=8)
    — pure full-width selects, no per-lane gathers. Masked entries
    must arrive with key=+inf and val already set to the caller's
    sentinel (they sort to the back)."""
    b = key.shape[1]
    net = _SORT_NETS.get(b) or _SORT_NETS.setdefault(b, _batcher_network(b))
    keys = [key[:, i] for i in range(b)]
    vals = [val[:, i] for i in range(b)]
    for i, j in net:
        ki, kj = keys[i], keys[j]
        vi, vj = vals[i], vals[j]
        swap = kj < ki
        keys[i] = jnp.where(swap, kj, ki)
        keys[j] = jnp.where(swap, ki, kj)
        vals[i] = jnp.where(swap, vj, vi)
        vals[j] = jnp.where(swap, vi, vj)
    return jnp.stack(vals, axis=1)


def _make_walk_parts(n: int, wb, any_hit: bool, leaf_test=_leaf_tri_t):
    """Build (init, step, done_of) for an n-lane lockstep walk.

    The walk state carries the rays themselves (org/direction/inv_d/
    tmin/tmax) so a REFILL driver (``_refill_wide``) can swap fresh chunks
    into row slices mid-loop; the classic per-chunk driver just never
    touches them. ``init`` builds a fresh state for n lanes; ``step`` is
    one walk step over the whole state; ``done_of`` extracts the done mask.

    ONE row gather per lane per step from the unified node+leaf table (bvh
    ``rows``): a lane's ``pending`` address names either a wide node
    (slab-test all children in one [N, B] pass) or a leaf row (test
    leaf_size prims as [N, ls] vector math). Children are sorted by actual
    slab entry distance at visit time (``sort8_by_key``) — true per-ray
    ordered descent."""
    from .bvh_wide import BRANCH

    # branch width shape-carried by the build ("branch" key; legacy dicts
    # without it are 8-wide)
    branch = wb["branch"].shape[1] if "branch" in wb else BRANCH
    # split u16 half tables when present (production upload): two 256 B-row
    # gathers + bit-exact f32 reconstruct beat one 512 B-row f32 gather ~2x
    # on the gather that is 84% of the walk (see bvh_wide.split_rows_u16)
    split = "rows_hi" in wb
    if split:
        rows_hi, rows_lo = wb["rows_hi"], wb["rows_lo"]  # [W + L, P] u16
        P = rows_hi.shape[1]
    else:
        rows_tab = wb["rows"]                # [W + L, P]
        P = rows_tab.shape[1]
    W = wb["wsplit"].shape[1]                # node-row count (static)
    D = wb["depth"].shape[1]                 # static max depth
    # per-primitive payload width, shape-carried by the build (9 floats for
    # both triangles p0|e1|e2 and curve segments pa|ba|ra,rb,m0)
    prim_row_w = wb["leaf_row_w"].shape[1]
    leaf_size = wb["leaf_ids"].shape[1]
    assert P >= 7 * branch and P >= (prim_row_w + 1) * leaf_size

    iota_b = jax.lax.broadcasted_iota(jnp.int32, (n, branch), 1)
    iota_d = jax.lax.broadcasted_iota(jnp.int32, (n, D), 1)
    iota_ls = jax.lax.broadcasted_iota(jnp.int32, (n, leaf_size), 1)

    def slab_children(row, best_t, org, inv_d, tmin, tmax):
        """Box-test all children of a gathered node row -> entry-distance
        sorted children set (missed/empty slots NONE, sorted last)."""
        B = branch
        meta = row[:, 6 * B: 7 * B].view(jnp.int32)          # [N, 8]
        near = jnp.full((n, B), -jnp.inf)
        far = jnp.full((n, B), jnp.inf)
        for ax in range(3):
            lo_c = row[:, ax * B: (ax + 1) * B]
            hi_c = row[:, (3 + ax) * B: (4 + ax) * B]
            o_c = org[:, ax:ax + 1]
            i_c = inv_d[:, ax:ax + 1]
            t0 = (lo_c - o_c) * i_c
            t1 = (hi_c - o_c) * i_c
            near = jnp.maximum(near, jnp.minimum(t0, t1))
            far = jnp.minimum(far, jnp.maximum(t0, t1))
        cap = jnp.minimum(tmax, best_t)
        hit = jnp.maximum(near, tmin[:, None]) <= jnp.minimum(
            far, cap[:, None]
        )
        # empty slots masked by meta, not box: their inverted AABB can
        # overflow to (-inf, +inf) slabs and read as a hit (see bvh_wide)
        ok = hit & (meta != NONE)
        key = jnp.where(ok, near, jnp.inf)
        return sort8_by_key(key, jnp.where(ok, meta, NONE))

    def init(org, direction, tmin, tmax):
        inv_d = jnp.where(
            jnp.abs(direction) > 1e-20,
            1.0 / jnp.where(direction != 0.0, direction, 1.0),
            np.float32(3.0e38),
        )
        dead = tmax <= tmin
        return (
            org, direction, inv_d, tmin, tmax,
            jnp.full((n, branch), NONE),                    # children
            jnp.full((n, D, branch), NONE),                 # stack
            jnp.zeros((n,), jnp.int32),                     # depth
            jnp.where(dead, -1, 0).astype(jnp.int32),       # pending: root
            jnp.zeros((n,), bool),                          # pend_leaf
            dead,                                           # done
            jnp.full((n,), RT_MAX),                         # best_t
            jnp.full((n,), -1, jnp.int32),                  # best_prim
            jnp.int32(0),                                   # step counter
        )

    def done_of(s):
        return s[10]

    def step(s):
        org, direction, inv_d, tmin, tmax, children, stack, depth, \
            pending, pend_leaf, done, best_t, best_prim, nd = s
        nd = nd + 1
        live = ~done

        # ---- THE gather: one unified row per lane per step --------------
        mi = jnp.maximum(pending, 0)
        if split:
            bits = (
                rows_hi[mi].astype(jnp.uint32) << 16
            ) | rows_lo[mi].astype(jnp.uint32)
            row = jax.lax.bitcast_convert_type(bits, jnp.float32)  # [N, P]
        else:
            row = rows_tab[mi]                               # [N, P]

        # ---- leaf service: lanes whose pending row is a leaf test its
        # leaf_size primitives (vectorized over the leaf axis)
        do_leaf = live & pend_leaf
        if not _SKIP_LEAF:
            ls = leaf_size
            # component-major columns (bvh_wide layout): all leaf math is
            # [N, ls] elementwise with full-width rows
            c = [row[:, k * ls: (k + 1) * ls] for k in range(prim_row_w)]
            pid = row[
                :, prim_row_w * ls: (prim_row_w + 1) * ls
            ].view(jnp.int32)                                # [N, ls]
            cap = jnp.minimum(tmax, best_t)
            t_ok = leaf_test(c, pid, org, direction, tmin, cap)
            t_ok = jnp.where(do_leaf[:, None], t_ok, RT_MAX)
            k_best = jnp.argmin(t_ok, axis=1)                # [N]
            t_best = jnp.min(t_ok, axis=1)
            hit_any = t_best < cap
            # one-hot select, NOT take_along_axis (a per-lane gather)
            oh_k = iota_ls == k_best[:, None]
            pid_best = jnp.sum(
                jnp.where(oh_k, pid, 0), axis=1, dtype=jnp.int32
            )
            best_t = jnp.where(hit_any, t_best, best_t)
            best_prim = jnp.where(hit_any, pid_best, best_prim)
        if any_hit:
            done = done | (best_prim >= 0)
            live = ~done

        # ---- node service: slab-test the gathered row -> sorted set -----
        do_node = live & ~pend_leaf & (pending >= 0)
        new_children = slab_children(row, best_t, org, inv_d, tmin, tmax)
        children = jnp.where(do_node[:, None], new_children, children)

        # ---- pop: lanes with an exhausted set restore saved siblings ----
        empty = ~jnp.any(children != NONE, axis=1)
        out_of_work = live & empty & (depth == 0)
        done = done | out_of_work
        live = live & ~out_of_work
        do_pop = live & empty & (depth > 0)
        oh_pop = iota_d == (depth - 1)[:, None]              # [N, D]
        popped = jnp.sum(
            jnp.where(oh_pop[:, :, None], stack, 0), axis=1, dtype=jnp.int32
        )
        children = jnp.where(do_pop[:, None], popped, children)
        depth = jnp.where(do_pop, depth - 1, depth)

        # ---- pick: nearest remaining child -> next step's pending row ---
        # (children are distance-sorted, so the FIRST non-NONE slot is the
        # nearest untested child)
        has = children != NONE
        pick = jnp.argmax(has, axis=1)                       # first True
        oh = iota_b == pick[:, None]
        entry = jnp.sum(jnp.where(oh, children, 0), axis=1, dtype=jnp.int32)
        take = live & jnp.any(has, axis=1)
        children = jnp.where((take[:, None] & oh), NONE, children)

        is_leaf = take & (entry < 0) & (entry != NONE)
        is_inner = take & (entry >= 0)

        # inner descend: push the remaining siblings (if any); the set is
        # replaced by the slab result when the row lands next step
        remain = jnp.any(children != NONE, axis=1)
        do_push = is_inner & remain
        oh_push = (iota_d == depth[:, None]) & do_push[:, None]
        stack = jnp.where(oh_push[:, :, None], children[:, None, :], stack)
        depth = depth + do_push.astype(jnp.int32)

        pending = jnp.where(
            is_inner, entry,
            jnp.where(is_leaf, W + (~entry), -1),
        )
        pend_leaf = is_leaf

        return (org, direction, inv_d, tmin, tmax, children, stack, depth,
                pending, pend_leaf, done, best_t, best_prim, nd)

    return init, step, done_of


def _wide_traverse(org, direction, wb, tmin, tmax, any_hit: bool,
                   with_stats: bool = False, leaf_test=_leaf_tri_t):
    """One chunk's lockstep walk. org/direction [N,3]; returns (t, prim)
    (+ a step-count scalar when ``with_stats``)."""
    init, step, done_of = _make_walk_parts(
        org.shape[0], wb, any_hit, leaf_test=leaf_test
    )
    out = jax.lax.while_loop(
        lambda s: ~jnp.all(done_of(s)), step, init(org, direction, tmin, tmax)
    )
    t, prim, nd = out[11], out[12], out[13]
    if with_stats:
        return t, prim, nd
    return t, prim


# Persistent-wavefront refill driver: NRC_TRAVERSAL_REFILL = G
# (> 0 enables). G rows of TRAVERSAL_CHUNK lanes step TOGETHER — one
# [G*C]-index row gather per step, which runs at a far better per-index
# rate than C-index gathers on the accelerator it was written for —
# and any row whose chunk has fully terminated retires its results and
# REFILLS with the next pending chunk in the same step, so the lockstep
# waste that made large monolithic chunks lose there never accrues. Refill cost is tiny by design: a
# fresh row only needs children/scalars reset — the sibling STACK is
# write-before-read for a fresh lane (pushes at depth d always precede
# the pop that reads d), so stale stack contents from the previous chunk
# are never observed.
_REFILL_GROUPS = int(_os.environ.get("NRC_TRAVERSAL_REFILL", "0"))


def _refill_wide(org, direction, wb, tmin, tmax, any_hit: bool,
                 leaf_test=_leaf_tri_t, groups: int = 8):
    from .intersect import TRAVERSAL_CHUNK, _coherence_key

    C = TRAVERSAL_CHUNK
    n = org.shape[0]
    pad = (-n) % C
    if pad:
        org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
        direction = jnp.concatenate(
            [direction, jnp.ones((pad, 3), direction.dtype)]
        )
        tmin = jnp.concatenate([tmin, jnp.ones((pad,), tmin.dtype)])
        tmax = jnp.concatenate([tmax, jnp.zeros((pad,), tmax.dtype)])
    m = n + pad
    c = m // C
    G = min(groups, c)
    root_lo, root_hi = wb["root"][0], wb["root"][1]
    key = _coherence_key(org, direction, tmin, tmax, root_lo, root_hi)
    perm = jnp.argsort(key)
    so = org[perm]
    sd = direction[perm]
    stn = tmin[perm]
    stx = tmax[perm]

    init_row, _, _ = _make_walk_parts(C, wb, any_hit, leaf_test=leaf_test)
    init_full, step_all, done_of = _make_walk_parts(
        G * C, wb, any_hit, leaf_test=leaf_test
    )
    state0 = init_full(so[: G * C], sd[: G * C], stn[: G * C], stx[: G * C])

    # out slot c is the dump for rows that are idle/already-retired
    out_t0 = jnp.full(((c + 1) * C,), RT_MAX)
    out_p0 = jnp.full(((c + 1) * C,), -1, jnp.int32)
    ids0 = jnp.arange(G, dtype=jnp.int32)

    def cond(carry):
        s, ids, nxt, out_t, out_p = carry
        return jnp.any(~done_of(s)) | (nxt < c)

    def body(carry):
        s, ids, nxt, out_t, out_p = carry
        s = step_all(s)
        done = done_of(s)
        best_t, best_prim = s[11], s[12]
        leaves = list(s)
        for g in range(G):
            sl = slice(g * C, (g + 1) * C)
            row_done = jnp.all(done[sl])
            # retire: write the row's results to its chunk slot (idempotent
            # while the row stays done; the dump slot c swallows idle rows)
            tgt = jnp.where(row_done, ids[g], c) * C
            out_t = jax.lax.dynamic_update_slice_in_dim(
                out_t, best_t[sl], tgt, 0
            )
            out_p = jax.lax.dynamic_update_slice_in_dim(
                out_p, best_prim[sl], tgt, 0
            )
            # refill: swap the next pending chunk's rays in
            take = row_done & (nxt < c)
            src = jnp.where(take, nxt, 0) * C
            f_org = jax.lax.dynamic_slice_in_dim(so, src, C, 0)
            f_dir = jax.lax.dynamic_slice_in_dim(sd, src, C, 0)
            f_tn = jax.lax.dynamic_slice_in_dim(stn, src, C, 0)
            f_tx = jax.lax.dynamic_slice_in_dim(stx, src, C, 0)
            fresh = init_row(f_org, f_dir, f_tn, f_tx)
            # leaves: org, dir, inv_d, tmin, tmax, children, stack, depth,
            # pending, pend_leaf, done, best_t, best_prim, nd — the STACK
            # (index 6) is intentionally left stale (write-before-read for
            # fresh lanes, see driver comment); nd (13) is global
            for li in (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 12):
                cur = jax.lax.slice_in_dim(leaves[li], g * C, (g + 1) * C, axis=0)
                new = jnp.where(
                    take if cur.ndim == 1 else take[..., None]
                    if cur.ndim == 2 else take[..., None, None],
                    fresh[li], cur,
                )
                leaves[li] = jax.lax.dynamic_update_slice_in_dim(
                    leaves[li], new, g * C, 0
                )
            ids = ids.at[g].set(
                jnp.where(take, nxt, jnp.where(row_done, c, ids[g]))
            )
            nxt = nxt + take.astype(jnp.int32)
        return tuple(leaves), ids, nxt, out_t, out_p

    carry = (state0, ids0, jnp.int32(G), out_t0, out_p0)
    s, ids, nxt, out_t, out_p = jax.lax.while_loop(cond, body, carry)
    inv = jnp.zeros(m, jnp.int32).at[perm].set(jnp.arange(m, dtype=jnp.int32))
    return out_t[: c * C][inv][:n], out_p[: c * C][inv][:n]


def _chunked_wide(org, direction, wb, tmin, tmax, any_hit: bool,
                  leaf_test=_leaf_tri_t):
    from .intersect import TRAVERSAL_CHUNK

    G = _REFILL_GROUPS
    if G > 0 and org.shape[0] >= 2 * G * TRAVERSAL_CHUNK:
        return _refill_wide(
            org, direction, wb, tmin, tmax, any_hit,
            leaf_test=leaf_test, groups=G,
        )
    return chunked_over_rays(
        lambda o, d, tn, tx: _wide_traverse(
            o, d, wb, tn, tx, any_hit, leaf_test=leaf_test
        ),
        org, direction, (wb["root"][0], wb["root"][1]), tmin, tmax,
    )


def intersect_wbvh(org, direction, wb, tris: TriSoA, tmin, tmax) -> Hit:
    """Closest hit over the wide BVH; winner barycentrics re-derived
    (``hit_from_t_prim`` — the epilogue shared with the binary walk and
    the primary raster)."""
    from .intersect import hit_from_t_prim

    t, prim = _chunked_wide(org, direction, wb, tmin, tmax, any_hit=False)
    return hit_from_t_prim(org, direction, tris, t, prim)


def occluded_wbvh(org, direction, wb, tris: TriSoA, tmin, tmax) -> jnp.ndarray:
    _, prim = _chunked_wide(org, direction, wb, tmin, tmax, any_hit=True)
    return prim >= 0


def intersect_curves_wbvh(org, direction, wb, tmin, tmax):
    """Closest hit over a wide CURVE BVH (payload rows pa|ba|ra,rb,m0;
    ``curve_intersect.build_wide_curve_bvh``) -> (t [N], prim [N])."""
    return _chunked_wide(
        org, direction, wb, tmin, tmax, any_hit=False, leaf_test=_leaf_cone_t
    )


def occluded_curves_wbvh(org, direction, wb, tmin, tmax) -> jnp.ndarray:
    _, prim = _chunked_wide(
        org, direction, wb, tmin, tmax, any_hit=True, leaf_test=_leaf_cone_t
    )
    return prim >= 0
