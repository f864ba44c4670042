"""Wavefront BVH traversal over the whole ray batch.

The reference traverses its flattened SAH tree with an explicit per-ray
128-deep stack (``libwurblpt/bvh.hpp:277-311``). Two lockstep traversals live
here, both plain `lax` that XLA compiles for the device:

**Wide path (default, round 4)** — ``_wide_closest_hit`` / ``_wide_any_hit``:
the binary SAH tree is collapsed into W-ary nodes whose children's AABBs and
links occupy ONE gathered row (build._collapse_wide), so each lockstep step
pays one row gather and slab-tests W children vectorized; an exact
per-lane short stack (single-pass one-hot push of the sorted-children prefix,
``_stack_push_sorted``) gives true front-to-back order with best-t pruning.
Two further facts, measured on the previous accelerator, shape it:

* the lockstep tail is the enemy: the mean ray finishes in ~6 steps but the
  max runs ~10x longer, and every step pays one row gather per LANE whether
  live or idle — so live lanes are periodically COMPACTED into 4x smaller
  batches (``_stage_sizes``, nonzero + gather + scatter-back), and the walk
  yields to leaf work early once few lanes still walk (walker-count exit);
* sequential one-hot stack pushes are memory-bound (each rewrites the whole
  [N, D] stack); all pushes are fused into one masked pass.

None of its constants (W, leaf size, the compaction schedule, the walk-exit
divisor) has been measured on the H100 yet; ROADMAP S2 re-tunes them, and
a one-thread-per-ray traversal kernel is S2's alternative to this walk.

**Binary threaded path (fallback)** — retained for BVHs built with
``WURBLPT_BVH_WIDE=0`` and raw-array scenes without packed leaf geometry:
nodes are *threaded* at build time (advance to node+1 on AABB hit,
``miss_next[node]`` on miss) with per-octant front-to-back link tables, a
stackless walk whose per-step cost is two row gathers for one box test.

Both paths share the two-phase structure (walk-to-leaf, then one packed
leaf-tile gather per leaf VISIT) and the leaf intersectors. Triangle tests
inside leaves are WATERTIGHT (intersect.watertight_tri, Woop semantics per
``hitable_triangle.hpp:189-274``) when the scene carries absolute vertices;
the Moller-Trumbore fallback only remains for raw-array scenes built without
them.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ..core.vecmath import safe_sqrt

from ..scene.ir import SceneArrays

# Host scalar, NOT jnp: a module-level device array becomes a hoisted
# const_arg in every program that closes over it (jax 0.9.0 drops those
# on cross-program re-dispatch; see tests/conftest.py).
BIG = np.float32(3.0e37)


def _slab_test(o, inv_d, bmin, bmax, t_min, t_max):
    """Majercik slab test (``aabb.hpp:70-86`` semantics), batched [N]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tlo, axis=-1), t_min)
    far = jnp.minimum(jnp.min(thi, axis=-1), t_max)
    return near <= far


def _leaf_rays(scene, o, d, pids, obj_rays):
    """Per-(lane, slot) rays: world by default, per-animation object space
    when obj_rays is given (hit t is affine-invariant)."""
    ox = o[:, None, :]
    dx = d[:, None, :]
    if obj_rays is None:
        return ox, dx
    n_tri = scene.n_tris
    pid_safe = jnp.maximum(pids, 0)
    if n_tri > 0:
        aid_t = scene.tris.anim[jnp.clip(pid_safe, 0, n_tri - 1)]
    else:
        aid_t = jnp.zeros(pids.shape, jnp.int32)
    if scene.n_spheres > 0:
        aid_s = scene.spheres.anim[
            jnp.clip(pid_safe - n_tri, 0, scene.n_spheres - 1)
        ]
    else:
        aid_s = jnp.zeros(pids.shape, jnp.int32)
    aid = jnp.where(pids < n_tri, aid_t, aid_s)
    o_a, d_a = obj_rays
    ox = jnp.take_along_axis(o_a, aid[..., None], axis=1)
    dx = jnp.take_along_axis(d_a, aid[..., None], axis=1)
    return ox, dx


def _leaf_tri_test(scene, ox, dx, pids, t_min, t_max):
    """Triangle tile test for gathered leaf prims. Returns (t, u, v, ok)."""
    from ..render.intersect import watertight_tri

    n_tri = scene.n_tris
    valid_pid = (pids >= 0) & (pids < n_tri)
    ti = jnp.clip(jnp.maximum(pids, 0), 0, n_tri - 1)
    T = scene.tris
    if T.v1 is not None:
        t, u, v, ok = watertight_tri(
            ox, dx, T.p0[ti], T.v1[ti], T.v2[ti],
            t_min[:, None], t_max[:, None],
        )
        ok = ok & valid_pid
        return jnp.where(ok, t, BIG), u, v, ok
    p0, e1, e2 = T.p0[ti], T.e1[ti], T.e2[ti]
    pvec = jnp.cross(dx, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(
        jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0
    )
    tvec = ox - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dx * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = (
        valid_pid
        & (jnp.abs(det) > 1e-12)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min[:, None]) & (t < t_max[:, None])
    )
    return jnp.where(ok, t, BIG), u, v, ok


def _leaf_sphere_test(scene, ox, dx, pids, t_min, t_max):
    n_tri = scene.n_tris
    valid_pid = pids >= n_tri
    si = jnp.clip(jnp.maximum(pids, 0) - n_tri, 0, scene.n_spheres - 1)
    S = scene.spheres
    oc = ox - S.center[si]
    a = jnp.sum(dx * dx, axis=-1)
    half_b = jnp.sum(oc * dx, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - S.radius[si] * S.radius[si]
    disc = half_b * half_b - a * c
    sq = safe_sqrt(disc)
    q = -(half_b + jnp.sign(half_b) * sq)
    s0 = q / jnp.maximum(a, 1e-20)
    s1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1.0)
    slo = jnp.minimum(s0, s1)
    shi = jnp.maximum(s0, s1)
    ts = jnp.where(slo > t_min[:, None], slo, shi)
    ok = (
        valid_pid & (disc > 0.0)
        & (ts > t_min[:, None]) & (ts < t_max[:, None])
    )
    return jnp.where(ok, ts, BIG), ok


def _packed_leaf_rays(scene, bvh, o, d, leaf_row_safe, pids, obj_rays):
    """Rays per (lane, slot) for the packed leaf path: world rays broadcast,
    or per-slot object-space rays via the packed leaf_anim ids."""
    if obj_rays is None:
        return o[:, None, :], d[:, None, :]
    aid = bvh.leaf_anim[leaf_row_safe]
    aid = jnp.where(pids >= 0, aid, 0)
    o_a, d_a = obj_rays
    ox = jnp.take_along_axis(o_a, aid[..., None], axis=1)
    dx = jnp.take_along_axis(d_a, aid[..., None], axis=1)
    return ox, dx


def _packed_leaf_tests(scene, bvh, o, d, t_min, t_max, leaf_row, on_leaf,
                       obj_rays):
    """Intersect each lane against its leaf's PACKED geometry row.

    One [N]-row gather of leaf_geom [L, K, 9] replaces K per-prim gathers
    (measured ~10x on the leaf phase at 100k prims). Returns
    (pids, t [N,K], u, v, ok)."""
    from ..render.intersect import watertight_tri

    leaf_row_safe = jnp.maximum(leaf_row, 0)
    pids = jnp.where(on_leaf[:, None], bvh.leaf_prims[leaf_row_safe], -1)
    geom = bvh.leaf_geom[leaf_row_safe]            # [N, K, 9] one gather
    ox, dx = _packed_leaf_rays(scene, bvh, o, d, leaf_row_safe, pids, obj_rays)

    n_tri = scene.n_tris
    is_tri = (pids >= 0) & (pids < n_tri)
    is_sph = pids >= n_tri
    tmaxk = t_max[:, None]

    t_all = jnp.full(pids.shape, BIG)
    u = jnp.zeros(pids.shape)
    v = jnp.zeros(pids.shape)
    ok = jnp.zeros(pids.shape, bool)
    if n_tri > 0:
        tt, ut, vt, okt = watertight_tri(
            ox, dx, geom[..., 0:3], geom[..., 3:6], geom[..., 6:9],
            t_min[:, None], tmaxk,
        )
        okt = okt & is_tri
        t_all = jnp.where(okt, tt, t_all)
        u = jnp.where(okt, ut, u)
        v = jnp.where(okt, vt, v)
        ok = ok | okt
    if scene.n_spheres > 0:
        oc = ox - geom[..., 0:3]
        radius = geom[..., 3]
        a = jnp.sum(dx * dx, axis=-1)
        half_b = jnp.sum(oc * dx, axis=-1)
        c = jnp.sum(oc * oc, axis=-1) - radius * radius
        disc = half_b * half_b - a * c
        sq = safe_sqrt(disc)
        q = -(half_b + jnp.sign(half_b) * sq)
        s0 = q / jnp.maximum(a, 1e-20)
        s1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1.0)
        slo = jnp.minimum(s0, s1)
        shi = jnp.maximum(s0, s1)
        ts = jnp.where(slo > t_min[:, None], slo, shi)
        oks = is_sph & (disc > 0.0) & (ts > t_min[:, None]) & (ts < tmaxk)
        t_all = jnp.where(oks, ts, t_all)
        ok = ok | oks
    return pids, t_all, u, v, ok


def _leaf_intersect(scene: SceneArrays, o, d, t_min, pids, best, obj_rays=None):
    """Intersect each ray with its K gathered leaf prims; fold into best.

    pids: [N, K] global prim ids (-1 = padding). best: (t, prim, u, v).
    (Per-prim-gather fallback for BVHs built without packed leaf geometry.)
    """
    bt, bp, bu, bv = best
    ox, dx = _leaf_rays(scene, o, d, pids, obj_rays)

    if scene.n_tris > 0:
        t_tri, u, v, _ = _leaf_tri_test(scene, ox, dx, pids, t_min, bt)
    else:
        t_tri = jnp.full(pids.shape, BIG)
        u = jnp.zeros(pids.shape)
        v = jnp.zeros(pids.shape)

    if scene.n_spheres > 0:
        t_sph, _ = _leaf_sphere_test(scene, ox, dx, pids, t_min, bt)
    else:
        t_sph = jnp.full(pids.shape, BIG)

    t_all = jnp.minimum(t_tri, t_sph)
    t_all = jnp.where(t_all < bt[:, None], t_all, BIG)
    k = jnp.argmin(t_all, axis=-1)
    rows = jnp.arange(pids.shape[0])
    tk = t_all[rows, k]
    closer = tk < bt
    is_tri_win = pids[rows, k] < scene.n_tris
    return (
        jnp.where(closer, tk, bt),
        jnp.where(closer, pids[rows, k], bp),
        jnp.where(closer, jnp.where(is_tri_win, u[rows, k], 0.0), bu),
        jnp.where(closer, jnp.where(is_tri_win, v[rows, k], 0.0), bv),
    )


def _octant_base(bvh, d):
    """Per-ray base row into the flattened per-octant link table [8N, 3]:
    octant = sign bits of the direction, row = octant * N + node."""
    n_nodes = bvh.node_f.shape[0]
    oct_ = ((d[:, 0] < 0).astype(jnp.int32)
            | ((d[:, 1] < 0).astype(jnp.int32) << 1)
            | ((d[:, 2] < 0).astype(jnp.int32) << 2))
    return oct_ * n_nodes


def _walk_to_leaf(bvh, o, inv_d, t_min, node, tmax_eff, oct_base=None):
    """Advance every lane to its NEXT hit leaf (or -1 done).

    Inner-node stepping is CHEAP (two small-table row gathers + a slab test);
    leaf-tile intersection is EXPENSIVE (wide gathers from the primitive
    arrays). Separating them means leaf work happens once per leaf VISIT, not
    once per traversal STEP — the gather volume drops by the inner/leaf step
    ratio (measured 35 s -> sub-second per cast at 100k prims, 76800 lanes).

    Links come from the per-ray-octant threading (build._octant_links), so
    every walk is near-child-first and tmax_eff (the shrinking best_t) prunes
    the far side. Returns the node id of a HIT leaf per lane, or -1 done.
    """
    def cond(state):
        node, settled = state
        return jnp.any(~settled)

    def body(state):
        node, settled = state
        live = node >= 0
        ns = jnp.maximum(node, 0)
        nf = bvh.node_f[ns]
        if oct_base is not None:
            ln = bvh.node_oct[oct_base + ns]
            leaf_row, hit_link, miss_link = ln[:, 0], ln[:, 1], ln[:, 2]
        else:
            # plain pre-order threading (any-hit: no best_t to prune with, and
            # the smaller table gathers faster)
            ni = bvh.node_i[ns]
            leaf_row, miss_link = ni[:, 0], ni[:, 1]
            hit_link = ns + 1
        box_hit = live & _slab_test(
            o, inv_d, nf[:, 0:3], nf[:, 3:6], t_min, tmax_eff
        )
        at_hit_leaf = box_hit & (leaf_row >= 0)
        nxt = jnp.where(box_hit & (leaf_row < 0), hit_link, miss_link)
        node = jnp.where(live & ~settled & ~at_hit_leaf, nxt, node)
        settled = settled | at_hit_leaf | (node < 0)
        return node, settled

    node, _ = jax.lax.while_loop(
        cond, body, (node, node < 0)
    )
    return node


# ---------------------------------------------------------------------------
# Wide-BVH traversal (one row gather tests W children; exact short stack)
# ---------------------------------------------------------------------------
#
# The binary threaded walk pays TWO row gathers per node VISIT to test ONE
# box. A W-wide node packs all W children's AABBs + links into one [W*7] f32
# row (build._collapse_wide): one gather, W vectorized slab tests, exact
# per-lane front-to-back ordering via a short stack. The stack lives in loop
# state as [N, D] arrays manipulated with one-hot masks — elementwise work,
# no per-lane dynamic gathers.

def _wide_decode(bvh):
    """(wide rows [M, W, 7], W, stack depth D)."""
    wn = bvh.wide_nodes
    W = wn.shape[1] // 7
    return wn, W, bvh.wide_meta.shape[0]


def _wide_children(bvh, node, o, inv_d, t_min, t_max_eff, W):
    """Gather each lane's wide node row and slab-test all W children.

    Returns (t_near [N, W] — BIG where missed/invalid, links [N, W]).
    """
    ns = jnp.maximum(node, 0)
    row = bvh.wide_nodes[ns].reshape(ns.shape[0], W, 7)   # ONE gather
    bmin = row[..., 0:3]
    bmax = row[..., 3:6]
    # Links are stored as exact float VALUES (|v| < 2^24), not bitcast int
    # patterns: small positive ids bitcast to f32 denormals, which XLA
    # backends may flush to zero in some op sequences.
    links = row[..., 6].astype(jnp.int32)
    t0 = (bmin - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bmax - o[:, None, :]) * inv_d[:, None, :]
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tlo, axis=-1), t_min[:, None])
    far = jnp.minimum(jnp.min(thi, axis=-1), t_max_eff[:, None])
    hit = (near <= far) & (links != -1) & (node >= 0)[:, None]
    return jnp.where(hit, near, BIG), links


def _stack_push_sorted(stack_l, stack_t, sp, links, tnear, live):
    """Push children 1..cnt-1 of the SORTED candidate list in far-to-near
    order (nearest ends on top) — in ONE pass over the stack.

    Sequential one-hot pushes materialize the whole [N, D] stack in device
    memory once per push; W-1 of them made the stack ops most of the step
    cost on the previous accelerator. Writing all pushed slots in a single
    masked update pays the stack traffic once. `tnear` ascending with
    BIG for invalid, so valid candidates are the prefix [0, cnt_all); slot
    p in [sp, sp+cnt_all-1) receives child j = sp + cnt_all - 1 - p.
    """
    W = links.shape[1]
    valid = tnear < BIG
    cnt_all = jnp.sum(valid.astype(jnp.int32), axis=1)
    cnt = jnp.maximum(cnt_all - 1, 0) * live.astype(jnp.int32)
    iota_d = jax.lax.broadcasted_iota(jnp.int32, stack_l.shape, 1)
    jp = sp[:, None] + cnt_all[:, None] - 1 - iota_d
    in_push = (iota_d >= sp[:, None]) & (iota_d < (sp + cnt)[:, None])
    oh = jp[..., None] == jax.lax.broadcasted_iota(
        jnp.int32, stack_l.shape + (W,), 2)
    newl = jnp.sum(jnp.where(oh, links[:, None, :], 0), axis=-1)
    newt = jnp.sum(jnp.where(oh, tnear[:, None, :], 0.0), axis=-1)
    return (
        jnp.where(in_push, newl, stack_l),
        jnp.where(in_push, newt, stack_t),
        sp + cnt,
    )


def _stack_pop(stack_l, stack_t, sp, best, mask):
    """Pop the topmost entry whose recorded entry-t still beats `best` on
    lanes where mask; entries above it (all provably prunable) are discarded
    by moving sp. Returns (node [-1 = empty], new_sp)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, stack_l.shape, 1)
    live = (iota < sp[:, None]) & (stack_t < best[:, None])
    top = jnp.max(jnp.where(live, iota, -1), axis=1)
    any_v = top >= 0
    oh = iota == top[:, None]
    link = jnp.sum(jnp.where(oh & live, stack_l, 0), axis=1)
    node = jnp.where(any_v, link, -1)
    new_sp = jnp.where(mask, jnp.maximum(top, 0), sp)
    return jnp.where(mask, node, 0), new_sp


def _wide_walk_to_leaf(bvh, o, inv_d, t_min, t_max, node, sp, stack_l,
                       stack_t, best_t, stop_count: int = 0,
                       unroll: int = 1):
    """Advance every lane to its next LEAF (node <= -2) or to done (-1).

    Children are always visited front-to-back (the sort is ~10% of a step and
    the prefix property is what the single-pass push needs); for closest-hit
    callers the shrinking best_t then prunes, for any-hit the order is merely
    harmless.

    `stop_count`: break out early once the number of lanes still WALKING
    (node >= 0) drops to this bound while at least one lane is parked at a
    leaf — the parked majority then proceeds to leaf work instead of idling
    through the walk's straggler tail (every lockstep step pays one row
    gather per LANE whether live or idle, so batch width, not walker count,
    is the cost). Progress is guaranteed: with nothing parked the walk
    continues regardless of the walker count.
    """
    wn, W, D = _wide_decode(bvh)

    def cond(state):
        nd = state[0]
        walking = nd >= 0
        any_walking = jnp.any(walking)
        if stop_count <= 0:
            return any_walking
        few = jnp.sum(walking.astype(jnp.int32)) <= stop_count
        parked = jnp.any(nd <= -2)
        return any_walking & ~(few & parked)

    def step(state):
        node, sp, stack_l, stack_t = state
        live = node >= 0
        tmax_eff = jnp.minimum(t_max, best_t)
        tnear, links = _wide_children(bvh, node, o, inv_d, t_min, tmax_eff, W)
        # Sort even on the unordered (any-hit) path: it is ~10% of a step and
        # makes valid candidates a PREFIX, enabling the single-pass push.
        tnear, links = jax.lax.sort((tnear, links), dimension=1, num_keys=1)
        first_hit = tnear[:, 0] < BIG
        desc = links[:, 0]
        stack_l, stack_t, sp = _stack_push_sorted(
            stack_l, stack_t, sp, links, tnear, live)
        popped, sp = _stack_pop(stack_l, stack_t, sp, jnp.minimum(t_max, best_t),
                                live & ~first_hit)
        node = jnp.where(live, jnp.where(first_hit, desc, popped), node)
        return node, sp, stack_l, stack_t

    def nbody(state):
        # Unrolled steps per while iteration: at compacted (small) widths the
        # loop's fixed per-iteration launch/sync cost dominates; settled
        # lanes mask out of later steps. Kept at 1 for the full-width stages:
        # on the previous accelerator a global 2x unroll regressed the whole
        # frame many times over (code-size/scheduling pathology in the
        # nested wavefront loop).
        for _ in range(unroll):
            state = step(state)
        return state

    return jax.lax.while_loop(cond, nbody, (node, sp, stack_l, stack_t))


def _walk_stop_div() -> int:
    """Walk-exit divisor: the wide walk yields to leaf work once walkers
    <= m // div. 8 was the best of a frame-gated sweep (2..32) on the
    previous accelerator: yielding too eagerly doubles the outer leaf/pop
    rounds, too lazily idles parked lanes in the walk. Not yet measured on
    the H100 (ROADMAP S2)."""
    import os

    return int(os.environ.get("WURBLPT_BVH_STOP_DIV", "8"))


def _stage_sizes(n: int):
    """Compaction schedule: full width, then /4 steps down to ~8k lanes.

    Live-lane histogram (terrain_city, 76800 camera rays): the average ray
    finishes in ~6 lockstep steps but the lockstep tail runs to ~95 — by
    step 7 under 11% of lanes are live, yet every step still pays one row
    gather per LANE. Re-packing survivors into a 4x smaller batch caps that
    waste at a bounded geometric overhead. The /4 factor and the 256-lane
    floor are starting points from the previous accelerator, not yet
    measured on the H100 (ROADMAP S2).
    """
    import os

    min_stage = int(os.environ.get("WURBLPT_BVH_MIN_STAGE", "256"))
    sizes = [n]
    while sizes[-1] >= 4 * min_stage:
        sizes.append(sizes[-1] // 4)
    return sizes


def _stage_sizes_fused(n: int):
    """Fused-cast schedule (== the standard one).

    Negative results on the full bvh_100k frame, on the previous
    accelerator (radiance bit-identical): fusing the bounce's closest cast
    with its deferred env-NEE any-hit into one traversal was slower than two
    separate casts under the /4 schedule, and slower still with an extra /2
    entry stage to shed entry-dead lanes. The integrator therefore fuses
    casts only on the matmul path (integrator._fused_mode). Not measured on
    the H100 (ROADMAP D1).
    """
    return _stage_sizes(n)


def _compact_gather(idx, valid, *arrays):
    """Gather rows `idx` of each array (idx already clipped); rows where
    ~valid are garbage the caller must mask."""
    return tuple(a[idx] for a in arrays)


def _wide_closest_hit(scene: SceneArrays, o, d, t_min, t_max, obj_rays=None):
    bvh = scene.bvh
    n = o.shape[0]
    _, W, D = _wide_decode(bvh)

    def run_stage(o_s, d_s, t_min_s, t_max_s, obj_s, state, stop):
        inv_d = jnp.where(
            jnp.abs(d_s) > 1e-20, 1.0 / jnp.where(d_s == 0.0, 1.0, d_s), BIG)
        m = o_s.shape[0]

        def cond(state):
            unfinished = state[0] != -1
            if stop <= 0:
                return jnp.any(unfinished)
            return jnp.sum(unfinished.astype(jnp.int32)) > stop

        def body(state):
            node, sp, stack_l, stack_t, bt, bp, bu, bv = state
            node, sp, stack_l, stack_t = _wide_walk_to_leaf(
                bvh, o_s, inv_d, t_min_s, t_max_s, node, sp, stack_l, stack_t,
                bt, stop_count=m // _walk_stop_div(), unroll=2 if m <= 4800 else 1)
            on_leaf = node <= -2
            leaf_row = jnp.where(on_leaf, -node - 2, -1)
            pids, t_all, u, v, _ = _packed_leaf_tests(
                scene, bvh, o_s, d_s, t_min_s, bt, leaf_row, on_leaf, obj_s)
            t_all = jnp.where(t_all < bt[:, None], t_all, BIG)
            k = jnp.argmin(t_all, axis=-1)
            rows = jnp.arange(m)
            tk = t_all[rows, k]
            closer = tk < bt
            is_tri_win = pids[rows, k] < scene.n_tris
            bt = jnp.where(closer, tk, bt)
            bp = jnp.where(closer, pids[rows, k], bp)
            bu = jnp.where(closer, jnp.where(is_tri_win, u[rows, k], 0.0), bu)
            bv = jnp.where(closer, jnp.where(is_tri_win, v[rows, k], 0.0), bv)
            popped, sp = _stack_pop(stack_l, stack_t, sp,
                                    jnp.minimum(t_max_s, bt), on_leaf)
            node = jnp.where(on_leaf, popped, node)
            return node, sp, stack_l, stack_t, bt, bp, bu, bv

        return jax.lax.while_loop(cond, body, state)

    state = (
        jnp.zeros((n,), jnp.int32),                 # node (wide root = 0)
        jnp.zeros((n,), jnp.int32),                 # sp
        jnp.zeros((n, D), jnp.int32),               # stack links
        jnp.full((n, D), BIG),                      # stack entry t
        jnp.full((n,), BIG),                        # best t
        jnp.full((n,), -1, jnp.int32),              # best prim
        jnp.zeros((n,)),                            # best u
        jnp.zeros((n,)),                            # best v
    )
    sizes = _stage_sizes(n)
    bt_f, bp_f, bu_f, bv_f = state[4:]
    o_s, d_s, t_min_s, t_max_s, obj_s = o, d, t_min, t_max, obj_rays
    idx_full = None                                 # map stage lane -> original
    for si, size in enumerate(sizes):
        stop = sizes[si + 1] if si + 1 < len(sizes) else 0
        if si > 0:
            node = state[0]
            idx_stage = jnp.nonzero(node != -1, size=size,
                                    fill_value=node.shape[0])[0]
            valid = idx_stage < node.shape[0]
            idx_c = jnp.minimum(idx_stage, node.shape[0] - 1)
            state = _compact_gather(idx_c, valid, *state)
            state = (jnp.where(valid, state[0], -1),) + state[1:]
            o_s, d_s, t_min_s, t_max_s = _compact_gather(
                idx_c, valid, o_s, d_s, t_min_s, t_max_s)
            if obj_s is not None:
                obj_s = _compact_gather(idx_c, valid, *obj_s)
            # stage lane -> ORIGINAL row for the final scatter
            idx_full = idx_c if idx_full is None else idx_full[idx_c]
            idx_full = jnp.where(valid, idx_full, n)
        state = run_stage(o_s, d_s, t_min_s, t_max_s, obj_s, state, stop)
        if si > 0:
            # scatter stage results back to the full-size outputs
            bt_f = bt_f.at[idx_full].set(state[4], mode="drop")
            bp_f = bp_f.at[idx_full].set(state[5], mode="drop")
            bu_f = bu_f.at[idx_full].set(state[6], mode="drop")
            bv_f = bv_f.at[idx_full].set(state[7], mode="drop")
        else:
            bt_f, bp_f, bu_f, bv_f = state[4:]
    hit = bp_f >= 0
    return jnp.where(hit, bt_f, BIG), bp_f, bu_f, bv_f


def _wide_any_hit(scene: SceneArrays, o, d, t_min, t_max, obj_rays=None):
    bvh = scene.bvh
    n = o.shape[0]
    _, W, D = _wide_decode(bvh)

    def run_stage(o_s, d_s, t_min_s, t_max_s, obj_s, state, stop):
        inv_d = jnp.where(
            jnp.abs(d_s) > 1e-20, 1.0 / jnp.where(d_s == 0.0, 1.0, d_s), BIG)
        m = o_s.shape[0]

        def cond(state):
            unfinished = state[0] != -1
            if stop <= 0:
                return jnp.any(unfinished)
            return jnp.sum(unfinished.astype(jnp.int32)) > stop

        def body(state):
            node, sp, stack_l, stack_t, occ = state
            node, sp, stack_l, stack_t = _wide_walk_to_leaf(
                bvh, o_s, inv_d, t_min_s, t_max_s, node, sp, stack_l, stack_t,
                t_max_s, stop_count=m // _walk_stop_div(), unroll=2 if m <= 4800 else 1)
            on_leaf = node <= -2
            leaf_row = jnp.where(on_leaf, -node - 2, -1)
            _, _, _, _, ok = _packed_leaf_tests(
                scene, bvh, o_s, d_s, t_min_s, t_max_s, leaf_row, on_leaf,
                obj_s)
            occ = occ | jnp.any(ok, axis=-1)
            popped, sp = _stack_pop(stack_l, stack_t, sp, t_max_s, on_leaf)
            node = jnp.where(on_leaf, jnp.where(occ, -1, popped), node)
            return node, sp, stack_l, stack_t, occ

        return jax.lax.while_loop(cond, body, state)

    state = (
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n, D), jnp.int32),
        jnp.full((n, D), BIG),
        jnp.zeros((n,), bool),                      # occluded
    )
    sizes = _stage_sizes(n)
    occ_f = state[4]
    o_s, d_s, t_min_s, t_max_s, obj_s = o, d, t_min, t_max, obj_rays
    idx_full = None
    for si, size in enumerate(sizes):
        stop = sizes[si + 1] if si + 1 < len(sizes) else 0
        if si > 0:
            node = state[0]
            idx_stage = jnp.nonzero(node != -1, size=size,
                                    fill_value=node.shape[0])[0]
            valid = idx_stage < node.shape[0]
            idx_c = jnp.minimum(idx_stage, node.shape[0] - 1)
            state = _compact_gather(idx_c, valid, *state)
            state = (jnp.where(valid, state[0], -1),) + state[1:]
            o_s, d_s, t_min_s, t_max_s = _compact_gather(
                idx_c, valid, o_s, d_s, t_min_s, t_max_s)
            if obj_s is not None:
                obj_s = _compact_gather(idx_c, valid, *obj_s)
            idx_full = idx_c if idx_full is None else idx_full[idx_c]
            idx_full = jnp.where(valid, idx_full, n)
        state = run_stage(o_s, d_s, t_min_s, t_max_s, obj_s, state, stop)
        if si > 0:
            occ_f = occ_f.at[idx_full].set(state[4], mode="drop")
        else:
            occ_f = state[4]
    return occ_f


def _wide_fused_hit(scene: SceneArrays, o, d, t_min, t_max, anyhit,
                    obj_rays=None):
    """Merged closest-hit + any-hit traversal over ONE lane batch.

    Lanes where `anyhit` is True retire on their FIRST confirmed hit in
    (t_min, t_max) and report only occlusion; the remaining lanes fold
    best-hit state exactly like `_wide_closest_hit`. Both kinds share the
    walk loop, the compaction stages, and the straggler tail, so a bounce's
    closest cast and its (deferred) NEE shadow casts pay the lockstep
    per-iteration fixed costs ONCE instead of once per cast. Lanes with
    t_max <= t_min (inactive) die on the root step and are
    compacted away at the first stage boundary.

    Returns (t, prim, u, v, occluded); closest lanes read the first four,
    any-hit lanes read the last.
    """
    bvh = scene.bvh
    n = o.shape[0]
    _, W, D = _wide_decode(bvh)

    def run_stage(o_s, d_s, t_min_s, t_max_s, ah_s, obj_s, state, stop):
        inv_d = jnp.where(
            jnp.abs(d_s) > 1e-20, 1.0 / jnp.where(d_s == 0.0, 1.0, d_s), BIG)
        m = o_s.shape[0]

        def cond(state):
            unfinished = state[0] != -1
            if stop <= 0:
                return jnp.any(unfinished)
            return jnp.sum(unfinished.astype(jnp.int32)) > stop

        def body(state):
            node, sp, stack_l, stack_t, bt, bp, bu, bv, occ = state
            node, sp, stack_l, stack_t = _wide_walk_to_leaf(
                bvh, o_s, inv_d, t_min_s, t_max_s, node, sp, stack_l, stack_t,
                bt, stop_count=m // _walk_stop_div(), unroll=2 if m <= 4800 else 1)
            on_leaf = node <= -2
            leaf_row = jnp.where(on_leaf, -node - 2, -1)
            bound = jnp.minimum(t_max_s, bt)
            pids, t_all, u, v, ok = _packed_leaf_tests(
                scene, bvh, o_s, d_s, t_min_s, bound, leaf_row, on_leaf, obj_s)
            # closest fold (masked off on any-hit lanes)
            t_all = jnp.where(t_all < bt[:, None], t_all, BIG)
            k = jnp.argmin(t_all, axis=-1)
            rows = jnp.arange(m)
            tk = t_all[rows, k]
            closer = (tk < bt) & ~ah_s
            is_tri_win = pids[rows, k] < scene.n_tris
            bt = jnp.where(closer, tk, bt)
            bp = jnp.where(closer, pids[rows, k], bp)
            bu = jnp.where(closer, jnp.where(is_tri_win, u[rows, k], 0.0), bu)
            bv = jnp.where(closer, jnp.where(is_tri_win, v[rows, k], 0.0), bv)
            # any-hit retire on first confirmed hit
            occ = occ | (ah_s & on_leaf & jnp.any(ok, axis=-1))
            popped, sp = _stack_pop(stack_l, stack_t, sp,
                                    jnp.minimum(t_max_s, bt), on_leaf)
            node = jnp.where(
                on_leaf, jnp.where(ah_s & occ, -1, popped), node)
            return node, sp, stack_l, stack_t, bt, bp, bu, bv, occ

        return jax.lax.while_loop(cond, body, state)

    state = (
        jnp.zeros((n,), jnp.int32),                 # node (wide root = 0)
        jnp.zeros((n,), jnp.int32),                 # sp
        jnp.zeros((n, D), jnp.int32),               # stack links
        jnp.full((n, D), BIG),                      # stack entry t
        jnp.full((n,), BIG),                        # best t
        jnp.full((n,), -1, jnp.int32),              # best prim
        jnp.zeros((n,)),                            # best u
        jnp.zeros((n,)),                            # best v
        jnp.zeros((n,), bool),                      # occluded (any-hit lanes)
    )
    sizes = _stage_sizes_fused(n)
    bt_f, bp_f, bu_f, bv_f, occ_f = state[4:]
    o_s, d_s, t_min_s, t_max_s, ah_s, obj_s = o, d, t_min, t_max, anyhit, obj_rays
    idx_full = None
    for si, size in enumerate(sizes):
        stop = sizes[si + 1] if si + 1 < len(sizes) else 0
        if si > 0:
            node = state[0]
            idx_stage = jnp.nonzero(node != -1, size=size,
                                    fill_value=node.shape[0])[0]
            valid = idx_stage < node.shape[0]
            idx_c = jnp.minimum(idx_stage, node.shape[0] - 1)
            state = _compact_gather(idx_c, valid, *state)
            state = (jnp.where(valid, state[0], -1),) + state[1:]
            o_s, d_s, t_min_s, t_max_s, ah_s = _compact_gather(
                idx_c, valid, o_s, d_s, t_min_s, t_max_s, ah_s)
            if obj_s is not None:
                obj_s = _compact_gather(idx_c, valid, *obj_s)
            idx_full = idx_c if idx_full is None else idx_full[idx_c]
            idx_full = jnp.where(valid, idx_full, n)
        state = run_stage(o_s, d_s, t_min_s, t_max_s, ah_s, obj_s, state, stop)
        if si > 0:
            bt_f = bt_f.at[idx_full].set(state[4], mode="drop")
            bp_f = bp_f.at[idx_full].set(state[5], mode="drop")
            bu_f = bu_f.at[idx_full].set(state[6], mode="drop")
            bv_f = bv_f.at[idx_full].set(state[7], mode="drop")
            occ_f = occ_f.at[idx_full].set(state[8], mode="drop")
        else:
            bt_f, bp_f, bu_f, bv_f, occ_f = state[4:]
    hit = bp_f >= 0
    return jnp.where(hit, bt_f, BIG), bp_f, bu_f, bv_f, occ_f


def bvh_fused_hit(scene: SceneArrays, o, d, t_min, t_max, n_closest: int,
                  obj_rays=None):
    """One traversal serving a closest segment and an any-hit segment.

    The first `n_closest` lanes are closest-hit queries; the rest are
    occlusion queries bounded by their per-lane t_max (semantics of
    bvh_closest_hit / bvh_any_hit respectively). Returns
    ((t, prim, u, v) over [:n_closest], occluded over [n_closest:]).
    Falls back to two separate traversals for BVHs without wide nodes.
    """
    bvh = scene.bvh
    n = o.shape[0]
    nc = n_closest
    if bvh.wide_nodes is not None and bvh.leaf_geom is not None and (
            obj_rays is None or bvh.leaf_anim is not None):
        ah = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) >= nc
        t, prim, u, v, occ = _wide_fused_hit(
            scene, o, d, t_min, t_max, ah, obj_rays=obj_rays)
        return (t[:nc], prim[:nc], u[:nc], v[:nc]), occ[nc:]
    obj_c = obj_s = None
    if obj_rays is not None:
        obj_c = tuple(a[:nc] for a in obj_rays)
        obj_s = tuple(a[nc:] for a in obj_rays)
    closest = bvh_closest_hit(
        scene, o[:nc], d[:nc], t_min[:nc], t_max[:nc], obj_rays=obj_c)
    occ = bvh_any_hit(
        scene, o[nc:], d[nc:], t_min[nc:], t_max[nc:], obj_rays=obj_s)
    return closest, occ


def bvh_closest_hit(scene: SceneArrays, o, d, t_min, t_max, obj_rays=None):
    """Closest hit via the threaded BVH. Returns (t, prim, u, v); prim=-1 miss.

    Node AABBs are world-space (swept over the render interval for animated
    prims at build time); leaves test in object space via `obj_rays`.

    Two-phase lockstep: an inner while_loop walks all lanes to their next hit
    leaf using only the packed node tables; an outer while_loop then pays one
    wide primitive-tile gather per LEAF VISIT, so leaf tiles are paid per
    visit, not per step.
    """
    bvh = scene.bvh
    n = o.shape[0]
    if bvh.wide_nodes is not None and bvh.leaf_geom is not None and (
            obj_rays is None or bvh.leaf_anim is not None):
        return _wide_closest_hit(scene, o, d, t_min, t_max, obj_rays=obj_rays)

    inv_d = jnp.where(jnp.abs(d) > 1e-20, 1.0 / jnp.where(d == 0.0, 1.0, d), BIG)

    init = (
        jnp.zeros((n,), jnp.int32),          # current node
        jnp.full((n,), BIG),                 # best t
        jnp.full((n,), -1, jnp.int32),       # best prim
        jnp.zeros((n,)),                     # best u
        jnp.zeros((n,)),                     # best v
    )

    def cond(state):
        return jnp.any(state[0] >= 0)

    use_packed = bvh.leaf_geom is not None and (
        obj_rays is None or bvh.leaf_anim is not None)
    oct_base = _octant_base(bvh, d)

    def body(state):
        node, bt, bp, bu, bv = state
        node = _walk_to_leaf(bvh, o, inv_d, t_min, node,
                             jnp.minimum(t_max, bt), oct_base)
        on_leaf = node >= 0
        ns = jnp.maximum(node, 0)
        ni = bvh.node_oct[oct_base + ns]
        leaf_row = jnp.where(on_leaf, ni[:, 0], -1)
        if use_packed:
            pids, t_all, u, v, _ = _packed_leaf_tests(
                scene, bvh, o, d, t_min, bt, leaf_row, on_leaf, obj_rays)
            t_all = jnp.where(t_all < bt[:, None], t_all, BIG)
            k = jnp.argmin(t_all, axis=-1)
            rows = jnp.arange(pids.shape[0])
            tk = t_all[rows, k]
            closer = tk < bt
            is_tri_win = pids[rows, k] < scene.n_tris
            bt = jnp.where(closer, tk, bt)
            bp = jnp.where(closer, pids[rows, k], bp)
            bu = jnp.where(closer, jnp.where(is_tri_win, u[rows, k], 0.0), bu)
            bv = jnp.where(closer, jnp.where(is_tri_win, v[rows, k], 0.0), bv)
        else:
            pids = jnp.where(
                on_leaf[:, None], bvh.leaf_prims[jnp.maximum(leaf_row, 0)], -1
            )
            bt, bp, bu, bv = _leaf_intersect(
                scene, o, d, t_min, pids, (bt, bp, bu, bv), obj_rays=obj_rays
            )
        node = jnp.where(on_leaf, ni[:, 2], -1)  # resume at the leaf's miss link
        return node, bt, bp, bu, bv

    node, bt, bp, bu, bv = jax.lax.while_loop(cond, body, init)
    hit = bp >= 0
    return jnp.where(hit, bt, BIG), bp, bu, bv


def bvh_any_hit(scene: SceneArrays, o, d, t_min, t_max, obj_rays=None):
    """Occlusion walk: a lane retires the moment ANY hit lands in
    (t_min, t_max) — no best-t refinement, early exit per lane. Same
    two-phase walk-to-leaf structure as bvh_closest_hit (leaf tiles are paid
    per leaf VISIT, not per step)."""
    bvh = scene.bvh
    n = o.shape[0]
    if bvh.wide_nodes is not None and bvh.leaf_geom is not None and (
            obj_rays is None or bvh.leaf_anim is not None):
        return _wide_any_hit(scene, o, d, t_min, t_max, obj_rays=obj_rays)
    inv_d = jnp.where(jnp.abs(d) > 1e-20, 1.0 / jnp.where(d == 0.0, 1.0, d), BIG)

    init = (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), bool))

    def cond(state):
        return jnp.any(state[0] >= 0)

    use_packed = bvh.leaf_geom is not None and (
        obj_rays is None or bvh.leaf_anim is not None)

    def body(state):
        node, occ = state
        node = _walk_to_leaf(bvh, o, inv_d, t_min, node, t_max)
        on_leaf = node >= 0
        ns = jnp.maximum(node, 0)
        ni = bvh.node_i[ns]
        leaf_row = jnp.where(on_leaf, ni[:, 0], -1)
        if use_packed:
            _, _, _, _, ok = _packed_leaf_tests(
                scene, bvh, o, d, t_min, t_max, leaf_row, on_leaf, obj_rays)
            hit_any = jnp.any(ok, axis=-1)
        else:
            pids = jnp.where(
                on_leaf[:, None], bvh.leaf_prims[jnp.maximum(leaf_row, 0)], -1
            )
            ox, dx = _leaf_rays(scene, o, d, pids, obj_rays)
            hit_any = jnp.zeros((n,), bool)
            if scene.n_tris > 0:
                _, _, _, ok = _leaf_tri_test(scene, ox, dx, pids, t_min, t_max)
                hit_any |= jnp.any(ok, axis=-1)
            if scene.n_spheres > 0:
                _, oks = _leaf_sphere_test(scene, ox, dx, pids, t_min, t_max)
                hit_any |= jnp.any(oks, axis=-1)
        occ = occ | hit_any
        node = jnp.where(on_leaf & ~occ, ni[:, 1], -1)
        return node, occ

    _, occ = jax.lax.while_loop(cond, body, init)
    return occ
