"""BVH construction: primitive AABBs -> threaded flat tree (BVHArrays).

The reference builds a full-sweep SAH tree and flattens it to 32-byte nodes
traversed with an explicit 128-deep stack (``libwurblpt/bvh.hpp:93-246,
277-311``). The batched design replaces the stack with *threading*: nodes are
laid out in DFS pre-order, advancing to ``node + 1`` on an AABB hit and to
``miss_next[node]`` otherwise, so a whole ray batch walks the tree in lockstep
with no per-ray stack (SURVEY.md section 1).

The builder itself is host-side native C++ (``native/src/bvh_builder.cpp``,
binned SAH) with a numpy fallback; both produce identical array layouts.
Leaves occupy exactly LEAF_SIZE slots in ``prim_order`` (padded with -1) so the
device traversal intersects a static-shape primitive tile per leaf step.
"""

from __future__ import annotations

import ctypes
import os
from collections import deque

import numpy as np
import jax.numpy as jnp

from ..scene.ir import BVHArrays

LEAF_SIZE = 4          # small scenes: few prims per leaf keeps tile work low
LEAF_SIZE_LARGE = 64   # big scenes (wide tiles pay off once octant
#                        front-to-back ordering prunes leaf visits)
BVH_WIDTH = 32         # wide-node branching factor (children per wide node):
#                        all W children's AABBs + links in ONE gathered row,
#                        slab-tested vectorized, so one row gather tests W
#                        boxes instead of two gathers testing one.
#                        Both values were tuned on the previous accelerator,
#                        whose gathers were priced per row; they are starting
#                        points, not yet measured on the H100 (ROADMAP S2).


# ---------------------------------------------------------------------------
# Primitive AABBs
# ---------------------------------------------------------------------------

def prim_aabbs(tris_np, spheres_np):
    """AABBs + centroids for the global prim ordering (tris then spheres).

    tris_np: (p0, e1, e2) numpy [T,3] each; spheres_np: (center, radius).
    """
    mins, maxs, cents = [], [], []
    p0, e1, e2 = tris_np
    if p0.shape[0]:
        v1 = p0 + e1
        v2 = p0 + e2
        tmin = np.minimum(np.minimum(p0, v1), v2)
        tmax = np.maximum(np.maximum(p0, v1), v2)
        mins.append(tmin)
        maxs.append(tmax)
        cents.append((tmin + tmax) * 0.5)
    center, radius = spheres_np
    if center.shape[0]:
        r = radius[:, None]
        mins.append(center - r)
        maxs.append(center + r)
        cents.append(center)
    if not mins:
        z = np.zeros((0, 3), np.float32)
        return z, z, z
    return (
        np.concatenate(mins).astype(np.float32),
        np.concatenate(maxs).astype(np.float32),
        np.concatenate(cents).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Native builder (ctypes)
# ---------------------------------------------------------------------------

def _native_lib():
    from ..native import try_load_library

    lib = try_load_library("wurblpt_bvh", ["bvh_builder.cpp"])
    if lib is None:
        return None
    fn = lib.wurblpt_build_bvh
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return fn


def _build_native(amin, amax, cent, leaf_size):
    fn = _native_lib()
    if fn is None:
        return None
    n = amin.shape[0]
    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    prim_start = np.empty((cap,), np.int32)
    prim_count = np.empty((cap,), np.int32)
    miss_next = np.empty((cap,), np.int32)
    prim_order = np.empty((n * leaf_size + leaf_size,), np.int32)
    order_len = ctypes.c_int(0)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    amin = np.ascontiguousarray(amin, np.float32)
    amax = np.ascontiguousarray(amax, np.float32)
    cent = np.ascontiguousarray(cent, np.float32)
    n_nodes = fn(
        p(amin, ctypes.c_float), p(amax, ctypes.c_float), p(cent, ctypes.c_float),
        n, leaf_size,
        p(node_min, ctypes.c_float), p(node_max, ctypes.c_float),
        p(prim_start, ctypes.c_int), p(prim_count, ctypes.c_int),
        p(miss_next, ctypes.c_int), p(prim_order, ctypes.c_int),
        ctypes.byref(order_len),
    )
    if n_nodes <= 0:
        return None
    return (
        node_min[:n_nodes], node_max[:n_nodes], prim_start[:n_nodes],
        prim_count[:n_nodes], miss_next[:n_nodes], prim_order[: order_len.value],
    )


# ---------------------------------------------------------------------------
# Numpy fallback builder (same layout, median/binned-SAH hybrid)
# ---------------------------------------------------------------------------

def _build_numpy(amin, amax, cent, leaf_size):
    n = amin.shape[0]
    node_min, node_max = [], []
    prim_start, prim_count, right_child = [], [], []
    order = []

    def half_area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    # (begin, end, parent_slot); pre-order emission like the native builder.
    stack = [(np.arange(n), -1)]
    while stack:
        idx, parent_slot = stack.pop()
        self_i = len(node_min)
        if parent_slot >= 0:
            right_child[parent_slot] = self_i
        bmin = amin[idx].min(0)
        bmax = amax[idx].max(0)
        node_min.append(bmin)
        node_max.append(bmax)
        right_child.append(-1)
        if idx.size <= leaf_size:
            prim_start.append(len(order))
            prim_count.append(idx.size)
            order.extend(idx.tolist())
            order.extend([-1] * (leaf_size - idx.size))
            continue
        prim_start.append(-1)
        prim_count.append(0)
        c = cent[idx]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            half = idx.size // 2
            part = np.argsort(c[:, axis], kind="stable")
            left, right = idx[part[:half]], idx[part[half:]]
        else:
            nb = 16
            bins = np.clip(
                ((c[:, axis] - c[:, axis].min()) / ext[axis] * nb).astype(np.int32),
                0, nb - 1,
            )
            best_cost, best_b = np.inf, -1
            for b in range(nb - 1):
                lm = bins <= b
                nl = int(lm.sum())
                if nl == 0 or nl == idx.size:
                    continue
                cost = half_area(amin[idx[lm]].min(0), amax[idx[lm]].max(0)) * nl + \
                    half_area(amin[idx[~lm]].min(0), amax[idx[~lm]].max(0)) * (idx.size - nl)
                if cost < best_cost:
                    best_cost, best_b = cost, b
            if best_b < 0:
                half = idx.size // 2
                part = np.argsort(c[:, axis], kind="stable")
                left, right = idx[part[:half]], idx[part[half:]]
            else:
                lm = bins <= best_b
                left, right = idx[lm], idx[~lm]
        stack.append((right, self_i))
        stack.append((left, -1))

    n_nodes = len(node_min)
    # Thread miss links over the pre-order layout.
    miss = np.full((n_nodes,), -1, np.int32)
    tstack = [(0, -1)]
    rc = np.asarray(right_child, np.int32)
    pc = np.asarray(prim_count, np.int32)
    while tstack:
        ni, m = tstack.pop()
        miss[ni] = m
        if pc[ni] == 0:
            tstack.append((rc[ni], m))
            tstack.append((ni + 1, rc[ni]))
    return (
        np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
        np.asarray(prim_start, np.int32), pc, miss,
        np.asarray(order, np.int32),
    )


# ---------------------------------------------------------------------------
# Wide-node collapse (binary SAH tree -> W-ary single-row nodes)
# ---------------------------------------------------------------------------

def _collapse_wide(built, leaf_size: int, width: int):
    """Collapse the binary builder output into a W-ary BVH packed for ONE
    row gather per traversal step.

    The reference's stack traversal touches one binary node per step
    (``bvh.hpp:277-311``); in a lockstep batch each touch is a row gather,
    so a W-wide node — all children's AABBs and links in one contiguous
    row — tests W boxes for the price of one gather. Collapse
    policy (Wald-style): starting from a binary node's two children, keep
    replacing the largest-surface-area inner member with its own children
    until W members exist. Each member becomes either a leaf slot or a new
    wide node.

    Returns (rows [M, W*7] f32, stack_depth int). Row layout per child j:
    ``rows[m, 7j:7j+6]`` = AABB min/max, ``rows[m, 7j+6]`` = int32 link
    bitcast to f32: ``>= 0`` wide child id, ``<= -2`` leaf (leaf_row =
    -link - 2), ``-1`` empty slot (box is +inf/-inf so the slab test
    misses).
    """
    node_min, node_max, prim_start, prim_count, miss_next, _ = built
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    prim_count = np.asarray(prim_count, np.int32)
    n = prim_count.shape[0]
    is_leaf = prim_count > 0
    child1 = np.where(~is_leaf, np.arange(n, dtype=np.int32) + 1, -1)
    child2 = np.full(n, -1, np.int32)
    inner = ~is_leaf
    child2[inner] = np.asarray(miss_next, np.int32)[child1[inner]]
    assert (child2[inner] >= 0).all(), "binary layout violation: single-child inner node"
    leaf_row = np.where(is_leaf, np.asarray(prim_start, np.int32) // leaf_size, -1)
    ext = np.maximum(node_max - node_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    members_of = []          # wide id -> list of binary member ids
    wid_of = {}
    q = deque()
    if is_leaf[0]:
        members_of.append([0])
    else:
        wid_of[0] = 0
        members_of.append(None)
        q.append(0)
    depth_of = {0: 1}
    max_depth = 1
    while q:
        b = q.popleft()
        w = wid_of[b]
        members = [child1[b], child2[b]]
        while len(members) < width:
            cand = [m for m in members if not is_leaf[m]]
            if not cand:
                break
            m = max(cand, key=lambda x: area[x])
            members.remove(m)
            members.append(child1[m])
            members.append(child2[m])
        members_of[w] = members
        d = depth_of[w] + 1
        for m in members:
            if not is_leaf[m]:
                wid_of[m] = len(members_of)
                depth_of[len(members_of)] = d
                max_depth = max(max_depth, d)
                members_of.append(None)
                q.append(m)

    M = len(members_of)
    rows = np.zeros((M, width, 7), np.float32)
    rows[..., 0:3] = np.inf
    rows[..., 3:6] = -np.inf
    links = np.full((M, width), -1, np.int32)
    for w, members in enumerate(members_of):
        for j, m in enumerate(members):
            rows[w, j, 0:3] = node_min[m]
            rows[w, j, 3:6] = node_max[m]
            links[w, j] = (-2 - leaf_row[m]) if is_leaf[m] else wid_of[m]
    # Exact float VALUES, not bitcast bit patterns: small ids bitcast to f32
    # denormals, which XLA backends may flush to zero in some op sequences.
    # All links are well inside +-2^24 so the float round-trips exactly
    # (asserted).
    assert np.abs(links).max(initial=0) < (1 << 24)
    rows[..., 6] = links.astype(np.float32)
    # EXACT worst-case stack need, not the max_depth * (W-1) bound: a node
    # pushes (cnt - 1) entries before descending, so the true maximum is the
    # deepest root-to-node path sum of (cnt - 1). The stack ops are O(N * D)
    # memory traffic per step (traverse._stack_push_sorted), so D is a direct
    # cost knob — the exact bound is typically several times tighter at
    # large W (DP below, bottom-up over the wide DAG).
    n_children = np.array([len(m) for m in members_of], np.int64)
    bound = np.zeros(M, np.int64)
    for w in range(M - 1, -1, -1):
        kid_max = 0
        for m in members_of[w]:
            if not is_leaf[m]:
                kid_max = max(kid_max, bound[wid_of[m]])
        bound[w] = (n_children[w] - 1) + kid_max
    stack_depth = int(bound[0]) + 2
    return rows.reshape(M, width * 7), stack_depth


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def pack_bvh(built, leaf_size: int, tris_np=None, spheres_np=None,
             tri_anim=None, sph_anim=None) -> BVHArrays:
    """Pack a builder's flat arrays into the gather-friendly BVHArrays layout
    (one f32 + one i32 gather per traversal step; 2-D leaf tile).

    With `tris_np`/`spheres_np`, leaf geometry is REPLICATED into contiguous
    [L, K, 9] rows (leaf_geom) so each leaf visit is one contiguous row
    gather per lane instead of K per-prim gathers. tris_np may be (p0, e1, e2) or
    (p0, e1, e2, v1, v2); absolute v1/v2 preserve watertightness.
    """
    node_min, node_max, prim_start, prim_count, miss_next, prim_order = built
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    node_f = np.concatenate([node_min, node_max], 1)
    prim_start = np.asarray(prim_start, np.int32)
    prim_count = np.asarray(prim_count, np.int32)
    miss_next = np.asarray(miss_next, np.int32)
    # Leaves occupy exactly leaf_size slots in prim_order -> row index.
    leaf_row = np.where(prim_count > 0, prim_start // leaf_size, -1).astype(np.int32)
    node_i = np.stack([leaf_row, miss_next], 1)
    order = np.asarray(prim_order, np.int32)
    assert order.size % leaf_size == 0
    leaf_prims = order.reshape(-1, leaf_size)

    node_oct = _octant_links(node_min, node_max, leaf_row, miss_next)

    leaf_geom = leaf_anim = None
    if tris_np is not None:
        if len(tris_np) == 5:
            p0, e1, e2, v1, v2 = tris_np
        else:
            p0, e1, e2 = tris_np
            v1, v2 = p0 + e1, p0 + e2
        center, radius = spheres_np if spheres_np is not None else (
            np.zeros((0, 3), np.float32), np.zeros((0,), np.float32))
        n_tri = p0.shape[0]
        pid = np.maximum(leaf_prims, 0)
        is_tri = (leaf_prims >= 0) & (pid < n_tri)
        is_sph = leaf_prims >= n_tri
        L, K = leaf_prims.shape
        geom = np.zeros((L, K, 9), np.float32)
        if n_tri:
            ti = np.clip(pid, 0, n_tri - 1)
            tg = np.concatenate([p0[ti], v1[ti], v2[ti]], -1)
            geom = np.where(is_tri[..., None], tg, geom)
        if radius.shape[0]:
            si = np.clip(pid - n_tri, 0, radius.shape[0] - 1)
            sg = np.zeros((L, K, 9), np.float32)
            sg[..., 0:3] = center[si]
            sg[..., 3] = radius[si]
            geom = np.where(is_sph[..., None], sg, geom)
        leaf_geom = jnp.asarray(geom)
        if tri_anim is not None or sph_anim is not None:
            ta = (np.asarray(tri_anim, np.int32) if tri_anim is not None
                  else np.zeros((n_tri,), np.int32))
            sa = (np.asarray(sph_anim, np.int32) if sph_anim is not None
                  else np.zeros((radius.shape[0],), np.int32))
            alla = np.concatenate([ta, sa])
            leaf_anim = jnp.asarray(
                np.where(leaf_prims >= 0, alla[np.clip(pid, 0, max(alla.size - 1, 0))], 0)
                .astype(np.int32))

    wide_nodes = wide_meta = None
    if os.environ.get("WURBLPT_BVH_WIDE", "1") != "0":
        width = int(os.environ.get("WURBLPT_BVH_WIDTH", str(BVH_WIDTH)))
        wrows, stack_depth = _collapse_wide(built, leaf_size, width)
        wide_nodes = jnp.asarray(wrows)
        wide_meta = jnp.zeros((stack_depth,), jnp.uint8)

    return BVHArrays(
        node_f=jnp.asarray(node_f),
        node_i=jnp.asarray(node_i),
        leaf_prims=jnp.asarray(leaf_prims),
        leaf_geom=leaf_geom,
        leaf_anim=leaf_anim,
        node_oct=jnp.asarray(node_oct),
        wide_nodes=wide_nodes,
        wide_meta=wide_meta,
    )


def _octant_links(node_min, node_max, leaf_row, miss_next):
    """Per-octant FRONT-TO-BACK threading: [8, N, 3] (leaf_row, hit, miss).

    The pre-order threading visits children in layout order regardless of ray
    direction; a ray travelling "backwards" along a node's split axis then
    finds its closest hit LAST and prunes nothing. Re-threading the same tree
    once per direction octant makes every walk near-child-first, so best_t
    terminates far subtrees early (the stack traversal's classic ordering,
    bvh.hpp:277-311, recovered without a stack). Child pairs are recovered
    from the pre-order layout (first child = n+1, second = miss link of the
    first), the split axis from the children's box centers.
    """
    n = node_min.shape[0]
    is_leaf = leaf_row >= 0
    child1 = np.where(~is_leaf, np.arange(n, dtype=np.int32) + 1, -1)
    child2 = np.full(n, -1, np.int32)
    inner = ~is_leaf
    child2[inner] = miss_next[child1[inner]]
    # Every inner node must have exactly two children in the pre-order
    # layout; a single-child node would make child2 = -1 and the threading
    # loop below would silently corrupt miss[-1]/hit[-1] for all octants.
    assert (child2[inner] >= 0).all(), "binary layout violation: single-child inner node"
    centers = 0.5 * (node_min + node_max)
    axis = np.zeros(n, np.int32)
    ci = child1[inner]
    cj = child2[inner]
    axis[inner] = np.argmax(np.abs(centers[cj] - centers[ci]), axis=1)
    # Which child is LOWER along the split axis (don't assume builder order).
    c1s = np.maximum(child1, 0)
    c2s = np.maximum(child2, 0)
    c1_lower = (centers[c1s, axis] <= centers[c2s, axis])

    out = np.empty((8, n, 3), np.int32)
    for oct_ in range(8):
        neg = [(oct_ >> a) & 1 for a in range(3)]  # bit a: dir[a] < 0
        hit = np.full(n, -1, np.int32)
        miss = np.full(n, -1, np.int32)
        # iterative threading with explicit stack: (node, miss_link)
        stack = [(0, -1)]
        while stack:
            nd, m = stack.pop()
            miss[nd] = m
            if is_leaf[nd]:
                hit[nd] = m  # after the leaf tile, continue at the miss link
                continue
            a, b = child1[nd], child2[nd]
            # near child first: the lower child when the ray dir is positive
            # along the split axis, the upper child otherwise.
            lower_child, upper_child = (a, b) if c1_lower[nd] else (b, a)
            flip = neg[axis[nd]] == 1
            first, second = (upper_child, lower_child) if flip else (lower_child, upper_child)
            hit[nd] = first
            stack.append((second, m))
            stack.append((first, second))
        out[oct_, :, 0] = leaf_row
        out[oct_, :, 1] = hit
        out[oct_, :, 2] = miss
    return out.reshape(8 * n, 3)


def build_bvh_arrays(tris_np, spheres_np, leaf_size: int = None,
                     aabb_override=None, tri_anim=None, sph_anim=None) -> BVHArrays:
    """Build BVHArrays from numpy geometry (see prim_aabbs for inputs).

    aabb_override: optional (amin, amax) replacing the computed prim boxes —
    used for animated prims whose world boxes are swept over the render
    interval (reference Scene::updateBVH(t0, t1), scene.hpp:151-169).

    leaf_size: leaf tile width K (None = scale with the scene; see
    LEAF_SIZE_LARGE).
    """
    amin, amax, cent = prim_aabbs(tris_np[:3], spheres_np)
    if aabb_override is not None:
        amin, amax = aabb_override
        cent = (amin + amax) * 0.5
    if amin.shape[0] == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    if leaf_size is None:
        env_leaf = os.environ.get("WURBLPT_BVH_LEAF")
        if env_leaf:
            leaf_size = int(env_leaf)
        else:
            leaf_size = LEAF_SIZE if amin.shape[0] < 4096 else LEAF_SIZE_LARGE
    built = _build_native(amin, amax, cent, leaf_size)
    if built is None:
        built = _build_numpy(amin, amax, cent, leaf_size)
    return pack_bvh(built, leaf_size, tris_np=tris_np, spheres_np=spheres_np,
                    tri_anim=tri_anim, sph_anim=sph_anim)
