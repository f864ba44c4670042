"""Ray-scene intersection as ONE matrix product (the brute-force cast).

The reference walks a BVH and evaluates Moller-Trumbore per (ray, triangle)
pair with scalar code (``hitable_triangle.hpp:189-274``). Batched per-pair
elementwise evaluation would materialize [N, T, 3] temporaries in device
memory, so here the intersection *is* a matmul (the module name records the
matrix unit of the accelerator it was first written for):

Every MT determinant is trilinear in (ray origin o, ray direction d) and the
triangle's (p0, e1, e2). With the ray feature vector

    r = [1, o, d, o x d, |o|^2, o . d]      (12 floats)

each of det / t_num / u_num / v_num is a LINEAR functional of r with
per-triangle coefficients (n = e1 x e2):

    det   = -d . n
    t_num = (o - p0) . n              =  o . n      - (p0 . n)
    u_num = det(o - p0, d, e2)        = (o x d) . e2 + d . (p0 x e2)
    v_num = -det(o - p0, d, e1)       = -(o x d) . e1 - d . (p0 x e1)

and the sphere quadratic's (half_b, c) are linear too:

    half_b = (o . d) - d . c
    c_q    = |o|^2 - 2 o . c + (|c|^2 - r^2)

so ONE [N, 12] @ [12, 4*T + 2*S] matmul (f32, precision=HIGHEST) computes
every ray/primitive test; a fused elementwise decode + min-reduction finds the
closest hit. No gathers, no [N, T, 3] temporaries. The product is plain
`lax`, left to XLA; HIGHEST precision keeps it out of TF32 on a GPU. With K=12
it is bound by memory bytes, not FLOPs, on the H100 (the [N, cols] product is
written and read back by the decode). Rays and primitives are translated by a
scene-center offset first so the
o x d cancellation error stays bounded by the scene extent (not the distance
to the world origin).

Hit ATTRIBUTE assembly uses the same trick: the winning one-hot [N, T]
(exact 0/1 floats) times a per-triangle attribute matrix [T, F] interpolates
normals/uv/tangents with a matmul instead of row gathers.

Used for moderate primitive counts (total padded columns <= MXU_MAX_PRIMS) in
non-animated scenes; larger scenes go through the BVH path (accel/traverse).
The crossover was set on the previous accelerator and is not yet measured on
the H100 (ROADMAP S4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..core.onb import onb_from_normal
from ..core.vecmath import cross, dot, normalize, safe_sqrt
from ..scene.ir import SceneArrays

# Host scalar, NOT jnp: a module-level device array becomes a hoisted
# const_arg in every program that closes over it (jax 0.9.0 drops those
# on cross-program re-dispatch; see tests/conftest.py).
BIG = np.float32(3.0e37)
MXU_MAX_PRIMS = 2048          # beyond this, the BVH path is used (ROADMAP S4)
_HI = jax.lax.Precision.HIGHEST


def _pad_rows(x, k):
    pad = k - x.shape[0]
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], 0)


class MxuScene(NamedTuple):
    """Loop-invariant matmul operands, built once per trace."""

    feat: jnp.ndarray      # [12, 4*Kt + 2*Ks] primitive feature matrix
    attr: jnp.ndarray      # [Kt, F] triangle attribute matrix (None-size 0 ok)
    center: jnp.ndarray    # [3] scene centering offset
    kt: int                # padded triangle count
    ks: int                # padded sphere count
    n_tris: int
    n_spheres: int


def build_mxu_scene(scene: SceneArrays) -> MxuScene:
    """Precompute the primitive feature + attribute matrices (jit-traceable)."""
    nt, ns = scene.n_tris, scene.n_spheres
    # Lane-pad each primitive class to a multiple of 128.
    kt = max(-(-nt // 128) * 128, 0) if nt else 0
    ks = max(-(-ns // 128) * 128, 0) if ns else 0

    # Scene center: static mean of primitive reference points.
    pts = []
    if nt:
        pts.append(scene.tris.p0)
    if ns:
        pts.append(scene.spheres.center)
    center = jnp.concatenate(pts, 0).mean(0)

    cols = []
    if nt:
        p0 = _pad_rows(scene.tris.p0 - center, kt)
        e1 = _pad_rows(scene.tris.e1, kt)
        e2 = _pad_rows(scene.tris.e2, kt)
        n = jnp.cross(e1, e2)
        zero = jnp.zeros((kt,))
        z3 = jnp.zeros((kt, 3))
        # feature rows: [1, o(3), d(3), oxd(3), |o|^2, o.d] = 12
        det_col = jnp.concatenate(
            [zero[:, None], z3, -n, z3, zero[:, None], zero[:, None]], 1)
        t_col = jnp.concatenate(
            [-jnp.sum(p0 * n, 1, keepdims=True), n, z3, z3,
             zero[:, None], zero[:, None]], 1)
        u_col = jnp.concatenate(
            [zero[:, None], z3, jnp.cross(p0, e2), e2,
             zero[:, None], zero[:, None]], 1)
        v_col = jnp.concatenate(
            [zero[:, None], z3, -jnp.cross(p0, e1), -e1,
             zero[:, None], zero[:, None]], 1)
        # grouped blocks [det | t | u | v], each kt wide: the decode then works
        # on contiguous [N, kt] slices (no strided relayout).
        tri_feat = jnp.concatenate([det_col, t_col, u_col, v_col], 0)  # [4kt, 12]
        cols.append(tri_feat)
    if ns:
        c = _pad_rows(scene.spheres.center - center, ks)
        r = _pad_rows(scene.spheres.radius, ks)
        zero = jnp.zeros((ks,))
        z3 = jnp.zeros((ks, 3))
        hb_col = jnp.concatenate(
            [zero[:, None], z3, -c, z3, zero[:, None], jnp.ones((ks, 1))], 1)
        cq_col = jnp.concatenate(
            [(jnp.sum(c * c, 1) - r * r)[:, None], -2.0 * c, z3, z3,
             jnp.ones((ks, 1)), zero[:, None]], 1)
        sph_feat = jnp.concatenate([hb_col, cq_col], 0)  # [2ks, 12] grouped
        cols.append(sph_feat)

    feat = jnp.concatenate(cols, 0).T  # [12, 4kt + 2ks]

    # Triangle attribute matrix for matmul hit assembly:
    # [n0 n1 n2 | uv0 uv1 uv2 | tan0 tan1 tan2 | gn | mat flags] = 9+6+9+3+2 = 29
    if nt:
        T = scene.tris
        gn_all = normalize(jnp.cross(T.e1, T.e2))
        attr = jnp.concatenate(
            [T.n0, T.n1, T.n2,
             T.uv0, T.uv1, T.uv2,
             T.tan0, T.tan1, T.tan2,
             gn_all,
             T.mat[:, None].astype(jnp.float32),
             T.flags[:, None].astype(jnp.float32)], 1)
        attr = _pad_rows(attr, kt)
    else:
        attr = jnp.zeros((0, 29))

    return MxuScene(feat=feat, attr=attr, center=center, kt=kt, ks=ks,
                    n_tris=nt, n_spheres=ns)


def _ray_features(o, d):
    oxd = jnp.cross(o, d)
    return jnp.concatenate(
        [jnp.ones(o.shape[:-1] + (1,)), o, d, oxd,
         jnp.sum(o * o, -1, keepdims=True), jnp.sum(o * d, -1, keepdims=True)],
        -1)


def mxu_closest_hit(ms: MxuScene, o, d, t_min, t_max):
    """Closest hit over all primitives. Returns (t, prim, u, v, onehot_tri).

    prim = -1 on miss; prim in [0, n_tris) for triangles, n_tris + j for
    spheres. onehot_tri [N, kt] marks the winning triangle (all-zero rows for
    sphere hits / misses) and feeds the attribute matmul.
    """
    oc = o - ms.center
    r = _ray_features(oc, d)                       # [N, 12]
    prod = jax.lax.dot_general(
        r, ms.feat, (((1,), (0,)), ((), ())), precision=_HI)  # [N, 4kt+2ks]
    return _decode_closest(ms, prod, d, t_min, t_max)


def _decode_closest(ms: MxuScene, prod, d, t_min, t_max):
    """Closest-hit decode of the feature-matmul product rows."""
    n = prod.shape[0]
    best_t = jnp.full((n,), BIG)
    best_prim = jnp.full((n,), -1, jnp.int32)
    best_u = jnp.zeros((n,))
    best_v = jnp.zeros((n,))
    onehot = None

    if ms.kt:
        kt = ms.kt
        det = prod[:, 0 * kt:1 * kt]
        tn = prod[:, 1 * kt:2 * kt]
        un = prod[:, 2 * kt:3 * kt]
        vn = prod[:, 3 * kt:4 * kt]
        s = jnp.sign(det)
        ad = jnp.abs(det)
        k_ids = jax.lax.broadcasted_iota(jnp.int32, (n, kt), 1)
        valid = (
            (ad > 1e-12)
            & (un * s >= 0.0)
            & (vn * s >= 0.0)
            & ((un + vn) * s <= ad)
            & (tn * s > t_min[:, None] * ad)
            & (tn * s < t_max[:, None] * ad)
            & (k_ids < ms.n_tris)
        )
        t_all = jnp.where(valid, tn / jnp.where(det == 0.0, 1.0, det), BIG)
        # Winner selection without row gathers: min + one-hot
        # mask reductions; ties broken toward the lowest prim id.
        tk = jnp.min(t_all, 1)
        hit_tri = tk < best_t
        oh = t_all <= tk[:, None]          # ties possible, resolved below
        k = jnp.min(jnp.where(oh, k_ids, jnp.int32(0x7FFFFFFF)), 1)
        onehot = (k_ids == k[:, None]) & hit_tri[:, None]
        inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
        u_all = un * inv_det
        v_all = vn * inv_det
        ohf = onehot.astype(t_all.dtype)
        best_u = jnp.sum(u_all * ohf, 1)
        best_v = jnp.sum(v_all * ohf, 1)
        best_t = jnp.where(hit_tri, tk, best_t)
        best_prim = jnp.where(hit_tri, k, best_prim)

    if ms.ks:
        sph0 = 4 * ms.kt
        half_b = prod[:, sph0:sph0 + ms.ks]
        cq = prod[:, sph0 + ms.ks:sph0 + 2 * ms.ks]
        a = jnp.sum(d * d, -1)[:, None]
        disc = half_b * half_b - a * cq
        sq = safe_sqrt(disc)
        q = -(half_b + jnp.sign(half_b) * sq)
        t0 = q / jnp.maximum(a, 1e-20)
        t1 = cq / jnp.where(jnp.abs(q) > 1e-20, q, 1.0)
        tlo = jnp.minimum(t0, t1)
        thi = jnp.maximum(t0, t1)
        ts = jnp.where(tlo > t_min[:, None], tlo, thi)
        j_ids = jax.lax.broadcasted_iota(jnp.int32, (n, ms.ks), 1)
        valids = (
            (disc > 0.0)
            & (ts > t_min[:, None])
            & (ts < t_max[:, None])
            & (j_ids < ms.n_spheres)
        )
        ts = jnp.where(valids, ts, BIG)
        tj = jnp.min(ts, 1)
        ohs = ts <= tj[:, None]
        j = jnp.min(jnp.where(ohs, j_ids, jnp.int32(0x7FFFFFFF)), 1)
        closer = tj < best_t
        best_prim = jnp.where(closer, ms.n_tris + j, best_prim)
        best_t = jnp.where(closer, tj, best_t)
        best_u = jnp.where(closer, 0.0, best_u)
        best_v = jnp.where(closer, 0.0, best_v)
        if onehot is not None:
            onehot = onehot & ~closer[:, None]

    if onehot is None:
        onehot = jnp.zeros((n, max(ms.kt, 1)), bool)
    return best_t, best_prim, best_u, best_v, onehot


def mxu_any_hit(ms: MxuScene, o, d, t_min, t_max):
    """Occlusion test: True where ANY primitive is hit in (t_min, t_max).

    Same feature matmul as `mxu_closest_hit` but the decode is a pure OR
    reduction — no winner selection, no one-hot, no u/v division. Shadow rays
    with a known target distance (lights_sample t_expected) use this instead
    of paying closest-hit cost (the reference only needs the blocker when it
    is NEARER than the light, wurblpt.hpp:203-217).
    """
    oc = o - ms.center
    r = _ray_features(oc, d)
    prod = jax.lax.dot_general(
        r, ms.feat, (((1,), (0,)), ((), ())), precision=_HI)
    return _decode_any(ms, prod, d, t_min, t_max)


def _decode_any(ms: MxuScene, prod, d, t_min, t_max):
    """Pure-OR occlusion decode of the feature-matmul product rows."""
    n = prod.shape[0]
    occluded = jnp.zeros((n,), bool)
    if ms.kt:
        kt = ms.kt
        det = prod[:, 0 * kt:1 * kt]
        tn = prod[:, 1 * kt:2 * kt]
        un = prod[:, 2 * kt:3 * kt]
        vn = prod[:, 3 * kt:4 * kt]
        s = jnp.sign(det)
        ad = jnp.abs(det)
        k_ids = jax.lax.broadcasted_iota(jnp.int32, (n, kt), 1)
        valid = (
            (ad > 1e-12)
            & (un * s >= 0.0)
            & (vn * s >= 0.0)
            & ((un + vn) * s <= ad)
            & (tn * s > t_min[:, None] * ad)
            & (tn * s < t_max[:, None] * ad)
            & (k_ids < ms.n_tris)
        )
        occluded |= jnp.any(valid, 1)
    if ms.ks:
        sph0 = 4 * ms.kt
        half_b = prod[:, sph0:sph0 + ms.ks]
        cq = prod[:, sph0 + ms.ks:sph0 + 2 * ms.ks]
        a = jnp.sum(d * d, -1)[:, None]
        disc = half_b * half_b - a * cq
        sq = safe_sqrt(disc)
        q = -(half_b + jnp.sign(half_b) * sq)
        t0 = q / jnp.maximum(a, 1e-20)
        t1 = cq / jnp.where(jnp.abs(q) > 1e-20, q, 1.0)
        tlo = jnp.minimum(t0, t1)
        thi = jnp.maximum(t0, t1)
        ts = jnp.where(tlo > t_min[:, None], tlo, thi)
        j_ids = jax.lax.broadcasted_iota(jnp.int32, (n, ms.ks), 1)
        valids = (
            (disc > 0.0)
            & (ts > t_min[:, None])
            & (ts < t_max[:, None])
            & (j_ids < ms.n_spheres)
        )
        occluded |= jnp.any(valids, 1)
    return occluded


def mxu_fused_hit(ms: MxuScene, o, d, t_min, t_max, n_closest: int):
    """ONE feature matmul serving a closest segment and an any-hit segment.

    The first `n_closest` rows are closest-hit queries (winner-selection
    decode), the rest occlusion queries (pure-OR decode). Merging a bounce's
    closest cast with its deferred NEE shadow casts halves the per-cast
    launch/stage overhead and runs one [N_total, 12] matmul
    instead of two smaller ones. Returns
    ((t, prim, u, v, onehot) over [:n_closest], occluded over [n_closest:]).
    """
    oc = o - ms.center
    r = _ray_features(oc, d)
    prod = jax.lax.dot_general(
        r, ms.feat, (((1,), (0,)), ((), ())), precision=_HI)
    closest = _decode_closest(
        ms, prod[:n_closest], d[:n_closest], t_min[:n_closest],
        t_max[:n_closest])
    occ = _decode_any(
        ms, prod[n_closest:], d[n_closest:], t_min[n_closest:],
        t_max[n_closest:])
    return closest, occ


def mxu_tri_attrs(ms: MxuScene, onehot, u, v):
    """Interpolated triangle attributes via the one-hot attribute matmul.

    Returns (normal, geom_normal, uv, tangent, mat, flags, valid_tri) where
    rows with all-zero onehot produce zeros (callers select sphere attrs).
    """
    oh = onehot.astype(jnp.float32)
    A = jax.lax.dot_general(
        oh, ms.attr, (((1,), (0,)), ((), ())), precision=_HI)  # [N, 29]
    n0, n1, n2 = A[:, 0:3], A[:, 3:6], A[:, 6:9]
    uv0, uv1, uv2 = A[:, 9:11], A[:, 11:13], A[:, 13:15]
    t0, t1, t2 = A[:, 15:18], A[:, 18:21], A[:, 21:24]
    gn = A[:, 24:27]
    mat = A[:, 27].astype(jnp.int32)
    flags = A[:, 28].astype(jnp.int32)

    w = (1.0 - u - v)[:, None]
    uu = u[:, None]
    vv = v[:, None]
    n_interp = normalize(w * n0 + uu * n1 + vv * n2)
    uv_out = w * uv0 + uu * uv1 + vv * uv2
    tan_raw = w * t0 + uu * t1 + vv * t2
    has_tan = (flags & 2) > 0
    tan_gs = tan_raw - dot(tan_raw, n_interp, keepdims=True) * n_interp
    tan_len = safe_sqrt(dot(tan_gs, tan_gs))
    tan_fb, _ = onb_from_normal(n_interp)
    tangent = jnp.where(
        (has_tan & (tan_len > 1e-8))[:, None],
        tan_gs / jnp.maximum(tan_len, 1e-20)[:, None],
        tan_fb,
    )
    valid = jnp.any(onehot, 1)
    return n_interp, gn, uv_out, tangent, mat, flags, valid
