"""Ray-primitive intersection for the wavefront integrator.

The reference intersects through virtual ``Hitable::hit`` calls under a stack-based
BVH traversal (``bvh.hpp:277-311``, ``hitable_triangle.hpp:189-274``,
``hitable_sphere.hpp:128-151``). Here a whole ray batch is intersected against
primitive *tiles*: a [RAYS x TILE] broadcasted test is elementwise work that XLA
fuses well; a `lax.fori_loop` over tiles keeps peak memory bounded. For scenes
beyond ~100k primitives the threaded-BVH path (:mod:`wurblpt_tpu.accel`) culls
tiles first.

Triangle tests: `watertight_tri` implements Woop's watertight test with the
reference's f64 edge fallback re-expressed as two-product-compensated f32
(hitable_triangle.hpp:189-274; SURVEY.md section 7 "watertight without
doubles") — it is the test used by the BVH leaf path (accel/traverse), which
serves every mesh-scale scene. The Moller-Trumbore tile test remains for the
brute-force sweep and the matmul intersector (intersect_mxu), whose single-matmul
formulation is inherently MT-shaped; small scenes that route there have no
shared-edge meshes of consequence, and parity holds on the benchmark scenes.

All functions are differentiable; hit distances and barycentrics carry gradients
to the vertex data.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import numpy as np
import jax.numpy as jnp

from ..core.onb import onb_from_normal
from ..core.vecmath import cross, dot, matvec, normalize, safe_sqrt
from ..scene.ir import SceneArrays, Triangles

# Host scalar, NOT jnp: a module-level device array becomes a hoisted
# const_arg in every program that closes over it (jax 0.9.0 drops those
# on cross-program re-dispatch; see tests/conftest.py).
BIG = np.float32(3.0e37)
TRI_TILE = 1024


class HitRecord(NamedTuple):
    """Per-ray hit data (reference HitRecord, ``hitable.hpp:39-64``)."""

    t: jnp.ndarray          # [N] hit distance (BIG = miss)
    hit: jnp.ndarray        # [N] bool
    prim: jnp.ndarray       # [N] int32 global prim id (tri: i, sphere: T + j)
    position: jnp.ndarray   # [N, 3]
    normal: jnp.ndarray     # [N, 3] shading normal (front-facing)
    geom_normal: jnp.ndarray  # [N, 3] geometric normal (front-facing)
    tangent: jnp.ndarray    # [N, 3]
    uv: jnp.ndarray         # [N, 2]
    backside: jnp.ndarray   # [N] bool
    mat: jnp.ndarray        # [N] int32


# ---------------------------------------------------------------------------
# Watertight triangle test (Woop/Benthin/Wald, f32 + two-product fallback)
# ---------------------------------------------------------------------------

def _two_prod(a, b):
    """Dekker/Veltkamp exact product: a*b == p + err in f32 (no FMA needed).

    The device path stays in f32; the reference's double-precision edge fallback
    (hitable_triangle.hpp:240-250) becomes error-compensated f32 (SURVEY.md
    section 7 "watertight without doubles"). The 4097 splitter is 2^12+1 for
    f32's 24-bit mantissa."""
    p = a * b
    c = jnp.float32(4097.0)
    ac = a * c
    ah = ac - (ac - a)
    al = a - ah
    bc = b * c
    bh = bc - (bc - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _diff_of_products(a, b, c, d):
    """a*b - c*d with compensated f32: faithful even under catastrophic
    cancellation (the sign is as reliable as the reference's f64 recompute)."""
    p1, e1 = _two_prod(a, b)
    p2, e2 = _two_prod(c, d)
    return (p1 - p2) + (e1 - e2)


def watertight_tri(o, d, v0, v1, v2, t_min, t_max):
    """Watertight ray/triangle test (hitable_triangle.hpp:189-274 semantics).

    o, d: [..., 3] ray (broadcast against vertex shapes); v0/v1/v2: [..., 3]
    ABSOLUTE vertex positions (shared vertices must be bit-identical across
    neighboring triangles for watertightness — hence Triangles.v1/v2, not
    p0+e1). t_min/t_max broadcast to the result shape. Returns
    (t, u, v, valid) with u, v the barycentric weights of v1, v2.

    The shear/scale transform and scaled edge functions U, V, W follow Woop's
    Listing 2; where any |edge| falls under the reference's long-double
    epsilon the edge functions are recomputed with two-product compensation
    instead of f64 (exact to f32 rounding of the true value).
    """
    ad = jnp.abs(d)
    kz = jnp.argmax(ad, axis=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = jnp.take_along_axis(d, kz[..., None], -1)[..., 0]
    # swap kx <-> ky when d[kz] < 0 to preserve winding
    neg = dz < 0
    kx, ky = jnp.where(neg, ky, kx), jnp.where(neg, kx, ky)
    dx = jnp.take_along_axis(d, kx[..., None], -1)[..., 0]
    dy = jnp.take_along_axis(d, ky[..., None], -1)[..., 0]
    Sz = 1.0 / dz
    Sx = dx * Sz
    Sy = dy * Sz

    def shear(p):
        rel = p - o
        pz = jnp.take_along_axis(rel, kz[..., None], -1)[..., 0]
        px = jnp.take_along_axis(rel, kx[..., None], -1)[..., 0] - Sx * pz
        py = jnp.take_along_axis(rel, ky[..., None], -1)[..., 0] - Sy * pz
        return px, py, pz

    Ax, Ay, Az = shear(v0)
    Bx, By, Bz = shear(v1)
    Cx, Cy, Cz = shear(v2)

    U = Cx * By - Cy * Bx
    V = Ax * Cy - Ay * Cx
    W = Bx * Ay - By * Ax
    # Reference threshold: float(epsilon_v<long double>) ~ 1.08e-19.
    eps = jnp.float32(1.1e-19)
    near = (jnp.abs(U) < eps) | (jnp.abs(V) < eps) | (jnp.abs(W) < eps)
    U = jnp.where(near, _diff_of_products(Cx, By, Cy, Bx), U)
    V = jnp.where(near, _diff_of_products(Ax, Cy, Ay, Cx), V)
    W = jnp.where(near, _diff_of_products(Bx, Ay, By, Ax), W)

    mixed = ((U < 0.0) | (V < 0.0) | (W < 0.0)) & ((U > 0.0) | (V > 0.0) | (W > 0.0))
    det = U + V + W
    Tn = U * (Sz * Az) + V * (Sz * Bz) + W * (Sz * Cz)
    ds = jnp.sign(det)
    in_range = (Tn * ds > t_min * det * ds) & (Tn * ds < t_max * det * ds)
    valid = (~mixed) & (det != 0.0) & in_range
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    t = Tn * inv_det
    u = V * inv_det
    v = W * inv_det
    return jnp.where(valid, t, BIG), u, v, valid


# ---------------------------------------------------------------------------
# Primitive tests (batched)
# ---------------------------------------------------------------------------

def ray_tri_tile(o, d, p0, e1, e2, t_min, t_max):
    """Intersect rays [N,3] with a triangle tile [T,3].

    Returns (t [N,T], u [N,T], v [N,T], valid [N,T]).

    o/d may be [N,3] (shared per ray) or [N,T,3] (per-lane object-space rays
    for animated prims).
    """
    if o.ndim == 2:
        o = o[:, None, :]
    if d.ndim == 2:
        d = d[:, None, :]
    p0 = p0[None, :, :]
    e1 = e1[None, :, :]
    e2 = e2[None, :, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    return t, u, v, valid


def ray_sphere_tile(o, d, center, radius, t_min, t_max):
    """Numerically stable sphere quadratic (hitable_sphere.hpp:128-151).

    Returns (t [N,S], valid [N,S]). o/d may be [N,3] or [N,S,3] (animated).
    """
    oc = (o[:, None, :] if o.ndim == 2 else o) - center[None, :, :]
    dd = d[:, None, :] if d.ndim == 2 else d
    a = jnp.sum(dd * dd, axis=-1)
    half_b = jnp.sum(oc * dd, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    sq = safe_sqrt(disc)
    # Stable roots: q = -(half_b + sign(half_b)*sq); t0 = q/a, t1 = c/q.
    q = -(half_b + jnp.sign(half_b) * sq)
    t0 = q / jnp.maximum(a, 1e-20)
    t1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1.0)
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    t = jnp.where(tlo > t_min[:, None], tlo, thi)
    valid = (disc > 0.0) & (t > t_min[:, None]) & (t < t_max[:, None])
    return jnp.where(valid, t, BIG), valid


# ---------------------------------------------------------------------------
# Closest hit over the whole scene (tiled brute force)
# ---------------------------------------------------------------------------

def _closest_tris(o, d, tris: Triangles, t_min, t_max, best, obj_rays=None):
    """Fold triangle tiles into the running best (t, prim, u, v).

    obj_rays: optional (o_a [N,A,3], d_a [N,A,3]) per-animation object-space
    rays; animated tiles gather their lane's ray by the tri's anim id (the hit
    parameter t is affine-invariant, see scene.animation.AnimCtx).
    """
    n_tri = tris.count
    if n_tri == 0:
        return best
    # Tile width: 128-lane aligned, capped at TRI_TILE. A small scene must not
    # pay for a full padded tile (36 tris padded to 1024 was 28x wasted VPU
    # work on the Cornell-box benchmark).
    tile = min(TRI_TILE, -(-n_tri // 128) * 128)
    n_tiles = -(-n_tri // tile)
    pad = n_tiles * tile - n_tri

    def padded(x):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)

    p0 = padded(tris.p0).reshape(n_tiles, tile, 3)
    e1 = padded(tris.e1).reshape(n_tiles, tile, 3)
    e2 = padded(tris.e2).reshape(n_tiles, tile, 3)
    aid = padded(tris.anim).reshape(n_tiles, tile) if obj_rays is not None else None

    def body(i, best):
        bt, bp, bu, bv = best
        if obj_rays is None:
            o_i, d_i = o, d
        else:
            o_a, d_a = obj_rays
            o_i = jnp.take_along_axis(o_a, aid[i][None, :, None], axis=1)
            d_i = jnp.take_along_axis(d_a, aid[i][None, :, None], axis=1)
        t, u, v, valid = ray_tri_tile(o_i, d_i, p0[i], e1[i], e2[i], t_min, t_max)
        tri_ids = i * tile + jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        valid &= tri_ids < n_tri
        t = jnp.where(valid, t, BIG)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(t.shape[0])
        tj = t[rows, j]
        closer = tj < bt
        return (
            jnp.where(closer, tj, bt),
            jnp.where(closer, tri_ids[rows, j], bp),
            jnp.where(closer, u[rows, j], bu),
            jnp.where(closer, v[rows, j], bv),
        )

    if n_tiles == 1:
        return body(0, best)
    return jax.lax.fori_loop(0, n_tiles, body, best)


def _closest_spheres(o, d, scene: SceneArrays, t_min, t_max, best, obj_rays=None):
    n_sph = scene.spheres.count
    if n_sph == 0:
        return best
    bt, bp, bu, bv = best
    if obj_rays is not None:
        o_a, d_a = obj_rays
        aid = scene.spheres.anim
        o = jnp.take_along_axis(o_a, aid[None, :, None], axis=1)
        d = jnp.take_along_axis(d_a, aid[None, :, None], axis=1)
    t, valid = ray_sphere_tile(o, d, scene.spheres.center, scene.spheres.radius, t_min, t_max)
    t = jnp.where(valid, t, BIG)
    j = jnp.argmin(t, axis=1)
    rows = jnp.arange(t.shape[0])
    tj = t[rows, j]
    closer = tj < bt
    prim = scene.n_tris + j
    return (
        jnp.where(closer, tj, bt),
        jnp.where(closer, prim, bp),
        jnp.where(closer, 0.0, bu),
        jnp.where(closer, 0.0, bv),
    )


def mxu_eligible(scene: SceneArrays, anim_ctx=None) -> bool:
    """True when the single-matmul intersector (intersect_mxu) applies:
    static scene, no BVH requested, and a moderate primitive count."""
    from .intersect_mxu import MXU_MAX_PRIMS

    if scene.bvh is not None or anim_ctx is not None:
        return False
    kt = -(-scene.n_tris // 128) * 128 if scene.n_tris else 0
    ks = -(-scene.n_spheres // 128) * 128 if scene.n_spheres else 0
    cols = 4 * kt + 2 * ks
    return 0 < cols <= 4 * MXU_MAX_PRIMS


def scene_raw_hit(scene: SceneArrays, o, d, t_min, t_max, anim_ctx=None, ms=None):
    """Closest-hit over all primitives. Returns (t, prim, u, v); prim = -1 on miss.

    anim_ctx: scene.animation.AnimCtx for animated scenes — rays are moved to
    each animation's object space once and prims gather their lane's ray.
    ms: precomputed intersect_mxu.MxuScene — routes the cast through the
    single-matmul intersector (built once per trace by the integrator).
    """
    if ms is not None:
        # Plain `lax`, left to XLA: one [N, 12] @ [12, cols] product at
        # HIGHEST precision (not TF32) plus a fused decode. A hand-written
        # fused-cast kernel was tried on the previous accelerator and removed:
        # inside the wavefront while_loop its custom-call boundary broke
        # XLA's fusion of the loop body. On the H100 the product is bound by
        # memory bytes, not FLOPs (K=12); its cost against the BVH path is
        # ROADMAP S4.
        from .intersect_mxu import mxu_closest_hit

        t, prim, u, v, _ = mxu_closest_hit(ms, o, d, t_min, t_max)
        return t, prim, u, v
    n = o.shape[0]
    best = (
        jnp.full((n,), BIG),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,)),
        jnp.zeros((n,)),
    )
    obj_rays = anim_ctx.ray_to_object(o, d) if anim_ctx is not None else None
    if scene.bvh is not None:
        from ..accel.traverse import bvh_closest_hit

        return bvh_closest_hit(scene, o, d, t_min, t_max, obj_rays=obj_rays)
    best = _closest_tris(o, d, scene.tris, t_min, t_max, best, obj_rays=obj_rays)
    best = _closest_spheres(o, d, scene, t_min, t_max, best, obj_rays=obj_rays)
    return best


def scene_fused_cast(scene: SceneArrays, o, d, t_min, t_max, n_closest: int,
                     anim_ctx=None, ms=None):
    """ONE cast serving a closest segment and an any-hit segment.

    Lanes [0, n_closest) are closest-hit queries; lanes [n_closest, N) are
    occlusion queries bounded by their per-lane t_max (set t_max <= t_min to
    disable a lane — it retires on the first step). The integrator uses this
    to batch a bounce's closest cast with the PREVIOUS bounce's deferred NEE
    shadow rays, so the traversal's lockstep fixed costs (BVH path) or the
    feature matmul (matmul path) are paid once per bounce instead of once per
    cast. Returns ((t, prim, u, v) over the closest segment, occluded over
    the any-hit segment).
    """
    if ms is not None:
        from .intersect_mxu import mxu_fused_hit

        (t, prim, u, v, _), occ = mxu_fused_hit(ms, o, d, t_min, t_max,
                                                n_closest)
        return (t, prim, u, v), occ
    obj_rays = anim_ctx.ray_to_object(o, d) if anim_ctx is not None else None
    if scene.bvh is not None:
        from ..accel.traverse import bvh_fused_hit

        return bvh_fused_hit(scene, o, d, t_min, t_max, n_closest,
                             obj_rays=obj_rays)
    # Brute-force tile sweep: no shared lockstep loop to save, so run the two
    # decodes as separate sweeps over the same tiles.
    nc = n_closest
    obj_c = obj_s = None
    if obj_rays is not None:
        obj_c = tuple(a[:nc] for a in obj_rays)
        obj_s = tuple(a[nc:] for a in obj_rays)
    n = o.shape[0]
    best = (
        jnp.full((nc,), BIG),
        jnp.full((nc,), -1, jnp.int32),
        jnp.zeros((nc,)),
        jnp.zeros((nc,)),
    )
    best = _closest_tris(o[:nc], d[:nc], scene.tris, t_min[:nc], t_max[:nc],
                         best, obj_rays=obj_c)
    best = _closest_spheres(o[:nc], d[:nc], scene, t_min[:nc], t_max[:nc],
                            best, obj_rays=obj_c)
    occ = _any_tris(o[nc:], d[nc:], scene.tris, t_min[nc:], t_max[nc:],
                    obj_rays=obj_s)
    occ |= _any_spheres(o[nc:], d[nc:], scene, t_min[nc:], t_max[nc:],
                        obj_rays=obj_s)
    return best, occ


def _any_tris(o, d, tris: Triangles, t_min, t_max, obj_rays=None):
    """True where any triangle is hit in (t_min, t_max) — validity-only fold."""
    n_tri = tris.count
    n = o.shape[0]
    if n_tri == 0:
        return jnp.zeros((n,), bool)
    tile = min(TRI_TILE, -(-n_tri // 128) * 128)
    n_tiles = -(-n_tri // tile)
    pad = n_tiles * tile - n_tri

    def padded(x):
        if pad == 0:
            return x
        return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)

    p0 = padded(tris.p0).reshape(n_tiles, tile, 3)
    e1 = padded(tris.e1).reshape(n_tiles, tile, 3)
    e2 = padded(tris.e2).reshape(n_tiles, tile, 3)
    aid = padded(tris.anim).reshape(n_tiles, tile) if obj_rays is not None else None

    def body(i, occ):
        if obj_rays is None:
            o_i, d_i = o, d
        else:
            o_a, d_a = obj_rays
            o_i = jnp.take_along_axis(o_a, aid[i][None, :, None], axis=1)
            d_i = jnp.take_along_axis(d_a, aid[i][None, :, None], axis=1)
        t, _, _, valid = ray_tri_tile(o_i, d_i, p0[i], e1[i], e2[i], t_min, t_max)
        tri_ids = i * tile + jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        valid &= tri_ids < n_tri
        return occ | jnp.any(valid, axis=1)

    if n_tiles == 1:
        return body(0, jnp.zeros((n,), bool))
    return jax.lax.fori_loop(0, n_tiles, body, jnp.zeros((n,), bool))


def _any_spheres(o, d, scene: SceneArrays, t_min, t_max, obj_rays=None):
    n_sph = scene.spheres.count
    n = o.shape[0]
    if n_sph == 0:
        return jnp.zeros((n,), bool)
    if obj_rays is not None:
        o_a, d_a = obj_rays
        aid = scene.spheres.anim
        o = jnp.take_along_axis(o_a, aid[None, :, None], axis=1)
        d = jnp.take_along_axis(d_a, aid[None, :, None], axis=1)
    _, valid = ray_sphere_tile(
        o, d, scene.spheres.center, scene.spheres.radius, t_min, t_max
    )
    return jnp.any(valid, axis=1)


def scene_any_hit(scene: SceneArrays, o, d, t_min, t_max, anim_ctx=None, ms=None):
    """Occlusion test (shadow rays): True where ANY primitive is hit in
    (t_min, t_max). Callers bound t_max at the sampled light's expected hit
    distance (lights_sample t_expected) so no winner selection, attribute
    gather, or blocker identity check is needed — the reference's
    `directHR.hitable == hotSpots[i]` test (wurblpt.hpp:203-217) is equivalent
    to "no hit strictly before the light". Scenes with media must use
    scene_raw_hit + apply_media instead (stochastic medium blocking needs the
    segment to the blocker)."""
    if ms is not None:
        from .intersect_mxu import mxu_any_hit

        return mxu_any_hit(ms, o, d, t_min, t_max)
    obj_rays = anim_ctx.ray_to_object(o, d) if anim_ctx is not None else None
    if scene.bvh is not None:
        from ..accel.traverse import bvh_any_hit

        return bvh_any_hit(scene, o, d, t_min, t_max, obj_rays=obj_rays)
    occ = _any_tris(o, d, scene.tris, t_min, t_max, obj_rays=obj_rays)
    occ |= _any_spheres(o, d, scene, t_min, t_max, obj_rays=obj_rays)
    return occ


# ---------------------------------------------------------------------------
# Hit record assembly
# ---------------------------------------------------------------------------

def _sphere_uv_tangent(local_pos_unit):
    """Lat/long texcoords + pole-safe tangent (hitable_sphere.hpp:43-75)."""
    x, y, z = local_pos_unit[..., 0], local_pos_unit[..., 1], local_pos_unit[..., 2]
    u = 0.5 + jnp.arctan2(x, z) / (2.0 * jnp.pi)
    v = 0.5 + jnp.arcsin(jnp.clip(y, -1.0, 1.0)) / jnp.pi
    tangent = jnp.stack([z, jnp.zeros_like(y), -x], axis=-1)
    ln = safe_sqrt(jnp.sum(tangent * tangent, axis=-1, keepdims=True))
    pole = ln < 1e-6
    tangent = jnp.where(pole, jnp.array([1.0, 0.0, 0.0]), tangent / jnp.maximum(ln, 1e-20))
    return jnp.stack([u, v], axis=-1), tangent


def assemble_hit(scene: SceneArrays, o, d, t, prim, u, v, anim_ctx=None, ms=None) -> HitRecord:
    """Gather per-prim attributes for winning prims and build the HitRecord.

    Interpolated normals/texcoords/tangents + Gram-Schmidt, front-face flip and
    backside flag match ``hitable_triangle.hpp:276-325``. With `anim_ctx`,
    prim-local attributes are computed in the animation's object space and the
    resulting frame is pushed to world with the forward/normal matrices
    (animation.hpp AnimationCache normal-matrix semantics).
    """
    n_tri = scene.n_tris
    hit = prim >= 0
    prim_safe = jnp.maximum(prim, 0)
    is_tri = hit & (prim_safe < n_tri) if n_tri > 0 else jnp.zeros_like(hit)

    # Miss lanes carry t = BIG; o + BIG*d overflows |position|^2 to inf and a
    # single inf/NaN forward value poisons every backward cotangent (inf * 0 =
    # NaN through jnp.where). Positions on miss lanes are placeholders anyway.
    t_pos = jnp.where(hit, t, 1.0)
    position = o + t_pos[..., None] * d
    pos_local = position
    aid_win = None
    if anim_ctx is not None:
        if n_tri > 0:
            aid_t = scene.tris.anim[jnp.clip(prim_safe, 0, n_tri - 1)]
        else:
            aid_t = jnp.zeros(prim.shape, jnp.int32)
        if scene.n_spheres > 0:
            aid_s = scene.spheres.anim[
                jnp.clip(prim_safe - n_tri, 0, scene.n_spheres - 1)
            ]
        else:
            aid_s = jnp.zeros(prim.shape, jnp.int32)
        aid_win = jnp.where(is_tri, aid_t, aid_s)
        o_a, d_a = anim_ctx.ray_to_object(o, d)
        o_obj = jnp.take_along_axis(o_a, aid_win[:, None, None], axis=1)[:, 0]
        d_obj = jnp.take_along_axis(d_a, aid_win[:, None, None], axis=1)[:, 0]
        pos_local = o_obj + t[..., None] * d_obj

    if ms is not None and n_tri > 0:
        # Matmul path: one-hot attribute matmul instead of row gathers.
        from .intersect_mxu import mxu_tri_attrs

        k_ids = jax.lax.broadcasted_iota(jnp.int32, (prim.shape[0], ms.kt), 1)
        onehot = (k_ids == prim[:, None]) & is_tri[:, None]
        n_interp, gn, uv_tri, tan_tri, mat_tri, _, _ = mxu_tri_attrs(ms, onehot, u, v)
    elif n_tri > 0:
        ti = jnp.clip(prim_safe, 0, n_tri - 1)
        T = scene.tris
        # ONE packed attribute row per triangle (n0|n1|n2|uv*3|tan*3|gn|
        # mat,flags float-encoded): one gather instead of ~14 field-by-field
        # gathers per bounce on the BVH path. The pack is a pure function of
        # the triangle table, hoisted out of the render loop by XLA.
        gn_all = normalize(cross(T.e1, T.e2))
        tri_packed = jnp.concatenate([
            T.n0, T.n1, T.n2, T.uv0, T.uv1, T.uv2, T.tan0, T.tan1, T.tan2,
            gn_all,
            jnp.stack([T.mat, T.flags], -1).astype(jnp.float32),  # ints < 2^24
        ], axis=-1)                                               # [T, 32]
        row = tri_packed[ti]
        n0, n1, n2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        uv0, uv1, uv2 = row[..., 9:11], row[..., 11:13], row[..., 13:15]
        t0_, t1_, t2_ = row[..., 15:18], row[..., 18:21], row[..., 21:24]
        gn = row[..., 24:27]
        ints = jnp.round(row[..., 27:29]).astype(jnp.int32)
        w = 1.0 - u - v
        n_interp = normalize(
            w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2)
        uv_tri = w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2
        tan_raw = w[..., None] * t0_ + u[..., None] * t1_ + v[..., None] * t2_
        has_tan = (ints[..., 1] & 2) > 0
        # Gram-Schmidt the interpolated tangent against the shading normal.
        tan_gs = tan_raw - dot(tan_raw, n_interp, keepdims=True) * n_interp
        tan_len = safe_sqrt(dot(tan_gs, tan_gs))
        tan_fallback, _ = onb_from_normal(n_interp)
        tan_tri = jnp.where(
            (has_tan & (tan_len > 1e-8))[..., None],
            tan_gs / jnp.maximum(tan_len, 1e-20)[..., None],
            tan_fallback,
        )
        mat_tri = ints[..., 0]
    else:
        zeros3 = jnp.zeros_like(position)
        n_interp = zeros3
        gn = zeros3
        uv_tri = jnp.zeros(position.shape[:-1] + (2,))
        tan_tri = zeros3
        mat_tri = jnp.zeros(position.shape[:-1], jnp.int32)

    if scene.n_spheres > 0:
        si = jnp.clip(prim_safe - n_tri, 0, scene.n_spheres - 1)
        S = scene.spheres
        # One packed row per sphere (center|radius|mat) — same rationale.
        sph_packed = jnp.concatenate([
            S.center, S.radius[:, None], S.mat.astype(jnp.float32)[:, None],
        ], axis=-1)                                               # [S, 5]
        srow = sph_packed[si]
        center = srow[..., 0:3]
        radius = srow[..., 3]
        local = (pos_local - center) / jnp.maximum(radius, 1e-20)[..., None]
        n_sph = normalize(local)
        uv_sph, tan_sph = _sphere_uv_tangent(n_sph)
        mat_sph = jnp.round(srow[..., 4]).astype(jnp.int32)
        # The hit re-projected onto the surface (pbrt's sphere refinement), in
        # the sphere's own space: o + t*d carries the rounding of t, and a
        # point that lands inside the sphere by more than min_hit_distance *
        # cos lets a grazing scatter ray re-hit the sphere from inside and
        # lose its sample (seen on the GPU in the white furnace).
        surf_sph = center + radius[..., None] * n_sph
    else:
        surf_sph = None
        n_sph = jnp.zeros_like(position)
        uv_sph = jnp.zeros(position.shape[:-1] + (2,))
        tan_sph = jnp.zeros_like(position)
        mat_sph = jnp.zeros(position.shape[:-1], jnp.int32)

    sel = is_tri[..., None]
    normal = jnp.where(sel, n_interp, n_sph)
    geom_normal = jnp.where(sel, gn, n_sph)
    uv_out = jnp.where(sel[..., :1] if sel.shape[-1] == 1 else sel, uv_tri, uv_sph)
    tangent = jnp.where(sel, tan_tri, tan_sph)
    mat = jnp.where(is_tri, mat_tri, mat_sph)

    if anim_ctx is not None:
        # Push the object-space frame to world: normals by R diag(1/s)
        # (normal matrix), tangents by the forward map (animation.hpp:52-125).
        from ..scene.animation import anim_forward_frames

        m_fwd, m_nrm, tf = anim_forward_frames(scene.anims, aid_win, anim_ctx.time)
        normal = normalize(matvec(m_nrm, normal))
        geom_normal = normalize(matvec(m_nrm, geom_normal))
        tangent = normalize(matvec(m_fwd, tangent))
        if surf_sph is not None:
            surf_sph = matvec(m_fwd, surf_sph) + tf.translation
    if surf_sph is not None:
        position = jnp.where((hit & ~is_tri)[..., None], surf_sph, position)

    # Backside: geometric normal faces away from the incoming ray.
    backside = dot(d, geom_normal) > 0.0
    flip = jnp.where(backside, -1.0, 1.0)[..., None]
    normal = normal * flip
    geom_normal = geom_normal * flip

    return HitRecord(
        t=t,
        hit=hit,
        prim=jnp.where(hit, prim, -1),
        position=position,
        normal=normal,
        geom_normal=geom_normal,
        tangent=tangent,
        uv=uv_out,
        backside=backside & hit,
        mat=jnp.where(hit, mat, 0),
    )


def scene_closest_hit(scene: SceneArrays, o, d, t_min, t_max, anim_ctx=None) -> HitRecord:
    t, prim, u, v = scene_raw_hit(scene, o, d, t_min, t_max, anim_ctx=anim_ctx)
    return assemble_hit(scene, o, d, t, prim, u, v, anim_ctx=anim_ctx)
