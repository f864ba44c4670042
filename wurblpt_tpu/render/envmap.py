"""Environment maps: radiance lookup + parameterization-independent importance sampling.

Reference: ``libwurblpt/envmap.hpp``. The key idea kept from the reference
(Lambers, arXiv:2208.10815, ``envmap.hpp:39-211``) is that importance sampling is
built on an equal-area square<->sphere map, independent of how the radiance
function is parameterized — so equirectangular and cube maps share one sampler.

Differences from the reference, chosen for batched evaluation:
* the equal-area map is the cylindrical (Archimedes) map (exactly equal-area,
  branch-free, cheap to invert) rather than the reference's square map;
* cell selection uses an O(1) alias table instead of a binary search over a
  cumulative table (``envmap.hpp:186-210``) — no divergent search loop.

Device API (all broadcasting over ray batches):
  env_radiance(env, dir)      -> [.., 4] radiance for escaped rays
  env_sample(env, u2)         -> (dir [..,3], pdf [..]) importance-sampled direction
  env_pdf(env, dir)           -> [..] solid-angle pdf of sampling dir
  env_has_importance(env)     -> static bool (table non-empty)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.vecmath import safe_sqrt

from ..core.transform import quat_conjugate, quat_rotate
from ..scene.ir import EnvMapArrays, empty_envmap

_TWO_PI = 2.0 * np.pi
_FOUR_PI = 4.0 * np.pi


# ---------------------------------------------------------------------------
# Equal-area square <-> sphere map (cylindrical / Archimedes)
# ---------------------------------------------------------------------------

def square_to_sphere(uv):
    """Map [0,1]^2 to the unit sphere, equal-area. y is 'up' (polar axis)."""
    phi = _TWO_PI * uv[..., 0]
    y = 2.0 * uv[..., 1] - 1.0
    r = safe_sqrt(1.0 - y * y)
    return jnp.stack([r * jnp.cos(phi), y, r * jnp.sin(phi)], axis=-1)


def sphere_to_square(d):
    """Inverse of square_to_sphere for unit directions."""
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    u = jnp.mod(phi / _TWO_PI, 1.0)
    v = 0.5 * (jnp.clip(d[..., 1], -1.0, 1.0) + 1.0)
    return jnp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# Radiance lookup
# ---------------------------------------------------------------------------

# Above this texel count the 2x2-patch images (4x memory) are skipped and
# bilinear taps fall back to four point gathers: a 4k equirect HDR would
# otherwise pin hundreds of MB of device memory for the whole render. Below
# it the single row gather is used.
PATCH_MAX_TEXELS = 1 << 21


def _bilinear_wrap(img, u, v):
    """Bilinear lookup with wrap in u, clamp in v. img: [H, W, 4]; u,v in [0,1].

    ONE row gather instead of four: a [H, W, 16] patch image holding each
    texel's 2x2 neighborhood (u-wrapped, v-clamped) is built here — it is a
    pure function of `img`, so XLA hoists it out of the render loop — and the
    four taps come from a single gathered row. Envmaps larger than
    PATCH_MAX_TEXELS trade the gather count back for memory (4 point
    gathers, no 4x patch image)."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    if h * w > PATCH_MAX_TEXELS:
        x1i = jnp.mod(x0i + 1, w)
        y1i = jnp.clip(y0i + 1, 0, h - 1)
        c00, c01 = img[y0i, x0i], img[y0i, x1i]
        c10, c11 = img[y1i, x0i], img[y1i, x1i]
    else:
        img_r = jnp.roll(img, -1, axis=1)                    # x+1, wrap
        img_d = jnp.concatenate([img[1:], img[-1:]], axis=0)  # y+1, clamp
        img_rd = jnp.roll(img_d, -1, axis=1)
        patch = jnp.concatenate([img, img_r, img_d, img_rd], -1)  # [H, W, 16]
        c = patch[y0i, x0i]
        c00, c01, c10, c11 = (c[..., 0:4], c[..., 4:8],
                              c[..., 8:12], c[..., 12:16])
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def _equirect_uv(d):
    """Mitsuba-convention equirect mapping (envmap.hpp:231-247 default):
    u = (atan(-x, z) - pi) mod 2pi / 2pi == atan2(x, -z)/(2pi) mod 1, so
    direction +z lands at u = 0.5 (picture center column).

    ROUND-5 FIX found by the city reference twin: the previous formula
    (0.5 * (1 + atan2(x, -z)/pi)) is the reference's SURROUND-VIDEO
    convention — a 180-degree yaw off Mitsuba's (sky column profiles
    anticorrelated at -0.998 against the reference render of the identical
    scene). v (asin-based, picture top = +y zenith) always agreed."""
    u = jnp.mod(jnp.arctan2(d[..., 0], -d[..., 2]) / (2.0 * np.pi), 1.0)
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / np.pi
    return u, v


def _cube_lookup(img, d):
    """Cube-map lookup; img [6, H, W, 4], face order +x,-x,+y,-y,+z,-z."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    # face selection
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = jnp.where(
        is_x,
        jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    )
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-20)
    # standard cube-map (sc, tc) per face
    sc = jnp.where(is_x, jnp.where(x > 0, -z, z), jnp.where(is_y, x, jnp.where(z > 0, x, -x)))
    tc = jnp.where(is_x, -y, jnp.where(is_y, jnp.where(y > 0, z, -z), -y))
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    h, w = img.shape[1], img.shape[2]
    # BILINEAR per-face lookup with edge clamp — the reference's cube faces
    # are TextureImages sampled bilinearly (texture_image.hpp:182-212 with
    # x1/y1 clamped by value(), :85-90). One gather via a [6, H, W, 16]
    # 2x2-patch image (pure function of the faces, hoisted); large face sets
    # fall back to four point gathers (PATCH_MAX_TEXELS memory gate).
    us = jnp.maximum(u * w - 0.5, 0.0)
    vs = jnp.maximum(v * h - 0.5, 0.0)
    x0 = jnp.clip(us.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(vs.astype(jnp.int32), 0, h - 1)
    a = (us - x0.astype(jnp.float32))[..., None]
    b = (vs - y0.astype(jnp.float32))[..., None]
    if 6 * h * w > PATCH_MAX_TEXELS:
        x1 = jnp.clip(x0 + 1, 0, w - 1)
        y1 = jnp.clip(y0 + 1, 0, h - 1)
        c00, c10 = img[face, y0, x0], img[face, y0, x1]
        c01, c11 = img[face, y1, x0], img[face, y1, x1]
    else:
        img_r = jnp.concatenate([img[:, :, 1:], img[:, :, -1:]], axis=2)
        img_d = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
        img_rd = jnp.concatenate([img_d[:, :, 1:], img_d[:, :, -1:]], axis=2)
        patch = jnp.concatenate([img, img_r, img_d, img_rd], -1)
        c = patch[face, y0, x0]
        c00, c10, c01, c11 = (c[..., 0:4], c[..., 4:8],
                              c[..., 8:12], c[..., 12:16])
    return (c00 * (1 - a) + c10 * a) * (1 - b) + (c01 * (1 - a) + c11 * a) * b


def env_radiance(env: EnvMapArrays, d):
    """Radiance arriving from direction d (world space). Returns [..., 4]."""
    d_map = quat_rotate(quat_conjugate(env.rotation), d)

    def none_fn(dm):
        return jnp.zeros(dm.shape[:-1] + (4,), jnp.float32)

    def equirect_fn(dm):
        u, v = _equirect_uv(dm)
        return _bilinear_wrap(env.image.reshape(env.image.shape[-3:]) if env.image.ndim == 3 else env.image[0], u, v)

    def cube_fn(dm):
        img = env.image if env.image.ndim == 4 else env.image[None]
        return _cube_lookup(img, dm)

    def const_fn(dm):
        return jnp.broadcast_to(env.const_radiance, dm.shape[:-1] + (4,))

    if env.image.ndim == 4 and env.image.shape[0] == 6:
        branches = [none_fn, cube_fn, cube_fn, const_fn]
    else:
        branches = [none_fn, equirect_fn, equirect_fn, const_fn]
    return jax.lax.switch(jnp.clip(env.kind, 0, 3), branches, d_map)


# ---------------------------------------------------------------------------
# Importance sampling (alias table over an equal-area grid)
# ---------------------------------------------------------------------------

def env_has_importance(env: EnvMapArrays) -> bool:
    """Static: does this envmap carry importance tables? (trace-time decision,
    mirroring supportsImportanceSampling(), envmap.hpp:165-168)."""
    return env.alias_prob.shape[0] > 0


def env_sample(env: EnvMapArrays, u3):
    """Sample a direction ~ pdf_table. u3: [..., 3] uniforms.

    Returns (world_dir [..., 3], pdf_solid_angle [...]).
    """
    res = env.pdf_table.shape[0]
    n = res * res
    # ONE packed [n, 4] row per cell (alias prob, alias idx, own pdf, ALIASED
    # cell's pdf): a single gather per sample instead of 3 naive ones. The
    # aliased-cell pdf is
    # resolved at pack time (loop-invariant, hoisted by XLA; gradients flow
    # through the pack). alias ids stored as exact float values (< 2^24):
    # denormal bit patterns are flushed by some XLA op sequences
    # (render/bsdf.py pack note).
    pdf_flat = env.pdf_table.reshape(n)
    packed = jnp.concatenate([
        env.alias_prob[:, None],
        env.alias_idx.astype(jnp.float32)[:, None],
        pdf_flat[:, None],
        pdf_flat[env.alias_idx][:, None],
    ], -1)
    cell = jnp.clip((u3[..., 0] * n).astype(jnp.int32), 0, n - 1)
    accept = u3[..., 0] * n - cell.astype(jnp.float32)
    row = packed[cell]
    take_alias = accept > row[..., 0]
    cell = jnp.where(
        take_alias, jnp.round(row[..., 1]).astype(jnp.int32), cell)
    pdf = jnp.where(take_alias, row[..., 3], row[..., 2])
    ci = cell // res   # v index
    cj = cell % res    # u index
    u = (cj.astype(jnp.float32) + u3[..., 1]) / res
    v = (ci.astype(jnp.float32) + u3[..., 2]) / res
    d_map = square_to_sphere(jnp.stack([u, v], axis=-1))
    return quat_rotate(env.rotation, d_map), pdf


def env_pdf(env: EnvMapArrays, d):
    """Solid-angle pdf of env_sample having produced world direction d."""
    res = env.pdf_table.shape[0]
    d_map = quat_rotate(quat_conjugate(env.rotation), d)
    uv = sphere_to_square(d_map)
    cj = jnp.clip((uv[..., 0] * res).astype(jnp.int32), 0, res - 1)
    ci = jnp.clip((uv[..., 1] * res).astype(jnp.int32), 0, res - 1)
    return env.pdf_table[ci, cj]


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

def _build_alias_table(weights: np.ndarray):
    """Vose's O(n) alias method. weights: flat nonnegative, sum > 0."""
    n = weights.size
    prob = weights * n / weights.sum()
    alias = np.zeros(n, np.int32)
    accept = np.ones(n, np.float64)
    small = [i for i in range(n) if prob[i] < 1.0]
    large = [i for i in range(n) if prob[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = prob[s]
        alias[s] = l
        prob[l] = prob[l] - (1.0 - prob[s])
        (small if prob[l] < 1.0 else large).append(l)
    for rest in (small, large):
        for i in rest:
            accept[i] = 1.0
            alias[i] = i
    return accept.astype(np.float32), alias


def build_envmap_arrays(env_desc, importance_default: int = 0) -> EnvMapArrays:
    """Flatten a host envmap descriptor (builder.EnvironmentMap*) to arrays."""
    from ..scene import builder as B

    if env_desc is None:
        return empty_envmap()

    rotation = np.array([0.0, 0.0, 0.0, 1.0], np.float32)

    if isinstance(env_desc, B.EnvironmentMapConstant):
        e = empty_envmap()
        return e._replace(kind=jnp.int32(3), const_radiance=jnp.asarray(B._vec4(env_desc.radiance)))

    if isinstance(env_desc, B.EnvironmentMapEquiRect):
        img = np.asarray(env_desc.image, np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate([img, img.mean(-1, keepdims=True)], -1)
        if env_desc.x_convention_surround:
            # Surround-video x convention (envmap.hpp:235-242): NO -pi shift,
            # i.e. a HALF-TURN u offset from the Mitsuba default — not a
            # mirror (round-5 fix; both conventions share handedness). A
            # cyclic half-width roll of the image is exact for even widths
            # because u wraps.
            if img.shape[1] % 2:
                raise ValueError(
                    "x_convention_surround needs an even-width equirect image")
            img = np.roll(img, img.shape[1] // 2, axis=1)
        if env_desc.rotation is not None:
            rotation = np.asarray(env_desc.rotation, np.float32)
        kind = 1
        res = env_desc.importance_resolution or importance_default
    elif isinstance(env_desc, B.EnvironmentMapCube):
        faces = [np.asarray(f, np.float32) for f in env_desc.faces]
        faces = [
            np.concatenate([f, f.mean(-1, keepdims=True)], -1) if f.shape[-1] == 3 else f
            for f in faces
        ]
        img = np.stack(faces, 0)
        if env_desc.rotation is not None:
            rotation = np.asarray(env_desc.rotation, np.float32)
        kind = 2
        res = env_desc.importance_resolution or importance_default
    else:
        raise TypeError(f"unknown envmap descriptor {env_desc!r}")

    base = empty_envmap()._replace(
        kind=jnp.int32(kind), image=jnp.asarray(img), rotation=jnp.asarray(rotation)
    )

    if not res:
        return base

    # Build the importance grid by evaluating radiance at cell centers on the
    # equal-area map (parameterization-independent, envmap.hpp:120-163).
    ii, jj = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    u = (jj + 0.5) / res
    v = (ii + 0.5) / res
    dirs = np.asarray(square_to_sphere(jnp.asarray(np.stack([u, v], -1), jnp.float32)))
    rad = np.asarray(env_radiance(base, jnp.asarray(dirs.reshape(-1, 3)))).reshape(res, res, 4)
    lum = 0.2126 * rad[..., 0] + 0.7152 * rad[..., 1] + 0.0722 * rad[..., 2] + 1e-12
    cell_prob = lum / lum.sum()
    cell_solid_angle = _FOUR_PI / (res * res)
    pdf_table = (cell_prob / cell_solid_angle).astype(np.float32)
    accept, alias = _build_alias_table(cell_prob.reshape(-1).astype(np.float64))

    return base._replace(
        pdf_table=jnp.asarray(pdf_table),
        alias_prob=jnp.asarray(accept),
        alias_idx=jnp.asarray(alias),
    )
