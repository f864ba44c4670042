"""Device-side texture evaluation.

Replaces the reference's virtual ``Texture::value(texcoords, t)`` dispatch
(``texture.hpp:47-158``) with masked evaluation over integer type codes. Image
textures sample a single padded stack with per-texture (h, w) — bilinear
filtering and fract-wrap addressing per ``texture_image.hpp:182-212``. Procedural
noise types (``texture_noise.hpp``) are hash-based and deterministic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.rng import hash4
from ..scene.ir import TextureTable, TextureType


def _hash01(ix, iy, seed):
    v0, _, _, _ = hash4(ix, iy, seed, jnp.uint32(0x9E3779B9))
    return (v0 >> 8).astype(jnp.float32) * (1.0 / 16777216.0)


def _hash_grad2(ix, iy, seed):
    """Unit 2D gradient from lattice coords."""
    ang = _hash01(ix, iy, seed) * (2.0 * jnp.pi)
    return jnp.cos(ang), jnp.sin(ang)


def _value_noise(u, v, seed):
    iu, iv = jnp.floor(u), jnp.floor(v)
    fu, fv = u - iu, v - iv
    iu, iv = iu.astype(jnp.int32), iv.astype(jnp.int32)
    su = fu * fu * (3.0 - 2.0 * fu)
    sv = fv * fv * (3.0 - 2.0 * fv)
    a = _hash01(iu, iv, seed)
    b = _hash01(iu + 1, iv, seed)
    c = _hash01(iu, iv + 1, seed)
    d = _hash01(iu + 1, iv + 1, seed)
    return (a * (1 - su) + b * su) * (1 - sv) + (c * (1 - su) + d * su) * sv


def _gradient_noise(u, v, seed):
    iu, iv = jnp.floor(u), jnp.floor(v)
    fu, fv = u - iu, v - iv
    iu, iv = iu.astype(jnp.int32), iv.astype(jnp.int32)
    su = fu * fu * fu * (fu * (fu * 6.0 - 15.0) + 10.0)
    sv = fv * fv * fv * (fv * (fv * 6.0 - 15.0) + 10.0)

    def g(dx, dy):
        gx, gy = _hash_grad2(iu + dx, iv + dy, seed)
        return gx * (fu - dx) + gy * (fv - dy)

    a, b, c, d = g(0, 0), g(1, 0), g(0, 1), g(1, 1)
    n = (a * (1 - su) + b * su) * (1 - sv) + (c * (1 - su) + d * su) * sv
    return 0.5 + 0.5 * n * 1.4142  # remap approx to [0,1]


def _worley_noise(u, v, seed):
    iu, iv = jnp.floor(u).astype(jnp.int32), jnp.floor(v).astype(jnp.int32)
    fu, fv = u - jnp.floor(u), v - jnp.floor(v)
    dmin = jnp.full_like(u, 8.0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            px = _hash01(iu + dx, iv + dy, seed) + dx
            py = _hash01(iu + dx, iv + dy, seed + 77) + dy
            d2 = (px - fu) ** 2 + (py - fv) ** 2
            dmin = jnp.minimum(dmin, d2)
    return jnp.sqrt(dmin)


def _perlin_signed(u, v, seed):
    """Signed single-octave Perlin (texture_noise.hpp:192-237 semantics).

    The reference interpolates dot products of random unit gradients at the
    cell corners with a Hermite fade; its output is SIGNED (roughly [-0.7,
    0.7]), unlike `_gradient_noise` which remaps to [0, 1]. Lattice hashing is
    counter-based (no 256-entry permutation tables — a hash replaces three
    per-lane table gathers and has no tiling period)."""
    iu, iv = jnp.floor(u), jnp.floor(v)
    fu, fv = u - iu, v - iv
    iu, iv = iu.astype(jnp.int32), iv.astype(jnp.int32)
    su = fu * fu * (3.0 - 2.0 * fu)
    sv = fv * fv * (3.0 - 2.0 * fv)

    def g(dx, dy):
        gx, gy = _hash_grad2(iu + dx, iv + dy, seed)
        return gx * (fu - dx) + gy * (fv - dy)

    a, b, c, d = g(0, 0), g(1, 0), g(0, 1), g(1, 1)
    return (a * (1 - su) + b * su) * (1 - sv) + (c * (1 - su) + d * su) * sv


def _perlin_turbulence(u, v, octaves_f, gain, seed, max_octaves: int = 8):
    """|sum_i gain^i * perlin(2^i * uv)| (texture_noise.hpp:239-251; the
    reference fixes gain at 0.5 and does not normalize — neither do we)."""
    total = jnp.zeros_like(u)
    amp = jnp.ones_like(u)
    for o in range(max_octaves):
        active = (octaves_f > o).astype(u.dtype)
        total = total + active * amp * _perlin_signed(
            u * (2.0 ** o), v * (2.0 ** o), seed + o)
        amp = amp * gain
    return jnp.abs(total)


def _fbm(noise_fn, u, v, octaves_f, gain, seed, max_octaves: int = 8):
    """Fixed-unrolled fractal sum; octaves_f masks active octaves per lane."""
    total = jnp.zeros_like(u)
    norm = jnp.zeros_like(u)
    amp = jnp.ones_like(u)
    for o in range(max_octaves):
        active = (octaves_f > o).astype(u.dtype)
        total = total + active * amp * noise_fn(u * (2.0 ** o), v * (2.0 ** o), seed + o)
        norm = norm + active * amp
        amp = amp * gain
    return total / jnp.maximum(norm, 1e-8)


def _bilinear_stack(tt: TextureTable, image_id, u, v, linear, hw=None):
    """Per-lane bilinear lookup in the padded image stack with fract-wrap.

    `hw`: optional per-lane (h, w) floats already gathered (the packed
    descriptor row carries them) — avoids four img_hw gathers."""
    img = tt.img_data
    if hw is None:
        h = tt.img_hw[image_id, 0].astype(jnp.float32)
        w = tt.img_hw[image_id, 1].astype(jnp.float32)
    else:
        h, w = hw
    # fract wrap (texture_image.hpp wrap semantics)
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    # v flip: texture row 0 is top; uv origin bottom-left.
    vv = 1.0 - vv
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = jnp.where(linear, x - x0, jnp.round(x - x0))
    fy = jnp.where(linear, y - y0, jnp.round(y - y0))
    wi = w.astype(jnp.int32)
    hi = h.astype(jnp.int32)
    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    x1i = jnp.mod(x0i + 1, wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    y1i = jnp.mod(y0i + 1, hi)
    c00 = img[image_id, y0i, x0i].astype(jnp.float32)
    c01 = img[image_id, y0i, x1i].astype(jnp.float32)
    c10 = img[image_id, y1i, x0i].astype(jnp.float32)
    c11 = img[image_id, y1i, x1i].astype(jnp.float32)
    fx = fx[..., None]
    fy = fy[..., None]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def sample_texture(tt: TextureTable, tex_id, uv, time=None):
    """Evaluate textures for a lane batch. tex_id [N] int32 (>= 0), uv [N, 2].

    Returns [N, 4] RGBA/RGB+NIR values after the flattened transformer affine
    (texture.hpp:207-246 semantics).

    The descriptor fields (type, params, affines, image id and its h/w) are
    packed into ONE [NT, 24] matrix — built here from the table, so XLA
    hoists the pack out of the render loop — and fetched with a single row
    gather per call instead of ~10 field-by-field gathers per texture
    sample. Only the 4 bilinear texel fetches remain per-lane data gathers.
    """
    # [NT, 24]: params(8) | uv_scale(2) | uv_offset(2) | val_scale(4) |
    # val_offset(4) | typ,image_id (float-encoded) | img_h,img_w (denormalized)
    iid = jnp.maximum(tt.image_id, 0)
    hw = (tt.img_hw[jnp.clip(iid, 0, max(tt.img_hw.shape[0] - 1, 0))]
          .astype(jnp.float32)
          if tt.img_data.shape[0] > 0 else
          jnp.ones(tt.image_id.shape + (2,), jnp.float32))
    packed = jnp.concatenate([
        tt.params, tt.uv_scale, tt.uv_offset, tt.val_scale, tt.val_offset,
        jnp.stack([tt.typ, iid], -1).astype(jnp.float32),  # exact: ids < 2^24
        hw,
    ], axis=-1)

    tex_id = jnp.clip(tex_id, 0, tt.count - 1)
    row = packed[tex_id]                      # ONE descriptor gather
    params = row[..., 0:8]
    uv_scale = row[..., 8:10]
    uv_offset = row[..., 10:12]
    val_scale = row[..., 12:16]
    val_offset = row[..., 16:20]
    ints = jnp.round(row[..., 20:22]).astype(jnp.int32)
    typ = ints[..., 0]
    image_id = ints[..., 1]
    img_h = row[..., 22]
    img_w = row[..., 23]
    u = uv[..., 0] * uv_scale[..., 0] + uv_offset[..., 0]
    v = uv[..., 1] * uv_scale[..., 1] + uv_offset[..., 1]

    out = params[..., 0:4]  # CONSTANT

    # CHECKER (texture.hpp:182-205): squares indexed by floor(u)+floor(v) parity.
    cell = (jnp.floor(u) + jnp.floor(v)).astype(jnp.int32)
    checker = jnp.where(
        (cell % 2 == 0)[..., None], params[..., 0:4], params[..., 4:8]
    )
    out = jnp.where((typ == TextureType.CHECKER)[..., None], checker, out)

    if tt.img_data.shape[0] > 0:
        img_val = _bilinear_stack(
            tt, image_id, u, v, params[..., 0] > 0.5, hw=(img_h, img_w)
        )
        out = jnp.where((typ == TextureType.IMAGE)[..., None], img_val, out)

    # Noise types
    octaves = params[..., 0]
    freq = params[..., 1]
    gain = params[..., 2]
    seed = params[..., 3].astype(jnp.int32)
    any_noise = (typ >= TextureType.VALUE_NOISE) & (typ <= TextureType.PERLIN_NOISE)
    # Only pay for noise evaluation if the scene contains noise textures: this
    # is a trace-time check on host metadata, so XLA never sees dead code.
    nu, nv = u * freq, v * freq
    noise_val = jnp.zeros_like(u)
    noise_val = jnp.where(typ == TextureType.VALUE_NOISE, _fbm(_value_noise, nu, nv, octaves, gain, seed), noise_val)
    noise_val = jnp.where(typ == TextureType.GRADIENT_NOISE, _fbm(_gradient_noise, nu, nv, octaves, gain, seed), noise_val)
    noise_val = jnp.where(typ == TextureType.WORLEY_NOISE, _worley_noise(nu, nv, seed), noise_val)
    # PERLIN: signed single octave (texture_noise.hpp:192-237), or the abs
    # turbulence sum when params[4] is set (:239-251).
    perlin = jnp.where(
        params[..., 4] > 0.5,
        _perlin_turbulence(nu, nv, octaves, gain, seed),
        _perlin_signed(nu, nv, seed),
    )
    noise_val = jnp.where(typ == TextureType.PERLIN_NOISE, perlin, noise_val)
    out = jnp.where(any_noise[..., None], noise_val[..., None], out)

    return out * val_scale + val_offset


def material_albedo(scene, mat_ids, uv, mrow=None):
    """albedo texture if present, else constant column.

    `mrow` (render.bsdf.MatRow): pre-gathered per-lane material attributes —
    avoids two more row gathers (the bounce body gathers ONE packed row per
    bounce)."""
    mt = scene.materials
    const = mrow.albedo if mrow is not None else mt.albedo[mat_ids]
    if scene.textures.count == 0:
        return const
    tex_id = mrow.albedo_tex if mrow is not None else mt.albedo_tex[mat_ids]
    texed = sample_texture(scene.textures, tex_id, uv)
    return jnp.where((tex_id >= 0)[..., None], texed * const, const)


def material_emissive(scene, mat_ids, uv, mrow=None):
    mt = scene.materials
    const = mrow.emissive if mrow is not None else mt.emissive[mat_ids]
    if scene.textures.count == 0:
        return const
    tex_id = mrow.emissive_tex if mrow is not None else mt.emissive_tex[mat_ids]
    texed = sample_texture(scene.textures, tex_id, uv)
    return jnp.where((tex_id >= 0)[..., None], texed * const, const)
