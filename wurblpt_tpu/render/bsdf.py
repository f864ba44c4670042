"""BSDF sampling / evaluation / emission over material-type codes.

Replaces the reference's virtual ``Material::scatter`` / ``scatterToDirection`` /
``emitted`` dispatch (``material.hpp:158-191``) with masked evaluation: every lane
computes the lobes of every material type present in the scene (a trace-time
static set) and selects. Discrete decisions (lobe choice, dispersion channel,
reflect/refract) are detached from the gradient tape; per-type sampling math:

* Lambertian  — cosine importance sampling (material_lambertian.hpp:35-120)
* GGX         — anisotropic Heitz VNDF sampling (material_ggx.hpp:89-171)
* Glass       — exact-Fresnel reflect/refract, per-channel IOR dispersion with
                random channel pick x4, Beer-Lambert exit absorption
                (material_glass.hpp:97-141)
* Mirror      — perfect specular (material_mirror.hpp)
* ModPhong    — energy-normalized diffuse+specular lobes, opacity pass-through
                (material_modphong.hpp:192-261)
* PhaseIso    — uniform sphere (material_phase_function_isotropic.hpp)
* Lights      — scatter None + directional emission (light_*.hpp)

Conventions: `wo` = direction toward the previous path vertex (= -ray.dir),
`wd` = sampled/next direction, both world-space unit. `atten` returns the
BSDF *value x cos(theta)* (what the reference calls attenuation); `pdf` is the
solid-angle sampling density. Radiance is RGB+NIR vec4.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import sampler
from ..core.fresnel import fresnel_schlick, fresnel_unpolarized
from ..core.onb import onb_from_normal_tangent, to_local, to_world
from ..core.vecmath import cross, dot, normalize, reflect, safe_sqrt
from ..scene.ir import MaterialFlags, MaterialType, SceneArrays
from .intersect import HitRecord
from .texture import material_albedo, material_emissive

_PI = jnp.pi
_INV_PI = 1.0 / jnp.pi


class ScatterKind:
    NONE = 0      # absorbed / light surface
    RANDOM = 1    # pdf-sampled lobe (participates in MIS)
    EXPLICIT = 2  # delta lobe (specular); no MIS


class ScatterSample(NamedTuple):
    kind: jnp.ndarray        # [N] int32
    direction: jnp.ndarray   # [N, 3]
    atten: jnp.ndarray       # [N, 4]  f * cos (RANDOM) or throughput factor (EXPLICIT)
    pdf: jnp.ndarray         # [N]
    ior: jnp.ndarray         # [N, 4]  refractive index for the continued ray


class SceneStatic(NamedTuple):
    """Trace-time facts about the scene (NOT traced; computed host-side from
    concrete arrays). Gates dead material branches out of the compiled kernel."""

    mat_types: frozenset
    has_textures: bool
    has_anim: bool
    n_lights: int
    env_kind: int
    env_importance: bool
    has_media: bool
    has_normal_maps: bool = False
    lights_animated: bool = False
    has_opacity_tex: bool = False
    has_spec_tex: bool = False
    # O(1) per-light MIS (SURVEY.md section 7 "NEE cost model"): swap the
    # O(L) mixture pdf for pick_prob x per-light pdf at both the NEE and the
    # emitted-MIS events. On by default for static-light scenes with many
    # lights; small scenes keep the mixture (matches the reference's
    # estimator exactly, wurblpt.hpp:181-195).
    per_light_mis: bool = False

    @staticmethod
    def from_scene(scene: SceneArrays) -> "SceneStatic":
        import numpy as np

        n_tri = scene.n_tris
        lp = np.asarray(scene.light_prims)
        la = False
        if lp.size > 0 and scene.anims.count > 1:
            anim_all = np.concatenate([
                np.asarray(scene.tris.anim).reshape(-1),
                np.asarray(scene.spheres.anim).reshape(-1),
            ])  # global prim id order: tris then spheres (matches light_prims)
            la = bool(np.any(anim_all[lp] != 0))
        return SceneStatic(
            mat_types=frozenset(np.unique(np.asarray(scene.materials.typ)).tolist()),
            has_textures=scene.textures.count > 0,
            has_anim=scene.anims.count > 1,
            n_lights=int(scene.light_prims.shape[0]),
            env_kind=int(scene.envmap.kind),
            env_importance=scene.envmap.alias_prob.shape[0] > 0,
            has_media=scene.media.count > 0,
            has_normal_maps=bool(np.any(np.asarray(scene.materials.normal_tex) >= 0)),
            lights_animated=la,
            has_opacity_tex=bool(
                scene.materials.opacity_tex is not None
                and np.any(np.asarray(scene.materials.opacity_tex) >= 0)
            ),
            has_spec_tex=bool(
                scene.materials.spec_tex is not None
                and np.any(np.asarray(scene.materials.spec_tex) >= 0)
            ),
            per_light_mis=bool(
                lp.size >= PER_LIGHT_MIS_MIN and not la
                and scene.prim_light_pick is not None
            ),
        )


PER_LIGHT_MIS_MIN = 8  # lights; below this the O(L) mixture broadcast is cheap


# ---------------------------------------------------------------------------
# Packed material rows: ONE gather for all per-lane material attributes
# ---------------------------------------------------------------------------
#
# The bounce body would otherwise do ~15 separate `mt.field[hr.mat]` gathers
# per iteration (typ, flags, albedo, emissive, p0..p2, texture ids, rgl id,
# again in emitted and bsdf_eval). Packing the MaterialTable into a single
# [M, 28] f32 matrix (ints bitcast) makes all of them ONE gather per bounce —
# the same trick as the wide-BVH node rows and the matmul intersector's
# attribute matrix. (On the previous accelerator each row gather cost the
# same whatever the row size; on the H100 this is not yet measured.) The packed matrix is built per trace from the (differentiable)
# table inside jit, so XLA hoists it out of the bounce loop and gradients
# still flow to the material parameters through the pack.

class MatRow(NamedTuple):
    """Per-lane material attributes (all [N] / [N,4]), from one packed row."""

    typ: jnp.ndarray
    flags: jnp.ndarray
    albedo: jnp.ndarray
    emissive: jnp.ndarray
    p0: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    albedo_tex: jnp.ndarray
    emissive_tex: jnp.ndarray
    normal_tex: jnp.ndarray
    opacity_tex: jnp.ndarray
    spec_tex: jnp.ndarray
    rgl_id: jnp.ndarray


def pack_material_table(mt) -> jnp.ndarray:
    """[M, 28] f32: albedo|emissive|p0|p1|p2 (20 floats) + 8 float-encoded
    int columns (typ, flags, 5 texture ids, rgl_id)."""
    m = mt.typ.shape[0]
    neg1 = jnp.full((m,), -1, jnp.int32)
    p2 = mt.p2 if mt.p2 is not None else jnp.zeros_like(mt.p0)
    opat = mt.opacity_tex if mt.opacity_tex is not None else neg1
    spct = mt.spec_tex if mt.spec_tex is not None else neg1
    # Int columns are stored as exact float VALUES (all < 2^24), not bit
    # patterns: small-int bit patterns are f32 DENORMALS and XLA flushes
    # denormals to zero in some op sequences (measured: bitcast int32 ->
    # concat -> column slice -> bitcast back returns zeros on this
    # toolchain) — float-encoding is exact and flush-proof.
    ints = jnp.stack([mt.typ, mt.flags, mt.albedo_tex, mt.emissive_tex,
                      mt.normal_tex, opat, spct, mt.rgl_id], axis=-1)
    return jnp.concatenate(
        [mt.albedo, mt.emissive, mt.p0, mt.p1, p2,
         ints.astype(jnp.float32)], axis=-1)


def gather_material_rows(packed, mat_ids) -> MatRow:
    """One [N]-row gather of the packed table -> every per-lane attribute."""
    row = packed[mat_ids]
    ints = jnp.round(row[..., 20:28]).astype(jnp.int32)
    return MatRow(
        typ=ints[..., 0], flags=ints[..., 1],
        albedo=row[..., 0:4], emissive=row[..., 4:8],
        p0=row[..., 8:12], p1=row[..., 12:16], p2=row[..., 16:20],
        albedo_tex=ints[..., 2], emissive_tex=ints[..., 3],
        normal_tex=ints[..., 4], opacity_tex=ints[..., 5],
        spec_tex=ints[..., 6], rgl_id=ints[..., 7],
    )


def material_rows(scene: SceneArrays, mat_ids, packed=None) -> MatRow:
    """MatRow for `mat_ids` — via `packed` (one gather) when provided, else
    per-field gathers (compatibility path for direct callers/tests)."""
    if packed is not None:
        return gather_material_rows(packed, mat_ids)
    mt = scene.materials
    m = mat_ids.shape[0] if hasattr(mat_ids, "shape") else 1
    neg1 = jnp.full(mat_ids.shape, -1, jnp.int32)
    return MatRow(
        typ=mt.typ[mat_ids], flags=mt.flags[mat_ids],
        albedo=mt.albedo[mat_ids], emissive=mt.emissive[mat_ids],
        p0=mt.p0[mat_ids], p1=mt.p1[mat_ids],
        p2=(mt.p2[mat_ids] if mt.p2 is not None else jnp.zeros(mat_ids.shape + (4,))),
        albedo_tex=mt.albedo_tex[mat_ids], emissive_tex=mt.emissive_tex[mat_ids],
        normal_tex=mt.normal_tex[mat_ids],
        opacity_tex=(mt.opacity_tex[mat_ids] if mt.opacity_tex is not None else neg1),
        spec_tex=(mt.spec_tex[mat_ids] if mt.spec_tex is not None else neg1),
        rgl_id=mt.rgl_id[mat_ids],
    )


def apply_normal_map(scene: SceneArrays, static: SceneStatic, hr: HitRecord,
                     mrow: "MatRow" = None) -> HitRecord:
    """Perturb the shading normal by the material's normal map.

    Reference ``Material::normalAt``/``tangentSpaceAt`` (material.hpp:195-228):
    texel -> nt = normalize(2*t - 1), transformed to world by the interpolated
    (tangent, bitangent, normal) frame; the tangent is re-orthogonalized
    against the mapped normal. No-op (and compiled out) without normal maps.
    """
    if not static.has_normal_maps:
        return hr
    from .texture import sample_texture

    ntex = mrow.normal_tex if mrow is not None else scene.materials.normal_tex[hr.mat]
    has_nm = (ntex >= 0) & hr.hit
    tex_n = sample_texture(scene.textures, jnp.maximum(ntex, 0), hr.uv)[..., :3]
    nt = normalize(tex_n * 2.0 - 1.0)
    t, b = onb_from_normal_tangent(hr.normal, hr.tangent)
    mapped = normalize(to_world(nt, t, b, hr.normal))
    new_n = jnp.where(has_nm[..., None], mapped, hr.normal)
    # Gram-Schmidt the tangent against the perturbed normal.
    tan = hr.tangent - dot(hr.tangent, new_n, keepdims=True) * new_n
    tlen = safe_sqrt(dot(tan, tan))
    new_t = jnp.where(
        (has_nm & (tlen > 1e-8))[..., None],
        tan / jnp.maximum(tlen, 1e-20)[..., None],
        hr.tangent,
    )
    return hr._replace(normal=new_n, tangent=new_t)


# ---------------------------------------------------------------------------
# GGX helpers (anisotropic, local tangent frame with n = +z)
# ---------------------------------------------------------------------------

def _ggx_ndf(h, ax, ay):
    """Anisotropic GGX D (material_ggx.hpp:89-110)."""
    hx2 = (h[..., 0] / ax) ** 2
    hy2 = (h[..., 1] / ay) ** 2
    hz2 = h[..., 2] ** 2
    denom = hx2 + hy2 + hz2
    return jnp.where(
        h[..., 2] > 0.0,
        1.0 / jnp.maximum(_PI * ax * ay * denom * denom, 1e-12),
        0.0,
    )


def _ggx_lambda(w, ax, ay):
    wz = jnp.maximum(jnp.abs(w[..., 2]), 1e-6)
    t2 = ((ax * w[..., 0]) ** 2 + (ay * w[..., 1]) ** 2) / (wz * wz)
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + t2))


def _ggx_g1(w, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(w, ax, ay))


def _ggx_g2(wi, wo, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(wi, ax, ay) + _ggx_lambda(wo, ax, ay))


def _ggx_sample_vndf(wo_local, ax, ay, u2):
    """Heitz 2018 VNDF sampling (material_ggx.hpp:138-171). wo_local.z > 0."""
    vh = normalize(
        jnp.stack([ax * wo_local[..., 0], ay * wo_local[..., 1], wo_local[..., 2]], axis=-1)
    )
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-20))
    t1 = jnp.where(
        (lensq > 1e-12)[..., None],
        jnp.stack([-vh[..., 1] * inv, vh[..., 0] * inv, jnp.zeros_like(inv)], axis=-1),
        jnp.array([1.0, 0.0, 0.0]),
    )
    t2v = cross(vh, t1)
    r = safe_sqrt(u2[..., 0])
    phi = 2.0 * _PI * u2[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2v
        + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh
    )
    h = normalize(
        jnp.stack(
            [ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(nh[..., 2], 1e-6)], axis=-1
        )
    )
    return h


def _ggx_eval_local(wo, wd, f0, ax, ay):
    """Returns (f*cos [N,4], pdf [N]) in the local frame; zero below horizon."""
    up = (wo[..., 2] > 1e-6) & (wd[..., 2] > 1e-6)
    h = normalize(wo + wd)
    d_term = _ggx_ndf(h, ax, ay)
    g2 = _ggx_g2(wo, wd, ax, ay)
    g1 = _ggx_g1(wo, ax, ay)
    cos_oh = jnp.maximum(dot(wo, h), 1e-6)
    f = fresnel_schlick(cos_oh[..., None], f0)
    woz = jnp.maximum(wo[..., 2], 1e-6)
    wdz = jnp.maximum(wd[..., 2], 1e-6)
    spec = f * (d_term * g2 / (4.0 * woz))[..., None]   # = f*D*G2/(4 cosO cosI) * cosI
    pdf = g1 * d_term / (4.0 * woz)                      # VNDF pdf for wd
    zero = jnp.zeros_like(spec)
    return jnp.where(up[..., None], spec, zero), jnp.where(up, pdf, 0.0)


# ---------------------------------------------------------------------------
# ModPhong helpers
# ---------------------------------------------------------------------------

def _modphong_ks(scene: SceneArrays, static: "SceneStatic", hr: HitRecord,
                 mrow: "MatRow"):
    """Shade-time specular color: map_Ks texture when present, else the
    constant p1 slot (material_modphong.hpp:129-146). Compiled out (constant
    path only) when no scene material carries a specular texture."""
    ks = mrow.p1
    if static.has_spec_tex:
        from .texture import sample_texture

        stex = mrow.spec_tex
        ks_t = sample_texture(scene.textures, jnp.maximum(stex, 0), hr.uv)
        ks = jnp.where((stex >= 0)[..., None], ks_t, ks)
    return ks


def _modphong_eval(wo, wd, n, kd, ks, shininess):
    """f*cos and mixture pdf for the energy-normalized modified Phong
    (material_modphong.hpp:192-239). All world-space; n front-facing."""
    cos_i = dot(wd, n)
    up = cos_i > 1e-6
    refl = reflect(-wo, n)
    cos_a = jnp.clip(dot(refl, wd), 0.0, 1.0)
    s = jnp.maximum(shininess, 0.0)
    norm_spec = (s + 2.0) / (2.0 * _PI)
    f = kd * _INV_PI + ks * (norm_spec * jnp.power(cos_a, s))[..., None]
    fcos = f * jnp.maximum(cos_i, 0.0)[..., None]
    # mixture pdf with lobe probability ps
    kd_max = jnp.max(kd[..., :3], axis=-1)
    ks_max = jnp.max(ks[..., :3], axis=-1)
    ps = jnp.where(kd_max + ks_max > 0, ks_max / jnp.maximum(kd_max + ks_max, 1e-12), 0.0)
    pdf_diff = jnp.maximum(cos_i, 0.0) * _INV_PI
    pdf_spec = (s + 1.0) / (2.0 * _PI) * jnp.power(cos_a, s)
    pdf = (1.0 - ps) * pdf_diff + ps * pdf_spec
    zero4 = jnp.zeros_like(fcos)
    return jnp.where(up[..., None], fcos, zero4), jnp.where(up, pdf, 0.0)


def _sample_power_cosine(axis, exponent, u2):
    """Sample direction ~ cos^s around axis."""
    ct = jnp.power(jnp.maximum(u2[..., 0], 1e-12), 1.0 / (exponent + 1.0))
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * _PI * u2[..., 1]
    local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    from ..core.onb import onb_from_normal

    t, b = onb_from_normal(axis)
    return to_world(local, t, b, axis)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def emitted(scene: SceneArrays, static: SceneStatic, hr: HitRecord, view_dir,
            mrow: "MatRow" = None):
    """Radiance emitted from the hit toward the viewer (material.hpp:182-185).

    view_dir points from the hit toward the previous vertex (= -ray.dir).
    `mrow`: pre-gathered material attributes (one packed-row gather).
    """
    if mrow is None:
        mrow = material_rows(scene, hr.mat)
    typ = mrow.typ
    flags = mrow.flags
    e = material_emissive(scene, hr.mat, hr.uv, mrow=mrow)

    is_emitter = (
        (typ == MaterialType.LIGHT_DIFFUSE)
        | (typ == MaterialType.LIGHT_SPOT)
        | (typ == MaterialType.LIGHT_TOF)
        | (typ == MaterialType.MODPHONG)
    )
    # Front side only, unless two-sided (hr.normal is already front-facing;
    # backside flag says the geometric front faces away).
    two_sided = (flags & MaterialFlags.TWO_SIDED) > 0
    front_ok = (~hr.backside) | two_sided

    cos_view = dot(hr.normal, view_dir)
    vis = cos_view > 0.0

    # Spot/ToF cone: emit only within the opening angle around the normal
    # (light_spot.hpp:32-75, light_tof.hpp:37-89).
    in_cone = cos_view >= mrow.p0[..., 0]
    is_cone = (typ == MaterialType.LIGHT_SPOT) | (typ == MaterialType.LIGHT_TOF)
    ok = is_emitter & front_ok & vis & (in_cone | ~is_cone)
    return jnp.where(ok[..., None], e, 0.0)


# ---------------------------------------------------------------------------
# Sampling (scatter)
# ---------------------------------------------------------------------------

def bsdf_sample(
    scene: SceneArrays,
    static: SceneStatic,
    hr: HitRecord,
    ray_dir,
    ray_ior,
    u4,
    u_lobe,
    u_chan=None,
    mrow: "MatRow" = None,
) -> ScatterSample:
    """Sample the outgoing lobe at each hit (reference Material::scatter).

    u4: [N,4] uniforms for direction sampling; u_lobe and u_chan: independent
    uniforms for discrete picks — glass uses u_chan for the dispersion channel
    and u_lobe for reflect/refract; ModPhong uses u_lobe for opacity
    pass-through and u_chan for the diffuse/specular lobe pick. The reference
    draws a fresh prng value per decision (material_glass.hpp:97-141,
    material_modphong.hpp:213-261); deriving both from one uniform correlates
    them and biases renders. Discrete picks are detached (stop_gradient) so
    gradients flow through the continuous eval only.
    """
    if mrow is None:
        mrow = material_rows(scene, hr.mat)
    typ = mrow.typ
    n = hr.normal
    wo = -ray_dir
    N = typ.shape[0]

    kind = jnp.zeros((N,), jnp.int32)
    direction = n
    atten = jnp.zeros((N, 4))
    pdf = jnp.zeros((N,))
    ior = ray_ior

    albedo = material_albedo(scene, hr.mat, hr.uv, mrow=mrow)
    u2 = jax.lax.stop_gradient(u4[..., 0:2])
    u_lobe = jax.lax.stop_gradient(u_lobe)
    if u_chan is None:
        u_chan = jnp.mod(u_lobe * 16.0, 1.0)  # legacy derived fallback
    u_chan = jax.lax.stop_gradient(u_chan)

    # ---- Lambertian ----
    if MaterialType.LAMBERTIAN in static.mat_types:
        d_cos = sampler.cosine_direction(n, u2)
        cos_t = jnp.maximum(dot(d_cos, n), 0.0)
        p = cos_t * _INV_PI
        sel = typ == MaterialType.LAMBERTIAN
        kind = jnp.where(sel, ScatterKind.RANDOM, kind)
        direction = jnp.where(sel[..., None], d_cos, direction)
        atten = jnp.where(sel[..., None], albedo * p[..., None], atten)
        pdf = jnp.where(sel, p, pdf)

    # ---- GGX ----
    if MaterialType.GGX in static.mat_types:
        ax = jnp.maximum(mrow.p0[..., 0], 1e-4)
        ay = jnp.maximum(mrow.p0[..., 1], 1e-4)
        t, b = onb_from_normal_tangent(n, hr.tangent)
        wo_l = to_local(wo, t, b, n)
        wo_l = wo_l.at[..., 2].set(jnp.maximum(wo_l[..., 2], 1e-4))
        h = _ggx_sample_vndf(wo_l, ax, ay, u2)
        wd_l = reflect(-wo_l, h)
        fcos, p = _ggx_eval_local(wo_l, wd_l, albedo, ax, ay)
        d_ggx = to_world(wd_l, t, b, n)
        sel = typ == MaterialType.GGX
        kind = jnp.where(sel, ScatterKind.RANDOM, kind)
        direction = jnp.where(sel[..., None], d_ggx, direction)
        atten = jnp.where(sel[..., None], fcos, atten)
        pdf = jnp.where(sel, p, pdf)

    # ---- Mirror ----
    if MaterialType.MIRROR in static.mat_types:
        d_m = reflect(ray_dir, n)
        sel = typ == MaterialType.MIRROR
        kind = jnp.where(sel, ScatterKind.EXPLICIT, kind)
        direction = jnp.where(sel[..., None], d_m, direction)
        atten = jnp.where(sel[..., None], albedo, atten)
        pdf = jnp.where(sel, 1.0, pdf)

    # ---- Glass ----
    if MaterialType.GLASS in static.mat_types:
        mat_ior = mrow.p0                # [N,4] per-channel IOR
        absorption = mrow.p1             # [N,4]
        dispersive = (
            (jnp.abs(mat_ior[..., 0] - mat_ior[..., 1]) > 1e-6)
            | (jnp.abs(mat_ior[..., 1] - mat_ior[..., 2]) > 1e-6)
            | (jnp.abs(mat_ior[..., 2] - mat_ior[..., 3]) > 1e-6)
        )
        # Random channel pick x4 when dispersive (material_glass.hpp:97-106).
        chan = jnp.clip((u_chan * 4.0).astype(jnp.int32), 0, 3)
        chan_mask = jax.nn.one_hot(chan, 4, dtype=atten.dtype)
        n_mat = jnp.take_along_axis(mat_ior, chan[..., None], axis=-1)[..., 0]
        n_mat = jnp.where(dispersive, n_mat, mat_ior[..., 0])
        n_i = jnp.where(hr.backside, n_mat, 1.0)
        n_t = jnp.where(hr.backside, 1.0, n_mat)
        cos_i = jnp.clip(dot(wo, n), 0.0, 1.0)
        fres = fresnel_unpolarized(cos_i, n_i, n_t)
        reflect_pick = u_lobe < fres
        from ..core.vecmath import refract as _refract

        refr_dir, tir = _refract(ray_dir, n, n_i / jnp.maximum(n_t, 1e-6))
        refl_dir = reflect(ray_dir, n)
        d_g = jnp.where((reflect_pick | tir)[..., None], refl_dir, refr_dir)
        a_g = jnp.ones((N, 4))
        a_g = jnp.where(dispersive[..., None], chan_mask * 4.0, a_g)
        # Beer-Lambert on backside exit (material_glass.hpp:107-111).
        beer = jnp.exp(-absorption * hr.t[..., None])
        a_g = a_g * jnp.where(hr.backside[..., None], beer, 1.0)
        new_ior = jnp.where(
            (reflect_pick | tir)[..., None],
            ray_ior,
            jnp.where(hr.backside[..., None], jnp.ones((N, 4)), jnp.broadcast_to(mat_ior, (N, 4))),
        )
        sel = typ == MaterialType.GLASS
        kind = jnp.where(sel, ScatterKind.EXPLICIT, kind)
        direction = jnp.where(sel[..., None], d_g, direction)
        atten = jnp.where(sel[..., None], a_g, atten)
        pdf = jnp.where(sel, 1.0, pdf)
        ior = jnp.where(sel[..., None], new_ior, ior)

    # ---- ModPhong ----
    if MaterialType.MODPHONG in static.mat_types:
        ks = _modphong_ks(scene, static, hr, mrow)
        shininess = mrow.p0[..., 0]
        opacity = mrow.p0[..., 1]
        if static.has_opacity_tex:
            # map_d / diffuse-alpha opacity (material_modphong.hpp:136-146).
            from .texture import sample_texture

            otex = mrow.opacity_tex
            opa_t = sample_texture(scene.textures, jnp.maximum(otex, 0), hr.uv)[..., 0]
            opacity = jnp.where(otex >= 0, opa_t, opacity)
        # Lobe-pick probability from the SAME shade-time kd/ks the mixture
        # pdf uses (material_modphong.hpp:213-220) — a flatten-time constant
        # here would make the sampling density disagree with the pdf whenever
        # diffuse or specular is textured (biased estimator).
        kd_max = jax.lax.stop_gradient(jnp.max(albedo[..., :3], axis=-1))
        ks_max = jax.lax.stop_gradient(jnp.max(ks[..., :3], axis=-1))
        ps = jnp.where(kd_max + ks_max > 0,
                       ks_max / jnp.maximum(kd_max + ks_max, 1e-12), 0.0)
        # Opacity pass-through (material_modphong.hpp:241-261): with prob
        # (1-opacity) REFRACT through the surface with the material's index
        # of refraction, attenuated by the transmissive color; total internal
        # reflection absorbs (the reference returns ScatterNone).
        pass_through = jax.lax.stop_gradient(u_lobe > opacity)
        mp_ior = mrow.p0[..., 3]
        eta = jnp.where(hr.backside, mp_ior, 1.0) / jnp.where(hr.backside, 1.0, mp_ior)
        from ..core.vecmath import refract as _refract_mp

        d_pass, tir_mp = _refract_mp(ray_dir, n, eta)
        transmissive = mrow.p2
        our_ri = jnp.where(hr.backside, 1.0, mp_ior)
        # Non-transparent backside hits absorb (material_modphong.hpp:262-263).
        backside_absorb = hr.backside & ~pass_through
        pick_spec = u_chan < ps
        refl_axis = reflect(ray_dir, n)
        d_spec = _sample_power_cosine(refl_axis, shininess, u2)
        d_diff = sampler.cosine_direction(n, u2)
        d_mp = jnp.where(pick_spec[..., None], d_spec, d_diff)
        fcos, p = _modphong_eval(wo, d_mp, n, albedo, ks, shininess)
        d_mp = jnp.where(pass_through[..., None], d_pass, d_mp)
        sel = typ == MaterialType.MODPHONG
        kind_mp = jnp.where(pass_through, ScatterKind.EXPLICIT, ScatterKind.RANDOM)
        kind_mp = jnp.where((pass_through & tir_mp) | backside_absorb,
                            ScatterKind.NONE, kind_mp)
        kind = jnp.where(sel, kind_mp, kind)
        direction = jnp.where(sel[..., None], d_mp, direction)
        atten = jnp.where(
            sel[..., None],
            jnp.where(pass_through[..., None], transmissive, fcos),
            atten,
        )
        pdf = jnp.where(sel, jnp.where(pass_through, 1.0, p), pdf)
        ior = jnp.where(
            (sel & pass_through)[..., None], our_ri[..., None], ior
        )

    # ---- Isotropic phase function ----
    if MaterialType.PHASE_ISO in static.mat_types:
        d_ph = sampler.on_unit_sphere(u2)
        p_ph = 1.0 / (4.0 * _PI)
        sel = typ == MaterialType.PHASE_ISO
        kind = jnp.where(sel, ScatterKind.RANDOM, kind)
        direction = jnp.where(sel[..., None], d_ph, direction)
        atten = jnp.where(sel[..., None], albedo * p_ph, atten)
        pdf = jnp.where(sel, p_ph, pdf)

    # ---- RGL measured materials ----
    if MaterialType.RGL in static.mat_types:
        from ..materials.rgl import rgl_sample_lanes

        d_r, fcos_r, p_r, ok_r = rgl_sample_lanes(scene, hr, wo, u2,
                                                  rgl_id=mrow.rgl_id)
        sel = (typ == MaterialType.RGL) & ok_r
        kind = jnp.where(sel, ScatterKind.RANDOM, kind)
        direction = jnp.where(sel[..., None], d_r, direction)
        atten = jnp.where(sel[..., None], fcos_r, atten)
        pdf = jnp.where(sel, p_r, pdf)

    return ScatterSample(kind=kind, direction=direction, atten=atten, pdf=pdf, ior=ior)


# ---------------------------------------------------------------------------
# Evaluation toward a given direction (NEE / MIS)
# ---------------------------------------------------------------------------

def bsdf_eval(scene: SceneArrays, static: SceneStatic, hr: HitRecord, ray_dir,
              wd, mrow: "MatRow" = None):
    """(f*cos [N,4], pdf [N]) of scattering into direction wd
    (reference Material::scatterToDirection, material.hpp:173-179).

    Delta lobes (glass/mirror/none/lights) return zeros — they never take part
    in NEE (wurblpt.hpp:179 requires ScatterRandom).
    """
    if mrow is None:
        mrow = material_rows(scene, hr.mat)
    typ = mrow.typ
    n = hr.normal
    wo = -ray_dir
    N = typ.shape[0]
    albedo = material_albedo(scene, hr.mat, hr.uv, mrow=mrow)

    fcos = jnp.zeros((N, 4))
    pdf = jnp.zeros((N,))

    if MaterialType.LAMBERTIAN in static.mat_types:
        cos_t = jnp.maximum(dot(wd, n), 0.0)
        p = cos_t * _INV_PI
        sel = typ == MaterialType.LAMBERTIAN
        fcos = jnp.where(sel[..., None], albedo * p[..., None], fcos)
        pdf = jnp.where(sel, p, pdf)

    if MaterialType.GGX in static.mat_types:
        ax = jnp.maximum(mrow.p0[..., 0], 1e-4)
        ay = jnp.maximum(mrow.p0[..., 1], 1e-4)
        t, b = onb_from_normal_tangent(n, hr.tangent)
        wo_l = to_local(wo, t, b, n)
        wd_l = to_local(wd, t, b, n)
        f_g, p_g = _ggx_eval_local(wo_l, wd_l, albedo, ax, ay)
        sel = typ == MaterialType.GGX
        fcos = jnp.where(sel[..., None], f_g, fcos)
        pdf = jnp.where(sel, p_g, pdf)

    if MaterialType.MODPHONG in static.mat_types:
        ks = _modphong_ks(scene, static, hr, mrow)
        shininess = mrow.p0[..., 0]
        f_m, p_m = _modphong_eval(wo, wd, n, albedo, ks, shininess)
        # Full lobe despite opacity, matching the reference's
        # scatterToDirection (material_modphong.hpp:310-328): NEE only runs on
        # RANDOM lanes, reached with probability `opacity`; that discrete
        # factor cancels against the opacity weight of the surface-reflection
        # term, so the conditional estimator with the FULL phong lobe (and its
        # unconditioned mixed pdf for MIS) is unbiased.
        sel = typ == MaterialType.MODPHONG
        fcos = jnp.where(sel[..., None], f_m, fcos)
        pdf = jnp.where(sel, p_m, pdf)

    if MaterialType.PHASE_ISO in static.mat_types:
        p_ph = 1.0 / (4.0 * _PI)
        sel = typ == MaterialType.PHASE_ISO
        fcos = jnp.where(sel[..., None], albedo * p_ph, fcos)
        pdf = jnp.where(sel, p_ph, pdf)

    if MaterialType.RGL in static.mat_types:
        from ..materials.rgl import rgl_eval_lanes

        f_r, p_r, ok_r = rgl_eval_lanes(scene, hr, wo, wd, rgl_id=mrow.rgl_id)
        sel = (typ == MaterialType.RGL) & ok_r
        fcos = jnp.where(sel[..., None], f_r, fcos)
        pdf = jnp.where(sel, p_r, pdf)

    return fcos, pdf
