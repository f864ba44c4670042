"""Flatten a host `Scene` into device `SceneArrays`.

This is the "compiler" from the ergonomic object API to the SoA IR: the analog of
the work the reference does lazily via ``Scene::updateBVH`` + per-hitable virtual
state (``scene.hpp:151-169``), done once up front with numpy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..core import color as colorlib
from ..core.transform import Transformation
from . import builder as B
from .geometryproc import compute_normals, compute_tangents
from .ir import (
    AnimTable,
    EnvMapArrays,
    MaterialFlags,
    MaterialTable,
    MaterialType,
    MediumArrays,
    SceneArrays,
    Spheres,
    TextureTable,
    TextureType,
    Triangles,
    empty_envmap,
)

_f32 = np.float32
_i32 = np.int32


class _TextureCollector:
    def __init__(self):
        self.descs: List[B.Texture] = []
        self.images: List[np.ndarray] = []

    def add(self, tex) -> int:
        if tex is None:
            return -1
        if not isinstance(tex, B.Texture):
            # Bare color -> constant texture is wasteful; callers keep constants
            # in the material table. Only Texture instances get table entries.
            raise TypeError(f"not a texture: {tex!r}")
        idx = len(self.descs)
        self.descs.append(tex)
        return idx

    def add_image(self, img: np.ndarray, srgb: bool) -> int:
        img = np.asarray(img)
        if img.dtype == np.uint8:
            imgf = img.astype(_f32) / 255.0
            if srgb:
                imgf = np.asarray(colorlib.srgb_to_rgb(imgf))
        else:
            imgf = img.astype(_f32)
        if imgf.ndim == 2:
            imgf = imgf[..., None]
        c = imgf.shape[-1]
        if c == 1:
            imgf = np.concatenate([imgf] * 3 + [np.mean(imgf, -1, keepdims=True)], -1)
        elif c == 2:
            # gray + alpha: replicate gray, keep alpha in NIR slot
            imgf = np.concatenate([imgf[..., :1]] * 3 + [imgf[..., 1:2]], -1)
        elif c == 3:
            nir = np.mean(imgf, -1, keepdims=True)
            imgf = np.concatenate([imgf, nir], -1)
        idx = len(self.images)
        self.images.append(imgf.astype(np.float16))
        return idx

    def build(self) -> TextureTable:
        nt = len(self.descs)
        typ = np.zeros((nt,), _i32)
        params = np.zeros((nt, 8), _f32)
        uv_scale = np.ones((nt, 2), _f32)
        uv_offset = np.zeros((nt, 2), _f32)
        val_scale = np.ones((nt, 4), _f32)
        val_offset = np.zeros((nt, 4), _f32)
        image_id = np.full((nt,), -1, _i32)

        for i, t in enumerate(self.descs):
            uv_scale[i] = t.uv_scale
            uv_offset[i] = t.uv_offset
            val_scale[i] = t.val_scale
            val_offset[i] = t.val_offset
            if isinstance(t, B.ConstantTexture):
                typ[i] = TextureType.CONSTANT
                params[i, 0:4] = B._vec4(t.color)
            elif isinstance(t, B.CheckerTexture):
                typ[i] = TextureType.CHECKER
                params[i, 0:4] = B._vec4(t.color1)
                params[i, 4:8] = B._vec4(t.color2)
                uv_scale[i] = (t.squares[0], t.squares[1])
            elif isinstance(t, B.ImageTexture):
                typ[i] = TextureType.IMAGE
                image_id[i] = self.add_image(t.image, t.srgb)
                params[i, 0] = 1.0 if t.linear_filtering else 0.0
            elif isinstance(t, B.NoiseTexture):
                typ[i] = t.kind
                params[i, 0] = float(t.octaves)
                params[i, 1] = t.frequency
                params[i, 2] = t.gain
                params[i, 3] = float(t.seed)
                params[i, 4] = 1.0 if t.turbulence else 0.0
            else:
                raise TypeError(f"unknown texture type {t!r}")

        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            stack = np.zeros((len(self.images), hmax, wmax, 4), np.float16)
            hw = np.zeros((len(self.images), 2), _i32)
            for i, im in enumerate(self.images):
                stack[i, : im.shape[0], : im.shape[1]] = im
                hw[i] = (im.shape[0], im.shape[1])
        else:
            stack = np.zeros((0, 1, 1, 4), np.float16)
            hw = np.zeros((0, 2), _i32)

        return TextureTable(
            typ=jnp.asarray(typ),
            params=jnp.asarray(params),
            uv_scale=jnp.asarray(uv_scale),
            uv_offset=jnp.asarray(uv_offset),
            val_scale=jnp.asarray(val_scale),
            val_offset=jnp.asarray(val_offset),
            image_id=jnp.asarray(image_id),
            img_data=jnp.asarray(stack),
            img_hw=jnp.asarray(hw),
        )


def _tex_or_color(val, collector: _TextureCollector, default=(0.0, 0.0, 0.0)):
    """Returns (constant_vec4, tex_id)."""
    if val is None:
        return B._vec4(default), -1
    if isinstance(val, B.Texture):
        return np.ones(4, _f32), collector.add(val)
    return B._vec4(val), -1


def _flatten_materials(materials, collector: _TextureCollector, rgl_names) -> MaterialTable:
    # Envmap-only scenes (e.g. tools/wurblpt-360-to-conventional.cpp:64-87) have
    # no materials; pad one MaterialType.NONE row so table gathers stay legal —
    # nothing matches it, so lanes that somehow land on it are absorbed.
    m = max(len(materials), 1)
    typ = np.zeros((m,), _i32)
    flags = np.zeros((m,), _i32)
    albedo = np.zeros((m, 4), _f32)
    albedo_tex = np.full((m,), -1, _i32)
    emissive = np.zeros((m, 4), _f32)
    emissive_tex = np.full((m,), -1, _i32)
    p0 = np.zeros((m, 4), _f32)
    p1 = np.zeros((m, 4), _f32)
    p2 = np.zeros((m, 4), _f32)
    normal_tex = np.full((m,), -1, _i32)
    rgl_id = np.full((m,), -1, _i32)
    opacity_tex = np.full((m,), -1, _i32)
    spec_tex = np.full((m,), -1, _i32)

    for i, mat in enumerate(materials):
        if mat.two_sided:
            flags[i] |= MaterialFlags.TWO_SIDED
        if mat.normal_map is not None:
            normal_tex[i] = collector.add(mat.normal_map)
        if isinstance(mat, B.Lambertian):
            typ[i] = MaterialType.LAMBERTIAN
            albedo[i], albedo_tex[i] = _tex_or_color(mat.albedo, collector)
        elif isinstance(mat, B.GGX):
            typ[i] = MaterialType.GGX
            albedo[i], albedo_tex[i] = _tex_or_color(mat.albedo, collector)
            r = mat.roughness
            if np.isscalar(r):
                r = (r, r)
            p0[i, 0:2] = np.maximum(np.asarray(r, _f32), 1e-4)
        elif isinstance(mat, B.Glass):
            typ[i] = MaterialType.GLASS
            ior = np.asarray(mat.ior, _f32).reshape(-1)
            if ior.size == 1:
                ior = np.repeat(ior, 4)
            elif ior.size == 3:
                ior = np.concatenate([ior, ior[-1:]])
            p0[i] = ior
            p1[i] = B._vec4(mat.absorption, nir=0.0) if np.asarray(mat.absorption).size != 4 else np.asarray(mat.absorption, _f32)
            albedo[i] = 1.0
        elif isinstance(mat, B.Mirror):
            typ[i] = MaterialType.MIRROR
            albedo[i], albedo_tex[i] = _tex_or_color(mat.color, collector, default=(1, 1, 1))
        elif isinstance(mat, B.ModPhong):
            typ[i] = MaterialType.MODPHONG
            albedo[i], albedo_tex[i] = _tex_or_color(mat.diffuse, collector)
            # map_Ks: textured specular sampled at shade time
            # (material_modphong.hpp:129-146; import.hpp:364-367).
            p1[i], spec_tex[i] = _tex_or_color(mat.specular, collector)
            spec = p1[i]
            p0[i, 0] = mat.shininess
            if isinstance(mat.opacity, B.Texture):
                # map_d / diffuse-alpha opacity (material_modphong.hpp:136-146);
                # sampled .r at shade time, constant slot unused.
                opacity_tex[i] = collector.add(mat.opacity)
                p0[i, 1] = 1.0
            else:
                p0[i, 1] = float(mat.opacity)
            p0[i, 3] = max(float(getattr(mat, "ior", 1.0)), 1.0)
            p2[i] = B._vec4(getattr(mat, "transmissive", (0.0, 0.0, 0.0)))
            # Lobe-selection probability from relative energies
            # (material_modphong.hpp:213-220): ps = max(spec)/(max(diff)+max(spec)).
            # Stored for reference/debugging only — the shader recomputes ps
            # from the SHADE-TIME textured kd/ks (bsdf._modphong_eval) so the
            # sampling density and the MIS pdf always agree.
            kd = float(np.max(albedo[i][:3]))
            ks = float(np.max(spec[:3]))
            p0[i, 2] = ks / (kd + ks) if (kd + ks) > 0 else 0.0
            emissive[i], emissive_tex[i] = _tex_or_color(mat.emissive, collector)
        elif isinstance(mat, B.PhaseIso):
            typ[i] = MaterialType.PHASE_ISO
            albedo[i], albedo_tex[i] = _tex_or_color(mat.albedo, collector, default=(1, 1, 1))
        elif isinstance(mat, B.LightDiffuse):
            typ[i] = MaterialType.LIGHT_DIFFUSE
            emissive[i], emissive_tex[i] = _tex_or_color(mat.radiance, collector)
        elif isinstance(mat, B.LightSpot):
            typ[i] = MaterialType.LIGHT_SPOT
            emissive[i], emissive_tex[i] = _tex_or_color(mat.radiance, collector)
            p0[i, 0] = np.cos(mat.half_angle)
        elif isinstance(mat, B.LightTof):
            typ[i] = MaterialType.LIGHT_TOF
            flags[i] |= MaterialFlags.TOF_LIGHT
            emissive[i] = (0.0, 0.0, 0.0, mat.radiance_w)
            p0[i, 0] = np.cos(mat.half_angle)
        elif isinstance(mat, B.RGLMaterial):
            typ[i] = MaterialType.RGL
            rgl_id[i] = rgl_names.get(mat.table_name, -1)
        else:
            raise TypeError(f"unknown material {mat!r}")

    return MaterialTable(
        typ=jnp.asarray(typ),
        flags=jnp.asarray(flags),
        albedo=jnp.asarray(albedo),
        albedo_tex=jnp.asarray(albedo_tex),
        emissive=jnp.asarray(emissive),
        emissive_tex=jnp.asarray(emissive_tex),
        p0=jnp.asarray(p0),
        p1=jnp.asarray(p1),
        normal_tex=jnp.asarray(normal_tex),
        rgl_id=jnp.asarray(rgl_id),
        p2=jnp.asarray(p2),
        opacity_tex=jnp.asarray(opacity_tex),
        spec_tex=jnp.asarray(spec_tex),
    )


def _flatten_animations(anims) -> AnimTable:
    n = len(anims)
    kmax = 1
    for a in anims:
        if a is not None:
            kmax = max(kmax, len(a.times))
    times = np.full((n, kmax), np.inf, _f32)
    trans = np.zeros((n, kmax, 3), _f32)
    rot = np.zeros((n, kmax, 4), _f32)
    rot[..., 3] = 1.0
    scale = np.ones((n, kmax, 3), _f32)
    nkeys = np.ones((n,), _i32)
    times[:, 0] = 0.0
    for i, a in enumerate(anims):
        if a is None:
            continue
        k = len(a.times)
        nkeys[i] = k
        times[i, :k] = np.asarray(a.times, _f32)
        for j, tf in enumerate(a.transformations):
            trans[i, j] = np.asarray(tf.translation)
            rot[i, j] = np.asarray(tf.rotation)
            scale[i, j] = np.asarray(tf.scale)
        # pad tail with last keyframe so clamping works
        trans[i, k:] = trans[i, k - 1]
        rot[i, k:] = rot[i, k - 1]
        scale[i, k:] = scale[i, k - 1]
    return AnimTable(
        times=jnp.asarray(times),
        trans=jnp.asarray(trans),
        rot=jnp.asarray(rot),
        scale=jnp.asarray(scale),
        nkeys=jnp.asarray(nkeys),
    )


def _bake_transform(tf: Optional[Transformation], pos, nrm, tan):
    if tf is None:
        return pos, nrm, tan
    t = np.asarray(tf.translation, _f32)
    q = np.asarray(tf.rotation, _f32)
    s = np.asarray(tf.scale, _f32)

    def rot(v):
        u, w = q[:3], q[3]
        tq = 2.0 * np.cross(u, v)
        return v + w * tq + np.cross(u, tq)

    pos = rot(pos * s) + t
    if nrm is not None:
        nn = rot(nrm / s)
        nrm = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-20)
    if tan is not None:
        tn = rot(tan * s)
        tan = tn / np.maximum(np.linalg.norm(tn, axis=-1, keepdims=True), 1e-20)
    return pos, nrm, tan


def _host_eval_anim(anim, t: float):
    """Host-side keyframe evaluation (numpy mirror of animation.eval_animation):
    returns (R [3,3] incl. scale, translation [3])."""
    times = np.asarray(anim.times, np.float64)
    k = int(np.clip(np.searchsorted(times, t, side="right") - 1, 0, len(times) - 1))
    k1 = min(k + 1, len(times) - 1)
    t0k, t1k = times[k], times[k1]
    alpha = 0.0 if t1k <= t0k else float(np.clip((t - t0k) / (t1k - t0k), 0.0, 1.0))
    tf0, tf1 = anim.transformations[k], anim.transformations[k1]

    def npv(x):
        return np.asarray(x, np.float64).reshape(-1)

    tr = npv(tf0.translation) * (1 - alpha) + npv(tf1.translation) * alpha
    s = npv(tf0.scale) * (1 - alpha) + npv(tf1.scale) * alpha
    q0, q1 = npv(tf0.rotation), npv(tf1.rotation)
    dotq = float(np.dot(q0, q1))
    if dotq < 0:
        q1, dotq = -q1, -dotq
    if dotq > 0.9995:
        q = q0 * (1 - alpha) + q1 * alpha
    else:
        th = np.arccos(np.clip(dotq, -1.0, 1.0))
        q = (np.sin((1 - alpha) * th) * q0 + np.sin(alpha * th) * q1) / np.sin(th)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return rot * s[None, :], tr


def _swept_aabbs(amin, amax, prim_anim, scene, t0: float, t1: float, n_samples: int = 16):
    """Conservative world AABBs for animated prims: union the object box's 8
    transformed corners over sampled times in [t0, t1] plus every keyframe time
    inside the interval, then inflate 1% (the reference sweeps rotations the
    same way, hitable_triangle.hpp:336-395)."""
    amin = amin.copy()
    amax = amax.copy()
    for aid in np.unique(prim_anim):
        if aid == 0:
            continue
        anim = scene._animations[aid]
        times = set(np.linspace(t0, t1, n_samples).tolist())
        times.update(t for t in np.asarray(anim.times, np.float64) if t0 <= t <= t1)
        sel = prim_anim == aid
        bmin, bmax = amin[sel], amax[sel]
        corners = np.stack([
            np.where(np.array(bits)[None, :] > 0, bmax, bmin)
            for bits in [(i >> 2 & 1, i >> 1 & 1, i & 1) for i in range(8)]
        ], axis=1)  # [P, 8, 3]
        new_min = np.full_like(bmin, np.inf)
        new_max = np.full_like(bmax, -np.inf)
        for t in sorted(times):
            rot, tr = _host_eval_anim(anim, float(t))
            tc = corners @ rot.T + tr[None, None, :]
            new_min = np.minimum(new_min, tc.min(axis=1))
            new_max = np.maximum(new_max, tc.max(axis=1))
        pad = 0.01 * (new_max - new_min) + 1e-6
        amin[sel] = (new_min - pad).astype(np.float32)
        amax[sel] = (new_max + pad).astype(np.float32)
    return amin, amax


def build_alias_table(weights: np.ndarray):
    """Vose alias-table construction (O(L)); returns (prob, alias, norm_w).

    With equal weights every prob is exactly 1.0, so alias sampling is
    bit-identical to a plain uniform pick.
    """
    w = np.asarray(weights, np.float64)
    L = w.shape[0]
    total = w.sum()
    if not np.isfinite(total) or total <= 0.0:
        w = np.ones((L,), np.float64)
        total = float(L)
    w = w / total
    scaled = w * L
    prob = np.ones((L,), np.float64)
    alias = np.arange(L, dtype=np.int64)
    small = [i for i in range(L) if scaled[i] < 1.0]
    large = [i for i in range(L) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(_f32), alias.astype(_i32), w.astype(_f32)


def _light_power_weights(light_ids, tri_e1, tri_e2, tri_mat, sph_r, sph_mat,
                         n_tri, mat_typ, mat_emissive, mat_p0):
    """Per-hot-spot emitted power: area x luminance x cone fraction.

    Textured emitters (emissive constant = 1) weigh by area alone — any
    positive weight keeps the estimator unbiased; power-proportional picking
    just minimizes variance (SURVEY.md section 7 "NEE cost model").
    """
    ids = np.asarray(light_ids, np.int64)
    is_tri = ids < n_tri
    area = np.empty(ids.shape, np.float64)
    mat = np.empty(ids.shape, np.int64)
    if np.any(is_tri):
        ti = ids[is_tri]
        area[is_tri] = 0.5 * np.linalg.norm(
            np.cross(tri_e1[ti], tri_e2[ti]), axis=-1)
        mat[is_tri] = tri_mat[ti]
    if np.any(~is_tri):
        si = ids[~is_tri] - n_tri
        area[~is_tri] = 4.0 * np.pi * np.asarray(sph_r)[si] ** 2
        mat[~is_tri] = np.asarray(sph_mat)[si]
    lum = np.maximum(mat_emissive[mat, :3].max(axis=-1), mat_emissive[mat, 3])
    # Spot/ToF cone: emission only within the opening angle
    # (light_spot.hpp:32-75); power scales with the cone's solid-angle share.
    is_cone = (mat_typ[mat] == MaterialType.LIGHT_SPOT) | (
        mat_typ[mat] == MaterialType.LIGHT_TOF)
    cone_frac = np.where(is_cone, 0.5 * (1.0 - mat_p0[mat, 0]), 1.0)
    return area * lum * np.maximum(cone_frac, 0.0)


def flatten_scene(scene, max_image_dim: int = 2048, use_bvh=None,
                  t0: float = 0.0, t1: float = 0.0,
                  light_sampling: str = "power") -> SceneArrays:
    collector = _TextureCollector()

    rgl_names = {name: i for i, name in enumerate(scene._rgl_tables)}
    # Pre-resolve materials attached inline to instances/spheres so they are
    # registered in scene._materials BEFORE the table is flattened (inline
    # Material objects are take()n on first resolve).
    for inst, _hot in scene._instances:
        scene._resolve_material(inst.material)
    for sph, _hot in scene._spheres:
        scene._resolve_material(sph.material)
    for med in scene._media:
        scene._resolve_material(med.phase)
    materials = _flatten_materials(scene._materials, collector, rgl_names)

    # --- triangles ---------------------------------------------------------
    p0s, e1s, e2s = [], [], []
    v1s, v2s = [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    t0s, t1s, t2s = [], [], []
    mats, anims_idx, flags_list = [], [], []
    tri_hot = []
    tri_count = 0
    light_prims = []

    def add_instance(inst: B.MeshInstance, hot: bool):
        nonlocal tri_count
        mesh = inst.mesh
        mat_id = scene._resolve_material(inst.material)
        pos = mesh.positions
        nrm = mesh.normals
        uv = mesh.texcoords
        tan = mesh.tangents
        if nrm is None:
            nrm = compute_normals(pos, mesh.indices)
        if tan is None and uv is not None:
            tan = compute_tangents(pos, nrm, uv, mesh.indices)
        anim_id = inst.animation if inst.animation is not None else 0
        # The instance transformation is always baked into the vertices; a
        # keyframe animation applies ON TOP at ray time (the reference's
        # TRANSFORM + ANIMATE template combination, hitable_triangle.hpp:446-511).
        pos, nrm, tan = _bake_transform(inst.transformation, pos, nrm, tan)
        f = mesh.indices
        nf = len(f)
        v0, v1, v2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
        p0s.append(v0)
        v1s.append(v1)
        v2s.append(v2)
        e1s.append(v1 - v0)
        e2s.append(v2 - v0)
        n0s.append(nrm[f[:, 0]])
        n1s.append(nrm[f[:, 1]])
        n2s.append(nrm[f[:, 2]])
        flg = 0
        if uv is not None:
            uv0s.append(uv[f[:, 0]]); uv1s.append(uv[f[:, 1]]); uv2s.append(uv[f[:, 2]])
            flg |= 1
        else:
            z = np.zeros((nf, 2), _f32)
            uv0s.append(z); uv1s.append(z); uv2s.append(z)
        if tan is not None:
            t0s.append(tan[f[:, 0]]); t1s.append(tan[f[:, 1]]); t2s.append(tan[f[:, 2]])
            flg |= 2
        else:
            z3 = np.zeros((nf, 3), _f32)
            t0s.append(z3); t1s.append(z3); t2s.append(z3)
        mats.append(np.full((nf,), mat_id, _i32))
        anims_idx.append(np.full((nf,), anim_id, _i32))
        flags_list.append(np.full((nf,), flg, _i32))
        if hot:
            light_prims.extend(range(tri_count, tri_count + nf))
        tri_count += nf

    for inst, hot in scene._instances:
        add_instance(inst, hot)

    if tri_count:
        tris = Triangles(
            p0=jnp.asarray(np.concatenate(p0s).astype(_f32)),
            e1=jnp.asarray(np.concatenate(e1s).astype(_f32)),
            e2=jnp.asarray(np.concatenate(e2s).astype(_f32)),
            n0=jnp.asarray(np.concatenate(n0s).astype(_f32)),
            n1=jnp.asarray(np.concatenate(n1s).astype(_f32)),
            n2=jnp.asarray(np.concatenate(n2s).astype(_f32)),
            uv0=jnp.asarray(np.concatenate(uv0s).astype(_f32)),
            uv1=jnp.asarray(np.concatenate(uv1s).astype(_f32)),
            uv2=jnp.asarray(np.concatenate(uv2s).astype(_f32)),
            tan0=jnp.asarray(np.concatenate(t0s).astype(_f32)),
            tan1=jnp.asarray(np.concatenate(t1s).astype(_f32)),
            tan2=jnp.asarray(np.concatenate(t2s).astype(_f32)),
            mat=jnp.asarray(np.concatenate(mats)),
            anim=jnp.asarray(np.concatenate(anims_idx)),
            flags=jnp.asarray(np.concatenate(flags_list)),
            v1=jnp.asarray(np.concatenate(v1s).astype(_f32)),
            v2=jnp.asarray(np.concatenate(v2s).astype(_f32)),
        )
    else:
        z3 = jnp.zeros((0, 3), jnp.float32)
        z2 = jnp.zeros((0, 2), jnp.float32)
        zi = jnp.zeros((0,), jnp.int32)
        tris = Triangles(z3, z3, z3, z3, z3, z3, z2, z2, z2, z3, z3, z3, zi, zi, zi,
                         v1=z3, v2=z3)

    # --- spheres -----------------------------------------------------------
    sc, sr, sm, sa = [], [], [], []
    for sph, hot in scene._spheres:
        mat_id = scene._resolve_material(sph.material)
        center = np.asarray(sph.center, _f32)
        radius = float(sph.radius)
        if sph.transformation is not None:
            tf = sph.transformation
            center = center * np.asarray(tf.scale, _f32)
            # rotate center
            q = np.asarray(tf.rotation, _f32)
            u, w = q[:3], q[3]
            tq = 2.0 * np.cross(u, center)
            center = center + w * tq + np.cross(u, tq) + np.asarray(tf.translation, _f32)
            radius *= float(np.mean(np.asarray(tf.scale)))
        if hot:
            light_prims.append(tri_count + len(sc))
        sc.append(center)
        sr.append(radius)
        sm.append(mat_id)
        sa.append(sph.animation if sph.animation is not None else 0)
    spheres = Spheres(
        center=jnp.asarray(np.asarray(sc, _f32).reshape(-1, 3)),
        radius=jnp.asarray(np.asarray(sr, _f32)),
        mat=jnp.asarray(np.asarray(sm, _i32)),
        anim=jnp.asarray(np.asarray(sa, _i32)),
    )

    # --- media (hitable_medium.hpp:38-99) ------------------------------------
    n_prims = tri_count + spheres.count
    mt_p0, mt_e1, mt_e2, mt_id = [], [], [], []
    ms_c, ms_r, ms_id = [], [], []
    med_density, med_phase = [], []
    for mi, med in enumerate(scene._media):
        med_density.append(float(med.density))
        med_phase.append(scene._resolve_material(med.phase))
        b = med.boundary
        if isinstance(b, B.SphereObject):
            center = np.asarray(b.center, _f32)
            radius = float(b.radius)
            if b.transformation is not None:
                tf = b.transformation
                center = center + np.asarray(tf.translation, _f32)
                radius *= float(np.max(np.asarray(tf.scale)))
            ms_c.append(center)
            ms_r.append(radius)
            ms_id.append(mi)
        else:
            mesh = b.mesh
            pos, _, _ = _bake_transform(b.transformation, mesh.positions, None, None)
            f = mesh.indices
            v0, v1, v2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
            mt_p0.append(v0)
            mt_e1.append(v1 - v0)
            mt_e2.append(v2 - v0)
            mt_id.append(np.full((len(f),), mi, _i32))
    media = MediumArrays(
        tri_p0=jnp.asarray(np.concatenate(mt_p0) if mt_p0 else np.zeros((0, 3), _f32)),
        tri_e1=jnp.asarray(np.concatenate(mt_e1) if mt_e1 else np.zeros((0, 3), _f32)),
        tri_e2=jnp.asarray(np.concatenate(mt_e2) if mt_e2 else np.zeros((0, 3), _f32)),
        tri_med=jnp.asarray(np.concatenate(mt_id) if mt_id else np.zeros((0,), _i32)),
        sph_center=jnp.asarray(np.asarray(ms_c, _f32).reshape(-1, 3)),
        sph_radius=jnp.asarray(np.asarray(ms_r, _f32).reshape(-1)),
        sph_med=jnp.asarray(np.asarray(ms_id, _i32).reshape(-1)),
        density=jnp.asarray(np.asarray(med_density, _f32).reshape(-1)),
        phase_mat=jnp.asarray(np.asarray(med_phase, _i32).reshape(-1)),
    )

    anims = _flatten_animations(scene._animations)
    textures = collector.build()

    # --- BVH (auto beyond the brute-force sweet spot) ------------------------
    # Small scenes are faster as one dense primitive tile (no gathers); big
    # scenes need the threaded SAH tree (accel/build.py). The threshold was
    # set on the previous accelerator; not yet measured on the H100
    # (ROADMAP S4).
    if use_bvh is None:
        use_bvh = n_prims >= 512
    bvh = None
    if use_bvh and n_prims > 0:
        from ..accel.build import build_bvh_arrays, prim_aabbs

        z03 = np.zeros((0, 3), _f32)
        tri_np = (
            np.concatenate(p0s).astype(_f32) if tri_count else z03,
            np.concatenate(e1s).astype(_f32) if tri_count else z03,
            np.concatenate(e2s).astype(_f32) if tri_count else z03,
            np.concatenate(v1s).astype(_f32) if tri_count else z03,
            np.concatenate(v2s).astype(_f32) if tri_count else z03,
        )
        sph_np = (
            np.asarray(sc, _f32).reshape(-1, 3),
            np.asarray(sr, _f32).reshape(-1),
        )
        aabb_override = None
        tri_anim_np = np.concatenate(anims_idx) if anims_idx else np.zeros((0,), _i32)
        sph_anim_np = np.asarray(sa, _i32).reshape(-1)
        prim_anim = np.concatenate([tri_anim_np, sph_anim_np])
        if np.any(prim_anim != 0):
            amin, amax, _ = prim_aabbs(tri_np[:3], sph_np)
            aabb_override = _swept_aabbs(amin, amax, prim_anim, scene, t0, t1)
        bvh = build_bvh_arrays(tri_np, sph_np, aabb_override=aabb_override,
                               tri_anim=tri_anim_np, sph_anim=sph_anim_np)

    # --- envmap ------------------------------------------------------------
    from ..render.envmap import build_envmap_arrays

    envmap = build_envmap_arrays(scene._envmap)

    # --- light pick table (power-proportional by default; "uniform" restores
    # the reference's uniform pick, wurblpt.hpp:187) ----
    if light_sampling not in ("power", "uniform"):
        raise ValueError(f"light_sampling must be 'power' or 'uniform', got {light_sampling!r}")
    light_ids = np.asarray(sorted(set(light_prims)), _i32)
    lw = lap = lai = None
    plp = pia = None
    if light_ids.size > 0:
        if light_sampling == "power":
            powers = _light_power_weights(
                light_ids,
                np.concatenate(e1s).astype(_f32) if tri_count else np.zeros((0, 3), _f32),
                np.concatenate(e2s).astype(_f32) if tri_count else np.zeros((0, 3), _f32),
                np.concatenate(mats) if tri_count else np.zeros((0,), _i32),
                np.asarray(sr, _f32), np.asarray(sm, _i32), tri_count,
                np.asarray(materials.typ), np.asarray(materials.emissive),
                np.asarray(materials.p0),
            )
            prob, alias, w = build_alias_table(powers)
            lw, lap, lai = jnp.asarray(w), jnp.asarray(prob), jnp.asarray(alias)
            pick_np = np.asarray(w, _f32)
        else:
            pick_np = np.full((light_ids.size,), 1.0 / light_ids.size, _f32)
        # Per-PRIM pick prob + 1/area for the O(1) per-light MIS path
        # (render/lights.lights_pdf_at_hit). Only valid for static lights:
        # areas are flatten-time world space.
        anim_all = np.concatenate([
            np.concatenate(anims_idx) if anims_idx else np.zeros((0,), _i32),
            np.asarray(sa, _i32).reshape(-1),
        ])
        if not np.any(anim_all[light_ids] != 0):
            plp_np = np.zeros((n_prims,), _f32)
            pia_np = np.zeros((n_prims,), _f32)
            plp_np[light_ids] = pick_np
            if tri_count:
                e1_all = np.concatenate(e1s).astype(_f32)
                e2_all = np.concatenate(e2s).astype(_f32)
                tri_lights = light_ids[light_ids < tri_count]
                areas = 0.5 * np.linalg.norm(
                    np.cross(e1_all[tri_lights], e2_all[tri_lights]), axis=-1)
                pia_np[tri_lights] = 1.0 / np.maximum(areas, 1e-20)
            plp, pia = jnp.asarray(plp_np), jnp.asarray(pia_np)

    return SceneArrays(
        tris=tris,
        spheres=spheres,
        materials=materials,
        textures=textures,
        anims=anims,
        bvh=bvh,
        envmap=envmap,
        light_prims=jnp.asarray(light_ids),
        media=media,
        rgl=_stack_rgl(scene),
        light_weights=lw,
        light_alias_prob=lap,
        light_alias_idx=lai,
        prim_light_pick=plp,
        prim_inv_area=pia,
    )


def _stack_rgl(scene):
    from ..materials.rgl import empty_rgl_tables, stack_rgl_tables

    if not scene._rgl_tables:
        return empty_rgl_tables()
    return stack_rgl_tables(scene._rgl_tables.values())
