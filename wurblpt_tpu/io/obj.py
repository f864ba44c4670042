"""OBJ/MTL scene import/export.

Import mirrors the reference's ``importIntoScene`` (import.hpp:206-508):

* parse OBJ + MTL (native C++ parser ``native/src/obj_parser.cpp`` with a
  numpy fallback; the reference vendors tiny_obj_loader),
* per MTL material, heuristically pick Lambertian / Glass / ModPhong
  (import.hpp:288-387) incl. the transmittance/opacity fixups,
* bump maps are converted to normal maps (import.hpp:64-92),
* all geometry per material is merged into one MeshInstance with (v, vn, vt)
  index-tuple dedup and computed smooth normals when absent
  (import.hpp:408-500),
* emissive materials register their instances as hot spots (import.hpp:497).

Export writes the whole scene back to OBJ + MTL (+ PNG textures), the
equivalent of ``Scene::exportToObj`` (scene.hpp:215-240).
"""

from __future__ import annotations

import ctypes
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene import builder as B


class ImportBits:
    """Import flags (import.hpp ImportBit*)."""

    NONE = 0
    INVERTED_TF = 1 << 0          # transmittance stored inverted
    WITH_GLASS = 1 << 1           # allow the Glass heuristic
    TWO_SIDED_MATERIALS = 1 << 2  # wrap everything two-sided
    DISABLE_LIGHT_SOURCES = 1 << 3
    DISABLE_HOT_SPOTS = 1 << 4


@dataclass
class RawObj:
    """Raw parse result: attrib arrays + per-corner index tuples."""

    v: np.ndarray       # [NV, 3]
    vn: np.ndarray      # [NN, 3]
    vt: np.ndarray      # [NT, 2]
    fv: np.ndarray      # [F, 3] int32 (vertex index per corner)
    fn: np.ndarray      # [F, 3] int32 (-1 = absent)
    ft: np.ndarray      # [F, 3] int32 (-1 = absent)
    fmat: np.ndarray    # [F] int32 material id (-1 = none)
    materials: List[dict]


# ---------------------------------------------------------------------------
# Parsing (native fast path + numpy fallback)
# ---------------------------------------------------------------------------

def _load_native():
    from ..native import try_load_library

    lib = try_load_library("wurblpt_obj", ["obj_parser.cpp"])
    if lib is None:
        return None
    lib.wobj_parse.restype = ctypes.c_void_p
    lib.wobj_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.wobj_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    lib.wobj_vertices.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_float)] * 3
    lib.wobj_faces.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 4
    lib.wobj_material_json.restype = ctypes.c_int
    lib.wobj_material_json.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int
    ]
    lib.wobj_free.argtypes = [ctypes.c_void_p]
    return lib


def _parse_native(path: str) -> Optional[RawObj]:
    lib = _load_native()
    if lib is None:
        return None
    h = lib.wobj_parse(
        path.encode(), os.path.dirname(os.path.abspath(path)).encode()
    )
    if not h:
        return None
    try:
        counts = (ctypes.c_longlong * 5)()
        lib.wobj_counts(h, counts)
        nv, nn, nt, nf, nm = (int(c) for c in counts)
        v = np.zeros((max(nv, 1), 3), np.float32)
        vn = np.zeros((max(nn, 1), 3), np.float32)
        vt = np.zeros((max(nt, 1), 2), np.float32)
        lib.wobj_vertices(
            h,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        fv = np.zeros((max(nf, 1), 3), np.int32)
        fn = np.zeros((max(nf, 1), 3), np.int32)
        ft = np.zeros((max(nf, 1), 3), np.int32)
        fm = np.zeros((max(nf, 1),), np.int32)
        lib.wobj_faces(
            h,
            fv.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            fn.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ft.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            fm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        mats = []
        for i in range(nm):
            need = lib.wobj_material_json(h, i, None, 0)
            buf = ctypes.create_string_buffer(need + 1)
            lib.wobj_material_json(h, i, buf, need + 1)
            mats.append(json.loads(buf.value.decode("utf-8", "replace")))
        return RawObj(v[:nv], vn[:nn], vt[:nt], fv[:nf], fn[:nf], ft[:nf],
                      fm[:nf], mats)
    finally:
        lib.wobj_free(h)


def _default_mtl(name: str) -> dict:
    return {
        "name": name, "kd": [0.8, 0.8, 0.8], "ks": [0, 0, 0], "ke": [0, 0, 0],
        "tr": [0, 0, 0], "ns": 0.0, "ni": 1.0, "d": 1.0, "illum": 2,
        "map_kd": {"name": "", "bm": 1.0}, "map_ks": {"name": "", "bm": 1.0},
        "map_ke": {"name": "", "bm": 1.0}, "map_d": {"name": "", "bm": 1.0},
        "map_ns": {"name": "", "bm": 1.0}, "map_bump": {"name": "", "bm": 1.0},
        "map_norm": {"name": "", "bm": 1.0},
    }


def _parse_python(path: str) -> RawObj:
    """Pure-python fallback parser (same subset as the native one)."""
    v, vn, vt = [], [], []
    fv, fn, ft, fm = [], [], [], []
    materials: List[dict] = []
    mat_ids: Dict[str, int] = {}
    cur = -1
    base = os.path.dirname(os.path.abspath(path))

    def parse_mtl_file(p):
        if not os.path.exists(p):
            return
        m = None
        for line in open(p, errors="replace"):
            tok = line.split()
            if not tok:
                continue
            k = tok[0]
            if k == "newmtl":
                name = line.split(None, 1)[1].strip()
                m = _default_mtl(name)
                mat_ids[name] = len(materials)
                materials.append(m)
            elif m is None:
                continue
            elif k in ("Kd", "Ks", "Ke", "Tf"):
                key = {"Kd": "kd", "Ks": "ks", "Ke": "ke", "Tf": "tr"}[k]
                m[key] = [float(x) for x in tok[1:4]]
            elif k == "Ns":
                m["ns"] = float(tok[1])
            elif k == "Ni":
                m["ni"] = float(tok[1])
            elif k == "d":
                m["d"] = float(tok[1])
            elif k == "Tr":
                m["d"] = 1.0 - float(tok[1])
            elif k == "illum":
                m["illum"] = int(tok[1])
            elif k in ("map_Kd", "map_Ks", "map_Ke", "map_d", "map_Ns",
                       "map_bump", "map_Bump", "bump", "norm"):
                key = {"map_Kd": "map_kd", "map_Ks": "map_ks",
                       "map_Ke": "map_ke", "map_d": "map_d",
                       "map_Ns": "map_ns", "map_bump": "map_bump",
                       "map_Bump": "map_bump", "bump": "map_bump",
                       "norm": "map_norm"}[k]
                args = tok[1:]
                bm = 1.0
                i = 0
                while i < len(args) and args[i].startswith("-"):
                    opt = args[i]
                    take = {"-o": 3, "-s": 3, "-t": 3, "-mm": 2}.get(opt, 1)
                    if opt == "-bm":
                        bm = float(args[i + 1])
                    i += 1 + take
                m[key] = {"name": " ".join(args[i:]), "bm": bm}

    for line in open(path, errors="replace"):
        tok = line.split()
        if not tok:
            continue
        k = tok[0]
        if k == "v":
            v.append([float(x) for x in tok[1:4]])
        elif k == "vn":
            vn.append([float(x) for x in tok[1:4]])
        elif k == "vt":
            vt.append([float(x) for x in tok[1:3]])
        elif k == "f":
            corners = []
            for c in tok[1:]:
                parts = (c.split("/") + ["", ""])[:3]
                vi = int(parts[0])
                ti = int(parts[1]) if parts[1] else 0
                ni = int(parts[2]) if parts[2] else 0
                corners.append((
                    vi - 1 if vi > 0 else len(v) + vi,
                    ti - 1 if ti > 0 else (len(vt) + ti if ti else -1),
                    ni - 1 if ni > 0 else (len(vn) + ni if ni else -1),
                ))
            for i in range(2, len(corners)):
                tri = (corners[0], corners[i - 1], corners[i])
                fv.append([t[0] for t in tri])
                ft.append([t[1] for t in tri])
                fn.append([t[2] for t in tri])
                fm.append(cur)
        elif k == "usemtl":
            cur = mat_ids.get(line.split(None, 1)[1].strip(), -1)
        elif k == "mtllib":
            parse_mtl_file(os.path.join(base, line.split(None, 1)[1].strip()))

    def arr(x, w, dt=np.float32):
        return (np.asarray(x, dt).reshape(-1, w) if x
                else np.zeros((0, w), dt))

    return RawObj(arr(v, 3), arr(vn, 3), arr(vt, 2),
                  arr(fv, 3, np.int32), arr(fn, 3, np.int32),
                  arr(ft, 3, np.int32),
                  np.asarray(fm, np.int32) if fm else np.zeros((0,), np.int32),
                  materials)


def load_obj_raw(path: str) -> RawObj:
    """Parse an OBJ (+MTL) file into raw arrays; native parser when available."""
    raw = _parse_native(path)
    if raw is None:
        raw = _parse_python(path)
    return raw


# ---------------------------------------------------------------------------
# Texture loading (importTexture, import.hpp:95-204)
# ---------------------------------------------------------------------------

def bump_to_normal_map(bump: np.ndarray, bump_scaling: float = 8.0) -> np.ndarray:
    """Height map [H,W] in [0,1] -> tangent-space normal map [H,W,3] in [0,1]
    (vectorized import.hpp:64-92 toNormalMap)."""
    h = np.asarray(bump, np.float32)
    if h.ndim == 3:
        h = h[..., 0]
    right = h[:, np.minimum(np.arange(h.shape[1]) + 1, h.shape[1] - 1)]
    left = h[:, np.maximum(np.arange(h.shape[1]) - 1, 0)]
    top = h[np.minimum(np.arange(h.shape[0]) + 1, h.shape[0] - 1), :]
    bottom = h[np.maximum(np.arange(h.shape[0]) - 1, 0), :]
    tx = np.stack([np.full_like(h, 2.0), np.zeros_like(h),
                   bump_scaling * (right - left)], axis=-1)
    ty = np.stack([np.zeros_like(h), np.full_like(h, 2.0),
                   bump_scaling * (top - bottom)], axis=-1)
    n = np.cross(tx, ty)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return (0.5 * (n + 1.0)).astype(np.float32)


def import_texture(path: str, srgb: bool = True,
                   to_normal_map: bool = False,
                   bump_multiplier: float = 1.0,
                   cache: Optional[dict] = None):
    """Load an image file into an ImageTexture (PIL-backed; png/jpg/tga/bmp/
    webp...). Returns None if the file is missing or unreadable; raises
    ImportError if PIL is not installed, so a textured material never
    silently loses its texture."""
    key = (os.path.abspath(path), srgb, to_normal_map, bump_multiplier)
    if cache is not None and key in cache:
        return cache[key]
    tex = None
    from PIL import Image

    try:
        img = Image.open(path)
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr_f = arr.astype(np.float32) / 255.0
        elif arr.dtype == np.uint16:
            arr_f = arr.astype(np.float32) / 65535.0
        else:
            arr_f = arr.astype(np.float32)
        if arr_f.ndim == 2:
            arr_f = arr_f[..., None]
        if to_normal_map:
            arr_f = bump_to_normal_map(arr_f, 8.0 * bump_multiplier)
            tex = B.ImageTexture(image=arr_f, srgb=False)
        else:
            tex = B.ImageTexture(image=arr_f, srgb=srgb)
    except Exception:
        tex = None
    if cache is not None:
        cache[key] = tex
    return tex


# ---------------------------------------------------------------------------
# Import into a Scene (import.hpp:206-508)
# ---------------------------------------------------------------------------

def _material_from_mtl(m: dict, base: str, import_bits: int, tex_cache: dict):
    """The reference's material heuristics (import.hpp:288-387).

    Returns (Material descriptor, is_light).
    """
    dif = np.asarray(m["kd"], np.float32)
    spc = np.asarray(m["ks"], np.float32)
    emi = np.asarray(m["ke"], np.float32)
    tra = np.asarray(m["tr"], np.float32)
    shi, opa, ior = float(m["ns"]), float(m["d"]), float(m["ni"])

    # Fixups (import.hpp:300-308).
    if import_bits & ImportBits.INVERTED_TF:
        tra = 1.0 - tra
    # DELIBERATE divergence from import.hpp:303-306: the reference applies
    # this fixup whenever max(Tf) < 1, so an MTL with NO Tf line (tinyobj
    # default 0,0,0) becomes fully transparent (opacity = average(0) = 0).
    # We additionally require max(Tf) > 0, treating Tf-less materials as
    # opaque — matching every mainstream OBJ consumer; MTLs that really
    # want transparency carry explicit Tf (which both importers then read
    # identically). Found by the round-5 city reference twin.
    if opa >= 1.0 and tra.max() < 1.0 and tra.max() > 0.0:
        opa = float(tra.mean())
        tra = 1.0 - tra
    if opa < 1.0 and tra.max() <= 0.0:
        tra = (1.0 - opa) * dif

    def tex_of(rec, srgb=True, to_nm=False):
        name = rec["name"]
        if not name:
            return None
        p = name if os.path.isabs(name) else os.path.join(base, name)
        return import_texture(p, srgb=srgb, to_normal_map=to_nm,
                              bump_multiplier=rec.get("bm", 1.0),
                              cache=tex_cache)

    normal_map = tex_of(m["map_norm"], srgb=False)
    if normal_map is None:
        normal_map = tex_of(m["map_bump"], srgb=False, to_nm=True)
    dif_tex = tex_of(m["map_kd"])
    dif_tex_alpha = dif_tex is not None and dif_tex.image.shape[-1] in (2, 4)
    no_lights = bool(import_bits & ImportBits.DISABLE_LIGHT_SOURCES)

    has_emission = (emi.max() > 0.0 or m["map_ke"]["name"]) and not no_lights

    if (not dif_tex_alpha and spc.max() <= 0.0 and not m["map_ks"]["name"]
            and not has_emission and opa >= 1.0 and not m["map_d"]["name"]):
        # Lambertian (cheapest; import.hpp:329-338)
        mat = B.Lambertian(albedo=dif_tex if dif_tex is not None else tuple(dif),
                           normal_map=normal_map)
        return mat, False
    if ((import_bits & ImportBits.WITH_GLASS) and dif_tex is None
            and not m["map_ks"]["name"] and emi.max() <= 0.0
            and not m["map_ke"]["name"] and opa < 1.0 and not m["map_d"]["name"]):
        absorption = B.Glass.absorption_from_transparent_color(tuple(dif))
        mat = B.Glass(ior=ior, absorption=absorption, normal_map=normal_map)
        return mat, False
    emissive = (0.0, 0.0, 0.0)
    emissive_tex = None
    if not no_lights:
        emissive = tuple(emi)
        emissive_tex = tex_of(m["map_ke"])
    # Opacity source priority (material_modphong.hpp:136-146): explicit map_d
    # texture > diffuse-map alpha channel > scalar dissolve.
    opa_src = tex_of(m["map_d"], srgb=False)
    if opa_src is None and dif_tex_alpha:
        # import_texture always yields float32 images, so the alpha channel is
        # already in [0, 1].
        alpha = np.asarray(dif_tex.image)[..., -1].astype(np.float32)
        opa_src = B.ImageTexture(image=np.repeat(alpha[..., None], 3, -1),
                                 srgb=False)
    mat = B.ModPhong(
        diffuse=dif_tex if dif_tex is not None else tuple(dif),
        specular=tex_of(m["map_ks"]) or tuple(spc),
        shininess=shi,
        opacity=opa_src if opa_src is not None else opa,
        emissive=emissive_tex if emissive_tex is not None else emissive,
        normal_map=normal_map,
        ior=ior,
        transmissive=tuple(np.clip(tra, 0.0, 1.0)),
    )
    is_light = (float(np.dot(emi, emi)) > 0.0 or emissive_tex is not None) \
        and not no_lights
    return mat, is_light


def _dedup_mesh(raw: RawObj, sel: np.ndarray) -> Optional[B.Mesh]:
    """Merge selected faces into one Mesh with (v,vt,vn) tuple dedup
    (import.hpp:415-479)."""
    if not np.any(sel):
        return None
    fv = raw.fv[sel]
    fn = raw.fn[sel]
    ft = raw.ft[sel]
    have_n = bool(np.all(fn >= 0)) and raw.vn.shape[0] > 0
    have_t = bool(np.all(ft >= 0)) and raw.vt.shape[0] > 0
    tuples = np.stack([fv, fn if have_n else np.zeros_like(fv),
                       ft if have_t else np.zeros_like(fv)], axis=-1)
    flat = tuples.reshape(-1, 3)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    indices = inv.reshape(-1, 3).astype(np.int32)
    positions = raw.v[uniq[:, 0]]
    normals = None
    if have_n:
        normals = raw.vn[uniq[:, 1]]
        ln = np.linalg.norm(normals, axis=-1, keepdims=True)
        ok = np.isfinite(normals).all() and ln.min() > 1e-6
        if not ok:
            normals = None  # invalid normals happen (e.g. Bistro); recompute
        else:
            normals = normals / ln
    texcoords = raw.vt[uniq[:, 2]] if have_t else None
    return B.Mesh(positions=positions, normals=normals, texcoords=texcoords,
                  indices=indices)


def import_into_scene(scene: B.Scene, path: str,
                      transformation=None,
                      import_bits: int = ImportBits.NONE) -> int:
    """Import an OBJ/MTL file into `scene`; returns the number of instances.

    Mirrors importIntoScene (import.hpp:206-508): one merged MeshInstance per
    material, emissive materials as hot spots, optional two-sided wrap.
    """
    raw = load_obj_raw(path)
    base = os.path.dirname(os.path.abspath(path))
    tex_cache: dict = {}
    n_instances = 0

    two_sided = bool(import_bits & ImportBits.TWO_SIDED_MATERIALS)
    no_hotspots = bool(import_bits & ImportBits.DISABLE_HOT_SPOTS)

    for mid in range(-1, len(raw.materials)):
        sel = raw.fmat == mid
        mesh = _dedup_mesh(raw, sel)
        if mesh is None:
            continue
        if mid < 0:
            mat = B.Lambertian(albedo=(0.5, 0.5, 0.5))  # nullMaterial
            is_light = False
            name = None
        else:
            mat, is_light = _material_from_mtl(
                raw.materials[mid], base, import_bits, tex_cache
            )
            name = raw.materials[mid]["name"]
        if two_sided:
            mat.two_sided = True
        mat_id = scene.take_material(mat, name=name)
        scene.take_mesh_instance(
            B.MeshInstance(mesh=mesh, material=mat_id,
                           transformation=transformation),
            hot_spot=is_light and not no_hotspots,
        )
        n_instances += 1
    return n_instances


def import_geometry(path: str) -> List[B.Mesh]:
    """Mesh-only import (importGeometry, import.hpp:511-588): one Mesh per
    used material slot, materials ignored."""
    raw = load_obj_raw(path)
    out = []
    for mid in range(-1, len(raw.materials)):
        mesh = _dedup_mesh(raw, raw.fmat == mid)
        if mesh is not None:
            out.append(mesh)
    return out


# ---------------------------------------------------------------------------
# Export (Scene -> OBJ/MTL/PNG; scene.hpp:215-240 exportToObj)
# ---------------------------------------------------------------------------

def _texture_to_png(tex, path_base: str, fallback_color) -> Optional[str]:
    """Rasterize a texture descriptor to PNG; returns the filename, or None
    for a texture kind that has no raster form. Needs PIL only when there is
    a texture to write, and raises ImportError without it rather than export
    a scene that would re-import untextured."""
    if isinstance(tex, B.ImageTexture):
        img = np.asarray(tex.image, np.float32)
    elif isinstance(tex, B.ConstantTexture):
        img = np.tile(np.asarray(tex.color, np.float32)[None, None, :3], (4, 4, 1))
    elif isinstance(tex, B.CheckerTexture):
        sx, sy = tex.squares
        yy, xx = np.mgrid[0:64, 0:64]
        c = (((xx * sx // 64) + (yy * sy // 64)) % 2).astype(np.float32)
        c1 = np.asarray(tex.color1, np.float32)[:3]
        c2 = np.asarray(tex.color2, np.float32)[:3]
        img = c1[None, None] * (1 - c[..., None]) + c2[None, None] * c[..., None]
    else:
        return None
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    from PIL import Image

    out = path_base + ".png"
    Image.fromarray(
        (np.clip(img[..., :3], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    ).save(out)
    return os.path.basename(out)


def export_scene_to_obj(scene: B.Scene, path: str) -> None:
    """Write the scene's mesh instances to OBJ + MTL (+ PNG textures).

    Spheres are exported as tessellated meshes, like the reference
    (sphere.hpp:64-85). Media have no surface representation and are skipped.
    """
    base, _ = os.path.splitext(path)
    mtl_path = base + ".mtl"
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)

    # Resolve every instance material so the table is complete.
    mat_of_instance = [scene._resolve_material(inst.material)
                       for inst, _ in scene._instances]
    mat_of_sphere = [scene._resolve_material(s.material)
                     for s, _ in scene._spheres]

    names = {}
    with open(mtl_path, "w") as mf:
        for i, mat in enumerate(scene._materials):
            name = f"material_{i}"
            for k, v in scene._material_names.items():
                if v == i:
                    name = k.replace(" ", "_")
            names[i] = name
            mf.write(f"newmtl {name}\n")

            def w_color(key, val, tex, tex_key):
                fn = None
                if isinstance(val, B.Texture):
                    tex, val = val, (1.0, 1.0, 1.0)
                if tex is not None:
                    fn = _texture_to_png(tex, os.path.join(dirname, f"{name}_{key}"),
                                         val)
                c = np.asarray(val, np.float32).reshape(-1)[:3]
                mf.write(f"{key} {c[0]:g} {c[1]:g} {c[2]:g}\n")
                if fn:
                    mf.write(f"{tex_key} {fn}\n")

            # Opaque materials MUST write "Tf 1 1 1": tinyobj defaults a
            # missing Tf to (0,0,0), and the reference's transmittance fixup
            # (import.hpp:303-306) reads "d 1 with max(Tf) < 1" as FULLY
            # TRANSPARENT (opacity = average(Tf) = 0). Round-5 city-twin
            # finding: without Tf lines every exported surface rendered
            # transparent in the reference build (terrain showed the
            # below-horizon sky; closed boxes went black from exhausted
            # path depth). Standard MTL exporters write Tf 1 1 1 for the
            # same reason.
            if isinstance(mat, B.Lambertian):
                w_color("Kd", mat.albedo, None, "map_Kd")
                mf.write("Tf 1 1 1\n")
            elif isinstance(mat, B.ModPhong):
                w_color("Kd", mat.diffuse, None, "map_Kd")
                w_color("Ks", mat.specular, None, "map_Ks")
                w_color("Ke", mat.emissive, None, "map_Ke")
                mf.write(f"Ns {mat.shininess:g}\nd {mat.opacity:g}\n")
                opa = float(np.asarray(mat.opacity, np.float32).reshape(-1)[0]) \
                    if not isinstance(mat.opacity, B.Texture) else 1.0
                tra = np.asarray(mat.transmissive, np.float32).reshape(-1)[:3]
                if opa < 1.0 and tra.max() > 0.0:
                    mf.write(f"Tf {tra[0]:g} {tra[1]:g} {tra[2]:g}\n")
                else:
                    mf.write("Tf 1 1 1\n")
            elif isinstance(mat, B.Glass):
                ior = np.asarray(mat.ior, np.float32).reshape(-1)
                mf.write(f"Ni {float(ior[0]):g}\nd 0.1\nillum 7\n")
            elif isinstance(mat, B.Mirror):
                w_color("Ks", mat.color, None, "map_Ks")
                mf.write("illum 5\nTf 1 1 1\n")
            elif isinstance(mat, (B.LightDiffuse, B.LightSpot)):
                w_color("Ke", mat.radiance, None, "map_Ke")
                mf.write("Tf 1 1 1\n")
            elif isinstance(mat, B.GGX):
                w_color("Kd", mat.albedo, None, "map_Kd")
                r = np.mean(np.asarray(mat.roughness, np.float32))
                mf.write(f"Ns {max(2.0 / max(r * r, 1e-4) - 2.0, 0.0):g}\n")
                mf.write("Tf 1 1 1\n")
            else:
                mf.write("Kd 0.8 0.8 0.8\nTf 1 1 1\n")
            if mat.normal_map is not None:
                fn = _texture_to_png(mat.normal_map,
                                     os.path.join(dirname, f"{name}_norm"),
                                     (0.5, 0.5, 1.0))
                if fn:
                    mf.write(f"norm {fn}\n")
            mf.write("\n")

    from ..scene.generator import generate_sphere, transform_mesh

    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        v_off = 1
        n_off = 1
        t_off = 1

        def write_mesh(mesh: B.Mesh, mat_id: int, tf, tag: str):
            nonlocal v_off, n_off, t_off
            pos, nrm, uv = mesh.positions, mesh.normals, mesh.texcoords
            if tf is not None:
                from ..scene.flatten import _bake_transform

                pos, nrm, _ = _bake_transform(tf, pos, nrm, None)
            if nrm is None:
                from ..scene.geometryproc import compute_normals

                nrm = compute_normals(pos, mesh.indices)
            f.write(f"o {tag}\nusemtl {names[mat_id]}\n")
            for p in pos:
                f.write(f"v {p[0]:g} {p[1]:g} {p[2]:g}\n")
            for n in nrm:
                f.write(f"vn {n[0]:g} {n[1]:g} {n[2]:g}\n")
            if uv is not None:
                for t in uv:
                    f.write(f"vt {t[0]:g} {t[1]:g}\n")
            for tri in mesh.indices:
                if uv is not None:
                    f.write("f " + " ".join(
                        f"{c + v_off}/{c + t_off}/{c + n_off}" for c in tri
                    ) + "\n")
                else:
                    f.write("f " + " ".join(
                        f"{c + v_off}//{c + n_off}" for c in tri
                    ) + "\n")
            v_off += len(pos)
            n_off += len(nrm)
            if uv is not None:
                t_off += len(uv)

        for i, (inst, _) in enumerate(scene._instances):
            write_mesh(inst.mesh, mat_of_instance[i], inst.transformation,
                       f"instance_{i}")
        for i, (sph, _) in enumerate(scene._spheres):
            mesh = transform_mesh(
                generate_sphere(radius=float(sph.radius), slices=40, stacks=20),
                translate=tuple(np.asarray(sph.center, np.float32)),
            )
            write_mesh(mesh, mat_of_sphere[i], sph.transformation,
                       f"sphere_{i}")
