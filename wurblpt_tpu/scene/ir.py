"""Scene intermediate representation: structure-of-arrays pytrees.

The reference scene is a pointer graph of virtual ``Hitable``/``Material``/``Texture``
objects (``libwurblpt/scene.hpp:55-241``). That design cannot run as one batched
device program. Here the scene is *data*: flat SoA jnp arrays bundled in NamedTuple
pytrees that are traced through jit and shard_map, replicated in every device's
memory (SURVEY.md section 2.2
"scene replication"). Virtual dispatch becomes integer type codes + masked
evaluation; per-object pointers become integer indices.

Channel convention: radiance/attenuation/refractive-index are 4-vectors
(RGB + NIR) exactly like the reference's vec4 pipeline (``ray.hpp:36-57``); the NIR
channel drives the AMCW Time-of-Flight sensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..materials.rgl import RGLTables


# Material type codes (replaces virtual Material* dispatch, material.hpp:129-271).
class MaterialType:
    NONE = 0
    LAMBERTIAN = 1       # material_lambertian.hpp
    GGX = 2              # material_ggx.hpp (anisotropic, VNDF-sampled)
    GLASS = 3            # material_glass.hpp (dielectric + dispersion)
    MIRROR = 4           # material_mirror.hpp
    MODPHONG = 5         # material_modphong.hpp
    PHASE_ISO = 6        # material_phase_function_isotropic.hpp
    LIGHT_DIFFUSE = 7    # light_diffuse.hpp
    LIGHT_SPOT = 8       # light_spot.hpp
    LIGHT_TOF = 9        # light_tof.hpp
    RGL = 10             # material_rgl.hpp (measured BRDF tables)
    COUNT = 11


# Material flag bits.
class MaterialFlags:
    TWO_SIDED = 1 << 0       # MaterialTwoSided wrapper semantics (material.hpp:273-334)
    TOF_LIGHT = 1 << 1       # isTofLight() (material.hpp:188-191)


# Texture type codes (texture.hpp built-ins + texture_image/noise).
class TextureType:
    CONSTANT = 0
    CHECKER = 1
    IMAGE = 2
    VALUE_NOISE = 3
    GRADIENT_NOISE = 4
    WORLEY_NOISE = 5
    PERLIN_NOISE = 6


class Triangles(NamedTuple):
    """One record per triangle; object-space geometry + per-instance indices.

    Replaces HitableTriangle's 16 template instantiations + pointer packing
    (``hitable_triangle.hpp:37-143``) with dense arrays; absence of texcoords or
    tangents is encoded as zeros + flags rather than template parameters.
    """

    p0: jnp.ndarray        # [T, 3] vertex 0 position
    e1: jnp.ndarray        # [T, 3] v1 - v0
    e2: jnp.ndarray        # [T, 3] v2 - v0
    n0: jnp.ndarray        # [T, 3] shading normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray       # [T, 2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    tan0: jnp.ndarray      # [T, 3] shading tangents (zeros if absent)
    tan1: jnp.ndarray
    tan2: jnp.ndarray
    mat: jnp.ndarray       # [T] int32 material index
    anim: jnp.ndarray      # [T] int32 animation index (0 = static identity)
    flags: jnp.ndarray     # [T] int32: bit0 has_texcoords, bit1 has_tangents
    # Absolute vertex positions for the WATERTIGHT intersection path
    # (intersect.watertight_tri): shared vertices must be bit-identical across
    # neighboring triangles, which p0 + e1 (rounded) cannot guarantee.
    v1: jnp.ndarray = None  # [T, 3]
    v2: jnp.ndarray = None  # [T, 3]

    @property
    def count(self):
        return self.p0.shape[0]


class Spheres(NamedTuple):
    """Analytic spheres (``hitable_sphere.hpp:34-220``). Object space: the sphere
    sits at `center` with `radius`; its animation transform moves/rotates it."""

    center: jnp.ndarray    # [S, 3]
    radius: jnp.ndarray    # [S]
    mat: jnp.ndarray       # [S] int32
    anim: jnp.ndarray      # [S] int32

    @property
    def count(self):
        return self.center.shape[0]


class MaterialTable(NamedTuple):
    """SoA material parameter table; `typ` selects the BSDF model per lane.

    Packing of the generic parameter slots p0/p1 by type:
      GGX:          p0.xy = roughness (anisotropic)
      GLASS:        p0 = per-channel refractive index (RGB+NIR), p1 = absorption
      MODPHONG:     p0.x = shininess, p0.y = opacity, p0.z = spec probability,
                    p0.w = index of refraction (pass-through),
                    p1 = specular color (RGB+NIR), p2 = transmissive color
      LIGHT_SPOT:   p0.x = cos(half opening angle)
      LIGHT_TOF:    p0.x = cos(half opening angle); emissive.w = NIR radiance
      PHASE_ISO:    albedo = single-scattering albedo
    """

    typ: jnp.ndarray          # [M] int32 MaterialType
    flags: jnp.ndarray        # [M] int32 MaterialFlags
    albedo: jnp.ndarray       # [M, 4] RGB+NIR base color / F0
    albedo_tex: jnp.ndarray   # [M] int32 texture id (-1 = use albedo constant)
    emissive: jnp.ndarray     # [M, 4]
    emissive_tex: jnp.ndarray # [M] int32
    p0: jnp.ndarray           # [M, 4]
    p1: jnp.ndarray           # [M, 4]
    normal_tex: jnp.ndarray   # [M] int32 (-1 = no normal map)
    rgl_id: jnp.ndarray       # [M] int32 index into RGL table stack (-1 = none)
    p2: jnp.ndarray = None    # [M, 4] extra params (MODPHONG: transmissive)
    opacity_tex: jnp.ndarray = None  # [M] int32 opacity texture, .r channel
    #                                  (material_modphong.hpp:136-146 map_d /
    #                                  diffuse-alpha; -1 = constant p0.y)
    spec_tex: jnp.ndarray = None     # [M] int32 specular texture (map_Ks,
    #                                  material_modphong.hpp:129-146 /
    #                                  import.hpp:364-367); -1 = constant p1.
    #                                  Sampled at shade time; the ModPhong
    #                                  lobe-pick probability is then computed
    #                                  from the SAME shade-time kd/ks as the
    #                                  mixture pdf (material_modphong.hpp:
    #                                  213-239) so sample and pdf agree.

    @property
    def count(self):
        return self.typ.shape[0]


class TextureTable(NamedTuple):
    """Flattened texture descriptors + one padded image stack.

    TextureTransformer nesting (``texture.hpp:207-246``) is flattened at build
    time into per-texture uv/value affine transforms. Image texels live in a
    single padded stack `img_data`; bilinear filtering + wrap happens at sample
    time (semantics of ``texture_image.hpp:182-212``).
    """

    typ: jnp.ndarray          # [NT] int32 TextureType
    params: jnp.ndarray       # [NT, 8] f32: CONSTANT: [0:4]=color;
                              #   CHECKER: [0:4]=color1,[4:8]=color2 (uses uv_scale for frequency)
                              #   NOISE types: [0]=octaves/cells, [1]=gain... (see texture code)
    uv_scale: jnp.ndarray     # [NT, 2]
    uv_offset: jnp.ndarray    # [NT, 2]
    val_scale: jnp.ndarray    # [NT, 4]
    val_offset: jnp.ndarray   # [NT, 4]
    image_id: jnp.ndarray     # [NT] int32 into image stack (-1 = none)
    img_data: jnp.ndarray     # [NI, H, W, 4] float16 linear texels (padded stack)
    img_hw: jnp.ndarray       # [NI, 2] int32 actual (h, w)

    @property
    def count(self):
        return self.typ.shape[0]


class AnimTable(NamedTuple):
    """Keyframed TRS animation tables (``animation_keyframes.hpp:51-216``).

    Row 0 is always the static identity animation. Keyframe arrays are padded to
    the max keyframe count; `times` padding is +inf so searchsorted lands inside
    the valid range.
    """

    times: jnp.ndarray   # [A, K] f32, sorted, padded +inf
    trans: jnp.ndarray   # [A, K, 3]
    rot: jnp.ndarray     # [A, K, 4] quaternions
    scale: jnp.ndarray   # [A, K, 3]
    nkeys: jnp.ndarray   # [A] int32

    @property
    def count(self):
        return self.times.shape[0]


class BVHArrays(NamedTuple):
    """Flattened threaded BVH (hit-link / miss-link), SoA, gather-packed.

    The reference flattens its SAH tree into 32-byte nodes traversed with an
    explicit stack (``bvh.hpp:217-311``). For SIMD wavefront traversal we instead
    thread the tree: every node knows where to go on AABB-hit (`hit_next`:
    first child for inner nodes, own miss link for leaves after intersecting
    primitives) and on miss (`miss_next`). Traversal is then a branch-free
    while-loop without any per-ray stack.

    Layout is packed for ONE f32 gather + ONE i32 gather per traversal step
    (five separate row gathers per step measured 27 s/frame on the 100k-tri
    bench scene). The leaf width K is static from `leaf_prims.shape[1]`, so
    the leaf tile size is a build-time tuning knob, not a code constant.
    """

    node_f: jnp.ndarray      # [N, 6] f32: min xyz, max xyz
    node_i: jnp.ndarray      # [N, 2] int32: (leaf_row | -1 inner, miss_next)
    leaf_prims: jnp.ndarray  # [L, K] int32 global prim ids, padded -1
    # Leaf-PACKED geometry: one contiguous [K*9]-float row per leaf so a leaf
    # visit costs ONE row gather per lane instead of K per-prim row gathers.
    # Triangle slots
    # hold [v0, v1, v2]; sphere slots hold [center, radius, 0...]; the prim id
    # in leaf_prims tells which. leaf_anim carries per-slot animation ids.
    leaf_geom: jnp.ndarray = None   # [L, K, 9] f32
    leaf_anim: jnp.ndarray = None   # [L, K] int32
    # Per-octant front-to-back threading, flattened [8*N, 3] int32 rows of
    # (leaf_row, hit_next, miss_next); row = octant * N + node. Near-child-
    # first order per ray direction octant lets best_t prune far subtrees
    # (the classic stack traversal's ordering without a stack).
    node_oct: jnp.ndarray = None
    # WIDE nodes (accel.build._collapse_wide): [M, W*7] f32 rows packing all
    # W children's AABBs + int32 links (bitcast to f32) of one W-ary node —
    # one row gather slab-tests W children at once, and an exact per-lane
    # near-first short stack (one-hot push/pop, accel.traverse) replaces the
    # octant threading. W = wide_nodes.shape[1] // 7.
    wide_nodes: jnp.ndarray = None
    # Shape-only carrier for the traversal stack depth: [D] uint8 zeros.
    # (A plain int field would become a traced leaf of the pytree; a static
    # shape survives jit/shard_map unchanged.)
    wide_meta: jnp.ndarray = None


class EnvMapArrays(NamedTuple):
    """Environment map raster + importance/alias tables (``envmap.hpp:44-286``).

    `kind`: 0 none, 1 equirect, 2 cube, 3 constant. The importance table lives on
    the parameterization-independent equal-area square map (envmap.hpp:53-109);
    sampling uses an O(1) alias table instead of the reference's binary search.
    """

    kind: jnp.ndarray          # [] int32
    const_radiance: jnp.ndarray  # [4]
    image: jnp.ndarray         # equirect: [H, W, 4]; cube: [6, H, W, 4]; else [1,1,4]
    # Importance sampling tables over an R x R equal-area grid:
    pdf_table: jnp.ndarray     # [R, R] f32 (solid-angle pdf per cell; 0-size if no IS)
    alias_prob: jnp.ndarray    # [R*R] f32 alias table acceptance prob
    alias_idx: jnp.ndarray     # [R*R] int32 alias partner
    rotation: jnp.ndarray      # [4] quaternion world-from-map


class MediumArrays(NamedTuple):
    """Homogeneous participating media (``hitable_medium.hpp:38-99`` +
    ``medium.hpp:37-57``).

    Boundary geometry lives OUTSIDE the solid prim arrays: a medium never
    occludes deterministically — each traced segment samples an exponential
    free path against the medium's density and scatters inside with the
    medium's phase-function material. Boundaries are per-medium so overlapping
    media stay independent (the reference nests one BVH per medium).
    """

    tri_p0: jnp.ndarray      # [MT, 3]
    tri_e1: jnp.ndarray      # [MT, 3]
    tri_e2: jnp.ndarray      # [MT, 3]
    tri_med: jnp.ndarray     # [MT] int32 medium id
    sph_center: jnp.ndarray  # [MS, 3]
    sph_radius: jnp.ndarray  # [MS]
    sph_med: jnp.ndarray     # [MS] int32 medium id
    density: jnp.ndarray     # [M] f32 (rho; mean free path = 1/rho)
    phase_mat: jnp.ndarray   # [M] int32 material-table id of the phase function

    @property
    def count(self):
        return self.density.shape[0]


def empty_media() -> MediumArrays:
    z3 = jnp.zeros((0, 3), jnp.float32)
    zi = jnp.zeros((0,), jnp.int32)
    return MediumArrays(
        tri_p0=z3, tri_e1=z3, tri_e2=z3, tri_med=zi,
        sph_center=z3, sph_radius=jnp.zeros((0,), jnp.float32), sph_med=zi,
        density=jnp.zeros((0,), jnp.float32), phase_mat=zi,
    )


class SceneArrays(NamedTuple):
    """The complete device-side scene: everything the render kernels read.

    Replicated per chip; only rays/pixels are sharded (SURVEY.md section 2.2).
    """

    tris: Triangles
    spheres: Spheres
    materials: MaterialTable
    textures: TextureTable
    anims: AnimTable
    bvh: Optional[BVHArrays]
    envmap: EnvMapArrays
    # Hot spots (NEE light list): global prim ids; tri i -> id i, sphere j -> T + j.
    light_prims: jnp.ndarray   # [L] int32
    media: MediumArrays
    # Measured RGL BRDF table stack (materials.rgl_id indexes axis 0); always
    # present so SceneArrays stays a uniform pytree (placeholder when unused).
    rgl: "RGLTables" = None
    # Power-proportional light picking (many-emitter scenes; SURVEY.md section 7
    # "NEE cost model"). None = uniform pick, exactly the reference's
    # wurblpt.hpp:187 — produced by flatten_scene(light_sampling="uniform");
    # the default "power" attaches these tables for every lit scene. When
    # set: `light_weights` are the normalized pick probabilities (the NEE
    # mixture pdf becomes sum w_i * pdf_i), and the alias table gives O(1)
    # sampling. With equal powers the alias pick is bit-identical to the
    # uniform pick.
    light_weights: Optional[jnp.ndarray] = None     # [L] f32
    light_alias_prob: Optional[jnp.ndarray] = None  # [L] f32
    light_alias_idx: Optional[jnp.ndarray] = None   # [L] int32
    # O(1) per-light NEE/MIS support (render/lights.lights_pdf_at_hit): pick
    # probability and 1/area indexed by GLOBAL PRIM id (0 for non-lights /
    # sphere slots). Built for static-light scenes; with these present and
    # >= 8 lights the integrator swaps the O(L) mixture pdf for per-light
    # MIS weights (pick_prob x per-light solid-angle pdf) — unbiased, O(1)
    # per bounce event.
    prim_light_pick: Optional[jnp.ndarray] = None   # [P] f32
    prim_inv_area: Optional[jnp.ndarray] = None     # [P] f32

    @property
    def n_tris(self):
        return self.tris.count

    @property
    def n_spheres(self):
        return self.spheres.count

    @property
    def n_lights(self):
        return self.light_prims.shape[0]


def empty_envmap() -> EnvMapArrays:
    return EnvMapArrays(
        kind=jnp.int32(0),
        const_radiance=jnp.zeros((4,), jnp.float32),
        image=jnp.zeros((1, 1, 4), jnp.float32),
        pdf_table=jnp.zeros((0, 0), jnp.float32),
        alias_prob=jnp.zeros((0,), jnp.float32),
        alias_idx=jnp.zeros((0,), jnp.int32),
        rotation=jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
    )
