"""Next-event-estimation light ("hot spot") sampling and pdf evaluation.

Reference semantics: ``Hitable::pdfValue``/``direction`` for triangles
(``hitable_triangle.hpp:405-443``) and spheres (``hitable_sphere.hpp:155-219``),
combined in the integrator as a uniform pick over hot spots whose mixture pdf is
the average of all per-light solid-angle pdfs (``wurblpt.hpp:181-195``). Here the
per-light pdfs are evaluated batched over a [RAYS x LIGHTS] broadcast.

Cost shape: the reference evaluates the O(L) pdf sum TWICE per bounce
(``wurblpt.hpp:182-184`` for the BSDF branch weight and ``:193-195`` for the
NEE branch). Here both directions needing a mixture pdf at a bounce share one
``lights_pdf_multi`` call (same origin -> `tvec`/`oc` terms computed once),
and the BSDF-direction pdf is carried forward in the loop state so the next
bounce's emitted-MIS weight costs nothing.

ANIMATED emitters: the reference evaluates light geometry at ray time through
the AnimationCache (hitable_triangle.hpp:405-443 uses the cached transform).
Here, when any hot spot is animated, `light_frames` gathers each light's
forward TRS map at each ray's time from the per-trace AnimCtx, and all
pdf/sample/emission math runs on the world-space geometry of that instant —
moving lights keep their full NEE contribution and MIS stays consistent.
Animated SPHERE emitters assume uniform animation scale (the radius is scaled
by the mean column norm of the forward map); anisotropic animated scale would
bias the cone pdf slightly — same limitation as the reference's animated
sphere (hitable_sphere.hpp scales radius by a scalar).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import sampler
from ..core.vecmath import cross, dot, matvec, normalize, safe_sqrt
from ..scene.ir import SceneArrays

_TWO_PI = 2.0 * jnp.pi


def light_anim_ids(scene: SceneArrays):
    """[L] int32 animation id of each hot-spot prim (0 = static)."""
    lp = scene.light_prims
    n_tri = scene.n_tris
    is_tri = lp < n_tri
    a_tri = (
        scene.tris.anim[jnp.clip(lp, 0, max(n_tri - 1, 0))]
        if n_tri > 0 else jnp.zeros_like(lp)
    )
    a_sph = (
        scene.spheres.anim[jnp.clip(lp - n_tri, 0, scene.n_spheres - 1)]
        if scene.n_spheres > 0 else jnp.zeros_like(lp)
    )
    return jnp.where(is_tri, a_tri, a_sph)


def light_frames(scene: SceneArrays, anim_ctx):
    """Per-ray forward frames of every hot spot's animation at ray time.

    Returns (m [N,L,3,3], t [N,L,3]); requires anim_ctx built with
    ``with_forward=True``.
    """
    aid = light_anim_ids(scene)
    return anim_ctx.m_fwd[:, aid], anim_ctx.t_inv[:, aid]


def _light_tri_data(scene: SceneArrays, frames):
    """Triangle geometry for tri hot spots, broadcast-ready as [B,L,3]
    (B=1 static, B=N animated via `frames`). Sphere entries get zeros."""
    lp = scene.light_prims
    n_tri = scene.n_tris
    L = lp.shape[0]
    is_tri = lp < n_tri
    if n_tri == 0:
        z = jnp.zeros((1, L, 3), jnp.float32)
        return is_tri, z, z, z
    ti = jnp.clip(lp, 0, n_tri - 1)
    T = scene.tris
    p0, e1, e2 = T.p0[ti][None], T.e1[ti][None], T.e2[ti][None]
    if frames is not None:
        m, t = frames  # m [N,L,3,3], t [N,L,3]
        p0 = matvec(m, p0) + t
        e1 = matvec(m, e1)
        e2 = matvec(m, e2)
    return is_tri, p0, e1, e2


def _light_sphere_data(scene: SceneArrays, frames):
    lp = scene.light_prims
    n_tri = scene.n_tris
    L = lp.shape[0]
    if scene.n_spheres == 0:
        return jnp.zeros((1, L, 3), jnp.float32), jnp.zeros((1, L), jnp.float32)
    si = jnp.clip(lp - n_tri, 0, scene.n_spheres - 1)
    S = scene.spheres
    center, radius = S.center[si][None], S.radius[si][None]
    if frames is not None:
        m, t = frames
        center = matvec(m, center) + t
        # Sphere radius under TRS scale (uniform scale assumed, like the
        # reference's animated sphere): |M column| = s.
        s_mean = jnp.linalg.norm(m, axis=-2).mean(-1)
        radius = radius * s_mean
    return center, radius


def light_pick_probs(scene: SceneArrays) -> Optional[jnp.ndarray]:
    """[L] normalized pick probability per hot spot, or None for uniform.

    Uniform picking matches the reference (wurblpt.hpp:187). Scenes with many
    emitters of very different power set `light_weights` on SceneArrays via the
    builder; the mixture pdf then becomes sum(w_i * pdf_i) instead of
    (1/L) * sum(pdf_i) — still an unbiased estimator, lower variance.
    """
    w = getattr(scene, "light_weights", None)
    return w


def lights_pdf_multi(
    scene: SceneArrays, origin, dirs, frames=None
) -> jnp.ndarray:
    """Mixture pdf of each of K directions from `origin`.

    origin: [N,3]; dirs: [N,K,3]. Returns [N,K]. The mixture is
    sum_i w_i * pdf_i with w_i the pick probability (uniform 1/L by default,
    wurblpt.hpp:181-185 / :193-195). Terms independent of the direction
    (`tvec`, `oc`, areas, cone angles) are computed once and shared across K.
    """
    L = scene.light_prims.shape[0]
    N, K = dirs.shape[0], dirs.shape[1]
    if L == 0:
        return jnp.zeros((N, K))
    is_tri, p0, e1, e2 = _light_tri_data(scene, frames)
    center, radius = _light_sphere_data(scene, frames)

    o = origin[:, None, None, :]          # [N,1,1,3]
    d = dirs[:, :, None, :]               # [N,K,1,3]
    p0b, e1b, e2b = p0[:, None], e1[:, None], e2[:, None]        # [B,1,L,3]

    # --- triangles: shared direction-independent terms -----------------------
    tvec = o - p0b                                               # [N,1,L,3]
    fn = jnp.cross(e1b, e2b)                                     # [B,1,L,3]
    fn_len = jnp.linalg.norm(fn, axis=-1)
    area = 0.5 * fn_len
    n_unit = fn / jnp.maximum(fn_len, 1e-20)[..., None]
    qvec = jnp.cross(tvec, e1b)                                  # [N,1,L,3]

    # --- triangles: per-direction -------------------------------------------
    pvec = jnp.cross(d, e2b)                                     # [N,K,L,3]
    det = jnp.sum(e1b * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2b * qvec, axis=-1) * inv_det
    tri_hit = (jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    cos_l = jnp.abs(jnp.sum(d * n_unit, axis=-1))
    # Triangle pdf: t^2 / (|cos| * area) (hitable_triangle.hpp:405-423).
    pdf_tri = jnp.where(tri_hit, t * t / jnp.maximum(cos_l * area, 1e-12), 0.0)

    # --- spheres: shared ------------------------------------------------------
    cb, rb = center[:, None], radius[:, None]                    # [B,1,L,*]
    oc = cb - o                                                  # [N,1,L,3]
    dist2 = jnp.sum(oc * oc, axis=-1)
    r2 = rb * rb
    outside = dist2 > r2
    sin2_max = jnp.clip(r2 / jnp.maximum(dist2, 1e-12), 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2_max)
    solid = _TWO_PI * (1.0 - cos_max)
    inv_dist = 1.0 / jnp.maximum(jnp.sqrt(dist2), 1e-12)

    # --- spheres: per-direction (uniform cone, hitable_sphere.hpp:155-219) ---
    cos_dir = jnp.sum(d * oc, axis=-1) * inv_dist
    in_cone = cos_dir >= cos_max
    pdf_sph = jnp.where(
        outside & in_cone & (solid > 1e-12), 1.0 / jnp.maximum(solid, 1e-12), 0.0
    )

    per_light = jnp.where(is_tri[None, None, :], pdf_tri, pdf_sph)  # [N,K,L]
    w = light_pick_probs(scene)
    if w is None:
        return jnp.sum(per_light, axis=-1) / L
    return jnp.sum(per_light * w[None, None, :], axis=-1)


def lights_pdf_sum(
    scene: SceneArrays, origin, direction, frames=None
) -> jnp.ndarray:
    """Mixture pdf of a single direction per ray (K=1 wrapper)."""
    return lights_pdf_multi(scene, origin, direction[:, None, :], frames=frames)[:, 0]


def light_pick_prob_of(scene: SceneArrays, pick):
    """Pick probability of light index `pick` [N] — O(1) per lane."""
    w = light_pick_probs(scene)
    L = scene.light_prims.shape[0]
    if w is None:
        return jnp.full(pick.shape, 1.0 / max(L, 1))
    return w[pick]


def lights_pdf_at_hit(scene: SceneArrays, o, d, t, prim, geom_normal):
    """O(1) per-light NEE density of the ray (o, d) given it HIT prim at
    distance t: pick_prob(prim's light) x solid-angle pdf of that light.

    This is the emitted-MIS weight's denominator on the per-light path
    (SURVEY.md section 7 "NEE cost model"): the reference — and the round-3
    mixture path — evaluate an O(L) pdf sum per bounce (wurblpt.hpp:181-195);
    here everything needed is already at hand from the actual hit: for a
    triangle light pdf = t^2 / (cos * area) with cos from the hit's geometric
    normal and 1/area prebuilt per prim (scene.prim_inv_area); for a sphere
    light the cone solid angle is recomputed from center/radius. Returns 0
    for non-light prims. Requires static lights (the flatten-time areas are
    object == world space); animated-light scenes use the mixture path.
    """
    n_tri = scene.n_tris
    P = scene.prim_light_pick.shape[0]
    pc = jnp.clip(jnp.maximum(prim, 0), 0, P - 1)
    # One [P,2] row gather for (pick prob, 1/area) — loop-invariant pack.
    pick_area = jnp.stack([scene.prim_light_pick, scene.prim_inv_area], -1)
    row = pick_area[pc]
    pp = jnp.where(prim >= 0, row[..., 0], 0.0)
    cos = jnp.abs(jnp.sum(d * geom_normal, axis=-1))
    pdf_tri = t * t * row[..., 1] / jnp.maximum(cos, 1e-12)
    if scene.n_spheres > 0:
        si = jnp.clip(pc - n_tri, 0, scene.n_spheres - 1)
        S = scene.spheres
        oc = S.center[si] - o
        dist2 = jnp.sum(oc * oc, axis=-1)
        r2 = S.radius[si] * S.radius[si]
        sin2 = jnp.clip(r2 / jnp.maximum(dist2, 1e-12), 0.0, 1.0)
        solid = _TWO_PI * (1.0 - safe_sqrt(1.0 - sin2))
        pdf_sph = jnp.where((dist2 > r2) & (solid > 1e-12),
                            1.0 / jnp.maximum(solid, 1e-12), 0.0)
        pdf = jnp.where(pc < n_tri, pdf_tri, pdf_sph)
    else:
        pdf = pdf_tri
    return pp * pdf


def lights_sample(
    scene: SceneArrays, origin, u3, frames=None
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pick a hot spot and sample a direction toward it (wurblpt.hpp:187-190).

    Returns (direction [N,3], picked_prim [N], t_expected [N], pick [N],
    pdf_sa [N]): `t_expected` is the EXACT hit distance along `direction` to
    the picked light's surface (triangles: distance to the sampled point;
    spheres: the near root of the cone-sampled ray's quadratic) — an
    occlusion test may terminate at t < t_expected instead of finding the
    closest hit. `pdf_sa` is the solid-angle density of `direction` under
    the PICKED light's sampling strategy (triangle: t^2/(cos*area),
    hitable_triangle.hpp:405-423; sphere: 1/cone-solid-angle,
    hitable_sphere.hpp:155-219) — the O(1) per-light MIS path multiplies it
    by the pick probability; the mixture path instead calls
    lights_pdf_multi/lights_pdf_sum.

    Picking is uniform by default; when the builder attached power weights
    (`light_weights` + alias table) the pick is O(1) power-proportional.
    """
    L = scene.light_prims.shape[0]
    n_tri = scene.n_tris
    n = origin.shape[0]
    alias_p = getattr(scene, "light_alias_prob", None)
    has_alias = alias_p is not None and alias_p.shape[0] == L

    # STATIC lights: one packed [L, 12] row per light (tri p0|e1|e2 or
    # sphere center+radius; prim id and alias entries bitcast) — the pick
    # plus geometry fetch is then TWO row gathers instead of ~8. The pack is
    # loop-invariant, hoisted out of the bounce loop by XLA.
    packed = None
    if frames is None:
        lp_all = scene.light_prims
        if n_tri > 0:
            ti_all = jnp.clip(lp_all, 0, n_tri - 1)
            T = scene.tris
            tri_geom = jnp.concatenate(
                [T.p0[ti_all], T.e1[ti_all], T.e2[ti_all]], -1)   # [L, 9]
        else:
            tri_geom = jnp.zeros((L, 9), jnp.float32)
        if scene.n_spheres > 0:
            si_all = jnp.clip(lp_all - n_tri, 0, scene.n_spheres - 1)
            S = scene.spheres
            sph_geom = jnp.concatenate(
                [S.center[si_all], S.radius[si_all][:, None],
                 jnp.zeros((L, 5), jnp.float32)], -1)             # [L, 9]
        else:
            sph_geom = jnp.zeros((L, 9), jnp.float32)
        geom = jnp.where((lp_all < n_tri)[:, None], tri_geom, sph_geom)
        a_p = alias_p if has_alias else jnp.ones((L,), jnp.float32)
        a_i = (scene.light_alias_idx if has_alias
               else jnp.arange(L, dtype=jnp.int32))
        # prim/alias ids stored as exact float values (< 2^24) — denormal
        # bit patterns are flushed by some XLA op sequences (bsdf.py note).
        packed = jnp.concatenate([
            geom,
            lp_all.astype(jnp.float32)[:, None],
            a_p[:, None],
            a_i.astype(jnp.float32)[:, None],
        ], -1)                                                    # [L, 12]

    cell = jnp.clip((u3[..., 0] * L).astype(jnp.int32), 0, L - 1)
    if has_alias:
        # Alias-table pick: O(1) per lane regardless of light count.
        frac = u3[..., 0] * L - cell.astype(u3.dtype)
        if packed is not None:
            cell_row = packed[cell]                               # gather 1
            take_alias = frac >= cell_row[..., 10]
            pick = jnp.where(
                take_alias,
                jnp.round(cell_row[..., 11]).astype(jnp.int32),
                cell)
        else:
            take_alias = frac >= alias_p[cell]
            pick = jnp.where(take_alias, scene.light_alias_idx[cell], cell)
    else:
        pick = cell
    if packed is not None:
        pick_row = packed[pick]                                   # gather 2
        lp = jnp.round(pick_row[..., 9]).astype(jnp.int32)
    else:
        pick_row = None
        lp = scene.light_prims[pick]
    is_tri = lp < n_tri

    if frames is not None:
        m_all, t_all = frames
        rows = jnp.arange(n)
        m_pick = m_all[rows, pick]          # [N,3,3]
        t_pick = t_all[rows, pick]          # [N,3]
    else:
        m_pick = t_pick = None

    # Triangle: uniform point.
    if n_tri > 0:
        if pick_row is not None:
            p0, e1, e2 = (pick_row[..., 0:3], pick_row[..., 3:6],
                          pick_row[..., 6:9])
        else:
            ti = jnp.clip(lp, 0, n_tri - 1)
            T = scene.tris
            p0, e1, e2 = T.p0[ti], T.e1[ti], T.e2[ti]
        if m_pick is not None:
            p0 = matvec(m_pick, p0) + t_pick
            e1 = matvec(m_pick, e1)
            e2 = matvec(m_pick, e2)
        bary = sampler.in_triangle(u3[..., 1:3])
        q = p0 + bary[..., 0:1] * e1 + bary[..., 1:2] * e2
        d_tri = q - origin
        dist_tri = jnp.linalg.norm(d_tri, axis=-1)
        d_tri = d_tri / jnp.maximum(dist_tri, 1e-12)[..., None]
        fn = jnp.cross(e1, e2)
        fn_len = jnp.linalg.norm(fn, axis=-1)
        area_tri = 0.5 * fn_len
        cos_tri = jnp.abs(jnp.sum(d_tri * fn, axis=-1)) / jnp.maximum(fn_len, 1e-20)
        pdf_tri = dist_tri * dist_tri / jnp.maximum(cos_tri * area_tri, 1e-12)
    else:
        d_tri = jnp.zeros_like(origin)
        dist_tri = jnp.zeros(origin.shape[:-1])
        pdf_tri = jnp.zeros(origin.shape[:-1])

    # Sphere: cone sample; expected hit distance = near quadratic root.
    if scene.n_spheres > 0:
        if pick_row is not None:
            center = pick_row[..., 0:3]
            radius = pick_row[..., 3]
        else:
            si = jnp.clip(lp - n_tri, 0, scene.n_spheres - 1)
            S = scene.spheres
            center = S.center[si]
            radius = S.radius[si]
        if m_pick is not None:
            center = matvec(m_pick, center) + t_pick
            radius = radius * jnp.linalg.norm(m_pick, axis=-2).mean(-1)
        oc = center - origin
        dist2 = jnp.sum(oc * oc, axis=-1)
        sin2_max = jnp.clip(radius * radius / jnp.maximum(dist2, 1e-12), 0.0, 1.0)
        cos_max = safe_sqrt(1.0 - sin2_max)
        d_sph = sampler.to_sphere(oc, cos_max, u3[..., 1:3])
        # t_exp: ray (origin, d_sph) vs the sphere, near root. Cone sampling
        # guarantees intersection up to roundoff; clamp the discriminant.
        half_b = -jnp.sum(oc * d_sph, axis=-1)
        cq = dist2 - radius * radius
        disc = jnp.maximum(half_b * half_b - cq, 0.0)
        dist_sph = -half_b - jnp.sqrt(disc)
        solid = _TWO_PI * (1.0 - cos_max)
        pdf_sph = jnp.where((dist2 > radius * radius) & (solid > 1e-12),
                            1.0 / jnp.maximum(solid, 1e-12), 0.0)
    else:
        d_sph = jnp.zeros_like(origin)
        dist_sph = jnp.zeros(origin.shape[:-1])
        pdf_sph = jnp.zeros(origin.shape[:-1])

    direction = jnp.where(is_tri[..., None], d_tri, d_sph)
    dist = jnp.where(is_tri, dist_tri, dist_sph)
    pdf_sa = jnp.where(is_tri, pdf_tri, pdf_sph)
    return direction, lp, dist, pick, pdf_sa
