"""Wavefront path integrator: the batched `tracePath` + `mcpt`.

Reference: ``libwurblpt/wurblpt.hpp:108-275`` (tracePath) and ``:279-449`` (mcpt).
The recursive-feeling per-pixel loop becomes a `lax.while_loop` over bounce depth
carrying a whole ray *batch*; terminated lanes are masked rather than compacted
(occupancy is recovered across bounces because every lane of a batch shares the
same bounce index — compaction is a planned optimization, SURVEY.md section 7).

Per bounce, matching the reference event-for-event:
  1. closest hit (tiled brute force or BVH)                    [wurblpt.hpp:131]
  2. miss -> envmap radiance with MIS weight, lane retires     [:136-146]
  3. geometric + per-channel optical path length accumulation  [:148-150]
  4. emitted radiance with MIS weight vs hot-spot mixture pdf  [:160-163,181-185]
  5. BSDF sample (ScatterRecord equivalent)                    [:157]
  6. next-event estimation toward a uniformly picked hot spot,
     power-heuristic weighted, visibility via blocker identity [:179-220]
  7. envmap NEE when importance tables exist                   [:221-252]
  8. throughput update, Russian roulette after bounce 5        [:169-176,258-273]

Randomness is counter-based: every decision hashes
(global pixel id, global sample id, bounce, salt) — results are bit-identical
for any sharding of the ray batch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.rng import Salt, uniform1, uniform2, uniform4
from ..core.sampler import power_heuristic
from ..core.vecmath import dot, matvec
from ..scene.ir import SceneArrays
from .bsdf import (
    ScatterKind,
    SceneStatic,
    apply_normal_map,
    bsdf_eval,
    bsdf_sample,
    emitted,
    gather_material_rows,
    pack_material_table,
)
from .camera import CameraConfig, CameraParams, camera_rays
from .envmap import env_has_importance, env_pdf, env_radiance, env_sample
from .intersect import (
    BIG,
    assemble_hit,
    scene_any_hit,
    scene_fused_cast,
    scene_raw_hit,
)
from .lights import (
    light_pick_prob_of,
    lights_pdf_at_hit,
    lights_pdf_multi,
    lights_sample,
)
from .media import apply_media
from .sensor import SensorEvent
from .texture import material_emissive


@dataclass(frozen=True)
class RenderParams:
    """Reference `Parameters` (wurblpt.hpp:79-96) + execution switches.

    `differentiable`: when True the bounce loop is a fixed-trip `fori_loop`
    (scan-lowered, reverse-differentiable, rematerialized per bounce) instead of
    an early-exiting `while_loop`. Inference keeps the while_loop so a batch
    whose paths all die early stops immediately.
    """

    max_path_components: int = 32
    rr_threshold: float = 1.0
    rr_start: int = 5
    min_hit_distance: float = 1e-4
    randomize_ray_over_pixel: bool = True
    differentiable: bool = False
    # NEE any-hit visibility band: the shadow ray is shortened to
    # ldist * (1 - shadow_identity_eps) so the sampled light itself never
    # counts as its own blocker (the reference instead compares blocker
    # identity, wurblpt.hpp:203-217). The band is RELATIVE, so its absolute
    # width grows with light distance (~3 mm per 10 units at the default);
    # an occluder pressed flush against a light plane closer than that band
    # can leak. Scenes with such contacts should lower this (the cost is
    # that f32 roundoff in ldist must stay below it: ~1e-6 * ldist).
    shadow_identity_eps: float = 3e-4
    # Deferred-NEE cast fusion: each bounce's NEE shadow rays are carried in
    # loop state and traced TOGETHER with the NEXT bounce's closest cast in
    # ONE scene_fused_cast (one traversal / one feature matmul; deposits
    # land one bounce late with the visibility verdict). Output is
    # bit-identical to the immediate path — same samples, same
    # contributions, per-lane deposit order preserved (verified on cornell,
    # envmap, terrain BVH and the pass renderer, tools/smoke_fused_nee.py).
    # DEFAULT OFF: on the previous accelerator it was slower on every bench
    # config (the ~33 f32/lane pending state carried through the wavefront
    # while_loop cost more than the merged cast saved; the merged BVH
    # traversal runs 2x wide until its first compaction). Not yet measured
    # on the H100 (ROADMAP D1). Kept as an opt-in so the experiment is
    # reproducible and is not silently retried.
    fused_nee: bool = False


class _PendNEE(NamedTuple):
    """A bounce's NEE shadow ray + its would-be deposit, deferred one bounce.

    The visibility cast rides the NEXT bounce's closest cast in one
    scene_fused_cast; every SensorEvent field is carried so the deposit is
    exactly the one the immediate path would have made."""

    d: jnp.ndarray         # [N, 3] shadow direction
    tmax: jnp.ndarray      # [N] visibility bound (light distance band / BIG)
    radiance: jnp.ndarray  # [N, 4] contribution if unoccluded
    pc: jnp.ndarray        # [N] int32 path component of the deposit
    geom: jnp.ndarray      # [N] geometric path length at the deposit
    opt: jnp.ndarray       # [N, 4] optical path length at the deposit
    dist: jnp.ndarray      # [N] distance-to-light of the deposit
    active: jnp.ndarray    # [N] bool


def _zero_pend(n: int) -> _PendNEE:
    return _PendNEE(
        d=jnp.zeros((n, 3)), tmax=jnp.zeros((n,)),
        radiance=jnp.zeros((n, 4)), pc=jnp.zeros((n,), jnp.int32),
        geom=jnp.zeros((n,)), opt=jnp.zeros((n, 4)),
        dist=jnp.zeros((n,)), active=jnp.zeros((n,), bool),
    )


def _fused_mode(static, params: "RenderParams", use_mxu: bool):
    """(fuse light-NEE?, fuse env-NEE?) for this trace — static booleans.

    Fusion applies only on the matmul intersector path, where it merges the
    bounce's casts into ONE feature matmul. On the BVH path a merged
    traversal was slower than two separate casts on the full bvh_100k frame
    (previous accelerator; not measured on the H100), so BVH scenes keep
    immediate per-bounce shadow casts.
    """
    env_is = static.env_kind != 0 and static.env_importance
    has_lights = static.n_lights > 0
    on = (getattr(params, "fused_nee", False) and not static.has_media
          and use_mxu)
    return on and has_lights, on and env_is


class _LoopState(NamedTuple):
    bounce: jnp.ndarray         # [N] per-lane bounce index
    o: jnp.ndarray
    d: jnp.ndarray
    time: jnp.ndarray
    ior: jnp.ndarray
    throughput: jnp.ndarray
    active: jnp.ndarray
    acc: jnp.ndarray
    geom_len: jnp.ndarray
    opt_len: jnp.ndarray
    prev_pdf: jnp.ndarray       # pdf of previous RANDOM bsdf sample (0 if none)
    prev_random: jnp.ndarray    # bool: previous scatter was pdf-sampled
    prev_light_pdf: jnp.ndarray  # light-mixture pdf of the previous bsdf sample
    stats: jnp.ndarray          # [2] int32: (closest casts, total casts incl. shadow)
    pend_o: Optional[jnp.ndarray] = None      # [N, 3] deferred-NEE origin
    pend_l: Optional[_PendNEE] = None         # deferred light-NEE
    pend_e: Optional[_PendNEE] = None         # deferred env-NEE


def _init_pend_fields(n: int, fuse_l: bool, fuse_e: bool):
    return dict(
        pend_o=jnp.zeros((n, 3)) if (fuse_l or fuse_e) else None,
        pend_l=_zero_pend(n) if fuse_l else None,
        pend_e=_zero_pend(n) if fuse_e else None,
    )


def _any_pending(st: _LoopState):
    out = jnp.zeros((), bool)
    if st.pend_l is not None:
        out = out | jnp.any(st.pend_l.active)
    if st.pend_e is not None:
        out = out | jnp.any(st.pend_e.active)
    return out


def _light_emitted_at(scene: SceneArrays, static: SceneStatic, prim, point, toward,
                      frame=None, mat_packed=None):
    """Emitted radiance of light prim `prim` at surface point `point` toward
    direction `toward` (unit, pointing from light to receiver).

    `frame`: optional per-ray (m [N,3,3], t [N,3]) forward TRS of the prim's
    animation at ray time — animated emitters evaluate their normal (cone
    axis / sidedness) in world space at that instant."""
    n_tri = scene.n_tris
    is_tri = prim < n_tri
    ti = jnp.clip(prim, 0, max(n_tri - 1, 0))
    if n_tri > 0:
        T = scene.tris
        e1, e2 = T.e1[ti], T.e2[ti]
        if frame is not None:
            m_f, _ = frame
            e1 = matvec(m_f, e1)
            e2 = matvec(m_f, e2)
        fn = jnp.cross(e1, e2)
        n_t = fn / jnp.maximum(jnp.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        mat_t = T.mat[ti]
    else:
        n_t = jnp.zeros_like(point)
        mat_t = jnp.zeros(prim.shape, jnp.int32)
    if scene.n_spheres > 0:
        si = jnp.clip(prim - n_tri, 0, scene.n_spheres - 1)
        S = scene.spheres
        center, radius = S.center[si], S.radius[si]
        if frame is not None:
            m_f, t_f = frame
            center = matvec(m_f, center) + t_f
            radius = radius * jnp.linalg.norm(m_f, axis=-2).mean(-1)
        n_s = (point - center) / jnp.maximum(radius, 1e-20)[..., None]
        mat_s = S.mat[si]
    else:
        n_s = jnp.zeros_like(point)
        mat_s = jnp.zeros(prim.shape, jnp.int32)
    n = jnp.where(is_tri[..., None], n_t, n_s)
    mat = jnp.where(is_tri, mat_t, mat_s)

    # Orient normal toward the receiver, honoring one-sidedness: emission only
    # when the receiver is on the front side (or the material is two-sided).
    # One packed-row gather for the light's material attributes (flags, type,
    # cone angle, emission) — see bsdf.pack_material_table.
    from ..scene.ir import MaterialFlags, MaterialType
    from .bsdf import material_rows

    lrow = (gather_material_rows(mat_packed, mat) if mat_packed is not None
            else material_rows(scene, mat))
    cos_v = dot(n, toward)
    two_sided = (lrow.flags & MaterialFlags.TWO_SIDED) > 0
    front = (cos_v > 0.0) | two_sided
    typ = lrow.typ
    in_cone = jnp.abs(cos_v) >= lrow.p0[..., 0]
    is_cone = (typ == MaterialType.LIGHT_SPOT) | (typ == MaterialType.LIGHT_TOF)
    e = material_emissive(scene, mat, jnp.zeros(point.shape[:-1] + (2,)),
                          mrow=lrow)
    ok = front & (in_cone | ~is_cone)
    return jnp.where(ok[..., None], e, 0.0)


def trace_paths(
    scene: SceneArrays,
    static: SceneStatic,
    sensor,
    o,
    d,
    time,
    pixel_id,
    sample_id,
    params: RenderParams,
    return_stats: bool = False,
):
    """Trace one batch of camera rays to completion; returns acc
    [N, sensor.n_acc] (with `return_stats`, also the [2] int32 cast counters
    (closest, total incl. shadow) for honest Mrays/s accounting)."""
    n = o.shape[0]

    # Per-ray animation frames (the AnimationCache analog, animation.hpp:52-125):
    # ray time is fixed along a path, so all A animations are evaluated once per
    # trace and every cast reuses the object-space transform tables.
    if static.has_anim:
        from ..scene.animation import make_anim_ctx

        anim_ctx = make_anim_ctx(scene.anims, time,
                                 with_forward=static.lights_animated)
    else:
        anim_ctx = None

    # MXU intersector (intersect_mxu): the primitive feature + attribute
    # matrices are loop-invariant, built ONCE per trace and closed over.
    from .intersect import mxu_eligible

    if mxu_eligible(scene, anim_ctx):
        from .intersect_mxu import build_mxu_scene

        ms = build_mxu_scene(scene)
    else:
        ms = None

    bounce_fn = _make_bounce_fn(scene, static, sensor, params, anim_ctx, ms, n)
    fuse_l, fuse_e = _fused_mode(static, params, ms is not None)

    init = _LoopState(
        bounce=jnp.zeros((n,), jnp.int32),
        o=o,
        d=d,
        time=time,
        ior=jnp.ones((n, 4)),
        throughput=jnp.ones((n, 4)),
        active=jnp.ones((n,), bool),
        acc=jnp.zeros((n, sensor.n_acc)),
        geom_len=jnp.zeros((n,)),
        opt_len=jnp.zeros((n, 4)),
        prev_pdf=jnp.zeros((n,)),
        prev_random=jnp.zeros((n,), bool),
        prev_light_pdf=jnp.zeros((n,)),
        stats=jnp.zeros((2,), jnp.int32),
        **_init_pend_fields(n, fuse_l, fuse_e),
    )

    def cond(st: _LoopState):
        # Deferred NEE keeps the loop alive while deposits are pending (at
        # most one extra step: a body with no active lanes deposits every
        # pending and creates none).
        return ((jnp.min(st.bounce) < params.max_path_components)
                & jnp.any(st.active)) | _any_pending(st)

    body = lambda st: bounce_fn(st, pixel_id, sample_id)

    if params.differentiable:
        # Fixed trip count + per-bounce rematerialization: reverse-mode works
        # and residual memory stays O(state) instead of O(state * depth).
        # Deferred NEE needs one extra trip to flush the final bounce's
        # shadow deposits.
        body_ckpt = jax.checkpoint(body)
        trips = params.max_path_components + (1 if (fuse_l or fuse_e) else 0)
        final = jax.lax.fori_loop(
            0, trips, lambda _, st: body_ckpt(st), init
        )
    else:
        final = jax.lax.while_loop(cond, body, init)
    if return_stats:
        return final.acc, final.stats
    return final.acc


def _make_bounce_fn(scene, static, sensor, params, anim_ctx, ms, n):
    """One wavefront bounce as a reusable function of (state, pixel, sample).

    Shared between `trace_paths` (fixed pixel/sample per lane for the whole
    call) and `trace_wavefront` (persistent lanes whose sample id changes as
    paths regenerate). `st.bounce` is per-lane.
    """
    env_is = static.env_kind != 0 and static.env_importance
    has_env = static.env_kind != 0
    has_lights = static.n_lights > 0
    # O(1) per-light MIS for many-light scenes: pdfs are pick_prob x the
    # SINGLE relevant light's solid-angle pdf (the picked one at the NEE
    # event, the one actually hit at the emitted event) instead of the O(L)
    # mixture broadcast — still unbiased (each light's NEE strategy pairs
    # with the BSDF strategy; weights sum to 1 per pair). Small scenes keep
    # the reference's mixture semantics exactly (wurblpt.hpp:181-195).
    per_light = has_lights and getattr(static, "per_light_mis", False)

    # Animated emitters: per-ray forward frames of each hot spot's animation
    # (ray time is fixed along a path, so they are loop-invariant like the
    # AnimCtx itself). None when every light is static.
    if has_lights and anim_ctx is not None and getattr(static, "lights_animated", False):
        from .lights import light_frames

        lframes = light_frames(scene, anim_ctx)
    else:
        lframes = None

    # ONE packed material matrix per trace (loop-invariant, hoisted by XLA):
    # every per-lane material attribute then costs a single row gather per
    # bounce instead of ~15 separate `mt.field[hr.mat]` gathers.
    mat_packed = pack_material_table(scene.materials)

    def cast(o_, d_, tmin_, tmax_, pixel_id, sample_id, k, salt_ctx):
        """Closest hit incl. stochastic medium scattering (media.py).

        `tmax_` is per-lane: callers pass 0 for lanes that do not need this
        cast (dead paths, non-NEE lanes) so the BVH compaction stages shed
        them after one step instead of re-walking stale rays — with 1 spp
        (no regeneration) roughly half the lanes are dead by bounce 2.

        Returns (t, prim, u, v, med_mask, med_mat); medium-scatter lanes get
        prim = n_solid + medium_id so blocker-identity checks treat them as
        occluders (wurblpt.hpp:203-217 semantics with media in the BVH).
        """
        t, prim, uu, vv = scene_raw_hit(
            scene, o_, d_, tmin_, tmax_, anim_ctx=anim_ctx, ms=ms
        )
        if static.has_media:
            return apply_media(
                scene, o_, d_, tmin_, t, prim, uu, vv,
                pixel_id, sample_id, k, salt_ctx,
            )
        zb = jnp.zeros(t.shape, bool)
        return t, prim, uu, vv, zb, jnp.zeros(t.shape, jnp.int32)

    fuse_l, fuse_e = _fused_mode(static, params, ms is not None)
    fused = fuse_l or fuse_e

    def body(st: _LoopState, pixel_id, sample_id) -> _LoopState:
        k = st.bounce
        acc = st.acc
        if fused:
            # ---- fused cast: this bounce's closest rays + the PREVIOUS
            # bounce's deferred NEE shadow rays in ONE traversal/matmul.
            # Inactive lanes get t_max = 0 and retire on the first step.
            o_parts = [st.o]
            d_parts = [st.d]
            tmax_parts = [jnp.where(st.active, jnp.full((n,), BIG), 0.0)]
            if fuse_l:
                o_parts.append(st.pend_o)
                d_parts.append(st.pend_l.d)
                tmax_parts.append(
                    jnp.where(st.pend_l.active, st.pend_l.tmax, 0.0))
            if fuse_e:
                o_parts.append(st.pend_o)
                d_parts.append(st.pend_e.d)
                tmax_parts.append(
                    jnp.where(st.pend_e.active, jnp.full((n,), BIG), 0.0))
            nseg = len(o_parts)
            (t, prim, u, v), occ = scene_fused_cast(
                scene,
                jnp.concatenate(o_parts, 0),
                jnp.concatenate(d_parts, 0),
                jnp.full((nseg * n,), params.min_hit_distance),
                jnp.concatenate(tmax_parts, 0),
                n, anim_ctx=anim_ctx, ms=ms,
            )
            med_mask = jnp.zeros((n,), bool)
            med_mat = jnp.zeros((n,), jnp.int32)
            # deposit the deferred NEE with this cast's visibility verdict
            off = 0
            if fuse_l:
                pl = st.pend_l
                vis = ~occ[off:off + n]
                off += n
                acc = sensor.accumulate(acc, SensorEvent(
                    radiance=pl.radiance, path_component=pl.pc,
                    geom_path_length=pl.geom, optical_path_length=pl.opt,
                    distance_to_light=pl.dist, active=pl.active & vis))
            if fuse_e:
                pe = st.pend_e
                vis = ~occ[off:off + n]
                acc = sensor.accumulate(acc, SensorEvent(
                    radiance=pe.radiance, path_component=pe.pc,
                    geom_path_length=pe.geom, optical_path_length=pe.opt,
                    distance_to_light=pe.dist, active=pe.active & vis))
        else:
            t, prim, u, v, med_mask, med_mat = cast(
                st.o, st.d, jnp.full((n,), params.min_hit_distance),
                jnp.where(st.active, jnp.full((n,), BIG), 0.0),
                pixel_id, sample_id, k, 0
            )
        hit = (prim >= 0) & st.active
        miss = (~(prim >= 0)) & st.active
        # ---- 2. environment on miss (wurblpt.hpp:136-146) -----------------
        if has_env:
            L_env = env_radiance(scene.envmap, st.d)
            if env_is:
                pdf_e = env_pdf(scene.envmap, st.d)
                w_env = jnp.where(
                    st.prev_random, power_heuristic(st.prev_pdf, pdf_e), 1.0
                )
            else:
                w_env = jnp.ones((n,))
            ev = SensorEvent(
                radiance=st.throughput * L_env * w_env[..., None],
                path_component=k,
                geom_path_length=st.geom_len,
                optical_path_length=st.opt_len,
                distance_to_light=jnp.zeros((n,)),
                active=miss,
            )
            acc = sensor.accumulate(acc, ev)

        hr = assemble_hit(scene, st.o, st.d, t, prim, u, v, anim_ctx=anim_ctx, ms=ms)
        if static.has_media:
            # Medium scatter lanes: phase-function material, arbitrary frame
            # facing the ray (hitable_medium.hpp:94-97 sets an arbitrary normal).
            # Applied BEFORE the material-row gather so medium lanes fetch the
            # phase material's row; normal mapping afterwards is a no-op on
            # them (phase materials carry no normal map).
            mm = med_mask[..., None]
            hr = hr._replace(
                mat=jnp.where(med_mask, med_mat, hr.mat),
                normal=jnp.where(mm, -st.d, hr.normal),
                geom_normal=jnp.where(mm, -st.d, hr.geom_normal),
                backside=jnp.where(med_mask, False, hr.backside),
                uv=jnp.where(med_mask[..., None], 0.0, hr.uv),
            )
        # ONE row gather for every material attribute this bounce touches.
        mrow = gather_material_rows(mat_packed, hr.mat)
        # Normal mapping (material.hpp:195-228): perturb the shading frame
        # before any scatter/eval; compiled out when no normal maps exist.
        hr = apply_normal_map(scene, static, hr, mrow=mrow)

        # ---- 3. path lengths (wurblpt.hpp:148-150) ------------------------
        geom_len = jnp.where(hit, st.geom_len + t, st.geom_len)
        opt_len = jnp.where(hit[..., None], st.opt_len + t[..., None] * st.ior, st.opt_len)

        # ---- 4. emitted with MIS weight (wurblpt.hpp:160-163, 181-185) ----
        # Mixture mode: the light-mixture pdf of THIS ray was already
        # evaluated last bounce (st.prev_light_pdf carries lights_pdf_multi
        # of the bsdf sample from its origin) — the reference re-evaluates
        # the O(L) sum here (wurblpt.hpp:182-184); we pay it once per bounce.
        # Per-light mode: the prim actually hit identifies the ONE light
        # whose NEE strategy could have produced this ray; its pick_prob x
        # solid-angle pdf comes O(1) from the hit itself (t, cos, 1/area).
        e = emitted(scene, static, hr, -st.d, mrow=mrow)
        if per_light:
            lp_hit = lights_pdf_at_hit(
                scene, st.o, st.d, t, jnp.where(hit, prim, -1), hr.geom_normal)
            w_emit = jnp.where(
                st.prev_random, power_heuristic(st.prev_pdf, lp_hit), 1.0
            )
        elif has_lights:
            w_emit = jnp.where(
                st.prev_random, power_heuristic(st.prev_pdf, st.prev_light_pdf), 1.0
            )
        else:
            w_emit = jnp.ones((n,))
        ev = SensorEvent(
            radiance=st.throughput * e * w_emit[..., None],
            path_component=k,
            geom_path_length=geom_len,
            optical_path_length=opt_len,
            distance_to_light=t,
            active=hit,
        )
        acc = sensor.accumulate(acc, ev)

        # ---- 5. scatter (wurblpt.hpp:157) ---------------------------------
        # Scalar decisions (lobe / dispersion channel / RR) share ONE hash
        # draw — its four words are independent (Salt.BSDF_AUX rationale).
        u4 = uniform4(pixel_id, sample_id, k, Salt.BSDF)
        u_aux = uniform4(pixel_id, sample_id, k, Salt.BSDF_AUX)
        u_lobe = u_aux[..., 0]
        u_chan = u_aux[..., 1]
        sr = bsdf_sample(scene, static, hr, st.d, st.ior, u4, u_lobe, u_chan,
                         mrow=mrow)
        is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
        is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)

        # ---- 6. NEE toward hot spots (wurblpt.hpp:179-220) ----------------
        if has_lights:
            u3 = uniform4(pixel_id, sample_id, k, Salt.NEE_SAMPLE)[..., :3]
            ldir, lprim, ldist, lpick, pdf_sa = lights_sample(
                scene, hr.position, u3, frames=lframes
            )
            if per_light:
                # O(1): the NEE strategy is "pick light i, sample its solid
                # angle" — its density is pick_prob(i) x pdf_i(dir), no O(L)
                # broadcast. The emitted-MIS side is handled at the NEXT
                # bounce's hit (lights_pdf_at_hit above).
                pdf_light = light_pick_prob_of(scene, lpick) * pdf_sa
                light_pdf_next = jnp.zeros((n,))
            else:
                # ONE light-mixture evaluation for BOTH directions needing it
                # at this bounce: the NEE direction (this branch's pdf) and
                # the bsdf sample (next bounce's emitted-MIS weight, carried
                # in state).
                pdf_pair = lights_pdf_multi(
                    scene, hr.position,
                    jnp.stack([ldir, sr.direction], axis=1), frames=lframes
                )
                pdf_light, light_pdf_next = pdf_pair[:, 0], pdf_pair[:, 1]
            f_l, pdf_b = bsdf_eval(scene, static, hr, st.d, ldir, mrow=mrow)
            if fuse_l:
                # Visibility is resolved by the NEXT bounce's fused cast;
                # the band semantics (shadow_identity_eps) are identical.
                visible = None
                st_t = ldist
            elif static.has_media:
                # Media block shadow rays stochastically (salt_ctx=1): need the
                # closest blocker segment, keep the identity-check path.
                st_t, st_prim, _, _, _, _ = cast(
                    hr.position, ldir, jnp.full((n,), params.min_hit_distance),
                    jnp.where(is_random, jnp.full((n,), BIG), 0.0),
                    pixel_id, sample_id, k, 1
                )
                visible = st_prim == lprim
                st_t = jnp.where(st_prim >= 0, st_t, ldist)
            else:
                # ANY-hit shortened at the sampled light's expected distance:
                # "no blocker strictly before the light" is exactly the
                # reference's directHR.hitable == hotSpots[i] (wurblpt.hpp:
                # 203-217) — the closest hit itself is never needed. Band
                # semantics documented at RenderParams.shadow_identity_eps.
                t_vis = jnp.maximum(ldist * (1.0 - params.shadow_identity_eps),
                                    params.min_hit_distance)
                occluded = scene_any_hit(
                    scene, hr.position, ldir,
                    jnp.full((n,), params.min_hit_distance),
                    # non-NEE lanes retire at entry (compacted away on the
                    # BVH path instead of walking a stale ray)
                    jnp.where(is_random, t_vis, 0.0),
                    anim_ctx=anim_ctx, ms=ms,
                )
                visible = ~occluded
                st_t = ldist
            if lframes is not None:
                rows = jnp.arange(n)
                pick_frame = (lframes[0][rows, lpick], lframes[1][rows, lpick])
            else:
                pick_frame = None
            Le = _light_emitted_at(
                scene, static, jnp.maximum(lprim, 0),
                hr.position + ldir * st_t[..., None], -ldir,
                frame=pick_frame, mat_packed=mat_packed,
            )
            # Detached-sampling estimator: the pdf and MIS weight are treated
            # as constants of the tape; gradients flow through f, Le and the
            # throughput (standard path-replay-style differentiation).
            # ATTACHED estimator for continuous quantities: with counter-based
            # (common) random numbers the sampled configuration moves with the
            # scene/camera parameters, so the pdf and MIS weight must stay on
            # the tape for geometry gradients to be unbiased (Zeltner et al.
            # 2021; validated by tests/test_gradients.py FD checks). Only
            # DISCRETE decisions (light pick, lobe pick, RR) stay detached.
            w_nee = power_heuristic(pdf_light, pdf_b)
            contrib = (
                st.throughput
                * f_l
                * Le
                * (w_nee / jnp.maximum(pdf_light, 1e-12))[..., None]
            )
            if fuse_l:
                t_vis = jnp.maximum(
                    ldist * (1.0 - params.shadow_identity_eps),
                    params.min_hit_distance)
                new_pend_l = _PendNEE(
                    d=ldir, tmax=t_vis, radiance=contrib, pc=k,
                    geom=geom_len + st_t,
                    opt=opt_len + st_t[..., None] * st.ior,
                    dist=st_t,
                    active=is_random & (pdf_light > 1e-12),
                )
            else:
                ok = is_random & visible & (pdf_light > 1e-12)
                ev = SensorEvent(
                    radiance=contrib,
                    path_component=k,
                    geom_path_length=geom_len + st_t,
                    optical_path_length=opt_len + st_t[..., None] * st.ior,
                    distance_to_light=st_t,
                    active=ok,
                )
                acc = sensor.accumulate(acc, ev)

        # ---- 7. envmap NEE (wurblpt.hpp:221-252) --------------------------
        if env_is:
            ue = uniform4(pixel_id, sample_id, k, Salt.ENVMAP_SAMPLE)[..., :3]
            edir, epdf = env_sample(scene.envmap, ue)
            f_e, pdf_be = bsdf_eval(scene, static, hr, st.d, edir, mrow=mrow)
            if fuse_e:
                unoccluded = None
            elif static.has_media:
                et, eprim, _, _, _, _ = cast(
                    hr.position, edir, jnp.full((n,), params.min_hit_distance),
                    jnp.where(is_random, jnp.full((n,), BIG), 0.0),
                    pixel_id, sample_id, k, 2
                )
                unoccluded = eprim < 0
            else:
                unoccluded = ~scene_any_hit(
                    scene, hr.position, edir,
                    jnp.full((n,), params.min_hit_distance),
                    jnp.where(is_random, jnp.full((n,), BIG), 0.0),
                    anim_ctx=anim_ctx, ms=ms,
                )
            L_e = env_radiance(scene.envmap, edir)
            w_e = power_heuristic(epdf, pdf_be)
            contrib_e = (st.throughput * f_e * L_e
                         * (w_e / jnp.maximum(epdf, 1e-12))[..., None])
            if fuse_e:
                new_pend_e = _PendNEE(
                    d=edir, tmax=jnp.full((n,), BIG), radiance=contrib_e,
                    pc=k, geom=geom_len, opt=opt_len,
                    dist=jnp.zeros((n,)),
                    active=is_random & (epdf > 1e-12),
                )
            else:
                ok_e = is_random & unoccluded & (epdf > 1e-12)
                ev = SensorEvent(
                    radiance=contrib_e,
                    path_component=k,
                    geom_path_length=geom_len,
                    optical_path_length=opt_len,
                    distance_to_light=jnp.zeros((n,)),
                    active=ok_e,
                )
                acc = sensor.accumulate(acc, ev)

        # ---- 8. throughput update + Russian roulette ----------------------
        # Attached pdf (see NEE note): for cosine sampling atten/pdf = albedo
        # exactly, so the cos-term derivatives cancel only when pdf stays on
        # the tape.
        ratio = jnp.where(
            is_random[..., None],
            sr.atten / jnp.maximum(sr.pdf, 1e-12)[..., None],
            sr.atten,
        )
        cont = is_random | is_explicit
        new_throughput = st.throughput * ratio

        # Russian roulette (wurblpt.hpp:258-273): q from the per-bounce ratio.
        max_r = jax.lax.stop_gradient(jnp.max(ratio, axis=-1))
        u_rr = u_aux[..., 2]
        do_rr = (k >= params.rr_start) & (max_r < params.rr_threshold) & cont
        q = jnp.clip(1.0 - max_r, 0.0, 0.95)
        killed = do_rr & (u_rr < q)
        new_throughput = jnp.where(
            (do_rr & ~killed)[..., None],
            new_throughput / jnp.maximum(1.0 - q, 0.05)[..., None],
            new_throughput,
        )
        alive = cont & ~killed & (jnp.max(new_throughput, axis=-1) > 0.0)

        # Ray counters (honest Mrays/s accounting, bench.py): one closest cast
        # per active lane; one shadow cast per NEE branch taken per RANDOM lane.
        n_closest = jnp.sum(st.active.astype(jnp.int32))
        n_shadow = jnp.zeros((), jnp.int32)
        if has_lights:
            n_shadow = n_shadow + jnp.sum(is_random.astype(jnp.int32))
        if env_is:
            n_shadow = n_shadow + jnp.sum(is_random.astype(jnp.int32))
        stats = st.stats + jnp.stack([n_closest, n_closest + n_shadow])

        return _LoopState(
            bounce=jnp.where(st.active, k + 1, k),
            o=jnp.where(hit[..., None], hr.position, st.o),
            d=jnp.where(cont[..., None], sr.direction, st.d),
            time=st.time,
            ior=jnp.where(cont[..., None], sr.ior, st.ior),
            throughput=jnp.where(cont[..., None], new_throughput, st.throughput),
            active=st.active & alive & (k + 1 < params.max_path_components),
            acc=acc,
            geom_len=geom_len,
            opt_len=opt_len,
            prev_pdf=jnp.where(is_random, sr.pdf, 0.0),
            prev_random=is_random,
            prev_light_pdf=(
                jnp.where(is_random, light_pdf_next, 0.0)
                if has_lights else st.prev_light_pdf
            ),
            stats=stats,
            pend_o=hr.position if fused else None,
            pend_l=new_pend_l if fuse_l else None,
            pend_e=new_pend_e if fuse_e else None,
        )

    return body


# ---------------------------------------------------------------------------
# Persistent-lane wavefront renderer (regeneration; the fast inference path)
# ---------------------------------------------------------------------------

def render_frame_wavefront(
    scene: SceneArrays,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    t0: float = 0.0,
    t1: float = 0.0,
    params: RenderParams = RenderParams(),
    max_lanes: int = 131072,
    return_stats: bool = False,
    host_blocks: bool = False,
    row_window: Optional[Tuple] = None,
):
    """Render a frame with PERSISTENT lanes: each lane owns one pixel (and a
    fixed subset of its samples) and traces those paths SEQUENTIALLY — the
    moment a path dies (miss/absorb/Russian roulette) the lane immediately
    starts its pixel's next sample at bounce 0.

    This is the batched answer to wavefront divergence (SURVEY.md section
    5.7): occupancy stays near 100% for the whole frame
    instead of decaying with bounce depth, with NO scatters, sorts, or
    compaction — deposits are conflict-free by construction because the
    lane-to-pixel map is static, and the counter-based RNG (keyed on pixel and
    sample ids, not lanes) keeps the estimator identical to `render_frame`.

    Pixel blocks of `B` pixels x `m` sample-lanes (B*m <= max_lanes) run
    sequentially under an outer `fori_loop` for frames bigger than the lane
    budget. The default budget is a starting point carried over from the
    previous accelerator, not yet measured on the H100 (ROADMAP S4, S5). Inference-only (while_loop); training uses `render_frame` with
    `params.differentiable=True`.

    `row_window=(row0, n_rows)` renders only frame rows [row0, row0 +
    n_rows) of the `height`-row frame (`row0` may be traced, `n_rows` is
    static; rows past the frame come out zero). Pixel and sample ids stay
    global, so a window is exactly that slice of the whole frame: this is how
    `parallel.sharding.render_frame_wavefront_sharded` splits a frame.

    Returns image [H, W, n_acc] ([n_rows, W, n_acc] with a window); with
    `return_stats` also a [2] int32 vector (closest-hit casts, total casts
    incl. NEE shadow rays) for honest Mrays/s.
    """
    if row_window is None:
        pix_base, n_rows = 0, height
    else:
        assert not host_blocks, "row_window renders inside one program"
        pix_base, n_rows = row_window[0] * width, int(row_window[1])
    if static.has_anim and t0 != t1:
        # Motion blur re-samples ray time per path; the per-trace AnimCtx
        # tables would go stale across regenerations. Use the pass renderer —
        # WITH its real cast counters, so motion-blur benches report honest
        # Mrays/s instead of zeros.
        return render_frame(scene, static, cam, cam_cfg, sensor, width, height,
                            samples_sqrt, t0, t1, params,
                            return_stats=return_stats, row_window=row_window)
    spp = samples_sqrt * samples_sqrt
    n_pix = width * n_rows
    if n_pix >= max_lanes:
        B, m = max_lanes, 1
    else:
        B = n_pix
        m = 1
        for c in range(min(spp, max(max_lanes // n_pix, 1)), 0, -1):
            if spp % c == 0:
                m = c
                break
    L = B * m
    P = spp // m
    n_blocks = -(-n_pix // B)

    img0 = jnp.zeros((n_blocks * B, sensor.n_acc))
    carry0 = (img0, jnp.zeros((2,), jnp.int32))
    if host_blocks and n_blocks > 1:
        # One device execution PER BLOCK (the compiled program is reused; blk
        # is a traced scalar), dispatched from Python. It exists because the
        # previous accelerator faulted on long executions; whether it earns
        # its place on the H100 is ROADMAP S5 (chip_smoke.py checks that both
        # forms render the same frame). Matches the fori_loop form to float
        # rounding (XLA fuses differently across the jit boundary).
        #
        # The jitted step comes from an lru_cache keyed on the STATIC config
        # and takes (scene, cam) as traced arguments: a fresh
        # jax.jit(lambda ...) here would re-trace the whole wavefront
        # program on EVERY render_frame_wavefront call.
        step = _wavefront_block_step(
            static, cam_cfg, sensor, params, width, height, samples_sqrt,
            float(t0), float(t1), B, m, P, n_pix)
        carry = carry0
        import os as _os

        trace_blocks = _os.environ.get("WURBLPT_BLOCK_TRACE", "") == "1"
        for b in range(n_blocks):
            if trace_blocks:
                import sys as _sys
                import time as _time

                jax.block_until_ready(carry)
                _t = _time.perf_counter()
                carry = step(jnp.int32(b), carry, scene, cam)
                jax.block_until_ready(carry)
                print(f"block {b}/{n_blocks}: "
                      f"{(_time.perf_counter() - _t) * 1e3:.1f} ms",
                      file=_sys.stderr)
            else:
                carry = step(jnp.int32(b), carry, scene, cam)
        img, stats = carry
    else:
        if static.has_anim:
            from ..scene.animation import make_anim_ctx

            anim_ctx = make_anim_ctx(scene.anims,
                                     jnp.full((L,), jnp.float32(t0)),
                                     with_forward=static.lights_animated)
        else:
            anim_ctx = None
        from .intersect import mxu_eligible

        if mxu_eligible(scene, anim_ctx):
            from .intersect_mxu import build_mxu_scene

            ms = build_mxu_scene(scene)
        else:
            ms = None
        bounce_fn = _make_bounce_fn(scene, static, sensor, params, anim_ctx,
                                    ms, L)
        fuse_l, fuse_e = _fused_mode(static, params, ms is not None)
        run_block = _make_run_block(
            scene, cam, bounce_fn, fuse_l, fuse_e, static, cam_cfg, sensor,
            params, width, height, samples_sqrt, float(t0), float(t1),
            B, m, P, n_pix, pix_base)
        img, stats = jax.lax.fori_loop(
            0, n_blocks, lambda b, c: run_block(jnp.int32(b), c), carry0
        )
    img = sensor.finish(img[:n_pix], 1.0 / spp).reshape(n_rows, width, sensor.n_acc)
    if return_stats:
        return img, stats
    return img


@functools.lru_cache(maxsize=64)
def _wavefront_block_step(static, cam_cfg, sensor, params, width, height,
                          samples_sqrt, t0, t1, B, m, P, n_pix):
    """Cached jitted (blk, carry, scene, cam) -> carry for host-blocks mode.

    All per-trace derived structures (AnimCtx, matmul operands, the bounce
    closure) are rebuilt INSIDE the jit from the traced scene, so the traced
    program is a pure function of the hashable static key and jax's own
    compilation cache takes over across calls."""
    L = B * m

    def step(blk, carry, scene, cam):
        if static.has_anim:
            from ..scene.animation import make_anim_ctx

            anim_ctx = make_anim_ctx(scene.anims, jnp.full((L,), jnp.float32(t0)),
                                     with_forward=static.lights_animated)
        else:
            anim_ctx = None
        from .intersect import mxu_eligible

        if mxu_eligible(scene, anim_ctx):
            from .intersect_mxu import build_mxu_scene

            ms = build_mxu_scene(scene)
        else:
            ms = None
        bounce_fn = _make_bounce_fn(scene, static, sensor, params, anim_ctx,
                                    ms, L)
        fuse_l, fuse_e = _fused_mode(static, params, ms is not None)
        run_block = _make_run_block(
            scene, cam, bounce_fn, fuse_l, fuse_e, static, cam_cfg, sensor,
            params, width, height, samples_sqrt, t0, t1, B, m, P, n_pix)
        return run_block(blk, carry)

    return jax.jit(step)


def _make_run_block(scene, cam, bounce_fn, fuse_l, fuse_e, static, cam_cfg,
                    sensor, params, width, height, samples_sqrt, t0, t1,
                    B, m, P, n_pix, pix_base=0):
    """One persistent-lane block render as a (blk, carry) -> carry closure
    (shared by the in-jit fori_loop path and the cached host-blocks step).

    The closure renders `n_pix` pixels starting at global pixel `pix_base`
    (a row window of the frame; may be traced)."""
    L = B * m
    lane = jnp.arange(L, dtype=jnp.int32)
    b_lane = lane % B            # pixel slot within the block
    j_lane = lane // B           # sample-lane index in [0, m)
    t0f, t1f = jnp.float32(t0), jnp.float32(t1)

    def run_block(blk, carry):
        img_acc, stats_acc = carry
        pix0 = blk * B
        p_lane = pix_base + pix0 + b_lane      # global pixel id (RNG key)
        valid = (pix0 + b_lane < n_pix) & (p_lane < width * height)
        p_safe = jnp.minimum(p_lane, width * height - 1)
        px = (p_safe % width).astype(jnp.float32)
        py = (p_safe // width).astype(jnp.float32)

        init_ls = _LoopState(
            bounce=jnp.zeros((L,), jnp.int32),
            o=jnp.zeros((L, 3)),
            d=jnp.concatenate([jnp.zeros((L, 2)), jnp.ones((L, 1))], -1),
            time=jnp.full((L,), t0f),
            ior=jnp.ones((L, 4)),
            throughput=jnp.zeros((L, 4)),
            active=jnp.zeros((L,), bool),
            acc=jnp.zeros((L, sensor.n_acc)),
            geom_len=jnp.zeros((L,)),
            opt_len=jnp.zeros((L, 4)),
            prev_pdf=jnp.zeros((L,)),
            prev_random=jnp.zeros((L,), bool),
            prev_light_pdf=jnp.zeros((L,)),
            stats=jnp.zeros((2,), jnp.int32),
            **_init_pend_fields(L, fuse_l, fuse_e),
        )
        init = (init_ls, jnp.zeros((L,), jnp.int32), jnp.zeros((L,), jnp.int32))

        def cond(carry):
            ls, sample, k_next = carry
            # The pending term flushes deferred NEE deposits after the last
            # path dies (regeneration never clears a pending — it belongs to
            # the lane's PREVIOUS path and deposits before being replaced).
            return (jnp.any(ls.active) | jnp.any((k_next < P) & valid)
                    | _any_pending(ls))

        def step(carry):
            ls, sample, k_next = carry
            # --- regenerate dead lanes with their pixel's next sample -------
            need = (~ls.active) & (k_next < P) & valid
            s_new = j_lane + k_next * m            # global sample id in [0, spp)
            s = jnp.where(need, s_new, sample)
            si = (s_new % samples_sqrt).astype(jnp.float32)
            sj = (s_new // samples_sqrt).astype(jnp.float32)
            uj = uniform2(p_lane, s_new, 0, Salt.PIXEL_JITTER)
            if params.randomize_ray_over_pixel:
                jx = (si + uj[..., 0]) / samples_sqrt
                jy = (sj + uj[..., 1]) / samples_sqrt
            else:
                jx = jnp.full((L,), 0.5)
                jy = jnp.full((L,), 0.5)
            pxy = jnp.stack([px + jx, py + jy], axis=-1)
            u_time = uniform1(p_lane, s_new, 0, Salt.TIME)
            u_lens = uniform2(p_lane, s_new, 0, Salt.LENS)
            o, d, tme = camera_rays(
                cam, cam_cfg, pxy, width, height, t0f, t1f, u_time, u_lens,
                anims=scene.anims,
            )
            sel = need[:, None]
            ls = ls._replace(
                bounce=jnp.where(need, 0, ls.bounce),
                o=jnp.where(sel, o, ls.o),
                d=jnp.where(sel, d, ls.d),
                time=jnp.where(need, tme, ls.time),
                ior=jnp.where(sel, 1.0, ls.ior),
                throughput=jnp.where(sel, 1.0, ls.throughput),
                active=ls.active | need,
                geom_len=jnp.where(need, 0.0, ls.geom_len),
                opt_len=jnp.where(sel, 0.0, ls.opt_len),
                prev_pdf=jnp.where(need, 0.0, ls.prev_pdf),
                prev_random=jnp.where(need, False, ls.prev_random),
                prev_light_pdf=jnp.where(need, 0.0, ls.prev_light_pdf),
            )
            k_next = k_next + need.astype(jnp.int32)
            # --- extend every live path by one bounce ------------------------
            ls = bounce_fn(ls, p_lane, s)
            return ls, s, k_next

        final_ls, _, _ = jax.lax.while_loop(cond, step, init)
        block_img = final_ls.acc.reshape(m, B, sensor.n_acc).sum(0)
        img_acc = jax.lax.dynamic_update_slice(img_acc, block_img, (pix0, 0))
        return img_acc, stats_acc + final_ls.stats

    return run_block


def render_frame_progressive(
    scene: SceneArrays,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    t0: float = 0.0,
    t1: float = 0.0,
    params: RenderParams = RenderParams(),
    samples_per_pass: int = 1,
    passes_per_chunk: int = 1,
    progress_cb=None,
):
    """`render_frame` with host-side progress reporting: the pass loop runs
    OUTSIDE jit in chunks, invoking ``progress_cb(passes_done, n_pass,
    preview_image)`` after each chunk (the reference prints per-block %
    progress to stderr, wurblpt.hpp:370-387). Bit-identical to `render_frame`
    for any chunking because the RNG is counter-based on (pixel, sample).

    The preview passed to the callback is the CURRENT accumulator finished at
    the samples completed so far — a live, correctly-exposed image.
    """
    spp = samples_sqrt * samples_sqrt
    assert spp % samples_per_pass == 0, "samples_per_pass must divide spp"
    n_pass = spp // samples_per_pass
    n_pix = width * height

    step = jax.jit(
        accumulate_passes,
        static_argnames=("static", "cam_cfg", "sensor", "width", "height",
                         "samples_sqrt", "params", "samples_per_pass",
                         "n_pass"),
    )
    img_acc = jnp.zeros((n_pix, sensor.n_acc))
    done = 0
    while done < n_pass:
        chunk = min(passes_per_chunk, n_pass - done)
        img_acc = step(scene, static, cam, cam_cfg, sensor, width, height,
                       samples_sqrt, t0, t1, params, samples_per_pass,
                       img_acc, done, chunk)
        done += chunk
        if progress_cb is not None:
            samples_done = done * samples_per_pass
            preview = sensor.finish(img_acc, 1.0 / samples_done).reshape(
                height, width, sensor.n_acc)
            progress_cb(done, n_pass, preview)
    img = sensor.finish(img_acc, 1.0 / spp)
    return img.reshape(height, width, sensor.n_acc)


# ---------------------------------------------------------------------------
# Frame renderer (the mcpt() equivalent)
# ---------------------------------------------------------------------------

def render_frame(
    scene: SceneArrays,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    t0: float = 0.0,
    t1: float = 0.0,
    params: RenderParams = RenderParams(),
    samples_per_pass: int = 1,
    return_stats: bool = False,
    row_window: Optional[Tuple] = None,
):
    """Render a full frame: stratified samples per pixel, sample-batch loop in
    jit (`lax.fori_loop` over passes), sensor finish at the end.

    Equivalent of ``mcpt(sensor, camera, scene, samplesSqrt, t0, t1, params)``
    (wurblpt.hpp:279-449). Returns the finished image [height, width, n_acc]
    ([n_rows, width, n_acc] with a `row_window`, as in
    `render_frame_wavefront`) (+ the [2] int32 cast counters with
    `return_stats`).
    """
    spp = samples_sqrt * samples_sqrt
    assert spp % samples_per_pass == 0, "samples_per_pass must divide spp"
    n_pass = spp // samples_per_pass
    n_rows = height if row_window is None else int(row_window[1])
    img, stats = accumulate_passes(
        scene, static, cam, cam_cfg, sensor, width, height, samples_sqrt,
        t0, t1, params, samples_per_pass,
        jnp.zeros((width * n_rows, sensor.n_acc)), 0, n_pass,
        return_stats=True, row_window=row_window,
    )
    img = sensor.finish(img, 1.0 / spp)
    img = img.reshape(n_rows, width, sensor.n_acc)
    if return_stats:
        return img, stats
    return img


def accumulate_passes(
    scene: SceneArrays,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    t0: float,
    t1: float,
    params: RenderParams,
    samples_per_pass: int,
    img_acc,
    pass_start: int,
    n_pass: int,
    sample_offset=0,
    return_stats: bool = False,
    row_window: Optional[Tuple] = None,
):
    """Accumulate `n_pass` sample passes starting at pass index `pass_start`
    into the raw sensor accumulator `img_acc` [n_pix, n_acc].
    With `return_stats`, also return the summed [2] int32 cast counters.

    `row_window=(row0, n_rows)` accumulates only frame rows [row0, row0 +
    n_rows) (`img_acc` is then [width * n_rows, n_acc]; `row0` may be
    traced). Pixel ids stay global, and rows past the frame trace its last
    pixel and deposit nothing, so the rays never leave the camera's frame.

    `sample_offset` (may be traced) shifts every global sample id — the
    reverse-differentiable way to draw a different stratified sample window
    per optimization step (a traced `pass_start` would make the fori_loop
    bounds dynamic, which reverse-mode rejects).

    Because the RNG is counter-based on (pixel, global sample id), splitting a
    frame's passes across calls — or across process restarts via
    render.checkpoint — is bit-identical to a single render_frame call. This is
    the resume granularity SURVEY.md section 5.4 calls for (the reference can
    only checkpoint whole frames via written image files).
    """
    if row_window is None:
        pix_base, n_rows = 0, height
    else:
        pix_base, n_rows = row_window[0] * width, int(row_window[1])
    n_pix = width * n_rows
    n_rays = n_pix * samples_per_pass  # all of a pass's samples in ONE batch

    pixel_id = pix_base + jnp.arange(n_pix, dtype=jnp.int32)
    in_frame = (pixel_id < width * height)[:, None]
    pixel_id = jnp.minimum(pixel_id, width * height - 1)
    # Samples are folded into the ray batch (wide batches fill the device;
    # the reference instead loops samples per pixel, wurblpt.hpp:348). The RNG is
    # counter-based on (pixel, sample), so the image is bit-identical for any
    # samples_per_pass.
    pid = jnp.broadcast_to(pixel_id[None, :], (samples_per_pass, n_pix)).reshape(-1)
    px = (pid % width).astype(jnp.float32)
    py = (pid // width).astype(jnp.float32)
    s_local = jnp.broadcast_to(
        jnp.arange(samples_per_pass, dtype=jnp.int32)[:, None],
        (samples_per_pass, n_pix),
    ).reshape(-1)

    t0f = jnp.float32(t0)
    t1f = jnp.float32(t1)

    def one_pass(p, carry):
        img_acc, stats_acc = carry
        s = p * samples_per_pass + s_local + sample_offset
        # stratified jitter (wurblpt.hpp:350-359)
        si = (s % samples_sqrt).astype(jnp.float32)
        sj = (s // samples_sqrt).astype(jnp.float32)
        uj = uniform2(pid, s, 0, Salt.PIXEL_JITTER)
        if params.randomize_ray_over_pixel:
            jx = (si + uj[..., 0]) / samples_sqrt
            jy = (sj + uj[..., 1]) / samples_sqrt
        else:
            jx = jnp.full((n_rays,), 0.5)
            jy = jnp.full((n_rays,), 0.5)
        pxy = jnp.stack([px + jx, py + jy], axis=-1)
        u_time = uniform1(pid, s, 0, Salt.TIME)
        u_lens = uniform2(pid, s, 0, Salt.LENS)
        o, d, time = camera_rays(
            cam, cam_cfg, pxy, width, height, t0f, t1f, u_time, u_lens,
            anims=scene.anims,
        )
        acc, stats = trace_paths(
            scene, static, sensor, o, d, time, pid, s, params,
            return_stats=True,
        )
        acc = acc.reshape(samples_per_pass, n_pix, sensor.n_acc).sum(0)
        return img_acc + jnp.where(in_frame, acc, 0.0), stats_acc + stats

    img_out, stats_out = jax.lax.fori_loop(
        pass_start, pass_start + n_pass,
        lambda pp, c: one_pass(jnp.int32(pp), c),
        (img_acc, jnp.zeros((2,), jnp.int32)),
    )
    if return_stats:
        return img_out, stats_out
    return img_out
