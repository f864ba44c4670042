"""Device-side keyframe animation evaluation.

Reference: ``Animation::at(t)`` + binary keyframe search with lerp+slerp
(``animation_keyframes.hpp:51-216``) and the per-render-time ``AnimationCache``
(``animation.hpp:52-125``). Here there is no cache: evaluation is a pure
vectorized gather + slerp over the padded keyframe tables, cheap enough to run
per ray time (motion blur gives every ray its own time anyway).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.transform import Transformation, quat_slerp, quat_to_mat3
from ..core.vecmath import matvec
from .ir import AnimTable


def eval_animation(anims: AnimTable, aid, t) -> Transformation:
    """Evaluate animation `aid` [N] at time `t` [N] -> Transformation batch.

    Clamps outside the keyframe range (the reference clamps too). Row 0 is the
    static identity, so static prims evaluate to identity for free.
    """
    times = anims.times[aid]              # [N, K] (+inf padded)
    k = jnp.sum((times <= t[..., None]).astype(jnp.int32), axis=-1) - 1
    kmax = anims.nkeys[aid] - 1
    k0 = jnp.clip(k, 0, kmax)
    k1 = jnp.clip(k + 1, 0, kmax)
    t0 = jnp.take_along_axis(times, k0[..., None], axis=-1)[..., 0]
    t1 = jnp.take_along_axis(times, k1[..., None], axis=-1)[..., 0]
    denom = jnp.maximum(t1 - t0, 1e-12)
    alpha = jnp.clip((t - t0) / denom, 0.0, 1.0)

    def g(table, idx):
        return jnp.take_along_axis(table[aid], idx[..., None, None], axis=-2)[..., 0, :]

    tr0, tr1 = g(anims.trans, k0), g(anims.trans, k1)
    ro0, ro1 = g(anims.rot, k0), g(anims.rot, k1)
    sc0, sc1 = g(anims.scale, k0), g(anims.scale, k1)
    a = alpha[..., None]
    return Transformation(
        translation=tr0 + (tr1 - tr0) * a,
        rotation=quat_slerp(ro0, ro1, alpha),
        scale=sc0 + (sc1 - sc0) * a,
    )


class AnimCtx(NamedTuple):
    """Per-ray inverse animation frames: the wavefront AnimationCache.

    The reference transforms animated triangle VERTICES at ray time
    (hitable_triangle.hpp ANIMATE path via AnimationCache,
    animation.hpp:52-125). Here we instead transform the RAY into each
    animation's object space once per cast — the hit parameter `t` is
    affine-invariant, so world hit points come from the untransformed ray and
    per-primitive work stays at two gathered mat-vecs.
    """

    r_inv: jnp.ndarray  # [N, A, 3, 3] diag(1/s) R^T
    t_inv: jnp.ndarray  # [N, A, 3]    world translation (subtract pre-rotate)
    time: jnp.ndarray   # [N]
    m_fwd: jnp.ndarray = None  # [N, A, 3, 3] forward map R diag(s); only built
    #                            when animated NEE needs light geometry in
    #                            world space at ray time (lights.py)

    def ray_to_object(self, o, d):
        """World rays [N,3] -> object-space rays per animation [N,A,3]."""
        oo = o[:, None, :] - self.t_inv
        o_a = matvec(self.r_inv, oo)
        d_a = matvec(self.r_inv, d[:, None, :])
        return o_a, d_a


def make_anim_ctx(anims: AnimTable, time, with_forward: bool = False) -> AnimCtx:
    """Evaluate ALL animations at each ray's time (A is small; row 0 identity)."""
    n = time.shape[0]
    a = anims.count
    aid = jnp.broadcast_to(jnp.arange(a, dtype=jnp.int32)[None, :], (n, a))
    tf = eval_animation(anims, aid, time[:, None])
    r3 = quat_to_mat3(tf.rotation)                      # [N,A,3,3], M = R diag(s)
    r_inv = jnp.swapaxes(r3, -1, -2) / jnp.maximum(
        tf.scale[..., :, None], 1e-20
    )                                                   # diag(1/s) R^T
    m_fwd = r3 * tf.scale[..., None, :] if with_forward else None
    return AnimCtx(r_inv=r_inv, t_inv=tf.translation, time=time, m_fwd=m_fwd)


def anim_forward_frames(anims: AnimTable, aid, time):
    """Forward linear map M=R diag(s) and normal matrix R diag(1/s) for the
    winning prims' animations ([N] aid at [N] time) — used by assemble_hit to
    push object-space normals/tangents back to world."""
    tf = eval_animation(anims, aid, time)
    r3 = quat_to_mat3(tf.rotation)
    m = r3 * tf.scale[..., None, :]
    mn = r3 / jnp.maximum(tf.scale[..., None, :], 1e-20)
    return m, mn, tf
