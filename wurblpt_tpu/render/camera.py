"""Cameras: projection, lens distortion, depth of field, surround & stereo.

Covers the reference's ``libwurblpt/optics.hpp`` (Projection with OpenCV
centerPixel+focalLength intrinsics :58-109, three LensDistortion models :152-310,
thin-lens DoF :312-335) and ``libwurblpt/camera.hpp`` (surround Off/180/360
modes :45-49, top/bottom-packed stereo with per-direction ODS eye offset
:129-170, motion-blur time sampling :174-180, image-space reprojection :205-217).

The camera pose/intrinsics are differentiable traced parameters (CameraParams
pytree); mode switches are static Python config (CameraConfig), so each mode
compiles to straight-line code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import sampler
from ..core.transform import (
    Transformation,
    quat_conjugate,
    quat_mul,
    quat_rotate,
)
from ..core.vecmath import normalize


class SurroundMode:
    OFF = 0
    S180 = 1
    S360 = 2


class DistortionModel:
    NONE = 0
    RADIAL_AND_PLANAR = 1   # optics.hpp:251-268 (closed-form undistort)
    RADIAL_ONLY = 2         # optics.hpp:269-278 (Drap-Lefevre inverse series)
    OPENCV = 3              # optics.hpp:279-308 (k1,k2,k3,p1,p2; iterative undistort)


@dataclass(frozen=True)
class CameraConfig:
    """Static (trace-time) camera switches."""

    surround: int = SurroundMode.OFF
    stereo: bool = False              # top/bottom packed stereo
    distortion: int = DistortionModel.NONE
    dof: bool = False
    undistort_iters: int = 32         # fixed-count replacement for the <=256-iter
    #                                   loop (optics.hpp:279-308). 32 meets the
    #                                   reference's 0.001 px tolerance across a
    #                                   sweep of strong coefficient sets
    #                                   (tests/test_sensors_optics.py round-trip
    #                                   test); 8 under-converges ~10x at
    #                                   k1=-0.3-class distortion (advisor
    #                                   round-4 finding), so the PUBLIC default
    #                                   is 32 and the bench config — where 8
    #                                   renders bit-identically — opts into 8
    #                                   explicitly.
    anim_id: int = -1                 # scene animation driving the pose per ray
    #                                   time (camera.hpp:56-111: a camera owns an
    #                                   Animation; -1 = static CameraParams pose)


class CameraParams(NamedTuple):
    """Differentiable camera parameters."""

    transformation: Transformation    # camera-to-world pose (at frame t0)
    center_px: jnp.ndarray            # [2] principal point (cx, cy) in pixels
    focal_px: jnp.ndarray             # [2] focal length (fx, fy) in pixels
    dist_k: jnp.ndarray               # [6] radial coefficients (k1..k6; model-dependent)
    dist_p: jnp.ndarray               # [2] tangential/planar coefficients (p1, p2)
    eye_distance: jnp.ndarray         # [] stereo interocular distance
    focus_distance: jnp.ndarray       # [] DoF focus plane distance
    aperture_diameter: jnp.ndarray    # [] DoF lens diameter


def make_camera(
    transformation: Optional[Transformation] = None,
    vfov_deg: Optional[float] = None,
    width: int = 1,
    height: int = 1,
    center_px=None,
    focal_px=None,
    dist_k=(0.0,) * 6,
    dist_p=(0.0, 0.0),
    eye_distance: float = 0.0635,
    focus_distance: float = 1.0,
    aperture_diameter: float = 0.0,
) -> CameraParams:
    """Build CameraParams either from a vertical field of view (Projection's
    vfov+aspect constructor, optics.hpp:58-65) or raw OpenCV intrinsics."""
    if transformation is None:
        transformation = Transformation.identity()
    if focal_px is None:
        assert vfov_deg is not None, "need vfov_deg or focal_px"
        fy = 0.5 * height / np.tan(np.deg2rad(vfov_deg) / 2.0)
        focal_px = (fy, fy)
    if center_px is None:
        center_px = (width / 2.0, height / 2.0)
    return CameraParams(
        transformation=transformation,
        center_px=jnp.asarray(center_px, jnp.float32),
        focal_px=jnp.asarray(focal_px, jnp.float32),
        dist_k=jnp.asarray(dist_k, jnp.float32),
        dist_p=jnp.asarray(dist_p, jnp.float32),
        eye_distance=jnp.asarray(eye_distance, jnp.float32),
        focus_distance=jnp.asarray(focus_distance, jnp.float32),
        aperture_diameter=jnp.asarray(aperture_diameter, jnp.float32),
    )


# ---------------------------------------------------------------------------
# Lens distortion (normalized image coordinates)
# ---------------------------------------------------------------------------

def distort_normalized(cam: CameraParams, cfg: CameraConfig, xy):
    """Forward distortion model on normalized coords (optics.hpp:227-246)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    k = cam.dist_k
    p1, p2 = cam.dist_p[0], cam.dist_p[1]
    if cfg.distortion == DistortionModel.NONE:
        return xy
    if cfg.distortion == DistortionModel.RADIAL_ONLY:
        radial = 1.0 + k[0] * r2 + k[1] * r2 * r2 + k[2] * r2 * r2 * r2
        return xy * radial[..., None]
    # RADIAL_AND_PLANAR and OPENCV share the polynomial + tangential form.
    radial = 1.0 + k[0] * r2 + k[1] * r2 * r2 + k[2] * r2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([x * radial + dx, y * radial + dy], axis=-1)


def undistort_normalized(cam: CameraParams, cfg: CameraConfig, xy):
    """Inverse distortion on normalized coords.

    RADIAL_AND_PLANAR: closed-form first-order inverse (optics.hpp:251-268).
    RADIAL_ONLY: Drap & Lefevre exact inverse series truncated at 4 terms
    (optics.hpp:269-278). OPENCV: fixed-point iteration (the reference iterates
    up to 256 times to 0.001 px, optics.hpp:279-308; we run a fixed count so
    the loop is compile-time static).
    """
    if cfg.distortion == DistortionModel.NONE:
        return xy
    k = cam.dist_k
    if cfg.distortion == DistortionModel.RADIAL_AND_PLANAR:
        # Closed-form first-order inverse (WSCG 2018 model, optics.hpp:251-268):
        # one implicit-function step: u = x - J^-1 * d(x), with the Jacobian's
        # trace approximated by (4 k1 r^2 + 6 k2 r^4 + 8 p1 y + 8 p2 x + 1).
        x, y = xy[..., 0], xy[..., 1]
        p1, p2 = cam.dist_p[0], cam.dist_p[1]
        r2 = x * x + y * y
        r4 = r2 * r2
        d1 = k[0] * r2 + k[1] * r4
        d2 = 1.0 / (4.0 * k[0] * r2 + 6.0 * k[1] * r4 + 8.0 * p1 * y + 8.0 * p2 * x + 1.0)
        ux = x - d2 * (d1 * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        uy = y - d2 * (d1 * y + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return jnp.stack([ux, uy], axis=-1)
    if cfg.distortion == DistortionModel.RADIAL_ONLY:
        # Inverse polynomial coefficients (Drap-Lefevre): b1=-k1, b2=3k1^2-k2, ...
        k1, k2, k3 = k[0], k[1], k[2]
        b1 = -k1
        b2 = 3.0 * k1 * k1 - k2
        b3 = -12.0 * k1 ** 3 + 8.0 * k1 * k2 - k3
        b4 = 55.0 * k1 ** 4 - 55.0 * k1 * k1 * k2 + 5.0 * k2 * k2 + 10.0 * k1 * k3
        r2 = jnp.sum(xy * xy, axis=-1)
        radial = 1.0 + b1 * r2 + b2 * r2 ** 2 + b3 * r2 ** 3 + b4 * r2 ** 4
        return xy * radial[..., None]

    def body(_, und):
        # solve distort(und) = xy by fixed point: und <- xy - (distort(und) - und)
        return xy - (distort_normalized(cam, cfg, und) - und)

    return jax.lax.fori_loop(0, cfg.undistort_iters, body, xy)


# ---------------------------------------------------------------------------
# Ray generation
# ---------------------------------------------------------------------------

def camera_rays(
    cam: CameraParams,
    cfg: CameraConfig,
    pixel_xy,            # [N, 2] float pixel coords (jitter already applied)
    width: int,
    height: int,
    t0,
    t1,
    u_time,              # [N] uniforms for motion-blur time
    u_lens,              # [N, 2] uniforms for DoF lens sampling
    anims=None,          # AnimTable; required when cfg.anim_id >= 0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Generate world-space rays for pixel centers (camera.hpp:123-185).

    Animated cameras (cfg.anim_id >= 0, camera.hpp:56-111,174-180): the pose is
    the scene animation evaluated at each ray's motion-blur time, composed with
    the static CameraParams pose (animation-local offset; identity CameraParams
    reproduces the reference's animation-only camera). Camera motion blur and
    per-frame video poses both fall out of this.

    Returns (origin [N,3], direction [N,3], time [N]).
    """
    px, py = pixel_xy[..., 0], pixel_xy[..., 1]
    time = t0 + u_time * (t1 - t0)
    tf = cam.transformation
    if cfg.anim_id >= 0:
        assert anims is not None, "animated camera needs the scene AnimTable"
        from ..scene.animation import eval_animation

        aid = jnp.full(time.shape, cfg.anim_id, jnp.int32)
        atf = eval_animation(anims, aid, time)
        # compose: world <- animation <- static camera-local pose
        tf = Transformation(
            translation=atf.translation
            + quat_rotate(atf.rotation, tf.translation * atf.scale),
            rotation=quat_mul(atf.rotation, jnp.broadcast_to(tf.rotation, atf.rotation.shape)),
            scale=atf.scale * tf.scale,
        )

    eff_height = height // 2 if cfg.stereo else height
    # top half = left eye (0), bottom half = right (1) (camera.hpp stereo packing)
    if cfg.stereo:
        eye = jnp.where(py < eff_height, 0.0, 1.0)
        py = jnp.where(py < eff_height, py, py - eff_height)
        eye_sign = jnp.where(eye < 0.5, -1.0, 1.0)
    else:
        eye_sign = jnp.zeros_like(px)

    if cfg.surround == SurroundMode.OFF:
        # Pinhole with optional distortion: pixel -> normalized -> undistort.
        nx = (px - cam.center_px[0]) / cam.focal_px[0]
        ny = (py - cam.center_px[1] if not cfg.stereo else py - cam.center_px[1] * (eff_height / height)) / cam.focal_px[1]
        und = undistort_normalized(cam, cfg, jnp.stack([nx, ny], axis=-1))
        d_cam = jnp.stack([und[..., 0], -und[..., 1], -jnp.ones_like(nx)], axis=-1)
        o_cam = jnp.zeros_like(d_cam)
        # conventional stereo: shift eye along camera x
        o_cam = o_cam.at[..., 0].add(eye_sign * 0.5 * cam.eye_distance)
    else:
        # Equirect surround (camera.hpp:129-170): 360 maps the full width to
        # [-pi, pi]; 180 maps it to [-pi/2, pi/2].
        span = jnp.pi if cfg.surround == SurroundMode.S360 else jnp.pi / 2.0
        phi = (px / width * 2.0 - 1.0) * span
        theta = (0.5 - py / eff_height) * jnp.pi
        ct = jnp.cos(theta)
        d_cam = jnp.stack(
            [ct * jnp.sin(phi), jnp.sin(theta), -ct * jnp.cos(phi)], axis=-1
        )
        # ODS-style per-direction eye offset (Google Jump; camera.hpp:74-79):
        # the eye sits on a circle of diameter eye_distance, offset perpendicular
        # to the viewing column.
        offset_dir = jnp.stack([jnp.cos(phi), jnp.zeros_like(phi), jnp.sin(phi)], axis=-1)
        o_cam = eye_sign[..., None] * 0.5 * cam.eye_distance * offset_dir

    if cfg.dof:
        # Thin lens (optics.hpp:312-335): jitter origin in the lens disk and
        # keep the focus-plane point fixed.
        lens = sampler.in_unit_disk(u_lens) * 0.5 * cam.aperture_diameter
        focus_pt = o_cam + d_cam * (cam.focus_distance / jnp.maximum(-d_cam[..., 2:3], 1e-6))
        o_cam = o_cam + jnp.concatenate([lens, jnp.zeros_like(lens[..., :1])], axis=-1)
        d_cam = focus_pt - o_cam

    d_world = quat_rotate(tf.rotation, normalize(d_cam))
    o_world = quat_rotate(tf.rotation, o_cam * tf.scale) + tf.translation
    return o_world, d_world, time


def camera_space_to_image_space(cam: CameraParams, cfg: CameraConfig, p_cam, width, height):
    """Project a camera-space point to pixel coords (camera.hpp:205-217), used
    by the optical-flow ground truth. Returns [N,2] pixels (may be off-screen)."""
    if cfg.surround == SurroundMode.OFF:
        z = jnp.minimum(p_cam[..., 2], -1e-6)
        # Inverse of camera_rays: d_cam = [ (px-cx)/fx, -(py-cy)/fy, -1 ], so
        # the normalized image coords of p are (-x/z, y/z) — note y/z, NOT
        # -y/z (a flip here breaks getRay <-> reprojection round trips and
        # every pixel-flow AOV; wurblpt.hpp:709 asserts this consistency).
        nx = -p_cam[..., 0] / z
        ny = p_cam[..., 1] / z
        dist = distort_normalized(cam, cfg, jnp.stack([nx, ny], axis=-1))
        px = dist[..., 0] * cam.focal_px[0] + cam.center_px[0]
        py = dist[..., 1] * cam.focal_px[1] + cam.center_px[1]
        return jnp.stack([px, py], axis=-1)
    span = jnp.pi if cfg.surround == SurroundMode.S360 else jnp.pi / 2.0
    d = normalize(p_cam)
    phi = jnp.arctan2(d[..., 0], -d[..., 2])
    theta = jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0))
    px = (phi / span + 1.0) * 0.5 * width
    py = (0.5 - theta / jnp.pi) * height
    return jnp.stack([px, py], axis=-1)


def world_to_camera(cam: CameraParams, p_world):
    tf = cam.transformation
    return quat_rotate(quat_conjugate(tf.rotation), p_world - tf.translation) / tf.scale
