"""Post-processing on rendered images (``libwurblpt/postproc.hpp``).

All functions take/return [H, W, C] jnp arrays and run on any JAX backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.color import rgb_luminance, rgb_to_srgb
from ..render.camera import CameraConfig, CameraParams, distort_normalized, undistort_normalized


def to_srgb(img):
    """Linear -> sRGB transfer (postproc.hpp:44)."""
    return rgb_to_srgb(jnp.clip(img, 0.0, 1.0))


def max_luminance(img):
    """Maximum pixel luminance (postproc.hpp:64)."""
    return jnp.max(rgb_luminance(img[..., :3]))


def uniform_rational_quantization(img, max_lum=None, brightness: float = 32.0):
    """URQ tone mapping (postproc.hpp:76-91): v' = v*(1+v/m^2)/(1+v) style
    rational curve scaled by a brightness parameter."""
    lum = rgb_luminance(img[..., :3])
    if max_lum is None:
        max_lum = jnp.maximum(jnp.max(lum), 1e-8)
    v = lum / max_lum
    mapped = v * (1.0 + brightness) / (1.0 + brightness * v)
    gain = jnp.where(lum > 1e-12, mapped * max_lum / jnp.maximum(lum, 1e-12), 0.0)
    return img * gain[..., None] / max_lum


def scale_luminance(img, factor):
    """Uniform luminance scale (postproc.hpp:93)."""
    return img * factor


def rescale(img, new_h: int, new_w: int):
    """Bilinear resize (postproc.hpp:112)."""
    h, w = img.shape[0], img.shape[1]
    yy = (jnp.arange(new_h) + 0.5) * (h / new_h) - 0.5
    xx = (jnp.arange(new_w) + 0.5) * (w / new_w) - 0.5
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, h - 1)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    fy = jnp.clip(yy - y0, 0.0, 1.0)[:, None, None]
    fx = jnp.clip(xx - x0, 0.0, 1.0)[None, :, None]
    c00 = img[y0][:, x0]
    c01 = img[y0][:, x1]
    c10 = img[y1][:, x0]
    c11 = img[y1][:, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def despeckle(img, threshold: float = 10.0):
    """Firefly removal (postproc.hpp:143-193): replace pixels whose luminance
    exceeds `threshold` x the median of their 3x3 neighborhood by that median
    (applied per channel via the luminance ratio)."""
    lum = rgb_luminance(img[..., :3])
    pad = jnp.pad(lum, 1, mode="edge")
    neigh = jnp.stack(
        [
            pad[dy : dy + lum.shape[0], dx : dx + lum.shape[1]]
            for dy in range(3)
            for dx in range(3)
            if not (dy == 1 and dx == 1)
        ],
        axis=-1,
    )
    med = jnp.median(neigh, axis=-1)
    bad = lum > threshold * jnp.maximum(med, 1e-12)
    gain = jnp.where(bad, med / jnp.maximum(lum, 1e-12), 1.0)
    return img * gain[..., None]


def _resample_normalized(img, cam: CameraParams, cfg: CameraConfig, forward: bool):
    """Shared warp: for each destination pixel, map through the (un)distortion
    and bilinearly sample the source (postproc.hpp:197-248)."""
    h, w = img.shape[0], img.shape[1]
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5, indexing="ij")
    nx = (xx - cam.center_px[0]) / cam.focal_px[0]
    ny = (yy - cam.center_px[1]) / cam.focal_px[1]
    xy = jnp.stack([nx, ny], axis=-1)
    mapped = distort_normalized(cam, cfg, xy) if forward else undistort_normalized(cam, cfg, xy)
    sx = mapped[..., 0] * cam.focal_px[0] + cam.center_px[0] - 0.5
    sy = mapped[..., 1] * cam.focal_px[1] + cam.center_px[1] - 0.5
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    fx = jnp.clip(sx - x0, 0, 1)[..., None]
    fy = jnp.clip(sy - y0, 0, 1)[..., None]
    c00 = img[y0, x0]
    c01 = img[y0, x1]
    c10 = img[y1, x0]
    c11 = img[y1, x1]
    out = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    return jnp.where(inside[..., None], out, 0.0)


def distort_image(img, cam: CameraParams, cfg: CameraConfig):
    """Apply lens distortion to an undistorted image: each distorted output
    pixel samples the undistorted source at its undistorted location."""
    return _resample_normalized(img, cam, cfg, forward=False)


def undistort_image(img, cam: CameraParams, cfg: CameraConfig):
    """Remove lens distortion: each output pixel samples the distorted source
    at its distorted location."""
    return _resample_normalized(img, cam, cfg, forward=True)


def tof_distance_to_coords(distance, cam: CameraParams, cfg: CameraConfig):
    """ToF camera-space distance image -> 3D camera-space coordinates
    (postproc.hpp:252-287): undistort the pixel, unproject its ray, scale so the
    point sits at the measured *distance* (not depth)."""
    h, w = distance.shape[0], distance.shape[1]
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5, indexing="ij")
    nx = (xx - cam.center_px[0]) / cam.focal_px[0]
    ny = (yy - cam.center_px[1]) / cam.focal_px[1]
    und = undistort_normalized(cam, cfg, jnp.stack([nx, ny], -1))
    d = jnp.stack([und[..., 0], -und[..., 1], -jnp.ones_like(und[..., 0])], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return d * distance[..., None]


def extract_component(img, c: int):
    """postproc.hpp:313-338."""
    return img[..., c]
