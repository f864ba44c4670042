"""Surround-format conversion tools.

Array equivalents of the reference's three converter executables
(``tools/wurblpt-360-to-180.cpp``, ``tools/wurblpt-stereo-to-mono.cpp``,
``tools/wurblpt-360-to-conventional.cpp``). Images here are numpy/jnp arrays
[H, W, C] with row 0 at the top; stereo frames are top/bottom packed with the
LEFT view on top (the packing camera_rays produces).

Run as a CLI: ``python -m wurblpt_tpu.utils.surround <cmd> ...``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def surround_360_to_180(img):
    """Crop a 360° equirect image to 180°: the center half of every row
    (works for mono and top/bottom stereo alike; wurblpt-360-to-180.cpp:54-60)."""
    w = img.shape[1]
    return img[:, w // 4: w // 4 + w // 2]


def stereo_to_mono(img):
    """Extract the left view from a top/bottom stereo frame
    (wurblpt-stereo-to-mono.cpp:52-53; left = top in our packing)."""
    h = img.shape[0]
    return img[: h // 2]


def stereo_pack(left, right):
    """Top/bottom pack two views (left on top)."""
    return np.concatenate([np.asarray(left), np.asarray(right)], axis=0)


def conventional_from_360(
    img,
    width: int,
    height: int,
    vfov_deg: float = 50.0,
    rotation=None,
):
    """Re-render a 360° mono frame as a conventional pinhole view by path
    tracing an environment map with max depth 1
    (wurblpt-360-to-conventional.cpp:64-87). Stereo inputs (square frames in
    the reference's heuristic) should be split with stereo_to_mono first and
    re-packed with stereo_pack.

    rotation: optional quaternion [x,y,z,w] camera orientation.
    """
    from ..core.transform import Transformation
    from ..render.camera import CameraConfig, make_camera
    from ..render.integrator import RenderParams, render_frame
    from ..render.sensor import SensorRGB
    from ..scene import builder as B
    from ..scene.flatten import flatten_scene
    from ..render.bsdf import SceneStatic

    img = np.asarray(img, np.float32)
    if img.shape[-1] == 3:
        img = np.concatenate([img, img.mean(-1, keepdims=True)], -1)

    scene = B.Scene()
    scene.set_environment_map(
        B.EnvironmentMapEquiRect(image=img, x_convention_surround=True))
    arrays = flatten_scene(scene)
    static = SceneStatic.from_scene(arrays)

    tf = Transformation.identity()
    if rotation is not None:
        tf = tf._replace(rotation=jnp.asarray(rotation, jnp.float32))
    cam = make_camera(transformation=tf, vfov_deg=vfov_deg,
                      width=width, height=height)
    params = RenderParams(max_path_components=1, randomize_ray_over_pixel=False)
    out = render_frame(arrays, static, cam, CameraConfig(), SensorRGB(),
                       width, height, 1, params=params)
    return np.asarray(out)[..., :3]


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    a = np.asarray(Image.open(path), np.float32)
    if a.dtype == np.uint8 or a.max() > 1.5:
        a = a / 255.0
    return a


def _save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    a = np.clip(np.asarray(img), 0.0, 1.0)
    Image.fromarray((a * 255.0 + 0.5).astype(np.uint8)).save(path)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="wurblpt-surround")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("360-to-180", "stereo-to-mono"):
        sp = sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("output")
    sp = sub.add_parser("360-to-conventional")
    sp.add_argument("width", type=int)
    sp.add_argument("height", type=int)
    sp.add_argument("vfov", type=float)
    sp.add_argument("input")
    sp.add_argument("output")
    a = p.parse_args(argv)

    img = _load_image(a.input)
    if a.cmd == "360-to-180":
        out = surround_360_to_180(img)
    elif a.cmd == "stereo-to-mono":
        out = stereo_to_mono(img)
    else:
        if img.shape[0] == img.shape[1]:  # stereo heuristic (square frame)
            l = conventional_from_360(stereo_to_mono(img), a.width,
                                      a.height // 2, a.vfov)
            r = conventional_from_360(img[img.shape[0] // 2:], a.width,
                                      a.height // 2, a.vfov)
            out = stereo_pack(l, r)
        else:
            out = conventional_from_360(img, a.width, a.height, a.vfov)
    _save_image(a.output, out)


if __name__ == "__main__":
    main()
