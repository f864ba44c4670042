"""Fused-NEE smoke: render small frames with fused_nee on/off and compare.

The deferred-NEE restructure (RenderParams.fused_nee) must be
estimator-identical: same samples, same contributions, only float
accumulation ORDER differs. Expect max|diff| ~1e-6 relative.

Run on CPU:  JAX_PLATFORMS=cpu python tools/smoke_fused_nee.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

from wurblpt_tpu import (CameraConfig, RenderParams, SceneStatic, SensorRGB,
                         make_camera)
from wurblpt_tpu.core.transform import from_lookat
from wurblpt_tpu.render.integrator import render_frame, render_frame_wavefront
from wurblpt_tpu.utils import scenes


def run(name, scene_b, cam, cfg, w, h, use_bvh=False, renderer="wave"):
    scene = scene_b.build(use_bvh=use_bvh) if use_bvh else scene_b.build()
    static = SceneStatic.from_scene(scene)
    out = {}
    for fused in (False, True):
        params = RenderParams(max_path_components=6, fused_nee=fused)
        fn = render_frame_wavefront if renderer == "wave" else render_frame
        img = fn(scene, static, cam, cfg, SensorRGB(), w, h, 2, params=params)
        out[fused] = np.asarray(img)
    a, b = out[False], out[True]
    d = np.abs(a - b).max()
    rel = d / max(a.max(), 1e-9)
    print(f"{name:24s} mean={a.mean():.6f} fused_mean={b.mean():.6f} "
          f"maxabs={d:.3e} rel={rel:.3e}")
    assert rel < 5e-5, (name, rel)


def main():
    w = h = 32
    pose, vfov = scenes.cornell_ref_camera()
    run("cornell/matmul", scenes.cornell_box_ref(),
        make_camera(transformation=pose, vfov_deg=vfov, width=w, height=h),
        CameraConfig(), w, h)
    run("envmap_cube/matmul", scenes.envmap_spheres(cube=True),
        make_camera(transformation=from_lookat((0.0, 0.6, 4.0), (0, 0, 0)),
                    vfov_deg=40.0, width=w, height=h),
        CameraConfig(), w, h)
    run("terrain/bvh", scenes.terrain_city(seed=3, terrain_res=48,
                                           n_buildings=40),
        make_camera(transformation=from_lookat((14.0, 9.0, 14.0),
                                               (0.0, 0.5, 0.0)),
                    vfov_deg=45.0, width=w, height=h),
        CameraConfig(), w, h, use_bvh=True)
    run("cornell/pass", scenes.cornell_box_ref(),
        make_camera(transformation=pose, vfov_deg=vfov, width=w, height=h),
        CameraConfig(), w, h, renderer="pass")
    print("OK")


if __name__ == "__main__":
    main()
