"""Scaling-efficiency harness: rays/s vs device count (BASELINE target >=85%).

Runs the sharded Cornell render over meshes of 1..N devices and reports
throughput + parallel efficiency. On several GPUs this measures scaling over
their interconnect; on a dev box it runs on virtual CPU devices (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) to validate the harness
and the sharding story end to end.

Usage: python tools/scaling_bench.py [--devices 1 2 4 8] [--size 128]
"""

import argparse
import json
import os
import sys

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402

if "--cpu" in sys.argv:
    # Pinned in config as well as in the environment, so a plugin installed
    # beside jaxlib cannot win platform selection.
    jax.config.update("jax_platforms", "cpu")

from wurblpt_tpu import (  # noqa: E402
    CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera,
)
from wurblpt_tpu.parallel import (  # noqa: E402
    init_multihost, make_global_mesh, measure_scaling, render_frame_sharded,
)
from wurblpt_tpu.utils import scenes  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp-sqrt", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="force virtual CPU mesh")
    args = ap.parse_args()

    init_multihost()
    n_all = len(jax.devices())
    counts = args.devices or [c for c in (1, 2, 4, 8, 16, 32) if c <= n_all]

    scene = scenes.cornell_box()
    arrays = scene.build()
    static = SceneStatic.from_scene(arrays)
    pose, vfov = scenes.cornell_camera()
    w = h = args.size
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=w, height=h)
    params = RenderParams(max_path_components=8)
    n_paths = w * h * args.spp_sqrt ** 2

    def render_fn(mesh):
        img = render_frame_sharded(
            arrays, static, cam, CameraConfig(), SensorRGB(), w, h,
            args.spp_sqrt, mesh=mesh, params=params,
        )
        jax.block_until_ready(img)
        return n_paths  # paths traced (lower bound on rays)

    results = measure_scaling(render_fn, counts)
    for r in results:
        print(json.dumps({
            "metric": "scaling_paths_per_s",
            "devices": r["devices"],
            "value": round(r["rays_per_s"], 1),
            "unit": "paths/s",
            "efficiency": round(r["efficiency"], 3),
        }))


if __name__ == "__main__":
    main()
