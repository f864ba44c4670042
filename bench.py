"""Benchmark: path-tracing throughput on one NVIDIA GPU.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Primary metric (BASELINE config 1): measured Mrays/s on the Cornell box
128x128 / 16 spp — the EXACT reference scene (utils/cornell_data.py), rendered
with the persistent-lane wavefront. "Rays" are counted INSIDE the loop
(closest-hit casts + NEE shadow casts, integrator._make_bounce_fn stats), the
same work unit the reference's tracePath performs per BVH traversal.

vs_baseline = our paths/s over the reference CPU build's paths/s recorded in
BASELINE.json "published" (parity/src/parity_cornell.cpp; measured on an
earlier host's CPU, not on the machine this runs on).

aux carries the remaining configs: RTIOW + OpenCV-distortion camera (config 2),
envmap + cube-map importance sampling furnace (config 3), ToF AMCW phase image
(config 4), a >100k-triangle BVH scene, and a >=64-emitter city scene. Each
row names the card it ran on (`nvidia-smi` name and power limit).

    python bench.py                      # every config, one JSON line
    python bench.py --config cornell     # one config, in this process

EACH CONFIG RUNS IN ITS OWN SUBPROCESS, one after another, and the parent
never imports JAX: a JAX process reserves most of the card's memory when it
first touches it, so only one JAX process may hold the card at a time. A
config that finds no GPU exits non-zero rather than time the CPU, and so
does the parent if any config failed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np


class Frame(NamedTuple):
    """One config's scene, camera and render settings. `chip_smoke.py`
    renders these same frames, so the smoke test runs the bench's sizes."""

    scene: Any
    static: Any
    cam: Any
    cam_cfg: Any
    params: Any
    width: int
    height: int
    ssqrt: int

    def render_fn(self, **kw):
        """(scene, cam) -> `render_frame_wavefront` of this frame."""
        from wurblpt_tpu import SensorRGB
        from wurblpt_tpu.render.integrator import render_frame_wavefront

        return lambda s, c: render_frame_wavefront(
            s, self.static, c, self.cam_cfg, SensorRGB(), self.width,
            self.height, self.ssqrt, params=self.params, **kw)


def cornell_frame(width=128, height=128, ssqrt=4, mpc=8, use_bvh=False):
    """The EXACT reference Cornell box (utils/cornell_data.py)."""
    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, make_camera
    from wurblpt_tpu.utils import scenes

    scene = scenes.cornell_box_ref().build(use_bvh=use_bvh)
    pose, vfov = scenes.cornell_ref_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=width,
                      height=height)
    return Frame(scene, SceneStatic.from_scene(scene), cam, CameraConfig(),
                 RenderParams(max_path_components=mpc), width, height, ssqrt)


def bvh_100k_frame():
    """>100k-triangle terrain + buildings through the wide-BVH path."""
    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.utils import scenes

    width, height = 160, 120
    scene = scenes.terrain_city(seed=3).build(use_bvh=True)
    cam = make_camera(transformation=from_lookat((14.0, 9.0, 14.0), (0.0, 0.5, 0.0)),
                      vfov_deg=45.0, width=width, height=height)
    return Frame(scene, SceneStatic.from_scene(scene), cam, CameraConfig(),
                 RenderParams(max_path_components=4), width, height, 2)


def city_frame(width=1920, height=1080, ssqrt=1, scene=None):
    """BASELINE config 5 (single-chip variant): Sponza-class composition —
    >200k-tri OBJ/MTL round-tripped scene, 96 emissive windows (alias-table
    light picking), ModPhong/GGX/mirror/RGL materials, 360-degree STEREO
    camera, BVH traversal. `scene` reuses an already built city."""
    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.camera import SurroundMode
    from wurblpt_tpu.utils import scenes

    if scene is None:
        scene = scenes.city_night(seed=7).build(use_bvh=True)
    cam = make_camera(
        transformation=from_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0)),
        vfov_deg=50.0, width=width, height=height, eye_distance=0.065)
    return Frame(scene, SceneStatic.from_scene(scene), cam,
                 CameraConfig(surround=SurroundMode.S360, stereo=True),
                 RenderParams(max_path_components=4), width, height, ssqrt)


# host_blocks with 65536-lane blocks: one device execution per block,
# dispatched from Python. Both values are starting points carried over from
# the previous accelerator and not yet measured on the H100 (ROADMAP S5);
# chip_smoke.py checks that the single-execution form (host_blocks=False)
# renders the same frame.
CITY_MAX_LANES = 65536


def _timeit(fn, *args, n=5):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, out


def bench_cornell():
    import jax

    f = cornell_frame()
    fn = jax.jit(f.render_fn(return_stats=True))
    dt, (img, stats) = _timeit(fn, f.scene, f.cam)
    stats = np.asarray(stats)
    n_paths = f.width * f.height * f.ssqrt ** 2
    return {
        "frame_ms": dt * 1e3,
        "paths_per_s": n_paths / dt,
        "closest_casts": int(stats[0]),
        "total_casts": int(stats[1]),
        "mrays_per_s": stats[1] / dt / 1e6,
        "mean_radiance": float(np.asarray(img).mean()),
    }


def bench_rtiow():
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.render.camera import DistortionModel
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.utils import scenes

    width, height = 192, 128
    ssqrt = 4
    scene = scenes.rtiow().build()
    static = SceneStatic.from_scene(scene)
    pose = from_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))
    cam = make_camera(transformation=pose, vfov_deg=30.0, width=width,
                      height=height,
                      dist_k=(-0.1, 0.02, 0.0, 0.0, 0.0, 0.0),
                      dist_p=(0.001, -0.001))
    # undistort_iters=8 renders bit-identically to 32 ON THIS CONFIG (its
    # distortion is mild); the public default stays 32 for strong ones.
    cfg = CameraConfig(distortion=DistortionModel.OPENCV, undistort_iters=8)
    params = RenderParams(max_path_components=8)
    fn = jax.jit(lambda s, c: render_frame_wavefront(
        s, static, c, cfg, SensorRGB(), width, height, ssqrt,
        params=params, return_stats=True))
    dt, (img, stats) = _timeit(fn, scene, cam)
    stats = np.asarray(stats)
    return {
        "frame_ms": dt * 1e3,
        "paths_per_s": width * height * ssqrt * ssqrt / dt,
        "mrays_per_s": stats[1] / dt / 1e6,
        "mean_radiance": float(np.asarray(img).mean()),
    }


def bench_envmap_furnace():
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.utils import scenes

    width = height = 128
    ssqrt = 4
    scene = scenes.envmap_spheres(cube=True).build()
    static = SceneStatic.from_scene(scene)
    pose = from_lookat((0.0, 0.6, 4.0), (0.0, 0.0, 0.0))
    cam = make_camera(transformation=pose, vfov_deg=40.0, width=width, height=height)
    params = RenderParams(max_path_components=8)
    fn = jax.jit(lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), SensorRGB(), width, height, ssqrt,
        params=params, return_stats=True))
    dt, (img, stats) = _timeit(fn, scene, cam)
    stats = np.asarray(stats)
    return {
        "frame_ms": dt * 1e3,
        "paths_per_s": width * height * ssqrt * ssqrt / dt,
        "mrays_per_s": stats[1] / dt / 1e6,
        "mean_radiance": float(np.asarray(img).mean()),
    }


def bench_tof():
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.render.sensor import SensorTofAmcw
    from wurblpt_tpu.utils import scenes

    width = height = 96
    ssqrt = 4
    scene = scenes.tof_box().build()
    static = SceneStatic.from_scene(scene)
    pose = from_lookat((0.0, 0.0, 1.19), (0.0, 0.0, 0.0))
    cam = make_camera(transformation=pose, vfov_deg=60.0, width=width, height=height)
    sensor = SensorTofAmcw(phase_index=0)
    params = RenderParams(max_path_components=6)
    fn = jax.jit(lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), sensor, width, height, ssqrt,
        params=params, return_stats=True))
    dt, (img, stats) = _timeit(fn, scene, cam)
    stats = np.asarray(stats)
    img_np = np.asarray(img)
    # Guard against a silently dark capture (round-4 found the ToF light
    # facing out of the room; throughput alone cannot catch that).
    assert (img_np != 0).mean() > 0.5, "ToF frame is dark"
    return {
        "frame_ms": dt * 1e3,
        "paths_per_s": width * height * ssqrt * ssqrt / dt,
        "mrays_per_s": stats[1] / dt / 1e6,
        "mean_energy_j": float(img_np.mean()),
    }


def bench_bvh_large():
    """>100k-triangle scene through the BVH path."""
    import jax

    f = bvh_100k_frame()
    fn = jax.jit(f.render_fn(return_stats=True))
    dt, (img, stats) = _timeit(fn, f.scene, f.cam, n=3)
    stats = np.asarray(stats)
    return {
        "n_tris": f.scene.n_tris,
        "frame_ms": dt * 1e3,
        "paths_per_s": f.width * f.height * f.ssqrt ** 2 / dt,
        "mrays_per_s": stats[1] / dt / 1e6,
        "mean_radiance": float(np.asarray(img).mean()),
    }


def bench_city_many_lights():
    """The city at 1080p, 1 spp, in host blocks (see CITY_MAX_LANES)."""
    f = city_frame()
    fn = f.render_fn(return_stats=True, host_blocks=True,
                     max_lanes=CITY_MAX_LANES)
    dt, (img, stats) = _timeit(fn, f.scene, f.cam, n=1)
    stats = np.asarray(stats)
    return {
        "n_tris": f.scene.n_tris,
        "n_lights": int(f.scene.light_prims.shape[0]),
        "frame_ms": dt * 1e3,
        "paths_per_s": f.width * f.height * f.ssqrt ** 2 / dt,
        "mrays_per_s": stats[1] / dt / 1e6,
        "mean_radiance": float(np.asarray(img).mean()),
    }


CONFIGS = {
    "cornell": bench_cornell,
    "rtiow_distortion": bench_rtiow,
    "envmap_cube_is": bench_envmap_furnace,
    "tof_amcw": bench_tof,
    "bvh_100k": bench_bvh_large,
    "city_many_lights": bench_city_many_lights,
}


def _run_config(name: str) -> int:
    """Child-process entry: run ONE config on the GPU and print its result
    JSON. Returns 2, having run nothing, when JAX's first device is not a
    GPU (no CUDA plugin, or a fallback to the CPU)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from wurblpt_tpu.utils.compile_cache import enable_compile_cache
    from wurblpt_tpu.utils.metadata import gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX's first device is {dev.platform} "
              f"{dev.device_kind}); config {name!r} not run", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    result = CONFIGS[name]()
    result["device"] = dev.device_kind
    result["card"] = card
    print("WURBLPT_BENCH_RESULT:" + json.dumps(result))
    return 0


CONFIG_TIMEOUTS = {"city_many_lights": 2700.0, "bvh_100k": 1800.0}


def _spawn_config(name: str, timeout_s: float = 1200.0):
    """Run one config in a fresh interpreter; return its result dict."""
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--config", name],
        capture_output=True, text=True, timeout=timeout_s, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("WURBLPT_BENCH_RESULT:"):
            return json.loads(line[len("WURBLPT_BENCH_RESULT:"):])
    tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-6:]
    return {"error": f"rc={proc.returncode}: " + " | ".join(tail)}


def main():
    aux = {}
    for name in CONFIGS:
        try:
            aux[name] = _spawn_config(name, CONFIG_TIMEOUTS.get(name, 1200.0))
        except subprocess.TimeoutExpired:
            aux[name] = {"error": "timeout"}
        except Exception as e:  # a failing config must not kill the bench
            aux[name] = {"error": f"{type(e).__name__}: {e}"}
    aux["device"] = aux.get("cornell", {}).pop("device", "unknown")
    aux["card"] = aux.get("cornell", {}).pop("card", "unknown")
    for name in CONFIGS:
        if isinstance(aux.get(name), dict):
            aux[name].pop("device", None)

    cornell = aux.get("cornell", {})
    pub = {}
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE.json")) as f:
            pub = json.load(f).get("published", {})
    except Exception:
        pass
    # Per-config reference-CPU denominators (parity/src/parity_*.cpp builds,
    # measured on an earlier host's CPU) -> vs_ref_cpu ratio on every row.
    ref_keys = {
        "cornell": "cornell128_16spp_ref_cpu_paths_per_s",
        "rtiow_distortion": "rtiow_192x128_16spp_ref_cpu_paths_per_s",
        "envmap_cube_is": "envmap_cube_is_128_16spp_ref_cpu_paths_per_s",
        "tof_amcw": "tof_96_16spp_ref_cpu_paths_per_s",
        "bvh_100k": "bvh100k_160x120_4spp_ref_cpu_paths_per_s",
        "city_many_lights": "city_1080p_360stereo_1spp_ref_cpu_paths_per_s",
    }
    for name, key in ref_keys.items():
        row = aux.get(name)
        ref = float(pub.get(key, 0.0))
        if isinstance(row, dict) and "paths_per_s" in row and ref > 0:
            row["ref_cpu_paths_per_s"] = ref
            row["vs_ref_cpu"] = round(row["paths_per_s"] / ref, 3)
    baseline = float(pub.get("cornell128_16spp_ref_cpu_paths_per_s", 0.0))
    paths_per_s = float(cornell.get("paths_per_s", 0.0))
    vs = paths_per_s / baseline if baseline > 0 else 0.0

    print(json.dumps({
        "metric": "cornell128_16spp_mrays_per_s",
        "value": round(float(cornell.get("mrays_per_s", 0.0)), 3),
        "unit": "Mrays/s",
        "vs_baseline": round(vs, 3),
        "aux": aux,
    }))
    failed = [n for n in CONFIGS if "error" in aux.get(n, {"error": ""})]
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--config":
        sys.exit(_run_config(sys.argv[2]))
    sys.exit(main())
