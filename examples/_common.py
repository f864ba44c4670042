"""Shared helpers for the example apps (the reference's ~100-line mains)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def default_parser(name: str, width=256, height=256, ssqrt=4, depth=8):
    p = argparse.ArgumentParser(prog=name)
    p.add_argument("--width", type=int, default=width)
    p.add_argument("--height", type=int, default=height)
    p.add_argument("--samples-sqrt", type=int, default=ssqrt)
    p.add_argument("--max-depth", type=int, default=depth)
    p.add_argument("--output", default=f"{name}.png")
    p.add_argument("--cpu", action="store_true", help="force JAX_PLATFORMS=cpu")
    return p


def setup_platform(args):
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from wurblpt_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        # Pinned in config as well as in the environment, so a plugin
        # installed beside jaxlib cannot win platform selection.
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


def save_png(path: str, img, tonemap: bool = True):
    """URQ tonemap + sRGB + 8-bit PNG (the reference apps' output path,
    e.g. wurblpt-cornellbox.cpp:262-278)."""
    from PIL import Image

    from wurblpt_tpu.utils import postproc

    a = np.asarray(img)[..., :3]
    if tonemap:
        a = np.asarray(postproc.uniform_rational_quantization(a))
    a = np.asarray(postproc.to_srgb(np.clip(a, 0.0, 1.0)))
    Image.fromarray((np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)).save(path)
    print(f"wrote {path}")


def render(scene_built, cam, cam_cfg, sensor, args, t0=0.0, t1=0.0,
           samples_per_pass=None, params=None):
    import jax

    from wurblpt_tpu import RenderParams, SceneStatic
    from wurblpt_tpu.render.integrator import render_frame

    static = SceneStatic.from_scene(scene_built)
    if params is None:
        params = RenderParams(max_path_components=args.max_depth)
    spp = args.samples_sqrt ** 2
    if samples_per_pass is None:
        samples_per_pass = min(spp, max(1, 2 ** 20 // (args.width * args.height)))
        while spp % samples_per_pass:
            samples_per_pass -= 1
    fn = jax.jit(lambda s, c: render_frame(
        s, static, c, cam_cfg, sensor, args.width, args.height,
        args.samples_sqrt, t0, t1, params, samples_per_pass))
    return fn(scene_built, cam)
