"""Smoke test of the path tracer on one NVIDIA GPU, at the bench's sizes.

    python chip_smoke.py            # all single-card phases
    python chip_smoke.py --four     # only the four-card mesh path

Every phase runs in THIS process, on the card, through the public entry
points (`render_frame_wavefront`, `render_frame`, `inverse.fit`,
`parallel.sharding`), and is checked against a plain reference: the reference
renderer's goldens under `parity/golden/`, an analytic invariant, or the same
program compiled for the CPU backend of this process. Each phase prints one
line: its compile time, its run time, and each comparison as value, bound and
the reason for the bound.

Running every program in one process is deliberate: it is the check that the
GPU backend does not mis-dispatch executables across programs (the tests
patch jax 0.9.0's dispatch fastpath on CPU; this script does not).

Exit status is 0 only if every phase passed. The last line of stdout is then
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`. With
no GPU (JAX fell back to the CPU, or no CUDA plugin) the script exits 2
before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Sizes of what is not a bench config. cornell, bvh_100k and the 1080p city
# render bench.py's frames as they are; the city golden is the reference
# renderer's own frame (parity/golden/).
FURNACE = dict(width=256, height=256, ssqrt=2, mpc=8, albedo=0.6, env=1.5)
CITY_GOLDEN = dict(width=192, height=108, ssqrt=4)
INVERSE = dict(width=64, height=64, ssqrt=2, mpc=4, steps=6)
TIMED_RUNS = 3


class PhaseFailed(Exception):
    pass


class Phase:
    """Collects one phase's timings and comparisons into its printed line."""

    def __init__(self, name):
        self.name = name
        self.parts = []
        self.failed = []

    def time(self, label, seconds):
        self.parts.append(f"{label} {seconds:.6g} s")

    def note(self, text):
        self.parts.append(text)

    def check(self, what, value, bound, reason, op="<="):
        ok = value <= bound if op == "<=" else value >= bound
        self.parts.append(f"{what} {value:.6g} {op} {bound:.6g} "
                          f"[{'ok' if ok else 'FAIL'}: {reason}]")
        if not ok:
            self.failed.append(what)

    def report(self):
        import jax

        mem = jax.devices()[0].memory_stats()
        if mem and "peak_bytes_in_use" in mem:
            self.note(f"device peak so far {mem['peak_bytes_in_use'] / 2**30:.4g} GiB")
        status = "FAIL " + ",".join(self.failed) if self.failed else "ok"
        print(f"phase {self.name} | " + " | ".join(self.parts)
              + f" | {status}", flush=True)
        if self.failed:
            raise PhaseFailed(self.name)


def _compile(fn, args):
    """AOT-compile `fn` for the devices its arguments live on."""
    import jax

    t = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t


def _run(compiled, args, repeats=TIMED_RUNS):
    """Warm call, then the median wall time of `repeats` calls (with none,
    the warm call's time)."""
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    times = [time.perf_counter() - t] if repeats == 0 else []
    for _ in range(repeats):
        t = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t)
    return out, statistics.median(times)


def _on(device, tree):
    import jax

    return jax.device_put(tree, device)


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _compare_backends(ph, label, gpu, cpu):
    """GPU frame vs the same program on the CPU backend.

    The counter-based RNG gives both the same samples, so a pixel differs
    only where float ordering (fusion, FMA contraction, reduction order)
    flips a discrete decision of one path: a hit at a silhouette, a lobe, a
    Russian-roulette draw. Such a flip moves one sample of one pixel a long
    way, so the bounds are on the share of pixels that agree and on the
    image mean, not on the largest difference (printed for the record)."""
    gpu = np.asarray(gpu, np.float64)
    cpu = np.asarray(cpu, np.float64)
    assert gpu.shape == cpu.shape and np.isfinite(gpu).all()
    diff = np.abs(gpu - cpu)
    close = (diff <= 1e-4 * np.abs(cpu) + 1e-6).all(-1)
    ph.check(f"{label}.pixels_differing", float(1.0 - close.mean()), 0.01,
             "<=1% of pixels may hold a path flipped by float ordering")
    ph.check(f"{label}.mean_rel",
             float(abs(gpu.mean() - cpu.mean()) / max(abs(cpu.mean()), 1e-12)),
             1e-3, "flipped paths are few and unbiased")
    ph.note(f"{label}.max_abs {diff.max():.4g}")


def _cornell_golden_metrics(ph, label, ours):
    """tests/test_parity.py's metrics, at the golden's own 128x128."""
    sys.path.insert(0, os.path.join(REPO, "parity"))
    import tgdshim

    def load(name):
        img, _ = tgdshim.load(os.path.join(REPO, "parity", "golden", name))
        return np.asarray(img, np.float32)[::-1]

    ours = np.asarray(ours, np.float32)
    h, w = ours.shape[:2]
    # Box-downsample the goldens to a smaller frame (uniform pixel jitter
    # makes that the expectation of the smaller render).
    f = 128 // h
    ref, ref16 = (load(n).reshape(h, f, w, f, 3).mean((1, 3)) for n in (
        "ref_cornell_128_2500spp.tgdshim", "ref_cornell_128_16spp.tgdshim"))
    scale = max(float(ref.mean()), 1e-9)
    ref_self = float(np.abs(ref16 - ref).mean()) / scale
    ph.check(f"{label}.golden_mean_abs_rel",
             float(np.abs(ours - ref).mean()) / scale,
             max(2.0 * ref_self, 0.10),
             "2x the reference's own 16-spp noise vs its 2500-spp image")
    ph.check(f"{label}.golden_mean_rel",
             abs(float(ours.mean()) - float(ref.mean())) / scale, 0.02,
             "unbiased: global means agree well under the noise floor")
    ph.check(f"{label}.golden_channel_rel",
             float(np.max(np.abs(ours.mean((0, 1)) - ref.mean((0, 1)))
                          / ref.mean((0, 1)))), 0.03, "color balance")
    worst = max(
        abs(float(np.quantile(ours.sum(-1), q)) - float(np.quantile(ref.sum(-1), q)))
        - (0.10 * max(float(np.quantile(ref.sum(-1), q)), 0.02) + 0.004)
        for q in (0.1, 0.25, 0.5, 0.75, 0.9))
    ph.check(f"{label}.golden_quantile_excess", worst, 0.0,
             "luminance quantiles within 10% + 0.004 of the golden's")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from wurblpt_tpu.utils.compile_cache import cache_dir
    from wurblpt_tpu.utils.metadata import gpu_name_and_power_limit

    ph = Phase("device")
    dev = jax.devices()[0]
    print(gpu_name_and_power_limit(), flush=True)
    try:
        import PIL  # noqa: F401
        pil = "importable"
    except ImportError:
        pil = "not importable"
    ph.note(f"{dev.platform} {dev.device_kind} x{len(jax.devices())}")
    ph.note(f"jax {jax.__version__}")
    ph.note(f"compile cache {cache_dir()}")
    ph.note(f"PIL {pil}")
    ph.report()


def phase_cornell():
    """Brute-force matmul cast, the bench's cornell frame; and the same frame
    with the BVH forced (the first datum for the cast crossover)."""
    import jax

    import bench

    ph = Phase("cornell")
    gpu = jax.devices()[0]
    f = bench.cornell_frame()
    fn = f.render_fn(return_stats=True)
    args = _on(gpu, (f.scene, f.cam))
    compiled, tc = _compile(fn, args)
    (img, stats), tr = _run(compiled, args)
    ph.time("compile", tc)
    ph.time("frame (matmul cast)", tr)
    n_paths = f.width * f.height * f.ssqrt ** 2
    ph.note(f"paths/s {n_paths / tr:.4g}, casts {int(np.asarray(stats)[1])}")
    _cornell_golden_metrics(ph, "matmul", img)

    args_cpu = _on(_cpu(), (f.scene, f.cam))
    compiled_cpu, tc_cpu = _compile(fn, args_cpu)
    (img_cpu, _), _ = _run(compiled_cpu, args_cpu, repeats=0)
    ph.time("cpu compile", tc_cpu)
    _compare_backends(ph, "vs_cpu", img, img_cpu)

    fb = bench.cornell_frame(use_bvh=True)
    assert fb.scene.bvh is not None
    args_b = _on(gpu, (fb.scene, fb.cam))
    compiled_b, tc_b = _compile(fb.render_fn(return_stats=True), args_b)
    (img_b, _), tr_b = _run(compiled_b, args_b)
    ph.time("bvh compile", tc_b)
    ph.time("frame (bvh forced)", tr_b)
    _cornell_golden_metrics(ph, "bvh", img_b)
    ph.report()


def phase_furnace():
    """White furnace: every sphere pixel is exactly albedo * env radiance.
    The sharpest probe of reduced-precision matrix products."""
    import jax

    from wurblpt_tpu import (CameraConfig, RenderParams, SceneStatic,
                             SensorRGB, make_camera)
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.utils import scenes

    cfg = FURNACE
    ph = Phase("furnace")
    w, h = cfg["width"], cfg["height"]
    scene = scenes.furnace(albedo=cfg["albedo"], env_radiance=cfg["env"]).build()
    static = SceneStatic.from_scene(scene)
    vfov = 40.0
    cam = make_camera(transformation=from_lookat((0, 0, 4), (0, 0, 0)),
                      vfov_deg=vfov, width=w, height=h)
    params = RenderParams(max_path_components=cfg["mpc"],
                          randomize_ray_over_pixel=False)
    fn = lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), SensorRGB(), w, h, cfg["ssqrt"],
        params=params)
    args = _on(jax.devices()[0], (scene, cam))
    compiled, tc = _compile(fn, args)
    img, tr = _run(compiled, args)
    ph.time("compile", tc)
    ph.time("frame", tr)
    img = np.asarray(img, np.float64)
    # Unit sphere at distance 4: its silhouette is a centered circle of
    # radius tan(asin(1/4)) / tan(vfov/2) half-heights; keep pixels whose
    # centre lies well inside it.
    r_px = np.tan(np.arcsin(0.25)) / np.tan(np.radians(vfov / 2)) * (h / 2)
    yy, xx = np.mgrid[0:h, 0:w]
    inside = np.hypot(xx + 0.5 - w / 2, yy + 0.5 - h / 2) < 0.9 * r_px
    want = cfg["albedo"] * cfg["env"]
    ph.note(f"{int(inside.sum())} sphere pixels")
    ph.check("sphere_max_rel", float(np.abs(img[inside] / want - 1.0).max()),
             1e-5, "f32 rounding of atten/pdf only; TF32 would show at 1e-3")
    ph.report()


def phase_bvh_100k():
    """Wide-BVH traversal at the bench's bvh_100k frame, vs the CPU backend
    on the same full frame (same samples)."""
    import jax

    import bench

    ph = Phase("bvh_100k")
    t = time.perf_counter()
    f = bench.bvh_100k_frame()
    ph.time("scene build", time.perf_counter() - t)
    fn = f.render_fn(return_stats=True)
    args = _on(jax.devices()[0], (f.scene, f.cam))
    compiled, tc = _compile(fn, args)
    (img, _), tr = _run(compiled, args)
    ph.time("compile", tc)
    ph.time("frame", tr)
    ph.note(f"{f.scene.n_tris} tris, mean radiance "
            f"{float(np.asarray(img).mean()):.6g}")
    args_cpu = _on(_cpu(), (f.scene, f.cam))
    compiled_cpu, tc_cpu = _compile(fn, args_cpu)
    (img_cpu, _), _ = _run(compiled_cpu, args_cpu, repeats=0)
    ph.time("cpu compile", tc_cpu)
    ph.note(f"compared on the full {f.ssqrt ** 2}-spp frame")
    _compare_backends(ph, "vs_cpu", img, img_cpu)
    ph.report()


def phase_city():
    """City: 249k triangles, 192 lights, RGL, 1080p 360-degree stereo; once
    in host blocks as the bench runs it, once as one execution; then a
    golden-sized frame against the reference renderer."""
    import jax

    import bench

    ph = Phase("city_many_lights")
    t = time.perf_counter()
    f = bench.city_frame()
    ph.time("scene build", time.perf_counter() - t)
    ph.note(f"{f.scene.n_tris} tris, {int(f.scene.light_prims.shape[0])} lights")
    gpu = jax.devices()[0]
    scene, cam = _on(gpu, (f.scene, f.cam))

    # Host blocks, as the bench runs it: a cached per-block program
    # dispatched from Python.
    hb = f.render_fn(return_stats=True, host_blocks=True,
                     max_lanes=bench.CITY_MAX_LANES)
    t = time.perf_counter()
    img_hb, st_hb = jax.block_until_ready(hb(scene, cam))
    ph.time("host-blocks first frame (incl. compile)", time.perf_counter() - t)
    t = time.perf_counter()
    img_hb, st_hb = jax.block_until_ready(hb(scene, cam))
    ph.time("host-blocks frame", time.perf_counter() - t)
    # One execution: the whole frame's block loop inside one program.
    one = f.render_fn(return_stats=True, max_lanes=bench.CITY_MAX_LANES)
    compiled, tc = _compile(one, (scene, cam))
    (img_one, st_one), tr = _run(compiled, (scene, cam), repeats=1)
    ph.time("single-execution compile", tc)
    ph.time("single-execution frame", tr)
    ph.note(f"mean radiance {float(np.asarray(img_one).mean()):.6g}")
    ph.check("host_blocks_vs_single.cast_count_diff",
             float(np.abs(np.asarray(st_hb) - np.asarray(st_one)).max()), 0.0,
             "same samples, same casts (tests/test_observability.py)")
    ph.check("host_blocks_vs_single.max_abs",
             float(np.abs(np.asarray(img_hb) - np.asarray(img_one)).max()),
             5e-5, "fusion-order rounding only (tests/test_observability.py)")

    # Golden-sized frame vs the reference renderer (tests/test_parity_city.py
    # metrics).
    sys.path.insert(0, os.path.join(REPO, "parity"))
    import tgdshim

    gw, gh = CITY_GOLDEN["width"], CITY_GOLDEN["height"]
    ref = np.asarray(tgdshim.load(os.path.join(
        REPO, "parity", "golden", f"ref_city_{gw}x{gh}_16spp.tgdshim"))[0],
        np.float32)[::-1]
    g = bench.city_frame(gw, gh, CITY_GOLDEN["ssqrt"], scene=f.scene)
    args_g = (scene, _on(gpu, g.cam))
    compiled_g, tc_g = _compile(g.render_fn(), args_g)
    ours, tr_g = _run(compiled_g, args_g, repeats=1)
    ours = np.asarray(ours, np.float32)
    ph.time(f"golden {gw}x{gh} compile", tc_g)
    ph.time(f"golden {gw}x{gh} frame", tr_g)
    sky = np.abs(ours[:4] - ref[:4]) - (2e-2 * np.abs(ref[:4]) + 2e-3)
    ph.check("golden_sky_rows_excess", float(sky.max()), 0.0,
             "direct-envmap rows are noise-free: rtol 2e-2, atol 2e-3")
    r = float(np.minimum(ref, 0.2).mean())
    o = float(np.minimum(ours, 0.2).mean())
    ph.check("golden_clipped_mean_rel", abs(o - r) / r, 0.12,
             "clipped means: few-spp firefly tails differ between estimators")
    worst = max(
        abs(float(np.quantile(ours.sum(-1), q)) - float(np.quantile(ref.sum(-1), q)))
        - (0.10 * max(float(np.quantile(ref.sum(-1), q)), 0.02) + 0.004)
        for q in (0.25, 0.5, 0.75))
    ph.check("golden_quantile_excess", worst, 0.0,
             "mid luminance quantiles within 10% + 0.004")
    ph.report()


def _inverse_setup(cfg=INVERSE):
    """Cornell at `cfg`'s size, a target rendered at its true albedo, and a
    grey start. Returns (static, params, apply_params, arrays) where
    `arrays` = (scene, cam, target, params0) is what moves between devices."""
    import jax.numpy as jnp

    import bench
    from wurblpt_tpu import SensorRGB
    from wurblpt_tpu.render.integrator import render_frame

    f = bench.cornell_frame(cfg["width"], cfg["height"], cfg["ssqrt"],
                            cfg["mpc"])
    scene, static, cam, params = f.scene, f.static, f.cam, f.params
    target = render_frame(scene, static, cam, f.cam_cfg, SensorRGB(),
                          f.width, f.height, f.ssqrt, params=params)
    params0 = {"albedo": jnp.full_like(scene.materials.albedo, 0.5)}

    def apply_params(s, p):
        return s._replace(materials=s.materials._replace(albedo=p["albedo"]))

    return static, params, apply_params, (scene, cam, target, params0)


def _keep_gradient():
    """An optax transformation that applies no update and keeps the last
    gradient as its state, so a training step returns its exact gradient."""
    import jax
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree.map(jax.numpy.zeros_like, p),
        lambda g, state, params=None: (
            jax.tree.map(jax.numpy.zeros_like, g), g))


def _train_step(setup, place, cfg=INVERSE, mesh=None):
    """`fit`'s training step with its arrays on `place` (a device, or the
    mesh's replicated sharding with `mesh`) and an optimizer that returns
    the step's gradient. Returns (jitted step, its arguments at step 0)."""
    import jax.numpy as jnp

    from wurblpt_tpu.inverse import make_train_step

    static, params, apply_params, arrays = setup
    scene, cam, target, params0 = _on(place, arrays)
    step, opt = make_train_step(
        scene, apply_params, target, cam=cam, width=cfg["width"],
        height=cfg["height"], samples_sqrt=cfg["ssqrt"], render_params=params,
        optimizer=_keep_gradient(), static=static, mesh=mesh)
    return step, (params0, opt.init(params0), jnp.int32(0))


def _first_gradient(setup, device, cfg=INVERSE):
    """The gradient `fit` takes at step 0, computed on `device` by the same
    training step. Returns (loss, gradient of the albedo table)."""
    step, args = _train_step(setup, device, cfg)
    _, grad, loss, _ = step(*args)
    return float(loss), np.asarray(grad["albedo"], np.float64)


def phase_inverse():
    """`inverse.fit` on Cornell 64x64 through the differentiable
    render_frame: the loss falls, and the first gradient matches the CPU
    backend's."""
    import jax

    from wurblpt_tpu.inverse import fit

    cfg = INVERSE
    ph = Phase("inverse")
    setup = _inverse_setup()
    static, params, apply_params, (scene, cam, target, params0) = setup
    t = time.perf_counter()
    res = fit(scene, params0, apply_params, target, cam=cam,
              width=cfg["width"], height=cfg["height"],
              samples_sqrt=cfg["ssqrt"], render_params=params,
              steps=cfg["steps"])
    jax.block_until_ready(res.params)
    ph.time(f"fit {cfg['steps']} steps (incl. compile)", time.perf_counter() - t)
    ph.note("losses " + " ".join(f"{x:.5g}" for x in res.losses))
    ph.check("loss_last_over_first", res.losses[-1] / res.losses[0], 1.0,
             "Adam on albedo from a grey start must descend")
    t = time.perf_counter()
    loss_g, g_gpu = _first_gradient(setup, jax.devices()[0])
    ph.time("first-gradient step (incl. compile)", time.perf_counter() - t)
    loss_c, g_cpu = _first_gradient(setup, _cpu())
    ph.note(f"|grad| {np.linalg.norm(g_cpu):.4g}")
    ph.check("grad_rel_l2", float(np.linalg.norm(g_gpu - g_cpu)
                                  / max(np.linalg.norm(g_cpu), 1e-30)),
             1e-4, "same samples; read 2.9e-6 on the H100, and products in "
                   "TF32 (~1e-3 relative) would exceed it")
    ph.check("loss_rel", abs(loss_g - loss_c) / max(abs(loss_c), 1e-30), 1e-3,
             "same samples, as the cornell frame")
    ph.report()


def phase_four():
    """The mesh path on four cards: the cornell bench frame sharded by rows
    against the one-card frame, and the sharded training step against the
    one-card step, in its result and its time."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from wurblpt_tpu import CameraConfig, SensorRGB
    from wurblpt_tpu.parallel.sharding import (
        make_ray_mesh, ray_batch_sizes, render_frame_wavefront_sharded,
        training_step)

    ph = Phase("four")
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devs)}")
    mesh = make_ray_mesh(devs[:4])
    f = bench.cornell_frame()

    args1 = _on(devs[0], (f.scene, f.cam))
    compiled1, tc1 = _compile(f.render_fn(return_stats=True), args1)
    (img1, _), t1 = _run(compiled1, args1)

    scene_r, cam_r = _on(NamedSharding(mesh, P()), (f.scene, f.cam))

    def sharded():
        return render_frame_wavefront_sharded(
            scene_r, f.static, cam_r, f.cam_cfg, SensorRGB(), f.width,
            f.height, f.ssqrt, mesh=mesh, params=f.params)

    t = time.perf_counter()
    img4 = jax.block_until_ready(sharded())
    tc4 = time.perf_counter() - t
    times = []
    for _ in range(TIMED_RUNS):
        t = time.perf_counter()
        img4 = jax.block_until_ready(sharded())
        times.append(time.perf_counter() - t)
    t4 = statistics.median(times)
    shard_devs = sorted({str(s.device) for s in img4.addressable_shards})
    ph.time("1-card compile", tc1)
    ph.time("1-card frame", t1)
    ph.time("4-card first frame (incl. compile)", tc4)
    ph.time("4-card frame", t4)
    ph.note(f"output shards on {shard_devs}")
    ph.check("distinct_cards_holding_shards", float(len(shard_devs)), 4.0,
             "each card renders its own band of rows", op=">=")
    ph.check("speedup_4_over_1", t1 / t4, 1.5,
             "a replicated frame would show ~1x", op=">=")
    img4 = np.asarray(img4, np.float64)
    img1 = np.asarray(img1, np.float64)
    ph.check("frame_max_abs", float(np.abs(img4 - img1).max()), 1e-4,
             "same samples per pixel; only the order of summing a pixel's "
             "sample lanes differs")

    icfg = INVERSE
    setup = _inverse_setup()
    static_i, rparams, apply_params, arrays = setup
    scene_r, cam_r, target_r, params0_r = _on(NamedSharding(mesh, P()), arrays)
    t = time.perf_counter()
    loss4, _, grad4 = training_step(
        scene_r, static_i, cam_r, CameraConfig(), SensorRGB(),
        icfg["width"], icfg["height"], icfg["ssqrt"], target_r,
        params0=params0_r, apply_params=apply_params, mesh=mesh,
        params=rparams, optimizer=_keep_gradient())
    g4 = np.asarray(grad4["albedo"], np.float64)
    ph.time("4-card training step (incl. compile)", time.perf_counter() - t)
    loss1, g1 = _first_gradient(setup, devs[0])
    ph.note(f"|grad| {np.linalg.norm(g1):.4g}")
    ph.check("train_loss_rel", abs(float(loss4) - loss1) / abs(loss1), 1e-4,
             "the loss is a mean over the same pixels, reduced in 4 parts")
    ph.check("train_grad_rel_l2",
             float(np.linalg.norm(g4 - g1) / max(np.linalg.norm(g1), 1e-30)),
             1e-4, "gradient all-reduce over the ray shards is exact up to "
                   "summation order")

    # The training step at the bench frame's size, timed without compile on
    # one card and on the mesh; each card must trace a quarter of every
    # pass's rays (one sample per pass: width * height rays).
    tcfg = dict(width=f.width, height=f.height, ssqrt=f.ssqrt,
                mpc=f.params.max_path_components)
    tsetup = _inverse_setup(tcfg)
    step1, targs1 = _train_step(tsetup, devs[0], tcfg)
    _, tstep1 = _run(step1.lower(*targs1).compile(), targs1)
    step4, targs4 = _train_step(tsetup, NamedSharding(mesh, P()), tcfg, mesh)
    compiled4 = step4.lower(*targs4).compile()
    _, tstep4 = _run(compiled4, targs4)
    rays = tcfg["width"] * tcfg["height"]
    hlo4 = compiled4.as_text()
    lanes = ray_batch_sizes(hlo4)
    ph.time(f"1-card training step {tcfg['width']}x{tcfg['height']}", tstep1)
    ph.time("4-card training step", tstep4)
    ph.check("train_speedup_4_over_1", tstep1 / tstep4, 1.5,
             "a replicated step would show ~1x", op=">=")
    full = [ln.strip()[:300] for ln in hlo4.splitlines()
            if f"f32[{rays},3]" in ln]
    if full:
        ph.note(f"first full-batch instruction: {full[0]}")
    ph.check("train_step_full_batch_arrays", float(len(full)), 0.0,
             f"no card holds a whole pass of {rays} rays")
    ph.check("train_step_quarter_batch_arrays", float(rays // 4 in lanes),
             1.0, f"each card traces {rays // 4} rays per pass", op=">=")
    ph.report()


PHASES = [phase_cornell, phase_furnace, phase_bvh_100k, phase_city,
          phase_inverse]


def _platforms_with_cpu():
    """Keep the CPU backend available beside the GPU for the references."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    _platforms_with_cpu()
    sys.path.insert(0, REPO)
    import jax

    from wurblpt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform} "
              f"{dev.device_kind}); nothing was run", file=sys.stderr)
        return 2
    phase_device()
    failed = []
    for phase in ([phase_four] if args.four else PHASES):
        try:
            phase()
        except PhaseFailed:      # its line, with the failed checks, is out
            failed.append(phase.__name__)
        except Exception as e:  # noqa: BLE001 - reported, and fails the run
            traceback.print_exc()
            print(f"phase {phase.__name__[6:]} | FAIL {type(e).__name__}: {e}",
                  flush=True)
            failed.append(phase.__name__)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
