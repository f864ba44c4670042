"""Multi-device sharding tests on the 8-virtual-CPU-device mesh.

Verifies the claims in wurblpt_tpu/parallel/sharding.py: chip-count invariance
of the counter-based RNG (sharded render == single-device render), gradient
correctness of the sharded training step (XLA psum == unsharded grads), and
the non-divisible-height padding path. This is the automated replacement of
the reference's untested MPI path (SURVEY.md section 4 item 6: "multi-node
testing: none" — we must do better).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wurblpt_tpu import (
    CameraConfig,
    RenderParams,
    SceneStatic,
    SensorRGB,
    make_camera,
)
from wurblpt_tpu.parallel.sharding import (
    make_ray_mesh,
    render_frame_sharded,
    training_step,
)
from wurblpt_tpu.render.integrator import render_frame
from wurblpt_tpu.utils import scenes


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices (see conftest)"
)

_PARAMS = RenderParams(max_path_components=5)


def _setup(w=16, h=16):
    scene = scenes.cornell_box()
    arrays = scene.build()
    static = SceneStatic.from_scene(arrays)
    pose, vfov = scenes.cornell_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=w, height=h)
    return arrays, static, cam


def test_sharded_equals_single_device():
    """Counter-based RNG => the image is independent of which chip computes a
    pixel: 8-way row-sharded render must be BIT-IDENTICAL to 1-device."""
    w = h = 16
    arrays, static, cam = _setup(w, h)
    sensor = SensorRGB()
    single = np.asarray(
        render_frame(arrays, static, cam, CameraConfig(), sensor, w, h, 2,
                     params=_PARAMS)
    )
    mesh8 = make_ray_mesh(jax.devices()[:8])
    sharded = np.asarray(
        render_frame_sharded(arrays, static, cam, CameraConfig(), sensor,
                             w, h, 2, mesh=mesh8, params=_PARAMS)
    )
    np.testing.assert_array_equal(single, sharded)


def test_sharded_nondivisible_height_pads():
    """height=10 over 8 devices exercises the row-padding path; the result
    must equal the unsharded render of the same frame."""
    w, h = 16, 10
    arrays, static, cam = _setup(w, h)
    sensor = SensorRGB()
    single = np.asarray(
        render_frame(arrays, static, cam, CameraConfig(), sensor, w, h, 2,
                     params=_PARAMS)
    )
    mesh8 = make_ray_mesh(jax.devices()[:8])
    sharded = np.asarray(
        render_frame_sharded(arrays, static, cam, CameraConfig(), sensor,
                             w, h, 2, mesh=mesh8, params=_PARAMS)
    )
    assert sharded.shape == single.shape
    np.testing.assert_array_equal(single, sharded)


def test_training_step_grads_match_unsharded():
    """The sharded training step (the production inverse.make_train_step unit
    over a mesh) must reproduce the unsharded step: same loss, same fitted
    params — the implicit gradient psum across ray shards is exact
    (scene-parameter all-reduce, SURVEY.md section 2.2)."""
    import optax

    from wurblpt_tpu.inverse import make_train_step

    w = h = 16
    arrays, static, cam = _setup(w, h)
    sensor = SensorRGB()
    diff_params = RenderParams(max_path_components=4, differentiable=True)
    target = jnp.zeros((h, w, 3), jnp.float32)

    params0 = {"albedo": arrays.materials.albedo,
               "emissive": arrays.materials.emissive}

    def apply_params(s, p):
        return s._replace(materials=s.materials._replace(
            albedo=p["albedo"], emissive=p["emissive"]))

    step_u, opt_u = make_train_step(
        arrays, apply_params, target, cam=cam, sensor=sensor,
        width=w, height=h, samples_sqrt=2, render_params=diff_params,
        optimizer=optax.sgd(0.1), static=static)
    p_u, _, loss_u, _ = step_u(params0, opt_u.init(params0), jnp.int32(0))

    mesh8 = make_ray_mesh(jax.devices()[:8])
    loss_s, p_s, _ = training_step(
        arrays, static, cam, CameraConfig(), sensor, w, h, 2, target,
        mesh=mesh8, params=diff_params, optimizer=optax.sgd(0.1),
    )
    np.testing.assert_allclose(float(loss_s), float(loss_u), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_s["albedo"]),
                               np.asarray(p_u["albedo"]),
                               rtol=2e-4, atol=1e-7)
    assert np.isfinite(float(loss_s))


def test_local_shard_rows_subset_meshes():
    """local_shard_rows must derive ranges from the mesh's ACTUAL devices —
    subset meshes (measure_scaling's all_devices[:n]) included."""
    import jax
    from wurblpt_tpu.parallel.distributed import local_shard_rows, make_global_mesh

    all_dev = jax.devices()
    for n in (1, 2, 4, 8):
        if n > len(all_dev):
            continue
        mesh = make_global_mesh(devices=all_dev[:n])
        start, count = local_shard_rows(100, mesh)
        # single process: this process owns ALL rows of any of its meshes
        assert (start, count) == (0, 100), (n, start, count)


def test_sharded_wavefront_equals_single_device():
    """The production wavefront under an 8-device mesh must equal the
    single-device wavefront (counter-based RNG, row bands under shard_map)."""
    from wurblpt_tpu.parallel.sharding import render_frame_wavefront_sharded
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    w, h = 16, 24
    arrays, static, cam = _setup(w, h)
    sensor = SensorRGB()
    single = np.asarray(render_frame_wavefront(
        arrays, static, cam, CameraConfig(), sensor, w, h, 2, params=_PARAMS))
    mesh8 = make_ray_mesh(jax.devices()[:8])
    sharded = np.asarray(render_frame_wavefront_sharded(
        arrays, static, cam, CameraConfig(), sensor, w, h, 2,
        mesh=mesh8, params=_PARAMS))
    np.testing.assert_allclose(sharded, single, atol=5e-5)


@pytest.mark.parametrize("n_dev,w,h,surround", [
    (4, 16, 10, False),   # height not divisible: the last band is padded
    (4, 16, 8, True),     # 360-degree stereo: rows map through the frame
], ids=["pad_rows", "surround_stereo"])
def test_sharded_wavefront_bands(n_dev, w, h, surround):
    """Each device renders its own band of rows; the bands assemble into the
    single-device frame, for padded heights and for surround/stereo frames
    whose ray directions depend on the full frame height."""
    from wurblpt_tpu.parallel.sharding import render_frame_wavefront_sharded
    from wurblpt_tpu.render.camera import SurroundMode
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    arrays, static, cam = _setup(w, h)
    cfg = (CameraConfig(surround=SurroundMode.S360, stereo=True) if surround
           else CameraConfig())
    single = np.asarray(render_frame_wavefront(
        arrays, static, cam, cfg, SensorRGB(), w, h, 2, params=_PARAMS))
    mesh = make_ray_mesh(jax.devices()[:n_dev])
    sharded = render_frame_wavefront_sharded(
        arrays, static, cam, cfg, SensorRGB(), w, h, 2, mesh=mesh,
        params=_PARAMS)
    assert sharded.shape == single.shape
    np.testing.assert_allclose(np.asarray(sharded), single, atol=5e-5)


def test_sharded_wavefront_partitions_the_lanes():
    """The compiled sharded program runs 1/n of the lanes per device: GSPMD
    alone would replicate the wavefront loop and render the whole frame on
    every device."""
    from wurblpt_tpu.parallel.sharding import _frame_bands, ray_batch_sizes
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    w, h = 16, 16
    arrays, static, cam = _setup(w, h)
    mesh = make_ray_mesh(jax.devices()[:4])
    fn = _frame_bands(render_frame_wavefront, static, CameraConfig(),
                      SensorRGB(), w, h, 2, mesh, 0.0, 0.0, _PARAMS,
                      max_lanes=131072)
    hlo = fn.lower(arrays, cam).compile().as_text()
    lanes = ray_batch_sizes(hlo)
    # 16 x 16 pixels x 4 samples = 1024 lanes single-device; 256 per device.
    assert 256 in lanes and 1024 not in lanes, sorted(lanes)


@pytest.mark.parametrize("program", ["pass_renderer", "training_step"])
def test_pass_programs_partition_the_lanes(program):
    """The pass renderer (motion-blurred frames) and the training step are
    split by rows, not replicated: each of 4 devices traces a quarter of
    every pass's rays."""
    from wurblpt_tpu.inverse import make_train_step
    from wurblpt_tpu.parallel.sharding import _frame_bands, ray_batch_sizes

    w, h = 16, 16
    arrays, static, cam = _setup(w, h)
    mesh = make_ray_mesh(jax.devices()[:4])
    if program == "pass_renderer":
        fn = _frame_bands(render_frame, static, CameraConfig(), SensorRGB(),
                          w, h, 2, mesh, 0.0, 0.0, _PARAMS, samples_per_pass=1)
        hlo = fn.lower(arrays, cam).compile().as_text()
    else:
        params0 = {"albedo": arrays.materials.albedo}

        def apply_params(s, p):
            return s._replace(materials=s.materials._replace(albedo=p["albedo"]))

        step, opt = make_train_step(
            arrays, apply_params, jnp.zeros((h, w, 3), jnp.float32), cam=cam,
            width=w, height=h, samples_sqrt=2, mesh=mesh, static=static,
            render_params=RenderParams(max_path_components=4,
                                       differentiable=True))
        hlo = step.lower(params0, opt.init(params0),
                         jnp.int32(0)).compile().as_text()
    lanes = ray_batch_sizes(hlo)
    # One sample per pass: 16 x 16 = 256 rays single-device, 64 per device.
    assert 64 in lanes and 256 not in lanes, sorted(lanes)


def test_sharded_motion_blur_equals_single_device():
    """A motion-blurred frame on the mesh goes through the pass renderer's
    row window (10 rows over 4 devices: the last band is short) and equals
    the single-device frame."""
    from wurblpt_tpu.core.transform import Transformation
    from wurblpt_tpu.parallel.sharding import render_frame_wavefront_sharded
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.scene.builder import (AnimationKeyframes, LightDiffuse,
                                           MeshInstance, Scene)
    from wurblpt_tpu.scene.generator import generate_quad

    sc = Scene()
    aid = sc.take_animation(AnimationKeyframes(
        times=[0.0, 1.0],
        transformations=[Transformation.make(translation=(-0.6, 0.0, 0.0)),
                         Transformation.make(translation=(0.6, 0.0, 0.0))]))
    sc.take_mesh_instance(
        MeshInstance(mesh=generate_quad(0.3, 0.3),
                     material=LightDiffuse(radiance=(4, 4, 4)), animation=aid),
        hot_spot=True)
    scene = sc.build(t0=0.0, t1=1.0)
    static = SceneStatic.from_scene(scene)
    w, h = 16, 10
    cam = make_camera(
        transformation=Transformation.make(translation=(0.0, 0.0, 2.5)),
        vfov_deg=50.0, width=w, height=h)
    params = RenderParams(max_path_components=2)
    single = np.asarray(render_frame_wavefront(
        scene, static, cam, CameraConfig(), SensorRGB(), w, h, 2, t0=0.0,
        t1=1.0, params=params))
    sharded = render_frame_wavefront_sharded(
        scene, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
        mesh=make_ray_mesh(jax.devices()[:4]), t0=0.0, t1=1.0, params=params)
    assert sharded.shape == single.shape and single.max() > 0.5
    np.testing.assert_array_equal(np.asarray(sharded), single)


def test_row_windows_tile_the_frame():
    """render_frame_wavefront(row_window=...) is exactly that slice of the
    whole frame: the RNG is keyed on global pixel ids."""
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    w, h = 12, 10
    arrays, static, cam = _setup(w, h)
    full = np.asarray(render_frame_wavefront(
        arrays, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
        params=_PARAMS))
    parts = [np.asarray(render_frame_wavefront(
        arrays, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
        params=_PARAMS, row_window=(r0, 4))) for r0 in (0, 4, 8)]
    assert parts[2][2:].max() == 0.0      # rows past the frame are empty
    np.testing.assert_allclose(np.concatenate(parts)[:h], full, atol=5e-5)
