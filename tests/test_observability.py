"""Progress reporting + output metadata stamping (the reference's TGD tags +
stderr progress, wurblpt.hpp:370-435)."""

import os

import numpy as np

from wurblpt_tpu import (
    CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera,
    render_frame, render_frame_progressive,
)
from wurblpt_tpu.utils import scenes
from wurblpt_tpu.utils.metadata import (
    read_png_metadata, save_png_with_metadata, timed_render,
)


def _setup(w=24, h=24):
    scene = scenes.cornell_box_ref().build()
    static = SceneStatic.from_scene(scene)
    pose, vfov = scenes.cornell_ref_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=w, height=h)
    return scene, static, cam


def test_progressive_matches_render_frame_and_reports():
    scene, static, cam = _setup()
    params = RenderParams(max_path_components=4)
    ref = np.asarray(render_frame(
        scene, static, cam, CameraConfig(), SensorRGB(), 24, 24, 2,
        params=params))
    seen = []

    def cb(done, total, preview):
        seen.append((done, total, float(np.asarray(preview).mean())))

    img = np.asarray(render_frame_progressive(
        scene, static, cam, CameraConfig(), SensorRGB(), 24, 24, 2,
        params=params, samples_per_pass=1, passes_per_chunk=1,
        progress_cb=cb))
    # bit-identical to the one-shot render (counter-based RNG)
    np.testing.assert_array_equal(img, ref)
    # 4 passes -> 4 callbacks, monotone progress, correctly-exposed previews
    assert [s[0] for s in seen] == [1, 2, 3, 4]
    assert all(s[1] == 4 for s in seen)
    assert all(np.isfinite(s[2]) and s[2] >= 0 for s in seen)


def test_wavefront_host_blocks_matches_fused():
    """host_blocks=True (one device execution per lane block, dispatched
    from Python) must match the fused fori_loop form up to XLA fusion-order
    rounding."""
    import jax.numpy as jnp

    from wurblpt_tpu import render_frame_wavefront

    scene, static, cam = _setup(32, 32)
    params = RenderParams(max_path_components=4)
    a, sa = render_frame_wavefront(
        scene, static, cam, CameraConfig(), SensorRGB(), 32, 32, 2,
        params=params, max_lanes=256, return_stats=True)
    b, sb = render_frame_wavefront(
        scene, static, cam, CameraConfig(), SensorRGB(), 32, 32, 2,
        params=params, max_lanes=256, return_stats=True, host_blocks=True)
    np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5)


def test_metadata_stamp_roundtrip(tmp_path):
    scene, static, cam = _setup(16, 16)
    params = RenderParams(max_path_components=3)
    with timed_render(spp=4, params=params, width=16, height=16,
                      scene="cornell") as st:
        img = render_frame(scene, static, cam, CameraConfig(), SensorRGB(),
                           16, 16, 2, params=params)
        st.total_casts = 12345
    path = str(tmp_path / "out.png")
    save_png_with_metadata(path, np.asarray(img), st)
    tags = read_png_metadata(path)
    assert tags["WURBLPT/SAMPLES_PER_PIXEL"] == "4"
    assert tags["WURBLPT/MAX_PATH_COMPONENTS"] == "3"
    assert tags["WURBLPT/TOTAL_CASTS"] == "12345"
    assert float(tags["WURBLPT/WALL_SECONDS"]) > 0
    assert float(tags["WURBLPT/MRAYS_PER_S"]) > 0
    assert tags["WURBLPT/SCENE"] == "cornell"
    assert os.path.exists(str(tmp_path / "out.json"))


def test_motion_blur_wavefront_reports_real_stats():
    """The wavefront's t0!=t1 fallback must report REAL cast counters, not
    zeros (round-2 weak item 7: a motion-blur bench would have divided by
    zero rays)."""
    from wurblpt_tpu import render_frame_wavefront
    from wurblpt_tpu.core.transform import Transformation, from_lookat
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene.builder import AnimationKeyframes
    from wurblpt_tpu.scene.generator import generate_quad

    sc = B.Scene()
    anim = AnimationKeyframes(
        times=[0.0, 1.0],
        transformations=[Transformation.make(translation=(0, 0, 0)),
                         Transformation.make(translation=(0.5, 0, 0))])
    aid = sc.take_animation(anim)
    sc.take_mesh_instance(B.MeshInstance(
        mesh=generate_quad(1.0, 1.0),
        material=B.Lambertian(albedo=(0.6,) * 3), animation=aid))
    sc.take_sphere(B.SphereObject((0, 0, 4), 0.3,
                                  B.LightDiffuse(radiance=(9.0,) * 3)),
                   hot_spot=True)
    scene = sc.build(t0=0.0, t1=1.0)
    static = SceneStatic.from_scene(scene)
    cam = make_camera(transformation=None, vfov_deg=50.0, width=12, height=12)
    from wurblpt_tpu.core.transform import from_lookat as _fl
    cam = make_camera(transformation=_fl((0, 0, 2.5), (0, 0, 0)),
                      vfov_deg=50.0, width=12, height=12)
    img, stats = render_frame_wavefront(
        scene, static, cam, CameraConfig(), SensorRGB(), 12, 12, 2,
        t0=0.0, t1=1.0, params=RenderParams(max_path_components=3),
        return_stats=True)
    s = np.asarray(stats)
    assert s[0] > 12 * 12 * 4  # at least one closest cast per path
    assert s[1] >= s[0]
