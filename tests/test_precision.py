"""Every matrix product in the render programs is pinned to full f32.

A `dot_general` without an explicit precision may run in TF32 on a GPU's
tensor cores (about three decimal digits), which moves ray origins, light
vertices and normals where a CPU run does not. These tests walk the jaxpr of
each render program, sub-jaxprs of loops, conditionals, remat and custom
derivative rules included, and fail on any `dot_general` whose precision is
not HIGHEST on both operands.
"""

import jax
import jax.numpy as jnp
import pytest

from wurblpt_tpu import (CameraConfig, RenderParams, SceneStatic, SensorRGB,
                         make_camera)
from wurblpt_tpu.core.transform import (Transformation, from_lookat,
                                        quat_from_axis_angle)
from wurblpt_tpu.render.integrator import render_frame, render_frame_wavefront
from wurblpt_tpu.scene.builder import (AnimationKeyframes, Lambertian,
                                       LightDiffuse, MeshInstance, Scene)
from wurblpt_tpu.scene.generator import generate_quad
from wurblpt_tpu.utils import scenes

_HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    """Jaxprs nested in an equation parameter (ClosedJaxpr, Jaxpr, tuples)."""
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _where(eqn):
    """The package's innermost source line that emitted `eqn`."""
    tb = eqn.source_info.traceback
    for frame in (tb.frames if tb is not None else []):
        if "wurblpt_tpu" in frame.file_name:
            return f"{frame.file_name}:{frame.line_num}"
    return "?"


def unpinned_dots(jaxpr):
    """(count of dot_generals, list of those not at HIGHEST precision)."""
    n, bad = 0, []
    stack = [jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr]
    while stack:
        jx = stack.pop()
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                n += 1
                prec = eqn.params.get("precision")
                if not (isinstance(prec, tuple)
                        and all(p == _HIGHEST for p in prec)):
                    bad.append((_where(eqn), prec,
                                [v.aval.shape for v in eqn.invars]))
            for v in eqn.params.values():
                stack.extend(_sub_jaxprs(v))
    return n, bad


def _cam(w, h, pose=None, vfov=40.0):
    return make_camera(transformation=pose, vfov_deg=vfov, width=w, height=h)


def _cornell():
    scene = scenes.cornell_box_ref().build()
    pose, vfov = scenes.cornell_ref_camera()
    return scene, _cam(8, 8, pose, vfov)


def _lamp_scene(n_lamps, use_bvh):
    """Floor plus `n_lamps` small emissive quads that slide over t in [0, 1]:
    animated geometry (animation.py) and animated light frames (lights.py)."""
    rot = quat_from_axis_angle((1.0, 0.0, 0.0), jnp.pi / 2)
    sc = Scene()
    sc.take_mesh_instance(MeshInstance(
        mesh=generate_quad(2.0, 2.0), material=Lambertian(albedo=(0.8,) * 3),
        transformation=Transformation.make(rotation=-rot)))
    for i in range(n_lamps):
        x = -1.0 + 2.0 * i / max(n_lamps - 1, 1)
        aid = sc.take_animation(AnimationKeyframes(
            times=[0.0, 1.0],
            transformations=[
                Transformation.make(translation=(x, 1.5, -0.5), rotation=rot),
                Transformation.make(translation=(x, 1.5, 0.5), rotation=rot)]))
        sc.take_mesh_instance(MeshInstance(
            mesh=generate_quad(0.2, 0.2),
            material=LightDiffuse(radiance=(20.0,) * 3), animation=aid),
            hot_spot=True)
    scene = sc.build(use_bvh=use_bvh, t0=0.0, t1=1.0)
    return scene, _cam(8, 8, from_lookat((0, 2.5, 3.5), (0, 0, 0)))


def _wavefront_cornell():
    scene, cam = _cornell()
    static = SceneStatic.from_scene(scene)
    return (lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), SensorRGB(), 8, 8, 2,
        params=RenderParams(max_path_components=4))), (scene, cam)


def _animated_motion_blur():
    scene, cam = _lamp_scene(1, use_bvh=False)
    static = SceneStatic.from_scene(scene)
    return (lambda s, c: render_frame(
        s, static, c, CameraConfig(), SensorRGB(), 8, 8, 2, 0.0, 1.0,
        params=RenderParams(max_path_components=4))), (scene, cam)


def _many_lights_bvh():
    scene, cam = _lamp_scene(12, use_bvh=True)
    static = SceneStatic.from_scene(scene)
    assert scene.bvh is not None and scene.light_prims.shape[0] >= 12
    return (lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), SensorRGB(), 8, 8, 2, 0.5, 0.5,
        params=RenderParams(max_path_components=4))), (scene, cam)


def _differentiable_render_frame():
    scene, cam = _cornell()
    static = SceneStatic.from_scene(scene)
    params = RenderParams(max_path_components=3, differentiable=True)

    def loss(albedo, s, c):
        s = s._replace(materials=s.materials._replace(albedo=albedo))
        return jnp.mean(render_frame(s, static, c, CameraConfig(), SensorRGB(),
                                     8, 8, 1, params=params))

    return (lambda s, c: jax.grad(loss)(s.materials.albedo, s, c)), (scene, cam)


@pytest.mark.parametrize("program", [
    _wavefront_cornell, _animated_motion_blur, _many_lights_bvh,
    _differentiable_render_frame,
])
def test_render_program_has_no_unpinned_dot(program):
    fn, args = program()
    n, bad = unpinned_dots(jax.make_jaxpr(fn)(*args))
    assert not bad, f"{len(bad)} of {n} dot_generals not at HIGHEST: {bad[:5]}"


def test_walker_flags_default_precision_einsum():
    """The walker itself: an einsum left at the default precision inside a
    while-loop body is found, and a HIGHEST one is not."""
    m = jnp.ones((4, 3, 3))
    v = jnp.ones((4, 3))

    def prog(prec):
        body = lambda x: jnp.einsum("nij,nj->ni", m, x, precision=prec)
        return jax.make_jaxpr(
            lambda x: jax.lax.while_loop(lambda y: y[0, 0] < 10.0, body, x))(v)

    n, bad = unpinned_dots(prog(None))
    assert n == 1 and len(bad) == 1
    assert unpinned_dots(prog(_HIGHEST)) == (1, [])
