"""Inverse rendering: optimize scene/camera parameters against image targets.

The reference has no autodiff at all; this module is this framework's
flagship differentiable-rendering entry point. The design is parameter-pytree
-based and optimizer-agnostic:

* `render_loss(...)` builds a differentiable scalar loss for any render
  configuration (the bounce loop runs in fixed-trip rematerialized mode,
  integrator.RenderParams(differentiable=True)).
* `fit(...)` runs an optax optimizer over an arbitrary params pytree; the
  caller says how params patch into the scene via `apply_params` — e.g. a
  texture image, a material roughness column, envmap texels, or the camera
  pose. Gradients flow through the attached-pdf estimator validated by
  tests/test_gradients.py.

Typical use (examples/inverse_rendering.py):

    params0 = {"albedo_img": jnp.full((16, 16, 4), 0.5)}
    def apply_params(scene, p):
        img_data = scene.textures.img_data.at[tex_id].set(p["albedo_img"])
        return scene._replace(textures=scene.textures._replace(img_data=img_data))
    result = fit(scene, params0, apply_params, target, render_kwargs, steps=60)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

from .render.bsdf import SceneStatic
from .render.camera import CameraConfig, CameraParams
from .render.integrator import RenderParams, render_frame
from .render.sensor import SensorRGB


@dataclass
class FitResult:
    params: Any
    losses: list
    final_image: Any


def make_train_step(
    scene,
    apply_params: Callable[[Any, Any], Any],
    target,
    *,
    cam: CameraParams,
    cam_cfg: CameraConfig = CameraConfig(),
    sensor=SensorRGB(),
    width: int,
    height: int,
    samples_sqrt: int = 2,
    render_params: RenderParams = RenderParams(max_path_components=4),
    optimizer=None,
    loss_fn: Optional[Callable] = None,
    apply_cam: Optional[Callable[[CameraParams, Any], CameraParams]] = None,
    mesh=None,
    static: Optional[SceneStatic] = None,
):
    """Build THE production training step: a jitted
    ``step(params, opt_state, sample_start) -> (params, opt_state, loss, img)``
    over an arbitrary optax-optimizable params pytree.

    This one function is the training loop's unit everywhere: `fit` drives it
    single-device; with `mesh` the differentiable renderer is split by frame
    rows over the mesh's first axis (`parallel.sharding.row_bands`) while
    params/scene stay replicated — the parameter gradients are summed across
    the row bands (the psum of SURVEY.md section 2.2 "result reduction"), and
    `parallel.sharding.training_step` + the multi-chip dryrun compile exactly
    this step.

    Returns (step_fn, optimizer) — init opt_state with
    ``optimizer.init(params0)``.
    """
    import dataclasses

    import optax

    if optimizer is None:
        optimizer = optax.adam(2e-2)
    if loss_fn is None:
        loss_fn = lambda img, tgt: jnp.mean((img - tgt) ** 2)
    if static is None:
        static = SceneStatic.from_scene(scene)

    diff_params = dataclasses.replace(render_params, differentiable=True)
    spp = samples_sqrt * samples_sqrt

    def render(s, c, sample_start, row_window=None):
        from .render.integrator import accumulate_passes

        n_rows = height if row_window is None else row_window[1]
        acc = accumulate_passes(
            s, static, c, cam_cfg, sensor, width, height, 8,
            0.0, 0.0, diff_params, 1,
            jnp.zeros((width * n_rows, sensor.n_acc)),
            0, spp, sample_offset=sample_start, row_window=row_window,
        )
        return sensor.finish(acc, 1.0 / spp).reshape(n_rows, width, sensor.n_acc)

    shardings = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel.sharding import row_bands

        assert height % mesh.devices.size == 0, (
            f"height {height} not divisible by mesh size {mesh.devices.size}")
        render = row_bands(render, mesh, height)
        shardings = (NamedSharding(mesh, P()),
                     NamedSharding(mesh, P(mesh.axis_names[0], None, None)))

    def objective(params, sample_start):
        s = apply_params(scene, params)
        c = apply_cam(cam, params) if apply_cam is not None else cam
        img = render(s, c, sample_start)
        return loss_fn(img, target), img

    def step(params, opt_state, sample_start):
        (loss, img), grads = jax.value_and_grad(objective, has_aux=True)(
            params, sample_start)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, img

    if shardings is None:
        step_fn = jax.jit(step)
    else:
        rep, shard_img = shardings
        step_fn = jax.jit(
            step,
            in_shardings=(rep, rep, rep),
            out_shardings=(rep, rep, rep, shard_img),
        )
    return step_fn, optimizer


def fit(
    scene,
    params0,
    apply_params: Callable[[Any, Any], Any],
    target,
    *,
    cam: CameraParams,
    cam_cfg: CameraConfig = CameraConfig(),
    sensor=SensorRGB(),
    width: int,
    height: int,
    samples_sqrt: int = 2,
    render_params: RenderParams = RenderParams(max_path_components=4),
    optimizer=None,
    steps: int = 50,
    loss_fn: Optional[Callable] = None,
    apply_cam: Optional[Callable[[CameraParams, Any], CameraParams]] = None,
    post_step: Optional[Callable[[Any], Any]] = None,
    sample_offset_per_step: bool = True,
    verbose: bool = False,
) -> FitResult:
    """Optimize `params0` so the rendered image matches `target`.

    apply_params(scene, params) -> scene patched with the current params.
    apply_cam(cam, params) -> camera patched (optional, for pose fitting).
    post_step(params) -> params, applied after each update (e.g. clipping to
    valid ranges). `sample_offset_per_step` re-randomizes the stratified
    sample id each step (stochastic gradient over the sample space) by
    rotating which sample of an (8x8) grid is drawn — cheap decorrelation.

    Returns FitResult(params, losses, final_image).
    """
    spp = samples_sqrt * samples_sqrt
    # Stratification grid: 8x8 = 64 sample slots; each step draws a
    # non-overlapping window of `spp` of them (counter-based RNG => each
    # window is an independent, reproducible sample set).
    n_windows = max(64 // spp, 1)

    step_fn, optimizer = make_train_step(
        scene, apply_params, target,
        cam=cam, cam_cfg=cam_cfg, sensor=sensor, width=width, height=height,
        samples_sqrt=samples_sqrt, render_params=render_params,
        optimizer=optimizer, loss_fn=loss_fn, apply_cam=apply_cam,
    )
    opt_state = optimizer.init(params0)
    params = params0
    losses = []
    img = None

    for step in range(steps):
        win = (step % n_windows) if sample_offset_per_step else 0
        salt = jnp.int32(win * spp)
        params, opt_state, loss, img = step_fn(params, opt_state, salt)
        if post_step is not None:
            params = post_step(params)
        losses.append(float(loss))
        if verbose and (step % 10 == 0 or step == steps - 1):
            print(f"step {step:4d}  loss {float(loss):.6f}")
    return FitResult(params=params, losses=losses, final_image=img)
