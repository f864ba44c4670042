"""Multi-chip / multi-host rendering: rays sharded over a device mesh.

Replaces the reference's MPI master/worker block scheduler (``libwurblpt/
mpi.hpp:36-289``) with the idiomatic JAX recipe (SURVEY.md section 2.2): one
global `Mesh` with a "rays" axis, the frame's pixel rows split across it
(`row_bands`, a `shard_map`), the scene pytree replicated in every device's
memory, and JAX inserting the collectives (the gradient psum from the
shard_map's transpose, the framebuffer gather on fetch) — no hand-written
transport. Reproducibility across chip counts is free because the RNG is
counter-based per (pixel, sample): a pixel's radiance does not depend on which
chip computed it (unlike the reference's sequential per-pixel PRNG streams,
which are order-dependent but pinned per pixel — both designs give
chip-count-invariant images; ours also gives order invariance).

Dynamic load balancing: the reference pulls 4096-pixel blocks from a queue
(mpi.hpp:166-178). Here every device gets an equal contiguous slice of the
(pixel x sample) ray space; variance in path depth is averaged out because
each device holds tens of thousands of lanes that retire independently
inside the masked wavefront loop, and persistent-lane regeneration keeps
iteration counts close. Whether the bands of a real frame stay balanced on
GPUs (a band of sky finishes early) is not yet measured (ROADMAP S7).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render.bsdf import SceneStatic
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import RenderParams, render_frame


def make_ray_mesh(devices=None, axis: str = "rays") -> Mesh:
    """1-D device mesh over all (local or global) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def ray_batch_sizes(hlo_text: str) -> set:
    """Leading sizes of the [n, 3] f32 arrays in a compiled program's HLO
    text: its ray batches (positions, directions, throughputs). On a mesh the
    text is one device's partition, so a partitioned program shows n / n_dev
    where a replicated one shows n."""
    import re

    return {int(n) for n in re.findall(r"f32\[(\d+),3\]", hlo_text)}


def row_bands(render, mesh: Mesh, height: int):
    """`render(*args, row_window=...)` split by frame rows over the mesh's
    first axis: device i renders rows [i * n_rows, (i + 1) * n_rows),
    n_rows = ceil(height / n_dev), from replicated arguments, and the result
    is row-sharded with n_dev * n_rows rows (rows past the frame are zero).

    The split is explicit (`shard_map`): GSPMD, left to propagate a sharding
    from an output constraint, does not partition the wavefront's while-loop
    lanes and kept a full pass of rays per card in the GPU's training step.
    Pixel and sample ids stay global, so the bands assemble into the
    single-device frame. Differentiable: the transpose sums the replicated
    arguments' cotangents over the devices (the gradient psum)."""
    axis = mesh.axis_names[0]
    n_rows = -(-height // mesh.devices.size)

    def band(*args):
        row0 = jax.lax.axis_index(axis) * n_rows
        return render(*args, row_window=(row0, n_rows))

    return jax.shard_map(band, mesh=mesh, in_specs=P(), out_specs=P(axis),
                         check_vma=False)


@lru_cache(maxsize=16)
def _frame_bands(render, static, cam_cfg, sensor, width, height, samples_sqrt,
                 mesh, t0, t1, params, **kw):
    """Cached jitted (scene, cam) -> row-sharded frame of `render`
    (`render_frame` or `render_frame_wavefront`), keyed on the static
    configuration so repeated frames reuse one compiled program."""
    def frame(scene_in, cam_in, row_window):
        return render(scene_in, static, cam_in, cam_cfg, sensor, width, height,
                      samples_sqrt, t0, t1, params, row_window=row_window, **kw)

    return jax.jit(row_bands(frame, mesh, height),
                   in_shardings=NamedSharding(mesh, P()))


def render_frame_sharded(
    scene,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    mesh: Optional[Mesh] = None,
    t0: float = 0.0,
    t1: float = 0.0,
    params: RenderParams = RenderParams(),
    samples_per_pass: int = 1,
):
    """`render_frame` (the pass renderer) with frame rows split over the
    mesh's "rays" axis (`row_bands`).

    The scene is replicated; the framebuffer is produced row-sharded and
    gathered implicitly on host fetch. Heights not divisible by the mesh size
    leave the last band short (its rows past the frame are sliced off) — the
    analog of the reference's final partial MPI block (mpi.hpp:226-232).
    """
    if mesh is None:
        mesh = make_ray_mesh()
    fn = _frame_bands(render_frame, static, cam_cfg, sensor, width, height,
                      samples_sqrt, mesh, float(t0), float(t1), params,
                      samples_per_pass=samples_per_pass)
    img = fn(scene, cam)
    return img[:height] if img.shape[0] != height else img


def render_frame_wavefront_sharded(
    scene,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    mesh: Optional[Mesh] = None,
    t0: float = 0.0,
    t1: float = 0.0,
    params: RenderParams = RenderParams(),
    max_lanes: int = 131072,
):
    """The PRODUCTION inference path on a mesh: the persistent-lane
    wavefront, each device rendering its own band of frame rows
    (`row_bands`; scene replicated, framebuffer row-sharded over the "rays"
    axis). The image equals the single-device wavefront up to the order in
    which a pixel's sample lanes are summed (verified in
    tests/test_sharding.py). Motion-blurred frames go through the pass
    renderer's row window, as the single-device wavefront hands them over.
    """
    if mesh is None:
        mesh = make_ray_mesh()
    from ..render.integrator import render_frame_wavefront

    fn = _frame_bands(render_frame_wavefront, static, cam_cfg, sensor, width,
                      height, samples_sqrt, mesh, float(t0), float(t1), params,
                      max_lanes=max_lanes)
    img = fn(scene, cam)
    return img[:height] if img.shape[0] != height else img


def training_step(
    scene,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    target,
    params0=None,
    apply_params=None,
    apply_cam=None,
    optimizer=None,
    mesh: Optional[Mesh] = None,
    params: RenderParams = RenderParams(),
    sample_start=0,
):
    """One step of THE production inverse-rendering optimizer on a mesh.

    This is `inverse.make_train_step` — the same optax-driven unit
    `inverse.fit` iterates single-device — compiled with the framebuffer (and
    with it the whole differentiable renderer) split by rows over the mesh's
    ray axis (`row_bands`); scene/params replicated; the parameter gradients
    are summed across the row bands (the psum of SURVEY.md section 2.2
    "result reduction"). Each device traces 1/n of the rays
    (tests/test_sharding.py checks the compiled lane count, `chip_smoke.py
    --four` on the cards). The multi-chip dryrun compiles exactly this step.

    params0/apply_params default to fitting the material color tables
    (albedo + emissive), the most common recovery target; pass any pytree +
    patcher for arbitrary scene/texture/camera fitting, exactly as with
    `inverse.fit`.

    Returns (loss, fitted_params, opt_state).
    """
    from ..inverse import make_train_step

    if mesh is None:
        mesh = make_ray_mesh()
    if params0 is None:
        params0 = {"albedo": scene.materials.albedo,
                   "emissive": scene.materials.emissive}

        def apply_params(s, p):  # noqa: F811 - default patcher pairs params0
            return s._replace(materials=s.materials._replace(
                albedo=p["albedo"], emissive=p["emissive"]))
    assert apply_params is not None, "params0 without apply_params"

    step_fn, optimizer = make_train_step(
        scene, apply_params, target,
        cam=cam, cam_cfg=cam_cfg, sensor=sensor, width=width, height=height,
        samples_sqrt=samples_sqrt, render_params=params, optimizer=optimizer,
        apply_cam=apply_cam, mesh=mesh, static=static,
    )
    opt_state = optimizer.init(params0)
    new_params, opt_state, loss, _img = step_fn(
        params0, opt_state, jnp.int32(sample_start))
    return loss, new_params, opt_state
