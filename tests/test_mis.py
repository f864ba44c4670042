"""MIS variance assertion: the Veach-style plate scene must render with LOWER
error under NEE+MIS than under BSDF-only sampling.

The reference only compares the two visually (wurblpt-mis-test.cpp:109-144);
here K independent 1-spp estimates are rendered per strategy (the counter-based
RNG makes pass i reproducible and independent of pass j) and the K-pass
average's error against an independent higher-spp reference must strictly
favor MIS.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
from wurblpt_tpu.render.integrator import accumulate_passes
from wurblpt_tpu.utils import scenes


@partial(jax.jit, static_argnames=("static", "width", "height", "depth"))
def _all_passes(scene, cam, ps, static, width, height, depth=3):
    """Independent 1-spp estimates in ONE program execution (vmapped over the
    pass index; the counter-based RNG makes each pass an independent,
    reproducible sample set). A single execution per program variant also
    dodges a jax-0.9.0 dispatch-fastpath fault where the SECOND execution of
    a second distinct program in one process dispatches a stale executable
    ("Execution supplied 31 buffers but compiled program expected 33"; see
    tests/conftest.py)."""
    def one(p):
        # samples_sqrt 8: pass p draws sample id p of a 64-sample grid.
        return accumulate_passes(
            scene, static, cam, CameraConfig(), SensorRGB(), width, height, 8,
            0.0, 0.0, RenderParams(max_path_components=depth), 1,
            jnp.zeros((width * height, 3)), p, 1,
        )
    return jax.vmap(one)(ps)


def _setup(scene, width, height, nee):
    static = SceneStatic.from_scene(scene)
    if not nee:
        # BSDF-only sampling: zero the static light count so the compiled
        # kernel drops every NEE/MIS branch (the scene arrays stay identical
        # — exactly the reference's material-only comparison mode).
        static = static._replace(n_lights=0)
    pose, vfov = scenes.mis_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov,
                      width=width, height=height)
    return static, cam


def test_mis_reduces_error_on_veach_plates():
    width = height = 48
    k = 16
    scene = scenes.mis_test(use_ggx=False).build()

    # Direct lighting only (depth 2): the cleanest MIS-vs-BSDF separation —
    # small bright lights make chance BSDF hits astronomically rare while
    # NEE+MIS resolves them smoothly.
    static_mis, cam = _setup(scene, width, height, nee=True)
    static_mat, _ = _setup(scene, width, height, nee=False)
    ref = np.asarray(_all_passes(
        scene, cam, jnp.arange(k, 64, dtype=jnp.int32),
        static=static_mis, width=width, height=height, depth=2)).mean(0)

    ps = jnp.arange(k, dtype=jnp.int32)
    est_mis = np.asarray(_all_passes(
        scene, cam, ps, static=static_mis, width=width, height=height,
        depth=2))
    est_mat = np.asarray(_all_passes(
        scene, cam, ps, static=static_mat, width=width, height=height,
        depth=2))

    # Mask out direct views of the lights: at 1 spp those pixels are pure
    # light-silhouette aliasing noise IDENTICAL under both strategies (the
    # camera ray either hits the 187-radiance disk or not) and would swamp
    # the surface-shading comparison MIS is about.
    lum = ref.sum(-1)
    mask = (lum > 0.002) & (lum < 1.0)
    assert mask.sum() > 500

    mae_mis = np.abs(est_mis.mean(0) - ref).sum(-1)[mask].mean()
    mae_mat = np.abs(est_mat.mean(0) - ref).sum(-1)[mask].mean()
    # The power heuristic must win decisively on direct lighting of this
    # scene (its textbook case; measured ratio ~3.2x).
    assert mae_mis < 0.5 * mae_mat, \
        f"MAE(MIS)={mae_mis:.4f} MAE(BSDF)={mae_mat:.4f}"

    # Both estimators target the same integral: aggregate means must agree
    # within Monte-Carlo error.
    tot_mis = est_mis.mean(0)[mask.reshape(-1)].mean()
    tot_mat = est_mat.mean(0)[mask.reshape(-1)].mean()
    assert abs(tot_mis - tot_mat) / (tot_mis + 1e-6) < 0.5, \
        f"estimator means diverge: {tot_mis:.4f} vs {tot_mat:.4f}"
