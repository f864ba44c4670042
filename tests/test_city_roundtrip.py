"""city_night composition scene (BASELINE config 5 stand-in): the OBJ/MTL
round trip must preserve geometry scale, emissive hot spots, and the
power-weighted pick tables; RGL + envmap attach after import."""

import numpy as np

from wurblpt_tpu.utils import scenes


def _small(**kw):
    return scenes.city_night(terrain_res=60, n_buildings=24, n_windows=66,
                             sphere_slices=8, **kw)


def test_city_roundtrip_preserves_lights_and_scale():
    direct = _small(obj_roundtrip=False).build(use_bvh=False)
    rt = _small(obj_roundtrip=True).build(use_bvh=False)

    # 66 window quads -> 132 hot-spot triangles either way
    assert direct.n_lights == 132
    assert rt.n_lights == 132
    # geometry survives the round trip (same tris; RGL sphere added after)
    assert rt.n_tris == direct.n_tris
    # power-weighted alias table present and normalized, with real spread
    w = np.asarray(rt.light_weights)
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    assert w.max() / w.min() > 5.0
    # the RGL table and material survive the post-import attach
    assert rt.rgl is not None and int(np.asarray(rt.rgl.n_tables)) >= 1 \
        if hasattr(rt.rgl, "n_tables") else rt.rgl is not None
    assert int(np.asarray(rt.materials.rgl_id).max()) >= 0
    # night-sky envmap with importance tables
    assert int(rt.envmap.kind) == 1
    assert rt.envmap.alias_prob.shape[0] > 0


def test_city_bounds_match_after_roundtrip():
    direct = _small(obj_roundtrip=False).build(use_bvh=False)
    rt = _small(obj_roundtrip=True).build(use_bvh=False)
    for arr_d, arr_r in ((direct.tris.p0, rt.tris.p0),):
        d = np.asarray(arr_d)
        r = np.asarray(arr_r)
        np.testing.assert_allclose(d.min(0), r.min(0), atol=1e-3)
        np.testing.assert_allclose(d.max(0), r.max(0), atol=1e-3)


_BLOCKED_BUILD = """
import sys
sys.modules["PIL"] = None          # any `import PIL...` now raises ImportError
try:
    import PIL  # noqa: F401
    raise SystemExit("PIL was not blocked")
except ImportError:
    pass
import numpy as np
from jax import tree_util
from wurblpt_tpu.utils import scenes
s = scenes.city_night(terrain_res=60, n_buildings=24, n_windows=66,
                      sphere_slices=8).build(use_bvh=False)
leaves = tree_util.tree_leaves_with_path((s.materials, s.textures, s.tris))
np.savez(sys.argv[1], **{tree_util.keystr(k): np.asarray(v) for k, v in leaves})
"""


def test_city_scene_is_the_same_without_pil(tmp_path):
    """The bench's city scene, OBJ round trip included, must not depend on
    whether PIL is importable: build it in a process where PIL is blocked and
    compare the flattened material, texture and triangle arrays."""
    import os
    import subprocess
    import sys

    from jax import tree_util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "blocked.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", _BLOCKED_BUILD, out], env=env,
                   cwd=repo, check=True, timeout=600)
    blocked = np.load(out)
    s = _small().build(use_bvh=False)
    leaves = tree_util.tree_leaves_with_path((s.materials, s.textures, s.tris))
    assert sorted(blocked.files) == sorted(tree_util.keystr(k) for k, _ in leaves)
    for k, v in leaves:
        np.testing.assert_array_equal(blocked[tree_util.keystr(k)],
                                      np.asarray(v), err_msg=tree_util.keystr(k))


def test_textured_export_without_pil_raises(tmp_path, monkeypatch):
    """A texture that needs writing must not be dropped silently when PIL is
    missing: the export raises instead."""
    import sys

    import pytest

    from wurblpt_tpu.io.obj import export_scene_to_obj
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene.generator import generate_quad

    sc = B.Scene()
    sc.take_mesh_instance(B.MeshInstance(
        mesh=generate_quad(1.0, 1.0),
        material=B.Lambertian(albedo=B.ImageTexture(
            image=np.full((4, 4, 3), 0.5, np.float32)))))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        export_scene_to_obj(sc, str(tmp_path / "t.obj"))
