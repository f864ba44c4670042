"""wurblpt_tpu: a differentiable path tracer in JAX.

A JAX/XLA framework with the capabilities of the WurblPT
reference renderer (see SURVEY.md): wavefront Monte-Carlo path integration with
NEE/MIS, BVH-accelerated triangle/sphere/medium intersection,
Lambertian/GGX/glass/ModPhong/RGL materials, parameterization-independent
environment-map importance sampling, OpenCV camera intrinsics + lens
distortion, 360/180 surround and stereo rendering, light-in-flight and AMCW
Time-of-Flight sensor simulation, ground-truth AOVs, animation, and OBJ/MTL
import/export — differentiable end-to-end and sharded over device meshes.
"""

from .core import color, constants, fresnel, onb, rng, sampler, transform, vecmath  # noqa: F401
from .core.transform import Transformation  # noqa: F401
from .render.bsdf import SceneStatic  # noqa: F401
from .render.camera import (  # noqa: F401
    CameraConfig,
    CameraParams,
    DistortionModel,
    SurroundMode,
    camera_rays,
    make_camera,
)
from .render.integrator import (  # noqa: F401
    RenderParams,
    render_frame,
    render_frame_progressive,
    render_frame_wavefront,
    trace_paths,
)
from .render.sensor import SensorRGB, SensorTofAmcw  # noqa: F401
from .scene.builder import (  # noqa: F401
    AnimationKeyframes,
    CheckerTexture,
    ConstantTexture,
    EnvironmentMapConstant,
    EnvironmentMapCube,
    EnvironmentMapEquiRect,
    GGX,
    Glass,
    ImageTexture,
    Lambertian,
    LightDiffuse,
    LightSpot,
    LightTof,
    Material,
    MediumObject,
    Mesh,
    MeshInstance,
    Mirror,
    ModPhong,
    NoiseTexture,
    PhaseIso,
    RGLMaterial,
    Scene,
    SphereObject,
)
from .scene import generator  # noqa: F401
from .io import (  # noqa: F401
    ImportBits,
    export_scene_to_obj,
    import_geometry,
    import_into_scene,
    import_texture,
)

__version__ = "0.1.0"
