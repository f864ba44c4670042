"""Stage-lights showcase (reference app: wurblpt-stagelights.cpp:30-204).

Composes the subsystems the reference app stresses together: a closed room,
four colored SPOT lights, a ModPhong torus, a participating medium behind a
refractive glass boundary, a glass sphere with a procedural bumpy NORMAL MAP,
and an anisotropic GGX icosahedron.

The reference's BumpyNormalMap evaluates gradient noise per shading point
(wurblpt-stagelights.cpp:59-85); here the height field is baked once into a
normal-map image on the host (finite differences -> tangent-space normals),
so a hit pays one image gather instead of four noise evaluations.
"""

import numpy as np

from _common import default_parser, render, save_png, setup_platform


def bumpy_normal_map(size: int = 256, base: int = 16, scale: float = 1.0,
                     seed: int = 31415926):
    """Tangent-space normal map from smooth value noise (host-side bake)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((base, base)).astype(np.float32)
    # bilinear upsample with wrap, like TextureGradientNoise's smooth field
    ys = np.linspace(0, base, size, endpoint=False)
    xs = np.linspace(0, base, size, endpoint=False)
    y0 = np.floor(ys).astype(int) % base
    x0 = np.floor(xs).astype(int) % base
    fy = (ys - np.floor(ys))[:, None]
    fx = (xs - np.floor(xs))[None, :]
    sy = fy * fy * (3 - 2 * fy)
    sx = fx * fx * (3 - 2 * fx)
    c00 = coarse[np.ix_(y0, x0)]
    c01 = coarse[np.ix_(y0, (x0 + 1) % base)]
    c10 = coarse[np.ix_((y0 + 1) % base, x0)]
    c11 = coarse[np.ix_((y0 + 1) % base, (x0 + 1) % base)]
    h = (c00 * (1 - sx) + c01 * sx) * (1 - sy) + (c10 * (1 - sx) + c11 * sx) * sy
    dhx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    dhy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    n = np.stack([-scale * dhx, -scale * dhy, np.full_like(h, 2.0 / size * base)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n + 1.0) * 0.5).astype(np.float32)


def main():
    p = default_parser("stagelights", width=480, height=270, ssqrt=5, depth=8)
    args = p.parse_args()
    setup_platform(args)

    from wurblpt_tpu import CameraConfig, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import Transformation, quat_from_axis_angle
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene import generator as G

    scene = B.Scene()
    white = scene.take_material(B.Lambertian(albedo=(0.8, 0.8, 0.8)))

    def wall(translate, axis, deg):
        tf = B.Transformation.make(
            translation=translate,
            rotation=quat_from_axis_angle(np.asarray(axis, np.float32),
                                          np.deg2rad(deg)),
            scale=(5.0, 5.0, 5.0))
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0),
                                                white, tf))

    # Room (wurblpt-stagelights.cpp:92-121): quads face inward.
    wall((-2.6, 0.0, 0.0), (0, 1, 0), +90)
    wall((+2.6, 0.0, 0.0), (0, 1, 0), -90)
    wall((0.0, 0.0, +5.0), (0, 1, 0), 180)
    wall((0.0, 0.0, -4.6), (0, 1, 0), 0)
    wall((0.0, -2.499, 0.0), (1, 0, 0), +90)
    wall((0.0, -5.0, 0.0), (1, 0, 0), -90)

    # Stage objects (:123-151)
    modphong = B.ModPhong(diffuse=(0.5, 0.5, 0.5), specular=(0.5, 0.5, 0.5),
                          shininess=120.0)
    tra0 = Transformation.make(
        translation=(-1.5, -4.7, -4.0),
        rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(30.0)),
        scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(
        G.generate_torus(1.0, 0.4, 64, 48), modphong, tra0))

    # Fog inside a refractive octahedron boundary
    tra1 = Transformation.make(
        translation=(-0.5, -4.7, -4.0),
        rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(160.0)),
        scale=(0.3,) * 3)
    glass_shell = B.Glass(ior=1.5)
    scene.take_mesh_instance(B.MeshInstance(G.generate_octahedron(),
                                            glass_shell, tra1))
    scene.take_medium(B.MediumObject(
        boundary=B.MeshInstance(G.generate_octahedron(), 0, tra1),
        density=2.5, phase=B.PhaseIso(albedo=(1.0, 1.0, 1.0))))

    # Glass sphere with the procedural bumpy normal map
    nmap = B.ImageTexture(image=bumpy_normal_map(), srgb=False)
    bumpy_glass = B.Glass(ior=1.5, normal_map=nmap)
    scene.take_sphere(B.SphereObject((0.5, -4.7, -4.0), 0.3, bumpy_glass))

    # Anisotropic GGX icosahedron
    ggx = B.GGX(albedo=(1.0, 1.0, 1.0), roughness=(0.01, 0.1))
    tra3 = Transformation.make(translation=(1.5, -4.7, -4.0), scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_icosahedron(), ggx, tra3))

    # Four colored spot lights above the stage (:154-173)
    colors = [(73.0, 118.0, 139.0), (243.0, 108.0, 100.0),
              (191.0, 197.0, 85.0), (165.0, 69.0, 179.0)]
    lrot = quat_from_axis_angle((1, 0, 0), np.deg2rad(90.0))
    for i, col in enumerate(colors):
        lm = scene.take_material(B.LightSpot(radiance=col,
                                             half_angle=np.deg2rad(20.0)))
        lt = Transformation.make(translation=(-1.5 + i, -2.5, -4.0),
                                 rotation=lrot, scale=(0.3,) * 3)
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0), lm, lt),
                                 hot_spot=True)

    built = scene.build()
    cam = make_camera(
        transformation=Transformation.make(translation=(0.0, -4.5, -1.2)),
        vfov_deg=50.0, width=args.width, height=args.height)
    img = render(built, cam, CameraConfig(), SensorRGB(), args)
    save_png(args.output, img)


if __name__ == "__main__":
    main()
