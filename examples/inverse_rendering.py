"""Inverse rendering: recover a texture, a roughness, and a light's radiance
from a rendered target image (VERDICT round-2 item 7).

The reference has no differentiable path at all; this is the framework's
flagship capability. Setup: a quad with an UNKNOWN 8x8 albedo texture and a
GGX sphere with UNKNOWN roughness, lit by a sphere light of UNKNOWN radiance.
The target is rendered with the true values; Adam recovers all three jointly
from pixels alone.
"""

import numpy as np

from _common import default_parser, save_png, setup_platform


def build_scene(tex_img, rough, light_rad):
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene import generator as G

    sc = B.Scene()
    tex = B.ImageTexture(image=tex_img, srgb=False, linear_filtering=True)
    sc.take_mesh_instance(B.MeshInstance(
        mesh=G.generate_quad(1.2, 1.2), material=B.Lambertian(albedo=tex)))
    sc.take_sphere(B.SphereObject((0.7, -0.5, 0.8), 0.35,
                                  B.GGX(albedo=(0.9, 0.9, 0.9), roughness=rough)))
    sc.take_sphere(B.SphereObject((0.8, 1.2, 2.4), 0.3,
                                  B.LightDiffuse(radiance=(light_rad,) * 3)),
                   hot_spot=True)
    return sc.build()


def main():
    p = default_parser("inverse_rendering", width=64, height=64, ssqrt=2, depth=3)
    p.add_argument("--steps", type=int, default=120)
    args = p.parse_args()
    setup_platform(args)

    import jax.numpy as jnp
    import optax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.inverse import fit
    from wurblpt_tpu.render.integrator import render_frame

    # Ground truth: checkerboard texture, roughness 0.15, radiance 22
    yy, xx = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    true_tex = np.where(((yy + xx) % 2 == 0)[..., None],
                        np.array([0.8, 0.25, 0.2], np.float32),
                        np.array([0.2, 0.4, 0.8], np.float32))
    true_rough, true_rad = 0.15, 22.0

    cam = make_camera(transformation=from_lookat((0.0, 0.0, 3.2), (0, 0, 0)),
                      vfov_deg=45.0, width=args.width, height=args.height)
    params = RenderParams(max_path_components=args.max_depth)

    target_scene = build_scene(true_tex, true_rough, true_rad)
    static = SceneStatic.from_scene(target_scene)
    target = render_frame(target_scene, static, cam, CameraConfig(), SensorRGB(),
                          args.width, args.height, 4, params=params)
    save_png(args.output.replace(".png", "-target.png"), target)

    # Initial guess: flat gray texture, wrong roughness, wrong radiance.
    scene0 = build_scene(np.full((8, 8, 3), 0.5, np.float32), 0.4, 8.0)
    # locate the texture's slot in the padded image stack + material columns
    tex_id = 0
    light_mat = int(np.asarray(scene0.materials.typ).tolist().index(7))  # LIGHT_DIFFUSE
    ggx_mat = int(np.asarray(scene0.materials.typ).tolist().index(2))    # GGX

    params0 = {
        "tex": jnp.asarray(scene0.textures.img_data[tex_id], jnp.float32),
        "log_rough": jnp.log(jnp.asarray(0.4)),
        "log_rad": jnp.log(jnp.asarray(8.0)),
    }

    def apply_params(scene, p):
        img_data = scene.textures.img_data.at[tex_id].set(
            p["tex"].astype(scene.textures.img_data.dtype))
        rough = jnp.exp(p["log_rough"])
        p0 = scene.materials.p0.at[ggx_mat, 0].set(rough)
        p0 = p0.at[ggx_mat, 1].set(rough)
        emis = scene.materials.emissive.at[light_mat, :3].set(
            jnp.exp(p["log_rad"]))
        return scene._replace(
            textures=scene.textures._replace(img_data=img_data),
            materials=scene.materials._replace(p0=p0, emissive=emis))

    result = fit(
        scene0, params0, apply_params, jnp.asarray(target),
        cam=cam, width=args.width, height=args.height,
        samples_sqrt=args.samples_sqrt, render_params=params,
        optimizer=optax.adam(5e-2), steps=args.steps, verbose=True,
    )

    rough = float(np.exp(result.params["log_rough"]))
    rad = float(np.exp(result.params["log_rad"]))
    tex_err = float(np.abs(np.asarray(result.params["tex"], np.float32)[..., :3]
                           - true_tex).mean())
    print(f"recovered roughness {rough:.3f} (true {true_rough})")
    print(f"recovered radiance  {rad:.2f} (true {true_rad})")
    print(f"texture MAE {tex_err:.4f}")
    print(f"loss {result.losses[0]:.5f} -> {result.losses[-1]:.5f}")
    save_png(args.output, result.final_image)


if __name__ == "__main__":
    main()
