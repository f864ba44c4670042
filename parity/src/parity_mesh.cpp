/* Parity driver: renders the bvh_100k benchmark scene with the REFERENCE
 * implementation (headers from /root/reference via parity/include, TGD shim
 * in parity/tgd). The scene geometry is the exact terrain_city(seed=3) mesh
 * exported by tools/make_parity_mesh.py (102k tris, Lambertian terrain and
 * buildings, specular spheres -> ModPhong via the reference's MTL heuristics,
 * import.hpp:288-387) lit by the same procedural sky as an equirect envmap
 * with importance sampling (32x32 grid, matching the JAX scene).
 *
 * Purpose: a measured reference-CPU paths/s for a mesh-scale BVH scene so
 * BASELINE.json's mesh row has a denominator (VERDICT round-3 Missing #1).
 * Camera, resolution, spp and path depth match bench.py bench_bvh_large:
 * lookat (14,9,14)->(0,0.5,0), vfov 45, 160x120, ssqrt 2, maxPathComponents 4.
 *
 * Usage: parity_mesh <scene.obj> <sky.tgdshim> <width> <height> <ssqrt> <out>
 */

#define TINYOBJLOADER_IMPLEMENTATION

#include <cstdio>
#include <cstdlib>
#include <chrono>

#include <tgd/array.hpp>
#include <tgd/io.hpp>
#include <wurblpt/wurblpt.hpp>
#include <wurblpt/import.hpp>

using namespace WurblPT;

int main(int argc, char** argv)
{
    if (argc != 7) {
        fprintf(stderr, "usage: %s <scene.obj> <sky.tgdshim> <w> <h> <ssqrt> <out>\n",
                argv[0]);
        return 1;
    }
    const char* objPath = argv[1];
    const char* skyPath = argv[2];
    unsigned int width = atoi(argv[3]);
    unsigned int height = atoi(argv[4]);
    int samples_sqrt = atoi(argv[5]);
    const char* out = argv[6];

    Scene scene;
    if (!importIntoScene(scene, objPath)) {
        fprintf(stderr, "import failed\n");
        return 1;
    }

    TGD::ArrayContainer sky = TGD::load(skyPath);
    Texture* tex = scene.take(createTextureImage(sky));
    EnvironmentMapEquiRect* env = new EnvironmentMapEquiRect(tex);
    env->initializeImportanceSampling(32);
    scene.take(env);

    SensorRGB sensor(width, height);
    Optics optics(Projection(radians(45.0f), sensor.aspectRatio()));
    Camera camera(optics, Transformation::fromLookAt(
            vec3(14.0f, 9.0f, 14.0f), vec3(0.0f, 0.5f, 0.0f),
            vec3(0.0f, 1.0f, 0.0f)));

    Parameters params;
    params.maxPathComponents = 4;
    float t0 = 0.0f, t1 = 0.0f;

    auto b0 = std::chrono::steady_clock::now();
    scene.updateBVH(t0, t1);
    auto b1 = std::chrono::steady_clock::now();

    auto w0 = std::chrono::steady_clock::now();
    mcpt(sensor, camera, scene, samples_sqrt, t0, t1, params);
    auto w1 = std::chrono::steady_clock::now();
    double wall = std::chrono::duration<double>(w1 - w0).count();
    double bvh_s = std::chrono::duration<double>(b1 - b0).count();

    TGD::Array<float> img = sensor.result();
    img.globalTagList().set("WALL_SECONDS", std::to_string(wall));
    TGD::save(img, out);
    long paths = (long)width * height * samples_sqrt * samples_sqrt;
    fprintf(stdout,
            "{\"paths\": %ld, \"wall_s\": %.4f, \"paths_per_s\": %.1f, \"bvh_build_s\": %.3f}\n",
            paths, wall, paths / wall, bvh_s);
    return 0;
}
