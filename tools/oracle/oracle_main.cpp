// Reference-oracle driver: compiles the UNMODIFIED reference header from
// /root/reference/include against the stub shims in stub_include/ and replays
// a binary frame stream through DSPMap::update, recording per-frame wall time
// and the occupancy/future outputs.  This provides (a) the measured
// single-core baseline BASELINE.md calls for and (b) golden behavioral data
// for stochastic-tolerance parity tests of the JAX build.
//
// Frame stream format (little-endian):
//   header: i32 n_frames, i32 max_points
//   frame:  i32 n_points, f32 pos[3], f32 quat[4] (wxyz), f64 t,
//           f32 points[n_points*3]  (sensor/body frame)
// Output:
//   header: i32 n_frames, i32 voxel_num, i32 horizons, i32 dims[3], f32 res
//   frame:  f64 update_wall_s, i32 n_occ, f32 ego_centers[n_occ*3]
//   tail:   f32 future[voxel_num * horizons]   (after last frame)

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

#ifdef ORACLE_STATIC
#include "dsp_static.h"
#elif defined(ORACLE_MULTI)
#include "dsp_dynamic_multiple_neighbors.h"
#else
#include "dsp_dynamic.h"
#endif

int main(int argc, char **argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s frames.bin out.bin [threshold]\n", argv[0]);
    return 1;
  }
  const float threshold = argc > 3 ? std::atof(argv[3]) : 0.2f;
  std::FILE *fin = std::fopen(argv[1], "rb");
  std::FILE *fout = std::fopen(argv[2], "wb");
  if (!fin || !fout) {
    std::fprintf(stderr, "cannot open files\n");
    return 1;
  }

  int32_t n_frames = 0, max_points = 0;
  std::fread(&n_frames, 4, 1, fin);
  std::fread(&max_points, 4, 1, fin);

  auto *my_map = new DSPMap();
  my_map->setPredictionVariance(0.05f, 0.05f);
  my_map->setObservationStdDev(0.1f);
  my_map->setNewBornParticleNumberofEachPoint(20);
  my_map->setNewBornParticleWeight(0.0001f);
  DSPMap::setOriginalVoxelFilterResolution(0.1f);

  const int32_t voxel_num = VOXEL_NUM;
  const int32_t horizons = PREDICTION_TIMES;
  int32_t dims[3] = {MAP_LENGTH_VOXEL_NUM, MAP_WIDTH_VOXEL_NUM,
                     MAP_HEIGHT_VOXEL_NUM};
  float res = (float)VOXEL_RESOLUTION;
  std::fwrite(&n_frames, 4, 1, fout);
  std::fwrite(&voxel_num, 4, 1, fout);
  std::fwrite(&horizons, 4, 1, fout);
  std::fwrite(dims, 4, 3, fout);
  std::fwrite(&res, 4, 1, fout);

  std::vector<float> points(3 * (size_t)max_points);
  static std::vector<float> future((size_t)voxel_num * horizons);

  for (int f = 0; f < n_frames; ++f) {
    int32_t n_points = 0;
    float pos[3], quat[4];
    double t;
    std::fread(&n_points, 4, 1, fin);
    std::fread(pos, 4, 3, fin);
    std::fread(quat, 4, 4, fin);
    std::fread(&t, 8, 1, fin);
    std::fread(points.data(), 4, (size_t)n_points * 3, fin);

    auto t0 = std::chrono::steady_clock::now();
    my_map->update(n_points, 3, points.data(), pos[0], pos[1], pos[2], t,
                   quat[0], quat[1], quat[2], quat[3]);
    int n_occ = 0;
    pcl::PointCloud<pcl::PointXYZ> cloud;
    my_map->getOccupancyMapWithFutureStatus(n_occ, cloud, future.data(),
                                            threshold);
    auto t1 = std::chrono::steady_clock::now();
    double wall = std::chrono::duration<double>(t1 - t0).count();

    std::fwrite(&wall, 8, 1, fout);
    int32_t n_occ32 = (int32_t)cloud.points.size();
    std::fwrite(&n_occ32, 4, 1, fout);
    for (auto &p : cloud.points) {
      float xyz[3] = {p.x, p.y, p.z};
      std::fwrite(xyz, 4, 3, fout);
    }
  }
  std::fwrite(future.data(), 4, future.size(), fout);
  std::fclose(fin);
  std::fclose(fout);
  return 0;
}
