// Native frame-preprocessing runtime: the host-side per-frame work the
// reference performs in its C++ ROS node (src/map_sim_example.cpp:306-336)
// reimplemented as a small shared library the Python runtime loads via
// ctypes (no pybind dependency).  This is the host data path feeding the device
// step: voxel-grid downsampling, the camera->body axis remap, the
// map-range crop, and pose-queue interpolation.
//
// Build: tools/build_native.sh -> libdspmap_native.so
// ABI: plain C, float32 buffers, caller-allocated outputs.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Voxel-grid downsample (PCL VoxelGrid equivalent, one centroid per occupied
// leaf; map_sim_example.cpp:314-317).  Returns the number of output points.
int dspmap_voxel_downsample(const float *points, int n, float leaf,
                            float *out, int out_capacity) {
  struct Acc {
    double x = 0, y = 0, z = 0;
    int n = 0;
  };
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve((size_t)n);
  const float inv = 1.0f / leaf;
  for (int i = 0; i < n; ++i) {
    float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    int64_t cx = (int64_t)std::floor(x * inv);
    int64_t cy = (int64_t)std::floor(y * inv);
    int64_t cz = (int64_t)std::floor(z * inv);
    uint64_t key = ((uint64_t)(cx & 0x1FFFFF) << 42) |
                   ((uint64_t)(cy & 0x1FFFFF) << 21) |
                   (uint64_t)(cz & 0x1FFFFF);
    Acc &a = cells[key];
    a.x += x;
    a.y += y;
    a.z += z;
    a.n += 1;
  }
  int m = 0;
  for (auto &kv : cells) {
    if (m >= out_capacity) break;
    out[3 * m] = (float)(kv.second.x / kv.second.n);
    out[3 * m + 1] = (float)(kv.second.y / kv.second.n);
    out[3 * m + 2] = (float)(kv.second.z / kv.second.n);
    ++m;
  }
  return m;
}

// Camera->body axis remap (x,y,z) <- (z_cam, -x_cam, -y_cam) and symmetric
// range crop to the map half-extents (map_sim_example.cpp:320-336).
// Returns the number of points kept (<= max_out).
int dspmap_remap_crop(const float *cam_points, int n, const float *half_extent,
                      float *out, int max_out) {
  int m = 0;
  for (int i = 0; i < n && m < max_out; ++i) {
    float x = cam_points[3 * i + 2];
    float y = -cam_points[3 * i];
    float z = -cam_points[3 * i + 1];
    if (x > -half_extent[0] && x < half_extent[0] && y > -half_extent[1] &&
        y < half_extent[1] && z > -half_extent[2] && z < half_extent[2]) {
      out[3 * m] = x;
      out[3 * m + 1] = y;
      out[3 * m + 2] = z;
      ++m;
    }
  }
  return m;
}

// Pose interpolation at a query time from a sorted pose stream:
// linear position, slerp attitude (shortest arc), clamped to the stream ends
// (map_sim_example.cpp:275-302).  times[n], pos[n*3], quat_wxyz[n*4].
void dspmap_interp_pose(const double *times, const float *pos,
                        const float *quat, int n, double t_query,
                        float *out_pos, float *out_quat) {
  if (n == 1) {
    std::memcpy(out_pos, pos, 12);
    std::memcpy(out_quat, quat, 16);
    return;
  }
  int k = 1;
  while (k < n - 1 && times[k] < t_query) ++k;
  const double ta = times[k - 1], tb = times[k];
  double f = tb == ta ? 0.0 : (t_query - ta) / (tb - ta);
  if (f < 0.0) f = 0.0;
  if (f > 1.0) f = 1.0;
  const float *pa = pos + 3 * (k - 1), *pb = pos + 3 * k;
  const float *qa = quat + 4 * (k - 1), *qb = quat + 4 * k;
  for (int i = 0; i < 3; ++i)
    out_pos[i] = (float)(pa[i] * (1.0 - f) + pb[i] * f);

  double dot = 0.0;
  for (int i = 0; i < 4; ++i) dot += (double)qa[i] * qb[i];
  double sign = dot >= 0.0 ? 1.0 : -1.0;
  dot *= sign;
  double wa, wb;
  if (dot > 0.9995) {
    wa = 1.0 - f;
    wb = f;
  } else {
    double theta = std::acos(dot);
    double s = std::sin(theta);
    wa = std::sin((1.0 - f) * theta) / s;
    wb = std::sin(f * theta) / s;
  }
  double norm = 0.0;
  float q[4];
  for (int i = 0; i < 4; ++i) {
    q[i] = (float)(qa[i] * wa + sign * qb[i] * wb);
    norm += (double)q[i] * q[i];
  }
  norm = std::sqrt(norm);
  for (int i = 0; i < 4; ++i) out_quat[i] = (float)(q[i] / norm);
}

// Full frame preprocessing in one call: downsample -> remap -> crop -> pad.
// Writes exactly max_points*3 floats into out (zero padded); returns count.
int dspmap_preprocess_frame(const float *cam_points, int n, float leaf,
                            const float *half_extent, float *out,
                            int max_points, float *scratch,
                            int scratch_capacity) {
  int m = dspmap_voxel_downsample(cam_points, n, leaf, scratch,
                                  scratch_capacity);
  std::memset(out, 0, sizeof(float) * 3 * (size_t)max_points);
  return dspmap_remap_crop(scratch, m, half_extent, out, max_points);
}

}  // extern "C"
