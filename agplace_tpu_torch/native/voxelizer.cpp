// Native batched voxelizer — the host-side hot loop of the input pipeline.
//
// The port's own copy of the JAX package's agplace_tpu/native/voxelizer.cpp
// (the same code; the port reads nothing of that package).  Equivalent of
// MinkowskiEngine's sparse_quantize as the reference collates use it
// (ME.utils.sparse_quantize with quantization_size=quant_size): floor-divide
// metric points by the quantisation size, deduplicate voxel coordinates,
// clamp into the occupancy-grid extent, and pad to a fixed capacity.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).
// Threaded over the batch dimension with std::thread.
//
// Built at first use by agplace_tpu_torch/native/__init__.py:
// g++ -O3 -shared -fPIC -o _build/libvoxelizer.so voxelizer.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

constexpr int kShift = 10;  // bits per axis in the packed key
constexpr int kMask = (1 << kShift) - 1;

inline int32_t pack(int x, int y, int z) {
  return ((x + 512) << (2 * kShift)) | ((y + 512) << kShift) | (z + 512);
}

// Canonical overflow rule (shared by quantize()/numpy fallback/this file):
// keep the lexicographically-smallest `capacity` unique voxel coordinates,
// emitted in ascending packed-key order — identical output arrays across all
// three backends, independent of point scan order.
void voxelize_one(const float* pts, int64_t n_points, float quant,
                  int capacity, int grid_radius, int32_t* out_coords,
                  uint8_t* out_mask) {
  std::unordered_set<int32_t> seen;
  seen.reserve(static_cast<size_t>(capacity) * 2);
  std::vector<int32_t> keys;
  keys.reserve(static_cast<size_t>(capacity) * 2);
  const float inv = 1.0f / quant;
  const int lo = -grid_radius + 1, hi = grid_radius - 1;
  for (int64_t i = 0; i < n_points; ++i) {
    const float px = pts[i * 3], py = pts[i * 3 + 1], pz = pts[i * 3 + 2];
    if (!std::isfinite(px) || !std::isfinite(py) || !std::isfinite(pz))
      continue;  // NaN padding rows
    int x = static_cast<int>(std::floor(px * inv));
    int y = static_cast<int>(std::floor(py * inv));
    int z = static_cast<int>(std::floor(pz * inv));
    x = x < lo ? lo : (x > hi ? hi : x);
    y = y < lo ? lo : (y > hi ? hi : y);
    z = z < lo ? lo : (z > hi ? hi : z);
    const int32_t key = pack(x, y, z);
    if (seen.insert(key).second) keys.push_back(key);
  }
  if (static_cast<int>(keys.size()) > capacity) {
    std::nth_element(keys.begin(), keys.begin() + capacity, keys.end());
    keys.resize(capacity);
  }
  std::sort(keys.begin(), keys.end());
  const int count = static_cast<int>(keys.size());
  for (int i = 0; i < count; ++i) {
    const int32_t key = keys[i];
    out_coords[i * 3] = ((key >> (2 * kShift)) & kMask) - 512;
    out_coords[i * 3 + 1] = ((key >> kShift) & kMask) - 512;
    out_coords[i * 3 + 2] = (key & kMask) - 512;
    out_mask[i] = 1;
  }
  // zero the padded tail
  std::memset(out_coords + count * 3, 0,
              sizeof(int32_t) * 3 * (capacity - count));
  std::memset(out_mask + count, 0, capacity - count);
}

}  // namespace

extern "C" {

// points: [b, p, 3] float32 (NaN rows = padding)
// out_coords: [b, capacity, 3] int32; out_mask: [b, capacity] uint8
void voxelize_batch(const float* points, int64_t b, int64_t p, float quant,
                    int32_t capacity, int32_t grid_radius,
                    int32_t* out_coords, uint8_t* out_mask,
                    int32_t n_threads) {
  if (n_threads <= 1 || b == 1) {
    for (int64_t i = 0; i < b; ++i)
      voxelize_one(points + i * p * 3, p, quant, capacity, grid_radius,
                   out_coords + i * capacity * 3, out_mask + i * capacity);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t per = (b + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * per, hi_i = std::min(b, lo + per);
    if (lo >= hi_i) break;
    workers.emplace_back([=]() {
      for (int64_t i = lo; i < hi_i; ++i)
        voxelize_one(points + i * p * 3, p, quant, capacity, grid_radius,
                     out_coords + i * capacity * 3,
                     out_mask + i * capacity);
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
