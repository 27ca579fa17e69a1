// Kernel K2: the polar-cache commit scatter.  For each of the cache's
// [A, A] f32 planes, one launch writes the S-row strip
//     plane[start + s, j] = blend[s, j]      (j outside the window)
// and the S-column strip
//     plane[i, start + s] = cols[s, i]       (every i)
// in place.  Row writers skip the window columns start..start+S-1, so
// inside the S x S window the column values stand, as in the JAX twin,
// which writes the columns after the rows
// (mpmcxx_tpu/ops/polar_cache.py write_symmetric_rows).  The row and
// column writes touch disjoint addresses, so the result is exact and does
// not depend on scheduling: it is bitwise the plain version's.
//
// Replaces the TPU kernel mpmcxx_tpu/ops/pallas_polar.py
// write_columns_pallas and the row dynamic_update_slice of
// write_symmetric_rows.
//
// Bound: launch latency.  A commit moves 2 x S x A floats per plane
// (~270 KB for S = 3, A = 11,264, three planes); the column strip is a
// strided write (one float per row-major line).  The window start is a
// device int32 the kernel reads itself, so the MC step never waits on the
// host for it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 5;

struct PlanePtrs {
  float* p[kMaxPlanes];
};

__global__ void write_plane_strips_kernel(PlanePtrs planes,
                                          const float* __restrict__ blend,
                                          const float* __restrict__ cols,
                                          const int* __restrict__ start_ptr,
                                          int S, int A) {
  const int start = *start_ptr;
  // the caller clips the window into [0, A - S]; stay in bounds anyway
  if (start < 0 || start > A - S) return;
  float* plane = planes.p[blockIdx.y];
  const size_t strip = static_cast<size_t>(S) * A;
  const float* bl = blend + blockIdx.y * strip;
  const float* cl = cols + blockIdx.y * strip;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < 2 * strip; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (idx < strip) {
      const int s = static_cast<int>(idx / A);
      const int j = static_cast<int>(idx % A);
      if (j >= start && j < start + S) continue;
      plane[static_cast<size_t>(start + s) * A + j] = bl[idx];
    } else {
      const size_t k = idx - strip;
      const int i = static_cast<int>(k / S);
      const int s = static_cast<int>(k % S);
      plane[static_cast<size_t>(i) * A + start + s] =
          cl[static_cast<size_t>(s) * A + i];
    }
  }
}

}  // namespace

// planes: host array of n_planes device pointers to [A, A] f32 planes;
// blend, cols: device [n_planes, S, A] f32; start: device int32 scalar.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_write_plane_strips(void* const* planes, int n_planes,
                                         const float* blend,
                                         const float* cols, const int* start,
                                         int S, int A, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  PlanePtrs ptrs = {};
  for (int i = 0; i < n_planes; ++i) ptrs.p[i] = static_cast<float*>(planes[i]);
  const int threads = 256;
  const size_t work = 2 * static_cast<size_t>(S) * A;
  size_t nblk = (work + threads - 1) / threads;
  if (nblk > 1024) nblk = 1024;
  const dim3 grid(static_cast<unsigned>(nblk), n_planes);
  write_plane_strips_kernel<<<grid, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ptrs, blend, cols, start, S, A);
  return static_cast<int>(cudaGetLastError());
}
