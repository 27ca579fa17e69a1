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
// Row-slice mode: a plane may be the slice of R rows of a row-sharded
// plane, holding global rows row0 .. row0 + R - 1 as an [R, A] tensor
// (R == A, row0 == 0 is the whole plane).  The row writers then write only
// the window rows that fall inside the slice, and the column writers take
// cols[s, row0 + i] for the slice's row i.  A window may straddle two
// slices; each slice's launch writes its share.
//
// Replaces the TPU kernel mpmcxx_tpu/ops/pallas_polar.py:134
// write_columns_pallas and the row dynamic_update_slice of
// write_symmetric_rows.
//
// Bound: launch latency.  A commit moves 2 x S x A floats per plane
// (~0.7 MB for S = 3, A = 19,712, three planes: 0.2 us at 3.35 TB/s); the
// column strip is a strided write (S floats per row-major line).  The
// design keeps the device part short:
// - The window start is the caller's 0-d device int64 (or int32), read by
//   the kernel itself: no cast launch, and the MC step never waits on the
//   host for it.
// - Grid (segments, planes): blockIdx.y is the plane; the first S x
//   row_segs blocks of a plane write its row strip (row s, one segment of
//   columns each), the rest its column strip (one thread per row of the
//   slice, its S floats).  Index math is 32-bit within a row, with one
//   division per block and none per element.  A thread issues its loads
//   before it reads the start, so the two wait on memory together.
// - Row strips move 16 bytes a thread where the rows allow it (A % 4 == 0
//   and 16-byte aligned bases), element by element only in the float4
//   that holds the window's edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 5;
constexpr int kThreads = 256;
constexpr int kChunk = 8;      // column-strip floats a thread loads at once

struct PlanePtrs {
  float* p[kMaxPlanes];
};

// The window start, or -1 where it is outside [0, A - S] (the caller
// clips it there; stay in bounds anyway).
__device__ __forceinline__ int window_start(const void* start, int is_64,
                                            int S, int A) {
  const long long st = is_64 ? *static_cast<const long long*>(start)
                             : *static_cast<const int*>(start);
  return st < 0 || st > A - S ? -1 : static_cast<int>(st);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
write_plane_strips_kernel(const __grid_constant__ PlanePtrs planes,
                          const float* __restrict__ blend,
                          const float* __restrict__ cols,
                          const void* __restrict__ start_ptr,
                          int start_is_64, int S, int A, int row0, int R,
                          int row_segs) {
  const int p = blockIdx.y;
  const int row_blocks = S * row_segs;
  const int b = blockIdx.x;
  if (b < row_blocks) {
    const int s = b / row_segs;
    const int seg = b - s * row_segs;
    const float* src = blend + static_cast<size_t>(p * S + s) * A;
    if (VEC) {
      const int g = seg * kThreads + threadIdx.x;     // float4 of the row
      if (g >= A / 4) return;
      const float4 v = reinterpret_cast<const float4*>(src)[g];
      const int start = window_start(start_ptr, start_is_64, S, A);
      const int row = start + s - row0;              // row of the slice
      if (start < 0 || row < 0 || row >= R) return;
      float* dst = planes.p[p] + static_cast<size_t>(row) * A;
      const int j = 4 * g, end = start + S;
      if (j + 4 <= start || j >= end) {
        reinterpret_cast<float4*>(dst)[g] = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j + k < start || j + k >= end) dst[j + k] = w[k];
      }
    } else {
      const int j = seg * kThreads + threadIdx.x;
      if (j >= A) return;
      const float v = src[j];
      const int start = window_start(start_ptr, start_is_64, S, A);
      const int row = start + s - row0;
      if (start < 0 || row < 0 || row >= R || (j >= start && j < start + S))
        return;
      planes.p[p][static_cast<size_t>(row) * A + j] = v;
    }
  } else {
    // row i of the slice's column strip: its S floats, kChunk loads at a
    // time, from global row row0 + i of cols
    const int i = (b - row_blocks) * kThreads + threadIdx.x;
    if (i >= R) return;
    const float* src = cols + static_cast<size_t>(p * S) * A + row0 + i;
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < S) v[k] = src[static_cast<size_t>(k) * A];
    const int start = window_start(start_ptr, start_is_64, S, A);
    if (start < 0) return;
    float* dst = planes.p[p] + static_cast<size_t>(i) * A + start;
    for (int s0 = 0;;) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (s0 + k < S) dst[s0 + k] = v[k];
      s0 += kChunk;
      if (s0 >= S) break;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (s0 + k < S) v[k] = src[static_cast<size_t>(s0 + k) * A];
    }
  }
}

}  // namespace

// planes: host array of n_planes device pointers to [R, A] f32 planes
// holding global rows row0 .. row0 + R - 1 of [A, A] planes; blend, cols:
// device [n_planes, S, A] f32; start: device 0-d int64 (start_is_64) or
// int32, the window's global row.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_write_plane_strips(void* const* planes, int n_planes,
                                         const float* blend,
                                         const float* cols, const void* start,
                                         int start_is_64, int S, int A,
                                         int row0, int R, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || S < 1 || S > A || R < 1 ||
      row0 < 0 || row0 > A - R)
    return static_cast<int>(cudaErrorInvalidValue);
  PlanePtrs ptrs = {};
  bool vec = A % 4 == 0 && reinterpret_cast<uintptr_t>(blend) % 16 == 0;
  for (int i = 0; i < n_planes; ++i) {
    ptrs.p[i] = static_cast<float*>(planes[i]);
    vec = vec && reinterpret_cast<uintptr_t>(planes[i]) % 16 == 0;
  }
  const int row_segs = vec ? (A / 4 + kThreads - 1) / kThreads
                           : (A + kThreads - 1) / kThreads;
  const dim3 grid(S * row_segs + (R + kThreads - 1) / kThreads, n_planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    write_plane_strips_kernel<true><<<grid, kThreads, 0, s>>>(
        ptrs, blend, cols, start, start_is_64, S, A, row0, R, row_segs);
  else
    write_plane_strips_kernel<false><<<grid, kThreads, 0, s>>>(
        ptrs, blend, cols, start, start_is_64, S, A, row0, R, row_segs);
  return static_cast<int>(cudaGetLastError());
}
