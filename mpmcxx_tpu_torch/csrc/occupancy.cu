// Kernel K3: cavity-grid occupancy.  For each of P points,
//     occ[p] = any over a of ( alive[a] && |points[p] - positions[a]|^2 < r2 )
// with exact per-axis f64 differences and d^2 formed as
// (dx*dx + dy*dy) + dz*dz in round-to-nearest steps that nvcc may not
// contract into FMAs, so the result is bitwise that of the plain PyTorch
// version (mpmcxx_tpu_torch/ops/cuda_cavity.py occupancy_plain).
//
// Replaces the TPU kernel mpmcxx_tpu/ops/pallas_cavity.py
// occupancy_pallas.  That kernel ran in f32 only because Mosaic has no f64;
// this one keeps the state's f64.  The same predicate serves the
// accessible-volume dart test of mc/cavity.update_grid (darts against the
// grid's open points), which the JAX package ran as a dense
// [darts, P, 3] tensor.
//
// Bound: f64 arithmetic, about 9 operations per point-atom test (the
// CO2 flagship's CLI run, 24^3 grid: 13,824 points against 19,712 slots
// of which ~10,100 live; 51,200 darts against the ~5,700 open grid
// points).  Design:
// - The atom axis is split across blocks: block (x, y) tests the 256
//   points of tile x against the 1,024 atom slots of chunk y, so the grid
//   test launches 54 x 20 blocks and the dart test 200 x 14, several
//   resident on every SM.  occ is zeroed first (on the same stream); a
//   block that finds a hit stores the byte 1.  The store is idempotent and
//   the predicate only grows, so the result does not depend on the order
//   of blocks, and no atomics are needed; a block skips the points another
//   block has already marked.
// - Each block compacts its chunk's live atoms into shared memory as it
//   stages them (warp ballot + popc, in slot order), so a dead slot (or a
//   closed grid point in the dart test) costs a byte read and no test.  A
//   thread leaves at its point's first hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // points per block, one per thread
constexpr int kChunk = 1024;      // atom slots per block
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
occupancy_kernel(const double* __restrict__ points,
                 const double* __restrict__ positions,
                 const uint8_t* __restrict__ alive, double r2, int P, int A,
                 uint8_t* occ) {
  __shared__ double sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ int warp_live[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int a0 = blockIdx.y * kChunk;

  // stage the chunk's live atoms, compacted in slot order
  int n = 0;
  for (int r = 0; r < kChunk; r += kThreads) {
    const int a = a0 + r + threadIdx.x;
    const bool live = a < A && alive[a] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int k = warp_live[w];
      before += w < warp ? k : 0;
      total += k;
    }
    if (live) {
      const int k = n + before + __popc(ballot & ((1u << lane) - 1u));
      sx[k] = positions[3 * static_cast<size_t>(a)];
      sy[k] = positions[3 * static_cast<size_t>(a) + 1];
      sz[k] = positions[3 * static_cast<size_t>(a) + 2];
    }
    n += total;
    __syncthreads();
  }

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (n == 0 || p >= P) return;
  // marked by a block of another chunk already (read past L1)
  if (*static_cast<volatile const uint8_t*>(occ + p)) return;
  const double px = points[3 * static_cast<size_t>(p)];
  const double py = points[3 * static_cast<size_t>(p) + 1];
  const double pz = points[3 * static_cast<size_t>(p) + 2];
  for (int k = 0; k < n; ++k) {
    const double dx = __dsub_rn(px, sx[k]);
    const double dy = __dsub_rn(py, sy[k]);
    const double dz = __dsub_rn(pz, sz[k]);
    const double d2 = __dadd_rn(
        __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
    if (d2 < r2) {
      occ[p] = 1;
      return;
    }
  }
}

}  // namespace

// points: device [P, 3] f64; positions: device [A, 3] f64; alive: device
// [A] bytes (0/1); occ: device [P] bytes, written (zeroed first).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_occupancy(const double* points, const double* positions,
                                const uint8_t* alive, double r2, int P, int A,
                                uint8_t* occ, void* stream) {
  if (P < 1 || A < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(occ, 0, static_cast<size_t>(P), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (A == 0) return static_cast<int>(cudaGetLastError());
  const unsigned chunks = static_cast<unsigned>((A + kChunk - 1) / kChunk);
  if (chunks > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((P + kThreads - 1) / kThreads),
                  chunks);
  occupancy_kernel<<<grid, kThreads, 0, s>>>(points, positions, alive, r2, P,
                                             A, occ);
  return static_cast<int>(cudaGetLastError());
}
