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
// Bound: f64 arithmetic, about 9 operations per point-atom pair (2.7e8
// pairs for the grid test and 7.1e8 for the dart test of one move of the
// CO2 flagship with a 24^3 grid).  Design: one thread per point; each
// block stages tiles of (x, y, z, alive) in shared memory, reads them as
// broadcasts, and leaves as soon as every point of the block is hit
// (__syncthreads_or on "still open").  One writer per point, no atomics:
// the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;

__global__ void occupancy_kernel(const double* __restrict__ points,
                                 const double* __restrict__ positions,
                                 const uint8_t* __restrict__ alive,
                                 double r2, int P, int A,
                                 uint8_t* __restrict__ occ) {
  __shared__ double sx[kTile], sy[kTile], sz[kTile];
  __shared__ uint8_t sa[kTile];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool real = p < P;
  double px = 0.0, py = 0.0, pz = 0.0;
  if (real) {
    px = points[3 * static_cast<size_t>(p)];
    py = points[3 * static_cast<size_t>(p) + 1];
    pz = points[3 * static_cast<size_t>(p) + 2];
  }
  bool hit = false;
  for (int t0 = 0; t0 < A; t0 += kTile) {
    // every block thread is still here; padding threads count as hit
    if (!__syncthreads_or(real && !hit)) break;
    const int a = t0 + threadIdx.x;
    if (a < A) {
      sx[threadIdx.x] = positions[3 * static_cast<size_t>(a)];
      sy[threadIdx.x] = positions[3 * static_cast<size_t>(a) + 1];
      sz[threadIdx.x] = positions[3 * static_cast<size_t>(a) + 2];
      sa[threadIdx.x] = alive[a];
    }
    __syncthreads();
    const int n = min(kTile, A - t0);
    if (real && !hit) {
      for (int k = 0; k < n; ++k) {
        const double dx = __dsub_rn(px, sx[k]);
        const double dy = __dsub_rn(py, sy[k]);
        const double dz = __dsub_rn(pz, sz[k]);
        const double d2 = __dadd_rn(
            __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
            __dmul_rn(dz, dz));
        if (sa[k] && d2 < r2) {
          hit = true;
          break;
        }
      }
    }
  }
  if (real) occ[p] = hit ? 1 : 0;
}

}  // namespace

// points: device [P, 3] f64; positions: device [A, 3] f64; alive: device
// [A] bytes (0/1); occ: device [P] bytes, written.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_occupancy(const double* points, const double* positions,
                                const uint8_t* alive, double r2, int P, int A,
                                uint8_t* occ, void* stream) {
  if (P < 1 || A < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((P + kThreads - 1) / kThreads);
  occupancy_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      points, positions, alive, r2, P, A, occ);
  return static_cast<int>(cudaGetLastError());
}
