// Kernel K1: the mixed-precision SCF dipole contraction
//     ef_i = sum_j [ s_ij d_ij + cd_ij mu_j ],   s_ij = co_ij (d_ij . mu_j)
// over the 3-, 4- or 5-plane f32 tuple of ops/polar.py fold_outer_rows
// (the caller negates: -T mu).  Mode 3 planes are masked displacements
// (dx, dy, dz) and co, cd are recomputed per pair exactly as
// ops/polar.py coeffs_from_d does; mode 4 is (cd, sx, sy, sz) with
// s = -(s . mu); mode 5 is (co, cd, dx, dy, dz).
//
// Replaces the TPU kernels mpmcxx_tpu/ops/pallas_polar.py
// contract_pallas_sym (:209; the SCF contraction of the flagship's
// default schedule: 4 calls per MC move plus every full solve) and
// contract_pallas (:39; the full-plane pass under MPMCXX_SYM_KERNEL=0).
// It assumes no symmetry of the planes.
//
// Bound: device-memory bytes.  This design streams every plane once: in
// mode 3 at A = 11,264 that is 3 x 11,264^2 x 4 B = 1.52 GB against
// ~40 flops + one expf per pair.  On the symmetric planes of the SCF the
// function needs only the tile triangle, about half those bytes: K4
// (csrc/contract_planes_tri.cu) reads each unordered tile pair once.
//
// Design: one warp per row i.  The warp's lanes walk the row's columns
// with stride 32, so each plane load is one coalesced 128-byte line per
// warp; mu comes in as an f32 [3, A] structure of arrays, shared by every
// row and served from L2/L1.  Math and accumulation are f32 (as on the
// TPU); each lane keeps three partial sums and the warp folds them with
// shuffles.  No shared memory, no atomics: every output row has one
// writer, so the result does not depend on scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int MODE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
contract_planes_kernel(const float* __restrict__ p0,
                       const float* __restrict__ p1,
                       const float* __restrict__ p2,
                       const float* __restrict__ p3,
                       const float* __restrict__ p4,
                       const float* __restrict__ mu, float l,
                       float* __restrict__ out, int A) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= A) return;
  const size_t base = static_cast<size_t>(row) * A;
  const float* mx = mu;
  const float* my = mu + A;
  const float* mz = mu + 2 * static_cast<size_t>(A);

  float ex = 0.f, ey = 0.f, ez = 0.f;
#pragma unroll 4
  for (int j = lane; j < A; j += 32) {
    float dx, dy, dz, co = 0.f, cd;
    if (MODE == 3) {
      dx = p0[base + j];
      dy = p1[base + j];
      dz = p2[base + j];
      // coeffs_from_d: co = -3 damp2 / r^5, cd = damp1 / r^3
      const float r2 = dx * dx + dy * dy + dz * dz;
      const bool live = r2 > 0.f;
      const float r2s = live ? r2 : 1.f;
      const float ir = rsqrtf(r2s);
      const float r = r2s * ir;
      const float ir2 = ir * ir;
      const float ir3 = ir * ir2;
      const float ir5 = ir3 * ir2;
      const float x = l * r;
      const float e = expf(-x);
      const float x2 = x * x;
      const float damp1 = 1.f - e * (0.5f * x2 + x + 1.f);
      const float damp2 = damp1 - e * (x * x2 * (1.0f / 6.0f));
      co = live ? -3.f * damp2 * ir5 : 0.f;
      cd = live ? damp1 * ir3 : 0.f;
    } else if (MODE == 4) {
      cd = p0[base + j];
      dx = p1[base + j];
      dy = p2[base + j];
      dz = p3[base + j];
    } else {
      co = p0[base + j];
      cd = p1[base + j];
      dx = p2[base + j];
      dy = p3[base + j];
      dz = p4[base + j];
    }
    const float mxj = mx[j], myj = my[j], mzj = mz[j];
    const float dot = dx * mxj + dy * myj + dz * mzj;
    const float s = (MODE == 4) ? -dot : co * dot;
    ex += s * dx + cd * mxj;
    ey += s * dy + cd * myj;
    ez += s * dz + cd * mzj;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ex += __shfl_down_sync(0xffffffffu, ex, off);
    ey += __shfl_down_sync(0xffffffffu, ey, off);
    ez += __shfl_down_sync(0xffffffffu, ez, off);
  }
  if (lane == 0) {
    out[3 * static_cast<size_t>(row) + 0] = ex;
    out[3 * static_cast<size_t>(row) + 1] = ey;
    out[3 * static_cast<size_t>(row) + 2] = ez;
  }
}

}  // namespace

// planes: host array of `mode` device pointers to [A, A] f32 row-major
// planes; mu: device [3, A] f32; out: device [A, 3] f32.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_contract_planes(const void* const* planes, int mode,
                                      const float* mu, float l, float* out,
                                      int A, void* stream) {
  const float* p[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < mode && i < 5; ++i)
    p[i] = static_cast<const float*>(planes[i]);
  const dim3 grid((A + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 3:
      contract_planes_kernel<3><<<grid, block, 0, s>>>(
          p[0], p[1], p[2], p[3], p[4], mu, l, out, A);
      break;
    case 4:
      contract_planes_kernel<4><<<grid, block, 0, s>>>(
          p[0], p[1], p[2], p[3], p[4], mu, l, out, A);
      break;
    case 5:
      contract_planes_kernel<5><<<grid, block, 0, s>>>(
          p[0], p[1], p[2], p[3], p[4], mu, l, out, A);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
