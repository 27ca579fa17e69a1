// Kernel K1: the mixed-precision SCF dipole contraction
//     ef_i = sum_j [ s_ij d_ij + cd_ij mu_j ],   s_ij = co_ij (d_ij . mu_j)
// over the 3-, 4- or 5-plane f32 tuple of ops/polar.py fold_outer_rows,
// with -ef written in f64.  Mode 3 planes are masked displacements
// (dx, dy, dz) and co, cd are recomputed per pair exactly as
// ops/polar.py coeffs_from_d does; mode 4 is (cd, sx, sy, sz) with
// s = -(s . mu); mode 5 is (co, cd, dx, dy, dz).  The planes are [R, A]:
// the whole square plane, or a slice of its rows.
//
// Replaces the TPU kernel mpmcxx_tpu/ops/pallas_polar.py:39
// contract_pallas (B1, the full-plane pass under MPMCXX_SYM_KERNEL=0) and
// serves the XLA branch of the JAX package's switch (square planes of
// other sizes, and the rectangular row slices of a row-sharded caller).
// It assumes no symmetry of the planes: on the symmetric planes of the
// SCF, K5 (csrc/contract_planes_sym.cu, the default schedule) and K4
// (csrc/contract_planes_tri.cu) read each unordered tile pair once.
//
// Bound: device-memory bytes.  Every plane entry is read once: in mode 3
// at R = A = 10,752 that is 1.387 GB (0.414 ms at 3.35 TB/s) against ~45
// flops and one expf per pair.  What the design does about it:
// - Persistent blocks, as many as fit on the card at once (two per SM),
//   each walking a contiguous range of work units: a unit is 32 rows x 64
//   columns, taken in row-major order, and every block gets the same
//   number of units (to one), so there is no ragged last wave.
// - One producer thread keeps the planes in flight: a ring of
//   shared-memory stages (4 in mode 3, 3 in mode 4, 2 in mode 5), each one
//   unit of every plane plus the unit's 64 dipoles, filled by TMA (one 2-D
//   tensor-map copy per plane, one bulk copy of mu's f64 [64, 3] rows)
//   behind "full" and "empty" mbarriers.  The tensor maps need a row
//   stride that is a multiple of 16 bytes; where A % 4 != 0 (or a pointer
//   is not 16-byte aligned) four producer warps fill the same stages with
//   4- and 8-byte cp.async copies instead, each warp a quarter of the
//   rows (a copy instruction moves only 128 bytes).  Both
//   fills put zeros outside the planes, and the consumers zero mu past
//   column A.
// - mu is read once per unit, not once per row: the stage carries it and
//   all 32 rows of the unit use it.  The kernel reads the caller's f64
//   [A, 3] mu and writes f64, so a call has no copy or cast launch.
// - Consumer thread (warp w, lane) owns rows 4w .. 4w+3 of the unit and
//   its columns 2 lane, 2 lane + 1; its row sums stay in registers while
//   the block stays in one row group.
// - No float atomics.  When the block leaves a row group, the warps fold
//   their row sums over the lanes and write them to the block's slot of
//   that row group (block - first block of the group).  A second launch
//   adds each row's slots in a fixed order and writes -ef in f64: every
//   output entry has one writer, and two launches on one input are
//   bitwise equal (on one card: the block count is the card's).
// Math and sums are f32, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kRows = 32;                      // rows of a unit
constexpr int kCols = 64;                      // columns of a unit
constexpr int kWarps = 8;                      // consumer warps
constexpr int kRowsPerWarp = kRows / kWarps;   // 4
// warps that fill the ring: one thread issues a stage's TMA copies; the
// cp.async fill, one copy instruction per 32 floats, takes four warps
template <bool TMA>
constexpr int kFillWarps = TMA ? 1 : 4;
template <bool TMA>
constexpr int kThreads = (kWarps + kFillWarps<TMA>) * 32;

template <int MODE>
struct Stage {
  // stages in the ring: as many as let two blocks share an SM
  static constexpr int kCount = MODE == 3 ? 4 : MODE == 4 ? 3 : 2;
  static constexpr int kPlaneFloats = MODE * kRows * kCols;
  // MODE planes x 32 rows x 64 columns (f32), then mu [64][3] (f64)
  static constexpr unsigned kBytes = kPlaneFloats * 4 + kCols * 3 * 8;
  // the ring, two mbarriers a stage, and room to align the ring to 128
  // bytes for TMA
  static constexpr size_t kSmem =
      static_cast<size_t>(kCount) * kBytes + 2 * kCount * 8 + 128;
};

struct PlanePtrs {
  const float* p[5];
};

// Units [g U / G, (g + 1) U / G) go to block g; the block of unit u.
__host__ __device__ inline int owner(long long u, int G, long long U) {
  return static_cast<int>(((u + 1) * G - 1) / U);
}

// Blocks that share row group rg: its slots.
__host__ __device__ inline int group_slots(int rg, int ncc, int G,
                                           long long U) {
  const long long f = static_cast<long long>(rg) * ncc;
  return owner(f + ncc - 1, G, U) - owner(f, G, U) + 1;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One stage (32 rows x 64 columns): this thread's 4 rows x 2 columns into
// acc.  m holds the f32 dipoles of the thread's two columns.
template <int MODE>
__device__ __forceinline__ void consume(const float* __restrict__ st,
                                        int warp, int lane, float l,
                                        const float (&m)[2][3],
                                        float (&acc)[kRowsPerWarp][3]) {
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    float2 v[MODE];
#pragma unroll
    for (int p = 0; p < MODE; ++p)
      v[p] = reinterpret_cast<const float2*>(
          st + (p * kRows + r) * kCols)[lane];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float q[MODE];
#pragma unroll
      for (int p = 0; p < MODE; ++p) q[p] = cc ? v[p].y : v[p].x;
      float dx, dy, dz, co = 0.f, cd;
      if constexpr (MODE == 3) {
        dx = q[0];
        dy = q[1];
        dz = q[2];
        // coeffs_from_d: co = -3 damp2 / r^5, cd = damp1 / r^3
        const float r2 = dx * dx + dy * dy + dz * dz;
        const bool live = r2 > 0.f;
        const float r2s = live ? r2 : 1.f;
        const float ir = rsqrtf(r2s);
        const float rad = r2s * ir;
        const float ir2 = ir * ir;
        const float ir3 = ir * ir2;
        const float ir5 = ir3 * ir2;
        const float x = l * rad;
        const float e = expf(-x);
        const float x2 = x * x;
        const float damp1 = 1.f - e * (0.5f * x2 + x + 1.f);
        const float damp2 = damp1 - e * (x * x2 * (1.0f / 6.0f));
        co = live ? -3.f * damp2 * ir5 : 0.f;
        cd = live ? damp1 * ir3 : 0.f;
      } else if constexpr (MODE == 4) {
        cd = q[0];
        dx = q[1];
        dy = q[2];
        dz = q[3];
      } else {
        co = q[0];
        cd = q[1];
        dx = q[2];
        dy = q[3];
        dz = q[4];
      }
      const float mx = m[cc][0], my = m[cc][1], mz = m[cc][2];
      const float dot = dx * mx + dy * my + dz * mz;
      const float s = (MODE == 4) ? -dot : co * dot;
      acc[rr][0] += s * dx + cd * mx;
      acc[rr][1] += s * dy + cd * my;
      acc[rr][2] += s * dz + cd * mz;
    }
  }
}

// TMA: the stages come from tensor maps m0..m4 and bulk copies of mu;
// otherwise from cp.async copies of planes.p and mu.
template <int MODE, bool TMA>
__global__ void __launch_bounds__(kThreads<TMA>, 2)
contract_planes_kernel(const __grid_constant__ CUtensorMap m0,
                       const __grid_constant__ CUtensorMap m1,
                       const __grid_constant__ CUtensorMap m2,
                       const __grid_constant__ CUtensorMap m3,
                       const __grid_constant__ CUtensorMap m4,
                       const PlanePtrs planes,
                       const double* __restrict__ mu, float l,
                       float* __restrict__ scratch, int R, int A, int G) {
  using S = Stage<MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((128u - (smem_u32(smem) & 127u)) & 127u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kCount * S::kBytes);
  uint64_t* empty = full + S::kCount;

  const int ncc = (A + kCols - 1) / kCols;
  const long long U = static_cast<long long>((R + kRows - 1) / kRows) * ncc;
  const long long u0 = static_cast<long long>(blockIdx.x) * U / G;
  const long long u1 = static_cast<long long>(blockIdx.x + 1) * U / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kCount; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32 * kFillWarps<TMA>);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (u0 >= u1) return;
  int rg = static_cast<int>(u0 / ncc);
  int cc = static_cast<int>(u0 - static_cast<long long>(rg) * ncc);

  if (warp >= kWarps) {
    // producers: fill the ring with the units in order
    if (TMA && lane != 0) return;
    const int fw = warp - kWarps;
    const CUtensorMap* maps[5] = {&m0, &m1, &m2, &m3, &m4};
    int s = 0;
    uint32_t parity = 1;     // the ring starts empty
    for (long long u = u0; u < u1; ++u) {
      const int r0 = rg * kRows, c0 = cc * kCols;
      const int ncol = A - c0 < kCols ? A - c0 : kCols;
      unsigned char* dst = ring + s * S::kBytes;
      float* dp = reinterpret_cast<float*>(dst);
      double* dmu = reinterpret_cast<double*>(dst + S::kPlaneFloats * 4);
      mbar_wait(&empty[s], parity);
      if constexpr (TMA) {
        const uint32_t mu_bytes = ncol * 3 * 8;
        mbar_expect_tx(&full[s], S::kPlaneFloats * 4 + mu_bytes);
#pragma unroll
        for (int p = 0; p < MODE; ++p)
          tma_load(dp + p * kRows * kCols, maps[p], c0, r0, &full[s]);
        bulk_load(dmu, mu + 3 * static_cast<size_t>(c0), mu_bytes, &full[s]);
      } else {
        // fill warp fw copies rows fw, fw + 4, ... of each plane, lane k
        // columns k and k + 32: every copy instruction reads 128 contiguous
        // bytes of a plane row
        constexpr int kStride = kFillWarps<TMA>;
#pragma unroll
        for (int p = 0; p < MODE; ++p) {
#pragma unroll 4
          for (int row = fw; row < kRows; row += kStride) {
            const bool live = r0 + row < R;
            const float* src =
                planes.p[p] + static_cast<size_t>(live ? r0 + row : 0) * A +
                c0;
            float* d = dp + (p * kRows + row) * kCols;
            cp_async4(d + lane, live && lane < ncol ? src + lane : src,
                      live && lane < ncol);
            cp_async4(d + lane + 32,
                      live && lane + 32 < ncol ? src + lane + 32 : src,
                      live && lane + 32 < ncol);
          }
        }
        if (fw == 0) {
#pragma unroll
          for (int k = 0; k < kCols * 3 / 32; ++k) {
            const int e = k * 32 + lane;
            const bool ok = e < ncol * 3;
            cp_async8(dmu + e,
                      ok ? mu + 3 * static_cast<size_t>(c0) + e : mu, ok);
          }
        }
        cp_async_arrive(&full[s]);
      }
      if (++s == S::kCount) {
        s = 0;
        parity ^= 1;
      }
      if (++cc == ncc) {
        cc = 0;
        ++rg;
      }
    }
    return;
  }

  // consumers
  float acc[kRowsPerWarp][3] = {};
  int s = 0;
  uint32_t parity = 0;
  for (long long u = u0; u < u1; ++u) {
    const int c0 = cc * kCols;
    const unsigned char* st = ring + s * S::kBytes;
    const double* smu =
        reinterpret_cast<const double*>(st + S::kPlaneFloats * 4);
    mbar_wait(&full[s], parity);
    float m[2][3];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 2 * lane + j;
      const bool ok = c0 + col < A;   // past A the stage's mu is stale
#pragma unroll
      for (int k = 0; k < 3; ++k)
        m[j][k] = ok ? static_cast<float>(smu[3 * col + k]) : 0.f;
    }
    consume<MODE>(reinterpret_cast<const float*>(st), warp, lane, l, m, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == S::kCount) {
      s = 0;
      parity ^= 1;
    }
    if (cc + 1 == ncc || u + 1 == u1) {
      // leaving row group rg: fold the row sums over the lanes; lane 0
      // writes them to this block's slot of the group
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[rr][k] += __shfl_xor_sync(0xffffffffu, acc[rr][k], off);
      if (lane == 0) {
        const size_t slot =
            blockIdx.x - owner(static_cast<long long>(rg) * ncc, G, U);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int row = rg * kRows + warp * kRowsPerWarp + rr;
          if (row < R) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
              scratch[(slot * R + row) * 3 + k] = acc[rr][k];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[rr][k] = 0.f;
    }
    if (++cc == ncc) {
      cc = 0;
      ++rg;
    }
  }
}

// out[r, k] = -(row r's slots, in slot order) in f64.
__global__ void __launch_bounds__(256)
sum_row_slots_kernel(const float* __restrict__ scratch,
                     double* __restrict__ out, int R, int ncc, long long U,
                     int G) {
  const int n = 3 * R;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  const int slots = group_slots(e / 3 / kRows, ncc, G, U);
  float acc = 0.f;
  for (int k = 0; k < slots; ++k)
    acc += scratch[static_cast<size_t>(k) * n + e];
  out[e] = -static_cast<double>(acc);
}

// Blocks of the persistent grid on the current device: all that fit at
// once.  Returns a CUDA error code (0 = ok).
template <int MODE, bool TMA>
int fit_blocks(int* blocks) {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev) {
    const int smem = static_cast<int>(Stage<MODE>::kSmem);
    err = cudaFuncSetAttribute(contract_planes_kernel<MODE, TMA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, contract_planes_kernel<MODE, TMA>, kThreads<TMA>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached = sms * per_sm;
    cached_dev = dev;
  }
  *blocks = cached;
  return 0;
}

// The launch's shape: blocks G (at most one per unit), column chunks ncc,
// units U and the row slots.
struct Launch {
  int G, ncc, slots;
  long long U;
};

int launch_shape(int mode, bool tma, int R, int A, Launch* L) {
  if (R < 1 || A < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  switch (mode * 2 + (tma ? 1 : 0)) {
    case 6: rc = fit_blocks<3, false>(&L->G); break;
    case 7: rc = fit_blocks<3, true>(&L->G); break;
    case 8: rc = fit_blocks<4, false>(&L->G); break;
    case 9: rc = fit_blocks<4, true>(&L->G); break;
    case 10: rc = fit_blocks<5, false>(&L->G); break;
    case 11: rc = fit_blocks<5, true>(&L->G); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  const int nrg = (R + kRows - 1) / kRows;
  L->ncc = (A + kCols - 1) / kCols;
  L->U = static_cast<long long>(nrg) * L->ncc;
  if (L->G > L->U) L->G = static_cast<int>(L->U);
  L->slots = 1;
  for (int rg = 0; rg < nrg; ++rg) {
    const int n = group_slots(rg, L->ncc, L->G, L->U);
    L->slots = n > L->slots ? n : L->slots;
  }
  return 0;
}

// Whether the stages can come by TMA: a row stride and every base a
// multiple of 16 bytes.
bool tma_ok(const void* const* planes, int mode, const double* mu, int A) {
  bool ok = A % 4 == 0 && reinterpret_cast<uintptr_t>(mu) % 16 == 0;
  for (int i = 0; i < mode; ++i)
    ok = ok && reinterpret_cast<uintptr_t>(planes[i]) % 16 == 0;
  return ok;
}

template <int MODE, bool TMA>
void launch(const CUtensorMap* m, const PlanePtrs& ptrs, const double* mu,
            float l, float* scratch, int R, int A, int G, cudaStream_t s) {
  contract_planes_kernel<MODE, TMA>
      <<<G, kThreads<TMA>, Stage<MODE>::kSmem, s>>>(
      m[0], m[1], m[2], m[3], m[4], ptrs, mu, l, scratch, R, A, G);
}

}  // namespace

// Row slots of the work buffer of a launch in `mode` on [R, A] planes at
// `planes` with mu at `mu` (the buffer is [slots, R, 3] f32), or -1.
extern "C" int mpmcxx_contract_planes_slots(const void* const* planes,
                                            int mode, const double* mu,
                                            int R, int A) {
  if (mode < 3 || mode > 5) return -1;
  Launch L;
  if (launch_shape(mode, tma_ok(planes, mode, mu, A), R, A, &L)) return -1;
  return L.slots;
}

// planes: host array of `mode` device pointers to [R, A] f32 row-major
// planes; mu: device [A, 3] f64; work: device [slots, R, 3] f32 with
// slots from mpmcxx_contract_planes_slots (overwritten where read); out:
// device [R, 3] f64, gets -T mu.  Launches the two passes on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_contract_planes(const void* const* planes, int mode,
                                      const double* mu, float l, float* work,
                                      int slots, double* out, int R, int A,
                                      void* stream) {
  if (mode < 3 || mode > 5) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = tma_ok(planes, mode, mu, A);
  Launch L;
  int e = launch_shape(mode, tma, R, A, &L);
  if (e) return e;
  if (slots != L.slots) return static_cast<int>(cudaErrorInvalidValue);
  PlanePtrs ptrs = {};
  for (int k = 0; k < mode; ++k)
    ptrs.p[k] = static_cast<const float*>(planes[k]);
  // one map per plane (unused ones repeat plane 0); left unencoded off TMA
  CUtensorMap m[5] = {};
  if (tma) {
    EncodeTiled enc = nullptr;
    e = encoder(&enc);
    for (int k = 0; k < 5 && !e; ++k)
      e = tensor_map(enc, &m[k], planes[k < mode ? k : 0], R, A, kRows,
                     kCols);
    if (e) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (tma ? 1 : 0)) {
    case 6: launch<3, false>(m, ptrs, mu, l, work, R, A, L.G, s); break;
    case 7: launch<3, true>(m, ptrs, mu, l, work, R, A, L.G, s); break;
    case 8: launch<4, false>(m, ptrs, mu, l, work, R, A, L.G, s); break;
    case 9: launch<4, true>(m, ptrs, mu, l, work, R, A, L.G, s); break;
    case 10: launch<5, false>(m, ptrs, mu, l, work, R, A, L.G, s); break;
    default: launch<5, true>(m, ptrs, mu, l, work, R, A, L.G, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_row_slots_kernel<<<(3 * R + 255) / 256, 256, 0, s>>>(work, out, R, L.ncc,
                                                          L.U, L.G);
  return static_cast<int>(cudaGetLastError());
}
