// Kernel K5: the SCF dipole contraction for symmetric T, each unordered
// tile pair read once
//     ef_i = sum_j [ s_ij d_ij + cd_ij mu_j ],   s_ij = co_ij (d_ij . mu_j)
// over the 3-, 4- or 5-plane f32 tuple of ops/polar.py fold_outer_rows
// (the caller negates: -T mu), with the per-pair arithmetic of K1
// (csrc/contract_planes.cu): mode 3 recomputes co, cd from the masked
// displacements, mode 4 is (cd, sx, sy, sz) with s = -(s . mu), mode 5 is
// (co, cd, dx, dy, dz).
//
// Replaces the TPU kernel mpmcxx_tpu/ops/pallas_polar.py:209
// contract_pallas_sym (B2: the default schedule of the SCF, 4 calls per MC
// move plus every full solve).
//
// Precondition: T is symmetric (d antisymmetric, co and cd symmetric: what
// fold_outer_rows builds and the in-place commits keep), so one b x b tile
// (I, J) serves the row sums of I (T_ij mu_j) and the column sums of J
// (T_ji mu_i = co_ij d_ij (d_ij . mu_i) + cd_ij mu_i).  A is a multiple of
// b = 64.
//
// Schedule: B2's wrapped-column pairing.  Row band I takes the column
// tiles J = (I + c) mod nr for c = 0 .. nr/2 (nr = A / 64).  When nr is
// even the c = nr/2 band is read from I < nr/2 only, so every unordered
// tile pair is read exactly once (B2 reads that band from both sides at
// weight 0.5).
//
// Bound: device-memory bytes.  The schedule reads P x 4 x (A^2/2 + A b/2)
// bytes of planes, 2.34 GB in mode 3 at A = 19,712 (0.70 ms at 3.35
// TB/s), half of K1's full-plane pass, against ~45 flops and one expf per
// pair in mode 3.  What the design does about it:
// - Persistent blocks, as many as fit on the card at once (two per SM in
//   modes 3 and 4, one in mode 5), each walking a fixed contiguous range
//   of the nr (nr + 1) / 2 tiles in band order: every block gets the same
//   number of tiles, so there is no ragged last wave.
// - One producer thread keeps the planes in flight.  A ring of 4 (modes 3
//   and 5) or 3 (mode 4) shared-memory stages, each 32 rows x 64 columns
//   of every plane plus the column tile's mu, is filled by TMA: one 2-D
//   tensor-map copy per plane and one for mu (cp.async.bulk.tensor), which
//   complete on the stage's "full" mbarrier; the eight consumer warps hand
//   a stage back through its "empty" mbarrier.  (Copying each 256-byte
//   tile row as its own 1-D bulk copy, 99-163 copies a stage, left the
//   copy engine's rate of requests, not the memory, setting the pace.)
//   The tensor maps are encoded per call on the host with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   the library needs no -lcuda at link time.
// - Consumer thread (warp w, lane) owns rows 4w .. 4w+3 of each half tile
//   and columns 2 lane, 2 lane + 1.  Each pair's coefficients (mode 3:
//   rsqrtf, expf) are computed once and feed both sums.  Row sums stay in
//   registers across the block's whole stretch of a band; column sums are
//   folded over the eight warps in shared memory once per tile.
// - No float atomics.  Column sums of tile (I, c) go to column slot c of
//   the atoms of J; a block's row sums of band I go to row slot (block -
//   first block of band I).  Every (slot, atom) entry has one writer, and
//   a second launch adds each atom's slots in a fixed order, so two
//   launches on one input are bitwise equal (on one card: the block count
//   is the card's).  Scratch: (row slots + nr/2) x A x 12 bytes, 37 MB at
//   A = 19,712 (1.6 % of the bytes read).  The second launch has four
//   threads an atom entry, each adding every fourth slot, and writes
//   -ef in f64; a first small launch makes mu's f32 [3, A] copy that the
//   tensor map reads.
// Math and sums are f32, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kTile = 64;                           // b
constexpr int kStageRows = 32;                      // half a tile per stage
constexpr int kWarps = 8;                           // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;           // + one producer warp
constexpr int kRowsPerWarp = kStageRows / kWarps;   // 4
constexpr int kRedFloats = kWarps * 3 * kTile;      // column-sum buffer
constexpr int kSumParts = 4;                        // threads an entry, pass 2

template <int MODE>
struct Stage {
  // stages in the ring: mode 4 takes 3 so that two blocks fit on an SM
  static constexpr int kCount = MODE == 4 ? 3 : 4;
  // MODE planes x 32 rows x 64 columns, then mu of the 64 columns [3][64]
  static constexpr int kFloats = (MODE * kStageRows + 3) * kTile;
  static constexpr unsigned kBytes = kFloats * 4;
  // the ring, the column-sum buffer [kWarps][3][kTile], two mbarriers a
  // stage, and room to align the ring to 128 bytes for TMA
  static constexpr size_t kSmem = static_cast<size_t>(kCount) * kBytes +
                                  kRedFloats * 4 + 2 * kCount * 8 + 128;
};

// The tiles in visiting order: band i holds c = 0 .. tiles(i) - 1.
struct Schedule {
  int nr, half;
  bool even;
  __host__ __device__ explicit Schedule(int A)
      : nr(A / kTile), half(A / kTile / 2), even((A / kTile) % 2 == 0) {}
  __host__ __device__ int tiles(int i) const {
    return (even && i >= half) ? half : half + 1;
  }
  __host__ __device__ long long first(int i) const {
    if (!even || i <= half) return static_cast<long long>(i) * (half + 1);
    return static_cast<long long>(half) * (half + 1) +
           static_cast<long long>(i - half) * half;
  }
  __host__ __device__ long long total() const { return first(nr); }
  __host__ __device__ void decode(long long t, int& i, int& c) const {
    const long long split =
        even ? static_cast<long long>(half) * (half + 1) : total();
    if (t < split) {
      i = static_cast<int>(t / (half + 1));
      c = static_cast<int>(t % (half + 1));
    } else {
      const long long u = t - split;
      i = half + static_cast<int>(u / half);
      c = static_cast<int>(u % half);
    }
  }
};

// Block g of G walks tiles [g T / G, (g + 1) T / G); the block that walks
// tile t.
__host__ __device__ inline int owner(long long t, int G, long long T) {
  return static_cast<int>(((t + 1) * G - 1) / T);
}

// The most blocks that share one band: the row slots of a launch.
int row_slots(const Schedule& sc, int G) {
  const long long T = sc.total();
  int r = 1;
  for (int i = 0; i < sc.nr; ++i) {
    const long long f = sc.first(i);
    const int n = owner(f + sc.tiles(i) - 1, G, T) - owner(f, G, T) + 1;
    r = n > r ? n : r;
  }
  return r;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// T_ij m for one pair: (ox, oy, oz) += s d + cd m.
template <int MODE>
__device__ __forceinline__ void add_t_mu(float dx, float dy, float dz,
                                         float co, float cd, float mx,
                                         float my, float mz, float& ox,
                                         float& oy, float& oz) {
  const float dot = dx * mx + dy * my + dz * mz;
  const float s = (MODE == 4) ? -dot : co * dot;
  ox += s * dx + cd * mx;
  oy += s * dy + cd * my;
  oz += s * dz + cd * mz;
}

// One stage (32 rows x 64 columns): this thread's 4 rows x 2 columns.
// Row sums into acc, and with COLUMNS the column sums into g.
template <int MODE, bool COLUMNS>
__device__ __forceinline__ void consume(const float* __restrict__ st,
                                        int warp, int lane, float l,
                                        float (&acc)[kRowsPerWarp][3],
                                        const float (&mi)[kRowsPerWarp][3],
                                        float (&g)[2][3]) {
  const float* muj = st + MODE * kStageRows * kTile;
  const float2 mx = reinterpret_cast<const float2*>(muj)[lane];
  const float2 my = reinterpret_cast<const float2*>(muj + kTile)[lane];
  const float2 mz = reinterpret_cast<const float2*>(muj + 2 * kTile)[lane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    float2 v[MODE];
#pragma unroll
    for (int p = 0; p < MODE; ++p)
      v[p] = reinterpret_cast<const float2*>(
          st + (p * kStageRows + r) * kTile)[lane];
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
      add_t_mu<MODE>(dx, dy, dz, co, cd, cc ? mx.y : mx.x,
                     cc ? my.y : my.x, cc ? mz.y : mz.x, acc[rr][0],
                     acc[rr][1], acc[rr][2]);
      if constexpr (COLUMNS)
        add_t_mu<MODE>(dx, dy, dz, co, cd, mi[rr][0], mi[rr][1], mi[rr][2],
                       g[cc][0], g[cc][1], g[cc][2]);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
contract_sym_kernel(const __grid_constant__ CUtensorMap m0,
                    const __grid_constant__ CUtensorMap m1,
                    const __grid_constant__ CUtensorMap m2,
                    const __grid_constant__ CUtensorMap m3,
                    const __grid_constant__ CUtensorMap m4,
                    const __grid_constant__ CUtensorMap mmu,
                    const float* __restrict__ mu, float l,
                    float* __restrict__ scratch, int A, int rslots, int G) {
  using S = Stage<MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(
      smem + ((128u - (smem_u32(smem) & 127u)) & 127u));
  float* red = stages + S::kCount * S::kFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kRedFloats);
  uint64_t* empty = full + S::kCount;

  const Schedule sc(A);
  const long long T = sc.total();
  const long long t0 = static_cast<long long>(blockIdx.x) * T / G;
  const long long t1 = static_cast<long long>(blockIdx.x + 1) * T / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kCount; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t0 >= t1) return;
  int i, c;
  sc.decode(t0, i, c);

  if (warp == kWarps) {
    // producer: one thread issues a stage's MODE + 1 tensor-map copies
    if (lane != 0) return;
    const CUtensorMap* maps[5] = {&m0, &m1, &m2, &m3, &m4};
    int s = 0;
    uint32_t parity = 1;     // the ring starts empty
    for (long long t = t0; t < t1; ++t) {
      const int j = i + c < sc.nr ? i + c : i + c - sc.nr;
      for (int h = 0; h < 2; ++h) {
        mbar_wait(&empty[s], parity);
        float* dst = stages + s * S::kFloats;
        mbar_expect_tx(&full[s], S::kBytes);
        const int row = i * kTile + h * kStageRows;
#pragma unroll
        for (int p = 0; p < MODE; ++p)
          tma_load(dst + p * kStageRows * kTile, maps[p], j * kTile, row,
                   &full[s]);
        tma_load(dst + MODE * kStageRows * kTile, &mmu, j * kTile, 0,
                 &full[s]);
        if (++s == S::kCount) {
          s = 0;
          parity ^= 1;
        }
      }
      if (++c == sc.tiles(i)) {
        c = 0;
        ++i;
      }
    }
    return;
  }

  // consumers
  float acc[2][kRowsPerWarp][3];
  float mi[2][kRowsPerWarp][3];
  int s = 0;
  uint32_t parity = 0;
  bool open = false;
  for (long long t = t0; t < t1; ++t) {
    const int j = i + c < sc.nr ? i + c : i + c - sc.nr;
    if (!open) {
      // this block's first tile of band i: zero the row sums, fetch mu
      // of the thread's rows
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int row = i * kTile + h * kStageRows + warp * kRowsPerWarp +
                          rr;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            acc[h][rr][k] = 0.f;
            mi[h][rr][k] = mu[static_cast<size_t>(k) * A + row];
          }
        }
      open = true;
    }
    const bool diag = c == 0;   // tile (I, I): its row sums cover it all
    float g[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mbar_wait(&full[s], parity);
      const float* st = stages + s * S::kFloats;
      if (diag)
        consume<MODE, false>(st, warp, lane, l, acc[h], mi[h], g);
      else
        consume<MODE, true>(st, warp, lane, l, acc[h], mi[h], g);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == S::kCount) {
        s = 0;
        parity ^= 1;
      }
    }
    if (!diag) {
      // column sums of tile J: the warps' partials added in warp order
      float* rw = red + warp * 3 * kTile;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        reinterpret_cast<float2*>(rw + k * kTile)[lane] =
            make_float2(g[0][k], g[1][k]);
      consumers_sync();
      if (threadIdx.x < 3 * kTile) {
        const int a = threadIdx.x / 3, k = threadIdx.x % 3;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          sum += red[(w * 3 + k) * kTile + a];
        scratch[((static_cast<size_t>(rslots) + c - 1) * A +
                 static_cast<size_t>(j) * kTile) * 3 + threadIdx.x] = sum;
      }
      consumers_sync();    // red is written again at the next tile
    }
    if (c + 1 == sc.tiles(i) || t + 1 == t1) {
      // leaving band i: fold the row sums over the lanes; lane 0 writes
      // them to this block's row slot of the band
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[h][rr][k] +=
                  __shfl_xor_sync(0xffffffffu, acc[h][rr][k], off);
      if (lane == 0) {
        const size_t slot = blockIdx.x - owner(sc.first(i), G, T);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            const size_t row = static_cast<size_t>(i) * kTile +
                               h * kStageRows + warp * kRowsPerWarp + rr;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              scratch[(slot * A + row) * 3 + k] = acc[h][rr][k];
          }
      }
      open = false;
    }
    if (++c == sc.tiles(i)) {
      c = 0;
      ++i;
    }
  }
}

// mu [A, 3] f64 -> mu32 [3, A] f32, the layout of the mu tensor map
__global__ void __launch_bounds__(256)
mu_soa_kernel(const double* __restrict__ mu, float* __restrict__ mu32,
              int A) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < 3 * A) mu32[(e % 3) * A + e / 3] = static_cast<float>(mu[e]);
}

// out[a, k] = -(the row slots of a's band, then column slots 1 .. nr/2) in
// f64; for even nr, slot nr/2 of the bands below nr/2 has no writer.  Part
// q of an entry adds its slots q, q + 4, ... in order, and the parts are
// added as (0 + 1) + (2 + 3).
__global__ void __launch_bounds__(256)
sum_sym_slots_kernel(const float* __restrict__ scratch,
                     double* __restrict__ out, int A, int rslots, int G) {
  constexpr int kEntries = 256 / kSumParts;
  __shared__ float part[kSumParts][kEntries];
  const Schedule sc(A);
  const long long T = sc.total();
  const size_t n = static_cast<size_t>(A) * 3;
  const int q = threadIdx.x / kEntries, el = threadIdx.x % kEntries;
  const size_t e = static_cast<size_t>(blockIdx.x) * kEntries + el;
  float acc = 0.f;
  if (e < n) {
    const int band = static_cast<int>(e / (3 * kTile));
    const long long f = sc.first(band);
    const int nrow =
        owner(f + sc.tiles(band) - 1, G, T) - owner(f, G, T) + 1;
    const int ncol = (sc.even && band < sc.half) ? sc.half - 1 : sc.half;
#pragma unroll 4
    for (int u = q; u < nrow + ncol; u += kSumParts) {
      const size_t slot = u < nrow ? u : rslots + (u - nrow);
      acc += scratch[slot * n + e];
    }
  }
  part[q][el] = acc;
  __syncthreads();
  if (q == 0 && e < n)
    out[e] = -static_cast<double>((part[0][el] + part[1][el]) +
                                  (part[2][el] + part[3][el]));
}

// Blocks of the persistent grid in MODE on the current device: all that
// fit at once.  Returns a CUDA error code (0 = ok).
template <int MODE>
int grid_blocks(int* blocks) {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev) {
    const int smem = static_cast<int>(Stage<MODE>::kSmem);
    err = cudaFuncSetAttribute(contract_sym_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, contract_sym_kernel<MODE>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached = sms * per_sm;
    cached_dev = dev;
  }
  *blocks = cached;
  return 0;
}

int grid_for(int mode, int A, int* G) {
  int rc;
  switch (mode) {
    case 3: rc = grid_blocks<3>(G); break;
    case 4: rc = grid_blocks<4>(G); break;
    case 5: rc = grid_blocks<5>(G); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  const long long T = Schedule(A).total();
  if (*G > T) *G = static_cast<int>(T);
  return 0;
}

}  // namespace

// Slots of the work buffer of a launch in `mode` at A (mu's f32 copy, the
// row slots, nr/2 column slots), or -1.
extern "C" int mpmcxx_contract_planes_sym_slots(int mode, int A) {
  if (A < kTile || A % kTile) return -1;
  int G = 0;
  if (grid_for(mode, A, &G)) return -1;
  const Schedule sc(A);
  return 1 + row_slots(sc, G) + sc.half;
}

// planes: host array of `mode` device pointers to [A, A] f32 row-major
// planes, 16-byte aligned, A a multiple of 64; mu: device [A, 3] f64;
// work: device [slots, A, 3] f32 with slots from
// mpmcxx_contract_planes_sym_slots (overwritten where read); out: device
// [A, 3] f64, gets -T mu.  Launches the three passes on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_contract_planes_sym(const void* const* planes,
                                          int mode, const double* mu,
                                          float l, float* work, int slots,
                                          double* out, int A, void* stream) {
  if (A < kTile || A % kTile) return static_cast<int>(cudaErrorInvalidValue);
  int G = 0;
  const int rc = grid_for(mode, A, &G);
  if (rc) return rc;
  const Schedule sc(A);
  const int rslots = row_slots(sc, G);
  if (slots != 1 + rslots + sc.half)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(A) * 3;
  float* mu32 = work;
  float* scratch = work + n;
  // one map per plane (unused ones repeat plane 0) and one for mu
  EncodeTiled enc = nullptr;
  int e = encoder(&enc);
  if (e) return e;
  CUtensorMap m[6];
  for (int k = 0; k < 5 && !e; ++k)
    e = tensor_map(enc, &m[k], planes[k < mode ? k : 0], A, A, kStageRows,
                   kTile);
  if (!e) e = tensor_map(enc, &m[5], mu32, 3, A, 3, kTile);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mu_soa_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      mu, mu32, A);
  switch (mode) {
    case 3:
      contract_sym_kernel<3><<<G, kThreads, Stage<3>::kSmem, s>>>(
          m[0], m[1], m[2], m[3], m[4], m[5], mu32, l, scratch, A, rslots,
          G);
      break;
    case 4:
      contract_sym_kernel<4><<<G, kThreads, Stage<4>::kSmem, s>>>(
          m[0], m[1], m[2], m[3], m[4], m[5], mu32, l, scratch, A, rslots,
          G);
      break;
    default:
      contract_sym_kernel<5><<<G, kThreads, Stage<5>::kSmem, s>>>(
          m[0], m[1], m[2], m[3], m[4], m[5], mu32, l, scratch, A, rslots,
          G);
      break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_sym_slots_kernel<<<static_cast<unsigned>(
                             (n + 256 / kSumParts - 1) / (256 / kSumParts)),
                         256, 0, s>>>(scratch, out, A, rslots, G);
  return static_cast<int>(cudaGetLastError());
}
