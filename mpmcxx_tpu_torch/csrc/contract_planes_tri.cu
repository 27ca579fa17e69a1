// Kernel K4: the SCF dipole contraction over the tile triangle
//     ef_i = sum_j [ s_ij d_ij + cd_ij mu_j ],   s_ij = co_ij (d_ij . mu_j)
// over the 3-, 4- or 5-plane f32 tuple of ops/polar.py fold_outer_rows
// (the caller negates: -T mu), with the per-pair arithmetic of K1
// (csrc/contract_planes.cu): mode 3 recomputes co, cd from the masked
// displacements, mode 4 is (cd, sx, sy, sz) with s = -(s . mu), mode 5 is
// (co, cd, dx, dy, dz).
//
// Replaces the TPU kernel mpmcxx_tpu/ops/pallas_polar.py
// contract_pallas_tri (the exact i <= j tile triangle, selected there by
// MPMCXX_TRI_KERNEL=1).
//
// Precondition: T is symmetric, i.e. d is antisymmetric and co, cd are
// symmetric (what fold_outer_rows builds and the in-place commits keep).
// Then T_ji mu_i = co_ij d_ij (d_ij . mu_i) + cd_ij mu_i, so one b x b tile
// (I, J) of the planes serves both ef_i += T_ij mu_j (row sums) and
// ef_j += T_ji mu_i (column sums).
//
// Bound: device-memory bytes.  Each unordered tile pair I <= J of every
// plane is read once: P x 4 x (A^2/2 + A b/2) bytes, 0.70 GB in mode 3 at
// A = 10,752, about half of K1's full-plane pass, against ~45 flops and one
// expf per pair.  The scratch below adds 2 x nr x A x 12 bytes (6 % at
// that width).
//
// Design: one block of 256 threads per tile pair, decoded from the linear
// block index (row-major over I <= J; no index table).  The mu of the row
// tile and of the column tile sit in shared memory.  Warp w walks the
// contiguous rows 8 w .. 8 w + 7 of the tile; its lanes take columns lane
// and lane + 32, so
// each plane load is a coalesced 128-byte line.  The coefficients of a
// pair are computed once and feed both directions.  A row's sum is folded
// across the warp with shuffles; a column's sum over the warp's rows stays
// in registers and the eight warps' partials are added in warp order in
// shared memory.  No float atomics: block (I, J) writes its row sums to
// scratch slot J of the rows of I and, off the diagonal, its column sums
// to slot I of the columns of J.  Every (slot, atom) entry has exactly one
// writer, and a second launch adds the nr slots of each atom in slot
// order, so the result repeats bitwise from run to run.  The ragged last
// tile is masked (missing entries read as 0, which contribute nothing in
// any mode).  Math and sums are f32, as on the TPU.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;

// The first row-tile index I of linear pair t, where row I holds the
// pairs (I, I), ..., (I, nr - 1) and starts at off(I) = I nr - I (I - 1) / 2.
__device__ __forceinline__ long long pair_offset(long long I, long long nr) {
  return I * nr - I * (I - 1) / 2;
}

template <int MODE>
__device__ __forceinline__ void load_pair(const float* __restrict__ p0,
                                          const float* __restrict__ p1,
                                          const float* __restrict__ p2,
                                          const float* __restrict__ p3,
                                          const float* __restrict__ p4,
                                          size_t k, float l, float& dx,
                                          float& dy, float& dz, float& co,
                                          float& cd) {
  if (MODE == 3) {
    dx = p0[k];
    dy = p1[k];
    dz = p2[k];
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
    co = 0.f;
    cd = p0[k];
    dx = p1[k];
    dy = p2[k];
    dz = p3[k];
  } else {
    co = p0[k];
    cd = p1[k];
    dx = p2[k];
    dy = p3[k];
    dz = p4[k];
  }
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
contract_tri_kernel(const float* __restrict__ p0,
                    const float* __restrict__ p1,
                    const float* __restrict__ p2,
                    const float* __restrict__ p3,
                    const float* __restrict__ p4,
                    const float* __restrict__ mu, float l,
                    float* __restrict__ scratch, int A, int nr) {
  __shared__ float mu_i[3][kTile];          // mu of the row tile I
  __shared__ float mu_j[3][kTile];          // mu of the column tile J
  __shared__ float col_part[kWarps][kTile][3];
  __shared__ float row_sum[kTile][3];

  // decode (I, J), I <= J, from the linear pair index
  const long long t = blockIdx.x;
  const double n2 = 2.0 * nr + 1.0;
  long long I = static_cast<long long>((n2 - sqrt(n2 * n2 - 8.0 * t)) * 0.5);
  if (I < 0) I = 0;
  if (I > nr - 1) I = nr - 1;
  while (I > 0 && pair_offset(I, nr) > t) --I;
  while (I + 1 < nr && pair_offset(I + 1, nr) <= t) ++I;
  const long long J = I + (t - pair_offset(I, nr));
  const bool diag = I == J;
  const int i0 = static_cast<int>(I) * kTile;
  const int j0 = static_cast<int>(J) * kTile;

  const int tid = threadIdx.x;
  if (tid < 3 * kTile) {
    const int c = tid / kTile, k = tid % kTile;
    const size_t off = static_cast<size_t>(c) * A;
    mu_i[c][k] = i0 + k < A ? mu[off + i0 + k] : 0.f;
    mu_j[c][k] = j0 + k < A ? mu[off + j0 + k] : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = lane, c1 = lane + 32;
  const bool ok0 = j0 + c0 < A, ok1 = j0 + c1 < A;
  const float mx0 = mu_j[0][c0], my0 = mu_j[1][c0], mz0 = mu_j[2][c0];
  const float mx1 = mu_j[0][c1], my1 = mu_j[1][c1], mz1 = mu_j[2][c1];
  float gx0 = 0.f, gy0 = 0.f, gz0 = 0.f;    // column sums, column c0
  float gx1 = 0.f, gy1 = 0.f, gz1 = 0.f;    // column sums, column c1

#pragma unroll 2
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int gi = i0 + r;
    const size_t base = static_cast<size_t>(gi) * A + j0;
    float ex = 0.f, ey = 0.f, ez = 0.f;
    const float mxi = mu_i[0][r], myi = mu_i[1][r], mzi = mu_i[2][r];
    if (gi < A) {
      float dx, dy, dz, co, cd;
      if (ok0) {
        load_pair<MODE>(p0, p1, p2, p3, p4, base + c0, l, dx, dy, dz, co,
                        cd);
        add_t_mu<MODE>(dx, dy, dz, co, cd, mx0, my0, mz0, ex, ey, ez);
        add_t_mu<MODE>(dx, dy, dz, co, cd, mxi, myi, mzi, gx0, gy0, gz0);
      }
      if (ok1) {
        load_pair<MODE>(p0, p1, p2, p3, p4, base + c1, l, dx, dy, dz, co,
                        cd);
        add_t_mu<MODE>(dx, dy, dz, co, cd, mx1, my1, mz1, ex, ey, ez);
        add_t_mu<MODE>(dx, dy, dz, co, cd, mxi, myi, mzi, gx1, gy1, gz1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ex += __shfl_down_sync(0xffffffffu, ex, off);
      ey += __shfl_down_sync(0xffffffffu, ey, off);
      ez += __shfl_down_sync(0xffffffffu, ez, off);
    }
    if (lane == 0) {
      row_sum[r][0] = ex;
      row_sum[r][1] = ey;
      row_sum[r][2] = ez;
    }
  }
  col_part[warp][c0][0] = gx0;
  col_part[warp][c0][1] = gy0;
  col_part[warp][c0][2] = gz0;
  col_part[warp][c1][0] = gx1;
  col_part[warp][c1][1] = gy1;
  col_part[warp][c1][2] = gz1;
  __syncthreads();

  // 3 kTile consecutive floats per slot: thread tid writes (atom tid / 3,
  // component tid % 3), so each store is one contiguous run
  if (tid < 3 * kTile) {
    const int a = tid / 3, c = tid % 3;
    if (i0 + a < A)
      scratch[(static_cast<size_t>(J) * A + i0) * 3 + tid] = row_sum[a][c];
    if (!diag && j0 + a < A) {
      float g = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) g += col_part[w][a][c];
      scratch[(static_cast<size_t>(I) * A + j0) * 3 + tid] = g;
    }
  }
}

// out[a, c] = sum over slots s = 0 .. nr - 1, in order, of scratch[s, a, c]
__global__ void __launch_bounds__(kThreads)
sum_slots_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                 int A, int nr) {
  const size_t n = static_cast<size_t>(A) * 3;
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int s = 0; s < nr; ++s) acc += scratch[static_cast<size_t>(s) * n + e];
  out[e] = acc;
}

}  // namespace

// planes: host array of `mode` device pointers to [A, A] f32 row-major
// planes; mu: device [3, A] f32; scratch: device [nr, A, 3] f32 with
// nr = ceil(A / 64) (fully overwritten); out: device [A, 3] f32.  Launches
// both passes on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_contract_planes_tri(const void* const* planes,
                                          int mode, const float* mu,
                                          float l, float* scratch,
                                          float* out, int A, void* stream) {
  if (A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < mode && i < 5; ++i)
    p[i] = static_cast<const float*>(planes[i]);
  const int nr = (A + kTile - 1) / kTile;
  const long long pairs = static_cast<long long>(nr) * (nr + 1) / 2;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(pairs));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 3:
      contract_tri_kernel<3><<<grid, block, 0, s>>>(
          p[0], p[1], p[2], p[3], p[4], mu, l, scratch, A, nr);
      break;
    case 4:
      contract_tri_kernel<4><<<grid, block, 0, s>>>(
          p[0], p[1], p[2], p[3], p[4], mu, l, scratch, A, nr);
      break;
    case 5:
      contract_tri_kernel<5><<<grid, block, 0, s>>>(
          p[0], p[1], p[2], p[3], p[4], mu, l, scratch, A, nr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(A) * 3;
  sum_slots_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, s>>>(scratch, out, A, nr);
  return static_cast<int>(cudaGetLastError());
}
