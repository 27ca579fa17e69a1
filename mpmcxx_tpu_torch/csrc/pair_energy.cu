// Kernel K6: the pair sums of the blocked full recompute
// (mpmcxx_tpu_torch/ops/energy.py energy_breakdown_blocked) in one launch:
// over the upper pair triangle (col > row) of live atoms, in float64,
//   rd    Lennard-Jones with Lorentz-Berthelot mixing, as
//         ops/pair_potentials.lj(..., pair_only=True): the cutoff test
//         rimg - SMALL_dR < cutoff, rd exclusions (same molecule, or a null
//         LJ pair whose dispersion coefficients are all zero), frozen pairs
//         out, the Feynman-Hibbs correction of order 2 or 4, the
//         cavity_autoreject MAXVALUE, and the long-range correction's pair
//         part (every live, unfrozen, non-SPECTRE pair with a nonzero mixed
//         epsilon and sigma, same molecule included, no cutoff);
//   es    the Ewald real-space sum ops/ewald.coulombic_real: q_i q_j
//         erfc(alpha r) / r within the cutoff over pairs that are not
//         es-excluded, plus its Feynman-Hibbs correction, minus
//         q_i q_j erf(alpha r) / r at the unwrapped distance over
//         same-molecule pairs;
//   close whether an inter-molecular pair lies closer than the absolute
//         cavity scale (ops/cuda_pairs.close_pairs).
// The minimum image is pbc.minimum_image_disp's: fractional coordinates
// through the reciprocal basis, rint (half to even, as torch.round), with
// the NaN guard that takes the real distance.  The geometry and the
// mixing are written in round-to-nearest steps that nvcc may not contract
// into FMAs, so every distance, mixed parameter and threshold test is
// bitwise that of the plain version (ops/cuda_pairs.pair_sums_plain); the
// energies differ from it only in rounding and summation order.
//
// Replaces no TPU kernel: the JAX package's blocked energy is XLA over
// row tiles (mpmcxx_tpu/ops/energy.py energy_breakdown_blocked), which
// the port ran as ~25 [256, A] float64 pair tensors a tile and dozens of
// elementwise launches over each (~10^4 launches a sweep).
//
// Bound: float64 arithmetic on the CUDA cores (the tensor cores have no
// erfc): the minimum image of every live pair (45 operations) and the
// terms of those within the cutoff, about 70-80 operations a live pair on
// the benchmark's cells when erfc, exp, sqrt and a division count one
// each; the inputs are a few per-atom vectors, so the bytes are
// negligible.  Design:
// - One block a tile pair (I <= J) of 128 x 128 slots, a linear grid over
//   the tile triangle.  A block compacts the live atoms of its row tile and
//   of its column tile into shared memory (warp ballot + popc, in slot
//   order), so dead capacity costs a byte read; a thread takes one live row
//   atom in registers and walks the live columns (each shared read is a
//   broadcast).  A tile with no live row or column returns zeros.
// - Each thread sums its row's pairs in column order; the block reduces by
//   warp shuffles and then warp by warp, and writes one [rd, es, close]
//   partial a tile.  A second one-block kernel sums the partials in a fixed
//   order: no atomics, so a call repeats bitwise.
// - Templated on the Feynman-Hibbs order (0, 2, 4) and on whether the
//   electrostatics are on, so the plain LJ + Ewald sweep carries no FH
//   registers; LRC and the cavity checks are block-uniform branches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 128;          // slots a tile side; one row a thread
constexpr int kWarps = kTile / 32;
constexpr int kSumThreads = 256;

// per-atom bits (ops/cuda_pairs.py atom_bits)
constexpr unsigned kAlive = 1u, kFrozen = 2u, kSpectre = 4u, kCnZero = 8u;

// host scalars, in the order of ops/cuda_pairs.py _consts
struct Consts {
  double alpha;      // Ewald alpha
  double cav_scale;  // cavity_autoreject_scale
  double sqrt_pi, pi;
  double m2a2, hbar2, kb;   // Feynman-Hibbs order 2
  double m2a4, hbar4, kb2;  // order 4
  double amu2kg, maxvalue, small_dr;
};
constexpr int kNumConsts = 13;
static_assert(sizeof(Consts) == kNumConsts * sizeof(double), "Consts");

struct Atoms {
  const double* pos;      // [A, 3]
  const double* charge;   // [A]
  const double* sigma;    // [A]
  const double* epsilon;  // [A]
  const double* mmass;    // [A] mass of the atom's molecule (amu)
  const int64_t* mol_id;  // [A]
  const uint8_t* bits;    // [A] kAlive | kFrozen | kSpectre | kCnZero
};

// one tile side staged in shared memory, live atoms only, in slot order
struct Side {
  double x[kTile], y[kTile], z[kTile], q[kTile], sig[kTile], eps[kTile],
      mm[kTile];
  int mol[kTile], idx[kTile];
  unsigned char bits[kTile];
};

__device__ __forceinline__ long long pair_offset(long long I, long long nt) {
  return I * nt - I * (I - 1) / 2;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Stage slot `a`'s atom (when live) into `s` at its compacted place.
// Returns the side's live count; every thread of the block calls it.
__device__ __forceinline__ int stage(const Atoms& at, int a, int A, Side& s,
                                     int* warp_live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = a < A ? at.bits[a] : 0u;
  const bool live = (b & kAlive) != 0u;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int k = warp_live[w];
    before += w < warp ? k : 0;
    n += k;
  }
  if (live) {
    const int k = before + __popc(ballot & ((1u << lane) - 1u));
    const size_t a3 = 3 * static_cast<size_t>(a);
    s.x[k] = at.pos[a3];
    s.y[k] = at.pos[a3 + 1];
    s.z[k] = at.pos[a3 + 2];
    s.q[k] = at.charge[a];
    s.sig[k] = at.sigma[a];
    s.eps[k] = at.epsilon[a];
    s.mm[k] = at.mmass[a];
    s.mol[k] = static_cast<int>(at.mol_id[a]);
    s.idx[k] = a;
    s.bits[k] = static_cast<unsigned char>(b);
  }
  __syncthreads();
  return n;
}

// pair_potentials.lj_fh_corr for Lorentz-Berthelot LJ
template <int kFH>
__device__ __forceinline__ double lj_fh(double rimg, double t12, double t6,
                                        double eps, double rm,
                                        const Consts& c, double k24t,
                                        double k1152) {
  const double ir = rimg == 0.0 ? 1.0 : 1.0 / rimg;
  const double ir2 = ir * ir, ir3 = ir2 * ir, ir4 = ir2 * ir2;
  const double dE = -24.0 * eps * (2.0 * t12 - t6) * ir;
  const double d2E = 24.0 * eps * (26.0 * t12 - 7.0 * t6) * ir2;
  double corr = c.m2a2 * (c.hbar2 / (k24t * rm)) * (d2E + 2.0 * dE * ir);
  if (kFH >= 4) {
    const double d3E = -1344.0 * eps * (6.0 * t12 - t6) * ir3;
    const double d4E = 12096.0 * eps * (10.0 * t12 - t6) * ir4;
    corr += c.m2a4 * (c.hbar4 / (k1152 * rm * rm)) *
            (15.0 * dE * ir3 + 4.0 * d3E * ir + d4E);
  }
  return corr;
}

// ewald.coulombic_real_fh at r (rimg, or 1 where rimg == 0)
template <int kFH>
__device__ __forceinline__ double coul_fh(double r, double erfc_t, double g,
                                          double rm, const Consts& c,
                                          double k24t, double k1152) {
  const double a = c.alpha, a2 = a * a, a3 = a2 * a, a4 = a3 * a;
  const double rr = r * r, ir = 1.0 / r;
  const double ir2 = ir * ir, ir3 = ir2 * ir, ir4 = ir2 * ir2;
  const double du = -2.0 * a * g / (r * c.sqrt_pi) - erfc_t * ir2;
  const double d2u =
      (4.0 / c.sqrt_pi) * g * (a3 + 1.0 * ir2) + 2.0 * erfc_t * ir3;
  double fh = c.m2a2 * (c.hbar2 / (k24t * rm)) * (d2u + 2.0 * du / r);
  if (kFH >= 4) {
    const double d3u =
        (g / c.sqrt_pi) * (-8.0 * (a3 * a2) * r - 8.0 * a3 / r -
                           12.0 * a * ir3) - 6.0 * erfc_t * ir4;
    const double d4u =
        (g / c.sqrt_pi) * (8.0 * a3 * a2 + 16.0 * a3 * a4 * rr +
                           32.0 * a3 * ir2 + 48.0 * ir4) +
        24.0 * erfc_t * (ir4 * ir);
    fh += c.m2a4 * (c.hbar4 / (k1152 * rm * rm)) *
          (15.0 * du * ir3 + 4.0 * d3u / r + d4u);
  }
  return fh;
}

// box: device [21] = basis (9, row-major), reciprocal (9), cutoff, volume,
// temperature.  partial: device [pairs, 3], one row a tile pair.
template <int kFH, bool kES>
__global__ void __launch_bounds__(kTile)
pair_energy_kernel(Atoms at, const double* __restrict__ box, Consts c,
                   int lrc, int cav_rel, int cav_abs, int A, int nt,
                   double* __restrict__ partial) {
  __shared__ Side rows, cols;
  __shared__ int warp_live[kWarps];
  __shared__ double red[2][kWarps];

  // decode (I, J), I <= J, from the linear tile-pair index
  const long long t = blockIdx.x;
  const double n2 = 2.0 * nt + 1.0;
  long long I = static_cast<long long>((n2 - sqrt(n2 * n2 - 8.0 * t)) * 0.5);
  if (I < 0) I = 0;
  if (I > nt - 1) I = nt - 1;
  while (I > 0 && pair_offset(I, nt) > t) --I;
  while (I + 1 < nt && pair_offset(I + 1, nt) <= t) ++I;
  const long long J = I + (t - pair_offset(I, nt));
  const bool diag = I == J;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rows = stage(at, static_cast<int>(I) * kTile + tid, A, rows,
                           warp_live);
  const int n_cols = stage(at, static_cast<int>(J) * kTile + tid, A, cols,
                           warp_live);

  double rd = 0.0, es = 0.0;
  int close = 0;
  if (tid < n_rows && n_cols > 0) {
    const int i = rows.idx[tid];
    const double xi = rows.x[tid], yi = rows.y[tid], zi = rows.z[tid];
    const double qi = rows.q[tid], sgi = rows.sig[tid], epi = rows.eps[tid];
    const double mmi = rows.mm[tid];
    const int moli = rows.mol[tid];
    const unsigned bi = rows.bits[tid];
    double B[9], R[9];
#pragma unroll
    for (int p = 0; p < 9; ++p) {
      B[p] = box[p];
      R[p] = box[9 + p];
    }
    const double cutoff = box[18], volume = box[19], temp = box[20];
    const double k24t = 24.0 * c.kb * temp;
    const double k1152 = 1152.0 * c.kb2 * temp * temp;
    const double lrc_pre = (16.0 / 3.0) * c.pi;
    for (int k = 0; k < n_cols; ++k) {
      if (diag && cols.idx[k] <= i) continue;
      const unsigned bj = cols.bits[k];
      const bool same = moli == cols.mol[k];
      const bool frozen = (bi & bj & kFrozen) != 0u;
      const double d[3] = {__dsub_rn(xi, cols.x[k]), __dsub_rn(yi, cols.y[k]),
                           __dsub_rn(zi, cols.z[k])};
      double img[3], di[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        img[q] = rint(__dadd_rn(__dadd_rn(__dmul_rn(d[0], R[q]),
                                          __dmul_rn(d[1], R[3 + q])),
                                __dmul_rn(d[2], R[6 + q])));
#pragma unroll
      for (int q = 0; q < 3; ++q)
        di[q] = __dsub_rn(d[q], __dadd_rn(__dadd_rn(__dmul_rn(img[0], B[q]),
                                                    __dmul_rn(img[1], B[3 + q])),
                                          __dmul_rn(img[2], B[6 + q])));
      double rimg = __dsqrt_rn(__dadd_rn(
          __dadd_rn(__dmul_rn(di[0], di[0]), __dmul_rn(di[1], di[1])),
          __dmul_rn(di[2], di[2])));
      const double r2 = __dadd_rn(
          __dadd_rn(__dmul_rn(d[0], d[0]), __dmul_rn(d[1], d[1])),
          __dmul_rn(d[2], d[2]));
      // NaN guard (src/System.cpp:1265-1270): a bad image takes the real
      // distance
      if (!isfinite(rimg)) rimg = __dsqrt_rn(r2);
      double rm = 0.0;
      if (kFH) {
        const double mmj = cols.mm[k], msum = __dadd_rn(mmi, mmj);
        rm = c.amu2kg * (mmi * mmj / (msum == 0.0 ? 1.0 : msum));
      }

      if (!frozen) {
        // Lorentz-Berthelot (src/System.cpp:1166-1177): an attractive-only
        // pair keeps epsilon 0
        const double sgj = cols.sig[k], epj = cols.eps[k];
        const bool attractive = sgi < 0.0 || sgj < 0.0;
        const bool sig_zero = sgi == 0.0 || sgj == 0.0;
        const double sigma =
            attractive ? __dmul_rn(0.5, __dadd_rn(fabs(sgi), fabs(sgj)))
                       : (sig_zero ? 0.0 : __dmul_rn(0.5, __dadd_rn(sgi, sgj)));
        const double eps = attractive ? 0.0 : __dsqrt_rn(__dmul_rn(epi, epj));
        const double abs_sig = fabs(sigma);
        const bool lj_null = epi == 0.0 || sgi == 0.0 || epj == 0.0 ||
                             sgj == 0.0;
        const bool rd_excluded = same || (lj_null && (bi & bj & kCnZero));
        if (!rd_excluded && __dsub_rn(rimg, c.small_dr) < cutoff) {
          const double sor = rimg == 0.0 ? abs_sig : abs_sig / rimg;
          const double s2 = sor * sor, s6 = s2 * s2 * s2;
          const double t12 = attractive ? 0.0 : s6 * s6;
          double pot = 4.0 * eps * (t12 - s6);
          if (kFH) pot += lj_fh<kFH>(rimg, t12, s6, eps, rm, c, k24t, k1152);
          if (cav_rel && rimg < __dmul_rn(c.cav_scale, abs_sig))
            pot = c.maxvalue;
          rd += pot;
        }
        if (lrc && !(bi & bj & kSpectre) && eps != 0.0 && sigma != 0.0) {
          const double sig_cut = abs_sig / cutoff;
          const double sig3 = abs_sig * abs_sig * abs_sig;
          const double sc3 = sig_cut * sig_cut * sig_cut;
          const double sc9 = sc3 * sc3 * sc3;
          rd += lrc_pre * eps * sig3 * ((1.0 / 3.0) * sc9 - sc3) / volume;
        }

        if (kES) {
          const double qj = cols.q[k];
          if (qi != 0.0 && qj != 0.0) {
            if (!same) {
              if (!(rimg > cutoff)) {
                const double r = rimg == 0.0 ? 1.0 : rimg;
                const double erfc_t = erfc(c.alpha * r);
                double pot = qi * qj * erfc_t / r;
                if (kFH)
                  pot += coul_fh<kFH>(r, erfc_t,
                                      exp(-c.alpha * c.alpha * r * r), rm, c,
                                      k24t, k1152);
                es += pot;
              }
            } else {
              // the screening-charge correction of excluded pairs, at the
              // real (unwrapped) distance (src/System.Energy.cpp:1504)
              double rr = __dsqrt_rn(r2);
              rr = rr == 0.0 ? 1.0 : rr;
              es -= qi * qj * erf(c.alpha * rr) / rr;
            }
          }
        }
      }
      if (cav_abs && !same && rimg < c.cav_scale) close = 1;
    }
  }

  rd = warp_sum(rd);
  es = warp_sum(es);
  const int any_close = __syncthreads_or(close);
  if (lane == 0) {
    red[0][warp] = rd;
    red[1][warp] = es;
  }
  __syncthreads();
  if (tid == 0) {
    double s_rd = 0.0, s_es = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s_rd += red[0][w];
      s_es += red[1][w];
    }
    double* out = partial + 3 * t;
    out[0] = s_rd;
    out[1] = s_es;
    out[2] = any_close ? 1.0 : 0.0;
  }
}

// out[0] = sum of rd partials, out[1] = of es, out[2] = max of close, each
// in one fixed order
__global__ void __launch_bounds__(kSumThreads)
pair_sum_kernel(const double* __restrict__ partial, long long pairs,
                double* __restrict__ out) {
  constexpr int kW = kSumThreads / 32;
  __shared__ double red[3][kW];
  double rd = 0.0, es = 0.0, close = 0.0;
  for (long long p = threadIdx.x; p < pairs; p += kSumThreads) {
    rd += partial[3 * p];
    es += partial[3 * p + 1];
    close = fmax(close, partial[3 * p + 2]);
  }
  rd = warp_sum(rd);
  es = warp_sum(es);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    close = fmax(close, __shfl_down_sync(0xffffffffu, close, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = rd;
    red[1][warp] = es;
    red[2][warp] = close;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s_rd = 0.0, s_es = 0.0, s_close = 0.0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      s_rd += red[0][w];
      s_es += red[1][w];
      s_close = fmax(s_close, red[2][w]);
    }
    out[0] = s_rd;
    out[1] = s_es;
    out[2] = s_close;
  }
}

template <int kFH, bool kES>
void launch(const Atoms& at, const double* box, const Consts& c, int lrc,
            int cav_rel, int cav_abs, int A, int nt, long long pairs,
            double* partial, cudaStream_t s) {
  pair_energy_kernel<kFH, kES><<<static_cast<unsigned>(pairs), kTile, 0, s>>>(
      at, box, c, lrc, cav_rel, cav_abs, A, nt, partial);
}

}  // namespace

// The tile side (slots); partial holds 3 doubles for each of the
// nt (nt + 1) / 2 tile pairs, nt = ceil(A / tile).
extern "C" int mpmcxx_pair_energy_tile() { return kTile; }

// pos [A, 3], charge, sigma, epsilon, mmass [A] f64; mol_id [A] int64;
// bits [A] bytes; box [21] f64 (see pair_energy_kernel), all device;
// consts: host array of kNumConsts doubles in Consts' order; fh_order 0, 2
// or 4; partial: device [pairs, 3] f64 scratch (fully overwritten); out:
// device [3] f64 = (rd, es, close as 0 or 1).  Launches both passes on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mpmcxx_pair_energy(const double* pos, const double* charge,
                                  const double* sigma, const double* epsilon,
                                  const double* mmass, const int64_t* mol_id,
                                  const uint8_t* bits, const double* box,
                                  const double* consts, int fh_order,
                                  int use_es, int lrc, int cav_rel,
                                  int cav_abs, int A, double* partial,
                                  double* out, void* stream) {
  if (A <= 0 || (fh_order != 0 && fh_order != 2 && fh_order != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (A + kTile - 1) / kTile;
  const long long pairs = static_cast<long long>(nt) * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  const Atoms at{pos, charge, sigma, epsilon, mmass, mol_id, bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fh_order * 2 + (use_es != 0)) {
    case 0: launch<0, false>(at, box, c, lrc, cav_rel, cav_abs, A, nt, pairs,
                             partial, s); break;
    case 1: launch<0, true>(at, box, c, lrc, cav_rel, cav_abs, A, nt, pairs,
                            partial, s); break;
    case 4: launch<2, false>(at, box, c, lrc, cav_rel, cav_abs, A, nt, pairs,
                             partial, s); break;
    case 5: launch<2, true>(at, box, c, lrc, cav_rel, cav_abs, A, nt, pairs,
                            partial, s); break;
    case 8: launch<4, false>(at, box, c, lrc, cav_rel, cav_abs, A, nt, pairs,
                             partial, s); break;
    default: launch<4, true>(at, box, c, lrc, cav_rel, cav_abs, A, nt, pairs,
                             partial, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_sum_kernel<<<1, kSumThreads, 0, s>>>(partial, pairs, out);
  return static_cast<int>(cudaGetLastError());
}
