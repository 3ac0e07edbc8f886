// Fused beam-gain maps for Hopper: per-path scalars and a codebook in,
// G = |conj(W) . H|^2 out, H never formed.
//
// Replaces the TPU kernel deepmimo_tpu/ops/pallas/beamgain.py::_bg_kernel
// (and _bg_kernel_norx; wrapper _fused_beam_gain_impl). For one user u, with
// TX element t = n*T1 + m, RX element r = n_r*R1 + m_r, beam b, output row
// q = r*B + b and output column kk = s*K + k:
//
//   a_tx[t, p] = exp(j (m gty[p] + n gtz[p]))
//   a_rx[r, p] = exp(j (m_r gry[p] + n_r grz[p]))          (R > 1 only)
//   eb[p, b]   = sum_t conj(w[b, t]) a_tx[t, p]             (codebook fold)
//   E[p, q]    = a_rx[r, p] eb[p, b]
//   g[p, kk]   = amp[s or 0, p] exp(j (psi[s, p] - omega[p] k))
//   G[q, kk]   = |sum_p E[p, q] g[p, kk]|^2
//
// which is beamgain.py::beam_gain_reference: y = conj(W) . H with
// H = (a_rx (x) a_tx) g, so G matches np.abs(H @ W.conj().T)**2.
//
// What bounds it on an H100: at the headline (131,072 users, P = 25,
// T = 64, B = 16, R = 1, K = 64) a user does B*T*P complex MACs in the fold
// and R*B*S*K*P in the path sum, 2 x 102,400 FP32 FMA: 0.81 ms at the FP32
// rate of 67 TFLOP/s, 0.33 ms if the card ran them at 3xTF32 on its tensor
// cores at the nominal 495 TFLOP/s. Its output is 0.54 GB, 0.16 ms at
// 3.35 TB/s. So it is bound by operations, and at these shapes by the
// instructions the SMs issue around them: the products are small (a user's
// fold is [P x T] . [T x B]) and mma.sync TF32 runs at half its nominal rate
// here (PERF.md), so the products run as FP32 FMA on the SIMT pipes and the
// design cuts everything else that is issued beside them.
//
// Design:
//   - persistent blocks of up to 8 warps, sized by the occupancy calculator;
//     a warp takes one user at a time (u = warp, warp + warps in the grid,
//     ...) and synchronises only with __syncwarp. Ragged U and U below the
//     number of warps need no mask beyond the loop bound;
//   - conj(W), interleaved [T][B] (re, im) by the wrapper, is staged in
//     shared memory once per block, after the only __syncthreads;
//   - paths run in chunks of 32 (8 when a large codebook leaves no room for
//     32-row buffers), lane = path for the trig and the fold, so that shared
//     memory does not grow with P. Each warp owns two [chunk][18] float2
//     buffers: E of one 16-row tile and the OFDM tables of one slot and one
//     64-column tile (rows padded to 18 so that a lane's 16-byte stores of
//     its row are free of bank conflicts);
//   - separable trig, as the JAX kernel's _response and _ofdm_tables
//     (deepmimo_tpu/ops/pallas/render.py:339, :387) and render_tables.cuh:
//     a_tx = ey[m % 8] * exp(j ((m - m % 8) gty + n gtz)) from 8 + t2
//     sincosf (plus one per block of 8 when T1 > 8), and
//     g = fine[k % 8] * coarse[s, k / 8] from 8 + 8 per slot and column
//     tile: 32 full-range sincosf per path at the headline instead of 128.
//     No inner loop divides by a runtime value;
//   - the fold: lane p keeps 16 complex accumulators (one per beam of the
//     tile) and reads conj(W) as warp-broadcast 16-byte loads, 2 beams per
//     load; its epilogue multiplies by a_rx (R > 1) and stores E;
//   - the path sum: lane (qg, kg) of the warp holds 8 rows x 4 columns of
//     complex accumulators; per path it reads 8 rows of E in four 16-byte
//     broadcasts, and fine and coarse in one 16-byte and two 8-byte loads,
//     and builds its four g from them: 7 shared loads and 16 products feed
//     128 FMA. The |y|^2 epilogue stores 8-byte pairs of adjacent columns,
//     coalesced along the row, with streaming stores;
//   - with one chunk (P <= 32) E is folded once per user and tile and kept
//     for every slot and column tile; with more, the chunks accumulate in
//     registers and E is folded again per slot and column tile.
// Mode (template argument kBf16, matmul_dtype "bfloat16"/"default"): the
// path sum's operands, E = a_rx eb and g, are rounded to bf16 (RNE) before
// its FP32 FMAs, as the TPU kernel rounds e2 and g2 for its one-pass dot
// (beamgain.py:132-135). The products of two bf16 values are exact in
// FP32, so this is a one-pass bf16 product with f32 accumulation. The
// codebook fold stays f32 grade: the TPU kernel runs it at HIGHEST for
// "float32", and at DEFAULT, one pass on the TPU, for the bf16 modes; on
// the CPU (the interpret mode the port is held against) DEFAULT is f32.
// Invalid paths arrive with zero amp and zero phases from the wrapper.
// Scalar type (template argument F, float or double): complex128 configs
// run the same kernel in float64 (FP64 FMA, sincos), as the JAX package
// sends them to the same TPU kernel. Every buffer holds complex values of
// F, so conj(W) and the warps' buffers take twice the shared memory, and
// with twice the registers per accumulator the float64 instantiations run
// one block of 8 warps per SM. No bf16 mode in float64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRows = 16;        // output rows (beams of one RX element)
constexpr int kCols = 64;        // output columns (subcarriers) per tile
constexpr int kPitch = 18;       // complex entries per row of a warp's buffers
constexpr int kL = 8;            // k = k2*kL + k1; TX m in blocks of kL
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block

// The complex type of scalar F: float2 or double2.
template <typename F>
using C2 = std::conditional_t<std::is_same_v<F, float>, float2, double2>;

// Entries of C2<F> that conj(W) [T][B] takes in shared memory, rounded up so
// that the buffers after it are 16-byte aligned.
template <typename F>
__host__ __device__ size_t cw_entries(size_t tb) {
  return sizeof(C2<F>) == 8 ? 2 * ((tb + 1) / 2) : tb;
}

// The block's shape: paths per chunk, warps, and shared-memory bytes
// (conj(W), then two [chunk][kPitch] complex buffers per warp). The widest
// chunk that leaves room for one warp, then as many warps as fit, at most
// kMaxWarps; warps == 0 when nothing fits. ops/kernels/beamgain.py's
// smem_bytes mirrors it.
struct Plan {
  int chunk, warps;
  size_t smem;
};

template <typename F>
Plan plan(int n_tx, int n_beams) {
  const size_t cw =
      sizeof(C2<F>) * cw_entries<F>(static_cast<size_t>(n_tx) * n_beams);
  for (int chunk : {32, 8}) {
    const size_t per_warp = 2 * sizeof(C2<F>) * chunk * kPitch;
    if (cw + per_warp <= kSmemLimit) {
      size_t warps = (kSmemLimit - cw) / per_warp;
      if (warps > static_cast<size_t>(kMaxWarps)) warps = kMaxWarps;
      return {chunk, static_cast<int>(warps), cw + warps * per_warp};
    }
  }
  return {8, 0, cw + 2 * sizeof(C2<F>) * 8 * kPitch};
}

template <typename F>
__device__ __forceinline__ C2<F> cx(F re, F im) {
  C2<F> z;
  z.x = re;
  z.y = im;
  return z;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename F>
__device__ __forceinline__ C2<F> cmul(C2<F> a, C2<F> b) {
  return cx<F>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 phasor(float ph) {
  float s, c;
  sincosf(ph, &s, &c);                // full range reduction
  return make_float2(c, s);
}
__device__ __forceinline__ double2 phasor(double ph) {
  double s, c;
  sincos(ph, &s, &c);
  return make_double2(c, s);
}

// acc += a * b
template <typename F>
__device__ __forceinline__ void cmac(C2<F>& acc, C2<F> a, C2<F> b) {
  acc.x = fmadd(a.x, b.x, fmadd(-a.y, b.y, acc.x));
  acc.y = fmadd(a.x, b.y, fmadd(a.y, b.x, acc.y));
}

// Two adjacent complex entries of shared or global memory, at a 16-byte
// aligned address: one 16-byte access in float, two in double.
__device__ __forceinline__ void load2(const float2* p, float2& a, float2& b) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  a = make_float2(x.x, x.y);
  b = make_float2(x.z, x.w);
}
__device__ __forceinline__ void load2(const double2* p, double2& a,
                                      double2& b) {
  a = p[0];
  b = p[1];
}
__device__ __forceinline__ void store2(float2* p, float2 a, float2 b) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store2(double2* p, double2 a, double2 b) {
  p[0] = a;
  p[1] = b;
}

// Two adjacent outputs, streaming, at an aligned address.
__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  __stcs(reinterpret_cast<float2*>(o), make_float2(a, b));
}
__device__ __forceinline__ void store_pair(double* o, double a, double b) {
  __stcs(reinterpret_cast<double2*>(o), make_double2(a, b));
}

// x rounded to bf16 (RNE) when kBf16 (float only), as it is otherwise.
template <typename F, bool kBf16>
__device__ __forceinline__ C2<F> operand(C2<F> x) {
  if constexpr (!kBf16) {
    return x;
  } else {
    static_assert(std::is_same_v<F, float>, "bf16 mode is float only");
    return make_float2(__bfloat162float(__float2bfloat16_rn(x.x)),
                       __bfloat162float(__float2bfloat16_rn(x.y)));
  }
}

// eb[j] = sum_t cw[t][b0 + j] a_tx[t] for j < kRows, for this lane's path.
// kVec: B is even and the tile's kRows beams all exist, so paired loads of
// two beams are aligned; otherwise single loads, clamped at beam B - 1.
template <typename F, bool kVec>
__device__ __forceinline__ void fold(const C2<F>* __restrict__ cw, int B,
                                     int b0, int t1, int t2, F gty, F gtz,
                                     C2<F> (&eb)[kRows]) {
  C2<F> ey[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) ey[i] = phasor(static_cast<F>(i) * gty);
#pragma unroll
  for (int j = 0; j < kRows; ++j) eb[j] = cx<F>(0, 0);
  for (int n = 0; n < t2; ++n) {
    const C2<F> ez = phasor(static_cast<F>(n) * gtz);
    for (int m0 = 0; m0 < t1; m0 += kL) {
      const C2<F> base =
          m0 == 0 ? ez : cmul<F>(ez, phasor(static_cast<F>(m0) * gty));
      const C2<F>* w = cw + static_cast<size_t>(n * t1 + m0) * B;
      const int n_m = min(kL, t1 - m0);
#pragma unroll
      for (int i = 0; i < kL; ++i, w += B) {
        if (i >= n_m) break;
        const C2<F> a = cmul<F>(base, ey[i]);
        if (kVec) {
#pragma unroll
          for (int j = 0; j < kRows / 2; ++j) {
            C2<F> x0, x1;
            load2(w + b0 + 2 * j, x0, x1);
            cmac<F>(eb[2 * j], x0, a);
            cmac<F>(eb[2 * j + 1], x1, a);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            cmac<F>(eb[j], w[min(b0 + j, B - 1)], a);
        }
      }
    }
  }
}

template <typename F>
struct Args {
  const F *gry, *grz, *gty, *gtz, *amp, *psi, *omega;
  F* out;
  int U, P, r1, r2, t1, t2, B, K, S, n_sa, chunk;
};

// E[lane][j] = a_rx[r] eb[j] of path p (zero for paths past P), written by
// the lanes of the chunk (rounded to bf16 when kBf16).
template <typename F, bool kBf16>
__device__ __forceinline__ void build_e(const Args<F>& a, const C2<F>* cw,
                                        C2<F>* e, int lane, size_t row,
                                        int p, int r, int b0) {
  if (lane >= a.chunk) return;
  C2<F> eb[kRows];
  if (p < a.P) {
    const F gty = a.gty[row + p], gtz = a.gtz[row + p];
    if (a.B % 2 == 0 && b0 + kRows <= a.B) {
      fold<F, true>(cw, a.B, b0, a.t1, a.t2, gty, gtz, eb);
    } else {
      fold<F, false>(cw, a.B, b0, a.t1, a.t2, gty, gtz, eb);
    }
    if (a.r1 * a.r2 > 1) {
      const int nr = r / a.r1;
      const C2<F> rx = phasor(static_cast<F>(r - nr * a.r1) *
                                  a.gry[row + p] +
                              static_cast<F>(nr) * a.grz[row + p]);
#pragma unroll
      for (int j = 0; j < kRows; ++j) eb[j] = cmul<F>(rx, eb[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) eb[j] = cx<F>(0, 0);
  }
  C2<F>* dst = e + lane * kPitch;
#pragma unroll
  for (int j = 0; j < kRows / 2; ++j)
    store2(dst + 2 * j, operand<F, kBf16>(eb[2 * j]),
           operand<F, kBf16>(eb[2 * j + 1]));
}

// The OFDM tables of path p for slot s and columns k0 .. k0 + kCols - 1:
// fine[k1] = exp(-j omega k1) at [0, kL) and
// coarse[j] = amp exp(j (psi - omega (k0 + kL j))) at [kL, 2 kL).
template <typename F>
__device__ __forceinline__ void build_tables(const Args<F>& a, C2<F>* tab,
                                             int lane, size_t u, size_t row,
                                             int p, int s, int k0) {
  if (lane >= a.chunk) return;
  C2<F> v[2 * kL];
  if (p < a.P) {
    const F om = a.omega[row + p];
    const F am = a.amp[(u * a.n_sa + (a.n_sa > 1 ? s : 0)) * a.P + p];
    const F ps = a.psi[(u * a.S + s) * a.P + p];
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      v[i] = phasor(-om * static_cast<F>(i));
      const C2<F> c = phasor(ps - om * static_cast<F>(k0 + kL * i));
      v[kL + i] = cx<F>(am * c.x, am * c.y);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2 * kL; ++i) v[i] = cx<F>(0, 0);
  }
  C2<F>* dst = tab + lane * kPitch;
#pragma unroll
  for (int i = 0; i < kL; ++i) store2(dst + 2 * i, v[2 * i], v[2 * i + 1]);
}

// y[i][c] += sum over the chunk's n_p paths of E[p][qg*8 + i] g[p][col c],
// columns k0 + 2 kg + (0, 1, 32, 33) of the tile (g rounded to bf16 when
// kBf16).
template <typename F, bool kBf16>
__device__ __forceinline__ void path_sum(const C2<F>* __restrict__ e,
                                         const C2<F>* __restrict__ tab,
                                         int n_p, int qg, int kg,
                                         C2<F> (&y)[8][4]) {
  const int f = 2 * (kg & 3);
  const int ca = kL + (kg >> 2), cb = ca + 4;
  for (int pp = 0; pp < n_p; ++pp) {
    const C2<F>* er = e + pp * kPitch + 8 * qg;
    const C2<F>* t = tab + pp * kPitch;
    C2<F> f0, f1;
    load2(t + f, f0, f1);
    const C2<F> c_a = t[ca], c_b = t[cb];
    const C2<F> g[4] = {operand<F, kBf16>(cmul<F>(f0, c_a)),
                        operand<F, kBf16>(cmul<F>(f1, c_a)),
                        operand<F, kBf16>(cmul<F>(f0, c_b)),
                        operand<F, kBf16>(cmul<F>(f1, c_b))};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      C2<F> e0, e1;
      load2(er + 2 * i, e0, e1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        cmac<F>(y[2 * i][c], e0, g[c]);
        cmac<F>(y[2 * i + 1][c], e1, g[c]);
      }
    }
  }
}

// G = |y|^2 of the lane's 8 rows and 4 columns, rows past B and columns past
// K skipped.
template <typename F>
__device__ __forceinline__ void store_power(const Args<F>& a, F* out_u,
                                            int r, int b0, int s, int k0,
                                            int qg, int kg,
                                            const C2<F> (&y)[8][4]) {
  const size_t sk = static_cast<size_t>(a.S) * a.K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = b0 + 8 * qg + i;
    if (b >= a.B) break;
    F* o = out_u + static_cast<size_t>(r * a.B + b) * sk +
           static_cast<size_t>(s) * a.K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 32 * h + 2 * kg;
      const C2<F> v0 = y[i][2 * h], v1 = y[i][2 * h + 1];
      const F p0 = v0.x * v0.x + v0.y * v0.y;
      const F p1 = v1.x * v1.x + v1.y * v1.y;
      if (a.K % 2 == 0) {           // o + k is aligned for the pair
        if (k < a.K) store_pair(o + k, p0, p1);
      } else {
        if (k < a.K) o[k] = p0;
        if (k + 1 < a.K) o[k + 1] = p1;
      }
    }
  }
}

template <typename F>
__device__ __forceinline__ void zero(C2<F> (&y)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) y[i][c] = cx<F>(0, 0);
  }
}

// kOneChunk: P <= chunk. A separate instantiation, so that the registers
// the chunked path keeps live across its fold (y beside the fold's
// accumulators) do not cost the one-chunk path spills. Two blocks per SM
// in float; in double the accumulators take twice the registers, so one.
template <typename F, bool kOneChunk, bool kBf16>
__global__ void __launch_bounds__(kMaxWarps * 32, sizeof(F) == 4 ? 2 : 1)
beamgain_kernel(Args<F> a, const C2<F>* __restrict__ cw_g) {
  extern __shared__ float4 smem[];
  const int T = a.t1 * a.t2;
  const int R = a.r1 * a.r2;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;

  // conj(W) [T][B], staged once for the block's life.
  C2<F>* cw = reinterpret_cast<C2<F>*>(smem);
  for (int i = threadIdx.x; i < T * a.B; i += blockDim.x) cw[i] = cw_g[i];
  __syncthreads();

  C2<F>* e = cw + cw_entries<F>(static_cast<size_t>(T) * a.B) +
             (threadIdx.x >> 5) * 2 * a.chunk * kPitch;
  C2<F>* tab = e + a.chunk * kPitch;
  const int n_ch = (a.P + a.chunk - 1) / a.chunk;
  const int qg = lane >> 4, kg = lane & 15;
  C2<F> y[8][4];

  for (int u = blockIdx.x * n_warps + (threadIdx.x >> 5); u < a.U;
       u += gridDim.x * n_warps) {
    const size_t row = static_cast<size_t>(u) * a.P;
    F* out_u = a.out + static_cast<size_t>(u) * R * a.B * a.S * a.K;
    for (int r = 0; r < R; ++r) {
      for (int b0 = 0; b0 < a.B; b0 += kRows) {
        if (kOneChunk) {
          // One chunk: fold E once, reuse it for every slot and column tile.
          build_e<F, kBf16>(a, cw, e, lane, row, lane, r, b0);
          for (int s = 0; s < a.S; ++s) {
            for (int k0 = 0; k0 < a.K; k0 += kCols) {
              build_tables<F>(a, tab, lane, u, row, lane, s, k0);
              __syncwarp();
              zero<F>(y);
              path_sum<F, kBf16>(e, tab, a.P, qg, kg, y);
              __syncwarp();         // E and the tables are read
              store_power<F>(a, out_u, r, b0, s, k0, qg, kg, y);
            }
          }
        } else {
          for (int s = 0; s < a.S; ++s) {
            for (int k0 = 0; k0 < a.K; k0 += kCols) {
              zero<F>(y);
              for (int c = 0; c < n_ch; ++c) {
                const int p0 = c * a.chunk;
                build_e<F, kBf16>(a, cw, e, lane, row, p0 + lane, r, b0);
                build_tables<F>(a, tab, lane, u, row, p0 + lane, s, k0);
                __syncwarp();
                path_sum<F, kBf16>(e, tab, min(a.chunk, a.P - p0), qg, kg,
                                   y);
                __syncwarp();
              }
              store_power<F>(a, out_u, r, b0, s, k0, qg, kg, y);
            }
          }
        }
      }
    }
  }
}

template <typename F, bool kBf16>
cudaError_t launch(const Args<F>& a0, const void* cw, int n_users,
                   cudaStream_t stream) {
  const Plan lp = plan<F>(a0.t1 * a0.t2, a0.B);
  if (lp.warps < 1) return cudaErrorInvalidValue;
  const int threads = 32 * lp.warps;
  const int smem = static_cast<int>(lp.smem);
  const auto kernel = a0.P <= lp.chunk ? beamgain_kernel<F, true, kBf16>
                                       : beamgain_kernel<F, false, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (static_cast<long long>(n_users) + lp.warps - 1) /
                         lp.warps;
  const long long full = static_cast<long long>(per_sm) * n_sm;
  const int grid = static_cast<int>(need < full ? need : full);
  Args<F> a = a0;
  a.chunk = lp.chunk;
  kernel<<<grid, threads, smem, stream>>>(
      a, static_cast<const C2<F>*>(cw));
  return cudaGetLastError();
}

template <typename F>
Args<F> make_args(const void* gry, const void* grz, const void* gty,
                  const void* gtz, const void* amp, const void* psi,
                  const void* omega, void* out, int n_users, int n_paths,
                  int r1, int r2, int t1, int t2, int n_beams, int n_k,
                  int n_s, int n_sa) {
  return Args<F>{static_cast<const F*>(gry), static_cast<const F*>(grz),
                 static_cast<const F*>(gty), static_cast<const F*>(gtz),
                 static_cast<const F*>(amp), static_cast<const F*>(psi),
                 static_cast<const F*>(omega), static_cast<F*>(out),
                 n_users, n_paths, r1, r2, t1, t2, n_beams, n_k, n_s, n_sa,
                 0};
}

}  // namespace

// Dynamic shared memory of the kernel's block at T TX elements and B beams,
// in float (f64 == 0) or double (0 when no block fits);
// ops/kernels/beamgain.py's smem_bytes mirrors it.
extern "C" long long beamgain_smem_bytes(int n_tx, int n_beams, int f64) {
  const Plan lp = f64 ? plan<double>(n_tx, n_beams)
                      : plan<float>(n_tx, n_beams);
  return lp.warps > 0 ? static_cast<long long>(lp.smem) : 0;
}

// Launches the beam-gain kernel on `stream`. Pointers are device pointers to
// contiguous arrays, all float32 (mode 0 or 1) or all float64 (mode 2):
// gry..gtz and omega [U, P], amp [U, n_sa*P], psi [U, n_s*P], cw [T, B, 2]
// (conj(W) transposed, real and imaginary parts interleaved),
// out [U, R*B, n_s*n_k]. Mode 1 rounds the path sum's operands to bf16.
// Returns the cudaError_t of the setup and the launch (0 on success); the
// kernel is not waited for.
extern "C" int beamgain_launch(const void* gry, const void* grz,
                               const void* gty, const void* gtz,
                               const void* amp, const void* psi,
                               const void* omega, const void* cw, void* out,
                               int n_users, int n_paths, int r1, int r2,
                               int t1, int t2, int n_beams, int n_k, int n_s,
                               int n_sa, int mode, void* stream) {
  if (n_users == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    return launch<double, false>(
        make_args<double>(gry, grz, gty, gtz, amp, psi, omega, out, n_users,
                          n_paths, r1, r2, t1, t2, n_beams, n_k, n_s, n_sa),
        cw, n_users, st);
  }
  const Args<float> a =
      make_args<float>(gry, grz, gty, gtz, amp, psi, omega, out, n_users,
                       n_paths, r1, r2, t1, t2, n_beams, n_k, n_s, n_sa);
  return mode == 1 ? launch<float, true>(a, cw, n_users, st)
                   : launch<float, false>(a, cw, n_users, st);
}
