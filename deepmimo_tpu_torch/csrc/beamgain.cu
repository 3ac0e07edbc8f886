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
// What bounds it on an H100: operations. A user does B*T*P complex MACs in
// the fold and R*B*S*K*P in the path sum. At the headline (131,072 users,
// P = 25, T = 64, R = 1, K = 64) with B = 16 beams that is 2 x 102,400
// FP32 FMA a user: 0.81 ms at the FP32 rate of 67 TFLOP/s, 0.33 ms at
// 3xTF32 on the tensor cores' nominal 495 TFLOP/s, beside 0.54 GB of output
// (0.16 ms at 3.35 TB/s). With B = 64 each product is 102,400 complex MACs
// a user: 3.2 ms as FP32 FMA, and 8.25e11 flops a call as the real-block
// GEMMs below at 3xTF32 over P padded to 32, 1.67 ms at 495 TFLOP/s. A
// 16x16 panel with its 256-beam grid (T = B = 256) folds 16 times that a
// user: 8.9e11 flops a call over the valid paths, 80% of its 1.12e12.
// Three designs share the launcher; the wrapper picks one from dtype, mode
// and shape (ops/kernels/beamgain.py tensor_core_route):
//
//   - SIMT (beamgain_kernel): float64, the one-pass bf16 mode, codebooks
//     under the wrapper's threshold of beams, panels past 256 elements and
//     the shapes at which the wrapper's cost models give it the smaller
//     time (small panels or few paths with few beams). Its shared memory
//     bounds it to T*B <= 28,768 in float32, 14,240 in float64.
//     Small products (a user's fold is [P x T] . [T x B]) on which
//     mma.sync TF32 runs at half its nominal rate here (PERF.md), so FP32
//     FMA on the SIMT pipes, bound by the instructions the SMs issue: the
//     design cuts everything issued beside the FMA. At B = 64 it issues at
//     ~72% of the SMs' rate, 11x its least time;
//   - tensor cores (tc::beamgain_kernel_tc): float32 at f32 grade, from
//     32 beams, T <= 64, where it is the faster or the SIMT design's
//     shared memory does not take the codebook. Two chained warpgroup
//     GEMMs per user on wgmma at 3xTF32 take the products off the issue
//     slots. What bounds it then is the SM itself: run without their
//     hand-over, the producers' trig, splits and shared stores and the
//     products take as long together as with it, so the two contend for
//     the SM rather than wait on each other; the design cuts the
//     producers' instructions per operand value and the products' count of
//     small wgmma (PERF.md);
//   - wide tensor cores (tcw::beamgain_kernel_wide): float32 at f32 grade,
//     from 32 beams, 64 < T <= 256, any number of beams. The tc design's
//     64-beam codebook tile in its four 3xTF32 planes would take 256 KB
//     at T = 256, and re-read from L2 per user it would move 1 MB a user
//     (137 GB a call). So its tile is 32 beams, whose real and imaginary
//     rows make the products' 64 rows: conj(W) of the tile in two planes
//     (128 KB at T = 256) stays in shared memory for every user the block
//     takes with it, while a_tx passes through in slices of 32 elements.
//     T = 256 is the most that the tile, two a_tx slices and two g
//     stages fit in a block's 227 KB.
//
// SIMT design:
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
//
// Tensor-core design (namespace tc), for one user and a tile of 64 beams
// (the rows of every product), in path chunks of 32 and tiles of 64
// subcarriers:
//   - the fold as two real GEMMs, D1 = Re conj(W) . X and D2 = Im conj(W) .
//     X on wgmma m64n64k8, with X = [Re a_tx | Im a_tx] (T x 64, columns
//     interleaved by path): eb = D1(re) - D2(im) + j (D1(im) + D2(re)), two
//     accumulators in place of one product against the doubled block
//     [[Ar, Ai], [Ai, -Ar]], so the producers write X once. conj(W) of the
//     tile, the same for every user, is split into tf32 hi and lo once per
//     block and beam tile into shared memory (64 KB at T = 64), the A
//     operand from shared memory;
//   - the path sum likewise as D3 = Er . G and D4 = Ei . G on wgmma
//     m64n128k8, G = [gr | gi] (32 x 128) with g scaled by a_rx[r] when
//     R > 1 (as pathsum.cu builds its B): y = D3(re) - D4(im) + j (D3(im) +
//     D4(re)), so g is written once, without the doubled block. Its A
//     operands are Er and Ei straight from the fold's accumulators, split
//     hi and lo in registers: a thread's accumulators of column blocks
//     2 ks and 2 ks + 1 are the A fragment of path-sum k-step ks (depths t
//     and t + 4: paths 8 ks + t and 8 ks + 4 + t), so G's rows are the
//     chunk's paths in order, as attention kernels feed S as P. G's columns
//     interleave re and im and run so that a thread holds both parts of
//     four adjacent subcarriers: the epilogue forms |y|^2 in registers and
//     leaves as 16-byte streaming stores into the [U, R*B, S*K] layout;
//   - 3xTF32 throughout (lo.hi + hi.lo + hi.hi, FP32 accumulation, the
//     split of render_tables.cuh), f32 grade like the SIMT design;
//   - persistent warp-specialised blocks, one per SM (196,608 bytes of
//     shared memory for every shape): one consumer warpgroup stages the
//     codebook and runs the products and the stores; 4 producer warps
//     build X and G into two stages, handed over by named barriers (full,
//     empty), so that their work runs beside the products. No product
//     register is written on a branch, so ptxas keeps the products in
//     flight together (the first product of a sum starts it, acc 0);
//   - the producers' trig is separable, as the SIMT design's: a_tx =
//     ey[m] ez[n] (8 x 8 panels; others take one sincos per entry) and g =
//     fine[k % 8] coarse[k / 8], each lane computing one entry of each
//     table of its two paths and taking the rest from the lanes of its path
//     by shuffle; the phases rounded as the plain version rounds them,
//     batches of branchless sincos in flight. Their stores fill core
//     matrices without bank conflicts, half of a quarter warp writing the
//     second column of each pair first, from swap(z) = (Im z, Re z), so no
//     value is selected per lane;
//   - with one path chunk (P <= 32) E is folded once per user and beam tile
//     and kept for every RX element, slot and 64-column tile; with more,
//     y sums over the chunks and E is folded again per output tile.
//
// Wide tensor-core design (namespace tcw), for one user and a tile of 32
// beams, in path chunks of 32, a_tx slices of 32 TX elements and tiles of
// 64 subcarriers:
//   - the fold as one real GEMM on wgmma m64n64k8, D = C . X over the
//     slices: row 16 v + g + 8 h of C is part h of conj(W) of beam
//     8 v + g, so a warpgroup thread holds both parts of one beam (rows
//     ra and ra + 8), and X's columns are tc's, so it holds both parts of
//     path 4 j + t in column block j: cr ar, cr ai, ci ar and ci ai, from
//     which Er and Ei of (beam, path) are its own;
//   - the path sum as one real GEMM on wgmma m64n64k8, y = A . G, with A
//     the real form [[Er, -Ei], [Ei, Er]] of E straight from those
//     registers: k-step j's depths t and t + 4 are parts re and im of
//     path 4 j + t, so its A fragment is (Er, Ei, -Ei, Er); G's depths
//     hold (gr, gi) of the paths and its columns run so that a thread
//     holds Re y and Im y (rows ra, ra + 8) of four adjacent subcarriers:
//     |y|^2 in registers, 16-byte streaming stores;
//   - a slice's products run on while the next slice's are issued;
//     3xTF32 throughout (a_tx's hi plane is the float itself, which the
//     tf32 products read truncated, its lo plane the exact rest);
//   - persistent warp-specialised blocks of 512 threads, one per SM
//     (229,376 bytes of shared memory): one consumer warpgroup stages the
//     codebook tile and runs the products and the stores; two producer
//     warpgroups build the a_tx slices and one builds g, each ring in two
//     stages (named barriers: each ring's full and empty), with 16-byte
//     stores free of bank conflicts; setmaxnreg gives the consumers 200
//     registers and the producers 96 (without it ptxas serialises the
//     products, C7512). a_tx is separable where the panel's rows are 8,
//     16 or 32 elements wide (a_tx = ey[m] ez[n]: the row factors once
//     per user, one sincos a slice), else one sincos per entry; g one
//     sincos per entry. The a_tx producers set the pace (PERF.md). No
//     product register is written on a branch; the k-step counts of a
//     slice and of the path sum are compile-time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "render_tables.cuh"
#include "tc_operands.cuh"
#include "wgmma.cuh"

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


// ---------------------------------------------------------------------------
// The tensor-core design: float32 at f32 grade, codebooks of 32 beams or
// more where it is the faster (the wrapper routes;
// ops/kernels/beamgain.py tensor_core_route)
// ---------------------------------------------------------------------------

namespace tc {

using render::Split;
using tcop::build_g;                 // G of a step (tc_operands.cuh)
using tcop::kGPlane;
using tcop::kKt;
using tcop::kNG;
using tcop::kPc;
using tcop::store_split;

constexpr int kConsumers = 128;      // one warpgroup: codebook, wgmma, stores
constexpr int kProducers = 128;      // 4 warps: the a_tx and g operands
constexpr int kThreads = kConsumers + kProducers;
constexpr int kM = 64;               // beams per tile: the products' rows
constexpr int kTMax = 64;            // TX elements the staged codebook holds
constexpr int kNX = 2 * kPc;         // fold columns: (re, im) of kPc paths
constexpr int kWPlane = kM * kTMax;  // floats of one codebook plane
constexpr int kXPlane = kTMax * kNX; // floats of one a_tx plane
// conj(W) as 4 planes (re hi, re lo, im hi, im lo), then 2 stages of a_tx
// (hi, lo) and 2 of g (hi, lo): 196,608 bytes, one block per SM.
constexpr size_t kSmemBytes =
    sizeof(float) * (4 * kWPlane + 2 * 2 * (kXPlane + kGPlane));
// Named barriers: stage s full (producers arrive, consumers wait) and
// empty (the reverse), the consumers' own.
constexpr int kFull = 1, kEmpty = 3, kConsBar = 5;
static_assert(kProducers == 4 * 32 && kPc == 32, "a producer warp per 8 "
              "paths of a chunk");

struct Args {
  const float *gry, *grz, *gty, *gtz, *amp, *psi, *omega;
  const float2* cw;         // conj(W) [T][B]
  float* out;               // [U, R*B, S*K]
  int U, P, r1, r2, t1, t2, T, B, K, S, n_sa;
  int n_items;              // beam tiles x users
  int n_ch, n_kt, n_steps;  // path chunks, column tiles, steps per item
  int vec;                  // 16-byte stores: K % 4 == 0, aligned out
};

// Step st of an item (one user and beam tile): output tile (r, s, column
// tile) and path chunk. With one chunk, E is folded at the item's first
// step and kept for every tile; with more, every step folds its chunk and
// the tile's sum runs over its n_ch steps.
struct Step {
  int chunk, r, s, k0;
  bool fold;
};

__device__ __forceinline__ Step step_at(const Args& a, int st) {
  Step x;
  int tile = st;
  x.chunk = 0;
  if (a.n_ch > 1) {
    tile = st / a.n_ch;
    x.chunk = st - tile * a.n_ch;
  }
  x.fold = a.n_ch > 1 || st == 0;
  const int rs = tile / a.n_kt;
  x.k0 = (tile - rs * a.n_kt) * kKt;
  x.r = rs / a.S;
  x.s = rs - x.r * a.S;
  return x;
}

// Producers: a_tx of the chunk as the fold's B operand [8 kKF x kNX] in
// hi and lo planes: column 8 J + 2 e + h at depth t holds the real (h = 0)
// or imaginary (h = 1) part of a_tx[t, path 4 J + e]. Warp w, lane
// e + 4 q + 16 jh writes column blocks J = 2 w + h2 (its paths
// 8 w + 4 h2 + e, h2 < 2) at depths t = 8 i + r, r = 4 jh + q
// (m[i] = t % t1, n[i] = t / t1). Depths past T and paths past P are
// zeros.
template <int kKF>
__device__ __forceinline__ void build_x(const Args& a, const bool (&ok)[2],
                                        const float (&gty)[2],
                                        const float (&gtz)[2],
                                        const float (&m)[kKF],
                                        const float (&n)[kKF], int w, int e,
                                        int q, int jh, float* xh) {
  const int r = 4 * jh + q;
  float2 v[2][kKF];
  if (a.t1 == 8) {
    // Separable: depth 8 i + r is element (m, n) = (r, i), a_tx = ey[r]
    // ez[i]. Lane (e, r) computes ey[r] and ez[r] of its paths and takes
    // ez[i] from lane (e, i); lanes jh = 1 build swap(ey) conj(ez[i]).
    const float rf = static_cast<float>(r);
    const float ph[4] = {__fmul_rn(rf, gty[0]), __fmul_rn(rf, gtz[0]),
                         __fmul_rn(rf, gty[1]), __fmul_rn(rf, gtz[1])};
    float2 yz[4];
    render::phasors(ph, yz);
    const float sz = jh ? -1.f : 1.f;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 y = yz[2 * h2], z = yz[2 * h2 + 1];
      const float2 ey = jh ? make_float2(y.y, y.x) : y;
#pragma unroll
      for (int i = 0; i < kKF; ++i) {
        const int src = e + 4 * (i & 3) + 16 * (i >> 2);
        v[h2][i] = render::cmul(ey, make_float2(
                                        __shfl_sync(~0u, z.x, src),
                                        sz * __shfl_sync(~0u, z.y, src)));
      }
    }
  } else {
    // Lanes jh = 1 take exp(j (pi / 2 - theta)) = swap(exp(j theta)).
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float ph[kKF];
#pragma unroll
      for (int i = 0; i < kKF; ++i) {
        const float th = __fadd_rn(__fmul_rn(m[i], gty[h2]),
                                   __fmul_rn(n[i], gtz[h2]));
        ph[i] = jh ? -th : th;
      }
      render::phasors(ph, v[h2], jh);
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
    for (int i = 0; i < kKF; ++i) {
      const int t = 8 * i + r;
      const int o = wg::offset(8 * (2 * w + h2) + 2 * e, t, kNX);
      store_split(xh, xh + kXPlane, jh ? o + 4 : o, jh ? o : o + 4,
                 ok[h2] && t < a.T ? v[h2][i] : make_float2(0.f, 0.f));
    }
  }
}

template <int kKF>
__device__ __forceinline__ void produce(const Args& a, float* x_st,
                                        float* g_st) {
  const int id = threadIdx.x - kConsumers;
  const int w = id >> 5, lane = id & 31;
  const int e = lane & 3, q = (lane >> 2) & 3, jh = lane >> 4;
  const int R = a.r1 * a.r2;
  float m[kKF], n[kKF];              // panel indices of the lane's depths
#pragma unroll
  for (int i = 0; i < kKF; ++i) {
    const int t = 8 * i + 4 * jh + q;
    const int nn = t / a.t1;
    m[i] = static_cast<float>(t - nn * a.t1);
    n[i] = static_cast<float>(nn);
  }
  int k = 0;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const size_t u = static_cast<size_t>(it % a.U);
    for (int st = 0; st < a.n_steps; ++st, ++k) {
      const Step x = step_at(a, st);
      const int sg = k & 1;
      bool ok[2];
      float gty[2] = {0.f, 0.f}, gtz[2] = {0.f, 0.f}, om[2] = {0.f, 0.f},
            ps[2] = {0.f, 0.f};
      float2 ca[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {   // the lane's two paths
        const int p = x.chunk * kPc + 8 * w + 4 * h2 + e;
        ok[h2] = p < a.P;
        float am = 0.f;
        float2 rx = make_float2(1.f, 0.f);
        if (ok[h2]) {
          const size_t row = u * a.P + p;
          if (x.fold) {
            gty[h2] = __ldg(a.gty + row);
            gtz[h2] = __ldg(a.gtz + row);
          }
          om[h2] = __ldg(a.omega + row);
          ps[h2] = __ldg(a.psi + (u * a.S + x.s) * a.P + p);
          am = __ldg(a.amp + (u * a.n_sa + (a.n_sa > 1 ? x.s : 0)) * a.P +
                     p);
          if (R > 1) {
            const int nr = x.r / a.r1;
            rx = render::phasor(__fadd_rn(
                __fmul_rn(static_cast<float>(x.r - nr * a.r1),
                          __ldg(a.gry + row)),
                __fmul_rn(static_cast<float>(nr), __ldg(a.grz + row))));
          }
        }
        ca[h2] = make_float2(am * rx.x, am * rx.y);
      }
      if (k >= 2) render::bar_sync(kEmpty + sg, kThreads);  // stage drained
      if (x.fold)
        build_x<kKF>(a, ok, gty, gtz, m, n, w, e, q, jh,
                     x_st + sg * 2 * kXPlane);
      build_g(om, ps, ca, x.k0, w, e, q, jh, g_st + sg * 2 * kGPlane);
      // Written through the generic proxy, read by wgmma through the async
      // proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      render::bar_arrive(kFull + sg, kThreads);
    }
  }
  // The consumers release the last two stages too.
  for (int j = k < 2 ? 0 : k - 2; j < k; ++j)
    render::bar_sync(kEmpty + (j & 1), kThreads);
}

// Consumers: conj(W) of beams b0 .. b0 + kM - 1 as the fold's A operand
// [kM x 8 kKF], split into re hi, re lo, im hi and im lo planes; zeros
// past B and T.
template <int kKF>
__device__ __forceinline__ void stage_codebook(const Args& a, int b0,
                                               float* w) {
  for (int idx = threadIdx.x; idx < kM * 8 * kKF; idx += kConsumers) {
    const int mm = idx & (kM - 1), t = idx / kM;
    float2 c = make_float2(0.f, 0.f);
    if (b0 + mm < a.B && t < a.T) c = a.cw[static_cast<size_t>(t) * a.B +
                                           b0 + mm];
    const Split re = render::split(c.x), im = render::split(c.y);
    const int o = wg::offset(mm, t, kM);
    w[o] = __uint_as_float(re.hi);
    w[kWPlane + o] = __uint_as_float(re.lo);
    w[2 * kWPlane + o] = __uint_as_float(im.hi);
    w[3 * kWPlane + o] = __uint_as_float(im.lo);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  render::bar_sync(kConsBar, kConsumers);
}

// E of the chunk as the path sum's A fragments, split hi and lo: rh, rl of
// its real part, ih, il of its imaginary part, one [4] per k-step.
struct EFrags {
  uint32_t rh[4][4], rl[4][4], ih[4][4], il[4][4];
};

__device__ __forceinline__ void fence_frags(EFrags& f) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wg::fence_regs(f.rh[ks]);
    wg::fence_regs(f.rl[ks]);
    wg::fence_regs(f.ih[ks]);
    wg::fence_regs(f.il[ks]);
  }
}

// Consumers: the fold of the stage's a_tx, D1 = Re conj(W) . X and D2 =
// Im conj(W) . X at 3xTF32, then E = eb of the chunk: this thread's
// accumulators of column block J hold, for rows ra and ra + 8, path
// 4 J + t as Er = D1(re) - D2(im) and Ei = D1(im) + D2(re), and blocks
// 2 ks and 2 ks + 1 are the A fragment of path-sum k-step ks (depths t and
// t + 4: paths 8 ks + t and 8 ks + 4 + t). The first products start the
// sums (acc 0): no register of a product is written outside the products
// on any branch, so that ptxas keeps them in flight together.
template <int kKF>
__device__ __forceinline__ void fold(const uint64_t (&dw)[4], const float* x,
                                     EFrags& f) {
  float d1[32], d2[32];
  const uint64_t xh = wg::desc(x, kNX), xl = wg::desc(x + kXPlane, kNX);
  wg::fence_regs(d1);
  wg::fence_regs(d2);
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < kKF; ++ks) {
    const uint64_t bh = wg::step(xh, ks, kNX), bl = wg::step(xl, ks, kNX);
    wg::mma_n64_ss(d1, wg::step(dw[1], ks, kM), bh, ks);     // lo . hi
    wg::mma_n64_ss(d2, wg::step(dw[3], ks, kM), bh, ks);
    wg::mma_n64_ss(d1, wg::step(dw[0], ks, kM), bl);         // hi . lo
    wg::mma_n64_ss(d2, wg::step(dw[2], ks, kM), bl);
    wg::mma_n64_ss(d1, wg::step(dw[0], ks, kM), bh);         // hi . hi
    wg::mma_n64_ss(d2, wg::step(dw[2], ks, kM), bh);
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(d1);
  wg::fence_regs(d2);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {    // a[i]: block 2 ks + i / 2, row i % 2
      const int o = 4 * (2 * ks + i / 2) + 2 * (i % 2);
      const Split re = render::split(d1[o] - d2[o + 1]);
      const Split im = render::split(d1[o + 1] + d2[o]);
      f.rh[ks][i] = re.hi;
      f.rl[ks][i] = re.lo;
      f.ih[ks][i] = im.hi;
      f.il[ks][i] = im.lo;
    }
  }
}

// Consumers: D3 = Er . G and D4 = Ei . G of the stage at 3xTF32, plus
// D3 and D4 unless `acc` is 0: y = D3(re) - D4(im) + j (D3(im) + D4(re)).
__device__ __forceinline__ void path_sum(float (&d3)[64], float (&d4)[64],
                                         EFrags& f, const float* g,
                                         int acc) {
  const uint64_t gh = wg::desc(g, kNG), gl = wg::desc(g + kGPlane, kNG);
  wg::fence_regs(d3);
  wg::fence_regs(d4);
  fence_frags(f);
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < kPc / 8; ++ks) {
    const uint64_t bh = wg::step(gh, ks, kNG), bl = wg::step(gl, ks, kNG);
    wg::mma_n128_rs(d3, f.rl[ks], bh, ks ? 1 : acc);          // lo . hi
    wg::mma_n128_rs(d4, f.il[ks], bh, ks ? 1 : acc);
    wg::mma_n128_rs(d3, f.rh[ks], bl);                        // hi . lo
    wg::mma_n128_rs(d4, f.ih[ks], bl);
    wg::mma_n128_rs(d3, f.rh[ks], bh);                        // hi . hi
    wg::mma_n128_rs(d4, f.ih[ks], bh);
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(d3);
  wg::fence_regs(d4);
  fence_frags(f);
}

// Consumers: G = |y|^2 of rows ra and ra + 8 of the beam tile and the
// step's 64 columns, as float4 streaming stores of four adjacent
// subcarriers; rows past B and columns past K skipped.
__device__ __forceinline__ void store_power(const Args& a, size_t u, int b0,
                                            const Step& x, int ra, int t,
                                            const float (&d3)[64],
                                            const float (&d4)[64]) {
  const size_t sk = static_cast<size_t>(a.S) * a.K;
  const int R = a.r1 * a.r2;
  const int cols = render::imin(kKt, a.K - x.k0);
  float* base = a.out + ((u * R + x.r) * a.B + b0) * sk +
                static_cast<size_t>(x.s) * a.K + x.k0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = ra + 8 * h;
    if (b0 + b >= a.B) continue;
    float* o = base + static_cast<size_t>(b) * sk;
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      const int kl = 16 * J + 4 * t;
      if (kl >= cols) continue;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * (4 * J + i) + 2 * h;
        const float yr = d3[c] - d4[c + 1], yi = d3[c + 1] + d4[c];
        v[i] = yr * yr + yi * yi;
      }
      if (a.vec) {                   // cols is a multiple of 4 here
        __stcs(reinterpret_cast<float4*>(o + kl),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kl + i < cols) __stcs(o + kl + i, v[i]);
      }
    }
  }
}

// kKF: the fold's k-steps (4 for T <= 32, else 8), X and conj(W) zero past
// T. kOneChunk: P <= kPc, E folded once per item (user and beam tile) and
// kept for every output tile; else every step folds its chunk and the
// output tile sums over n_ch steps.
template <int kKF, bool kOneChunk>
__global__ void __launch_bounds__(kThreads, 1)
beamgain_kernel_tc(Args a) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);        // [4][kWPlane]
  float* x_st = w + 4 * kWPlane;                     // [2][hi, lo][kXPlane]
  float* g_st = x_st + 2 * 2 * kXPlane;              // [2][hi, lo][kGPlane]
  if (threadIdx.x >= kConsumers) {
    produce<kKF>(a, x_st, g_st);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int ra = 16 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
  const uint64_t dw[4] = {wg::desc(w, kM), wg::desc(w + kWPlane, kM),
                          wg::desc(w + 2 * kWPlane, kM),
                          wg::desc(w + 3 * kWPlane, kM)};
  EFrags f;                          // E of the chunk
  float d3[64], d4[64];              // column block j: d[4 j .. 4 j + 3]
  int k = 0, staged = -1;            // k: the step, over the block's items
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const int bt = it / a.U, b0 = bt * kM;
    const size_t u = static_cast<size_t>(it - bt * a.U);
    if (bt != staged) {              // every earlier product has completed
      if (staged >= 0) render::bar_sync(kConsBar, kConsumers);
      stage_codebook<kKF>(a, b0, w);
      staged = bt;
    }
    if (kOneChunk) {
      render::bar_sync(kFull + (k & 1), kThreads);   // a_tx, g of step k
      fold<kKF>(dw, x_st + (k & 1) * 2 * kXPlane, f);
      for (int st = 0;;) {
        const int sg = k & 1;
        path_sum(d3, d4, f, g_st + sg * 2 * kGPlane, 0);
        render::bar_arrive(kEmpty + sg, kThreads);   // may be rebuilt
        store_power(a, u, b0, step_at(a, st), ra, t, d3, d4);
        ++k;
        if (++st == a.n_steps) break;
        render::bar_sync(kFull + (k & 1), kThreads);  // g of step k
      }
    } else {
      for (int st = 0; st < a.n_steps; st += a.n_ch) {
        for (int c = 0; c < a.n_ch; ++c, ++k) {
          const int sg = k & 1;
          render::bar_sync(kFull + sg, kThreads);    // a_tx, g of step k
          fold<kKF>(dw, x_st + sg * 2 * kXPlane, f);
          path_sum(d3, d4, f, g_st + sg * 2 * kGPlane, c);
          render::bar_arrive(kEmpty + sg, kThreads);
        }
        store_power(a, u, b0, step_at(a, st), ra, t, d3, d4);
      }
    }
  }
}

cudaError_t launch(const ::Args<float>& s, const void* cw,
                   cudaStream_t stream) {
  Args a{s.gry, s.grz, s.gty, s.gtz, s.amp, s.psi, s.omega,
         static_cast<const float2*>(cw), s.out, s.U, s.P, s.r1, s.r2, s.t1,
         s.t2, s.t1 * s.t2, s.B, s.K, s.S, s.n_sa, 0, 0, 0, 0, 0};
  if (a.T > kTMax) return cudaErrorInvalidValue;
  a.n_ch = (a.P + kPc - 1) / kPc;
  a.n_kt = (a.K + kKt - 1) / kKt;
  const long long items = static_cast<long long>((a.B + kM - 1) / kM) * a.U;
  const long long tiles = static_cast<long long>(a.r1) * a.r2 * a.S * a.n_kt;
  const long long steps = a.n_ch > 1 ? tiles * a.n_ch : tiles;
  if (items > 0x3fffffff || steps > 0x3fffffff) return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  a.n_steps = static_cast<int>(steps);
  a.vec = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const bool one = a.n_ch == 1;
  const auto kernel = a.T <= 32 ? (one ? beamgain_kernel_tc<4, true>
                                       : beamgain_kernel_tc<4, false>)
                                : (one ? beamgain_kernel_tc<8, true>
                                       : beamgain_kernel_tc<8, false>);
  const int smem = static_cast<int>(kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long full = static_cast<long long>(per_sm) * n_sm;
  const int grid = static_cast<int>(items < full ? items : full);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The wide tensor-core design: float32 at f32 grade, panels of 65 to kTMax
// TX elements (the wrapper routes; ops/kernels/beamgain.py
// tensor_core_route)
// ---------------------------------------------------------------------------

namespace tcw {

using render::Split;
using tcop::kKt;
using tcop::kPc;

constexpr int kConsumers = 128;      // one warpgroup: codebook, wgmma, stores
constexpr int kXProducers = 256;     // two warpgroups: the a_tx slices
constexpr int kGProducers = 128;     // one warpgroup: g
constexpr int kThreads = kConsumers + kXProducers + kGProducers;
constexpr int kXRing = kConsumers + kXProducers;  // the rings' barriers
constexpr int kGRing = kConsumers + kGProducers;
// Registers a thread of the consumers and of the producers: 65,536 for
// the block's 512 threads, most of them to the consumers' accumulators
// and fragments (setmaxnreg).
constexpr int kConsumerRegs = 200, kProducerRegs = 96;
static_assert(kConsumers * kConsumerRegs +
              (kXProducers + kGProducers) * kProducerRegs <= 65536,
              "the register file");
constexpr int kBeams = 32;           // beams per tile
constexpr int kM = 2 * kBeams;       // the products' rows: (beam, part)
constexpr int kTMax = 256;           // TX elements the staged codebook holds
constexpr int kTS = 32;              // depths of one a_tx slice
constexpr int kNX = 2 * kPc;         // fold columns: (re, im) of kPc paths
constexpr int kDG = 2 * kPc;         // path-sum depths: (re, im) of kPc paths
constexpr int kWPlane = kM * kTMax;  // floats of one codebook plane
constexpr int kXPlane = kTS * kNX;   // floats of one a_tx slice plane
constexpr int kGPlane = kDG * kKt;   // floats of one g plane
// The rings: a_tx slices in kXStages stages, g in kGStages (4 and 1
// measured alike at the cell's shape).
constexpr int kXStages = 2, kGStages = 2;
// conj(W) of the tile as 2 planes (hi, lo) over kTMax depths, then the
// a_tx and g stages (hi, lo): 229,376 bytes, one block per SM.
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kWPlane + 2 * (kXStages * kXPlane +
                                        kGStages * kGPlane));
// Named barriers: a_tx stage s full and empty, g stage s full and empty
// (each ring's producers arrive on full, the consumers on empty), the
// consumers' own.
constexpr int kXFull = 1, kXEmpty = kXFull + kXStages,
              kGFull = kXEmpty + kXStages, kGEmpty = kGFull + kGStages,
              kConsBar = kGEmpty + kGStages;
static_assert(kConsBar <= 15, "16 named barriers");
static_assert(kXProducers == 8 * 32 && kGProducers == 4 * 32 &&
              kPc == 32 && kKt == 64,
              "two a_tx warps and a g warp per 8 paths of a chunk");

struct Args {
  const float *gry, *grz, *gty, *gtz, *amp, *psi, *omega;
  const float2* cw;         // conj(W) [T][B]
  float* out;               // [U, R*B, S*K]
  int U, P, r1, r2, t1, t2, T, B, K, S, n_sa;
  int n_items;              // beam tiles x users
  int n_ch, n_kt, n_tiles;  // path chunks, column tiles, output tiles
  int n_sl;                 // a_tx slices of kTS depths
  int vec;                  // 16-byte stores: K % 4 == 0, aligned out
};

// Output tile `tile` of an item: RX element, slot and first column.
struct Tile {
  int r, s, k0;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int tile) {
  Tile x;
  const int rs = tile / a.n_kt;
  x.k0 = (tile - rs * a.n_kt) * kKt;
  x.r = rs / a.S;
  x.s = rs - x.r * a.S;
  return x;
}

// An a_tx producer lane's share of a slice: path 8 (w % 4) + 4 jp + e of
// the chunk (column block J = 2 (w % 4) + jp of X) and the 4 depths
// 8 q + 4 (w / 4) + i (i < 4) of the slice, q = 2 x + hs, for lane
// e + 4 hs + 8 x + 16 jp of a_tx producer warp w (of 8).
struct XLane {
  int e, hs, q, jp, half;
};

__device__ __forceinline__ XLane x_lane(int w, int lane) {
  return {lane & 3, (lane >> 2) & 1, 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1),
          lane >> 4, w >> 2};
}

// The separable panels: rows of t1 = 8, 16 or 32 elements, so that depth
// 8 q + r (r < 8) of every slice lies at the same element m =
// (8 q + r) % t1 of a row, and a lane's depths of a slice in one row n.
__device__ __forceinline__ bool separable(const Args& a) {
  return a.t1 == 8 || a.t1 == 16 || a.t1 == 32;
}

// Producers: a_tx of the lane's path at its 4 depths of the slice at t0
// into the fold's B operand [kTS x kNX] (hi and lo planes), whose column
// 8 J + 2 e + h holds part h of a_tx of path 4 J + e: per part one
// 16-byte store to each plane, the lanes hs = 1 writing the imaginary
// part first, so that the 8 lanes of each quarter of a store cover 8 rows
// of one core matrix (free of bank conflicts). The hi plane holds x
// itself, whose low 13 bits the tf32 products do not read (x truncated),
// and the lo plane the rest, x - trunc(x), exactly. On separable panels
// a_tx = ey[i] ez with the lane's row factors ey (once per item) and ez =
// exp(j n gtz) of the slice's row n; else one sincos per depth. Depths
// past T and paths past P are zeros.
__device__ __forceinline__ void build_x(const Args& a, const XLane& l,
                                        bool ok, float gty, float gtz,
                                        const float2 (&ey)[4], int t0, int w,
                                        float* xh) {
  const int k0 = 8 * l.q + 4 * l.half;        // the lane's first depth
  const int t = t0 + k0;
  float2 v[4];
  if (separable(a)) {
    float ph[1] = {__fmul_rn(static_cast<float>(t / a.t1), gtz)};
    float2 ez[1];
    render::phasors(ph, ez);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = render::cmul(ey[i], ez[0]);
  } else {
    int n = t / a.t1, m = t - n * a.t1;
    float ph[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ph[i] = __fadd_rn(__fmul_rn(static_cast<float>(m), gty),
                        __fmul_rn(static_cast<float>(n), gtz));
      const bool wrap = ++m == a.t1;
      m = wrap ? 0 : m;
      n += wrap;
    }
    render::phasors(ph, v);
  }
  const int row = 8 * (2 * (w & 3) + l.jp) + 2 * l.e;
#pragma unroll
  for (int k = 0; k < 2; ++k) {               // part hs, then 1 - hs
    const int h = k ^ l.hs;
    float hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = ok && t + i < a.T ? (h ? v[i].y : v[i].x) : 0.f;
      hi[i] = x;
      lo[i] = x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    }
    const int o = wg::offset(row + h, k0, kNX);
    *reinterpret_cast<float4*>(xh + o) =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(xh + kXPlane + o) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Producers: g of the tile's slot and columns k0 .. k0 + kKt - 1 as the
// path sum's B operand [kDG x kKt] in hi and lo planes: depth 8 ks + d +
// 4 c holds part c of g of path 4 ks + d of the chunk (the order in which
// the fold's accumulators lie as A fragments), column n subcarrier
// 16 (n / 16) + 2 (n / 8 % 2) + 4 (n % 8 / 2) + n % 2 of the tile, so that
// a consumer thread's accumulators hold four adjacent subcarriers. g = ca
// exp(j (psi - omega k)), ca = amp a_rx[r], one sincos per entry. Lane
// cg + 16 kh of g producer warp w takes the 4 paths of k-step ks =
// 2 w + kh and the columns cg + 16 i (i < 4): per column and part one
// 16-byte store to each plane, the 8 lanes of each quarter of a store
// covering 8 rows of one core matrix. Columns past K hold values that
// are never stored.
__device__ __forceinline__ void build_g(const float (&om)[4],
                                        const float (&ps)[4],
                                        const float2 (&ca)[4], int k0,
                                        int ks, int cg, float* gh) {
  const int kb = k0 + 2 * ((cg >> 3) & 1) + 4 * ((cg & 7) >> 1) + (cg & 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ph[4];
#pragma unroll
    for (int d = 0; d < 4; ++d)
      ph[d] = __fsub_rn(ps[d],
                        __fmul_rn(om[d], static_cast<float>(kb + 16 * i)));
    float2 v[4];
    render::phasors(ph, v);
    float re[2][4], im[2][4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float2 g = render::cmul(ca[d], v[d]);
      const Split sr = render::split(g.x), si = render::split(g.y);
      re[0][d] = __uint_as_float(sr.hi);
      re[1][d] = __uint_as_float(sr.lo);
      im[0][d] = __uint_as_float(si.hi);
      im[1][d] = __uint_as_float(si.lo);
    }
    const int o = wg::offset(cg + 16 * i, 8 * ks, kKt);
    const int o2 = wg::offset(cg + 16 * i, 8 * ks + 4, kKt);
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      *reinterpret_cast<float4*>(gh + pl * kGPlane + o) =
          make_float4(re[pl][0], re[pl][1], re[pl][2], re[pl][3]);
      *reinterpret_cast<float4*>(gh + pl * kGPlane + o2) =
          make_float4(im[pl][0], im[pl][1], im[pl][2], im[pl][3]);
    }
  }
}

// Producers: the a_tx slices of chunk c of user u into the a_tx stages,
// counted by kx.
__device__ __forceinline__ void produce_x(const Args& a, size_t u, int c,
                                          int w, int lane, float* x_st,
                                          int& kx) {
  const XLane l = x_lane(w, lane);
  const int p = c * kPc + 8 * (w & 3) + 4 * l.jp + l.e;
  const bool ok = p < a.P;
  const float gty = ok ? __ldg(a.gty + u * a.P + p) : 0.f;
  const float gtz = ok ? __ldg(a.gtz + u * a.P + p) : 0.f;
  float2 ey[4];                      // the row factors of the lane's depths
  if (separable(a)) {
    float ph[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ph[i] = __fmul_rn(
          static_cast<float>((8 * l.q + 4 * l.half + i) % a.t1), gty);
    render::phasors(ph, ey);
  }
  for (int sl = 0; sl < a.n_sl; ++sl, ++kx) {
    const int sg = kx % kXStages;
    if (kx >= kXStages) render::bar_sync(kXEmpty + sg, kXRing);  // drained
    build_x(a, l, ok, gty, gtz, ey, sl * kTS, w, x_st + sg * 2 * kXPlane);
    // Written through the generic proxy, read by wgmma through the async
    // proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    render::bar_arrive(kXFull + sg, kXRing);
  }
}

// Producers: g of output tile `tile` and chunk c of user u into a g
// stage, counted by kg.
__device__ __forceinline__ void produce_g(const Args& a, size_t u, int tile,
                                          int c, int w, int lane,
                                          float* g_st, int& kg) {
  const int ks = 2 * w + (lane >> 4), cg = lane & 15;
  const Tile x = tile_at(a, tile);
  const int R = a.r1 * a.r2;
  float om[4] = {0.f, 0.f, 0.f, 0.f}, ps[4] = {0.f, 0.f, 0.f, 0.f};
  float2 ca[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int p = c * kPc + 4 * ks + d;
    float am = 0.f;
    float2 rx = make_float2(1.f, 0.f);
    if (p < a.P) {
      const size_t row = u * a.P + p;
      om[d] = __ldg(a.omega + row);
      ps[d] = __ldg(a.psi + (u * a.S + x.s) * a.P + p);
      am = __ldg(a.amp + (u * a.n_sa + (a.n_sa > 1 ? x.s : 0)) * a.P + p);
      if (R > 1) {
        const int nr = x.r / a.r1;
        rx = render::phasor(__fadd_rn(
            __fmul_rn(static_cast<float>(x.r - nr * a.r1),
                      __ldg(a.gry + row)),
            __fmul_rn(static_cast<float>(nr), __ldg(a.grz + row))));
      }
    }
    ca[d] = make_float2(am * rx.x, am * rx.y);
  }
  const int sg = kg % kGStages;
  if (kg >= kGStages) render::bar_sync(kGEmpty + sg, kGRing);  // drained
  build_g(om, ps, ca, x.k0, ks, cg, g_st + sg * 2 * kGPlane);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  render::bar_arrive(kGFull + sg, kGRing);
  ++kg;
}

// Producers: every item's operands of their ring in the order the
// consumers take them: the a_tx warpgroups (`gp` false) each chunk's a_tx
// slices, once per item with one chunk, else once per output tile; the g
// warpgroup (`gp`) g of every output tile and chunk.
__device__ __forceinline__ void produce(const Args& a, bool gp, float* x_st,
                                        float* g_st) {
  const int id = threadIdx.x - kConsumers - (gp ? kXProducers : 0);
  const int w = id >> 5, lane = id & 31;
  int k = 0;                         // stages of the ring
  const int n_x = a.n_ch == 1 ? 1 : a.n_tiles;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const size_t u = static_cast<size_t>(it % a.U);
    if (gp) {
      for (int tile = 0; tile < a.n_tiles; ++tile)
        for (int c = 0; c < a.n_ch; ++c)
          produce_g(a, u, tile, c, w, lane, g_st, k);
    } else {
      for (int o = 0; o < n_x; ++o)
        for (int c = 0; c < a.n_ch; ++c)
          produce_x(a, u, c, w, lane, x_st, k);
    }
  }
  // The consumers release the ring's last stages too.
  const int n_st = gp ? kGStages : kXStages;
  for (int j = k < n_st ? 0 : k - n_st; j < k; ++j)
    render::bar_sync((gp ? kGEmpty : kXEmpty) + j % n_st,
                     gp ? kGRing : kXRing);
}

// Consumers: conj(W) of beams b0 .. b0 + kBeams - 1 as the fold's A
// operand [kM x depth], split into hi and lo planes: row 16 v + g + 8 h
// holds part h (0: re, 1: im) of beam b0 + 8 v + g, so that a thread's
// accumulator rows ra and ra + 8 are the two parts of one beam; zeros
// past B and T.
__device__ __forceinline__ void stage_codebook(const Args& a, int b0,
                                               float* w) {
  const int depth = a.n_sl * kTS;
  for (int idx = threadIdx.x; idx < kM * depth; idx += kConsumers) {
    const int m = idx & (kM - 1), t = idx / kM;
    const int b = b0 + 8 * (m >> 4) + (m & 7);
    float v = 0.f;
    if (b < a.B && t < a.T) {
      const float2 c = a.cw[static_cast<size_t>(t) * a.B + b];
      v = (m & 8) ? c.y : c.x;
    }
    const Split s = render::split(v);
    const int o = wg::offset(m, t, kM);
    w[o] = __uint_as_float(s.hi);
    w[kWPlane + o] = __uint_as_float(s.lo);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  render::bar_sync(kConsBar, kConsumers);
}

// E of the chunk as the path sum's A fragments of its 8 k-steps, hi and lo.
struct EFrags {
  uint32_t h[8][4], l[8][4];
};

__device__ __forceinline__ void fence_frags(EFrags& f) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    wg::fence_regs(f.h[ks]);
    wg::fence_regs(f.l[ks]);
  }
}

// Consumers: the fold of the chunk, D = conj(W) . X over the a_tx slices
// at 3xTF32; a slice's products run on while the next slice's are issued,
// and its stage is released once they are done (acc 0 starts the sum at
// its first product). Then E: this thread's accumulators of column block
// j hold, for the two parts (rows ra, ra + 8) of its beam and the two
// parts (columns 2 t, 2 t + 1) of path 4 j + t, cr ar, cr ai, ci ar and
// ci ai, so Er = cr ar - ci ai and Ei = cr ai + ci ar. Path-sum k-step j has depths t and t + 4 at parts
// re and im of path 4 j + t, so its A fragment, the real form [[Er, -Ei],
// [Ei, Er]] of E, is this thread's own: a = (Er, Ei, -Ei, Er).
__device__ __forceinline__ void fold(const Args& a, uint64_t dwh,
                                     uint64_t dwl, const float* x_st,
                                     int& kx, EFrags& f) {
  float d[32];
  for (int sl = 0; sl < a.n_sl; ++sl, ++kx) {
    const int sg = kx % kXStages;
    render::bar_sync(kXFull + sg, kXRing);               // a_tx of slice sl
    const float* x = x_st + sg * 2 * kXPlane;
    const uint64_t xh = wg::desc(x, kNX), xl = wg::desc(x + kXPlane, kNX);
    wg::fence_regs(d);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kTS / 8; ++ks) {
      const int kw = sl * (kTS / 8) + ks;
      const uint64_t bh = wg::step(xh, ks, kNX), bl = wg::step(xl, ks, kNX);
      wg::mma_n64_ss(d, wg::step(dwl, kw, kM), bh, sl + ks);  // lo . hi
      wg::mma_n64_ss(d, wg::step(dwh, kw, kM), bl);           // hi . lo
      wg::mma_n64_ss(d, wg::step(dwh, kw, kM), bh);           // hi . hi
    }
    wg::commit();
    if (sl > 0) {                    // the previous slice's products done
      wg::wait_one();
      render::bar_arrive(kXEmpty + (kx - 1) % kXStages, kXRing);
    }
  }
  wg::wait_all();
  wg::fence_regs(d);
  render::bar_arrive(kXEmpty + (kx - 1) % kXStages, kXRing);  // reusable
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const Split re = render::split(d[4 * j] - d[4 * j + 3]);
    const Split im = render::split(d[4 * j + 1] + d[4 * j + 2]);
    const Split nim = render::neg(im);
    f.h[j][0] = re.hi;
    f.h[j][1] = im.hi;
    f.h[j][2] = nim.hi;
    f.h[j][3] = re.hi;
    f.l[j][0] = re.lo;
    f.l[j][1] = im.lo;
    f.l[j][2] = nim.lo;
    f.l[j][3] = re.lo;
  }
}

// Consumers: y = E . g of the stage at 3xTF32, plus y unless `acc` is 0:
// rows ra and ra + 8 of the accumulator are Re y and Im y of the thread's
// beam.
__device__ __forceinline__ void path_sum(float (&y)[32], EFrags& f,
                                         const float* g, int acc) {
  const uint64_t gh = wg::desc(g, kKt), gl = wg::desc(g + kGPlane, kKt);
  wg::fence_regs(y);
  fence_frags(f);
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < kDG / 8; ++ks) {
    const uint64_t bh = wg::step(gh, ks, kKt), bl = wg::step(gl, ks, kKt);
    wg::mma_n64_rs(y, f.l[ks], bh, ks ? 1 : acc);             // lo . hi
    wg::mma_n64_rs(y, f.h[ks], bl);                           // hi . lo
    wg::mma_n64_rs(y, f.h[ks], bh);                           // hi . hi
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(y);
  fence_frags(f);
}

// Consumers: G = |y|^2 of the thread's beam b0 + bl and the tile's
// columns 16 i + 4 t .. + 3 (i < 4) as float4 streaming stores; beams
// past B and columns past K skipped.
__device__ __forceinline__ void store_power(const Args& a, size_t u, int b0,
                                            const Tile& x, int bl, int t,
                                            const float (&y)[32]) {
  const int b = b0 + bl;
  if (b >= a.B) return;
  const size_t sk = static_cast<size_t>(a.S) * a.K;
  const int R = a.r1 * a.r2;
  const int cols = render::imin(kKt, a.K - x.k0);
  float* o = a.out + ((u * R + x.r) * a.B + b) * sk +
             static_cast<size_t>(x.s) * a.K + x.k0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kl = 16 * i + 4 * t;
    if (kl >= cols) continue;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 2 * i + (c >> 1);
      const float yr = y[4 * j + (c & 1)], yi = y[4 * j + 2 + (c & 1)];
      v[c] = yr * yr + yi * yi;
    }
    if (a.vec) {                     // cols is a multiple of 4 here
      __stcs(reinterpret_cast<float4*>(o + kl),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (kl + c < cols) __stcs(o + kl + c, v[c]);
    }
  }
}

// Per item (a user and a tile of kBeams beams): conj(W) of the tile stays
// in shared memory for every user the block takes with it, while a_tx
// passes through in slices of kTS depths. kOneChunk: P <= kPc, E folded
// once per item and kept for every output tile; else every output tile
// folds each chunk again and sums over the n_ch chunks.
template <bool kOneChunk>
__global__ void __launch_bounds__(kThreads, 1)
beamgain_kernel_wide(Args a) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);        // [hi, lo][kWPlane]
  float* x_st = w + 2 * kWPlane;         // [kXStages][hi, lo][kXPlane]
  float* g_st = x_st + kXStages * 2 * kXPlane;  // [kGStages][hi, lo][..]
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce(a, threadIdx.x >= kConsumers + kXProducers, x_st, g_st);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31;
  const int bl = 8 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
  const uint64_t dwh = wg::desc(w, kM), dwl = wg::desc(w + kWPlane, kM);
  EFrags f;                          // E of the chunk
  float y[32];                       // column block j: y[4 j .. 4 j + 3]
  int kx = 0, kg = 0, staged = -1;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const int bt = it / a.U, b0 = bt * kBeams;
    const size_t u = static_cast<size_t>(it - bt * a.U);
    if (bt != staged) {              // every earlier product has completed
      if (staged >= 0) render::bar_sync(kConsBar, kConsumers);
      stage_codebook(a, b0, w);
      staged = bt;
    }
    if (kOneChunk) {
      fold(a, dwh, dwl, x_st, kx, f);
      for (int tile = 0; tile < a.n_tiles; ++tile, ++kg) {
        const int sg = kg % kGStages;
        render::bar_sync(kGFull + sg, kGRing);          // g of the tile
        path_sum(y, f, g_st + sg * 2 * kGPlane, 0);
        render::bar_arrive(kGEmpty + sg, kGRing);       // may be rebuilt
        store_power(a, u, b0, tile_at(a, tile), bl, t, y);
      }
    } else {
      for (int tile = 0; tile < a.n_tiles; ++tile) {
        for (int c = 0; c < a.n_ch; ++c, ++kg) {
          fold(a, dwh, dwl, x_st, kx, f);
          const int sg = kg % kGStages;
          render::bar_sync(kGFull + sg, kGRing);
          path_sum(y, f, g_st + sg * 2 * kGPlane, c);
          render::bar_arrive(kGEmpty + sg, kGRing);
        }
        store_power(a, u, b0, tile_at(a, tile), bl, t, y);
      }
    }
  }
}

cudaError_t launch(const ::Args<float>& s, const void* cw,
                   cudaStream_t stream) {
  Args a{s.gry, s.grz, s.gty, s.gtz, s.amp, s.psi, s.omega,
         static_cast<const float2*>(cw), s.out, s.U, s.P, s.r1, s.r2, s.t1,
         s.t2, s.t1 * s.t2, s.B, s.K, s.S, s.n_sa, 0, 0, 0, 0, 0, 0};
  if (a.T > kTMax) return cudaErrorInvalidValue;
  a.n_ch = (a.P + kPc - 1) / kPc;
  a.n_kt = (a.K + kKt - 1) / kKt;
  a.n_sl = (a.T + kTS - 1) / kTS;
  const long long items =
      static_cast<long long>((a.B + kBeams - 1) / kBeams) * a.U;
  const long long tiles = static_cast<long long>(a.r1) * a.r2 * a.S * a.n_kt;
  if (items > 0x3fffffff || tiles * a.n_ch > 0x3fffffff)
    return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  a.n_tiles = static_cast<int>(tiles);
  a.vec = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const auto kernel = a.n_ch == 1 ? beamgain_kernel_wide<true>
                                  : beamgain_kernel_wide<false>;
  const int smem = static_cast<int>(kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long full = static_cast<long long>(per_sm) * n_sm;
  const int grid = static_cast<int>(items < full ? items : full);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tcw

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
// out [U, R*B, n_s*n_k]. Mode 1 rounds the path sum's operands to bf16;
// mode 3 runs the tensor-core design (float32, T <= 64), mode 4 its wide
// design (float32, 64 < T <= 256; cudaErrorInvalidValue past 256).
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
  if (mode == 3) return tc::launch(a, cw, st);
  if (mode == 4) return tcw::launch(a, cw, st);
  return mode == 1 ? launch<float, true>(a, cw, n_users, st)
                   : launch<float, false>(a, cw, n_users, st);
}
