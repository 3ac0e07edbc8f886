// Shared register-tiled complex product of the path-sum kernel
// (pathsum.cu):
//
//   Y[q, kk] = sum_n A[n, q] B[n, kk]
//
// for one user, with A and B already staged in shared memory as [N][Q] and
// [N][K] real/imag planes. Each of the kTQ x kTK threads owns a kRQ x kRK
// register tile of complex outputs per (kTQ*kRQ) x (kTK*kRK) output tile, so
// kRQ + kRK complex shared-memory loads feed 4*kRQ*kRK FMAs; the A loads are
// warp broadcasts and the B loads consecutive words. Neighbouring threads
// own neighbouring kk, so the epilogue's stores along kk are contiguous. Any
// Q and K are taken: the tile loops clamp their loads and skip the epilogue
// at the ragged edge. The epilogue is called once per output as
// epi(q, kk, re, im).
//
// The path sum runs the 16 x 16 thread, 4 x 4 tile layout of store_tiles
// (64 x 64 output tiles).

#pragma once

#include <cstddef>

namespace path_sum {

template <int kTQ, int kTK, int kRQ, int kRK, class Epilogue>
__device__ __forceinline__ void tile_loop(
    const float* __restrict__ ar, const float* __restrict__ ai,
    const float* __restrict__ br, const float* __restrict__ bi, int N, int Q,
    int K, Epilogue epi) {
  constexpr int kBlockQ = kTQ * kRQ;
  constexpr int kBlockK = kTK * kRK;
  const int tx = threadIdx.x % kTK;
  const int ty = threadIdx.x / kTK;
  for (int q0 = 0; q0 < Q; q0 += kBlockQ) {
    for (int k0 = 0; k0 < K; k0 += kBlockK) {
      int qi[kRQ], ki[kRK];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) qi[i] = min(q0 + ty + i * kTQ, Q - 1);
#pragma unroll
      for (int j = 0; j < kRK; ++j) ki[j] = min(k0 + tx + j * kTK, K - 1);

      float yr[kRQ][kRK], yi[kRQ][kRK];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
#pragma unroll
        for (int j = 0; j < kRK; ++j) {
          yr[i][j] = 0.f;
          yi[i][j] = 0.f;
        }
      }
      for (int n = 0; n < N; ++n) {
        float a_r[kRQ], a_i[kRQ], b_r[kRK], b_i[kRK];
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          a_r[i] = ar[n * Q + qi[i]];
          a_i[i] = ai[n * Q + qi[i]];
        }
#pragma unroll
        for (int j = 0; j < kRK; ++j) {
          b_r[j] = br[n * K + ki[j]];
          b_i[j] = bi[n * K + ki[j]];
        }
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
#pragma unroll
          for (int j = 0; j < kRK; ++j) {
            yr[i][j] = fmaf(a_r[i], b_r[j], fmaf(-a_i[i], b_i[j], yr[i][j]));
            yi[i][j] = fmaf(a_r[i], b_i[j], fmaf(a_i[i], b_r[j], yi[i][j]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const int q = q0 + ty + i * kTQ;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < kRK; ++j) {
          const int kk = k0 + tx + j * kTK;
          if (kk >= K) continue;
          epi(q, kk, yr[i][j], yi[i][j]);
        }
      }
    }
  }
}

// Threads of the render and path-sum blocks (the store_tiles layout).
constexpr int kThreads = 256;

// Epilogue of H planes: out_r[q * stride + kk] and out_i[q * stride + kk].
struct StorePlanes {
  float* out_r;
  float* out_i;
  size_t stride;
  __device__ __forceinline__ void operator()(int q, int kk, float re,
                                             float im) const {
    out_r[q * stride + kk] = re;
    out_i[q * stride + kk] = im;
  }
};

// H[q, kk] = sum_p E[q, p] g[kk, p] from E [P][Q] and g [P][SK], written to
// out_r/out_i for q < Q, kk < SK. Call with all kThreads threads after the
// staging __syncthreads.
__device__ __forceinline__ void store_tiles(
    const float* __restrict__ er, const float* __restrict__ ei,
    const float* __restrict__ gr, const float* __restrict__ gi, int P, int Q,
    int SK, float* out_r, float* out_i, size_t stride) {
  tile_loop<16, 16, 4, 4>(er, ei, gr, gi, P, Q, SK,
                          StorePlanes{out_r, out_i, stride});
}

}  // namespace path_sum
