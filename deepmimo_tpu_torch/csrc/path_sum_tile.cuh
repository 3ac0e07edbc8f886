// Shared tile loop of the forward path-sum kernels (render_fwd.cu,
// pathsum.cu): H[q, kk] = sum_p E[q, p] g[kk, p] for one user, with E and g
// already staged in shared memory as [P][Q] and [P][SK] real/imag planes.
//
// Each of the 256 threads owns a 4 x 4 register tile of complex outputs per
// 64 x 64 output tile: 16 shared-memory loads feed 64 FMAs, and the loads
// are warp broadcasts (E) or consecutive words (g). Neighbouring threads own
// neighbouring kk, so each store row is contiguous. Any Q and SK are taken:
// the tile loops clamp their loads and mask their stores at the ragged edge.

#pragma once

namespace path_sum {

constexpr int kThreadsK = 16;                  // threads along kk
constexpr int kThreadsQ = 16;                  // threads along q
constexpr int kTileK = 4;                      // outputs per thread along kk
constexpr int kTileQ = 4;                      // outputs per thread along q
constexpr int kThreads = kThreadsK * kThreadsQ;
constexpr int kBlockK = kThreadsK * kTileK;    // output tile width
constexpr int kBlockQ = kThreadsQ * kTileQ;    // output tile height

// Writes out_r[q * stride + kk] and out_i[q * stride + kk] for q < Q,
// kk < SK. Call with all kThreads threads after the staging __syncthreads.
__device__ __forceinline__ void store_tiles(
    const float* __restrict__ er, const float* __restrict__ ei,
    const float* __restrict__ gr, const float* __restrict__ gi, int P, int Q,
    int SK, float* __restrict__ out_r, float* __restrict__ out_i,
    size_t stride) {
  const int tx = threadIdx.x % kThreadsK;
  const int ty = threadIdx.x / kThreadsK;
  for (int q0 = 0; q0 < Q; q0 += kBlockQ) {
    for (int k0 = 0; k0 < SK; k0 += kBlockK) {
      int qi[kTileQ], ki[kTileK];
#pragma unroll
      for (int i = 0; i < kTileQ; ++i) qi[i] = min(q0 + ty + i * kThreadsQ, Q - 1);
#pragma unroll
      for (int j = 0; j < kTileK; ++j) ki[j] = min(k0 + tx + j * kThreadsK, SK - 1);

      float hr[kTileQ][kTileK], hi[kTileQ][kTileK];
#pragma unroll
      for (int i = 0; i < kTileQ; ++i) {
#pragma unroll
        for (int j = 0; j < kTileK; ++j) {
          hr[i][j] = 0.f;
          hi[i][j] = 0.f;
        }
      }
      for (int p = 0; p < P; ++p) {
        float a_r[kTileQ], a_i[kTileQ], b_r[kTileK], b_i[kTileK];
#pragma unroll
        for (int i = 0; i < kTileQ; ++i) {
          a_r[i] = er[p * Q + qi[i]];
          a_i[i] = ei[p * Q + qi[i]];
        }
#pragma unroll
        for (int j = 0; j < kTileK; ++j) {
          b_r[j] = gr[p * SK + ki[j]];
          b_i[j] = gi[p * SK + ki[j]];
        }
#pragma unroll
        for (int i = 0; i < kTileQ; ++i) {
#pragma unroll
          for (int j = 0; j < kTileK; ++j) {
            hr[i][j] = fmaf(a_r[i], b_r[j], fmaf(-a_i[i], b_i[j], hr[i][j]));
            hi[i][j] = fmaf(a_r[i], b_i[j], fmaf(a_i[i], b_r[j], hi[i][j]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTileQ; ++i) {
        const int q = q0 + ty + i * kThreadsQ;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < kTileK; ++j) {
          const int kk = k0 + tx + j * kThreadsK;
          if (kk >= SK) continue;
          out_r[q * stride + kk] = hr[i][j];
          out_i[q * stride + kk] = hi[i][j];
        }
      }
    }
  }
}

}  // namespace path_sum
