// Fused beam-gain maps for Hopper: per-path scalars and a codebook in,
// G = |conj(W) . H|^2 out, H never formed.
//
// Replaces the TPU kernel deepmimo_tpu/ops/pallas/beamgain.py::_bg_kernel
// (and _bg_kernel_norx; wrapper _fused_beam_gain_impl). For one user u, with
// TX element t = n*T1 + m, RX element r, beam b, output row q = r*B + b and
// output column kk = s*K + k:
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
// What bounds it on an H100: at the headline (P = 25, T = 64, B = 16,
// R = 1, K = 64) a user does B*T*P complex MACs in the fold and
// R*B*S*K*P in the path sum (409,600 FP32 flops together) and 3,200
// sincosf, and stores only 4 KB of G (0.54 GB per 131,072 users, 0.16 ms at
// 3.35 TB/s), so FP32 FMA throughput and the trig bound it (0.8 ms of FMA
// at 67 TFLOP/s). Design:
//   - one block of 128 threads per user; the conjugated codebook [T][B]
//     (transposed by the wrapper, so staging it is a straight copy free of
//     bank conflicts), a_tx [T][P], E [P][Q] and (R > 1) a_rx [P][R] are
//     staged in shared memory; the path sum runs one slot s at a time, with
//     that slot's g [P][K] over a_tx's space once the fold is done, so a
//     block holds 8*(T*B + P*max(T, K) + P*Q [+ P*R]) bytes for any number
//     of slots (24.2 KB at the headline and with the four dual-polar
//     slots, which would take 62.6 KB with all slots' g at once);
//   - the fold and the path sum are the register-tiled loop of
//     path_sum_tile.cuh in FP32 FMA (no TF32), each with a thread layout
//     that fits its small output: the fold's P x B outputs in 32 x 16
//     tiles of 2 x 2, each slot's Q x K in 16 x 64 tiles of 4 x 2, so
//     Q = 16 and K = 64 run no clamped duplicate rows or columns;
//   - the fold's epilogue writes E straight into shared memory (times a_rx
//     when R > 1), and the path sum's epilogue stores |y|^2.
// Invalid paths arrive with zero amp and zero phases from the wrapper.
// Ragged U needs no mask: the grid has exactly one block per user.

#include <cuda_runtime.h>

#include "path_sum_tile.cuh"

namespace {

constexpr int kThreads = 128;
// Fold: rows p, columns b, reduction over t.
constexpr int kFoldTQ = 16, kFoldTK = 8, kFoldRQ = 2, kFoldRK = 2;
// Path sum: rows q = r*B + b, columns kk, reduction over p.
constexpr int kSumTQ = 4, kSumTK = 32, kSumRQ = 4, kSumRK = 2;
static_assert(kFoldTQ * kFoldTK == kThreads, "fold layout");
static_assert(kSumTQ * kSumTK == kThreads, "path-sum layout");

// E[p][r*B + b] = a_rx[p][r] * eb[p][b] (eb itself when R = 1).
struct FoldIntoE {
  float* er;
  float* ei;
  const float* xr;
  const float* xi;
  int R, B, Q;
  __device__ __forceinline__ void operator()(int p, int b, float re,
                                             float im) const {
    if (R == 1) {
      er[p * Q + b] = re;
      ei[p * Q + b] = im;
      return;
    }
    for (int r = 0; r < R; ++r) {
      const float cr = xr[p * R + r], ci = xi[p * R + r];
      er[p * Q + r * B + b] = cr * re - ci * im;
      ei[p * Q + r * B + b] = cr * im + ci * re;
    }
  }
};

// G[q][k] = |y|^2 at out[q * stride + k].
struct StorePower {
  float* out;
  int stride;
  __device__ __forceinline__ void operator()(int q, int k, float re,
                                             float im) const {
    out[static_cast<size_t>(q) * stride + k] = re * re + im * im;
  }
};

__global__ void __launch_bounds__(kThreads)
beamgain_kernel(const float* __restrict__ gry, const float* __restrict__ grz,
                const float* __restrict__ gty, const float* __restrict__ gtz,
                const float* __restrict__ amp, const float* __restrict__ psi,
                const float* __restrict__ omega, const float* __restrict__ cw,
                float* __restrict__ out,
                int n_paths, int r1, int r2, int t1, int t2, int n_beams,
                int n_k, int n_s, int n_sa) {
  extern __shared__ float smem[];
  const int u = blockIdx.x;
  const int P = n_paths;
  const int T = t1 * t2;
  const int R = r1 * r2;
  const int B = n_beams;
  const int Q = R * B;
  const int K = n_k;
  const int X = max(T, K);
  float* cwr = smem;             // [T][B] conj(W)
  float* cwi = cwr + T * B;
  float* xr = cwi + T * B;       // [T][P] a_tx, then one slot's [P][K] g
  float* xi = xr + P * X;
  float* er = xi + P * X;        // [P][Q]
  float* ei = er + P * Q;
  float* rr = ei + P * Q;        // [P][R] a_rx, R > 1 only
  float* ri = rr + P * R;

  const size_t row = static_cast<size_t>(u) * P;
  const int tid = threadIdx.x;

  // Conjugated codebook [2][T][B], as given.
  for (int idx = tid; idx < 2 * T * B; idx += kThreads) cwr[idx] = cw[idx];
  // TX panel responses a_tx [T][P].
  for (int idx = tid; idx < T * P; idx += kThreads) {
    const int t = idx / P;
    const int p = idx - t * P;
    float s, c;
    sincosf(static_cast<float>(t % t1) * gty[row + p] +
                static_cast<float>(t / t1) * gtz[row + p],
            &s, &c);
    xr[idx] = c;
    xi[idx] = s;
  }
  // RX panel responses a_rx [P][R].
  if (R > 1) {
    for (int idx = tid; idx < P * R; idx += kThreads) {
      const int p = idx / R;
      const int r = idx - p * R;
      float s, c;
      sincosf(static_cast<float>(r % r1) * gry[row + p] +
                  static_cast<float>(r / r1) * grz[row + p],
              &s, &c);
      rr[idx] = c;
      ri[idx] = s;
    }
  }
  __syncthreads();

  // Codebook fold eb = a_tx^T conj(W)^T, chained into E.
  path_sum::tile_loop<kFoldTQ, kFoldTK, kFoldRQ, kFoldRK>(
      xr, xi, cwr, cwi, T, P, B, FoldIntoE{er, ei, rr, ri, R, B, Q});

  float* out_u = out + static_cast<size_t>(u) * Q * n_s * K;
  for (int s = 0; s < n_s; ++s) {
    __syncthreads();             // the fold, or the last slot, is done
    // OFDM path gains of slot s, g [P][K], over a_tx's space.
    const float* amp_s = amp + static_cast<size_t>(u) * n_sa * P +
                         (n_sa > 1 ? s * P : 0);
    const float* psi_s = psi + static_cast<size_t>(u) * n_s * P + s * P;
    for (int idx = tid; idx < P * K; idx += kThreads) {
      const int p = idx / K;
      const int k = idx - p * K;
      float sn, cs;
      sincosf(psi_s[p] - omega[row + p] * static_cast<float>(k), &sn, &cs);
      xr[idx] = amp_s[p] * cs;
      xi[idx] = amp_s[p] * sn;
    }
    __syncthreads();
    // Path sum with the power epilogue into columns s*K .. s*K + K - 1.
    path_sum::tile_loop<kSumTQ, kSumTK, kSumRQ, kSumRK>(
        er, ei, xr, xi, P, Q, K, StorePower{out_u + s * K, n_s * K});
  }
}

// Shared memory of one block in bytes; ops/kernels/beamgain.py's
// smem_bytes mirrors it.
size_t smem_bytes(int n_paths, int n_rx, int n_tx, int n_beams, int n_k) {
  const size_t x = n_tx > n_k ? n_tx : n_k;
  const size_t p = n_paths;
  return sizeof(float) * 2 *
         (static_cast<size_t>(n_tx) * n_beams + p * x +
          p * n_rx * n_beams + (n_rx > 1 ? p * n_rx : 0));
}

}  // namespace

// Launches the beam-gain kernel on `stream`. Pointers are device pointers to
// contiguous float32 arrays: gry..gtz and omega [U, P], amp [U, n_sa*P],
// psi [U, n_s*P], cw [2, T, B] (the real and imaginary planes of conj(W)
// transposed), out [U, R*B, n_s*n_k]. Returns the
// cudaError_t of the launch (0 on success); the kernel is not waited for.
extern "C" int beamgain_launch(const float* gry, const float* grz,
                               const float* gty, const float* gtz,
                               const float* amp, const float* psi,
                               const float* omega, const float* cw,
                               float* out, int n_users,
                               int n_paths, int r1, int r2, int t1, int t2,
                               int n_beams, int n_k, int n_s, int n_sa,
                               void* stream) {
  if (n_users == 0) return cudaSuccess;
  const size_t smem =
      smem_bytes(n_paths, r1 * r2, t1 * t2, n_beams, n_k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beamgain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  beamgain_kernel<<<n_users, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      gry, grz, gty, gtz, amp, psi, omega, cw, out, n_paths, r1, r2, t1,
      t2, n_beams, n_k, n_s, n_sa);
  return cudaGetLastError();
}
