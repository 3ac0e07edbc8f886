// Fused channel render for Hopper: per-path scalars in, H planes out.
//
// Replaces the TPU kernel deepmimo_tpu/ops/pallas/render.py::_kernel (and
// _kernel_norx). For one user u, with panel element t = n*M1 + m, output
// row q = r*T + t and output column kk = s*K + k:
//
//   E[q, p]  = exp(j (m_r gry + n_r grz + m_t gty + n_t gtz))
//   g[kk, p] = amp[s or 0, p] * exp(j (psi[s, p] - omega[p] * k))
//   H[q, kk] = sum_p E[q, p] g[kk, p]
//
// which is render.py::_reference_impl. E = a_rx (x) a_tx is formed as one
// phasor of the summed RX and TX phases.
//
// What bounds it on an H100: at the headline shape (P = 25, Q = 64,
// S*K = 64) every user writes 32 KB of H (4.29 GB per 131,072 users, about
// 1.3 ms at 3.35 TB/s) and does 8*Q*SK*P = 819,200 FP32 flops (about
// 1.6 ms at 67 TFLOP/s). Inputs are 7 [U, P] arrays, a few percent of the
// bytes. Design:
//   - one block per user; E and g of all P paths are built once in shared
//     memory (8*P*(Q + SK) bytes, 25.6 KB at the headline), so the trig
//     runs (Q + SK)*P times per user, not Q*SK*P;
//   - the path sum is the shared tile loop of path_sum_tile.cuh (4 x 4
//     complex register tiles, contiguous store rows);
//   - phases use sincosf (full range reduction): omega*k reaches ~31 rad at
//     the headline, where the fast intrinsics lose digits.
// Ragged U needs no mask: the grid has exactly one block per user.

#include <cuda_runtime.h>

#include "path_sum_tile.cuh"

namespace {

using path_sum::kThreads;

__global__ void __launch_bounds__(kThreads)
render_fwd_kernel(const float* __restrict__ gry, const float* __restrict__ grz,
                  const float* __restrict__ gty, const float* __restrict__ gtz,
                  const float* __restrict__ amp, const float* __restrict__ psi,
                  const float* __restrict__ omega, float* __restrict__ out,
                  int n_users, int n_paths, int r1, int r2, int t1, int t2,
                  int n_k, int n_s, int n_sa, int packed) {
  extern __shared__ float smem[];
  const int u = blockIdx.x;
  const int P = n_paths;
  const int T = t1 * t2;
  const int Q = r1 * r2 * T;
  const int SK = n_s * n_k;
  float* er = smem;              // [P][Q]
  float* ei = er + P * Q;        // [P][Q]
  float* gr = ei + P * Q;        // [P][SK]
  float* gi = gr + P * SK;       // [P][SK]

  const size_t row = static_cast<size_t>(u) * P;
  const int tid = threadIdx.x;

  // Panel outer product E = a_rx (x) a_tx.
  for (int idx = tid; idx < P * Q; idx += kThreads) {
    const int p = idx / Q;
    const int q = idx - p * Q;
    const int r = q / T;
    const int t = q - r * T;
    float ph = static_cast<float>(t % t1) * gty[row + p] +
               static_cast<float>(t / t1) * gtz[row + p];
    if (r > 0) {
      ph += static_cast<float>(r % r1) * gry[row + p] +
            static_cast<float>(r / r1) * grz[row + p];
    }
    float s, c;
    sincosf(ph, &s, &c);
    er[idx] = c;
    ei[idx] = s;
  }
  // OFDM path gains, snapshot-major along kk.
  for (int idx = tid; idx < P * SK; idx += kThreads) {
    const int p = idx / SK;
    const int kk = idx - p * SK;
    const int s = kk / n_k;
    const int k = kk - s * n_k;
    const float a = amp[static_cast<size_t>(u) * n_sa * P +
                        (n_sa > 1 ? s * P : 0) + p];
    const float base = psi[static_cast<size_t>(u) * n_s * P + s * P + p] -
                       omega[row + p] * static_cast<float>(k);
    float sn, cs;
    sincosf(base, &sn, &cs);
    gr[idx] = a * cs;
    gi[idx] = a * sn;
  }
  __syncthreads();

  // Packed [U, Q, 2*SK] (hr | hi on each row) or stacked [2, U, Q, SK].
  const size_t stride = packed ? 2 * static_cast<size_t>(SK) : SK;
  float* out_r = out + static_cast<size_t>(u) * Q * stride;
  float* out_i = packed ? out_r + SK
                        : out + (static_cast<size_t>(n_users) + u) * Q * SK;

  path_sum::store_tiles(er, ei, gr, gi, P, Q, SK, out_r, out_i, stride);
}

}  // namespace

// Launches the render on `stream`. Pointers are device pointers to
// contiguous float32 arrays: gry..gtz and omega [U, P], amp [U, n_sa*P],
// psi [U, n_s*P], out as described above. Returns the cudaError_t of the
// launch (0 on success); the kernel itself is not waited for.
extern "C" int render_fwd_launch(const float* gry, const float* grz,
                                 const float* gty, const float* gtz,
                                 const float* amp, const float* psi,
                                 const float* omega, float* out, int n_users,
                                 int n_paths, int r1, int r2, int t1, int t2,
                                 int n_k, int n_s, int n_sa, int packed,
                                 void* stream) {
  if (n_users == 0) return cudaSuccess;
  const int q = r1 * r2 * t1 * t2;
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(n_paths) *
                      (q + static_cast<size_t>(n_s) * n_k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  render_fwd_kernel<<<n_users, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      gry, grz, gty, gtz, amp, psi, omega, out, n_users, n_paths, r1, r2, t1,
      t2, n_k, n_s, n_sa, packed);
  return cudaGetLastError();
}
