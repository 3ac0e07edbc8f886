// Backward of the fused channel render for Hopper: cotangent of H in, the
// gradients of the 7 per-path scalars out.
//
// Replaces the TPU kernel deepmimo_tpu/ops/pallas/render.py::_bwd_kernel
// (and _bwd_kernel_norx; wrapper _bwd_impl, VJP rule _bwd). Forward, for
// one user (render_fwd.cu): E[q, p] = exp(j phi[q, p]) with
// phi = m_r gry + n_r grz + m_t gty + n_t gtz, g[kk, p] = a[s, p] exp(j b),
// b = psi[s, p] - omega[p] k, kk = s*K + k, and H = E g^T. With the
// cotangent ct = cr + j ci of H:
//
//   dE_r = ct_r . g_r + ct_i . g_i        dE_i = ct_i . g_r - ct_r . g_i
//   dG_r = ct_r^T . E_r + ct_i^T . E_i    dG_i = ct_i^T . E_r - ct_r^T . E_i
//
// (render.py:755-762), chained in the block to the outputs (:765-797):
//   damp[s or 0, p] = sum_k dG_r cb + dG_i sb     (cb + j sb = exp(j b))
//   dpsi[s, p]      = sum_k w,  domega[p] = -sum_{s,k} k w,
//                     w = g_r dG_i - g_i dG_r
//   dphi[q, p]      = E_r dE_i - E_i dE_r,  dgty = sum_q m_t(q) dphi, and
//                     likewise dgtz (n_t), dgry (m_r), dgrz (n_r).
// E is one phasor of the summed phase, so the panel chain needs no separate
// a_rx / a_tx; with a single RX antenna dgry = dgrz = 0 exactly.
//
// What bounds it on an H100: at the headline shape (P = 25, Q = 64,
// S*K = 64) it reads ct once (32 KB per user, 4.29 GB per 131,072 users,
// about 1.3 ms at 3.35 TB/s) and does two contractions the size of the
// forward's path sum, 2 * 8*Q*SK*P = 1.64 MFLOP per user (2.15e11 in all,
// about 3.2 ms at 67 TFLOP/s FP32): FMA throughput binds. Design:
//   - one block per user and every accumulator on chip: the chains above
//     are linear, so each (q tile, kk tile) step folds its partial dE rows
//     and dG columns straight into per-path sums; nothing of size
//     [Q, P] or [SK, P] is kept across tiles or written to HBM;
//   - the block walks paths in chunks of 32 (one path per lane), q in
//     tiles of 64 rows and kk in tiles of 64 columns inside one slot, so
//     shared memory is a constant 87 KB for any shape and every shape the
//     forward kernel takes is taken here; at the headline each loop runs
//     once and ct is read once;
//   - E and the gain planes of a tile are rebuilt in shared memory with
//     sincosf (full range reduction, as the forward), the ct tile is
//     staged there with coalesced loads, zero-padded at ragged edges;
//   - each thread holds 8 rows of dE and 8 columns of dG for its path in
//     registers; ct reads are warp broadcasts and E / g reads are float4
//     on padded rows, so shared-memory traffic stays below the FMAs;
//   - the per-path sums are reduced across the 8 warps through shared
//     memory; lane p of warp 0 owns path p's outputs for the whole block
//     and is their only reader and writer, so no atomics are needed and
//     the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPaths = 32;                   // paths per chunk: one per lane
constexpr int kTQ = 64;                      // q rows per tile
constexpr int kTK = 64;                      // k columns per tile
constexpr int kRows = kTQ / kWarps;          // dE rows per thread
constexpr int kCols = kTK / kWarps;          // dG columns per thread
constexpr int kES = kTQ + 4;                 // padded row of the E tile
constexpr int kGS = kTK + 4;                 // padded row of the g tile
constexpr int kSmemFloats = 2 * kPaths * kES + 4 * kPaths * kGS +
                            2 * kTQ * kTK + kWarps * kPaths * 4;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__global__ void __launch_bounds__(kThreads, 2)
render_bwd_kernel(const float* __restrict__ gry, const float* __restrict__ grz,
                  const float* __restrict__ gty, const float* __restrict__ gtz,
                  const float* __restrict__ amp, const float* __restrict__ psi,
                  const float* __restrict__ omega, const float* __restrict__ ct,
                  float* __restrict__ dgry, float* __restrict__ dgrz,
                  float* __restrict__ dgty, float* __restrict__ dgtz,
                  float* __restrict__ damp, float* __restrict__ dpsi,
                  float* __restrict__ domega, int n_users, int n_paths,
                  int r1, int r2, int t1, int t2, int n_k, int n_s, int n_sa,
                  int packed) {
  extern __shared__ float4 smem4[];
  float* er_s = reinterpret_cast<float*>(smem4);   // [kPaths][kES]
  float* ei_s = er_s + kPaths * kES;
  float* cb_s = ei_s + kPaths * kES;               // [kPaths][kGS], unit
  float* sb_s = cb_s + kPaths * kGS;
  float* gr_s = sb_s + kPaths * kGS;               // [kPaths][kGS], amp-scaled
  float* gi_s = gr_s + kPaths * kGS;
  float* ctr_s = gi_s + kPaths * kGS;              // [kTQ][kTK]
  float* cti_s = ctr_s + kTQ * kTK;
  float* red_s = cti_s + kTQ * kTK;                // [kWarps][kPaths][4]

  const int u = blockIdx.x;
  const int P = n_paths;
  const int T = t1 * t2;
  const int Q = r1 * r2 * T;
  const int SK = n_s * n_k;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t row = static_cast<size_t>(u) * P;
  const size_t amp_row = static_cast<size_t>(u) * n_sa * P;
  const size_t psi_row = static_cast<size_t>(u) * n_s * P;

  // Packed [U, Q, 2*SK] (cr | ci on each row) or stacked [2, U, Q, SK].
  const size_t stride = packed ? 2 * static_cast<size_t>(SK) : SK;
  const float* ct_r = ct + static_cast<size_t>(u) * Q * stride;
  const float* ct_i = packed ? ct_r + SK
                             : ct + (static_cast<size_t>(n_users) + u) * Q * SK;

  for (int p0 = 0; p0 < P; p0 += kPaths) {
    const int p = p0 + lane;
    const bool owner = warp == 0 && p < P;      // sole reader/writer of p's
    if (owner) {                                // outputs in this block
      dgry[row + p] = 0.f;
      dgrz[row + p] = 0.f;
      dgty[row + p] = 0.f;
      dgtz[row + p] = 0.f;
      domega[row + p] = 0.f;
      for (int s = 0; s < n_s; ++s) dpsi[psi_row + s * P + p] = 0.f;
      for (int s = 0; s < n_sa; ++s) damp[amp_row + s * P + p] = 0.f;
    }

    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      __syncthreads();                // the previous tile's readers are done
      for (int idx = tid; idx < kPaths * kTQ; idx += kThreads) {
        const int pp = idx / kTQ;
        const int qq = idx - pp * kTQ;
        const int pg = p0 + pp;
        const int q = q0 + qq;
        float sn = 0.f, cs = 0.f;
        if (pg < P && q < Q) {
          const int r = q / T;
          const int t = q - r * T;
          float ph = static_cast<float>(t % t1) * gty[row + pg] +
                     static_cast<float>(t / t1) * gtz[row + pg];
          if (r > 0) {
            ph += static_cast<float>(r % r1) * gry[row + pg] +
                  static_cast<float>(r / r1) * grz[row + pg];
          }
          sincosf(ph, &sn, &cs);
        }
        er_s[pp * kES + qq] = cs;
        ei_s[pp * kES + qq] = sn;
      }

      float der[kRows], dei[kRows];          // rows q0 + warp*kRows + i
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        der[i] = 0.f;
        dei[i] = 0.f;
      }

      for (int s = 0; s < n_s; ++s) {
        for (int k0 = 0; k0 < n_k; k0 += kTK) {
          __syncthreads();            // E tile built; last g/ct tile consumed
          for (int idx = tid; idx < kPaths * kTK; idx += kThreads) {
            const int pp = idx / kTK;
            const int kc = idx - pp * kTK;
            const int pg = p0 + pp;
            const int k = k0 + kc;
            float sn = 0.f, cs = 0.f, a = 0.f;
            if (pg < P && k < n_k) {
              a = amp[amp_row + (n_sa > 1 ? s * P : 0) + pg];
              sincosf(psi[psi_row + s * P + pg] -
                          omega[row + pg] * static_cast<float>(k),
                      &sn, &cs);
            }
            cb_s[pp * kGS + kc] = cs;
            sb_s[pp * kGS + kc] = sn;
            gr_s[pp * kGS + kc] = a * cs;
            gi_s[pp * kGS + kc] = a * sn;
          }
          for (int idx = tid; idx < kTQ * kTK; idx += kThreads) {
            const int qq = idx / kTK;
            const int kc = idx - qq * kTK;
            const int q = q0 + qq;
            const int k = k0 + kc;
            float vr = 0.f, vi = 0.f;
            if (q < Q && k < n_k) {
              const size_t off = static_cast<size_t>(q) * stride +
                                 static_cast<size_t>(s) * n_k + k;
              vr = ct_r[off];
              vi = ct_i[off];
            }
            ctr_s[idx] = vr;
            cti_s[idx] = vi;
          }
          __syncthreads();

          // dE rows += ct . g (contract this tile's kk).
          const float* g_r = gr_s + lane * kGS;
          const float* g_i = gi_s + lane * kGS;
          for (int kc = 0; kc < kTK; kc += 4) {
            const float4 br = *reinterpret_cast<const float4*>(g_r + kc);
            const float4 bi = *reinterpret_cast<const float4*>(g_i + kc);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const int off = (warp * kRows + i) * kTK + kc;
              const float4 cr = *reinterpret_cast<const float4*>(ctr_s + off);
              const float4 ci = *reinterpret_cast<const float4*>(cti_s + off);
              der[i] += dot4(cr, br) + dot4(ci, bi);
              dei[i] += dot4(ci, br) - dot4(cr, bi);
            }
          }

          // dG columns = ct^T . E (contract this tile's q).
          float dgr[kCols], dgi[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            dgr[j] = 0.f;
            dgi[j] = 0.f;
          }
          const float* e_r = er_s + lane * kES;
          const float* e_i = ei_s + lane * kES;
          for (int qq = 0; qq < kTQ; qq += 4) {
            const float4 ar4 = *reinterpret_cast<const float4*>(e_r + qq);
            const float4 ai4 = *reinterpret_cast<const float4*>(e_i + qq);
            const float ar[4] = {ar4.x, ar4.y, ar4.z, ar4.w};
            const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int off = (qq + m) * kTK + warp * kCols;
              const float4 c0 = *reinterpret_cast<const float4*>(ctr_s + off);
              const float4 c1 = *reinterpret_cast<const float4*>(ctr_s + off + 4);
              const float4 d0 = *reinterpret_cast<const float4*>(cti_s + off);
              const float4 d1 = *reinterpret_cast<const float4*>(cti_s + off + 4);
              const float cv[kCols] = {c0.x, c0.y, c0.z, c0.w,
                                       c1.x, c1.y, c1.z, c1.w};
              const float dv[kCols] = {d0.x, d0.y, d0.z, d0.w,
                                       d1.x, d1.y, d1.z, d1.w};
#pragma unroll
              for (int j = 0; j < kCols; ++j) {
                dgr[j] = fmaf(cv[j], ar[m], fmaf(dv[j], ai[m], dgr[j]));
                dgi[j] = fmaf(dv[j], ar[m], fmaf(-cv[j], ai[m], dgi[j]));
              }
            }
          }

          // Gain-side chain of these columns (zero beyond n_k: ct is 0).
          float s_amp = 0.f, s_psi = 0.f, s_om = 0.f;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int kc = warp * kCols + j;
            const int g = lane * kGS + kc;
            const float w = gr_s[g] * dgi[j] - gi_s[g] * dgr[j];
            s_amp += dgr[j] * cb_s[g] + dgi[j] * sb_s[g];
            s_psi += w;
            s_om -= static_cast<float>(k0 + kc) * w;
          }
          float* red = red_s + (warp * kPaths + lane) * 4;
          red[0] = s_amp;
          red[1] = s_psi;
          red[2] = s_om;
          __syncthreads();
          if (owner) {
            float a = 0.f, b = 0.f, c = 0.f;
            for (int w = 0; w < kWarps; ++w) {
              const float* rw = red_s + (w * kPaths + lane) * 4;
              a += rw[0];
              b += rw[1];
              c += rw[2];
            }
            damp[amp_row + (n_sa > 1 ? s * P : 0) + p] += a;
            dpsi[psi_row + s * P + p] += b;
            domega[row + p] += c;
          }
        }
      }

      // Panel-side chain of this tile's rows.
      float s_ty = 0.f, s_tz = 0.f, s_ry = 0.f, s_rz = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int qq = warp * kRows + i;
        const int q = q0 + qq;
        if (q < Q) {
          const float dphi = er_s[lane * kES + qq] * dei[i] -
                             ei_s[lane * kES + qq] * der[i];
          const int r = q / T;
          const int t = q - r * T;
          s_ty += static_cast<float>(t % t1) * dphi;
          s_tz += static_cast<float>(t / t1) * dphi;
          s_ry += static_cast<float>(r % r1) * dphi;
          s_rz += static_cast<float>(r / r1) * dphi;
        }
      }
      __syncthreads();                // the owners have read red_s
      float* red = red_s + (warp * kPaths + lane) * 4;
      red[0] = s_ty;
      red[1] = s_tz;
      red[2] = s_ry;
      red[3] = s_rz;
      __syncthreads();
      if (owner) {
        float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          const float* rw = red_s + (w * kPaths + lane) * 4;
          a += rw[0];
          b += rw[1];
          c += rw[2];
          d += rw[3];
        }
        dgty[row + p] += a;
        dgtz[row + p] += b;
        dgry[row + p] += c;
        dgrz[row + p] += d;
      }
    }
  }
}

}  // namespace

// Launches the backward on `stream`. Pointers are device pointers to
// contiguous float32 arrays: inputs as render_fwd_launch takes them, ct in
// the forward's output layout, and the 7 gradients shaped like the inputs
// (every element is written). Returns the cudaError_t of the launch (0 on
// success); the kernel itself is not waited for.
extern "C" int render_bwd_launch(const float* gry, const float* grz,
                                 const float* gty, const float* gtz,
                                 const float* amp, const float* psi,
                                 const float* omega, const float* ct,
                                 float* dgry, float* dgrz, float* dgty,
                                 float* dgtz, float* damp, float* dpsi,
                                 float* domega, int n_users, int n_paths,
                                 int r1, int r2, int t1, int t2, int n_k,
                                 int n_s, int n_sa, int packed, void* stream) {
  if (n_users == 0) return cudaSuccess;
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  const cudaError_t err = cudaFuncSetAttribute(
      render_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  render_bwd_kernel<<<n_users, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      gry, grz, gty, gtz, amp, psi, omega, ct, dgry, dgrz, dgty, dgtz, damp,
      dpsi, domega, n_users, n_paths, r1, r2, t1, t2, n_k, n_s, n_sa, packed);
  return cudaGetLastError();
}
