// Backward of the fused channel render for Hopper: cotangent of H in, the
// gradients of the 7 per-path scalars out.
//
// Replaces the TPU kernel deepmimo_tpu/ops/pallas/render.py::_bwd_kernel
// (and _bwd_kernel_norx; wrapper _bwd_impl, VJP rule _bwd). Forward, for
// one user (render_fwd.cu): E[q, p] = exp(j phi[q, p]) with
// phi = m_r gry + n_r grz + m_t gty + n_t gtz, g[kk, p] = a[s, p] U[kk, p],
// U = exp(j b), b = psi[s, p] - omega[p] k, kk = s*K + k, and H = E g^T.
// With the cotangent ct = cr + j ci of H:
//
//   dE = ct . conj(g):   dE_r = cr . g_r + ci . g_i,  dE_i = ci . g_r - cr . g_i
//   dG = ct^T . conj(E): dG_r = cr^T . E_r + ci^T . E_i,
//                        dG_i = ci^T . E_r - cr^T . E_i
//
// (render.py:755-762), chained in the block to the outputs (:765-797):
//   damp[s or 0, p] = sum_k dG_r U_r + dG_i U_i
//   dpsi[s, p]      = sum_k w,  domega[p] = -sum_{s,k} k w,
//                     w = a (U_r dG_i - U_i dG_r)
//   dphi[q, p]      = E_r dE_i - E_i dE_r,  dgty = sum_q m_t(q) dphi, and
//                     likewise dgtz (n_t), dgry (m_r), dgrz (n_r).
// With a single RX antenna dgry = dgrz = 0 exactly.
//
// What bounds it on an H100: at the headline shape (P = 25, Q = 64,
// S*K = 64) it reads ct once (32 KB per user, 4.29 GB per 131,072 users,
// about 1.3 ms at 3.35 TB/s) and does two contractions the size of the
// forward's path sum, 2.15e11 flop: 1.3 ms at f32 grade on the tensor
// cores (3 TF32 passes at 495 TFLOP/s), so bytes and tensor-core work
// bound it about equally. mma.sync runs TF32 at about half that rate on
// an H100 (tools/mma_peak.cu), so the three passes of the two padded
// GEMMs take ~3 ms alone, and the lanes' splits of the B fragments add to
// them: this design is bound by the consumer warps. Design:
//   - tiles of 64 q rows x 64 k columns inside one slot (so a = amp[s, p]
//     is one number per path and tile) and chunks of 32 paths; the chains
//     are linear, so each tile's partial dE rows and dG columns are folded
//     straight from the accumulators into per-path sums and nothing of
//     size [Q, P] or [SK, P] is kept across tiles or written to HBM;
//   - warp-specialised, one persistent block of 16 warps per SM, as the
//     forward: 8 producer warps stage each tile into one of two stages
//     (ct, split; E and U from the trig tables), 8 consumer warps run both
//     products and fold them. Named barriers hand the stages back and
//     forth, so the ct loads, the trig and the operand build run while the
//     tensor cores work on the other stage;
//   - both contractions are real GEMMs per tile on the tensor cores, in
//     3xTF32 mma.sync m16n8k8 (render_tables.cuh; no one-pass TF32):
//     consumer warps 0-3 compute dE / a (M = q, N = paths re/im, K = kk
//     re/im; A = ct, B = U with signs), warps 4-7 dG (M = kk, K = q re/im;
//     A = ct read transposed, B = E with signs), 32 rows x 16 paths each;
//   - ct is read from HBM into registers while the tile's tables are
//     built (coalesced, zero past the tile) and split into tf32 hi and lo
//     once per tile, into a plane that both products read: (cr hi, ci hi,
//     cr lo, ci lo) per element, columns XOR-swizzled by bits 0-1 of the
//     row, so that the 16-byte A-fragment loads of ct and of its transpose
//     are both free of bank conflicts. E and U stay fp32 (split planes of
//     them would not fit two stages): the consumers split the B fragments
//     they load;
//   - E and U of a tile come from the separable and two-table trig of
//     render_tables.cuh, with full-range sincosf;
//   - the per-path sums are reduced over a warp's rows with shuffles and
//     over its two row halves through shared memory; lane p of consumer
//     warp 0 owns path p's outputs for the chunk, keeps them in registers
//     and is their only writer, so no atomics are needed and the result is
//     deterministic;
//   - shared memory depends only on the tile sizes and the table
//     capacities, so every shape the forward takes is taken here.
// Mode (template argument kPasses, one instantiation each, chosen at
// launch): 1 (matmul_dtype "bfloat16"/"default") rounds the ct plane and
// the B fragments of E and U to bf16 and runs one pass, hi*hi, as the TPU
// kernel's one-pass mode rounds both products' operands (render.py
// _dot_mode, :710-711); the ct plane's lo half is then never built. The
// chains (E, U and amp in the folds) stay f32.

#include <cuda_runtime.h>

#include "render_tables.cuh"

namespace {

using namespace render;

constexpr int kConsumers = 256;     // 8 warps: the two products
constexpr int kProducers = 256;     // 8 warps: staging
constexpr int kThreads = kConsumers + kProducers;
constexpr int kES = kPC + 4;        // E and U plane row (float2), 4 mod 16
constexpr int kRed = 8;             // partial sums per (row half, path)
// One stage (bytes): the split ct tile, the E and U planes and amp of the
// tile's slot.
constexpr int kStage = 16 * kMT * kNT + 8 * 2 * kMT * kES + 4 * kPC;
// Named barriers: stage b full / empty, producers, consumers.
constexpr int kFull = 1, kEmpty = 3, kProdBar = 5, kConsBar = 6;
constexpr int kHandoff = kConsumers + kProducers;

// Trig table entries per path: a tile lies in one slot, so its OFDM
// window has at most 9 coarse groups.
__host__ __device__ inline int table_cap(const Shape& s) {
  return panel_cap(s) + imin(kL, s.K) + imin(s.K2, (kNT - 1) / kL + 2);
}

size_t smem_bytes(const Shape& s) {
  return 2 * static_cast<size_t>(kStage) + sizeof(float) * 2 * 2 * kPC * kRed +
         sizeof(float2) * static_cast<size_t>(table_cap(s)) * kPC +
         sizeof(float) * (2 * kScal * kPC + kMT + kNT);
}

// Column of element (q, kk) in the ct plane: bits 1-2 of kk are flipped
// by bits 1 and 0 of q.
__device__ __forceinline__ int ct_col(int q, int kk) {
  return kk ^ (((q & 1) << 2) | (q & 2));
}

// One step of a block's walk: user, path chunk, slot, k columns, q rows.
struct Item {
  int u, p0, sl, k0, q0;
};

__device__ __forceinline__ Item next_item(const Shape& s, Item it) {
  if ((it.q0 += kMT) < s.Q) return it;
  it.q0 = 0;
  if ((it.k0 += kNT) < s.K) return it;
  it.k0 = 0;
  if (++it.sl < s.S) return it;
  it.sl = 0;
  if ((it.p0 += kPC) < s.P) return it;
  it.p0 = 0;
  it.u += gridDim.x;
  return it;
}

// The stage's parts.
struct Stage {
  float4* c;          // [kMT][kNT], split ct, ct_col
  float2* e;          // [kMT][kES]
  float2* w;          // [kNT][kES], unit OFDM phasors
  float* amp;         // [kPC]
  __device__ explicit Stage(char* base)
      : c(reinterpret_cast<float4*>(base)),
        e(reinterpret_cast<float2*>(c + kMT * kNT)),
        w(e + kMT * kES),
        amp(reinterpret_cast<float*>(w + kNT * kES)) {}
};

// The producers: every tile of the block's walk into stage n % 2, ct split
// for a product of kPasses passes.
template <int kPasses>
__device__ __forceinline__ void produce(
    const Shape& s, int packed, const float* gry, const float* grz,
    const float* gty, const float* gtz, const float* amp, const float* psi,
    const float* omega, const float* ct, char* stages, char* mem) {
  const Team tm{static_cast<int>(threadIdx.x) - kConsumers, kProducers};
  float2* tab = reinterpret_cast<float2*>(mem);
  float* scal = reinterpret_cast<float*>(tab + static_cast<size_t>(table_cap(s)) * kPC);
  int* row_ix = reinterpret_cast<int*>(scal + 2 * kScal * kPC);
  int* col_ix = row_ix + kMT;
  const size_t stride = packed ? 2 * static_cast<size_t>(s.SK) : s.SK;
  constexpr int kPer = kMT * kNT / kProducers;  // ct elements per thread
  const int kl = tm.id % kNT, r_base = tm.id / kNT;
  constexpr int kRowStep = kProducers / kNT;

  Item it{static_cast<int>(blockIdx.x), 0, 0, 0, 0};
  issue_scalars(tm, s, it.u, it.p0, gry, grz, gty, gtz, omega, scal);
  cp_async_commit();
  int n = 0;
  for (; it.u < s.U; ++n) {
    const size_t u = it.u;
    const Tile tl(s, it.q0, it.sl * s.K + it.k0, imin(kNT, s.K - it.k0));
    const int np = imin(kPC, s.P - it.p0);
    cp_async_wait_all();
    bar_sync(kProdBar, kProducers);    // scalars landed; tables free
    const Item nx = next_item(s, it);
    if (nx.u < s.U) {                  // the next tile's scalars, ahead
      issue_scalars(tm, s, nx.u, nx.p0, gry, grz, gty, gtz, omega,
                    scal + ((n + 1) & 1) * kScal * kPC);
      cp_async_commit();
    }
    // Column kl of rows r_base + kRowStep * i of the ct tile, in flight
    // while the tables are built.
    const size_t col0 = static_cast<size_t>(it.sl) * s.K + it.k0 + kl;
    const float* ct_r = ct + (u * s.Q + it.q0) * stride + col0;
    const float* ct_i = packed ? ct_r + s.SK
                               : ct + ((s.U + u) * s.Q + it.q0) * s.SK + col0;
    float cr[kPer], ci[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = r_base + kRowStep * i;
      const bool ok = r < tl.rows && kl < tl.cols;
      cr[i] = ok ? __ldcs(ct_r + r * stride) : 0.f;
      ci[i] = ok ? __ldcs(ct_i + r * stride) : 0.f;
    }
    build_tables(tm, s, tl, u, it.p0, scal + (n & 1) * kScal * kPC, psi,
                 nullptr, tab, row_ix, col_ix);
    bar_sync(kProdBar, kProducers);    // tables ready
    const int b = n & 1;
    if (n > 1) bar_sync(kEmpty + b, kHandoff);   // stage b consumed
    const Stage st(stages + b * kStage);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = r_base + kRowStep * i;
      st.c[r * kNT + ct_col(r, kl)] =
          split4<kPasses>(make_float2(cr[i], ci[i]));
    }
    if (tm.id < np) {
      st.amp[tm.id] = __ldg(amp + u * s.n_sa * s.P +
                            (s.n_sa > 1 ? it.sl * s.P : 0) + it.p0 + tm.id);
    }
    build_planes<kES, kPasses>(tm, tl, np, tab, row_ix, col_ix, st.e, st.w);
    bar_arrive(kFull + b, kHandoff);   // stage b full
    it = nx;
  }
  // The consumers' releases of the last two tiles.
  if (n > 1) bar_sync(kEmpty + (n & 1), kHandoff);
  if (n > 0) bar_sync(kEmpty + ((n - 1) & 1), kHandoff);
}

template <int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
render_bwd_kernel(const float* __restrict__ gry, const float* __restrict__ grz,
                  const float* __restrict__ gty, const float* __restrict__ gtz,
                  const float* __restrict__ amp, const float* __restrict__ psi,
                  const float* __restrict__ omega, const float* __restrict__ ct,
                  float* __restrict__ dgry, float* __restrict__ dgrz,
                  float* __restrict__ dgty, float* __restrict__ dgtz,
                  float* __restrict__ damp, float* __restrict__ dpsi,
                  float* __restrict__ domega, Shape s, int packed) {
  extern __shared__ float4 smem4[];
  char* stages = reinterpret_cast<char*>(smem4);     // [2][kStage]
  float* reds = reinterpret_cast<float*>(stages + 2 * kStage);
  if (threadIdx.x >= kConsumers) {                    // [2][2][kPC][kRed]
    produce<kPasses>(s, packed, gry, grz, gty, gtz, amp, psi, omega, ct,
                     stages,
            reinterpret_cast<char*>(reds + 2 * 2 * kPC * kRed));
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (threadIdx.x >> 5) & 1;          // rows 32 wm .. + 31
  const int wn = (threadIdx.x >> 6) & 1;          // paths 16 wn .. + 15
  const int gemm = threadIdx.x >> 7;              // 0: dE, 1: dG

  // Owner lane state (warp 0, path p0 + lane).
  float o_ty = 0.f, o_tz = 0.f, o_ry = 0.f, o_rz = 0.f, o_om = 0.f;
  float o_amp = 0.f, o_samp = 0.f, o_spsi = 0.f;

  Item it{static_cast<int>(blockIdx.x), 0, 0, 0, 0};
  for (int b = 0; it.u < s.U; b ^= 1) {
    const size_t u = it.u;
    const int rows = imin(kMT, s.Q - it.q0);
    const int cols = imin(kNT, s.K - it.k0);
    const int np = imin(kPC, s.P - it.p0);
    const Stage st(stages + b * kStage);
    const float4* c_pl = st.c;
    const float2* e_pl = st.e;
    const float2* u_pl = st.w;
    const float* amp_t = st.amp;
    float* red = reds + b * 2 * kPC * kRed;

    // This warp: rows 32 wm + 16 i + g (+ 8) of its product, paths
    // 16 wn + 4 j + t (accumulator columns 2t, 2t + 1: re, im); B column g
    // is path 16 wn + 4 j + g / 2, re (g even) or im (g odd).
    const int m_rows = gemm ? cols : rows;        // M of this product
    const int n_ks = ((gemm ? rows : cols) + 3) / 4;
    const int n_nt = imin(4, (np - 16 * wn + 3) / 4);
    float sums[4][4] = {};
    bar_sync(kFull + b, kHandoff);    // stage b holds this tile
    if (32 * wm < m_rows && n_nt > 0) {
      const bool m1 = 32 * wm + 16 < m_rows;
      const float2* b_pl = (gemm ? e_pl : u_pl) + 16 * wn + (g >> 1);
      float acc[2][4][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < n_ks; ++ks) {
        const int kx = 4 * ks + t;                // kk (dE) or q (dG)
        Split a[2][4], bf[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n_nt) cplx_b<kPasses>(bf[j], b_pl[kx * kES + 4 * j], g & 1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !m1) break;
          const int r0 = 32 * wm + 16 * i + g, r1 = r0 + 8;
          if (gemm == 0) {     // A[q][kk re/im] = ct[q][kk]
            cplx_a(a[i], c_pl[r0 * kNT + ct_col(r0, kx)],
                   c_pl[r1 * kNT + ct_col(r1, kx)]);
          } else {             // A[kk][q re/im] = ct[q][kk]
            cplx_a(a[i], c_pl[kx * kNT + ct_col(kx, r0)],
                   c_pl[kx * kNT + ct_col(kx, r1)]);
          }
        }
        mma3<kPasses>(acc, a, bf, m1 ? 2 : 1, n_nt);
      }

      // Fold this tile's rows into the per-path sums.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * wm + 16 * i + g + 8 * h;
          if (r >= m_rows) continue;
          if (gemm == 0) {     // dE rows: the panel chain
            const int q = it.q0 + r;
            const int tq = q % s.T, rq = q / s.T;
            const float d[4] = {static_cast<float>(tq % s.t1),
                                static_cast<float>(tq / s.t1),
                                static_cast<float>(rq % s.r1),
                                static_cast<float>(rq / s.r1)};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int pp = 16 * wn + 4 * j + t;
              if (j < n_nt && pp < np) {
                const float2 e = e_pl[r * kES + pp];
                const float dphi = amp_t[pp] * (e.x * acc[i][j][2 * h + 1] -
                                                e.y * acc[i][j][2 * h]);
#pragma unroll
                for (int v = 0; v < 4; ++v) sums[j][v] += d[v] * dphi;
              }
            }
          } else {             // dG columns: the gain chain
            const float kf = static_cast<float>(it.k0 + r);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int pp = 16 * wn + 4 * j + t;
              if (j < n_nt && pp < np) {
                const float2 w = u_pl[r * kES + pp];
                const float dgr = acc[i][j][2 * h], dgi = acc[i][j][2 * h + 1];
                const float wk = amp_t[pp] * (w.x * dgi - w.y * dgr);
                sums[j][0] += dgr * w.x + dgi * w.y;
                sums[j][1] += wk;
                sums[j][2] -= kf * wk;
              }
            }
          }
        }
      }
    }
    bar_arrive(kEmpty + b, kHandoff);  // stage b may be refilled

    // Sum over the 8 row lanes g; lane t of each warp writes the sums of
    // its 4 paths (zeros where it had none), so every entry of red is
    // written on every tile.
    const int n_v = gemm ? 3 : 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float x = sums[j][v];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        sums[j][v] = x;
      }
      if (g == 0) {
        float* dst = red + (wm * kPC + 16 * wn + 4 * j + t) * kRed + 4 * gemm;
        for (int v = 0; v < n_v; ++v) dst[v] = sums[j][v];
      }
    }
    bar_sync(kConsBar, kConsumers);   // every warp's sums are in red[b]

    if (threadIdx.x < kPC) {
      const int p = it.p0 + threadIdx.x;
      const bool first = it.k0 == 0 && it.q0 == 0;
      const bool last = it.k0 + kNT >= s.K && it.q0 + kMT >= s.Q;
      if (first && it.sl == 0) {
        o_ty = o_tz = o_ry = o_rz = o_om = o_amp = 0.f;
      }
      if (first) o_samp = o_spsi = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* x = red + (m * kPC + threadIdx.x) * kRed;
        o_ty += x[0];
        o_tz += x[1];
        o_ry += x[2];
        o_rz += x[3];
        o_samp += x[4];
        o_spsi += x[5];
        o_om += x[6];
      }
      if (last && p < s.P) {
        dpsi[(u * s.S + it.sl) * s.P + p] = o_spsi;
        if (s.n_sa > 1) {
          damp[(u * s.S + it.sl) * s.P + p] = o_samp;
        } else {
          o_amp += o_samp;
        }
        if (it.sl == s.S - 1) {
          const size_t row = u * s.P + p;
          dgty[row] = o_ty;
          dgtz[row] = o_tz;
          dgry[row] = o_ry;
          dgrz[row] = o_rz;
          domega[row] = o_om;
          if (s.n_sa == 1) damp[row] = o_amp;
        }
      }
    }
    it = next_item(s, it);
  }
}

}  // namespace

// Launches the backward on `stream`. Pointers are device pointers to
// contiguous float32 arrays: inputs as render_fwd_launch takes them, ct in
// the forward's output layout, and the 7 gradients shaped like the inputs
// (every element is written). passes: 3 (3xTF32) or 1 (bf16 operands).
// Returns the cudaError_t of the launch (0 on success); the kernel itself
// is not waited for.
extern "C" int render_bwd_launch(const float* gry, const float* grz,
                                 const float* gty, const float* gtz,
                                 const float* amp, const float* psi,
                                 const float* omega, const float* ct,
                                 float* dgry, float* dgrz, float* dgty,
                                 float* dgtz, float* damp, float* dpsi,
                                 float* domega, int n_users, int n_paths,
                                 int r1, int r2, int t1, int t2, int n_k,
                                 int n_s, int n_sa, int packed, int passes,
                                 void* stream) {
  if (n_users == 0) return cudaSuccess;
  if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
  const auto kernel =
      passes == 3 ? render_bwd_kernel<3> : render_bwd_kernel<1>;
  const Shape s =
      make_shape(n_users, n_paths, r1, r2, t1, t2, n_k, n_s, n_sa);
  const int smem = static_cast<int>(smem_bytes(s));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid = imin(n_users, n_sm * (per_sm > 0 ? per_sm : 1));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gry, grz, gty, gtz, amp, psi, omega, ct, dgry, dgrz, dgty, dgtz, damp,
      dpsi, domega, s, packed);
  return cudaGetLastError();
}
