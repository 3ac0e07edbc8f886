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
// bound it about equally. Two designs share the launcher, one for each
// mode; the launcher picks by `passes`:
//
//   - tensor cores (tc::render_bwd_kernel_tc): f32 grade (passes 3). One
//     contraction on wgmma from register A fragments, folded per row tile
//     into the 7 outputs: 4.1 ms at the headline. Bound by its serial fold
//     (1.1 ms of the 4.1 with the fold taken out) and by the SM's issue
//     slots, which the producers' trig and splits share with the
//     consumers (the kernel takes 3.0 ms with no product, 3.1 ms with no
//     operand built);
//   - mma.sync (render_bwd_kernel): the one-pass bf16 mode (passes 1).
//     The port's first design, which also ran f32 grade in 3xTF32 until
//     the tensor-core design replaced it there (11.6 ms at the headline
//     against 4.1, and 1.7-3.6x slower at every one of 31 panel shapes
//     timed, Q = 8 to 144): mma.sync runs TF32 at about half wgmma's rate
//     on an H100, and the lanes' splits of the B fragments add to the
//     passes, so it is bound by its consumer warps.
//
// mma.sync design:
//   - tiles of 64 q rows x 64 k columns inside one slot (so a = amp[s, p]
//     is one number per path and tile) and chunks of 32 paths; the chains
//     are linear, so each tile's partial dE rows and dG columns are folded
//     straight from the accumulators into per-path sums and nothing of
//     size [Q, P] or [SK, P] is kept across tiles or written to HBM;
//   - warp-specialised, one persistent block of 16 warps per SM, as the
//     forward: 8 producer warps stage each tile into one of two stages
//     (ct, rounded; E and U from the trig tables), 8 consumer warps run
//     both products and fold them. Named barriers hand the stages back and
//     forth, so the ct loads, the trig and the operand build run while the
//     tensor cores work on the other stage;
//   - both contractions are real GEMMs per tile on the tensor cores in
//     one bf16 pass of mma.sync m16n8k8 (render_tables.cuh): consumer
//     warps 0-3 compute dE / a (M = q, N = paths re/im, K = kk re/im;
//     A = ct, B = U with signs), warps 4-7 dG (M = kk, K = q re/im;
//     A = ct read transposed, B = E with signs), 32 rows x 16 paths each.
//     The ct plane and the B fragments of E and U are rounded to bf16 and
//     the product runs hi*hi alone, as the TPU kernel's one-pass mode
//     rounds both products' operands (render.py _dot_mode, :710-711); the
//     chains (E, U and amp in the folds) stay f32;
//   - ct is read from HBM into registers while the tile's tables are
//     built (coalesced, zero past the tile) and rounded once per tile,
//     into a plane that both products read, columns XOR-swizzled by bits
//     0-1 of the row, so that the 16-byte A-fragment loads of ct and of
//     its transpose are both free of bank conflicts. E and U stay fp32 in
//     shared memory: the consumers round the B fragments they load;
//   - E and U of a tile come from the separable and two-table trig of
//     render_tables.cuh, with full-range sincosf;
//   - the per-path sums are reduced over a warp's rows with shuffles and
//     over its two row halves through shared memory; lane p of consumer
//     warp 0 owns path p's outputs for the chunk, keeps them in registers
//     and is their only writer, so no atomics are needed and the result is
//     deterministic;
//   - shared memory depends only on the tile sizes and the table
//     capacities, so every shape the forward takes is taken here.
//
// Tensor-core design (namespace tc), per user, path chunk of 32, slot,
// tile of 64 rows (q) and step of 32 subcarriers:
//   - one contraction where the mma.sync design has two: the chains reduce
//     dG against U over k anyway, so sum_k dG conj(U) = sum_q conj(E) dE.
//     With dE = ct . conj(U) and dEk = ct . conj(k U) (contracting k) and
//     z = conj(E) dE, zk = conj(E) dEk per (q, p): damp = sum_q Re z,
//     dpsi = a sum_q Im z, domega = -a sum_q Im zk and dphi = a Im z, so
//     no transposed operand is needed: dG's contraction over q becomes a
//     column of k U beside each column of U, the same products;
//   - the contraction as two real GEMMs on wgmma m64n128k8, D3 = cr . B
//     and D4 = ci . B with B = [U | k U] (32 x 128, re and im of each
//     path), dE = D3(re) + D4(im) + j (D4(re) - D3(im)), as the forward
//     forms H; A = ct from registers (wgmma's register A fragments), B
//     from shared memory in wgmma.cuh's K-major layout, at 3xTF32 (lo.hi +
//     hi.lo + hi.hi, FP32 accumulation, the split of render_tables.cuh).
//     The consumers load each row's ct from shared memory as float4 and
//     split it into hi and lo in registers; the k-steps take subcarriers
//     in the order of those float4, and the producers write B's depths in
//     the same order. A k-step's products are committed as one group and
//     the next k-step's fragments are built while they run (two fragment
//     sets in flight). No product register is written on a branch and
//     every k-step count is fixed, so ptxas keeps the products in flight;
//   - the fold at the end of each row tile: z and zk from the
//     accumulators and E, each lane's 5 sums (7 with more than one RX
//     element: the panel indices' weighted sums of Im z) reduce-scattered
//     over the warp's 8 row lanes (lane l ends with path l) and summed
//     over the 4 warps through shared memory; lane p of consumer warp 0
//     owns path p's outputs for the chunk and is their only writer: no
//     atomics, deterministic, nothing of size [Q, P] or [SK, P] written;
//   - persistent warp-specialised blocks, one per SM (217,088 bytes of
//     shared memory, three stages): one consumer warpgroup runs the
//     products and the folds; two producer warpgroups copy each step's ct
//     tile into its stage with cp.async one step ahead (zeros past Q and
//     K), build B from U = exp(j (psi - omega k)) with one full-range
//     sincos an entry, and, at a row tile's last step, E (separable for TX
//     panels 8 elements wide: exp(j m_t gty) exp(j (n_t gtz + m_r gry +
//     n_r grz))) and the rows' panel indices. Named barriers hand the
//     stages over (full, empty); setmaxnreg gives the consumers 232
//     registers and the producers 136;
//   - any shape the mma.sync design takes: P in chunks of 32, ragged Q
//     and K tiles, S slots with per-slot amplitudes, packed and stacked ct.

#include <cuda_runtime.h>

#include <cstdint>

#include "render_tables.cuh"
#include "wgmma.cuh"

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
// Passes of the products (render_tables.cuh): one bf16 pass, the mode
// this design runs.
constexpr int kPasses = 1;

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

// The producers: every tile of the block's walk into stage n % 2, ct
// rounded for the one bf16 pass.
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
    produce(s, packed, gry, grz, gty, gtz, amp, psi, omega, ct, stages,
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

// ---------------------------------------------------------------------------
// The tensor-core design: f32 grade
// ---------------------------------------------------------------------------

namespace tc {

using render::Split;

constexpr int kConsumers = 128;      // one warpgroup: the products, the folds
constexpr int kProducers = 256;      // two warpgroups: ct copies, U and E
constexpr int kThreads = kConsumers + kProducers;
// Registers a thread of the consumers and of the producers (setmaxnreg):
// the 168 a thread of 384 at launch, moved to the accumulators and
// fragments.
constexpr int kConsumerRegs = 232, kProducerRegs = 136;
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "the registers of the launch");
constexpr int kM = 64;               // rows (q) per tile: the products' M
constexpr int kPc = 32;              // paths per chunk
constexpr int kKt = 32;              // subcarriers per step: the depth
constexpr int kN = 4 * kPc;          // columns: U and k U of each path
constexpr int kStages = 3;
constexpr int kES = kPc + 4;         // E plane row (float2)
constexpr int kSums = 7;             // per-path sums of a fold
// One stage (floats): B's hi and lo planes [kN x kKt] in wgmma.cuh's
// K-major layout, the cr and ci planes of the ct tile [kM][kKt] (16-byte
// chunks swizzled by bit 0 of the row), E [kM][kES] (float2) and the
// rows' panel indices [kM] (float4: m_t, n_t, m_r, n_r).
constexpr int kBPlane = kN * kKt;
constexpr int kCtPlane = kM * kKt;
constexpr int kStage = 2 * kBPlane + 2 * kCtPlane + 2 * kM * kES + 4 * kM;
constexpr int kRed = 2 * 4 * kSums * 32;     // [fold % 2][warp][sum][lane]
constexpr int kEy = 2 * 2 * 8 * kPc;         // [fold % 2][8][kPc] float2
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * kStage + kRed + kEy);
// Named barriers: stage b full (producers arrive, consumers wait) and
// empty (the reverse), and each side's own.
constexpr int kFull = 1, kEmpty = kFull + kStages;
constexpr int kConsBar = kEmpty + kStages, kProdBar = kConsBar + 1;
constexpr int kHandoff = kConsumers + kProducers;
static_assert(kProdBar < 16, "named barriers 1..15");
static_assert(kProducers == 8 * 32 && kPc == 32 && kKt == 32 && kM == 64,
              "a producer lane per path; a B core column and 8 rows of E "
              "per warp");

struct Args {
  const float *gry, *grz, *gty, *gtz, *amp, *psi, *omega, *ct;
  float *dgry, *dgrz, *dgty, *dgtz, *damp, *dpsi, *domega;
  int U, P, r1, t1, T, Q, K, S, n_sa;
  int n_rt, n_ch, n_kt;     // row tiles, path chunks, column steps
  int packed, vec;          // vec: 16-byte copies (K % 4 == 0, aligned ct)
};

// A block's walk: for each of its users, path chunk c, slot s, row tile
// rt and column step kt (kKt subcarriers of the slot), in that order.
struct Pos {
  int u, c, s, rt, kt;
};

__device__ __forceinline__ void advance(const Args& a, Pos& x) {
  if (++x.kt < a.n_kt) return;
  x.kt = 0;
  if (++x.rt < a.n_rt) return;
  x.rt = 0;
  if (++x.s < a.S) return;
  x.s = 0;
  if (++x.c < a.n_ch) return;
  x.c = 0;
  x.u += gridDim.x;
}

struct StagePtrs {
  float* bh;       // B hi [kBPlane], then B lo
  float* cr;       // ct planes [kCtPlane]: cr, then ci
  float2* e;       // [kM][kES]
  float4* wt;      // [kM]
  __device__ StagePtrs(float* base, int b)
      : bh(base + b * kStage),
        cr(bh + 2 * kBPlane),
        e(reinterpret_cast<float2*>(cr + 2 * kCtPlane)),
        wt(reinterpret_cast<float4*>(e + kM * kES)) {}
};

// cp.async of 16 (4) bytes from global src to shared dst, of which the
// first `n` are copied and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
// Waits until at most one committed group of copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Float offset of 16-byte chunk c16 (subcarriers 4 c16 .. 4 c16 + 3 of
// the step) of row r of a ct plane: chunks XOR-swizzled by bit 0 of the
// row, so that the consumers' float4 loads of rows g and g + 1 fall in
// different banks.
__device__ __forceinline__ int ct_off(int r, int c16) {
  return r * kKt + 4 * (c16 ^ ((r & 1) << 2));
}

// Producers: the cp.async copies of the ct tile of step x (rows
// rt kM .., subcarriers kt kKt .. of slot s) into the stage's cr and ci
// planes, zeros past Q and K.
__device__ __forceinline__ void copy_ct(const Args& a, const Pos& x, int id,
                                        float* cr) {
  const size_t sk = static_cast<size_t>(a.S) * a.K;
  const size_t stride = a.packed ? 2 * sk : sk;
  const int q0 = x.rt * kM, k0 = x.kt * kKt;
  const size_t col0 = static_cast<size_t>(x.s) * a.K + k0;
  const float* src_r = a.ct + (static_cast<size_t>(x.u) * a.Q + q0) * stride +
                       col0;
  const float* src_i =
      a.packed ? src_r + sk
               : a.ct + ((static_cast<size_t>(a.U) + x.u) * a.Q + q0) * sk +
                     col0;
  if (a.vec) {
    // 1024 chunks of 16 bytes: 8 a row and plane, 4 rows a warp.
#pragma unroll
    for (int i = 0; i < 2 * kM * kKt / 4 / kProducers; ++i) {
      const int idx = id + kProducers * i;
      const int pl = idx >> 9, r = (idx >> 3) & (kM - 1), c16 = idx & 7;
      const bool ok = q0 + r < a.Q && k0 + 4 * c16 < a.K;
      const float* src = (pl ? src_i : src_r) + r * stride + 4 * c16;
      cp_async16(cr + pl * kCtPlane + ct_off(r, c16), ok ? src : a.ct,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = id; idx < 2 * kM * kKt; idx += kProducers) {
      const int pl = idx / (kM * kKt), r = (idx / kKt) & (kM - 1);
      const int col = idx & (kKt - 1);
      const bool ok = q0 + r < a.Q && k0 + col < a.K;
      const float* src = (pl ? src_i : src_r) + r * stride + col;
      cp_async4(cr + pl * kCtPlane + ct_off(r, col >> 2) + (col & 3),
                ok ? src : a.ct, ok ? 4 : 0);
    }
  }
}

// Producers: B of step x, [kN x kKt] K-major in hi and lo planes. Column
// 2 l + c is part c of U = exp(j (psi - omega k)) of path l of the chunk,
// column 64 + 2 l + c that of k U (k the subcarrier in its slot), so that a
// consumer lane's accumulator block j holds path 4 j + t (j < 8) and its
// k-weighted twin (block j + 8). Depths are subcarriers in the order the
// consumers' A fragments take them: core column m holds k = 16 (m / 4) +
// m % 4 + 4 d for its depths d < 4. Warp w, lane l builds core column w
// of path l; zeros past K and P. Lanes with bit 2 set store their
// imaginary columns first, so the 8 lanes of each quarter warp write 8
// different rows of a core matrix.
__device__ __forceinline__ void build_b(const Args& a, int kt, bool okp,
                                        float om, float ps, int w, int l,
                                        float* bh) {
  const int sw = (l >> 2) & 1, m = w;
  float ph[4], kf[4];
  bool ok[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int k = kt * kKt + 16 * (m >> 2) + (m & 3) + 4 * d;
    ok[d] = okp && k < a.K;
    kf[d] = static_cast<float>(k);
    ph[d] = __fsub_rn(ps, __fmul_rn(om, kf[d]));
  }
  float2 v[4];
  render::phasors(ph, v);
  float h[4][4], lw[4][4];    // [Ur, Ui, k Ur, k Ui][depth]
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float ur = ok[d] ? v[d].x : 0.f, ui = ok[d] ? v[d].y : 0.f;
    const float x[4] = {ur, ui, kf[d] * ur, kf[d] * ui};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Split sp = render::split(x[c]);
      h[c][d] = __uint_as_float(sp.hi);
      lw[c][d] = __uint_as_float(sp.lo);
    }
  }
  float4 hi[4], lo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    hi[c] = make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
    lo[c] = make_float4(lw[c][0], lw[c][1], lw[c][2], lw[c][3]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {      // U, then k U
#pragma unroll
    for (int o = 0; o < 2; ++o) {             // first, second column
      const int c = o ^ sw;                   // 0: re, 1: im
      const int n = 64 * half + 2 * l + c;
      const int off = (m * (kN / 8) + (n >> 3)) * 32 + (n & 7) * 4;
      const float4 vh = c ? hi[2 * half + 1] : hi[2 * half];
      const float4 vl = c ? lo[2 * half + 1] : lo[2 * half];
      *reinterpret_cast<float4*>(bh + off) = vh;
      *reinterpret_cast<float4*>(bh + kBPlane + off) = vl;
    }
  }
}

// The panel indices of row q: m_t, n_t, m_r, n_r (q = r T + t, t =
// n_t t1 + m_t, r = n_r r1 + m_r).
__device__ __forceinline__ void row_weights(const Args& a, int q,
                                            float (&wt)[4]) {
  const int rq = q / a.T, tq = q - rq * a.T;
  const int nt = tq / a.t1, nr = rq / a.r1;
  wt[0] = static_cast<float>(tq - nt * a.t1);
  wt[1] = static_cast<float>(nt);
  wt[2] = static_cast<float>(rq - nr * a.r1);
  wt[3] = static_cast<float>(nr);
}

// Producers: the panel indices of row tile rt's rows into wt, then E
// [kM][kES] of the tile and the chunk, exp(j phi) with phi = m_t gty +
// n_t gtz + m_r gry + n_r grz, zeros past Q. Warp w, lane l: path l, rows
// 8 w + i. For TX panels 8 elements wide those rows are one row group
// (m_t = i): E = ey[i] ez with ey[m] = exp(j m gty), one entry a warp
// shared through ey, and ez = exp(j (n_t gtz + m_r gry + n_r grz)) of the
// group; else one sincos an entry, the phase rounded as the plain version
// rounds it.
__device__ __forceinline__ void build_e(const Args& a, int rt,
                                        const float (&sc)[4], int id,
                                        float2* e, float4* wt, float2* ey) {
  const int w = id >> 5, l = id & 31;
  if (id < kM) {
    float x[4];
    row_weights(a, rt * kM + id, x);
    wt[id] = make_float4(x[0], x[1], x[2], x[3]);
  }
  const bool sep = a.t1 == 8;
  if (sep) {
    float ph[1] = {__fmul_rn(static_cast<float>(w), sc[2])};
    float2 v[1];
    render::phasors(ph, v);
    ey[w * kPc + l] = v[0];
  }
  render::bar_sync(kProdBar, kProducers);
  if (sep) {
    const float4 x = wt[8 * w];
    float ph[1] = {__fadd_rn(__fadd_rn(__fmul_rn(x.y, sc[3]),
                                       __fmul_rn(x.z, sc[0])),
                             __fmul_rn(x.w, sc[1]))};
    float2 ez[1];
    render::phasors(ph, ez);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * w + i;
      e[r * kES + l] = rt * kM + r < a.Q ? render::cmul(ey[i * kPc + l], ez[0])
                                         : make_float2(0.f, 0.f);
    }
    return;
  }
  float ph[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = wt[8 * w + i];
    ph[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x.x, sc[2]),
                                          __fmul_rn(x.y, sc[3])),
                                __fmul_rn(x.z, sc[0])),
                      __fmul_rn(x.w, sc[1]));
  }
  float2 v[8];
  render::phasors(ph, v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * w + i;
    e[r * kES + l] = rt * kM + r < a.Q ? v[i] : make_float2(0.f, 0.f);
  }
}

// Producers: every step of the block's walk into stage n % kStages. The
// copies of the next step's ct and its scalars are issued before this
// step's B and E are built, so their latency hides behind that work.
__device__ __forceinline__ void produce(const Args& a, float* st_base,
                                        float2* ey) {
  const int id = threadIdx.x - kConsumers;
  const int w = id >> 5, l = id & 31;
  Pos x{static_cast<int>(blockIdx.x), 0, 0, 0, 0};
  if (x.u >= a.U) return;
  float sc[4], om, ps;            // gry, grz, gty, gtz; omega, psi of path l
  bool okp;
  auto scalars = [&](const Pos& y, float (&g)[4], float& o, float& p,
                     bool& ok) {
    const int pp = y.c * kPc + l;
    ok = pp < a.P;
    const size_t row = static_cast<size_t>(y.u) * a.P + pp;
    g[0] = ok ? __ldg(a.gry + row) : 0.f;
    g[1] = ok ? __ldg(a.grz + row) : 0.f;
    g[2] = ok ? __ldg(a.gty + row) : 0.f;
    g[3] = ok ? __ldg(a.gtz + row) : 0.f;
    o = ok ? __ldg(a.omega + row) : 0.f;
    p = ok ? __ldg(a.psi + (static_cast<size_t>(y.u) * a.S + y.s) * a.P + pp)
           : 0.f;
  };
  scalars(x, sc, om, ps, okp);
  copy_ct(a, x, id, StagePtrs(st_base, 0).cr);
  render::cp_async_commit();
  int n = 0, folds = 0;
  for (; x.u < a.U; ++n) {
    Pos nx = x;
    advance(a, nx);
    float nsc[4], nom = 0.f, nps = 0.f;
    bool nok = false;
    if (nx.u < a.U) {                 // the next step's copies, ahead
      const int b1 = (n + 1) % kStages;
      if (n + 1 >= kStages) render::bar_sync(kEmpty + b1, kHandoff);
      copy_ct(a, nx, id, StagePtrs(st_base, b1).cr);
      scalars(nx, nsc, nom, nps, nok);
    }
    render::cp_async_commit();
    const StagePtrs st(st_base, n % kStages);
    build_b(a, x.kt, okp, om, ps, w, l, st.bh);
    if (x.kt == a.n_kt - 1) {
      build_e(a, x.rt, sc, id, st.e, st.wt, ey + (folds & 1) * 8 * kPc);
      ++folds;
    }
    cp_async_wait_one();      // this step's copies have landed
    // B is written through the generic proxy and read by wgmma through
    // the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    render::bar_arrive(kFull + n % kStages, kHandoff);
    x = nx;
    if (nx.u < a.U) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = nsc[i];
      om = nom;
      ps = nps;
      okp = nok;
    }
  }
  // The consumers' releases of the last steps.
  for (int k = n > kStages ? n - kStages : 0; k < n; ++k)
    render::bar_sync(kEmpty + k % kStages, kHandoff);
}

// A fragments of one k-step, split: cr and ci, hi and lo.
struct Frag {
  uint32_t rh[4], rl[4], ih[4], il[4];
};

__device__ __forceinline__ void fence_frag(Frag& f) {
  wg::fence_regs(f.rh);
  wg::fence_regs(f.rl);
  wg::fence_regs(f.ih);
  wg::fence_regs(f.il);
}

// Consumer lane (w, g, t), k-step ks = 2 i + e of a step: A rows
// 16 w + g and + 8 (q of the tile), depths t and t + 4 the subcarriers
// 16 i + 4 t + 2 e and + 1, elements 2 e and 2 e + 1 of the lane's float4
// of each row (chunk 4 i + t).
__device__ __forceinline__ void make_frag(const float4 (&x)[4], int e,
                                          Frag& f) {
  // x: cr row g, cr row g + 8, ci row g, ci row g + 8
  float v[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v[r][0] = e ? x[r].z : x[r].x;
    v[r][1] = e ? x[r].w : x[r].y;
  }
  // a[0] (row g, depth t), a[1] (row g + 8, depth t), a[2] (row g,
  // depth t + 4), a[3] (row g + 8, depth t + 4)
  const float ar[4] = {v[0][0], v[1][0], v[0][1], v[1][1]};
  const float ai[4] = {v[2][0], v[3][0], v[2][1], v[3][1]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split r = render::split(ar[i]), m = render::split(ai[i]);
    f.rh[i] = r.hi;
    f.rl[i] = r.lo;
    f.ih[i] = m.hi;
    f.il[i] = m.lo;
  }
}

// D3 += cr . B and D4 += ci . B for one k-step at 3xTF32 (lo . hi, hi .
// lo, hi . hi); the first products start the sums unless `acc`.
__device__ __forceinline__ void products(float (&d3)[64], float (&d4)[64],
                                         Frag& f, uint64_t bh, uint64_t bl,
                                         int acc) {
  wg::fence();
  wg::mma_n128_rs(d3, f.rl, bh, acc);
  wg::mma_n128_rs(d4, f.il, bh, acc);
  wg::mma_n128_rs(d3, f.rh, bl);
  wg::mma_n128_rs(d4, f.ih, bl);
  wg::mma_n128_rs(d3, f.rh, bh);
  wg::mma_n128_rs(d4, f.ih, bh);
  wg::commit();
}

// c ? x : y as one selp, so that a select over an array of registers
// stays in registers (the compiler would index a local copy of it).
__device__ __forceinline__ float select(bool c, float x, float y) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(x), "f"(y), "r"(static_cast<int>(c)));
  return r;
}

// One stage of reduce_scatter: lanes with bit `kMask` set keep blocks
// kHalf .. 2 kHalf - 1 and send blocks 0 .. kHalf - 1, the others the
// reverse; each keeps its blocks plus its partner's copy of them, in
// blocks 0 .. kHalf - 1.
template <int kHalf, int kMask, int kS>
__device__ __forceinline__ void reduce_half(float (&v)[8][kS], int lane) {
  const bool up = lane & kMask;
#pragma unroll
  for (int jj = 0; jj < kHalf; ++jj) {
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      const float mine = select(up, v[jj + kHalf][m], v[jj][m]);
      const float other = select(up, v[jj][m], v[jj + kHalf][m]);
      v[jj][m] = mine + __shfl_xor_sync(0xffffffffu, other, kMask);
    }
  }
}

// Reduce-scatter over a warp's 8 row lanes g (lane bits 2-4): v[j][m]
// summed over g lands in lane (g = j, t), which then holds in v[0] the
// sums of path 4 g + t, its own lane number.
template <int kS>
__device__ __forceinline__ void reduce_scatter(float (&v)[8][kS], int lane) {
  reduce_half<4, 16>(v, lane);
  reduce_half<2, 8>(v, lane);
  reduce_half<1, 4>(v, lane);
}

// kS: the sums of a fold, 7, or 5 with one RX element (m_r = n_r = 0, so
// dgry and dgrz are zeros).
template <int kS>
__global__ void __launch_bounds__(kThreads, 1)
render_bwd_kernel_tc(Args a) {
  extern __shared__ float4 smem4[];
  float* st_base = reinterpret_cast<float*>(smem4);
  float* red = st_base + kStages * kStage;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce(a, st_base, reinterpret_cast<float2*>(red + kRed));
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;                 // A rows r0, r0 + 8
  float d3[64], d4[64];     // column block j: d[4 j .. 4 j + 3]
  Frag f[2];
  // Owner lanes (warp 0, path c kPc + lane): sums of the slot over its row
  // tiles, and of the chunk over its slots.
  float s_sum[kSums];
  float o_ty = 0.f, o_tz = 0.f, o_ry = 0.f, o_rz = 0.f, o_om = 0.f,
        o_amp = 0.f;
  int n = 0, folds = 0, rel = -1;            // rel: stage to release
  for (int u = blockIdx.x; u < a.U; u += gridDim.x) {
    const size_t uu = u;
    for (int c = 0; c < a.n_ch; ++c) {
      const int p = c * kPc + lane;
      o_ty = o_tz = o_ry = o_rz = o_om = o_amp = 0.f;
      for (int s = 0; s < a.S; ++s) {
#pragma unroll
        for (int m = 0; m < kSums; ++m) s_sum[m] = 0.f;
        for (int rt = 0; rt < a.n_rt; ++rt) {
          int b = 0;
          for (int kt = 0; kt < a.n_kt; ++kt, ++n) {
            b = n % kStages;
            const StagePtrs st(st_base, b);
            render::bar_sync(kFull + b, kHandoff);
            const uint64_t bh = wg::desc(st.bh, kN);
            const uint64_t bl = wg::desc(st.bh + kBPlane, kN);
#pragma unroll
            for (int i = 0; i < kKt / 16; ++i) {
              float4 x[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int row = r0 + 8 * (r & 1);
                x[r] = *reinterpret_cast<const float4*>(
                    st.cr + (r >> 1) * kCtPlane + ct_off(row, 4 * i + t));
              }
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ks = 2 * i + e;
                make_frag(x, e, f[e]);
                products(d3, d4, f[e], wg::step(bh, ks, kN),
                         wg::step(bl, ks, kN), (kt | ks) ? 1 : 0);
                wg::wait_one();              // k-step ks - 1 is done
                fence_frag(f[e ^ 1]);
                if (ks == 0 && rel >= 0) {   // the step before is done
                  render::bar_arrive(kEmpty + rel, kHandoff);
                  rel = -1;
                }
              }
            }
            rel = b;
          }
          wg::wait_all();
          wg::fence_regs(d3);
          wg::fence_regs(d4);
          fence_frag(f[0]);
          fence_frag(f[1]);

          // The fold of the row tile: with dE = ct . conj(U) and dEk =
          // ct . conj(k U) of the slot (D3 = cr . B, D4 = ci . B),
          // z = conj(E) dE and zk = conj(E) dEk: damp = Re z, dpsi = a Im z,
          // domega = -a Im zk, dphi = a Im z, each summed over the rows
          // (dphi weighted by each row's panel indices).
          const StagePtrs sf(st_base, b);
          const float2* e_pl = sf.e;
          float wt[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 x = sf.wt[r0 + 8 * h];
            wt[h][0] = x.x;
            wt[h][1] = x.y;
            wt[h][2] = x.z;
            wt[h][3] = x.w;
          }
          float v[8][kS];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int m = 0; m < kS; ++m) v[j][m] = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = 4 * j + 2 * h;
              const float2 ev = e_pl[(r0 + 8 * h) * kES + 4 * j + t];
              const float der = d3[o] + d4[o + 1], dei = d4[o] - d3[o + 1];
              const float dkr = d3[32 + o] + d4[33 + o];
              const float dki = d4[32 + o] - d3[33 + o];
              const float zr = ev.x * der + ev.y * dei;
              const float zi = ev.x * dei - ev.y * der;
              const float zk = ev.x * dki - ev.y * dkr;
              v[j][0] += zr;
              v[j][1] += zi;
              v[j][2] += zk;
#pragma unroll
              for (int q = 0; q < kS - 3; ++q) v[j][3 + q] += wt[h][q] * zi;
            }
          }
          render::bar_arrive(kEmpty + b, kHandoff);  // E and B read
          rel = -1;
          reduce_scatter(v, lane);
          float* rd = red + (folds & 1) * 4 * kSums * 32;
#pragma unroll
          for (int m = 0; m < kS; ++m) rd[(w * kSums + m) * 32 + lane] =
              v[0][m];
          render::bar_sync(kConsBar, kConsumers);
          ++folds;
          if (w == 0) {
#pragma unroll
            for (int m = 0; m < kS; ++m)
              s_sum[m] += rd[m * 32 + lane] + rd[(kSums + m) * 32 + lane] +
                          rd[(2 * kSums + m) * 32 + lane] +
                          rd[(3 * kSums + m) * 32 + lane];
          }
        }
        if (w == 0 && p < a.P) {             // the slot's outputs
          const float am = __ldg(a.amp + (uu * a.n_sa + (a.n_sa > 1 ? s : 0)) *
                                             a.P + p);
          const size_t sp = (uu * a.S + s) * a.P + p;
          a.dpsi[sp] = am * s_sum[1];
          if (a.n_sa > 1) {
            a.damp[sp] = s_sum[0];
          } else {
            o_amp += s_sum[0];
          }
          o_om -= am * s_sum[2];
          o_ty += am * s_sum[3];
          o_tz += am * s_sum[4];
          if (kS == kSums) {
            o_ry += am * s_sum[5];
            o_rz += am * s_sum[6];
          }
        }
      }
      if (w == 0 && p < a.P) {               // the chunk's outputs
        const size_t row = uu * a.P + p;
        a.dgty[row] = o_ty;
        a.dgtz[row] = o_tz;
        a.dgry[row] = o_ry;
        a.dgrz[row] = o_rz;
        a.domega[row] = o_om;
        if (a.n_sa == 1) a.damp[row] = o_amp;
      }
    }
  }
}

cudaError_t launch(const float* gry, const float* grz, const float* gty,
                   const float* gtz, const float* amp, const float* psi,
                   const float* omega, const float* ct, float* dgry,
                   float* dgrz, float* dgty, float* dgtz, float* damp,
                   float* dpsi, float* domega, const Shape& s, int packed,
                   cudaStream_t stream) {
  Args a{gry, grz, gty, gtz, amp, psi, omega, ct, dgry, dgrz, dgty, dgtz,
         damp, dpsi, domega, s.U, s.P, s.r1, s.t1, s.T, s.Q, s.K, s.S,
         s.n_sa, 0, 0, 0, packed, 0};
  a.n_rt = (s.Q + kM - 1) / kM;
  a.n_ch = (s.P + kPc - 1) / kPc;
  a.n_kt = (s.K + kKt - 1) / kKt;
  a.vec = s.K % 4 == 0 && reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  const auto kernel = s.r1 * s.r2 > 1 ? render_bwd_kernel_tc<kSums>
                                      : render_bwd_kernel_tc<kSums - 2>;
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
  const int grid = render::imin(s.U, per_sm * n_sm);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Launches the backward on `stream`. Pointers are device pointers to
// contiguous float32 arrays: inputs as render_fwd_launch takes them, ct in
// the forward's output layout, and the 7 gradients shaped like the inputs
// (every element is written). passes: 3 (3xTF32, the tensor-core design)
// or 1 (bf16 operands, the mma.sync design). Returns the cudaError_t of
// the launch (0 on success); the kernel itself is not waited for.
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
  const Shape s =
      make_shape(n_users, n_paths, r1, r2, t1, t2, n_k, n_s, n_sa);
  if (passes == 3)
    return tc::launch(gry, grz, gty, gtz, amp, psi, omega, ct, dgry, dgrz,
                      dgty, dgtz, damp, dpsi, domega, s, packed,
                      static_cast<cudaStream_t>(stream));
  const auto kernel = render_bwd_kernel;
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
