// Fused channel render for Hopper: per-path scalars in, H planes out.
//
// Replaces the TPU kernel deepmimo_tpu/ops/pallas/render.py::_kernel (and
// _kernel_norx). For one user u, with panel element t = n*M1 + m, output
// row q = r*T + t and output column kk = s*K + k:
//
//   E[q, p]  = a_rx[r, p] a_tx[t, p]
//            = exp(j (m_r gry + n_r grz + m gty + n gtz))
//   g[kk, p] = amp[s or 0, p] * exp(j (psi[s, p] - omega[p] * k))
//   H[q, kk] = sum_p E[q, p] g[kk, p]
//
// which is render.py::_reference_impl.
//
// What bounds it on an H100: at the headline shape (P = 25, Q = 64,
// S*K = 64) every user writes 32 KB of H: 4.29 GB per 131,072 users, about
// 1.3 ms at 3.35 TB/s. The path sum is 1.07e11 flop; at f32 grade on the
// tensor cores (3 TF32 passes at 495 TFLOP/s) that is 0.65 ms, so HBM
// bytes bound it. Two designs share the launcher; the wrapper picks one
// from dtype, mode and shape (ops/kernels/render.py tensor_core_route):
//
//   - mma.sync (render_fwd_kernel): the bf16 modes, and panels of fewer
//     than 48 rows (the quickstart's 8 x 1). mma.sync runs TF32 at about half the tensor
//     cores' rate on an H100 (tools/mma_peak.cu: ~1.2e11 m16n8k8
//     products/s), so the three passes over the padded 64 x 56 x 128 GEMM
//     of each user take ~1.5 ms alone, and its products and its
//     producers contend for the issue slots (PERF.md: 4.18 ms, 2.48 of
//     products alone, 2.69 of producers alone);
//   - tensor cores (tc::render_fwd_kernel_tc): float32 out at f32 grade
//     on panels of 48 rows or more, the headline among them.
//     The path sum as warpgroup GEMMs on wgmma, off the issue slots:
//     2.12 ms at the headline, 7.43 at 4 slots (16.7 on mma.sync).
//
// mma.sync design:
//   - the path sum is a real GEMM per tile on the tensor cores, in 3xTF32
//     mma.sync m16n8k8 (render_tables.cuh; no one-pass TF32): A = E with
//     the k-step's columns t and t + 4 the real and imaginary part of path
//     4*ks + t, B built from g with signs so that each n-tile's columns are
//     the hr (or hi) of 8 outputs; a thread's accumulators then hold 4
//     adjacent kk of one row, stored as one 16-byte vector;
//   - tiles of 64 rows x 64 columns and chunks of 32 paths, so shared
//     memory is bounded for every shape and a block takes any Q, S*K and P;
//   - warp-specialised, one persistent block of 16 warps per SM: two
//     producer groups of 4 warps take the block's tiles in turns and build
//     each tile's operands, 8 consumer warps (32 rows x 16 kk each, hr and
//     hi) run the mma and write H. Named barriers hand the two operand
//     stages back and forth (full: producers arrive, consumers wait; empty:
//     the reverse), so one tile's trig, its operand build and the stores of
//     the previous tile all run while the tensor cores work on another;
//   - E and g are built per tile into shared memory from per-tile tables
//     (separable panel responses, a fine and a coarse OFDM table): 4x
//     fewer sincosf than one per element, all with full range reduction
//     (omega*k reaches ~31 rad at the headline, where the fast intrinsics
//     lose digits). Each value is split into tf32 hi and lo once, as it is
//     staged, and stored as (re hi, im hi, re lo, im lo), so the main loop
//     does no conversion: per k-step a consumer warp makes 6 16-byte loads
//     and 24 mma (plane rows of 36 float4 keep the loads conflict-free);
//   - the accumulators hold 4 adjacent kk of one row per lane and go
//     straight to HBM as coalesced 16-byte streaming stores (64 contiguous
//     bytes per row and instruction), which do not block the warp.
// Modes (template arguments, one instantiation each, chosen at launch):
//   - kPasses = 1 (matmul_dtype "bfloat16"/"default"): E and g are rounded
//     to bf16 as they are staged and the product is one pass, hi*hi
//     (render_tables.cuh), the TPU kernel's one-pass mode (render.py
//     _dot_mode);
//   - OutT = __nv_bfloat16 (out_dtype "bfloat16"): H is stored in bf16,
//     rounded to nearest even from the f32 accumulators, as the TPU kernel
//     casts at its store (render.py:516-528). Lanes t and t ^ 1 swap the hr
//     and hi halves of their 4 columns with two shuffles, so that each
//     stores 8 adjacent bf16 of one plane as one 16-byte vector.
//
// Tensor-core design (namespace tc), per user and tile of 64 rows (q), in
// path chunks of 32 and tiles of 64 subcarriers of one slot:
//   - the path sum as two real GEMMs on wgmma m64n128k8, D3 = Er . G and
//     D4 = Ei . G with G = [gr | gi] (32 x 128), H = D3(re) - D4(im) +
//     j (D3(im) + D4(re)) formed in registers, as the beam gain's path sum
//     (beamgain.cu); both operands from shared memory in wgmma.cuh's
//     K-major layout, at 3xTF32 (lo.hi + hi.lo + hi.hi, FP32
//     accumulation, the split of render_tables.cuh). No product register
//     is written on a branch and every k-step count is fixed, so ptxas
//     keeps the products in flight together;
//   - E (a_rx (x) a_tx of the tile's rows) is built once per user and row
//     tile and kept for every slot and column tile when P <= 32; only G is
//     built per tile (with more paths, E and G per chunk, summed in the
//     accumulators). Rows past Q and paths past P are zeros;
//   - persistent warp-specialised blocks, one per SM (131,072 bytes of
//     shared memory): one consumer warpgroup runs the products and the
//     stores; two producer groups of 4 warps take the steps in turn, group
//     g building stage g (E and G), handed over by named barriers (full,
//     empty). The producers set its pace: with one group the kernel took
//     2.69 ms at the headline, of which 2.09 producers alone;
//   - separable trig, full-range: E = ey[m] ez[row group] for 8-wide TX
//     panels (two sincos a lane and path, the rest by shuffle; other
//     panels one sincos an entry), G = fine[k % 8] coarse[k / 8] by
//     tc_operands.cuh's build_g, the beam gain's producer;
//   - the accumulators hold four adjacent subcarriers of a row per lane
//     (build_g's column order) and go straight to HBM as 16-byte streaming
//     stores into the packed or stacked layout, with no workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "render_tables.cuh"
#include "tc_operands.cuh"
#include "wgmma.cuh"

namespace {

using namespace render;

constexpr int kConsumers = 256;       // 8 warps: mma and stores
constexpr int kGroup = 128;           // 4 warps per producer group
constexpr int kThreads = kConsumers + 2 * kGroup;
constexpr int kES = kPC + 4;          // plane row (float4), 4 mod 8
constexpr int kPlane = kMT * kES;     // E and g planes alike
static_assert(kMT == kNT, "E and g planes share one size");
// Named barriers: stage b full / empty, producer group g.
constexpr int kFull = 1, kEmpty = 3, kGroupBar = 5;
constexpr int kHandoff = kConsumers + kGroup;

// Shared memory of one producer group: its tables, scalars and indices.
__host__ __device__ size_t group_bytes(const Shape& s) {
  return sizeof(float2) * static_cast<size_t>(panel_cap(s) + ofdm_cap(s)) *
             kPC +
         sizeof(float) * (2 * kScal * kPC + kMT + kNT);
}

size_t smem_bytes(const Shape& s) {
  return sizeof(float4) * 4 * kPlane + 2 * group_bytes(s);
}

// One step of a block's walk: user, q rows, kk columns, path chunk.
struct Item {
  int u, q0, kk0, p0;
};

__device__ __forceinline__ Item next_item(const Shape& s, Item it) {
  if ((it.p0 += kPC) < s.P) return it;
  it.p0 = 0;
  if ((it.kk0 += kNT) < s.SK) return it;
  it.kk0 = 0;
  if ((it.q0 += kMT) < s.Q) return it;
  it.q0 = 0;
  it.u += gridDim.x;
  return it;
}

// Producer group g: the operands of every other tile of the block's walk
// (from the g-th) into stage g, split for a product of kPasses passes.
template <int kPasses>
__device__ __forceinline__ void produce(
    const Shape& s, int g, const float* gry, const float* grz,
    const float* gty, const float* gtz, const float* amp, const float* psi,
    const float* omega, float4* e_pl, float4* g_pl, char* mem) {
  const Team tm{static_cast<int>(threadIdx.x) - kConsumers - g * kGroup,
                kGroup};
  float2* tab = reinterpret_cast<float2*>(mem);
  float* scal = reinterpret_cast<float*>(
      tab + static_cast<size_t>(panel_cap(s) + ofdm_cap(s)) * kPC);
  int* row_ix = reinterpret_cast<int*>(scal + 2 * kScal * kPC);
  int* col_ix = row_ix + kMT;

  Item it{static_cast<int>(blockIdx.x), 0, 0, 0};
  if (g == 1) it = next_item(s, it);
  if (it.u < s.U) {
    issue_scalars(tm, s, it.u, it.p0, gry, grz, gty, gtz, omega, scal);
    cp_async_commit();
  }
  int n = 0;
  for (; it.u < s.U; ++n) {
    const Tile tl(s, it.q0, it.kk0, imin(kNT, s.SK - it.kk0));
    cp_async_wait_all();
    bar_sync(kGroupBar + g, kGroup);   // scalars landed; tables free
    const Item nx = next_item(s, next_item(s, it));
    if (nx.u < s.U) {                  // the next tile's scalars, ahead
      issue_scalars(tm, s, nx.u, nx.p0, gry, grz, gty, gtz, omega,
                    scal + ((n + 1) & 1) * kScal * kPC);
      cp_async_commit();
    }
    build_tables(tm, s, tl, it.u, it.p0, scal + (n & 1) * kScal * kPC, psi,
                 amp, tab, row_ix, col_ix);
    bar_sync(kGroupBar + g, kGroup);   // tables ready
    if (n > 0) bar_sync(kEmpty + g, kHandoff);   // stage g consumed
    build_planes<kES, kPasses>(tm, tl, imin(kPC, s.P - it.p0), tab, row_ix,
                               col_ix, e_pl, g_pl);
    bar_arrive(kFull + g, kHandoff);   // stage g full
    it = nx;
  }
  if (n > 0) bar_sync(kEmpty + g, kHandoff);     // the last release
}

// Two bf16 (RNE) in one word, a in the low half.
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kPasses, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
render_fwd_kernel(const float* __restrict__ gry, const float* __restrict__ grz,
                  const float* __restrict__ gty, const float* __restrict__ gtz,
                  const float* __restrict__ amp, const float* __restrict__ psi,
                  const float* __restrict__ omega, OutT* __restrict__ out,
                  Shape s, int packed, int vec) {
  extern __shared__ float4 smem4[];
  float4* planes = smem4;             // [stage][E, g][kPlane]
  if (threadIdx.x >= kConsumers) {
    const int g = (threadIdx.x - kConsumers) / kGroup;
    produce<kPasses>(s, g, gry, grz, gty, gtz, amp, psi, omega,
            planes + 2 * g * kPlane, planes + (2 * g + 1) * kPlane,
            reinterpret_cast<char*>(planes + 4 * kPlane) + g * group_bytes(s));
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (threadIdx.x >> 5) & 1;      // rows 32 wm .. 32 wm + 31
  const int wn = threadIdx.x >> 6;            // kk 16 wn .. 16 wn + 15
  const size_t stride = packed ? 2 * static_cast<size_t>(s.SK) : s.SK;

  // A rows of m-tile i: ra + 16 i and ra + 16 i + 8. B column g of n-tile
  // j (hr or hi) is kk = 16 wn + 4 (g / 2) + 2 j + g % 2, so the lane's
  // accumulator columns 2t, 2t + 1 of n-tiles 0 and 1 are kk = 16 wn + 4t
  // + 0..3.
  const int ra = 32 * wm + g;
  const int brow = (16 * wn + 4 * (g >> 1) + (g & 1)) * kES;

  float acc[2][4][4];        // [m-tile][hr j0, hr j1, hi j0, hi j1][frag]
  Item it{static_cast<int>(blockIdx.x), 0, 0, 0};
  for (int b = 0; it.u < s.U; b ^= 1) {
    const size_t u = it.u;
    const int rows = imin(kMT, s.Q - it.q0);
    const int cols = imin(kNT, s.SK - it.kk0);
    const int np = imin(kPC, s.P - it.p0);
    const float4* e_pl = planes + 2 * b * kPlane;
    const float4* g_pl = e_pl + kPlane;

    if (it.p0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
    bar_sync(kFull + b, kHandoff);    // stage b holds this tile's operands
    const bool m1 = 32 * wm + 16 < rows;      // second m-tile has rows
    if (32 * wm < rows && 16 * wn < cols) {
      const int n_ks = (np + 3) / 4;
#pragma unroll 2
      for (int ks = 0; ks < n_ks; ++ks) {
        const int pp = 4 * ks + t;
        Split a[2][4], b4[4][2];   // b4: hr j0, hr j1, hi j0, hi j1
#pragma unroll
        for (int j = 0; j < 2; ++j) {      // hr: (g_r, -g_i); hi: (g_i, g_r)
          const float4 x = g_pl[brow + 2 * j * kES + pp];
          const Split re = split_re(x), im = split_im(x);
          b4[j][0] = re;
          b4[j][1] = neg(im);
          b4[2 + j][0] = im;
          b4[2 + j][1] = re;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !m1) break;
          cplx_a(a[i], e_pl[(ra + 16 * i) * kES + pp],
                 e_pl[(ra + 16 * i + 8) * kES + pp]);
        }
        mma3<kPasses>(acc, a, b4, m1 ? 2 : 1, 4);
      }
    }
    bar_arrive(kEmpty + b, kHandoff);  // stage b may be refilled
    const Item nx = next_item(s, it);
    if (it.p0 + kPC < s.P) {
      it = nx;
      continue;                // more path chunks for this tile
    }

    // Packed [U, Q, 2*SK] (hr | hi on each row) or stacked [2, U, Q, SK].
    // Streaming stores: they drain while the next tile is computed.
    OutT* out_r = out + (u * s.Q + it.q0) * stride + it.kk0;
    OutT* out_i = packed ? out_r + s.SK
                         : out + ((s.U + u) * s.Q + it.q0) * s.SK + it.kk0;
    const int c = 16 * wn + 4 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 16 * i + 8 * h;
        if constexpr (std::is_same<OutT, float>::value) {
          if (r >= rows || c >= cols) continue;
          const float4 vr = make_float4(acc[i][0][2 * h], acc[i][0][2 * h + 1],
                                        acc[i][1][2 * h], acc[i][1][2 * h + 1]);
          const float4 vi = make_float4(acc[i][2][2 * h], acc[i][2][2 * h + 1],
                                        acc[i][3][2 * h], acc[i][3][2 * h + 1]);
          float* dr = out_r + r * stride + c;
          float* di = out_i + r * stride + c;
          if (vec) {             // cols is a multiple of 4 here
            __stcs(reinterpret_cast<float4*>(dr), vr);
            __stcs(reinterpret_cast<float4*>(di), vi);
          } else {
            const float xr[4] = {vr.x, vr.y, vr.z, vr.w};
            const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (c + e < cols) {
                __stcs(dr + e, xr[e]);
                __stcs(di + e, xi[e]);
              }
            }
          }
        } else {
          const uint2 pr = make_uint2(
              bf16x2(acc[i][0][2 * h], acc[i][0][2 * h + 1]),
              bf16x2(acc[i][1][2 * h], acc[i][1][2 * h + 1]));
          const uint2 pi = make_uint2(
              bf16x2(acc[i][2][2 * h], acc[i][2][2 * h + 1]),
              bf16x2(acc[i][3][2 * h], acc[i][3][2 * h + 1]));
          if (vec) {             // cols is a multiple of 8 here
            // Even t keeps hr and takes its neighbour's (kk c .. c + 7); odd
            // t keeps hi and takes its neighbour's (c - 4 .. c + 3). The
            // shuffles run on every lane, before any lane skips its store.
            const uint2 send = (t & 1) ? pr : pi;
            const uint2 got = make_uint2(
                __shfl_xor_sync(0xffffffffu, send.x, 1),
                __shfl_xor_sync(0xffffffffu, send.y, 1));
            if (r >= rows || c >= cols) continue;
            const uint4 v = (t & 1) ? make_uint4(got.x, got.y, pi.x, pi.y)
                                    : make_uint4(pr.x, pr.y, got.x, got.y);
            OutT* dst = ((t & 1) ? out_i : out_r) + r * stride + (c & ~7);
            __stcs(reinterpret_cast<uint4*>(dst), v);
          } else {
            if (r >= rows || c >= cols) continue;
            const uint32_t xr[2] = {pr.x, pr.y}, xi[2] = {pi.x, pi.y};
            unsigned short* dr =
                reinterpret_cast<unsigned short*>(out_r + r * stride + c);
            unsigned short* di =
                reinterpret_cast<unsigned short*>(out_i + r * stride + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (c + e < cols) {
                const int sh = 16 * (e & 1);
                dr[e] = static_cast<unsigned short>(xr[e >> 1] >> sh);
                di[e] = static_cast<unsigned short>(xi[e >> 1] >> sh);
              }
            }
          }
        }
      }
    }
    it = nx;
  }
}

template <int kPasses, typename OutT>
cudaError_t launch(const float* gry, const float* grz, const float* gty,
                   const float* gtz, const float* amp, const float* psi,
                   const float* omega, void* out, const Shape& s, int packed,
                   cudaStream_t stream) {
  const auto kernel = render_fwd_kernel<kPasses, OutT>;
  const int smem = static_cast<int>(smem_bytes(s));
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
  const int grid = imin(s.U, n_sm * (per_sm > 0 ? per_sm : 1));
  // 16-byte stores need every row segment 16-byte aligned: 4 float or 8
  // bf16 columns.
  constexpr int kVec = 16 / sizeof(OutT);
  const int vec = s.SK % kVec == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<grid, kThreads, smem, stream>>>(gry, grz, gty, gtz, amp, psi,
                                           omega, static_cast<OutT*>(out), s,
                                           packed, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core design: float32 at f32 grade, panels of 48 rows or more
// (the wrapper routes; ops/kernels/render.py tensor_core_route)
// ---------------------------------------------------------------------------

namespace tc {

using render::Split;
using tcop::kGPlane;
using tcop::kKt;
using tcop::kNG;
using tcop::kPc;

constexpr int kConsumers = 128;      // one warpgroup: wgmma and stores
constexpr int kGroup = 128;          // 4 warps: the E and g of a step
constexpr int kGroups = 2;           // producer groups: group g, stage g
constexpr int kThreads = kConsumers + kGroups * kGroup;
constexpr int kHandoff = kConsumers + kGroup;   // a stage's two sides
constexpr int kM = 64;               // rows (q) per tile: the products' rows
constexpr int kEPlane = kM * kPc;    // floats of one E plane
// 2 stages of E (re hi, re lo, im hi, im lo) and of g (hi, lo): 131,072
// bytes, one block per SM.
constexpr size_t kSmemBytes =
    sizeof(float) * 2 * (4 * kEPlane + 2 * kGPlane);
// Named barriers: stage s full (producers arrive, consumers wait) and
// empty (the reverse).
constexpr int kFull = 1, kEmpty = 3;
static_assert(kGroup == 4 * 32 && kPc == 32, "a producer warp per 8 "
              "paths of a chunk");

struct Args {
  const float *gry, *grz, *gty, *gtz, *amp, *psi, *omega;
  float* out;               // packed [U, Q, 2*S*K] or stacked [2, U, Q, S*K]
  int U, P, r1, t1, t2, T, Q, K, S, n_sa;
  int n_rt, n_items;        // row tiles; users x row tiles
  int n_ch, n_kt, n_steps;  // path chunks, column tiles, steps per item
  int packed, vec;          // vec: 16-byte stores (K % 4 == 0, aligned out)
};

// Step st of an item (one user and row tile): output tile (slot s, columns
// k0 .. k0 + kKt - 1 of the slot) and path chunk. With one chunk, E is
// built at the item's first step and kept for every tile; with more, every
// step builds its chunk's E and the tile's sum runs over its n_ch steps.
struct Step {
  int chunk, s, k0;
};

__device__ __forceinline__ Step step_at(const Args& a, int st) {
  Step x;
  int tile = st;
  x.chunk = 0;
  if (a.n_ch > 1) {
    tile = st / a.n_ch;
    x.chunk = st - tile * a.n_ch;
  }
  x.s = tile / a.n_kt;
  x.k0 = (tile - x.s * a.n_kt) * kKt;
  return x;
}

// The phase of RX element r = nr r1 + mr of a path, mr gry + nr grz, and
// that of row group G = r t2 + n (TX n of RX element r), n gtz + the RX
// phase, rounded as the plain version rounds each product.
__device__ __forceinline__ float rx_phase(const Args& a, int r, float gry,
                                          float grz) {
  const int nr = r / a.r1;
  return __fadd_rn(__fmul_rn(static_cast<float>(r - nr * a.r1), gry),
                   __fmul_rn(static_cast<float>(nr), grz));
}
__device__ __forceinline__ float group_phase(const Args& a, int G, float gry,
                                             float grz, float gtz) {
  const int r = G / a.t2;
  return __fadd_rn(__fmul_rn(static_cast<float>(G - r * a.t2), gtz),
                   rx_phase(a, r, gry, grz));
}

// Producers: E of rows q0 .. q0 + kM - 1 and the chunk's paths as the
// path sum's A operand [kM x kPc] in four K-major planes (re hi, re lo,
// im hi, im lo): depth p is path p of the chunk, the order of G's rows.
// E[q, p] = a_rx[r, p] a_tx[t, p] for q = r T + t, t = n t1 + m. Warp w,
// lane e + 4 rr (paths 8 w + 4 h2 + e, h2 < 2) writes rows 8 i + rr,
// i < 8: for each (i, h2) the warp fills one core matrix, without bank
// conflicts. Rows past Q and paths past P are zeros.
__device__ __forceinline__ void build_e(const Args& a, int q0,
                                        const bool (&ok)[2],
                                        const float (&gry)[2],
                                        const float (&grz)[2],
                                        const float (&gty)[2],
                                        const float (&gtz)[2], int w, int e,
                                        int rr, float* ep) {
  float2 v[2][8];
  if (a.t1 == 8) {
    // Separable: row 8 i + rr is TX m = rr of row group G = q0 / 8 + i (q0
    // is a multiple of 8), E = ey[rr] ez[G]. Lane (e, rr) computes ey[rr]
    // and ez of group q0 / 8 + rr for its paths and takes ez[G] from lane
    // (e, i).
    const float rf = static_cast<float>(rr);
    float ph[4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      ph[2 * h2] = __fmul_rn(rf, gty[h2]);
      ph[2 * h2 + 1] = group_phase(a, q0 / 8 + rr, gry[h2], grz[h2],
                                   gtz[h2]);
    }
    float2 yz[4];
    render::phasors(ph, yz);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 ez = yz[2 * h2 + 1];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 z = make_float2(__shfl_sync(~0u, ez.x, e + 4 * i),
                                     __shfl_sync(~0u, ez.y, e + 4 * i));
        v[h2][i] = render::cmul(yz[2 * h2], z);
      }
    }
  } else {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float ph[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = q0 + 8 * i + rr;
        const int r = q / a.T, tt = q - r * a.T;
        const int n = tt / a.t1;
        ph[i] = __fadd_rn(
            __fadd_rn(__fmul_rn(static_cast<float>(tt - n * a.t1), gty[h2]),
                      __fmul_rn(static_cast<float>(n), gtz[h2])),
            rx_phase(a, r, gry[h2], grz[h2]));
      }
      render::phasors(ph, v[h2]);
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * i + rr;
      const float2 z = ok[h2] && q0 + row < a.Q ? v[h2][i]
                                                : make_float2(0.f, 0.f);
      const Split re = render::split(z.x), im = render::split(z.y);
      const int o = wg::offset(row, 8 * w + 4 * h2 + e, kM);
      ep[o] = __uint_as_float(re.hi);
      ep[kEPlane + o] = __uint_as_float(re.lo);
      ep[2 * kEPlane + o] = __uint_as_float(im.hi);
      ep[3 * kEPlane + o] = __uint_as_float(im.lo);
    }
  }
}

// Producer group g: E (at an item's first step, or at every step with
// more than one chunk) and g of the block's steps k = g, g + 2, ... into
// stage g.
template <bool kOneChunk>
__device__ __forceinline__ void produce(const Args& a, int g, float* e_st,
                                        float* g_st) {
  const int id = threadIdx.x - kConsumers - g * kGroup;
  const int w = id >> 5, lane = id & 31;
  const int e = lane & 3, rr = lane >> 2;
  float* gp = g_st + g * 2 * kGPlane;
  int k = 0, n = 0;                  // k: the step, n: the item
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x, ++n) {
    const int ut = it / a.n_rt;
    const size_t u = static_cast<size_t>(ut);
    const int q0 = (it - ut * a.n_rt) * kM;
    for (int st = 0; st < a.n_steps; ++st, ++k) {
      if ((k & 1) != g) continue;
      const Step x = step_at(a, st);
      const bool build = !kOneChunk || st == 0;
      bool ok[2];
      float gry[2] = {0.f, 0.f}, grz[2] = {0.f, 0.f}, gty[2] = {0.f, 0.f},
            gtz[2] = {0.f, 0.f}, om[2] = {0.f, 0.f}, ps[2] = {0.f, 0.f};
      float2 ca[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {   // the lane's two paths
        const int p = x.chunk * kPc + 8 * w + 4 * h2 + e;
        ok[h2] = p < a.P;
        float am = 0.f;
        if (ok[h2]) {
          const size_t row = u * a.P + p;
          if (build) {
            gry[h2] = __ldg(a.gry + row);
            grz[h2] = __ldg(a.grz + row);
            gty[h2] = __ldg(a.gty + row);
            gtz[h2] = __ldg(a.gtz + row);
          }
          om[h2] = __ldg(a.omega + row);
          ps[h2] = __ldg(a.psi + (u * a.S + x.s) * a.P + p);
          am = __ldg(a.amp + (u * a.n_sa + (a.n_sa > 1 ? x.s : 0)) * a.P +
                     p);
        }
        ca[h2] = make_float2(am, 0.f);
      }
      if (k >= 2) render::bar_sync(kEmpty + g, kHandoff);   // stage drained
      if (build)
        build_e(a, q0, ok, gry, grz, gty, gtz, w, e, rr,
                e_st + (kOneChunk ? n & 1 : g) * 4 * kEPlane);
      tcop::build_g(om, ps, ca, x.k0, w, e, rr & 3, rr >> 2, gp);
      // Written through the generic proxy, read by wgmma through the async
      // proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      render::bar_arrive(kFull + g, kHandoff);
    }
  }
  if (k > g) render::bar_sync(kEmpty + g, kHandoff);     // the last release
}

// Consumers: D3 = Er . G and D4 = Ei . G of the stages at 3xTF32, plus
// D3 and D4 unless `acc` is 0: H = D3(re) - D4(im) + j (D3(im) + D4(re)).
// The first products start the sums (acc 0) and every k-step count is
// fixed: no register of a product is written outside the products, so
// ptxas keeps them in flight together.
__device__ __forceinline__ void path_sum(float (&d3)[64], float (&d4)[64],
                                         const float* e, const float* g,
                                         int acc) {
  const uint64_t rh = wg::desc(e, kM), rl = wg::desc(e + kEPlane, kM);
  const uint64_t ih = wg::desc(e + 2 * kEPlane, kM);
  const uint64_t il = wg::desc(e + 3 * kEPlane, kM);
  const uint64_t gh = wg::desc(g, kNG), gl = wg::desc(g + kGPlane, kNG);
  wg::fence_regs(d3);
  wg::fence_regs(d4);
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < kPc / 8; ++ks) {
    const uint64_t bh = wg::step(gh, ks, kNG), bl = wg::step(gl, ks, kNG);
    const uint64_t ah = wg::step(rh, ks, kM), al = wg::step(rl, ks, kM);
    const uint64_t jh = wg::step(ih, ks, kM), jl = wg::step(il, ks, kM);
    wg::mma_n128_ss(d3, al, bh, ks ? 1 : acc);                // lo . hi
    wg::mma_n128_ss(d4, jl, bh, ks ? 1 : acc);
    wg::mma_n128_ss(d3, ah, bl);                              // hi . lo
    wg::mma_n128_ss(d4, jh, bl);
    wg::mma_n128_ss(d3, ah, bh);                              // hi . hi
    wg::mma_n128_ss(d4, jh, bh);
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(d3);
  wg::fence_regs(d4);
}

// Consumers: H of rows ra and ra + 8 of the row tile and the step's 64
// columns, as float4 streaming stores of four adjacent subcarriers into
// each plane; rows past Q and columns past K skipped.
__device__ __forceinline__ void store_h(const Args& a, size_t u, int q0,
                                        const Step& x, int ra, int t,
                                        const float (&d3)[64],
                                        const float (&d4)[64]) {
  const size_t sk = static_cast<size_t>(a.S) * a.K;
  const size_t stride = a.packed ? 2 * sk : sk;
  const int cols = render::imin(kKt, a.K - x.k0);
  const size_t c0 = static_cast<size_t>(x.s) * a.K + x.k0;
  float* out_r = a.out + (u * a.Q + q0) * stride + c0;
  float* out_i = a.packed ? out_r + sk
                          : a.out + ((a.U + u) * a.Q + q0) * sk + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    if (q0 + row >= a.Q) continue;
    float* dr = out_r + row * stride;
    float* di = out_i + row * stride;
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      const int kl = 16 * J + 4 * t;
      if (kl >= cols) continue;
      float vr[4], vi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * (4 * J + i) + 2 * h;
        vr[i] = d3[c] - d4[c + 1];
        vi[i] = d3[c + 1] + d4[c];
      }
      if (a.vec) {                   // cols is a multiple of 4 here
        __stcs(reinterpret_cast<float4*>(dr + kl),
               make_float4(vr[0], vr[1], vr[2], vr[3]));
        __stcs(reinterpret_cast<float4*>(di + kl),
               make_float4(vi[0], vi[1], vi[2], vi[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kl + i < cols) {
            __stcs(dr + kl + i, vr[i]);
            __stcs(di + kl + i, vi[i]);
          }
        }
      }
    }
  }
}

// kOneChunk: P <= kPc, E built once per item (user and row tile) and kept
// for every slot and column tile; else every step builds its chunk's E
// and the output tile sums over n_ch steps.
template <bool kOneChunk>
__global__ void __launch_bounds__(kThreads, 1)
render_fwd_kernel_tc(Args a) {
  extern __shared__ float4 smem4[];
  float* e_st = reinterpret_cast<float*>(smem4);   // [2][4][kEPlane]
  float* g_st = e_st + 2 * 4 * kEPlane;            // [2][hi, lo][kGPlane]
  if (threadIdx.x >= kConsumers) {
    produce<kOneChunk>(a, (threadIdx.x - kConsumers) / kGroup, e_st, g_st);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int ra = 16 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
  float d3[64], d4[64];              // column block j: d[4 j .. 4 j + 3]
  int k = 0, n = 0;                  // k: the step, n: the item
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x, ++n) {
    const int ut = it / a.n_rt;
    const size_t u = static_cast<size_t>(ut);
    const int q0 = (it - ut * a.n_rt) * kM;
    if (kOneChunk) {
      const float* e = e_st + (n & 1) * 4 * kEPlane;
      for (int st = 0; st < a.n_steps; ++st, ++k) {
        const int sg = k & 1;
        render::bar_sync(kFull + sg, kHandoff);      // E (st 0) and g
        path_sum(d3, d4, e, g_st + sg * 2 * kGPlane, 0);
        render::bar_arrive(kEmpty + sg, kHandoff);   // may be rebuilt
        store_h(a, u, q0, step_at(a, st), ra, t, d3, d4);
      }
    } else {
      for (int st = 0; st < a.n_steps; st += a.n_ch) {
        for (int c = 0; c < a.n_ch; ++c, ++k) {
          const int sg = k & 1;
          render::bar_sync(kFull + sg, kHandoff);    // E and g of step k
          path_sum(d3, d4, e_st + sg * 4 * kEPlane, g_st + sg * 2 * kGPlane,
                   c);
          render::bar_arrive(kEmpty + sg, kHandoff);
        }
        store_h(a, u, q0, step_at(a, st), ra, t, d3, d4);
      }
    }
  }
}

cudaError_t launch(const float* gry, const float* grz, const float* gty,
                   const float* gtz, const float* amp, const float* psi,
                   const float* omega, void* out, const Shape& s, int packed,
                   cudaStream_t stream) {
  Args a{gry, grz, gty, gtz, amp, psi, omega, static_cast<float*>(out),
         s.U, s.P, s.r1, s.t1, s.t2, s.T, s.Q, s.K, s.S, s.n_sa,
         0, 0, 0, 0, 0, packed, 0};
  a.n_rt = (s.Q + kM - 1) / kM;
  a.n_ch = (s.P + kPc - 1) / kPc;
  a.n_kt = (s.K + kKt - 1) / kKt;
  const long long items = static_cast<long long>(a.n_rt) * s.U;
  const long long tiles = static_cast<long long>(s.S) * a.n_kt;
  const long long steps = a.n_ch > 1 ? tiles * a.n_ch : tiles;
  if (items > 0x3fffffff || steps > 0x3fffffff) return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  a.n_steps = static_cast<int>(steps);
  a.vec = s.K % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto kernel = a.n_ch == 1 ? render_fwd_kernel_tc<true>
                                  : render_fwd_kernel_tc<false>;
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

}  // namespace

// Launches the render on `stream`. Pointers are device pointers to
// contiguous arrays: gry..gtz and omega [U, P], amp [U, n_sa*P],
// psi [U, n_s*P] float32, out as described above, float32 or (out_bf16)
// bf16. passes: 3 (3xTF32) or 1 (bf16 operands). tensor_cores runs the
// tensor-core design (passes 3, float32 out only). Returns the cudaError_t
// of the launch (0 on success); the kernel itself is not waited for.
extern "C" int render_fwd_launch(const float* gry, const float* grz,
                                 const float* gty, const float* gtz,
                                 const float* amp, const float* psi,
                                 const float* omega, void* out, int n_users,
                                 int n_paths, int r1, int r2, int t1, int t2,
                                 int n_k, int n_s, int n_sa, int packed,
                                 int passes, int out_bf16, int tensor_cores,
                                 void* stream) {
  if (n_users == 0) return cudaSuccess;
  if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
  if (tensor_cores && (passes != 3 || out_bf16)) return cudaErrorInvalidValue;
  const Shape s =
      make_shape(n_users, n_paths, r1, r2, t1, t2, n_k, n_s, n_sa);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tensor_cores)
    return tc::launch(gry, grz, gty, gtz, amp, psi, omega, out, s, packed,
                      st);
  if (passes == 3 && !out_bf16)
    return launch<3, float>(gry, grz, gty, gtz, amp, psi, omega, out, s,
                            packed, st);
  if (passes == 3)
    return launch<3, __nv_bfloat16>(gry, grz, gty, gtz, amp, psi, omega, out,
                                    s, packed, st);
  if (!out_bf16)
    return launch<1, float>(gry, grz, gty, gtz, amp, psi, omega, out, s,
                            packed, st);
  return launch<1, __nv_bfloat16>(gry, grz, gty, gtz, amp, psi, omega, out, s,
                                  packed, st);
}
