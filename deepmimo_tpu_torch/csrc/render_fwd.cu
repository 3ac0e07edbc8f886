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
// bytes bound it. mma.sync, though, runs TF32 at about half that rate on
// an H100 (tools/mma_peak.cu: ~1.2e11 m16n8k8 products/s), so the three
// passes over the padded 64 x 56 x 128 GEMM of each user take ~1.5 ms
// alone: this design is bound by the tensor-core issue rate. Design:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "render_tables.cuh"

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

}  // namespace

// Launches the render on `stream`. Pointers are device pointers to
// contiguous arrays: gry..gtz and omega [U, P], amp [U, n_sa*P],
// psi [U, n_s*P] float32, out as described above, float32 or (out_bf16)
// bf16. passes: 3 (3xTF32) or 1 (bf16 operands). Returns the cudaError_t
// of the launch (0 on success); the kernel itself is not waited for.
extern "C" int render_fwd_launch(const float* gry, const float* grz,
                                 const float* gty, const float* gtz,
                                 const float* amp, const float* psi,
                                 const float* omega, void* out, int n_users,
                                 int n_paths, int r1, int r2, int t1, int t2,
                                 int n_k, int n_s, int n_sa, int packed,
                                 int passes, int out_bf16, void* stream) {
  if (n_users == 0) return cudaSuccess;
  if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
  const Shape s =
      make_shape(n_users, n_paths, r1, r2, t1, t2, n_k, n_s, n_sa);
  const auto st = static_cast<cudaStream_t>(stream);
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
